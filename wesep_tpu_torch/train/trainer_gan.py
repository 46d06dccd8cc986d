"""MetricGAN training step: generator + CMGAN metric discriminator.

Counterpart of wesep_tpu/train/trainer_gan.py, in the JAX package's order.
Per batch:

  1. the generator's forward in train mode (its BatchNorm statistics move
     once), detached for the discriminator;
  2. the metric targets, without gradient: m(mixture) and m(est_k);
  3. D step: D in train mode on (clean, clean) -> 1, (clean, mixture) ->
     m(mixture), then (clean, est_k) -> m(est_k) for every estimate, each
     call's masked MSE summed; the spectral-norm u moves once per call and
     threads from call to call; every call applies the same dropout mask,
     one draw per step from a generator seeded by (`seed`, D's step), as
     the JAX step passes one rng to every apply; then D's optimizer (clip
     -> + wd * p -> Adam -> its own schedule);
  4. G step: `weighted_loss` + gan_loss_weight * mean((D(clean, est_k) -
     1)^2) summed over the estimates, through the UPDATED D in eval mode
     (its power step runs from the new u and stores nothing; no dropout;
     no gradient reaches D's parameters); then G's optimizer.

The JAX step runs the generator twice, once for D (detached) and once
inside G's loss, from the same parameters and statistics on the same
batch. Here one forward with autograd serves both: its detached estimates
feed D, and its graph G's loss. The outputs, the gradients and the one
statistics update are the same.

Metric functions take (est, ref) [B, T] and return (values [B], valid
[B]); invalid pairs (a silent reference or estimate for PESQ) are masked
out of D's loss:

  * `metric_pesq` (the recipes' default, `gan_metric: pesq`): the P.862
    model of ops/pesq.py on the tensors' device;
  * `metric_pesq_callback` (`pesq_host`): per row on the host through
    utils/score.cal_PESQ_norm (the `pesq` package where installed, else
    the same in-repo model on the CPU, with a crude alignment);
  * `metric_sisdr_norm` (`sisdr`): sigmoid(SI-SDR / 10).
"""

from typing import Callable, Sequence

import numpy as np
import torch

from wesep_tpu_torch.train.losses import si_sdr
from wesep_tpu_torch.train.trainer import weighted_loss

__all__ = ["make_gan_train_step", "metric_sisdr_norm", "metric_pesq",
           "metric_pesq_callback", "masked_mse", "estimates",
           "dropout_generator"]


@torch.no_grad()
def metric_sisdr_norm(est, ref):
    """(values [B], valid [B]) proxy in (0, 1): sigmoid(SI-SDR / 10)."""
    vals = torch.sigmoid(si_sdr(est, ref) / 10.0)
    return vals, torch.ones_like(vals, dtype=torch.bool)


def metric_pesq(est, ref, fs: int = 16000):
    """Normalised P.862 scores (pesq + 0.5) / 5 on the device, with silent
    pairs marked invalid (ops/pesq.pesq_norm_batch)."""
    from wesep_tpu_torch.ops.pesq import pesq_norm_batch

    return pesq_norm_batch(est, ref, fs)


@torch.no_grad()
def metric_pesq_callback(est, ref, fs: int = 16000):
    """Normalised PESQ per row on the host (utils/score.cal_PESQ_norm);
    a None score marks the row invalid."""
    from wesep_tpu_torch.utils.score import cal_PESQ_norm

    est_np = est.float().cpu().numpy()
    ref_np = ref.float().cpu().numpy()
    vals = np.zeros(est_np.shape[0], np.float32)
    valid = np.zeros(est_np.shape[0], bool)
    for i in range(est_np.shape[0]):
        p = cal_PESQ_norm(est_np[i], ref_np[i], fs)
        if p is not None:
            vals[i] = p
            valid[i] = True
    return (torch.from_numpy(vals).to(est.device),
            torch.from_numpy(valid).to(est.device))


def masked_mse(pred, target, valid):
    """sum(valid * (pred - target)^2) / max(sum(valid), 1)."""
    valid = valid.to(pred.dtype)
    err = (pred.reshape(-1) - target).square() * valid
    return err.sum() / valid.sum().clamp_min(1.0)


def estimates(outputs):
    """The waveform estimates of a model's (ests, logits) output: the 2-D
    entries of a list, or the one estimate."""
    ests, _ = outputs
    if isinstance(ests, (list, tuple)):
        return [e for e in ests if e is not None and e.dim() == 2]
    return [ests]


def dropout_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of D's dropout draw at `step`."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))


def make_gan_train_step(
    criterion: Sequence[Callable],
    loss_posi=((0,),),
    loss_weight=((1.0,),),
    multi_task: bool = False,
    gan_loss_weight: float = 0.05,
    metric_fn: Callable = metric_sisdr_norm,
    seed: int = 42,
):
    """-> step((gen_state, dis_state), batch) -> (states, metrics), the
    metrics {"loss", "se_loss", "d_loss"} as tensors on the device."""

    def step(states, batch):
        gen_state, dis_state = states
        gen, disc = gen_state.model, dis_state.model
        targets, mix = batch["wav_targets"], batch["wav_mix"]

        gen.train()
        outputs = gen(mix, batch["spk_embeds"])
        ests = [e.detach() for e in estimates(outputs)]
        noisy_m, noisy_valid = metric_fn(mix, targets)
        est_metrics = [metric_fn(e, targets) for e in ests]

        # D step; one dropout draw for every call of the step
        disc.train()
        mask = disc.dropout_mask(targets.shape[0],
                                 dropout_generator(seed, dis_state.step),
                                 targets.device)
        ones = torch.ones(targets.shape[0], device=targets.device)
        d_loss = masked_mse(disc(targets, targets, mask), ones, ones) \
            + masked_mse(disc(targets, mix, mask), noisy_m, noisy_valid)
        for e, (m, valid) in zip(ests, est_metrics):
            d_loss = d_loss + masked_mse(disc(targets, e, mask), m, valid)
        names = list(dis_state.optimizer.params)
        grads = torch.autograd.grad(
            d_loss, [dis_state.optimizer.params[n] for n in names])
        dis_state.optimizer.update(dict(zip(names, grads)))
        dis_state.step += 1

        # G step through the updated D, in eval mode, D's parameters held
        disc.eval()
        held = list(disc.parameters())
        for p in held:
            p.requires_grad_(False)
        try:
            se_loss = weighted_loss(outputs, targets, batch.get("spk_label"),
                                    criterion, loss_posi, loss_weight,
                                    multi_task)
            gan_loss = 0.0
            for e in estimates(outputs):
                gan_loss = gan_loss + (disc(targets, e).reshape(-1)
                                       - ones).square().mean()
        finally:
            for p in held:
                p.requires_grad_(True)
        g_loss = se_loss + gan_loss_weight * gan_loss
        names = list(gen_state.optimizer.params)
        grads = torch.autograd.grad(
            g_loss, [gen_state.optimizer.params[n] for n in names])
        gen_state.optimizer.update(dict(zip(names, grads)))
        gen_state.step += 1
        return (gen_state, dis_state), {"loss": g_loss.detach(),
                                        "se_loss": se_loss.detach(),
                                        "d_loss": d_loss.detach()}

    return step

"""Train and eval steps and the optimizer chain.

Counterpart of wesep_tpu/train/trainer.py, on one device a process.
The chain per update is the JAX package's: clip every parameter's gradient
to L2 norm `clip_grad` on its own (not a global norm) -> add
`weight_decay * p` (coupled L2, as torch.optim.Adam does) -> Adam with bias
correction -> times `schedule(step)`, the step counted from 0 at the first
update. `Optimizer` writes that chain out on tensors; its state (`count`,
`mu`, `nu` by parameter name) checkpoints with the model and can be filled
from the JAX package's optimizer state (utils/jax_params.py).

Loss weighting follows the (loss_posi, loss_weight) table: loss = sum_i
sum_j w[i][j] * mean(L_i(outputs[posi[i][j]], targets)), with CE routed to
`spk_label` when `multi_task`; a model that returns a list of estimates
(the multi-scale decoders) is indexed by position, the speaker logits last.
A train step runs the model in train mode, so BatchNorm statistics move
once per (micro)batch, in order; an eval step runs it in eval mode and
leaves them as they are. With `ssa_enroll_prob` > 0 (self-estimated
speech augmentation) a (micro)batch may first run a no-grad forward in
train mode whose estimate, as fbank after CMVN where the recipe feeds
fbank, becomes the enrollment of the loss forward; that pass's BatchNorm
statistics are thrown away, as the JAX package throws them away.

With `device_augment` (online mixing) a batch holds dry sources
`wav_srcs` [B, S, T] (and raw noise chunks `wav_noise` [B, T]) and the step
simulates each (micro)batch on its device in f32 (data/augment.py: FRAM-RIR
reverb, SNR mixing, additive noise) before the `compute_dtype` cast, then
repeats each mixture per target speaker (sample-major, speaker-minor) and
takes the scaled sources as the targets. Its draws come from a generator on
the batch's device seeded from (seed, step, microbatch); in a
data-parallel run every rank draws those of the global (micro)batch and
takes its own mixtures', so the ranks together simulate what one process
simulates on all their rows.

Data parallelism: when a process group of more than one rank is up, the
train step runs the model through DistributedDataParallel, so each rank's
gradient is the mean over every rank's rows; the wrapper sets the group
on the model's BatchNorms, so their batch statistics are every rank's too
(models/common.BatchNorm), and the loss the step
returns is the mean over ranks. The update then applies the same chain to
that gradient on every rank: the JAX package's step over a batch sharded
on its data axis, whose loss and statistics are those of the global batch.
Every rank must run the same number of steps.
"""

import contextlib
import dataclasses
import random
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from wesep_tpu_torch.data import augment
from wesep_tpu_torch.models.common import BatchNorm
from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank
from wesep_tpu_torch.train.losses import is_ce

__all__ = ["TrainState", "Optimizer", "per_param_clip", "make_optimizer",
           "weighted_loss", "make_train_step", "make_eval_step",
           "batch_to_device", "data_parallel_group", "data_parallel",
           "mean_over_ranks"]


@dataclasses.dataclass
class TrainState:
    """What a training run carries: the model (its parameters are updated
    in place), the optimizer with its state, the update count, and in a
    data-parallel run the model's DistributedDataParallel wrapper."""

    model: torch.nn.Module
    optimizer: "Optimizer"
    step: int = 0
    replica: Optional[torch.nn.Module] = dataclasses.field(default=None,
                                                          repr=False)


def data_parallel_group():
    """The default process group while one of more than one rank is up
    (a data-parallel run), else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def data_parallel(state: TrainState):
    """The DistributedDataParallel wrapper of `state.model` while a process
    group of more than one rank is up (made on first use; it broadcasts
    rank 0's parameters), else None. Buffers are not broadcast: they start
    equal, and the wrapper sets the group on the model's BatchNorms, which
    then move them by every rank's statistics."""
    group = data_parallel_group()
    if group is None:
        return None
    if state.replica is None:
        from torch.nn.parallel import DistributedDataParallel

        for module in state.model.modules():
            if isinstance(module, BatchNorm):
                module.group = group
        device = next(state.model.parameters()).device
        state.replica = DistributedDataParallel(
            state.model,
            device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)
    return state.replica


def mean_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """A scalar's mean over the ranks of a data-parallel run (itself
    otherwise)."""
    group = data_parallel_group()
    if group is None:
        return value
    import torch.distributed as dist

    total = value.detach().clone()
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group)


def per_param_clip(grad: torch.Tensor, clip: float) -> torch.Tensor:
    """Scale one parameter's gradient so its L2 norm is at most `clip`:
    coefficient min(clip / (norm + 1e-6), 1)."""
    norm = grad.float().square().sum().sqrt()
    coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
    return (grad * coef).to(grad.dtype)


class Optimizer:
    """clip per parameter -> + weight_decay * p -> Adam -> * schedule(count).

    `params` maps names to the tensors it updates in place; those whose
    top-level name is in `freeze_prefixes` get no update and carry no
    state."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable,
                 weight_decay: float = 1e-4, clip_grad: float = 5.0,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 freeze_prefixes: Sequence[str] = ()):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.params = {
            name: p for name, p in params.items()
            if name.split(".")[0] not in freeze_prefixes
        }
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> float:
        """Apply one update from `grads` (by name); return the rate used."""
        lr = float(self.schedule(self.count))
        self.count += 1
        correct1 = 1.0 - self.beta1 ** self.count
        correct2 = 1.0 - self.beta2 ** self.count
        for name, p in self.params.items():
            g = grads[name]
            if self.clip_grad and self.clip_grad > 0:
                g = per_param_clip(g, self.clip_grad)
            if self.weight_decay and self.weight_decay > 0:
                g = g + self.weight_decay * p
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(self.beta1).add_(g, alpha=1.0 - self.beta1)
            nu.mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            step = (mu / correct1) / ((nu / correct2).sqrt() + self.eps)
            p.sub_(lr * step)
        return lr

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": {n: t.detach().clone() for n, t in self.mu.items()},
                "nu": {n: t.detach().clone() for n, t in self.nu.items()}}

    def load_state_dict(self, state: dict):
        if set(state["mu"]) != set(self.mu) or set(state["nu"]) != set(self.nu):
            raise ValueError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        with torch.no_grad():
            for name in self.mu:
                self.mu[name].copy_(state["mu"][name])
                self.nu[name].copy_(state["nu"][name])


def make_optimizer(
    params,
    schedule: Callable,
    weight_decay: float = 1e-4,
    clip_grad: float = 5.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    freeze_prefixes: Sequence[str] = (),
) -> Optimizer:
    """The chain over `params`: a module (its named parameters) or a dict
    of named tensors."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return Optimizer(params, schedule, weight_decay, clip_grad, beta1, beta2,
                     eps, freeze_prefixes)


def _flatten_outputs(outputs):
    """Model returns (ests, spk_logits); flatten to an indexable list.
    Multi-decoder models return ests as a list, so positions 0.. index the
    scales and the last the speaker logits."""
    ests, spk_logits = outputs
    flat = list(ests) if isinstance(ests, (list, tuple)) else [ests]
    flat.append(spk_logits)
    return flat


def weighted_loss(outputs, targets, spk_label, criterion: Sequence[Callable],
                  loss_posi: Sequence[Sequence[int]],
                  loss_weight: Sequence[Sequence[float]],
                  multi_task: bool = False):
    """The (loss_posi, loss_weight) double loop."""
    flat = _flatten_outputs(outputs)
    total = 0.0
    for i, crit in enumerate(criterion):
        for j in range(len(loss_posi[i])):
            out = flat[loss_posi[i][j]]
            ref = spk_label if multi_task and is_ce(crit) else targets
            total = total + loss_weight[i][j] * crit(out, ref).mean()
    return total


def batch_to_device(batch: dict, device) -> dict:
    """The numeric arrays of a host batch as tensors on `device`."""
    return {
        k: torch.from_numpy(v).to(device) for k, v in batch.items()
        if isinstance(v, np.ndarray) and v.dtype.kind in "fiu"
    }


def _split(batch: dict, accum_steps: int, i: int) -> dict:
    """Microbatch i of `accum_steps`: every leaf split by its own rows (a
    batch simulated on the device has B mixtures in `wav_srcs` and B * S
    enrollment rows)."""
    if accum_steps <= 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % accum_steps:
            raise ValueError(f"accum_steps={accum_steps} must divide batch "
                             f"rows {v.shape[0]} of {k}")
        size = v.shape[0] // accum_steps
        out[k] = v[i * size:(i + 1) * size]
    return out


def _rank_and_world():
    group = data_parallel_group()
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def make_train_step(
    criterion: Sequence[Callable],
    loss_posi: Sequence[Sequence[int]] = ((0,),),
    loss_weight: Sequence[Sequence[float]] = ((1.0,),),
    multi_task: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    ssa_enroll_prob: float = 0.0,
    ssa_speaker_feat: bool = True,
    fbank_args: Optional[dict] = None,
    sample_rate: int = 16000,
    seed: int = 42,
    device_augment: Optional[dict] = None,
    accum_steps: int = 1,
):
    """Build `train_step(state, batch) -> (state, {"loss": tensor})`.

    `compute_dtype` casts the mixture and the enrollment (parameters stay
    f32; every module computes in its input's dtype). accum_steps > 1
    splits the batch's rows into that many equal microbatches, averages
    their gradients and losses and applies one update. The loss comes back
    as a tensor on the device, so nothing waits on the host per batch.

    `device_augment`: {reverb_prob, use_random_snr (default true),
    noise_prob, noise_snr, sample_rate} of the simulation on the device;
    the batch then holds `wav_srcs` (and `wav_noise`), see above.

    `ssa_enroll_prob`: each (micro)batch, with that probability (a coin
    from a generator seeded with `seed`, apart from Python's global
    `random` that the data chain draws from), the enrollment of the loss
    forward is the model's own first estimate from a no-grad forward in
    train mode on the batch's enrollment; with `ssa_speaker_feat` that
    estimate's Kaldi fbank (`fbank_args`, dither 0, int16 scale) after
    CMVN, computed on the batch's device.
    """
    coin = random.Random(seed)
    aug = dict(device_augment) if device_augment is not None else None
    fa = fbank_args or {}

    def cast(mix, enroll):
        if compute_dtype is None:
            return mix, enroll
        return mix.to(compute_dtype), enroll.to(compute_dtype)

    @torch.no_grad()
    def ssa_enroll(model, mb):
        saved = [b.clone() for b in model.buffers()]
        est = model(*cast(mb["wav_mix"], mb["spk_embeds"]))[0]
        for b, old in zip(model.buffers(), saved):
            b.copy_(old)
        if isinstance(est, (list, tuple)):
            est = est[0]
        if not ssa_speaker_feat:
            return est
        return apply_cmvn(kaldi_fbank(
            est, sample_rate=sample_rate,
            num_mel_bins=fa.get("num_mel_bins", 80),
            frame_length_ms=fa.get("frame_length", 25),
            frame_shift_ms=fa.get("frame_shift", 10), dither=0.0,
            input_scale=32768.0))

    def simulate(mb, step, micro):
        """The (micro)batch with its mixtures simulated on its device: the
        draws of the global (micro)batch, this rank's mixtures of them."""
        srcs = mb["wav_srcs"].float()
        b, n_spk, t = srcs.shape
        noise = mb.get("wav_noise")
        rank, world = _rank_and_world()
        cfg = augment.RirConfig(sr=aug.get("sample_rate", sample_rate),
                                num_src=n_spk)
        reverb_prob = aug.get("reverb_prob", 0.0)
        noise_prob = aug.get("noise_prob", 0.0) if noise is not None else 0.0
        draws = augment.draw_augment(
            augment.step_generator(seed, step, micro, srcs.device),
            b * world, n_spk, cfg, reverb_prob,
            aug.get("use_random_snr", True), noise_prob,
            tuple(aug.get("noise_snr", (-5.0, 25.0))))
        mix, scaled = augment.augment_batch(
            srcs, augment.take_rows(draws, rank * b, b),
            None if noise is None else noise.float(), cfg, reverb_prob,
            noise_prob)
        out = dict(mb)
        out["wav_mix"] = mix.repeat_interleave(n_spk, 0)
        out["wav_targets"] = scaled.reshape(b * n_spk, t)
        return out

    def loss_of(model, net, mb):
        """The weighted loss of a (micro)batch through `net` (the model or
        its data-parallel wrapper)."""
        enroll = mb["spk_embeds"]
        if ssa_enroll_prob > 0 and coin.random() < ssa_enroll_prob:
            enroll = ssa_enroll(model, mb)
        return weighted_loss(net(*cast(mb["wav_mix"], enroll)),
                             mb["wav_targets"], mb.get("spk_label"),
                             criterion, loss_posi, loss_weight, multi_task)

    def replica_grads(model, replica, mb_loss, params, sync):
        """The data-parallel backward: DistributedDataParallel all-reduces
        the gradients in the backward of the microbatch that syncs (the
        others accumulate in .grad under no_sync)."""
        with contextlib.nullcontext() if sync else replica.no_sync():
            mb_loss.backward()
        if not sync:
            return None
        grads = [p.grad for p in params]
        for p in model.parameters():
            p.grad = None
        return grads

    def train_step(state: TrainState, batch):
        model, optimizer = state.model, state.optimizer
        model.train()
        replica = data_parallel(state)
        net = model if replica is None else replica
        names = list(optimizer.params)
        params = [optimizer.params[n] for n in names]
        grads, loss = None, 0.0
        for i in range(accum_steps):
            mb = _split(batch, accum_steps, i)
            if aug is not None:
                mb = simulate(mb, state.step, i)
            mb_loss = loss_of(model, net, mb)
            if replica is not None:
                grads = replica_grads(model, replica, mb_loss, params,
                                      sync=i + 1 == accum_steps)
            else:
                mb_grads = torch.autograd.grad(mb_loss, params)
                grads = mb_grads if grads is None else [
                    a + b for a, b in zip(grads, mb_grads)]
            loss = loss + mb_loss.detach()
        if accum_steps > 1:
            grads = [g / accum_steps for g in grads]
            loss = loss / accum_steps
        optimizer.update(dict(zip(names, grads)))
        state.step += 1
        return state, {"loss": mean_over_ranks(loss)}

    return train_step


def make_eval_step(criterion: Sequence[Callable]):
    """Validation step: criterion[0] on the primary output, no gradient;
    in a data-parallel run the mean over every rank's rows."""

    def eval_step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad():
            flat = _flatten_outputs(
                state.model(batch["wav_mix"], batch["spk_embeds"]))
            loss = criterion[0](flat[0], batch["wav_targets"]).mean()
        return {"loss": mean_over_ranks(loss)}

    return eval_step

"""Train and eval steps and the optimizer chain.

Counterpart of wesep_tpu/train/trainer.py for one process and one device.
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
leaves them as they are.
"""

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from wesep_tpu_torch.train.losses import is_ce

__all__ = ["TrainState", "Optimizer", "per_param_clip", "make_optimizer",
           "weighted_loss", "make_train_step", "make_eval_step",
           "batch_to_device"]


@dataclasses.dataclass
class TrainState:
    """What a training run carries: the model (its parameters are updated
    in place), the optimizer with its state, and the update count."""

    model: torch.nn.Module
    optimizer: "Optimizer"
    step: int = 0


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


def make_train_step(
    criterion: Sequence[Callable],
    loss_posi: Sequence[Sequence[int]] = ((0,),),
    loss_weight: Sequence[Sequence[float]] = ((1.0,),),
    multi_task: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    ssa_enroll_prob: float = 0.0,
    device_augment: Optional[dict] = None,
    accum_steps: int = 1,
):
    """Build `train_step(state, batch) -> (state, {"loss": tensor})`.

    `compute_dtype` casts the mixture and the enrollment (parameters stay
    f32; every module computes in its input's dtype). accum_steps > 1
    splits the batch's rows into that many equal microbatches, averages
    their gradients and losses and applies one update. The loss comes back
    as a tensor on the device, so nothing waits on the host per batch.
    """
    if ssa_enroll_prob and ssa_enroll_prob > 0:
        raise NotImplementedError(
            "SSA_enroll_prob > 0 (self-estimated speech augmentation) needs "
            "ops/fbank, which is not ported yet; see ROADMAP.md queue A, "
            "the joint v2 BSRNN")
    if device_augment is not None:
        raise NotImplementedError(
            "device_augment (online mixing on the device) needs "
            "data/augment, which is not ported yet; see ROADMAP.md queue A, "
            "device augmentation")

    def loss_of(model, mb):
        mix, enroll = mb["wav_mix"], mb["spk_embeds"]
        if compute_dtype is not None:
            mix, enroll = mix.to(compute_dtype), enroll.to(compute_dtype)
        return weighted_loss(model(mix, enroll), mb["wav_targets"],
                             mb.get("spk_label"), criterion, loss_posi,
                             loss_weight, multi_task)

    def train_step(state: TrainState, batch):
        model, optimizer = state.model, state.optimizer
        model.train()
        names = list(optimizer.params)
        params = [optimizer.params[n] for n in names]
        if accum_steps <= 1:
            loss = loss_of(model, batch)
            grads = torch.autograd.grad(loss, params)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % accum_steps:
                raise ValueError(f"accum_steps={accum_steps} must divide "
                                 f"batch rows {rows}")
            size = rows // accum_steps
            grads, loss = None, 0.0
            for i in range(accum_steps):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_loss = loss_of(model, mb)
                mb_grads = torch.autograd.grad(mb_loss, params)
                grads = mb_grads if grads is None else [
                    a + b for a, b in zip(grads, mb_grads)]
                loss = loss + mb_loss.detach()
            grads = [g / accum_steps for g in grads]
            loss = loss / accum_steps
        optimizer.update(dict(zip(names, grads)))
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_eval_step(criterion: Sequence[Callable]):
    """Validation step: criterion[0] on the primary output, no gradient."""

    def eval_step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad():
            flat = _flatten_outputs(
                state.model(batch["wav_mix"], batch["spk_embeds"]))
            loss = criterion[0](flat[0], batch["wav_targets"]).mean()
        return {"loss": loss}

    return eval_step

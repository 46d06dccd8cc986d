"""Per-iteration learning-rate schedules as pure `step -> lr` functions.

Counterpart of wesep_tpu/train/schedulers.py. A schedule is a Python
function of the integer step (0 at the first update); the train step sets
the optimizer's learning rate from it before every update, and the step
checkpoints with the optimizer state.

  ExponentialDecrease  warm-up coefficient * initial_lr *
                       exp(t / T * log(final / initial))
  TriAngular2          cyclic triangular, the peak halving every cycle
  margin_scheduler     margin ramp for margin-based speaker losses
"""

import math
from typing import Callable

__all__ = ["exponential_decrease", "triangular2", "margin_scheduler",
           "get_scheduler"]


def _warm_coeff(step, warm_up_iter, scale_ratio, warm_from_zero):
    """Multi-process warm-up coefficient."""
    if warm_up_iter <= 0 or step >= warm_up_iter:
        return 1.0 * scale_ratio
    if warm_from_zero:
        return scale_ratio * step / warm_up_iter
    if scale_ratio > 1:
        return (scale_ratio - 1) * step / warm_up_iter + 1.0
    return 1.0 * scale_ratio


def exponential_decrease(
    num_epochs: int,
    epoch_iter: int,
    initial_lr: float,
    final_lr: float,
    warm_up_epoch: int = 6,
    scale_ratio: float = 1.0,
    warm_from_zero: bool = False,
) -> Callable:
    max_iter = num_epochs * epoch_iter
    warm_up_iter = warm_up_epoch * epoch_iter
    log_ratio = math.log(final_lr / initial_lr)

    def schedule(step):
        step = int(step)
        coeff = _warm_coeff(step, warm_up_iter, scale_ratio, warm_from_zero)
        return coeff * initial_lr * math.exp(step / max_iter * log_ratio)

    return schedule


def triangular2(
    num_epochs: int,
    epoch_iter: int,
    initial_lr: float,
    final_lr: float,
    warm_up_epoch: int = 6,
    scale_ratio: float = 1.0,
    cycle_step: int = 2,
    reduce_lr_diff_ratio: float = 0.5,
) -> Callable:
    del num_epochs
    warm_up_iter = warm_up_epoch * epoch_iter
    cycle_iter = cycle_step * epoch_iter
    step_size = cycle_iter // 2
    min_lr = final_lr
    gap = initial_lr - final_lr

    def schedule(step):
        step = int(step)
        coeff = _warm_coeff(step, warm_up_iter, scale_ratio, False)
        point = step % cycle_iter
        max_lr = min_lr + gap * reduce_lr_diff_ratio ** (step // cycle_iter)
        if point <= step_size:
            lr = min_lr + (max_lr - min_lr) * point / step_size
        else:
            lr = max_lr - (max_lr - min_lr) * (point - step_size) / step_size
        return coeff * lr

    return schedule


def margin_scheduler(
    initial_margin: float = 0.0,
    final_margin: float = 0.2,
    increase_start_epoch: int = 1,
    fix_start_epoch: int = 1,
    epoch_iter: int = 1,
    increase_type: str = "exp",
) -> Callable:
    """Margin ramp for margin-based speaker losses."""
    increase_start_iter = (increase_start_epoch - 1) * epoch_iter
    fix_start_iter = (fix_start_epoch - 1) * epoch_iter
    increase_iter = max(fix_start_iter - increase_start_iter, 1)

    def schedule(step):
        step = float(step)
        if step >= fix_start_iter:
            return final_margin
        if step < increase_start_iter:
            return initial_margin
        cur = step - increase_start_iter
        if increase_type == "exp":
            ratio = 1.0 - math.exp(
                cur / increase_iter * math.log(1e-3 / (1.0 + 1e-6)))
        else:
            ratio = cur / increase_iter
        return initial_margin + (final_margin - initial_margin) * ratio

    return schedule


_SCHEDULERS = {
    "ExponentialDecrease": exponential_decrease,
    "TriAngular2": triangular2,
}


def get_scheduler(name: str, **kwargs) -> Callable:
    if name not in _SCHEDULERS:
        raise ValueError(
            f"Unknown scheduler {name!r}; have {sorted(_SCHEDULERS)}")
    return _SCHEDULERS[name](**kwargs)

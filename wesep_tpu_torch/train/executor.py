"""Epoch-level train and validation loops around the train and eval steps.

Counterpart of wesep_tpu/train/executor.py for one process: it feeds
batches, paces logging and averages losses. The steps return their loss as
a tensor on the device; it is fetched only at log points and at the end of
the epoch, so the device never waits on the host between batches. The
multi-process stop vote of the JAX package comes with the data-parallel
slice; here `should_stop` is this process's own flag.
"""

from typing import Callable, Optional

from wesep_tpu_torch.utils.config import table_row
from wesep_tpu_torch.utils.profiling import ThroughputMeter

__all__ = ["Executor"]


def _mean(losses) -> float:
    return sum(float(x) for x in losses) / len(losses) if losses else 0.0


class Executor:
    def __init__(self):
        self.step = 0
        self.stopped = False

    def train(self, dataloader, train_step: Callable, state, epoch_iter: int,
              epoch: int, logger=None, log_batch_interval: int = 100,
              device_put: Optional[Callable] = None,
              sample_rate: int = 16000,
              should_stop: Optional[Callable[[], bool]] = None):
        """One training epoch -> (state, avg_loss).

        `should_stop` is checked between batches and asks for a clean
        early exit (the preemption hook); `self.stopped` says whether the
        epoch ended early, so the caller can checkpoint and shut down."""
        self.stopped = False
        losses = []
        meter = ThroughputMeter(sample_rate=sample_rate)
        for i, batch in enumerate(dataloader):
            if should_stop is not None and should_stop():
                self.stopped = True
                if logger:
                    logger.warning(
                        "stop requested: ending epoch %d after %d batches",
                        epoch, i)
                break
            meter.update(batch)
            if device_put is not None:
                batch = device_put(batch)
            state, metrics = train_step(state, batch)
            losses.append(metrics["loss"])
            self.step += 1
            if logger and (i + 1) % log_batch_interval == 0:
                logger.info(table_row((
                    "TRAIN", epoch, i + 1, _mean(losses),
                    f"{meter.audio_sec_per_sec():.0f}as/s")))
            if (i + 1) == epoch_iter:
                break
        avg = _mean(losses)
        if logger:
            logger.info("epoch %d throughput: %s", epoch, meter.summary())
        return state, avg

    def cv(self, dataloader, eval_step: Callable, state, val_iter: int,
           epoch: int, logger=None, log_batch_interval: int = 100,
           device_put: Optional[Callable] = None):
        """Validation epoch -> avg loss on criterion[0]."""
        losses = []
        for i, batch in enumerate(dataloader):
            if device_put is not None:
                batch = device_put(batch)
            losses.append(eval_step(state, batch)["loss"])
            if logger and (i + 1) % log_batch_interval == 0:
                logger.info(table_row(
                    ("VAL", epoch, i + 1, _mean(losses), "-")))
            if (i + 1) == val_iter:
                break
        return _mean(losses)

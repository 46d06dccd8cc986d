"""The (data x model) grid of process groups behind `model_axis`.

Counterpart of the JAX package's 2-D device mesh (wesep_tpu/bin/train.py:
`model_axis: M` reshapes the devices to (N / M data) x (M model)), with
one process a card: rank r of N sits at data index r // M and model index
r % M, so that rank = d * M + m as `devices.reshape(data, model)` numbers
them. The ranks of one model group (same d) run the same rows: the
group's first rank reads them and sends each batch to the others
(`Mesh.shared_batches`), which read nothing; a model that shards
(TF-GridNet with `shard_model_axis`) splits its folded batch over them at
the places where the JAX model places that batch on ('data', 'model') and
gathers it back with `gather_rows`, an all-gather whose backward sums the
incoming gradients over the group. The ranks of one data group (same m)
hold distinct rows: BatchNorm statistics are reduced over it.

Gradients: every rank of a model group computes the same loss, so the
gradients it finds for any tensor sum, over the group, to M times the
gradient of that loss: downstream of a gather each rank holds the whole
gradient, and the gather's backward hands each rank M times the gradient
of its own share (the sum of the M equal copies), which flows upstream only
into that share. The mean over all N ranks that the train step takes
after the backward (train/trainer.py) then gives M / N = 1 / (N / M)
times the sum of the data groups' gradients: the data-parallel mean, for
sharded and redundant parameters alike.

Convolutions: cuDNN's default backward algorithms for TF-GridNet's
convolutions sum in an order that changes from call to call, so one
process's first f32 gradient of the same step differs from itself by up to
6e-4 rel. L2 on the card; the grid steps run under
`deterministic_convolutions` (ROADMAP.md C.3b).
"""

import contextlib
import dataclasses
import math
from typing import Optional

import torch

__all__ = ["Mesh", "make_mesh", "shard_rows", "gather_rows", "run_sharded",
           "deterministic_convolutions"]


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms, benchmark off, inside the block;
    both flags restored after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its two groups (None for a group
    of one rank)."""

    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def attach(self, model: torch.nn.Module):
        """Set the groups on a model: its BatchNorms reduce over the data
        group, and a model that shards over the model axis takes the model
        group."""
        from wesep_tpu_torch.models.common import BatchNorm

        for module in model.modules():
            if isinstance(module, BatchNorm):
                module.group = self.data_group
        set_group = getattr(model, "set_model_group", None)
        if set_group is not None:
            set_group(self.model_group)
        return model

    def shared_batches(self, loader):
        """The batches of the model group's first rank, on every rank of
        the group: that rank iterates `loader` and sends each batch (any
        shapes) to the others, which do not read theirs; the end of its
        loader ends theirs. A gather of shares of different rows would
        compute nothing meaningful, and a loader's prefetch threads draw
        from Python's global random in an order of their own."""
        if self.model_group is None:
            yield from loader
            return
        import torch.distributed as dist

        src = dist.get_global_rank(self.model_group, 0)
        batches = iter(loader) if self.model_rank == 0 else None
        while True:
            box = [next(batches, None) if batches is not None else None]
            dist.broadcast_object_list(box, src, group=self.model_group)
            if box[0] is None:
                return
            yield box[0]


def make_mesh(model_axis: int) -> Mesh:
    """The grid of the running process group at `model_axis` model ranks (a
    divisor of the world size: bin/train's set-up checks it, as the JAX
    package does). Every rank must call it, in the same order: it makes
    every group of the grid on every rank."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    data = world // model_axis
    data_groups = [dist.new_group([d * model_axis + m for d in range(data)])
                   for m in range(model_axis)]
    model_groups = [dist.new_group([d * model_axis + m
                                    for m in range(model_axis)])
                    for d in range(data)]
    d, m = divmod(rank, model_axis)
    return Mesh(d, data, m, model_axis,
                data_groups[m] if data > 1 else None, model_groups[d])


def shard_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of x's rows (dim 0) over `group`: the rows padded
    with zeros to a multiple of the group's size, then the rank's equal
    slice of them."""
    import torch.distributed as dist

    size, rank = dist.get_world_size(group), dist.get_rank(group)
    share = math.ceil(x.shape[0] / size)
    pad = share * size - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x[rank * share:(rank + 1) * share]


class _GatherRows(torch.autograd.Function):
    """All-gather of equal shares along dim 0, cut to `rows`; the backward
    sums the gradient over the group and returns this rank's share."""

    @staticmethod
    def forward(ctx, local, group, rows):
        import torch.distributed as dist

        size, rank = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.share = group, rank, local.shape[0]
        ctx.padded = local.shape[0] * size
        return torch.cat(parts)[:rows]

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        pad = ctx.padded - grad.shape[0]
        full = torch.cat([grad, grad.new_zeros((pad,) + grad.shape[1:])]) \
            if pad else grad.contiguous().clone()
        dist.all_reduce(full, group=ctx.group)
        start = ctx.rank * ctx.share
        return full[start:start + ctx.share], None, None


def gather_rows(local: torch.Tensor, group, rows: int) -> torch.Tensor:
    """The inverse of shard_rows: every rank's share, in rank order, with
    the padding dropped (`rows` rows); gradients flow back to each share."""
    return _GatherRows.apply(local, group, rows)


def run_sharded(fn, group, *xs):
    """fn over the model axis' shares of xs' rows (dim 0), the result put
    back together: with no group, fn(*xs); with a process group, fn on this
    rank's share (shard_rows), gathered back (gather_rows); with an int n,
    fn on each of the n shares in turn in this process, padded as
    shard_rows pads them, the outputs concatenated and cut back. The last
    is the grid's reference in one process: every call inside fn sees the
    rows it sees on a rank of a model group of n (so cuDNN and cuBLAS pick
    the algorithms they pick there), and the shares' gradients meet in the
    concatenation's backward."""
    if group is None:
        return fn(*xs)
    rows = xs[0].shape[0]
    if not isinstance(group, int):
        return gather_rows(fn(*(shard_rows(x, group) for x in xs)), group,
                           rows)
    share = math.ceil(rows / group)
    pad = share * group - rows
    if pad:
        xs = [torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in xs]
    return torch.cat([fn(*(x[i * share:(i + 1) * share] for x in xs))
                      for i in range(group)])[:rows]

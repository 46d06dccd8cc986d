"""Shard-list iteration with deterministic per-rank sharding.

Counterpart of wesep_tpu/data/datalist.py for one pass over a test list:
an optional seeded shuffle, then data[rank::world_size]. Rank and world
size come from the arguments or, where a process group is up, from
torch.distributed. Epochs, repetition and loader workers come with the
training slice.
"""

import random
from typing import Iterator, List, Optional

__all__ = ["DataList"]


def _process_group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataList:
    """Iterable over {src, rank, world_size} dicts, this rank's share."""

    def __init__(self, lists: List[str], shuffle: bool = False,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        self.lists = lists
        self.shuffle = shuffle
        if rank is None or world_size is None:
            pg_rank, pg_world = _process_group()
            rank = pg_rank if rank is None else rank
            world_size = pg_world if world_size is None else world_size
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[dict]:
        data = list(range(len(self.lists)))
        if self.shuffle:
            # seed -1: the JAX DataList's seed before any set_epoch
            random.Random(-1).shuffle(data)
        if len(data) > 1:  # a single shard goes to every rank, as in JAX
            data = data[self.rank::self.world_size]
        for index in data:
            yield dict(src=self.lists[index], rank=self.rank,
                       world_size=self.world_size)

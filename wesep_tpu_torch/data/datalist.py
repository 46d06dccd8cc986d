"""Shard-list iteration with deterministic (epoch, rank, worker) sharding.

Counterpart of wesep_tpu/data/datalist.py: an epoch-seeded global shuffle,
then data[rank::world_size][worker_id::num_workers]. Rank and world size
come from the arguments or, where a process group is up, from
torch.distributed; workers from the loader. With `repeat_dataset` the list
is cycled without end and the caller bounds the epoch.
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
    """Iterable over {src, rank, world_size, worker_id, num_workers} dicts,
    this rank's and worker's share."""

    def __init__(self, lists: List[str], shuffle: bool = False,
                 partition: bool = True, repeat_dataset: bool = False,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 worker_id: int = 0, num_workers: int = 1):
        self.lists = lists
        self.shuffle = shuffle
        self.partition = partition
        self.repeat_dataset = repeat_dataset
        if rank is None or world_size is None:
            pg_rank, pg_world = _process_group()
            rank = pg_rank if rank is None else rank
            world_size = pg_world if world_size is None else world_size
        self.rank = rank
        self.world_size = world_size
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.epoch = -1  # the seed before any set_epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _sample(self) -> List[int]:
        data = list(range(len(self.lists)))
        if len(data) <= self.num_workers:
            # too few shards to split: every rank and worker reads them all
            if self.shuffle:
                random.Random(self.epoch).shuffle(data)
        else:
            if self.partition:
                if self.shuffle:
                    random.Random(self.epoch).shuffle(data)
                data = data[self.rank::self.world_size]
            data = data[self.worker_id::self.num_workers]
        return data

    def __iter__(self) -> Iterator[dict]:
        info = dict(rank=self.rank, world_size=self.world_size,
                    worker_id=self.worker_id, num_workers=self.num_workers)
        indexes = self._sample()
        if not self.repeat_dataset:
            for index in indexes:
                yield dict(src=self.lists[index], **info)
            return
        counter = 0
        while True:
            index = indexes[counter % len(indexes)]
            counter += 1
            yield dict(src=self.lists[index], **info)

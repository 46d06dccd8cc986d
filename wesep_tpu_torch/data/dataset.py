"""Dataset chain and collators of the serving path.

Counterpart of wesep_tpu/data/dataset.py for state="test" with
pre-extracted embeddings (joint_training=False) on whole utterances: the
chain is a plain iterable of sample dicts, and the collators turn lists of
samples into fixed-shape numpy batches {wav_mix, wav_targets, spk_embeds,
key, spk}, one row per target speaker. Training chains (chunking, online
mixing, augmentation, enrollment wavs) come with later slices.
"""

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from wesep_tpu_torch.data import processor
from wesep_tpu_torch.data.datalist import DataList
from wesep_tpu_torch.utils.file_utils import read_lists

__all__ = ["Dataset", "tse_collate_fn", "tse_collate_fn_2spk", "BatchLoader"]


class _Chain:
    """Composable generator chain."""

    def __init__(self, source, fn=None, *args, **kw):
        self.source = source
        self.fn = fn
        self.args = args
        self.kw = kw

    def __iter__(self):
        if self.fn is None:
            return iter(self.source)
        return self.fn(iter(self.source), *self.args, **self.kw)

    def apply(self, fn, *args, **kw):
        return _Chain(self, fn, *args, **kw)


def Dataset(
    data_type: str,
    data_list_file: str,
    configs: dict,
    spk2embed_dict=None,
    spk1_embed=None,
    spk2_embed=None,
    state: str = "test",
    joint_training: bool = False,
    whole_utt: bool = True,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
):
    """Test-set chain: open -> group/parse -> [shuffle] -> resample ->
    fixed embeddings."""
    if state != "test" or joint_training or not whole_utt:
        raise NotImplementedError(
            "only the test chain (state='test', whole utterances, "
            "pre-extracted embeddings) is ported; training chains come "
            "with the training slice"
        )
    if data_type not in ("shard", "raw"):
        raise ValueError(f"data_type must be shard or raw, not {data_type}")
    shuffle = configs.get("shuffle", False)
    chain = _Chain(DataList(read_lists(data_list_file), shuffle=shuffle,
                            rank=rank, world_size=world_size))
    if data_type == "shard":
        chain = chain.apply(processor.url_opener)
        chain = chain.apply(processor.tar_file_and_group)
    else:
        chain = chain.apply(processor.parse_raw)
    if shuffle:
        chain = chain.apply(processor.shuffle,
                            **configs.get("shuffle_args", {}))
    chain = chain.apply(processor.resample,
                        configs.get("resample_rate", 16000))
    return chain.apply(processor.sample_fix_spk_embedding,
                       spk2embed_dict, spk1_embed, spk2_embed)


def tse_collate_fn(batch: List[dict]) -> dict:
    """Expand each mixture into num_speaker rows (sample-major,
    speaker-minor). Pre-extracted embeddings all have one width, so rows
    stack without padding or trimming."""
    wav_mix, wav_targets, spk_embeds, spk, key = [], [], [], [], []
    for s in batch:
        for i in range(s["num_speaker"]):
            wav_mix.append(s["wav_mix"])
            wav_targets.append(s[f"wav_spk{i + 1}"])
            spk_embeds.append(np.asarray(s[f"embed_spk{i + 1}"]))
            spk.append(s[f"spk{i + 1}"])
            key.append(s["key"])
    return {
        "wav_mix": np.concatenate(wav_mix).astype(np.float32),
        "wav_targets": np.concatenate(wav_targets).astype(np.float32),
        "spk_embeds": np.concatenate(spk_embeds).astype(np.float32),
        "spk": spk,
        "key": key,
    }


def tse_collate_fn_2spk(batch: List[dict]) -> dict:
    """Two-speaker variant: num_speaker defaults to 2."""
    for s in batch:
        s.setdefault("num_speaker", 2)
    return tse_collate_fn(batch)


class BatchLoader:
    """Batches an iterable dataset with a collate fn; a background thread
    keeps `prefetch` batches ready."""

    def __init__(self, dataset, batch_size: int = 8,
                 collate_fn=tse_collate_fn, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.prefetch = prefetch

    def _batches(self) -> Iterator[dict]:
        buf = []
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()

        def producer():
            # an exception in the chain surfaces in the consumer
            try:
                for b in self._batches():
                    q.put(b)
                q.put(end)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()

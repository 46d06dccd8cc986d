"""Dataset chains, collators and loaders.

Counterpart of wesep_tpu/data/dataset.py for premixed data
(online_mix=False): a chain is a plain iterable of sample dicts, and the
collators turn lists of samples into fixed-shape numpy batches {wav_mix,
wav_targets, spk_embeds, spk_label, key, spk}, one row per target speaker.
`state` picks the chain: "train" draws a random chunk and a random cue of
each target speaker, "val" and "test" take the fixed enrollment the lists
name. The cue is a pre-extracted embedding or, with `joint_training`, an
enrollment waveform (and the speaker's class label where `dict_spk` is
given); the collators bring the waveforms to one length
(`fixed_enroll_len`). Online mixing, noise, reverberation and fbank
features of the enrollment are not ported yet.
"""

import logging
import multiprocessing
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from wesep_tpu_torch.data import processor
from wesep_tpu_torch.data.datalist import DataList
from wesep_tpu_torch.utils.file_utils import read_lists

__all__ = ["Dataset", "tse_collate_fn", "tse_collate_fn_2spk", "BatchLoader",
           "MultiWorkerLoader"]


class _Chain:
    """Composable generator chain with set_epoch plumbed to the DataList."""

    def __init__(self, source, fn=None, *args, **kw):
        self.source = source
        self.fn = fn
        self.args = args
        self.kw = kw

    def set_epoch(self, epoch: int):
        self.source.set_epoch(epoch)

    def __iter__(self):
        if self.fn is None:
            return iter(self.source)
        return self.fn(iter(self.source), *self.args, **self.kw)

    def apply(self, fn, *args, **kw):
        return _Chain(self, fn, *args, **kw)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (see ROADMAP.md queue A); the port's data "
        "chain reads premixed data with pre-extracted embeddings or "
        "enrollment wavs")


def Dataset(
    data_type: str,
    data_list_file: str,
    configs: dict,
    spk2embed_dict=None,
    spk1_embed=None,
    spk2_embed=None,
    state: str = "train",
    joint_training: bool = False,
    dict_spk=None,
    whole_utt: bool = False,
    repeat_dataset: bool = False,
    noise_prob: float = 0,
    reverb_prob: float = 0,
    noise_enroll_prob: float = 0,
    reverb_enroll_prob: float = 0,
    specaug_enroll_prob: float = 0,
    noise_lmdb_file: Optional[str] = None,
    online_mix: bool = False,
    device_augment: bool = False,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    worker_id: int = 0,
    num_workers: int = 1,
):
    """Build the streaming chain: open -> group/parse -> [filter] ->
    [shuffle] -> resample -> [random chunk] -> embeddings or enrollment
    wavs."""
    if data_type not in ("shard", "raw"):
        raise ValueError(f"data_type must be shard or raw, not {data_type}")
    if joint_training and configs.get("speaker_feat", False):
        _not_ported("speaker_feat (fbank features of the enrollment; queue "
                    "A, the joint v2 BSRNN)")
    if online_mix or device_augment:
        _not_ported("online mixing")
    if noise_prob > 0 or noise_enroll_prob > 0:
        _not_ported("noise augmentation")
    if reverb_prob > 0 or reverb_enroll_prob > 0:
        _not_ported("reverberation")
    if specaug_enroll_prob > 0:
        _not_ported("SpecAugment on enrollment features")
    shuffle = configs.get("shuffle", False)
    chain = _Chain(DataList(
        read_lists(data_list_file), shuffle=shuffle,
        repeat_dataset=repeat_dataset, rank=rank, world_size=world_size,
        worker_id=worker_id, num_workers=num_workers))
    if data_type == "shard":
        chain = chain.apply(processor.url_opener)
        chain = chain.apply(processor.tar_file_and_group)
    else:
        chain = chain.apply(processor.parse_raw)
    if configs.get("filter_len", False) and state == "train":
        chain = chain.apply(processor.filter_len,
                            **configs.get("filter_args", {}))
    if shuffle:
        chain = chain.apply(processor.shuffle,
                            **configs.get("shuffle_args", {}))
    resample_rate = configs.get("resample_rate", 16000)
    chain = chain.apply(processor.resample, resample_rate)
    if not whole_utt:
        chain = chain.apply(processor.random_chunk,
                            configs.get("chunk_len", resample_rate * 3))
    if state == "train":
        if joint_training:
            return chain.apply(processor.sample_enrollment, spk2embed_dict,
                               dict_spk)
        return chain.apply(processor.sample_spk_embedding, spk2embed_dict)
    if joint_training:
        return chain.apply(processor.sample_fix_spk_enrollment,
                           spk2embed_dict, spk1_embed, spk2_embed, dict_spk)
    return chain.apply(processor.sample_fix_spk_embedding,
                       spk2embed_dict, spk1_embed, spk2_embed)


def _pad_or_trim_embeds(spk_embeds: List[np.ndarray], mode: str,
                        fixed_len: Optional[int] = None):
    """Bring enrollments to one length along axis 1: wrap-pad or trim to
    `fixed_len`, else zero-pad to the longest (`mode="max"`) or trim to the
    shortest. Pre-extracted embeddings already agree and pass through."""
    lengths = [e.shape[1] for e in spk_embeds]
    if fixed_len is not None:
        out = []
        for e in spk_embeds:
            if e.shape[1] >= fixed_len:
                out.append(e[:, :fixed_len])
            else:
                width = [(0, 0), (0, fixed_len - e.shape[1])] \
                    + [(0, 0)] * (e.ndim - 2)
                out.append(np.pad(e, width, mode="wrap"))
        return out, lengths
    if len(set(lengths)) == 1:
        return spk_embeds, lengths
    if mode == "max":
        out = []
        for e in spk_embeds:
            width = [(0, 0), (0, max(lengths) - e.shape[1])] \
                + [(0, 0)] * (e.ndim - 2)
            out.append(np.pad(e, width))
        return out, lengths
    return [e[:, :min(lengths)] for e in spk_embeds], lengths


def tse_collate_fn(batch: List[dict], mode: str = "min",
                   fixed_enroll_len: Optional[int] = None) -> dict:
    """Expand each mixture into num_speaker rows (sample-major,
    speaker-minor)."""
    wav_mix, wav_targets, spk_embeds = [], [], []
    spk, key, spk_label = [], [], []
    for s in batch:
        for i in range(s["num_speaker"]):
            wav_mix.append(s["wav_mix"])
            wav_targets.append(s[f"wav_spk{i + 1}"])
            spk.append(s[f"spk{i + 1}"])
            key.append(s["key"])
            spk_embeds.append(np.asarray(s[f"embed_spk{i + 1}"]))
            if f"spk{i + 1}_label" in s:
                spk_label.append(s[f"spk{i + 1}_label"])
    spk_embeds, lengths = _pad_or_trim_embeds(spk_embeds, mode,
                                              fixed_enroll_len)
    return {
        "wav_mix": np.concatenate(wav_mix).astype(np.float32),
        "wav_targets": np.concatenate(wav_targets).astype(np.float32),
        "spk_embeds": np.concatenate(spk_embeds).astype(np.float32),
        "length_spk_embeds": lengths,
        "spk": spk,
        "key": key,
        "spk_label": np.asarray(spk_label, np.int32),
    }


def tse_collate_fn_2spk(batch: List[dict], mode: str = "min",
                        fixed_enroll_len: Optional[int] = None) -> dict:
    """Two-speaker variant: num_speaker defaults to 2."""
    for s in batch:
        s.setdefault("num_speaker", 2)
    return tse_collate_fn(batch, mode, fixed_enroll_len)


def _batches(dataset, batch_size, collate_fn, drop_last) -> Iterator[dict]:
    buf = []
    for sample in dataset:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_fn(buf)
            buf = []
    if buf and not drop_last:
        yield collate_fn(buf)


class BatchLoader:
    """Batches an iterable dataset with a collate fn; a background thread
    keeps `prefetch` batches ready (prefetch <= 0: no thread)."""

    def __init__(self, dataset, batch_size: int = 8,
                 collate_fn=tse_collate_fn, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.dataset.set_epoch(epoch)

    def _batches(self) -> Iterator[dict]:
        return _batches(self.dataset, self.batch_size, self.collate_fn,
                        self.drop_last)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
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


def _worker_main(dataset, collate_fn, batch_size, drop_last, epoch, out):
    """Body of a worker process: batch this worker's share of the shards
    into the shared queue (a top-level function, so spawn can pickle it)."""
    try:
        dataset.set_epoch(epoch)
        for batch in _batches(dataset, batch_size, collate_fn, drop_last):
            out.put(batch)
    finally:
        out.put(None)  # this worker is done


class MultiWorkerLoader:
    """Multi-process batch loader for host-heavy chains.

    Takes one Dataset per worker (built with worker_id/num_workers, so each
    owns a share of the shards) and runs each in a spawned process; their
    batches interleave through a shared queue. A worker that is killed
    outright is counted as finished, so the loader does not wait for it
    forever. The thread-prefetching BatchLoader is enough for plain
    decode-and-chunk chains."""

    def __init__(self, worker_datasets, batch_size: int = 8,
                 collate_fn=tse_collate_fn, drop_last: bool = True,
                 queue_size: int = 8):
        self.worker_datasets = list(worker_datasets)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.queue_size = queue_size
        self.epoch = -1

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue(maxsize=self.queue_size)
        procs = [
            ctx.Process(
                target=_worker_main,
                args=(ds, self.collate_fn, self.batch_size, self.drop_last,
                      self.epoch, out),
                daemon=True)
            for ds in self.worker_datasets
        ]
        for p in procs:
            p.start()
        finished = 0
        killed = set()
        try:
            while finished < len(procs):
                try:
                    item = out.get(timeout=10.0)
                except queue.Empty:
                    for i, p in enumerate(procs):
                        if (i not in killed and p.exitcode is not None
                                and p.exitcode < 0):
                            logging.warning(
                                "data worker %d killed (exit %s); going on "
                                "without it", i, p.exitcode)
                            killed.add(i)
                            finished += 1
                    continue
                if item is None:
                    finished += 1
                    continue
                yield item
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

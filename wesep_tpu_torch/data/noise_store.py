"""Noise database: a packed single-file store and an LMDB reader.

Counterpart of wesep_tpu/data/noise_store.py. The packed format (`.pack`)
is the magic `WESEPNZ1`, the index's length as a little-endian uint64, a
json index {key: [offset, size]} and the concatenated wav files, read
through a read-only mmap. An LMDB directory (a pickled `__keys__` list and
one value per key) is read where the `lmdb` package is installed.
`NoiseStore` picks the reader by the path (directory: LMDB, file: pack).
Keys starting with `speech` select the [10, 30] dB SNR range of host noise
augmentation (processor._add_noise_to); `noise_*` and `music_*` the
configured one.
"""

import json
import mmap
import os
import random
import struct
from typing import List, Optional, Tuple

__all__ = ["NoiseStore", "build_pack"]

_MAGIC = b"WESEPNZ1"


def build_pack(wav_files: List[str], out_path: str,
               keys: Optional[List[str]] = None) -> str:
    """Pack `wav_files` into one store at `out_path`, under `keys` (default:
    each file's base name without extension); returns `out_path`."""
    if keys is None:
        keys = [os.path.splitext(os.path.basename(p))[0] for p in wav_files]
    index = {}
    offset = 0
    blobs = []
    for key, path in zip(keys, wav_files):
        with open(path, "rb") as f:
            data = f.read()
        index[key] = (offset, len(data))
        blobs.append(data)
        offset += len(data)
    index_bytes = json.dumps(index).encode("utf8")
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(index_bytes)))
        f.write(index_bytes)
        for b in blobs:
            f.write(b)
    return out_path


class _PackReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(8) != _MAGIC:
            raise ValueError(f"{path} is not a wesep noise pack")
        (index_len,) = struct.unpack("<Q", self._f.read(8))
        self.index = json.loads(self._f.read(index_len).decode("utf8"))
        self._data_start = 16 + index_len
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.keys = list(self.index.keys())

    def get(self, key: str) -> bytes:
        offset, size = self.index[key]
        start = self._data_start + offset
        return self._mm[start:start + size]


class _LmdbReader:
    def __init__(self, path: str):
        import pickle

        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                f"{path} is an LMDB noise store and the lmdb package is not "
                "installed; build a .pack store with "
                "`python -m wesep_tpu_torch.tools.make_noise_db`") from e
        self.db = lmdb.open(path, readonly=True, lock=False,
                            readahead=False, meminit=False)
        with self.db.begin(write=False) as txn:
            self.keys = pickle.loads(txn.get(b"__keys__"))

    def get(self, key: str) -> bytes:
        with self.db.begin(write=False) as txn:
            return txn.get(key.encode())


class NoiseStore:
    """Uniform random access over a noise store."""

    def __init__(self, path: str):
        self._reader = (_LmdbReader(path) if os.path.isdir(path)
                        else _PackReader(path))
        self.keys = self._reader.keys

    def random_one(self) -> Tuple[str, bytes]:
        """A key drawn with Python's global `random`, and its wav bytes."""
        key = self.keys[random.randint(0, len(self.keys) - 1)]
        return key, self._reader.get(key)

    def get(self, key: str) -> bytes:
        return self._reader.get(key)

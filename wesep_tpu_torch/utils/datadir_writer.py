"""Kaldi-style data directory writer that warns of key mismatches.

Counterpart of wesep_tpu/utils/datadir_writer.py (the reference toolkit's
wesep/utils/datadir_writer.py, from ESPnet): `writer["spk1.scp"][key] =
value` opens output_dir/spk1.scp when its first line is written; on close,
the files of one directory are checked for equal key sets, and each
mismatch is logged. A key written twice to one file warns.

    with DatadirWriter("out") as writer:
        writer["spk1.scp"]["utt1"] = "out/utt1_spk1.wav"
"""

import logging
import warnings
from pathlib import Path
from typing import Dict

__all__ = ["DatadirWriter"]


class DatadirWriter:
    def __init__(self, p: str):
        self.path = Path(p)
        self.children: Dict[str, "DatadirWriter"] = {}
        self.fd = None
        self.has_children = False
        self.keys = set()

    def __enter__(self):
        return self

    def __getitem__(self, key: str) -> "DatadirWriter":
        if self.fd is not None:
            raise RuntimeError("this writer points to a file, not a dir")
        if key not in self.children:
            self.children[key] = DatadirWriter(self.path / key)
            self.has_children = True
        return self.children[key]

    def __setitem__(self, key: str, value: str):
        if self.has_children:
            raise RuntimeError("this writer points to a dir, not a file")
        if self.fd is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.fd = self.path.open("w", encoding="utf-8")
        if key in self.keys:
            warnings.warn(f"duplicated key: {key}")
        self.keys.add(key)
        self.fd.write(f"{key} {value}\n")

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()

    def close(self):
        """Close every file; log each pair of sibling files, in the order
        they were opened, whose keys differ."""
        if self.has_children:
            prev = None
            for name, child in self.children.items():
                child.close()
                if prev is not None and prev[1] != child.keys:
                    logging.warning("keys mismatch between %s and %s",
                                    prev[0], name)
                prev = (name, child.keys)
        elif self.fd is not None:
            self.fd.close()
            self.fd = None

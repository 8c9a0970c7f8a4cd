"""Random-access pickle-blob dataset, on-disk compatible with the reference
and with the JAX package (the port's own copy of
diffsinger_tpu/data/indexed_dataset.py).

Format parity (reference utils/indexed_datasets.py): ``<path>.data`` is a
concatenation of pickled dict items; ``<path>.idx`` is an ``np.save``-d dict
``{'offsets': [0, o1, ...]}``. Binarized datasets produced by either framework
are interchangeable.

Reads use a single mmap (zero-copy into the page cache) instead of the
reference's seek/read file handle + 1-item cache.
"""

from __future__ import annotations

import mmap
import os
import pickle
from typing import Any, Dict, List

import numpy as np


class IndexedDataset:
    def __init__(self, path: str):
        self.path = path
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.offsets: List[int] = list(idx["offsets"])
        self._file = open(f"{path}.data", "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        if i < 0 or i >= len(self):
            raise IndexError("index out of range")
        return pickle.loads(self._mm[self.offsets[i]: self.offsets[i + 1]])

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def close(self):
        try:
            self._mm.close()
            self._file.close()
        except Exception:
            pass

    def __del__(self):
        self.close()


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.out_file = open(f"{path}.data", "wb")
        self.byte_offsets = [0]

    def add_item(self, item: Dict[str, Any]):
        n = self.out_file.write(pickle.dumps(item))
        self.byte_offsets.append(self.byte_offsets[-1] + n)

    def finalize(self):
        self.out_file.close()
        np.save(open(f"{self.path}.idx", "wb"), {"offsets": self.byte_offsets})

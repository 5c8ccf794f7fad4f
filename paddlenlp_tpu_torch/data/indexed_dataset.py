"""Memory-mapped token dataset: ``.bin`` (token stream) + ``.idx`` (index).

A copy of ``paddlenlp_tpu/data/indexed_dataset.py`` (pure numpy): both
packages read and write the same files.

Counterpart of ``paddlenlp/data/indexed_dataset.py`` (mmap binary format,
``make_dataset`` :56). Layout (little-endian):

``.idx``: magic ``PDNLPTPU`` | u64 version | u8 dtype_code | u64 n_seqs | u64 n_docs
          | i32 sizes[n_seqs] | i64 pointers[n_seqs] | i64 doc_idx[n_docs+1]
``.bin``: concatenated token arrays.

Reads are ``np.memmap``-backed: only touched pages hit disk — the property the
reference's format exists for (pretraining corpora >> RAM).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

__all__ = ["MMapIndexedDataset", "MMapIndexedDatasetBuilder", "make_dataset", "data_file_path", "index_file_path"]

_MAGIC = b"PDNLPTPU"
_VERSION = 1

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    def __init__(self, out_prefix: str, dtype=np.uint16):
        self._prefix = out_prefix
        self._dtype = np.dtype(dtype)
        os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
        self._bin = open(data_file_path(out_prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def add_document(self, tokens) -> None:
        self.add_item(tokens)
        self.end_document()

    def finalize(self) -> None:
        self._bin.close()
        sizes = np.asarray(self._sizes, dtype=np.int32)
        pointers = np.zeros(len(sizes), dtype=np.int64)
        np.cumsum(sizes[:-1] * self._dtype.itemsize, out=pointers[1:])
        doc_idx = np.asarray(self._doc_idx, dtype=np.int64)
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _DTYPE_CODES[self._dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(doc_idx) - 1))
            f.write(sizes.tobytes())
            f.write(pointers.tobytes())
            f.write(doc_idx.tobytes())


class MMapIndexedDataset:
    """Sequence-indexed view over the token stream; ``get(i, offset, length)``
    slices within a sequence without loading it fully."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{index_file_path(prefix)}: bad magic {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            (dtype_code,) = struct.unpack("<B", f.read(1))
            (n_seqs,) = struct.unpack("<Q", f.read(8))
            (n_docs,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        self.dtype = np.dtype(_DTYPES[dtype_code])
        idx_map = np.memmap(index_file_path(prefix), mode="r", dtype=np.uint8, offset=offset)
        pos = 0
        self.sizes = idx_map[pos : pos + 4 * n_seqs].view(np.int32)
        pos += 4 * n_seqs
        self.pointers = idx_map[pos : pos + 8 * n_seqs].view(np.int64)
        pos += 8 * n_seqs
        self.doc_idx = idx_map[pos : pos + 8 * (n_docs + 1)].view(np.int64)
        self._bin = np.memmap(data_file_path(prefix), mode="r", dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def n_docs(self) -> int:
        return len(self.doc_idx) - 1

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        size = int(self.sizes[idx])
        if length is None:
            length = size - offset
        start = int(self.pointers[idx]) + offset * self.dtype.itemsize
        raw = self._bin[start : start + length * self.dtype.itemsize]
        return raw.view(self.dtype)

    def __getitem__(self, idx):
        return self.get(idx)


def make_dataset(prefix: str) -> MMapIndexedDataset:
    """Open a prebuilt dataset (reference indexed_dataset.py:56)."""
    return MMapIndexedDataset(prefix)

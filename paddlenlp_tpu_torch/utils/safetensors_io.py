"""Safetensors read/write with lazy per-tensor slicing.

PyTorch port of ``paddlenlp_tpu/utils/safetensors_io.py``: the same header
parser with ``numpy.memmap``-backed tensors, so a tensor can be sliced without
materializing it. numpy has no bfloat16, so BF16 tensors are read as their raw
``uint16`` bits and :meth:`SafeFile.get_torch` reinterprets them as
``torch.bfloat16``. The writer half (:func:`save_file`,
:func:`shard_checkpoint`) takes numpy arrays or CPU torch tensors and writes
``torch.bfloat16`` as BF16.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "SafeFile",
    "SafeSlice",
    "load_file",
    "safe_keys",
    "save_file",
    "shard_checkpoint",
]

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # raw bits; get_torch() views them as torch.bfloat16
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "U16": np.uint16,
    "U32": np.uint32,
    "U64": np.uint64,
}

_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}


def _decode_dtype(name: str):
    dt = _DTYPES.get(name)
    if dt is None:
        raise ValueError(f"unsupported safetensors dtype {name}")
    return np.dtype(dt)


class SafeSlice:
    """Lazy view over one tensor in a safetensors file; supports numpy basic slicing."""

    def __init__(self, mmap: np.memmap, dtype: np.dtype, shape: Tuple[int, ...], start: int, end: int):
        self._mmap = mmap
        self.dtype = dtype
        self.shape = tuple(shape)
        self._start = start
        self._end = end

    def get_shape(self) -> List[int]:
        return list(self.shape)

    def get_dtype(self) -> np.dtype:
        return self.dtype

    @property
    def nbytes(self) -> int:
        return self._end - self._start

    def _view(self) -> np.ndarray:
        raw = self._mmap[self._start : self._end]
        arr = raw.view(self.dtype)
        return arr.reshape(self.shape) if self.shape else arr.reshape(())

    def __getitem__(self, index) -> np.ndarray:
        # memmap-backed: only the touched pages are read from disk.
        out = self._view()[index]
        return np.ascontiguousarray(out).reshape(out.shape)  # keep 0-d as 0-d

    def numpy(self) -> np.ndarray:
        return self[...]


class SafeFile:
    """Zero-copy safetensors reader (header parse + memmap-backed slices)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header_len = struct.unpack("<Q", f.read(8))[0]
            header = json.loads(f.read(header_len).decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self._entries = header
        self._data_offset = 8 + header_len
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r", offset=self._data_offset)

    def keys(self) -> List[str]:
        return list(self._entries.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get_slice(self, key: str) -> SafeSlice:
        ent = self._entries[key]
        start, end = ent["data_offsets"]
        return SafeSlice(self._mmap, _decode_dtype(ent["dtype"]), tuple(ent["shape"]), start, end)

    def get_tensor(self, key: str) -> np.ndarray:
        return self.get_slice(key).numpy()

    def get_torch(self, key: str) -> torch.Tensor:
        """The tensor as a CPU ``torch.Tensor`` in its stored dtype."""
        t = torch.from_numpy(self.get_tensor(key).copy())  # memmap views are read-only
        return t.view(torch.bfloat16) if self._entries[key]["dtype"] == "BF16" else t

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        for k in self.keys():
            yield k, self.get_tensor(k)

    def close(self):
        self._mmap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def safe_keys(path: str) -> List[str]:
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len).decode("utf-8"))
    header.pop("__metadata__", None)
    return list(header.keys())


def load_file(path: str, keys: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    sf = SafeFile(path)
    out = {}
    for k in keys if keys is not None else sf.keys():
        out[k] = sf.get_tensor(k)
    return out


def _as_numpy(x: Union[np.ndarray, torch.Tensor]) -> Tuple[np.ndarray, str]:
    """(the array in C order, its safetensors dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "BF16"
        x = t.numpy()
    arr = np.ascontiguousarray(x)
    name = _DTYPE_NAMES.get(arr.dtype)
    if name is None:
        raise ValueError(f"unsupported dtype for safetensors: {arr.dtype}")
    return arr, name


def save_file(tensors: Dict[str, Union[np.ndarray, torch.Tensor]], path: str,
              metadata: Optional[Dict[str, str]] = None):
    """Write a safetensors file (streams tensor by tensor, then renames into place)."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    arrays = []
    for name, x in tensors.items():
        shape = list(x.shape)
        arr, dtype = _as_numpy(x)
        arrays.append(arr)
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * ((-(8 + len(blob))) % 8)  # 8-byte aligned data, as the upstream format
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(memoryview(arr.reshape(-1)).cast("B"))
    os.replace(tmp, path)


def shard_checkpoint(tensors: Dict[str, Union[np.ndarray, torch.Tensor]], max_shard_size: int = 5 * 1024**3,
                     weights_name: str = "model.safetensors"):
    """Split a state dict into shards of at most ``max_shard_size`` bytes:
    ``([(filename, shard), ...], index or None)`` (a single shard needs no index)."""
    shards: List[dict] = [{}]
    sizes = [0]
    for name, x in tensors.items():
        nbytes = x.numel() * x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).nbytes
        if sizes[-1] + nbytes > max_shard_size and sizes[-1] > 0:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = x
        sizes[-1] += nbytes
    if len(shards) == 1:
        return [(weights_name, shards[0])], None
    stem, ext = os.path.splitext(weights_name)
    n = len(shards)
    named = [(f"{stem}-{i + 1:05d}-of-{n:05d}{ext}", shard) for i, shard in enumerate(shards)]
    weight_map = {key: fname for fname, shard in named for key in shard}
    return named, {"metadata": {"total_size": int(sum(sizes))}, "weight_map": weight_map}

"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``paddlenlp_tpu_torch/csrc/`` is compiled on first use into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) under ``paddlenlp_tpu_torch/_build/``, named by a hash of
the source, the local headers it includes (``#include "..."``, transitively)
and the flags: a changed source or header rebuilds, an unchanged one loads
the cached library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "build", "library_path", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: the kernel sources the port builds (stem -> file under csrc/)
SOURCES = {"paged_attention_sm90": "paged_attention_sm90.cu", "flash_attention_sm90": "flash_attention_sm90.cu",
           "flash_attention_sm90_f32": "flash_attention_sm90_f32.cu"}

#: Hopper only: the `a` keeps wgmma/setmaxnreg available to later kernels;
#: -Xptxas -v records registers, shared memory and spills in the build log;
#: -ldl: flash_attention_sm90.cu takes cuTensorMapEncodeTiled from libcuda (dlopen)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")


def _files(stem: str) -> List[Path]:
    """``stem``'s source and the local headers it includes, transitively,
    each once, in the order they are first included."""
    out, todo = [], [CSRC / SOURCES[stem]]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        included = re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)
        todo += [path.parent / name for name in included]
    return out


def library_path(stem: str) -> Path:
    """Where ``stem``'s library lives for the current source, its headers and
    the flags."""
    h = hashlib.sha256()
    for path in _files(stem):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build(stem: str) -> dict:
    """Compile ``stem``'s library unless it is cached. Returns ``{"seconds",
    "cached", "log"}``: the ``nvcc -Xptxas -v`` output, read back from the
    saved build log on a cache hit (``None`` if there is none); raises with
    the compiler's output when the build fails."""
    out = library_path(stem)
    log_path = out.with_suffix(".log")
    if out.is_file():
        log = log_path.read_text() if log_path.is_file() else None
        return {"seconds": 0.0, "cached": True, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[stem])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[stem]} (exit {proc.returncode}):\n{proc.stdout}")
    log_path.write_text(proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return {"seconds": time.perf_counter() - t0, "cached": False, "log": proc.stdout}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``stem``, built first if needed."""
    lib = _LOADED.get(stem)
    if lib is None:
        path = library_path(stem)
        if not path.is_file():
            build(stem)
        lib = ctypes.CDLL(str(path))
        _LOADED[stem] = lib
    return lib

"""Index builders of the pretraining dataset, in numpy.

Port of ``paddlenlp_tpu/data/native.py``: its numpy versions of
``build_sample_idx`` and ``build_blending_indices``. The JAX package compiles
a g++ helper (``csrc/sample_idx.cpp``) for the same loops; that host-side
speed-up is not part of the port yet (ROADMAP Queue 1 item 15). Both give the
same indices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_blending_indices", "build_sample_idx"]


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int, n_samples: int) -> np.ndarray:
    """[(doc_pos, doc_offset)] per sample boundary; shape [n_samples+1, 2]."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, dtype=np.int64)
    out = np.zeros((n_samples + 1, 2), dtype=np.int64)
    doc_pos, doc_offset = 0, 0
    for i in range(1, n_samples + 1):
        remaining = seq_length + 1
        while remaining > 0:
            if doc_pos >= len(doc_idx):
                raise ValueError("corpus exhausted before n_samples; increase epochs in doc_idx")
            doc_len = int(sizes[doc_idx[doc_pos]]) - doc_offset
            if doc_len > remaining:
                doc_offset += remaining
                remaining = 0
            else:
                remaining -= doc_len
                doc_pos += 1
                doc_offset = 0
        out[i] = (doc_pos, doc_offset)
    return out


def build_blending_indices(weights: np.ndarray, n_samples: int):
    """Largest-deficit greedy blend assignment -> (dataset_index i32, sample_index i64)."""
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    dataset_index = np.zeros(n_samples, dtype=np.int32)
    dataset_sample_index = np.zeros(n_samples, dtype=np.int64)
    counts = np.zeros(len(weights))
    for i in range(n_samples):
        d = int(np.argmax((i + 1) * weights - counts))
        dataset_index[i] = d
        dataset_sample_index[i] = counts[d]
        counts[d] += 1
    return dataset_index, dataset_sample_index

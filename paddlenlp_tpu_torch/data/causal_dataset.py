"""Megatron-style GPT pretraining dataset over mmap corpora.

A copy of ``paddlenlp_tpu/data/causal_dataset.py``: ``build_train_valid_test_datasets``
with weighted multi-corpus blending, ``GPTDataset`` with its cached
doc/sample/shuffle index build. The index builders are the numpy ones of
``native.py`` (the JAX package's g++ helper, ``csrc/sample_idx.cpp``, is a
host-side speed-up on ROADMAP Queue 1 item 15), so the samples equal the JAX
package's bit for bit. Caches are keyed by (seq_length, n_samples, seed) next
to the corpus files.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import logger
from .indexed_dataset import MMapIndexedDataset, make_dataset
from .native import build_sample_idx

__all__ = ["GPTDataset", "BlendableDataset", "build_train_valid_test_datasets", "get_train_valid_test_split_"]


def get_train_valid_test_split_(splits_string: str, size: int) -> List[int]:
    """'949,50,1' -> cumulative sample boundaries (reference helper)."""
    splits = [float(s) for s in splits_string.replace("/", ",").split(",")]
    while len(splits) < 3:
        splits.append(0.0)
    total = sum(splits) or 1.0
    weights = [s / total for s in splits]
    bounds = [0]
    for w in weights:
        bounds.append(bounds[-1] + int(round(w * size)))
    bounds[3] = size
    return bounds


class GPTDataset:
    """Fixed-length causal-LM samples drawn from a document stream.

    Produces dicts with ``input_ids`` [seq_length] and ``labels`` (next tokens) —
    samples span document boundaries exactly like the reference (:282).
    """

    def __init__(
        self,
        indexed: MMapIndexedDataset,
        doc_ids: np.ndarray,  # document indices belonging to this split
        seq_length: int,
        n_samples: int,
        seed: int = 0,
        name: str = "train",
        cache_dir: Optional[str] = None,
    ):
        self.indexed = indexed
        self.seq_length = seq_length
        self.n_samples = n_samples
        self.seed = seed
        self.name = name

        doc_ids = np.asarray(doc_ids, dtype=np.int64)
        tokens_per_epoch = int(self.indexed.sizes[doc_ids].sum())
        n_epochs = max(1, int(np.ceil((n_samples * (seq_length + 1)) / max(tokens_per_epoch, 1))) + 1)

        cache_key = hashlib.md5(
            f"{name}-{seq_length}-{n_samples}-{seed}-{len(doc_ids)}-{tokens_per_epoch}".encode()
        ).hexdigest()[:16]
        cache_base = cache_dir or os.path.join(os.path.dirname(indexed._prefix) or ".", "index-cache")
        cache_path = os.path.join(cache_base, f"{os.path.basename(indexed._prefix)}-{cache_key}")
        done_marker = cache_path + "-done"
        if os.path.isfile(done_marker):  # marker written LAST via atomic rename
            self.doc_idx = np.load(cache_path + "-doc.npy")
            self.sample_idx = np.load(cache_path + "-sample.npy")
            self.shuffle_idx = np.load(cache_path + "-shuffle.npy")
            return

        t0 = time.time()
        rng = np.random.default_rng(seed)
        # epoch-repeated shuffled document order
        self.doc_idx = np.concatenate([rng.permutation(doc_ids) for _ in range(n_epochs)])
        self.sample_idx = build_sample_idx(self.indexed.sizes, self.doc_idx, seq_length, n_samples)
        self.shuffle_idx = rng.permutation(n_samples).astype(np.int64)
        try:
            # concurrent-safe publish: per-file tmp + os.replace, done-marker last.
            # Concurrent builders compute identical (deterministic) indices, so the
            # last replace wins harmlessly; readers gate on the marker.
            os.makedirs(cache_base, exist_ok=True)
            tmp_suffix = f".tmp{os.getpid()}"
            for suffix, arr in (("-doc.npy", self.doc_idx), ("-sample.npy", self.sample_idx),
                                ("-shuffle.npy", self.shuffle_idx)):
                np.save(cache_path + suffix + tmp_suffix, arr)
                os.replace(cache_path + suffix + tmp_suffix + ".npy", cache_path + suffix)
            with open(done_marker + tmp_suffix, "w") as f:
                f.write("ok")
            os.replace(done_marker + tmp_suffix, done_marker)
        except OSError as e:
            logger.warning(f"index cache write failed: {e}")
        logger.info(f"built {name} GPTDataset index in {time.time() - t0:.2f}s "
                    f"(docs/epoch={len(doc_ids)}, epochs={n_epochs}, samples={n_samples})")

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int):
        idx = int(self.shuffle_idx[idx % self.n_samples])
        doc_pos0, offset0 = self.sample_idx[idx]
        doc_pos1, offset1 = self.sample_idx[idx + 1]
        parts = []
        if doc_pos0 == doc_pos1:
            parts.append(self.indexed.get(int(self.doc_idx[doc_pos0]), int(offset0),
                                          int(offset1 - offset0)))
        else:
            parts.append(self.indexed.get(int(self.doc_idx[doc_pos0]), int(offset0)))
            for p in range(int(doc_pos0) + 1, int(doc_pos1)):
                parts.append(self.indexed.get(int(self.doc_idx[p])))
            if offset1 > 0:
                parts.append(self.indexed.get(int(self.doc_idx[doc_pos1]), 0, int(offset1)))
        tokens = np.concatenate(parts).astype(np.int64)
        assert len(tokens) == self.seq_length + 1, (len(tokens), self.seq_length)
        return {"input_ids": tokens[:-1].astype(np.int32), "labels": tokens[1:].astype(np.int32)}


class BlendableDataset:
    """Weighted mixture of datasets (reference blendable_dataset.py): sample i of
    the blend is drawn from the component whose running quota is furthest behind."""

    def __init__(self, datasets: Sequence, weights: Sequence[float], n_samples: int, seed: int = 0):
        assert len(datasets) == len(weights) and datasets
        self.datasets = list(datasets)
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        self.n_samples = n_samples
        # deterministic largest-deficit assignment in the native helper (the
        # reference/Megatron build_blending_indices hot loop)
        from .native import build_blending_indices

        self.dataset_index, self.dataset_sample_index = build_blending_indices(w, n_samples)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        d = self.dataset_index[idx]
        return self.datasets[d][int(self.dataset_sample_index[idx]) % len(self.datasets[d])]


def build_train_valid_test_datasets(
    data_prefix,
    seq_length: int,
    train_valid_test_num_samples: Tuple[int, int, int],
    splits_string: str = "949,50,1",
    seed: int = 0,
    cache_dir: Optional[str] = None,
):
    """Reference causal_dataset.py:112 — single corpus or weighted blend
    (``[w1, prefix1, w2, prefix2, ...]``)."""
    if isinstance(data_prefix, (list, tuple)) and len(data_prefix) > 1:
        weights = [float(w) for w in data_prefix[0::2]]
        prefixes = [str(p) for p in data_prefix[1::2]]
        total_w = sum(weights)
        per_split = []
        for split_i in range(3):
            n = train_valid_test_num_samples[split_i]
            if n <= 0:
                per_split.append(None)
                continue
            comps = []
            for prefix, w in zip(prefixes, weights):
                # each component only needs ~weight*n samples (+margin for the
                # greedy assignment), not the full blend size
                comp_counts = [0, 0, 0]
                comp_counts[split_i] = int(np.ceil(n * w / total_w)) + 1
                t, v, te = build_train_valid_test_datasets(
                    prefix, seq_length, tuple(comp_counts), splits_string, seed, cache_dir
                )
                comps.append((t, v, te)[split_i])
            per_split.append(BlendableDataset(comps, weights, n, seed))
        return tuple(per_split)

    prefix = data_prefix[0] if isinstance(data_prefix, (list, tuple)) else data_prefix
    indexed = make_dataset(str(prefix))
    bounds = get_train_valid_test_split_(splits_string, indexed.n_docs)
    out = []
    for i, name in enumerate(["train", "valid", "test"]):
        n = train_valid_test_num_samples[i]
        docs = np.arange(bounds[i], bounds[i + 1], dtype=np.int64)
        if n <= 0 or len(docs) == 0:
            out.append(None)
            continue
        out.append(GPTDataset(indexed, docs, seq_length, n, seed=seed, name=name, cache_dir=cache_dir))
    return tuple(out)

"""ZeroPadding sample packing.

Port of ``paddlenlp_tpu/datasets/zero_padding_dataset.py`` (host code over
numpy; reference greedy packs :20, ``ZeroPaddingMapDataset`` :106 / iterable
:176). Packed rows carry ``segment_ids`` + per-segment ``position_ids``; the
port's training forward hands both to the flash kernels
(``ops/flash_attention.py``), which mask attention to each segment. The
padding tail is a segment of its own, ``len(pack) + 1``, that attends nothing
else.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List

import numpy as np

__all__ = ["ZeroPaddingMapDataset", "ZeroPaddingIterableDataset", "greedy_pack"]


def _finalize(pack: List[Dict], max_length: int, pad_id: int = 0) -> Dict[str, np.ndarray]:
    ids, labels, segments, positions = [], [], [], []
    for seg, ex in enumerate(pack):
        x = np.asarray(ex["input_ids"], dtype=np.int32)
        y = np.asarray(ex.get("labels", x), dtype=np.int32)
        ids.append(x)
        labels.append(y)
        segments.append(np.full(len(x), seg, dtype=np.int32))
        positions.append(np.arange(len(x), dtype=np.int32))
    ids = np.concatenate(ids)
    labels = np.concatenate(labels)
    segments = np.concatenate(segments)
    positions = np.concatenate(positions)
    pad = max_length - len(ids)
    if pad > 0:
        ids = np.pad(ids, (0, pad), constant_values=pad_id)
        labels = np.pad(labels, (0, pad), constant_values=-100)
        segments = np.pad(segments, (0, pad), constant_values=len(pack) + 1)  # own segment: attends nothing else
        positions = np.pad(positions, (0, pad), constant_values=0)
    return {"input_ids": ids, "labels": labels, "segment_ids": segments, "position_ids": positions}


def greedy_pack(examples: Iterable[Dict], max_length: int, pad_id: int = 0) -> List[Dict[str, np.ndarray]]:
    """First-fit-in-order greedy packing (reference :20)."""
    packs: List[Dict[str, np.ndarray]] = []
    current: List[Dict] = []
    used = 0
    for ex in examples:
        n = len(ex["input_ids"])
        if n > max_length:
            ex = {k: np.asarray(v)[:max_length] for k, v in ex.items()}
            n = max_length
        if used + n > max_length and current:
            packs.append(_finalize(current, max_length, pad_id))
            current, used = [], 0
        current.append(ex)
        used += n
    if current:
        packs.append(_finalize(current, max_length, pad_id))
    return packs


class ZeroPaddingMapDataset:
    def __init__(self, dataset, tokenizer=None, max_length: int = 2048):
        pad_id = 0
        if tokenizer is not None and tokenizer.pad_token_id is not None:
            pad_id = tokenizer.pad_token_id
        examples = (dataset[i] for i in range(len(dataset)))
        self._packs = greedy_pack(examples, max_length, pad_id)

    def __len__(self):
        return len(self._packs)

    def __getitem__(self, idx):
        return self._packs[idx]


class ZeroPaddingIterableDataset:
    def __init__(self, dataset: Iterable, tokenizer=None, max_length: int = 2048):
        self._dataset = dataset
        self._max_length = max_length
        self._pad_id = tokenizer.pad_token_id if tokenizer is not None and tokenizer.pad_token_id else 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        current: List[Dict] = []
        used = 0
        for ex in self._dataset:
            n = len(ex["input_ids"])
            if n > self._max_length:
                ex = {k: np.asarray(v)[: self._max_length] for k, v in ex.items()}
                n = self._max_length
            if used + n > self._max_length and current:
                yield _finalize(current, self._max_length, self._pad_id)
                current, used = [], 0
            current.append(ex)
            used += n
        if current:
            yield _finalize(current, self._max_length, self._pad_id)

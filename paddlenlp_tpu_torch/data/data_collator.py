"""Data collators (reference: paddlenlp/data/data_collator.py — default/padding
collators :1-320, ``DataCollatorForSeq2Seq`` :321, LM masking :501).

A copy of ``paddlenlp_tpu/data/data_collator.py`` (pure numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "default_data_collator",
    "DataCollatorWithPadding",
    "DataCollatorForSeq2Seq",
    "DataCollatorForLanguageModeling",
]


def default_data_collator(features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    batch = {}
    for k in features[0]:
        vals = [f[k] for f in features]
        if isinstance(vals[0], (int, float, np.integer, np.floating)):
            batch[k] = np.asarray(vals)
        else:
            batch[k] = np.stack([np.asarray(v) for v in vals])
    return batch


def _pad_to(arrs: List[np.ndarray], pad_value, multiple: Optional[int] = None, side: str = "right"):
    target = max(len(a) for a in arrs)
    if multiple:
        target = ((target + multiple - 1) // multiple) * multiple
    out = np.full((len(arrs), target), pad_value, dtype=np.asarray(arrs[0]).dtype)
    for i, a in enumerate(arrs):
        if side == "right":
            out[i, : len(a)] = a
        else:
            out[i, target - len(a):] = a
    return out


@dataclasses.dataclass
class DataCollatorWithPadding:
    tokenizer: Any
    padding: bool = True
    max_length: Optional[int] = None
    pad_to_multiple_of: Optional[int] = None
    return_attention_mask: bool = True
    label_pad_token_id: int = -100

    def __call__(self, features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        pad_id = self.tokenizer.pad_token_id if self.tokenizer is not None else 0
        if pad_id is None:
            pad_id = 0
        ids = [np.asarray(f["input_ids"]) for f in features]
        side = getattr(self.tokenizer, "padding_side", "right")
        batch = {"input_ids": _pad_to(ids, pad_id, self.pad_to_multiple_of, side)}
        if self.return_attention_mask:
            masks = [np.ones(len(a), dtype=np.int64) for a in ids]
            batch["attention_mask"] = _pad_to(masks, 0, self.pad_to_multiple_of, side)
        for key in features[0]:
            if key in ("input_ids", "attention_mask"):
                continue
            vals = [np.asarray(f[key]) for f in features]
            if vals[0].ndim == 0:
                batch[key] = np.stack(vals)
            else:
                fill = self.label_pad_token_id if key == "labels" else 0
                batch[key] = _pad_to(vals, fill, self.pad_to_multiple_of, side)
        return batch


@dataclasses.dataclass
class DataCollatorForSeq2Seq(DataCollatorWithPadding):
    pass


@dataclasses.dataclass
class DataCollatorForLanguageModeling:
    """MLM masking (reference :501): 15% of tokens -> 80% [MASK] / 10% random / 10% keep."""

    tokenizer: Any
    mlm: bool = True
    mlm_probability: float = 0.15
    pad_to_multiple_of: Optional[int] = None
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        pad_id = self.tokenizer.pad_token_id or 0
        ids = [np.asarray(f["input_ids"]) for f in features]
        input_ids = _pad_to(ids, pad_id, self.pad_to_multiple_of)
        attention_mask = _pad_to([np.ones(len(a), np.int64) for a in ids], 0, self.pad_to_multiple_of)
        if not self.mlm:
            labels = input_ids.copy()
            labels[attention_mask == 0] = -100
            return {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}

        labels = input_ids.copy()
        special = np.zeros_like(input_ids, dtype=bool)
        for tid in (self.tokenizer.cls_token_id, self.tokenizer.sep_token_id, pad_id):
            if tid is not None:
                special |= input_ids == tid
        prob = self._rng.random(input_ids.shape)
        masked = (prob < self.mlm_probability) & ~special & (attention_mask == 1)
        labels[~masked] = -100
        decider = self._rng.random(input_ids.shape)
        mask_id = self.tokenizer.mask_token_id
        replace = masked & (decider < 0.8)
        if mask_id is not None:
            input_ids[replace] = mask_id
        randomize = masked & (decider >= 0.8) & (decider < 0.9)
        input_ids[randomize] = self._rng.integers(0, self.tokenizer.vocab_size, randomize.sum())
        return {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}

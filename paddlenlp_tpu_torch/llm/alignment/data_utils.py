"""Shared data plumbing for the alignment entry points (dpo/rm/ppo).

Port of ``llm/alignment/data_utils.py``: one copy of the jsonl preference
loader ({"src", "chosen", "rejected"} rows) and the list-backed dataset the
three run_*.py scripts feed their trainers.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["ListDataset", "load_preference_rows"]


class ListDataset:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def load_preference_rows(path: str, tokenizer, max_length: int, max_prompt_length: int,
                         mode: str = "dpo"):
    """jsonl {"src", "chosen", "rejected"} -> per-pair token rows.

    mode="dpo": chosen/rejected input_ids + prompt-masked labels (DPOTrainer).
    mode="rm":  chosen/rejected input_ids + attention masks (RewardTrainer).
    Prompts are clamped so a long prompt can never push a row past
    ``max_length`` (a negative pad width crashed the old per-script loaders).
    """
    if mode not in ("dpo", "rm"):
        raise ValueError(f"mode must be dpo|rm, got {mode!r}")
    prompt_cap = min(max_prompt_length, max_length - 1)  # always leaves >=1 response slot
    eos = [tokenizer.eos_token_id] if tokenizer.eos_token_id is not None else []
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            prompt = tokenizer.encode(str(r["src"]))[:prompt_cap]

            def build(resp):
                resp_ids = (tokenizer.encode(str(resp)) + eos)[: max_length - len(prompt)]
                ids = np.asarray(prompt + resp_ids, dtype=np.int32)
                pad = max_length - len(ids)
                if mode == "dpo":
                    labels = np.asarray([-100] * len(prompt) + resp_ids, dtype=np.int32)
                    return (np.pad(ids, (0, pad)), np.pad(labels, (0, pad), constant_values=-100))
                mask = np.concatenate([np.ones(len(ids), np.int32), np.zeros(pad, np.int32)])
                return (np.pad(ids, (0, pad)), mask)

            c0, c1 = build(r["chosen"])
            r0, r1 = build(r["rejected"])
            if mode == "dpo":
                rows.append({"chosen_input_ids": c0, "chosen_labels": c1,
                             "rejected_input_ids": r0, "rejected_labels": r1})
            else:
                rows.append({"chosen_input_ids": c0, "chosen_attention_mask": c1,
                             "rejected_input_ids": r0, "rejected_attention_mask": r1})
    return rows

"""Corpus preprocessing: text/jsonl -> .bin/.idx mmap dataset.

Port of ``llm/tools/preprocess_data.py`` (host code: the port's tokenizer
and ``data.MMapIndexedDatasetBuilder``); the files it writes equal the JAX
tool's byte for byte, including the switch from uint16 to uint32 token
storage for a vocabulary over 65,535.

Usage:
    python -m paddlenlp_tpu_torch.llm.tools.preprocess_data --input corpus.jsonl \\
        --output_prefix data/corpus --tokenizer_name_or_path <dir> [--json_key text] [--append_eos]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np

from ...data import MMapIndexedDatasetBuilder
from ...transformers import AutoTokenizer
from ...utils.log import logger

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="txt (one doc per line) or jsonl")
    ap.add_argument("--output_prefix", required=True)
    ap.add_argument("--tokenizer_name_or_path", required=True)
    ap.add_argument("--json_key", default="text")
    ap.add_argument("--append_eos", action="store_true")
    ap.add_argument("--dtype", default="uint16", choices=["uint16", "uint32", "int32"])
    args = ap.parse_args(argv)

    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_name_or_path)
    if np.dtype(args.dtype).itemsize == 2 and tokenizer.vocab_size > 65535:
        logger.warning("vocab > 65535: forcing uint32 token storage")
        args.dtype = "uint32"
    builder = MMapIndexedDatasetBuilder(args.output_prefix, dtype=np.dtype(args.dtype))
    eos = tokenizer.eos_token_id
    t0, n_docs, n_tokens = time.time(), 0, 0
    with open(args.input) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            text = json.loads(line).get(args.json_key, "") if args.input.endswith((".json", ".jsonl")) else line
            if not text:
                continue
            ids = tokenizer.encode(text)
            if args.append_eos and eos is not None:
                ids = ids + [eos]
            builder.add_document(ids)
            n_docs += 1
            n_tokens += len(ids)
            if n_docs % 10000 == 0:
                logger.info(f"{n_docs} docs, {n_tokens} tokens ({n_tokens / (time.time() - t0):.0f} tok/s)")
    builder.finalize()
    logger.info(f"wrote {args.output_prefix}.bin/.idx: {n_docs} docs, {n_tokens} tokens")


if __name__ == "__main__":
    main()

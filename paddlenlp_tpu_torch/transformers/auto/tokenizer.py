"""AutoTokenizer (reference: paddlenlp/transformers/auto/tokenizer.py).

Port of ``paddlenlp_tpu/transformers/auto/tokenizer.py``: one fast tokenizer
class serves every model (the ``tokenizer.json`` artifact)."""

from __future__ import annotations

from ..tokenizer_utils import PretrainedTokenizer

__all__ = ["AutoTokenizer"]


class AutoTokenizer:
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> PretrainedTokenizer:
        return PretrainedTokenizer.from_pretrained(pretrained_model_name_or_path, **kwargs)

"""Tokenizers: one fast tokenizer class over the Rust ``tokenizers`` runtime,
with jinja chat templates.

Port of ``paddlenlp_tpu/transformers/tokenizer_utils.py``: host code over
numpy, the same files (``tokenizer.json``, ``tokenizer_config.json``) and the
same ids. ``tokenizers`` is imported where the JAX module imports it, inside
``PretrainedTokenizer.__init__``: without it the package still imports and a
tokenizer's construction raises ``ImportError``. Checkpoints shipping only a
sentencepiece model (``spiece.model`` / ``tokenizer.model``) are converted on
load by ``convert_slow_tokenizer.convert_spm_to_fast``.

Batched decode wants LEFT padding; ``padding_side`` is configurable per call
and per instance, as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..utils.downloader import resolve_file, resolve_model_dir
from ..utils.env import TOKENIZER_CONFIG_NAME
from ..utils.log import logger

__all__ = ["PretrainedTokenizer", "BatchEncoding", "ChatTemplateMixin"]

TOKENIZER_FILE = "tokenizer.json"
SPECIAL_TOKENS_MAP_FILE = "special_tokens_map.json"

SPECIAL_TOKEN_ATTRS = ["bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token"]


class BatchEncoding(dict):
    """dict of encoded arrays with attribute access (input_ids, attention_mask...)."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def convert_to_numpy(self):
        for k, v in self.items():
            if isinstance(v, list):
                self[k] = np.asarray(v)
        return self


class ChatTemplateMixin:
    """HF-compatible jinja chat templates (reference ChatTemplateMixin
    tokenizer_utils.py:629; the reference's custom ChatTemplate JSON zoo is
    subsumed by the jinja format stored in tokenizer_config.json)."""

    chat_template: Optional[str] = None

    def apply_chat_template(
        self,
        conversation: List[Dict[str, str]],
        add_generation_prompt: bool = True,
        tokenize: bool = False,
        **kwargs,
    ):
        if self.chat_template is None:
            raise ValueError(f"{type(self).__name__} has no chat_template set")
        try:
            from jinja2.sandbox import ImmutableSandboxedEnvironment

            env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
        except ImportError:
            import jinja2

            env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)

        def raise_exception(message):
            raise ValueError(message)

        template = env.from_string(self.chat_template)
        rendered = template.render(
            messages=conversation,
            add_generation_prompt=add_generation_prompt,
            bos_token=getattr(self, "bos_token", None),
            eos_token=getattr(self, "eos_token", None),
            unk_token=getattr(self, "unk_token", None),
            pad_token=getattr(self, "pad_token", None),
            raise_exception=raise_exception,
            **kwargs,
        )
        if tokenize:
            return self(rendered, add_special_tokens=False)
        return rendered


class PretrainedTokenizer(ChatTemplateMixin):
    padding_side: str = "right"
    model_max_length: int = 10**9

    def __init__(
        self,
        tokenizer_object=None,
        tokenizer_file: Optional[str] = None,
        padding_side: str = "right",
        model_max_length: Optional[int] = None,
        chat_template: Optional[str] = None,
        **kwargs,
    ):
        from tokenizers import Tokenizer

        if tokenizer_object is not None:
            self._tokenizer = tokenizer_object
        elif tokenizer_file is not None:
            self._tokenizer = Tokenizer.from_file(tokenizer_file)
        else:
            raise ValueError("need tokenizer_object or tokenizer_file")
        self.padding_side = padding_side
        if model_max_length:
            self.model_max_length = model_max_length
        self.chat_template = chat_template
        for attr in SPECIAL_TOKEN_ATTRS:
            setattr(self, attr, _token_content(kwargs.pop(attr, None)))
        self.init_kwargs = kwargs

    # ------------------------------------------------------------------ loading
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> "PretrainedTokenizer":
        model_dir = resolve_model_dir(pretrained_model_name_or_path)
        tok_file = os.path.join(model_dir, TOKENIZER_FILE)
        tokenizer_object = None
        spm_path = None
        if not os.path.isfile(tok_file):
            try:
                tok_file = resolve_file(pretrained_model_name_or_path, TOKENIZER_FILE)
            except (FileNotFoundError, OSError, ValueError):
                # no authoritative tokenizer.json anywhere — fall back to a
                # sentencepiece-only checkpoint (llama/t5/gemma lineage) and
                # rebuild the fast tokenizer from the spm proto
                for spm_name in ("spiece.model", "tokenizer.model", "sentencepiece.bpe.model"):
                    cand = os.path.join(model_dir, spm_name)
                    if os.path.isfile(cand):
                        spm_path = cand
                        break
                if spm_path is None:
                    raise
        config: Dict[str, Any] = {}
        cfg_path = os.path.join(model_dir, TOKENIZER_CONFIG_NAME)
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                config = json.load(f)
        config.pop("tokenizer_class", None)
        if spm_path is not None:
            from .convert_slow_tokenizer import convert_spm_to_fast

            # template hints: explicit add_bos_token/add_eos_token in
            # tokenizer_config.json win; otherwise t5-lineage spiece.model and
            # mbart-lineage sentencepiece.bpe.model append </s>, llama-lineage
            # tokenizer.model prepends <s>
            add_bos = config.get("add_bos_token")
            add_eos = config.get("add_eos_token")
            if add_bos is None and add_eos is None and not spm_path.endswith("tokenizer.model"):
                add_bos, add_eos = False, True
            tokenizer_object = convert_spm_to_fast(spm_path, add_bos=add_bos, add_eos=add_eos)
            # language codes etc. live outside the spm vocab (mbart lineage) —
            # graft them on from the configs' additional_special_tokens
            extra = config.get("additional_special_tokens") or []
            if extra:
                from tokenizers import AddedToken

                tokenizer_object.add_special_tokens(
                    [AddedToken(t if isinstance(t, str) else t.get("content", ""),
                                special=True, normalized=False) for t in extra])
        sp_path = os.path.join(model_dir, SPECIAL_TOKENS_MAP_FILE)
        if os.path.isfile(sp_path):
            with open(sp_path) as f:
                for k, v in json.load(f).items():
                    config.setdefault(k, v)
        config.update(kwargs)
        if tokenizer_object is not None:
            return cls(tokenizer_object=tokenizer_object, **config)
        return cls(tokenizer_file=tok_file, **config)

    def save_pretrained(self, save_directory: str):
        os.makedirs(save_directory, exist_ok=True)
        self._tokenizer.save(os.path.join(save_directory, TOKENIZER_FILE))
        config = {
            "tokenizer_class": type(self).__name__,
            "padding_side": self.padding_side,
            "model_max_length": self.model_max_length,
        }
        if self.chat_template:
            config["chat_template"] = self.chat_template
        for attr in SPECIAL_TOKEN_ATTRS:
            if getattr(self, attr, None) is not None:
                config[attr] = getattr(self, attr)
        config.update(self.init_kwargs)
        with open(os.path.join(save_directory, TOKENIZER_CONFIG_NAME), "w") as f:
            json.dump(config, f, indent=2, default=str)

    # ------------------------------------------------------------------ vocab
    @property
    def vocab_size(self) -> int:
        return self._tokenizer.get_vocab_size()

    def __len__(self):
        return self._tokenizer.get_vocab_size(with_added_tokens=True)

    def get_vocab(self) -> Dict[str, int]:
        return self._tokenizer.get_vocab()

    def convert_tokens_to_ids(self, tokens: Union[str, List[str]]):
        if isinstance(tokens, str):
            return self._tokenizer.token_to_id(tokens)
        return [self._tokenizer.token_to_id(t) for t in tokens]

    def convert_ids_to_tokens(self, ids: Union[int, List[int]]):
        if isinstance(ids, int):
            return self._tokenizer.id_to_token(ids)
        return [self._tokenizer.id_to_token(i) for i in ids]

    def _special_id(self, attr) -> Optional[int]:
        token = getattr(self, attr, None)
        return self._tokenizer.token_to_id(token) if token else None

    @property
    def pad_token_id(self):
        return self._special_id("pad_token")

    @property
    def eos_token_id(self):
        return self._special_id("eos_token")

    @property
    def bos_token_id(self):
        return self._special_id("bos_token")

    @property
    def unk_token_id(self):
        return self._special_id("unk_token")

    @property
    def cls_token_id(self):
        return self._special_id("cls_token")

    @property
    def sep_token_id(self):
        return self._special_id("sep_token")

    @property
    def mask_token_id(self):
        return self._special_id("mask_token")

    def add_special_tokens(self, special_tokens: Dict[str, str]) -> int:
        from tokenizers import AddedToken

        added = 0
        for attr, token in special_tokens.items():
            token = _token_content(token)
            if attr == "additional_special_tokens":
                added += self._tokenizer.add_special_tokens([AddedToken(t, special=True) for t in token])
                continue
            setattr(self, attr, token)
            if self._tokenizer.token_to_id(token) is None:
                added += self._tokenizer.add_special_tokens([AddedToken(token, special=True)])
        return added

    def add_tokens(self, tokens: Union[str, List[str]]) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        return self._tokenizer.add_tokens(tokens)

    # ------------------------------------------------------------------ encode
    def tokenize(self, text: str, **kwargs) -> List[str]:
        return self._tokenizer.encode(text, add_special_tokens=False).tokens

    def encode(self, text: str, add_special_tokens: bool = True, **kwargs) -> List[int]:
        return self._tokenizer.encode(text, add_special_tokens=add_special_tokens).ids

    def __call__(
        self,
        text: Union[str, List[str]],
        text_pair: Optional[Union[str, List[str]]] = None,
        padding: Union[bool, str] = False,
        truncation: Union[bool, str] = False,
        max_length: Optional[int] = None,
        add_special_tokens: bool = True,
        return_attention_mask: bool = True,
        return_token_type_ids: bool = False,
        return_offsets_mapping: bool = False,
        padding_side: Optional[str] = None,
        return_tensors: Optional[str] = None,
        **kwargs,
    ) -> BatchEncoding:
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        pairs = None
        if text_pair is not None:
            pairs = [text_pair] if isinstance(text_pair, str) else list(text_pair)
        if truncation:
            self._tokenizer.enable_truncation(max_length or self.model_max_length)
        else:
            self._tokenizer.no_truncation()
        inputs = list(zip(texts, pairs)) if pairs is not None else texts
        encodings = self._tokenizer.encode_batch(inputs, add_special_tokens=add_special_tokens)
        ids = [e.ids for e in encodings]
        type_ids = [e.type_ids for e in encodings]
        offsets = [list(e.offsets) for e in encodings] if return_offsets_mapping else None
        masks = [[1] * len(i) for i in ids]

        if padding:
            side = padding_side or self.padding_side
            pad_id = self.pad_token_id
            if pad_id is None:
                pad_id = 0
                logger.warning_once("tokenizer has no pad_token; padding with id 0")
            target = max_length if padding == "max_length" and max_length else max(len(i) for i in ids)
            for k in range(len(ids)):
                deficit = target - len(ids[k])
                if deficit > 0:
                    if side == "left":
                        ids[k] = [pad_id] * deficit + ids[k]
                        masks[k] = [0] * deficit + masks[k]
                        type_ids[k] = [0] * deficit + type_ids[k]
                        if offsets is not None:
                            offsets[k] = [(0, 0)] * deficit + offsets[k]
                    else:
                        ids[k] = ids[k] + [pad_id] * deficit
                        masks[k] = masks[k] + [0] * deficit
                        type_ids[k] = type_ids[k] + [0] * deficit
                        if offsets is not None:
                            offsets[k] = offsets[k] + [(0, 0)] * deficit

        out = {"input_ids": ids}
        if return_attention_mask:
            out["attention_mask"] = masks
        if return_token_type_ids:
            out["token_type_ids"] = type_ids
        if return_offsets_mapping:
            out["offset_mapping"] = offsets
        if single and return_tensors is None:
            out = {k: v[0] for k, v in out.items()}
        enc = BatchEncoding(out)
        if return_tensors == "np":
            enc.convert_to_numpy()
        return enc

    # ------------------------------------------------------------------ decode
    def decode(self, token_ids, skip_special_tokens: bool = True, **kwargs) -> str:
        ids = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        return self._tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)

    def batch_decode(self, sequences, skip_special_tokens: bool = True, **kwargs) -> List[str]:
        return [self.decode(s, skip_special_tokens=skip_special_tokens) for s in sequences]


def _token_content(token):
    if isinstance(token, dict):
        return token.get("content")
    return token

"""SentencePiece ``spiece.model`` -> ``tokenizers`` fast-tokenizer converter.

Port of ``paddlenlp_tpu/transformers/convert_slow_tokenizer.py`` (plain
Python, no torch): the ``ModelProto`` is decoded with a small proto2 wire-format
walker, since no sentencepiece wheel is needed. Field numbers, from the
reference's ``sentencepiece_model_pb2.py`` descriptor:

  ModelProto:      pieces=1 (repeated), trainer_spec=2, normalizer_spec=3
  SentencePiece:   piece=1 (str), score=2 (float), type=3
                   (NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4 UNUSED=5 BYTE=6)
  TrainerSpec:     model_type=3 (UNIGRAM=1 BPE=2), byte_fallback=35,
                   unk_id=40 bos_id=41 eos_id=42 pad_id=43
  NormalizerSpec:  precompiled_charsmap=2, add_dummy_prefix=3,
                   remove_extra_whitespaces=4

The rebuilt fast tokenizer is the JAX package's: Unigram (or extracted BPE,
merges in the same order) model, Precompiled normalizer from the embedded
charsmap, Metaspace pre-tokenizer/decoder, control pieces as special added
tokens. ``tokenizers`` is imported inside ``convert_spm_to_fast``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["parse_spm_model", "convert_spm_to_fast", "SpmModel"]

# SentencePiece.Type values
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# --------------------------------------------------------------------------- #
# minimal proto2 wire-format reader (varint walk; no protobuf dependency)
# --------------------------------------------------------------------------- #
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _walk(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    wire 0 -> int, wire 2 -> bytes, wire 5 -> raw 4 bytes, wire 1 -> raw 8."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        else:  # groups (3/4) don't occur in this schema
            raise ValueError(f"unsupported wire type {wt} at offset {i}")
        yield fno, wt, val


@dataclass
class SpmModel:
    pieces: List[Tuple[str, float, int]] = field(default_factory=list)  # (piece, score, type)
    model_type: int = 1  # UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    byte_fallback: bool = False
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True

    @property
    def is_bpe(self) -> bool:
        return self.model_type == 2


def parse_spm_model(data: bytes) -> SpmModel:
    m = SpmModel()
    for fno, _, val in _walk(data):
        if fno == 1:  # SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _walk(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            m.pieces.append((piece, score, ptype))
        elif fno == 2:  # TrainerSpec
            for f2, w2, v2 in _walk(val):
                if f2 == 3:
                    m.model_type = v2
                elif f2 == 35:
                    m.byte_fallback = bool(v2)
                elif f2 == 40:
                    m.unk_id = v2
                elif f2 == 41:
                    m.bos_id = v2
                elif f2 == 42:
                    m.eos_id = v2
                elif f2 == 43:
                    # proto2 negative int32 varints are sign-extended to 64 bits
                    m.pad_id = v2 - 2**64 if v2 >= 2**63 else v2
        elif fno == 3:  # NormalizerSpec
            for f2, w2, v2 in _walk(val):
                if f2 == 2:
                    m.precompiled_charsmap = v2
                elif f2 == 3:
                    m.add_dummy_prefix = bool(v2)
                elif f2 == 4:
                    m.remove_extra_whitespaces = bool(v2)
    return m


# --------------------------------------------------------------------------- #
# fast-tokenizer assembly
# --------------------------------------------------------------------------- #
def _extract_bpe_merges(vocab: Dict[str, int], scores: Dict[str, float]) -> List[Tuple[str, str]]:
    """Recover merge rules from a BPE spm vocab: every splittable piece whose
    halves are both in-vocab yields a merge, ranked by the merged piece's score
    (higher score = earlier merge) — the reference converter's extractor."""
    merges = []
    for piece, pid in vocab.items():
        if len(piece) < 2:
            continue
        best = None
        for i in range(1, len(piece)):
            left, right = piece[:i], piece[i:]
            if left in vocab and right in vocab:
                cand = (scores.get(left, 0.0) + scores.get(right, 0.0), left, right)
                if best is None or cand[0] > best[0]:
                    best = cand
        if best is not None:
            merges.append((scores.get(piece, 0.0), pid, best[1], best[2]))
    merges.sort(key=lambda t: (-t[0], t[1]))
    return [(l, r) for _, _, l, r in merges]


def convert_spm_to_fast(spm_path: str, *, add_bos: Optional[bool] = None,
                        add_eos: Optional[bool] = None):
    """Build a ``tokenizers.Tokenizer`` equivalent to the sentencepiece model at
    ``spm_path``. ``add_bos``/``add_eos`` override the post-processor template
    (default: llama-style bos-only when bos piece exists)."""
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers

    with open(spm_path, "rb") as f:
        m = parse_spm_model(f.read())
    if not m.pieces:
        raise ValueError(f"{spm_path}: no sentencepiece vocabulary found")

    if m.is_bpe:
        vocab = {p: i for i, (p, _, _) in enumerate(m.pieces)}
        scores = {p: s for p, s, _ in m.pieces}
        merges = _extract_bpe_merges(vocab, scores)
        unk_piece = m.pieces[m.unk_id][0] if 0 <= m.unk_id < len(m.pieces) else "<unk>"
        tok = Tokenizer(models.BPE(vocab, merges, unk_token=unk_piece,
                                   fuse_unk=True, byte_fallback=m.byte_fallback))
    else:
        tok = Tokenizer(models.Unigram([(p, s) for p, s, _ in m.pieces],
                                       unk_id=max(m.unk_id, 0), byte_fallback=m.byte_fallback))

    norms = []
    if m.precompiled_charsmap:
        norms.append(normalizers.Precompiled(m.precompiled_charsmap))
    if m.remove_extra_whitespaces:
        norms.append(normalizers.Replace(Regex(" {2,}"), " "))
    if norms:
        tok.normalizer = normalizers.Sequence(norms) if len(norms) > 1 else norms[0]

    scheme = "always" if m.add_dummy_prefix else "never"
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme=scheme)

    specials = [AddedToken(p, special=True, normalized=False)
                for p, _, t in m.pieces if t in (CONTROL, UNKNOWN)]
    if specials:
        tok.add_special_tokens(specials)

    bos = m.pieces[m.bos_id][0] if 0 <= m.bos_id < len(m.pieces) else None
    eos = m.pieces[m.eos_id][0] if 0 <= m.eos_id < len(m.pieces) else None
    add_bos = (bos is not None) if add_bos is None else (add_bos and bos is not None)
    add_eos = False if add_eos is None else (add_eos and eos is not None)
    if add_bos or add_eos:
        from tokenizers import processors

        single = ([f"{bos}:0"] if add_bos else []) + ["$A:0"] + ([f"{eos}:0"] if add_eos else [])
        pair = single + ([f"{bos}:1"] if add_bos else []) + ["$B:1"] + ([f"{eos}:1"] if add_eos else [])
        special_toks = []
        if add_bos:
            special_toks.append((bos, m.bos_id))
        if add_eos:
            special_toks.append((eos, m.eos_id))
        tok.post_processor = processors.TemplateProcessing(
            single=" ".join(single), pair=" ".join(pair), special_tokens=special_toks)
    return tok

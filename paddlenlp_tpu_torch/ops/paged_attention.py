"""Ragged paged attention: the CUDA kernel's wrapper and its plain version.

Port of ``paddlenlp_tpu/ops/pallas/paged_attention.py``. One call computes
attention for a ragged batch in which each sequence feeds ``q_lens[b]`` new
query tokens starting at absolute position ``q_start[b]`` (a prefill chunk, a
decode token, or nothing), reading its KV from the paged pool through
``block_tables[b]``. :func:`ragged_paged_attention_ref` computes the same
function in plain PyTorch.

Two kernels, the route chosen by dtype alone (:func:`kernel_route`). bf16
queries over a bf16, int8 or fp8 pool, the serving path's types, take the
Hopper tensor-core kernel of ``paddlenlp_tpu_torch/csrc/paged_attention_sm90.cu``
(``cp.async`` gather ring, ``wgmma``; a quantized pool lands as raw bytes
and is widened to bf16 in shared memory, its scales folded into the scores
and the probabilities; when the grid is small, as in decode, the kv walk is
split into :func:`kv_partitions` and a second kernel merges them in order).
fp32 queries or an fp32 pool take the SIMT kernel of
``paddlenlp_tpu_torch/csrc/paged_attention.cu``, the precise check.

:func:`ragged_paged_attention` takes the plain version only for tensors on the
CPU. For CUDA tensors it checks the operands and launches its kernel, or
raises: there is no fallback. ``LAUNCHES`` counts kernel launches on either
route, ``LAUNCHES_SM90`` those of the Hopper route (either pool kind) and
``LAUNCHES_SM90_QUANT`` those of the Hopper route over an int8 or fp8 pool.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from . import _build

__all__ = ["LAUNCHES", "LAUNCHES_SM90", "LAUNCHES_SM90_QUANT", "NEG_INF", "kernel_route", "kv_partitions",
           "paged_decode_attention", "ragged_paged_attention", "ragged_paged_attention_ref"]

NEG_INF = -1e30

#: kernel launches since the counter was last set to 0 (by a caller that
#: wants to know whether a run went through the kernel)
LAUNCHES = 0
#: the launches of those that took the Hopper route (paged_attention_sm90.cu)
LAUNCHES_SM90 = 0
#: the launches of those that took the Hopper route over an int8 or fp8 pool
LAUNCHES_SM90_QUANT = 0
#: guards the three counts: the engine loops of several in-process replicas
#: launch at the same time, and ``+=`` on a module global can lose a bump
_COUNT_LOCK = threading.Lock()

KV_TILE = 64  # kv positions of the Hopper kernel's tile, the unit of a partition
ROW_TILE = 64  # folded query rows of its block
H100_SMS = 132  # streaming multiprocessors of an H100 SXM

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_QUANTIZED = (torch.int8, torch.float8_e4m3fn)
#: route -> (library stem, C entry)
_ENTRIES = {"sm90": ("paged_attention_sm90", "pdnlp_ragged_paged_attention_sm90"),
            "sm90_quant": ("paged_attention_sm90", "pdnlp_ragged_paged_attention_sm90_quant"),
            "simt": ("paged_attention", "pdnlp_ragged_paged_attention")}
#: pointers and ints each entry takes, before its float scale and its stream
_ARGS = {"sm90": (9, 9), "sm90_quant": (11, 10), "simt": (9, 9)}


def kernel_route(q_dtype, kv_dtype) -> str:
    """The kernel a (query, pool) dtype pair takes on CUDA: ``"sm90"`` for
    bf16 queries over a bf16 pool, ``"sm90_quant"`` for bf16 queries over an
    int8 or fp8 pool (both paged_attention_sm90.cu), ``"simt"``
    (paged_attention.cu) for fp32 queries or an fp32 pool."""
    if q_dtype != torch.bfloat16 or kv_dtype == torch.float32:
        return "simt"
    return "sm90_quant" if kv_dtype in _QUANTIZED else "sm90"


def ragged_paged_attention_ref(q, pool_k, pool_v, block_tables, q_start, q_lens, scale=None,
                               k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain PyTorch version: gather each sequence's blocks, dequantize in
    fp32, mask per query row, softmax in fp32. Rows ``t >= q_lens[b]`` are
    exact zeros (their softmax denominator is 0, finalized as ``max(l, 1e-37)``
    like the kernel)."""
    B, T, N, H = q.shape
    _nb, K, bs, _ = pool_k.shape
    group = N // K
    S = block_tables.shape[1] * bs
    scale = H**-0.5 if scale is None else scale
    tables = block_tables.long()

    def gathered(pool, sc):  # [nb, K, bs, H] -> [B, K, S, H] fp32
        x = pool[tables].float()
        if sc is not None:
            x = x * sc[tables]
        return x.permute(0, 2, 1, 3, 4).reshape(B, K, S, H)

    k = gathered(pool_k, k_scale)
    v = gathered(pool_v, v_scale)
    qf = q.float().reshape(B, T, K, group, H)  # head n = kh * group + g
    s = torch.einsum("btkgh,bksh->bkgts", qf, k) * scale
    t = torch.arange(T, device=q.device)
    q_pos = q_start.long()[:, None] + t[None, :]
    valid = (torch.arange(S, device=q.device)[None, None, :] <= q_pos[:, :, None]) \
        & (t[None, :, None] < q_lens.long()[:, None, None])  # [B, T, S]
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bkgts,bksh->btkgh", p, v)
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # [B, T, K, group, 1]
    out = out / torch.clamp_min(l, 1e-37)
    return out.reshape(B, T, N, H).to(q.dtype)


def _check_cuda_operands(q, pool_k, pool_v, block_tables, q_start, q_lens, k_scale, v_scale):
    dev = q.device
    named = {"q": q, "pool_k": pool_k, "pool_v": pool_v, "block_tables": block_tables,
             "q_start": q_start, "q_lens": q_lens}
    if k_scale is not None or v_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ragged_paged_attention: {name} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"ragged_paged_attention: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be contiguous")
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(f"ragged_paged_attention: q must be [B,T,N,H] and pools [nb,K,bs,H], "
                         f"got {tuple(q.shape)} and {tuple(pool_k.shape)}")
    B, T, N, H = q.shape
    nb, K, bs, Hk = pool_k.shape
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"ragged_paged_attention: q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    if pool_k.dtype not in _KV_DTYPES or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"ragged_paged_attention: pool dtypes {pool_k.dtype}/{pool_v.dtype} "
                        f"not one of {list(_KV_DTYPES)}")
    if tuple(pool_v.shape) != tuple(pool_k.shape):
        raise ValueError(f"ragged_paged_attention: pool_v {tuple(pool_v.shape)} != pool_k {tuple(pool_k.shape)}")
    if H not in (64, 128) or Hk != H:
        raise ValueError(f"ragged_paged_attention: head_dim must be 64 or 128 on both q and the pool, "
                         f"got {H} and {Hk}")
    if not 1 <= bs <= 64:
        raise ValueError(f"ragged_paged_attention: block_size must be in [1, 64], got {bs}")
    if K < 1 or N % K:
        raise ValueError(f"ragged_paged_attention: {N} query heads do not fold over {K} kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"ragged_paged_attention: block_tables must be [{B}, max_blocks], "
                         f"got {tuple(block_tables.shape)}")
    for name, t in (("block_tables", block_tables), ("q_start", q_start), ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"ragged_paged_attention: {name} must be int32, got {t.dtype}")
    if tuple(q_start.shape) != (B,) or tuple(q_lens.shape) != (B,):
        raise ValueError(f"ragged_paged_attention: q_start/q_lens must be [{B}]")
    quantized = pool_k.dtype in _QUANTIZED
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("ragged_paged_attention: int8/fp8 pools need k_scale and v_scale, "
                         "float pools take neither")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (nb, K, bs, 1):
                raise ValueError(f"ragged_paged_attention: {name} must be float32 [{nb},{K},{bs},1], "
                                 f"got {t.dtype} {tuple(t.shape)}")


def kv_partitions(B, T, N, K, max_blocks, block_size, sms=H100_SMS) -> Tuple[int, int]:
    """How the Hopper kernel splits the kv walk of each (row tile, kv head,
    sequence): ``(parts, part_len)``, partition p covering kv positions
    ``[p * part_len, (p + 1) * part_len)``, ``part_len`` a multiple of
    :data:`KV_TILE` and ``parts * part_len`` at least the tables' capacity.

    A launch whose blocks already put two on every SM (prefill chunks) takes
    one partition and no merge. Otherwise (decode: 8 rows x 4 kv heads give
    32 blocks) the capacity is cut so that the grid holds about 8 blocks an
    SM: a block whose partition starts past its rows' context exits at once,
    and the engine's decode contexts (256-2,112 of 4,096) fill about a
    third of their tables, which leaves ~2 live blocks an SM. Shapes only:
    the contexts are on the device, and reading them would cost a sync."""
    tiles = -(-T * (N // K) // ROW_TILE) * K * B
    cap = max_blocks * block_size
    if tiles >= 2 * sms:
        return 1, -(-cap // KV_TILE) * KV_TILE
    want = max(1, min(-(-8 * sms // tiles), -(-cap // KV_TILE)))
    part_len = -(-cap // (want * KV_TILE)) * KV_TILE
    return -(-cap // part_len), part_len


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_fn(route: str):
    """The C entry of ``route`` (see :func:`kernel_route`)."""
    stem, symbol = _ENTRIES[route]
    fn = getattr(_build.load(stem), symbol)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[route]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ragged_paged_attention(q, pool_k, pool_v, block_tables, q_start, q_lens, scale=None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Attention for a ragged mixed prefill/decode batch over the paged pool.

    q [B, T, N, H] (bf16/fp32); pool_k/pool_v [nb, K, bs, H] (bf16, fp32, int8
    or fp8-e4m3; the quantized ones with k_scale/v_scale [nb, K, bs, 1] fp32);
    block_tables [B, max_blocks], q_start/q_lens [B], all int32. Query token t
    of row b attends kv positions ``[0, q_start[b] + t]``; returns
    [B, T, N, H] in q's dtype with rows ``t >= q_lens[b]`` zeroed. bf16 q
    over a bf16, int8 or fp8 pool runs the Hopper kernel, fp32 q or an fp32
    pool the SIMT one."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, pool_k, pool_v, block_tables, q_start, q_lens, scale,
                                          k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on CUDA (or its plain version on the CPU), "
                         f"got {q.device}")
    _check_cuda_operands(q, pool_k, pool_v, block_tables, q_start, q_lens, k_scale, v_scale)
    B, T, N, H = q.shape
    _nb, K, bs, _ = pool_k.shape
    mb = block_tables.shape[1]
    route = kernel_route(q.dtype, pool_k.dtype)
    scale = float(H**-0.5 if scale is None else scale)
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "simt":
            _launch(route, ptr(q), ptr(pool_k), ptr(pool_v), ptr(block_tables), ptr(q_start), ptr(q_lens),
                    ptr(k_scale), ptr(v_scale), ptr(out), B, T, N, K, H, bs, mb,
                    _Q_DTYPES[q.dtype], _KV_DTYPES[pool_k.dtype], scale, stream)
        else:
            parts, part_len = kv_partitions(B, T, N, K, mb, bs, _sm_count(q.device.index or 0))
            part_o = part_ml = None
            if parts > 1:  # each partition's unnormalised rows and their (max, sum), for the merge
                rows = B * K * parts * T * (N // K)
                part_o = torch.empty(rows * H, dtype=torch.float32, device=q.device)
                part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
            geometry = (B, T, N, K, H, bs, mb, parts, part_len)
            if route == "sm90":
                _launch(route, ptr(q), ptr(pool_k), ptr(pool_v), ptr(block_tables), ptr(q_start), ptr(q_lens),
                        ptr(out), ptr(part_o), ptr(part_ml), *geometry, scale, stream)
            else:
                _launch(route, ptr(q), ptr(pool_k), ptr(pool_v), ptr(k_scale), ptr(v_scale), ptr(block_tables),
                        ptr(q_start), ptr(q_lens), ptr(out), ptr(part_o), ptr(part_ml), *geometry,
                        _KV_DTYPES[pool_k.dtype], scale, stream)
    return out


def _launch(route, *args):
    """Call ``route``'s C entry with ``args`` and count the launch. A refused
    launch raises and counts nothing."""
    global LAUNCHES, LAUNCHES_SM90, LAUNCHES_SM90_QUANT
    rc = _kernel_fn(route)(*args)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed ({_ENTRIES[route][1]}): CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        if route != "simt":
            LAUNCHES_SM90 += 1
        if route == "sm90_quant":
            LAUNCHES_SM90_QUANT += 1


def paged_decode_attention(q, pool_k, pool_v, block_tables, context_lens, scale=None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode-only wrapper: every sequence feeds one query token at position
    ``context_lens[b]`` (the ragged kernel with ``q_lens = 1``). q [B, N, H]."""
    B = q.shape[0]
    out = ragged_paged_attention(
        q[:, None].contiguous(), pool_k, pool_v, block_tables, context_lens,
        torch.ones(B, dtype=torch.int32, device=q.device), scale=scale, k_scale=k_scale,
        v_scale=v_scale)
    return out[:, 0]

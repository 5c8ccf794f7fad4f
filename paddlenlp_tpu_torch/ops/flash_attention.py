"""Flash attention for training: the CUDA kernels' wrappers, their plain
versions, the autograd function and the attention dispatcher.

Port of ``paddlenlp_tpu/ops/pallas/flash_attention.py`` (``flash_attention``
:353, a ``custom_vjp`` over ``_flash_fwd`` :131 and ``_flash_bwd`` :272) and of
``paddlenlp_tpu/ops/flash_attention.py`` ``dot_product_attention`` (:72).
The kernels are in ``paddlenlp_tpu_torch/csrc/``:

- :func:`flash_attention_fwd` -> (out, lse), the forward (``_fa_kernel`` :81);
- :func:`flash_attention_bwd_dq` -> dq (``_bwd_dq_kernel`` :187);
- :func:`flash_attention_bwd_dkv` -> (dk, dv), summed per KV head over its
  query group (``_bwd_dkv_kernel`` :227).

Two routes, chosen by dtype (:func:`kernel_route`). bf16 operands, the
training path's, take all three through the Hopper tensor-core kernels of
``flash_attention_sm90.cu`` (``"sm90"``: TMA tile ring, ``wgmma``). fp32
operands, those of a model computing in fp32 and of the fp32 checks (1e-4
gates, which bf16 operands cannot meet), take all three through
``flash_attention_sm90_f32.cu`` (``"sm90_f32"``: 3xTF32 ``mma.sync``
products at fp32 accuracy; dk/dv's walks split over blocks by
:func:`dkv_split`, their partial sums merged in order by a second kernel).
Head dims (:data:`HEAD_DIMS`): both routes take 64, 128 and 192
(DeepSeek-V2's MLA runs q and k at 128 + 64 and pads v up to them; at 192
the fp32 kernels split the head dim over warp pairs) and refuse any other
with ``ValueError``.

Layouts are the JAX package's: q [B, T, N, H], k/v [B, S, K, H] with query
head n reading KV head n // (N // K), lse [B, N, T] fp32, segment_ids [B, T]
int32. :func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref`
compute the same functions in fp32, step by step; each wrapper takes them only
for tensors on the CPU. For CUDA tensors it checks the operands and launches
its kernel, or raises: there is no fallback. ``LAUNCHES`` counts each
kernel's launches on every route, ``LAUNCHES_SM90`` those of the bf16
Hopper route and ``LAUNCHES_SM90_F32`` those of the fp32 one.

:func:`dot_product_attention` is the dispatcher. It sends to the flash
kernels exactly the calls the JAX dispatcher sends to Pallas
(``pallas_eligible``, :108-116: causal self-attention with no padding mask and
no cache offset, ``T == S``); every other call it serves takes
:func:`dot_product_attention_dense`, the counterpart of XLA's
``jax.nn.dot_product_attention``: the masked and cached attention of
``generate``. That function is no kernel's plain version: it serves calls on
the card, and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["HEAD_DIMS", "LAUNCHES", "LAUNCHES_SM90", "LAUNCHES_SM90_F32", "NEG_INF", "dense_attention_mask",
           "dkv_split", "dkv_walk", "dot_product_attention", "dot_product_attention_dense", "flash_attention",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "flash_attention_bwd_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref", "kernel_route", "plain_softmax"]

NEG_INF = -1e30

#: kernel launches per kernel since the counters were last set to 0
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
#: the launches of those that took the Hopper bf16 route (flash_attention_sm90.cu)
LAUNCHES_SM90 = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
#: the launches of those that took the Hopper fp32 route (flash_attention_sm90_f32.cu)
LAUNCHES_SM90_F32 = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
#: guards the three dicts: threads of one process may launch at the same time,
#: and ``+=`` on a dict entry can lose a bump
_COUNT_LOCK = threading.Lock()

#: route -> (library stem, suffix of the C entries)
_ROUTES = {"sm90": ("flash_attention_sm90", "_sm90"), "sm90_f32": ("flash_attention_sm90_f32", "_sm90_f32")}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the head dims each route's kernels are built for
HEAD_DIMS = {"sm90": (64, 128, 192), "sm90_f32": (64, 128, 192)}

# where the options outside this port's slice are planned (ROADMAP.md)
_LATER = {
    "bias": "additive attention bias (ROADMAP Queue 1 item 14e, with T5's relative positions)",
    "use_alibi": "ALiBi (ROADMAP Queue 1 item 14e, with the bloom and baichuan families)",
    "dropout_rate": "attention dropout (ROADMAP Queue 1 item 15, training left)",
    "positions": "permuted positions for context parallel (ROADMAP Queue 1 item 15, training left)",
    "causal": "non-causal attention in the dispatcher (ROADMAP Queue 1 item 14e, the encoder families)",
}


def _check_args(q, k, v, segment_ids, causal, window):
    """The rejects of ``_flash_fwd`` (:133-139), on every device."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q must be [B,T,N,H] and k, v [B,S,K,H], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, N, H = q.shape
    Bk, S, K, Hk = k.shape
    if Bk != B or Hk != H:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if K < 1 or N % K:
        raise ValueError(f"flash_attention: {N} query heads do not fold over {K} kv heads")
    if causal and T != S:
        raise ValueError(f"causal flash_attention requires T == S (got T={T}, S={S}); "
                         "cross-length causal (KV cache) goes through the XLA dispatcher path")
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True (matches the XLA dispatcher)")
    if segment_ids is not None and (T != S or tuple(segment_ids.shape) != (B, T)):
        raise ValueError(f"flash_attention: segment_ids must be [{B}, {T}] with T == S, "
                         f"got {tuple(segment_ids.shape)} and S={S}")


# ---------------------------------------------------------------- plain versions
def _up(x):
    """x in fp32, or in float64 where it already is (gradcheck)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _visible(T, S, causal, window, segment_ids, device):
    """[B or 1, T, S] element visibility (``_visible`` :46)."""
    rows = torch.arange(T, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    valid = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        valid = valid & (cols <= rows)
    if window is not None:
        valid = valid & (cols > rows - window)
    valid = valid[None]
    if segment_ids is not None:
        valid = valid & (segment_ids[:, :, None] == segment_ids[:, None, :])
    return valid


def _scores(q, k, segment_ids, scale, causal, window):
    """fp32 scores [B, K, g, T, S] with invisible entries at NEG_INF, and the mask."""
    B, T, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    qf = _up(q).reshape(B, T, K, N // K, H)  # head n = kh * group + g
    s = torch.einsum("btkgh,bskh->bkgts", qf, _up(k)) * scale
    valid = _visible(T, S, causal, window, segment_ids, q.device)[:, None, None]
    return torch.where(valid, s, torch.full_like(s, NEG_INF)), valid


def flash_attention_fwd_ref(q, k, v, segment_ids=None, scale=None, causal=True,
                            window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward in fp32: (out [B,T,N,H] in q's dtype, lse [B,N,T]
    fp32). Invisible entries get p = 0, the denominator is ``max(l, 1e-37)``
    and ``lse = m + log(max(l, 1e-37))``, as the kernel's finalizer (:121-123)."""
    _check_args(q, k, v, segment_ids, causal, window)
    B, T, N, H = q.shape
    K = k.shape[2]
    scale = H**-0.5 if scale is None else scale
    s, valid = _scores(q, k, segment_ids, scale, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-37)  # [B, K, g, T, 1]
    out = torch.einsum("bkgts,bskh->btkgh", p / l, _up(v))
    lse = (m + torch.log(l))[..., 0].reshape(B, N, T)
    return out.reshape(B, T, N, H).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, do, lse, delta, segment_ids=None, scale=None, causal=True,
                            window=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward in fp32 from the saved lse and
    ``delta = rowsum(dO * O)`` [B,N,T] (:func:`_delta`): ``p = exp(s - lse)``,
    ``ds = p * (dO v^T - delta) * scale``; dq = ds k, dk = ds^T q and
    dv = p^T dO, summed over each KV head's query group. Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
    _check_args(q, k, v, segment_ids, causal, window)
    B, T, N, H = q.shape
    K = k.shape[2]
    g = N // K
    scale = H**-0.5 if scale is None else scale
    s, valid = _scores(q, k, segment_ids, scale, causal, window)
    lse5 = _up(lse).reshape(B, K, g, T)[..., None]
    p = torch.where(valid, torch.exp(s - lse5), torch.zeros_like(s))
    dof = _up(do).reshape(B, T, K, g, H)
    delta = _up(delta).reshape(B, K, g, T)[..., None]
    dv = torch.einsum("bkgts,btkgh->bskh", p, dof)
    dp = torch.einsum("btkgh,bskh->bkgts", dof, _up(v))
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgts,bskh->btkgh", ds, _up(k)).reshape(B, T, N, H)
    dk = torch.einsum("bkgts,btkgh->bskh", ds, _up(q).reshape(B, T, K, g, H))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels
def _check_cuda_operands(name, tensors, q, k, segment_ids):
    dev = q.device
    for tname, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {tname} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or tensors["v"].dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype of {list(_DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {tensors['v'].dtype}")
    H, route = q.shape[-1], kernel_route(q.dtype, "fwd")
    if H not in HEAD_DIMS[route]:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS[route]} on the {route} route, got {H}")
    if segment_ids is not None:
        if segment_ids.dtype != torch.int32:
            raise TypeError(f"{name}: segment_ids must be int32, got {segment_ids.dtype}")
        if segment_ids.device != dev or not segment_ids.is_contiguous():
            raise ValueError(f"{name}: segment_ids must be a contiguous tensor on {dev}")


def _kernel_fn(stem: str, symbol: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _geometry(q, k, causal, window):
    B, T, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    return [B, T, S, N, K, H, int(bool(causal)), -1 if window is None else int(window), _DTYPES[q.dtype]]


def kernel_route(dtype, what) -> str:
    """The route a launch of ``what`` (``"fwd"``, ``"bwd_dq"`` or
    ``"bwd_dkv"``) takes for operands of ``dtype``: ``"sm90"`` for bf16,
    ``"sm90_f32"`` for fp32 (the same for all three kernels)."""
    return "sm90" if dtype == torch.bfloat16 else "sm90_f32"


# the dk/dv walk's split (flash_attention_sm90_f32.cu): kv tiles of 64 rows,
# 16-row query steps; a part takes at least _MIN_CHUNK steps, and the launch
# aims at _WAVES waves of two blocks an SM. That is the residency of the 4-warp
# blocks at head_dim 64 and 128; at 192 one 8-warp block fills an SM, so the
# same chunk gives 2 * _WAVES waves there (more parts and merge traffic than
# one block an SM would need; the split was not retimed at 192)
_F32_RES, _F32_STEP, _MIN_CHUNK, _WAVES = 64, 16, 32, 3


def dkv_walk(T, S, causal, window, tile) -> Tuple[int, int]:
    """(lo, count): the 16-row query tiles lo .. lo + count - 1 that each query
    head walks for the fp32 dk/dv kernel's 64-row kv tile ``tile``, those
    that can see it (``dkv_walk`` of ``flash_attention_sm90_f32.cu``)."""
    n_qs = -(-T // _F32_STEP)
    kv0 = tile * _F32_RES
    lo, hi = 0, n_qs
    if causal:
        lo = kv0 // _F32_STEP
        if window is not None:
            last = min(kv0 + _F32_RES, S) - 1 + min(window, T + S) - 1
            hi = 0 if last < 0 else min(n_qs, last // _F32_STEP + 1)
    return lo, max(hi - lo, 0)


def dkv_split(B, T, S, N, K, causal, window, sms) -> Tuple[int, int]:
    """How the fp32 dk/dv kernel splits its walks over a card of ``sms``
    streaming multiprocessors: (chunk, slots). Each 64-row kv tile walks
    ``N // K`` query heads times its visible 16-row query tiles; the walk is
    cut into parts of ``chunk`` steps so that the launch fills about three
    waves of two blocks an SM (the causal mask leaves the first tile's walk
    the longest; at head_dim 192, one block an SM, about six waves), and
    every part of a tile cut in more than one takes a
    workspace slot of [B, K, 2, 64, H] fp32 partial sums."""
    totals = [(N // K) * dkv_walk(T, S, causal, window, t)[1] for t in range(-(-S // _F32_RES))]
    chunk = max(_MIN_CHUNK, -(-B * K * sum(totals) // (_WAVES * 2 * sms)))
    parts = [max(1, -(-tot // chunk)) for tot in totals]
    return chunk, sum(p for p in parts if p > 1)


def _launch(symbol, n_ptr, ptrs, q, k, causal, window, scale, what, extra=()):
    """Launch ``what`` on its route (:func:`kernel_route`); ``extra`` ints
    follow the geometry. A refused launch raises; nothing runs in its place."""
    route = kernel_route(q.dtype, what)
    stem, suffix = _ROUTES[route]
    symbol += suffix
    ints = _geometry(q, k, causal, window) + list(extra)
    H = q.shape[-1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_fn(stem, symbol, n_ptr, len(ints))(*ptrs, *ints, float(H**-0.5 if scale is None else scale),
                                                         stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed ({symbol}): CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES[what] += 1
        if route == "sm90":
            LAUNCHES_SM90[what] += 1
        elif route == "sm90_f32":
            LAUNCHES_SM90_F32[what] += 1


def _device(name, q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (or its plain version on the CPU), got {q.device}")
    return True


def flash_attention_fwd(q, k, v, segment_ids=None, scale=None, causal=True,
                        window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (out [B,T,N,H] in q's dtype, lse [B,N,T] fp32)."""
    _check_args(q, k, v, segment_ids, causal, window)
    if not _device("flash_attention_fwd", q):
        return flash_attention_fwd_ref(q, k, v, segment_ids, scale, causal, window)
    _check_cuda_operands("flash_attention_fwd", {"q": q, "k": k, "v": v}, q, k, segment_ids)
    B, T, N, _H = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, N, T, dtype=torch.float32, device=q.device)
    _launch("pdnlp_flash_fwd", 6, [_ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(out), _ptr(lse)],
            q, k, causal, window, scale, "fwd")
    return out, lse


def _delta(out, do):
    """rowsum(dO * O) in fp32, [B, N, T] (computed outside the kernels, as
    XLA does for the TPU kernels, :279)."""
    return (_up(do) * _up(out)).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_dq(q, k, v, do, lse, delta, segment_ids=None, scale=None, causal=True,
                           window=None) -> torch.Tensor:
    """dq [B,T,N,H] in q's dtype from the saved lse and ``delta = rowsum(dO*O)``
    [B,N,T] fp32."""
    _check_args(q, k, v, segment_ids, causal, window)
    if not _device("flash_attention_bwd_dq", q):
        return flash_attention_bwd_ref(q, k, v, do, lse, delta, segment_ids, scale, causal, window)[0]
    _check_cuda_operands("flash_attention_bwd_dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta},
                         q, k, segment_ids)
    _check_saved("flash_attention_bwd_dq", q, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("pdnlp_flash_bwd_dq", 8,
            [_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(segment_ids), _ptr(dq)],
            q, k, causal, window, scale, "bwd_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, segment_ids=None, scale=None, causal=True,
                            window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,K,H] in k's dtype, accumulated in fp32 per KV head over
    its query group."""
    _check_args(q, k, v, segment_ids, causal, window)
    if not _device("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_ref(q, k, v, do, lse, delta, segment_ids, scale, causal, window)[1:]
    _check_cuda_operands("flash_attention_bwd_dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta},
                         q, k, segment_ids)
    _check_saved("flash_attention_bwd_dkv", q, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(segment_ids), _ptr(dk), _ptr(dv)]
    if kernel_route(q.dtype, "bwd_dkv") != "sm90_f32":
        _launch("pdnlp_flash_bwd_dkv", 9, ptrs, q, k, causal, window, scale, "bwd_dkv")
        return dk, dv
    B, T, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, slots = dkv_split(B, T, S, N, K, causal, window, sms)
    ws = torch.empty(slots * B * K * 2 * _F32_RES * H, dtype=torch.float32, device=q.device) if slots else None
    _launch("pdnlp_flash_bwd_dkv", 10, ptrs + [_ptr(ws)], q, k, causal, window, scale, "bwd_dkv", (chunk, slots))
    return dk, dv


def _check_saved(name, q, do, lse, delta):
    B, T, N, _H = q.shape
    if do.dtype != q.dtype or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: do must be {q.dtype} {tuple(q.shape)}, got {do.dtype} {tuple(do.shape)}")
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, N, T):
            raise ValueError(f"{name}: {tname} must be float32 [{B}, {N}, {T}], got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of :353: the forward saves (q, k, v, out, lse); the
    backward computes delta and runs the dq and dk/dv kernels (for CPU
    tensors, the plain backward once)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, causal, window):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, scale, causal, window)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.opts = (scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        scale, causal, window = ctx.opts
        do = do.contiguous()
        delta = _delta(out, do)
        if q.device.type == "cpu":  # the plain backward computes all three at once
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, lse, delta, segment_ids, scale, causal, window)
        else:
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, segment_ids, scale, causal, window)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, segment_ids, scale, causal, window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, segment_ids: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention (the ``flash_attention`` custom_vjp,
    :353): q [B,T,N,H], k/v [B,S,K,H] -> [B,T,N,H] in q's dtype."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), segment_ids, scale, causal, window)


def plain_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic over the last axis: exp(x - max) / sum
    (the port's samplers and this module's XLA-path counterpart share it)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def dot_product_attention_dense(query, key, value, mask: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Attention in plain PyTorch with the arithmetic of XLA's
    ``jax.nn.dot_product_attention`` (``_dot_product_attention_core`` and
    ``_apply_masks`` in jax 0.9): query [B,T,N,H] over key/value [B,S,K,H],
    ``mask`` a bool [B|1, N|1, T, S] (True = attend). The logits are the
    operands' product in fp32 (at least), scaled, and set to
    ``-0.7 * finfo.max`` where masked; the softmax runs in fp32 and the
    probabilities are cast to the value dtype before the PV product; query
    head n reads KV head n // (N // K). A fully masked row attends uniformly
    over all S positions: it comes out finite wherever V is finite."""
    B, T, N, H = query.shape
    S, K = key.shape[1], key.shape[2]
    if N % K:
        raise ValueError(f"dot_product_attention_dense: {N} query heads do not fold over {K} kv heads")
    G = N // K
    scale = H**-0.5 if scale is None else scale
    ldt = torch.promote_types(query.dtype, torch.float32)
    logits = torch.einsum("btkgh,bskh->bkgts", query.reshape(B, T, K, G, H).to(ldt), key.to(ldt))
    logits = logits * torch.tensor(scale, dtype=ldt, device=logits.device)
    if mask is not None:
        mB, mN = mask.shape[0], mask.shape[1]
        grouped = mask[:, :, None] if mN == 1 else mask.reshape(mB, K, G, T, S)
        big_neg = torch.tensor(-0.7 * torch.finfo(ldt).max, dtype=ldt, device=logits.device)
        logits = torch.where(grouped, logits, big_neg)
    probs = plain_softmax(logits.float()).to(key.dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, value).reshape(B, T, N, H)


def dense_attention_mask(B, T, S, device, attention_mask, segment_ids, q_offset, window):
    """[B, 1, T, S] bool: causal from ``q_offset`` (the absolute position of
    query row 0) with an optional window, same segment, and the padding mask
    (``paddlenlp_tpu/ops/flash_attention.py:135-153``)."""
    rows = torch.arange(T, device=device)[:, None] + q_offset
    cols = torch.arange(S, device=device)[None, :]
    mask = cols <= rows
    if window is not None:
        mask = mask & (cols > rows - window)
    mask = mask[None, None].expand(B, 1, T, S)
    if segment_ids is not None:
        q_seg = segment_ids[:, -T:] if T != S else segment_ids
        mask = mask & (q_seg[:, None, :, None] == segment_ids[:, None, None, :])
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].to(device=device, dtype=torch.bool)
    return mask


def dot_product_attention(query, key, value, *, attention_mask=None, segment_ids=None, causal: bool = True,
                          q_offset=0, scale: Optional[float] = None, dropout_rate: float = 0.0,
                          window: Optional[int] = None, positions=None, use_alibi: bool = False,
                          bias=None) -> torch.Tensor:
    """Causal attention, query [B,T,N,H] over key/value [B,S,K,H], with
    optional packed-batch ``segment_ids`` [B, S], a sliding ``window``, a
    padding ``attention_mask`` [B, S] (1 = keep) and ``q_offset``, the
    absolute position of query row 0 over a KV cache (the dispatcher of
    ``paddlenlp_tpu/ops/flash_attention.py:72``). Calls the JAX dispatcher
    would send to Pallas (no mask, no offset, ``T == S``) run the flash
    kernels (on the card: bf16 and fp32 at head_dim 64, 128 or 192,
    :data:`HEAD_DIMS`); the rest run :func:`dot_product_attention_dense`.
    The options outside the port's slice raise ``NotImplementedError``."""
    asked = {"bias": bias is not None, "use_alibi": use_alibi, "dropout_rate": dropout_rate != 0.0,
             "positions": positions is not None, "causal": not causal}
    for opt, on in asked.items():
        if on:
            raise NotImplementedError(f"dot_product_attention: {_LATER[opt]} is not part of the port yet")
    B, T = query.shape[0], query.shape[1]
    S = key.shape[1]
    q_offset = int(q_offset)
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=query.device, dtype=torch.int32).contiguous()
    if attention_mask is None and q_offset == 0 and T == S:
        return flash_attention(query, key, value, segment_ids, scale, True, window)
    mask = dense_attention_mask(B, T, S, query.device, attention_mask, segment_ids, q_offset, window)
    return dot_product_attention_dense(query, key, value, mask, scale)

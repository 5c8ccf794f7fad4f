"""TF32 arithmetic of the port's tensor-core kernels, emulated in torch on the
CPU: the operand roundings of ``mma.sync ... .tf32`` and the 3xTF32 split
(hi and lo parts, three products) that gives fp32 accuracy."""

import torch


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: x rounded to TF32's 10 mantissa bits, to nearest
    with ties away from zero (finite x)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x as the tensor core reads an fp32 register as a TF32 operand: its low
    13 bits dropped (toward zero)."""
    b = x.float().contiguous().view(torch.int32)
    return (b & -0x2000).view(torch.float32)


def mm_tf32(a, b, passes, lo=tf32_rna):
    """a @ b as the kernels' ``mma.sync`` products make it: each operand split
    into hi = tf32_rna(x) and lo = ``lo``(x - hi), then a_lo b_hi + a_hi b_lo +
    a_hi b_hi in fp32 (``passes=3``), or a_hi b_hi alone (``passes=1``, one
    TF32 pass)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return ah @ bh
    return lo(a - ah) @ bh + ah @ lo(b - bh) + ah @ bh

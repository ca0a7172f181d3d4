"""Quantization-interval math: the reference's quant "magic" tables,
GET_ORIG_COEF, the interval clamp, and the exact C float->int
conversion semantics the scalar build relies on
(reference: quantsmooth.h:324-341, 555-560, 2497-2539).

Tables are built with numpy on the host; the rest is eager torch on
whatever device the tensors live on.  Every float op is a separate
torch op (no fused multiply-add), so each result is rounded once, as
in the C scalar build.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(1 << 31)
_TWO31 = 2147483648.0  # 2^31, exactly representable in fp32


def make_quant_tables(qtbl):
    """Sanitized quantizers + fixed-point reciprocal/shift.

    Returns (div, x1, qshr) int32[64] numpy arrays ready for
    get_orig_coef.  div is the zero-repaired quantizer
    (quantsmooth.h:2508-2511); x1 and qshr reproduce the reference's
    round-half-away division tables (quantsmooth.h:2513-2539, non-NEON
    branch), reinterpreted int16 as the C code does with
    (int16_t)quantval[...].
    """
    q = np.asarray(qtbl, dtype=np.int64)
    q = (q - ((q - 1) >> 16)).astype(np.int64)  # zero -> 1
    div = q.astype(np.int32)
    x1s = np.zeros(64, dtype=np.int32)
    qshrs = np.zeros(64, dtype=np.int32)
    for i in range(64):
        qi = int(q[i])
        n = qi.bit_length() - 1
        x1 = (((0x10000 << n) + qi - 1) // qi) & 0xFFFFFFFF
        if n:
            x1 |= x1 >> 16
        x2 = (-0x8000 >> n) & 0xFFFF
        x1s[i] = np.uint16(x1 & 0xFFFF).astype(np.int16)
        qshrs[i] = np.uint16(x2).astype(np.int16)
    return div, x1s, qshrs


def roundf(x):
    """C roundf: round half away from zero, exact for fp32.

    Split x = trunc + frac (both exact) and compare the fraction
    against 0.5; floor(x + 0.5) is wrong one ulp below the tie."""
    t = torch.trunc(x)
    f = x - t  # exact (Sterbenz)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (t + torch.where(f >= 0.5, one, zero)) - torch.where(
        f <= -0.5, one, zero)


def c_f32_to_i32(x):
    """C ``(int)`` cast of a float on x86 (cvttss2si): truncate toward
    zero; NaN and out-of-range values give INT32_MIN, which the scalar
    reference relies on when a weight sum is zero
    (quantsmooth.h:1548-1561 with a3 == 0).  torch's own cast leaves
    those cases undefined, so they are masked explicitly."""
    t = torch.trunc(x)
    in_range = (t >= -_TWO31) & (t < _TWO31)     # NaN fails both
    safe = torch.where(in_range, t, torch.zeros_like(t))
    return torch.where(in_range, safe.to(torch.int32),
                       torch.full_like(safe, INT32_MIN, dtype=torch.int32))


def wrap_i32(x):
    """int64 tensor -> int32 with C two's-complement wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def get_orig_coef(coef, div, x1, qshr):
    """Nearest dequantized lattice point a0 = round_half_away(c/q)*q,
    the fixed-point formula of the reference (quantsmooth.h:332-336,
    non-NEON).  All args broadcastable int32."""
    c = coef.to(torch.int32)
    a0 = ((x1 * c) >> 16) + c
    a0 = ((-a0) * qshr + 0x4000) >> 15
    return a0 * div


def interval_clamp(add, a0, div):
    """Clamp to the quantization interval around a0
    (reference: quantsmooth.h:555-560)."""
    d0 = (div - 1) >> 1
    d1 = div >> 1
    dh = a0 + torch.where(a0 < 0, d1, d0)
    dl = a0 - torch.where(a0 > 0, d1, d0)
    return torch.maximum(torch.minimum(add, dh), dl)

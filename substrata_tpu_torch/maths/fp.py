"""Float32 rounding helpers that repeat the reference's arithmetic.

XLA on the CPU contracts ``a * b + c`` into one fused multiply-add, and
``jnp.mod`` on floats is ``fmod`` shifted into the divisor's sign.  Where a
result must match the reference to the bit (audio playheads, which grow to
thousands of samples), the port rounds the same way: ``fma`` rounds once,
the kernels call ``__fmaf_rn`` at the same places.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x):
    """Python numbers take float32 rounding first (XLA's weak types)."""
    return float(np.float32(x)) if isinstance(x, (int, float)) else x.to(torch.float64)


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding: the product of two float32
    values is exact in float64, and the sum is rounded there and then to
    float32 (the two roundings differ from one only at an exact float32
    tie, which these inputs do not reach in practice)."""
    return (_f32(a) * _f32(b) + _f32(c)).to(torch.float32)


def recip(c: float) -> float:
    """float32 ``1 / c``: XLA folds a division by a static config value
    into a multiply by this reciprocal."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt(x):
    """Correctly rounded float32 square root, as XLA and CUDA's sqrtf give
    it (torch's float32 sqrt on the CPU can be one ulp off); the float64
    root of a float32 rounds to the float32 one without double-rounding
    error."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def dot3(a, b):
    """fma(a2, b2, fma(a1, b1, a0 b0)) over the trailing axis: a sum of
    products as XLA reduces it."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def float_mod(x, y):
    """``jnp.mod`` for floats (``torch.remainder`` rounds differently).
    ``y`` is a tensor or a Python number."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)

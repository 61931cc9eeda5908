"""BC1 (DXT1) block encoding of texture mip chains (kernel KAC).

Replaces K18, ``substrata_tpu/shared/texture_compress.py:_bc1_kernel``
(:46, jitted at :120): per 4x4 block of [nb, 16, 3] float32 pixels
(values 0..255) a range fit, two least-squares refinements of the
endpoints, RGB565 quantisation, the swap to the 4-colour mode
(word(c0) > word(c1)) and the final index pick against the quantised
palette; equal endpoints take index 0.  Out: [nb, 2] int32 holding the
uint32 words (word 0 = c0 | c1 << 16, word 1 = sixteen 2-bit indices,
pixel 0 in the low bits); the host views them as ``<u4``.

``bc1_encode`` runs ``bc1_encode_plain`` for CPU tensors and the launch of
``csrc/bc1.cu`` for CUDA ones.  Rounding follows the jitted reference,
found by comparing against it on seeded corpora (tests/test_torch_texture.py):
XLA folds ``c * 31 / 255`` into one multiply by fl(31 fl(1/255)) and the
expansion into one by fl(255 fl(1/31)) (63 likewise); ``jnp.round`` rounds half
to even; the reciprocal of the determinant is a true division; every sum
of products is an fma chain in index order (the palette
``fma(w, c0, (1 - w) c1)``, each squared distance
``fma(e2, e2, fma(e1, e1, e0 e0))``, the 16-term sums and the two
``einsum`` dots, and ``a b - c d`` as ``fma(a, b, -(c d))``).  The argmins
keep the first minimum.  The twin does its bit packing in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp

launches = 0

# Fraction of c0 by palette index in the 4-colour mode, and 1 - it, both
# rounded to float32 as the reference's constants are.
_W = np.array([1.0, 0.0, 2.0 / 3.0, 1.0 / 3.0], np.float32)
# XLA folds ``c * a / b`` into ``c * fl(a * fl(1 / b))``.
_Q5 = float(np.float32(31) * (np.float32(1) / np.float32(255)))     # 0.121568635
_Q6 = float(np.float32(63) * (np.float32(1) / np.float32(255)))     # 0.247058839
_E5 = float(np.float32(255) * (np.float32(1) / np.float32(31)))     # 8.22580624
_E6 = float(np.float32(255) * (np.float32(1) / np.float32(63)))     # 4.04761934

# The twin's working set is ~1.6 kB a block in float64; it walks long
# chains in pieces of this many blocks.
_PLAIN_CHUNK = 1 << 16


def _mix(w, v, c0, c1):
    """The palette [nb, 4, 3]: fma(w, c0, v * c1)."""
    return fp.fma(w[None, :, None], c0[:, None, :], v[None, :, None] * c1[:, None, :])


def _nearest(blocks, pal):
    """Index of the nearest palette entry per pixel, the first on ties."""
    e = blocks[:, :, None, :] - pal[:, None, :, :]
    d = fp.fma(e[..., 2], e[..., 2], fp.fma(e[..., 1], e[..., 1], e[..., 0] * e[..., 0]))
    best, idx = d[..., 0], torch.zeros(d.shape[:2], dtype=torch.int64, device=d.device)
    for k in range(1, 4):
        lt = d[..., k] < best
        best = torch.where(lt, d[..., k], best)
        idx = torch.where(lt, k, idx)
    return idx


def _chain(x, y):
    """sum_p x[:, p] * y[:, p] over 16 pixels as an fma chain; ``y`` may
    carry a trailing colour axis."""
    if y.dim() == 3:
        x = x[:, :, None]
    acc = x[:, 0] * y[:, 0]
    for p in range(1, 16):
        acc = fp.fma(x[:, p], y[:, p], acc)
    return acc


def _q565(c):
    """(565 word, expanded 8-bit endpoint) of endpoints [nb, 3]."""
    r = torch.round(c[:, 0] * _Q5).clamp(0, 31)
    g = torch.round(c[:, 1] * _Q6).clamp(0, 63)
    b = torch.round(c[:, 2] * _Q5).clamp(0, 31)
    word = (r.long() << 11) | (g.long() << 5) | b.long()
    return word, torch.stack([r * _E5, g * _E6, b * _E5], dim=-1)


def _encode_chunk(blocks):
    dev = blocks.device
    wts = torch.as_tensor(_W, device=dev)
    vts = 1.0 - wts
    c0, c1 = blocks.max(dim=1).values, blocks.min(dim=1).values
    for _ in range(2):
        idx = _nearest(blocks, _mix(wts, vts, c0, c1))
        w = wts[idx]
        v = 1.0 - w
        sww, swv, svv = _chain(w, w), _chain(w, v), _chain(v, v)
        bw, bv = _chain(w, blocks), _chain(v, blocks)
        det = fp.fma(sww, svv, -(swv * swv))
        ok = det.abs() > 1e-6
        inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
        n0 = fp.fma(svv[:, None], bw, -(swv[:, None] * bv)) * inv[:, None]
        n1 = fp.fma(sww[:, None], bv, -(swv[:, None] * bw)) * inv[:, None]
        c0 = torch.where(ok[:, None], n0.clamp(0.0, 255.0), c0)
        c1 = torch.where(ok[:, None], n1.clamp(0.0, 255.0), c1)
    w0, p0 = _q565(c0)
    w1, p1 = _q565(c1)
    swap = w0 < w1
    w0, w1 = torch.where(swap, w1, w0), torch.where(swap, w0, w1)
    p0, p1 = (torch.where(swap[:, None], p1, p0), torch.where(swap[:, None], p0, p1))
    idx = _nearest(blocks, _mix(wts, vts, p0, p1))
    idx = torch.where((w0 == w1)[:, None], 0, idx)
    bits = (idx << (2 * torch.arange(16, device=dev))).sum(dim=1)     # disjoint bits
    words = torch.stack([w0 | (w1 << 16), bits], dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def bc1_encode_plain(blocks: torch.Tensor) -> torch.Tensor:
    """The twin: [nb, 16, 3] float32 -> [nb, 2] int32 (uint32 bits)."""
    return torch.cat([_encode_chunk(blocks[i:i + _PLAIN_CHUNK])
                      for i in range(0, max(blocks.shape[0], 1), _PLAIN_CHUNK)])


def bc1_encode(blocks: torch.Tensor) -> torch.Tensor:
    """KAC: BC1-encode ``blocks`` [nb, 16, 3] float32 (0..255) into
    [nb, 2] int32 words, one launch for the whole batch."""
    global launches
    if blocks.device.type == "cpu":
        return bc1_encode_plain(blocks)
    nb = blocks.shape[0]
    build.check(blocks, "blocks", torch.float32, (nb, 16, 3), blocks.device)
    if blocks.data_ptr() % 16:
        blocks = blocks.clone()        # the kernel stages with 16-byte loads
    out = torch.empty((nb, 2), dtype=torch.int32, device=blocks.device)
    build.launch("bc1_encode", blocks, out, nb)
    launches += 1
    return out

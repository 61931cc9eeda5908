"""One halo exchange phase of the spatially sharded step (kernel KAD).

Replaces K20c, ``substrata_tpu/parallel/spatial.py:halo_exchange`` (:97)
with ``_pack_halo`` (:86), and ``_axis_exchange`` (:238) for the 2-D
tiles.  The reference runs inside ``shard_map``: each device masks its
boundary bodies, packs up to ``halo_cap`` of them by ``argsort(~mask)``
and ``ppermute``s them to its neighbours, whose missing links deliver
zeros.  On one card the mesh axis is the leading shard axis: every field
of the source state is a contiguous [S * rows_in] array, and one launch
writes the combined [S * (rows_in + 2H)] state, shard d's rows followed by
the H rows from its low neighbour and the H from its high one (the
reference's ``concat([local, from_left, from_right])``).

``exchange`` runs ``exchange_plain`` for CPU tensors and the launch of
``csrc/halo.cu`` for CUDA ones.  The shard at axis position ``(d //
stride) % n_axis`` sends up to ``d + stride`` and down to ``d - stride``:
stride 1 for x-slabs and a tile grid's y axis, ``py`` for its x axis.

Rounding of the edges (probed on the compiled HLO of ``halo_exchange``
inside ``shard_map``): XLA folds the weak-typed constants, so
``left_edge + halo_width`` becomes ``d * w + fl(x_min + hw)`` and
``right_edge - halo_width`` becomes ``d * w + fl(fl(x_min + w) - hw)``,
each one fma; ``thresholds`` computes them so on the host.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.physics.state import BODY_FIELDS, BodyState

launches = 0

ALIVE_F = BODY_FIELDS.index("alive")
AWAKE_F = BODY_FIELDS.index("awake")


def thresholds(lo: float, hi: float, n: int, halo_width: float):
    """(low, high) mask thresholds [n] float32 of the n shards along one axis
    over [lo, hi], by axis position: a body is sent down when its coordinate is below
    low[d], up when above high[d]."""
    f32 = np.float32
    w = f32((hi - lo) / n)
    c_lo = f32(f32(lo) + f32(halo_width))
    c_hi = f32(f32(f32(lo) + w) - f32(halo_width))
    d = np.arange(n, dtype=np.float64)
    # fma(d, w, c): the product is exact in float64, one rounding at the end.
    return ((d * np.float64(w) + np.float64(c_lo)).astype(f32),
            (d * np.float64(w) + np.float64(c_hi)).astype(f32))


def _rows(t: torch.Tensor, n_shards: int) -> torch.Tensor:
    return t.reshape((n_shards, -1) + tuple(t.shape[1:]))


def exchange_plain(src: BodyState, n_shards: int, halo: int, axis: int, stride: int,
                   n_axis: int, lo_thr, hi_thr):
    """The twin.  Returns (combined BodyState [S * (rows_in + 2H)],
    overflow int32 [S, 2]: max(count - H, 0) of the high and the low
    boundary of each shard)."""
    dev = src.device
    s = n_shards
    pos = _rows(src.pos, s)
    alive = _rows(src.alive, s)
    c = pos[..., axis]
    ap = (torch.arange(s, device=dev) // stride) % n_axis
    lo_t = torch.as_tensor(np.asarray(lo_thr, np.float32), device=dev)[ap, None]
    hi_t = torch.as_tensor(np.asarray(hi_thr, np.float32), device=dev)[ap, None]
    masks = (alive & (c > hi_t), alive & (c < lo_t))        # sent up, sent down
    packs = []
    for mask in masks:
        order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :halo]
        valid = torch.gather(mask, 1, order)
        fields = {}
        for f in BODY_FIELDS:
            x = _rows(getattr(src, f), s)
            idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
                order.shape + tuple(x.shape[2:]))
            fields[f] = torch.gather(x, 1, idx)
        fields["alive"] = fields["alive"] & valid
        fields["awake"] = fields["awake"] & valid
        packs.append(fields)
    count = torch.stack([m.sum(1) for m in masks], dim=1)
    overflow = torch.clamp(count - halo, min=0).to(torch.int32)
    has_low = (ap > 0)
    has_high = (ap < n_axis - 1)
    src_low = torch.clamp(torch.arange(s, device=dev) - stride, 0, s - 1)
    src_high = torch.clamp(torch.arange(s, device=dev) + stride, 0, s - 1)
    out = {}
    for f in BODY_FIELDS:
        x = _rows(getattr(src, f), s)
        up, down = packs[0][f], packs[1][f]
        shape = (s, 1) + (1,) * (x.dim() - 2)
        from_low = torch.where(has_low.reshape(shape), up[src_low], torch.zeros_like(up))
        from_high = torch.where(has_high.reshape(shape), down[src_high], torch.zeros_like(down))
        out[f] = torch.cat([x, from_low, from_high], dim=1).reshape((-1,) + tuple(x.shape[2:]))
    return BodyState(**out), overflow


def _host_ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 4-byte aligned (the kernels copy rows that are
    whole 32-bit words as words)."""
    if not t.is_contiguous() or t.data_ptr() % 4:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def exchange(src: BodyState, n_shards: int, halo: int, axis: int, stride: int, n_axis: int,
             lo_thr, hi_thr, overflow: torch.Tensor | None = None):
    """KAD: one exchange phase over all shards, one launch.  ``src`` holds
    S contiguous blocks of rows_in rows; returns (combined [S * (rows_in +
    2H)], overflow int32 [S, 2]), the counts written into ``overflow`` when
    the caller passes one."""
    global launches
    total = src.capacity
    if total % n_shards:
        raise ValueError(f"capacity {total} is not a multiple of {n_shards} shards")
    rows_in = total // n_shards
    if halo > rows_in:
        raise ValueError(f"halo_cap {halo} > {rows_in} rows a shard")
    if src.device.type == "cpu":
        combined, ov = exchange_plain(src, n_shards, halo, axis, stride, n_axis, lo_thr, hi_thr)
        if overflow is None:
            return combined, ov
        overflow.copy_(ov)
        return combined, overflow
    dev = src.device
    ins = [aligned(getattr(src, f)) for f in BODY_FIELDS]
    for f, t in zip(BODY_FIELDS, ins):
        if t.device != dev or t.shape[0] != total:
            raise ValueError(f"{f}: shape {tuple(t.shape)} on {t.device}, expected "
                             f"[{total}, ...] on {dev}")
    rows_out = rows_in + 2 * halo
    outs = [torch.empty((n_shards * rows_out,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
            for t in ins]
    if overflow is None:
        overflow = torch.empty((n_shards, 2), dtype=torch.int32, device=dev)
    build.check(overflow, "overflow", torch.int32, (n_shards, 2), dev)
    lo = np.ascontiguousarray(lo_thr, np.float32)
    hi = np.ascontiguousarray(hi_thr, np.float32)
    if lo.shape != (n_axis,) or hi.shape != (n_axis,):
        raise ValueError(f"thresholds: expected [{n_axis}] each")
    build.launch("halo_exchange", _host_ptrs(ins), _host_ptrs(outs),
                 (ctypes.c_int * len(ins))(*[row_bytes(t) for t in ins]), len(ins),
                 ins[0], ins[ALIVE_F], ALIVE_F, AWAKE_F,
                 lo.ctypes.data_as(ctypes.c_void_p), hi.ctypes.data_as(ctypes.c_void_p),
                 n_shards, rows_in, halo, axis, stride, n_axis, overflow)
    launches += 1
    return BodyState(**dict(zip(BODY_FIELDS, outs))), overflow


def bytes_moved(src: BodyState, n_shards: int, halo: int) -> int:
    """Bytes one phase must move: every input row read once, every output
    row written once."""
    row = sum(row_bytes(getattr(src, f)) for f in BODY_FIELDS)
    return (2 * src.capacity + 2 * n_shards * halo) * row

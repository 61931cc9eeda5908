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
import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.physics.state import BODY_FIELDS, BodyState, zero_body_state

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
    """``t`` contiguous and 4-byte aligned (KAE copies rows that are whole
    32-bit words as words)."""
    if not t.is_contiguous() or t.data_ptr() % 4:
        return t.clone(memory_format=torch.contiguous_format)
    return t


# csrc/halo.cu:halo_exchange's packed argument: the output buffer and the
# overflow counts, then a plan's record, then the source pointers.
_HEAD = struct.Struct("=2q")
MAX_FIELDS = 24            # csrc/halo.cu:kMaxFields
MAX_ROWS_IN = 393_216      # csrc/halo.cu:kMaxWords words of 32 rows
_CHUNK = 256               # csrc/halo.cu:kMaxChunk: ghost places a block
_THREADS = 512             # a block's threads
_GROUPS = (torch.float32, torch.int32, torch.bool)
_plans = {}
_specs = []


def _field_specs():
    """(dtype, trailing shape) of each BodyState field, BODY_FIELDS order."""
    if not _specs:
        z = zero_body_state(1, device="cpu")
        _specs.extend((getattr(z, f).dtype, tuple(getattr(z, f).shape[1:]))
                      for f in BODY_FIELDS)
    return _specs


def _sm_count(device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return 132


class _Plan:
    """KAD's record for one (S, rows_in, H, axis, stride, n_axis,
    thresholds, device): the fields' dtypes and shapes, the output buffer's
    layout (the float32 fields, then the int32 and the bool ones, each at
    a 16-byte offset, then room for the overflow counts), the ghost blocks
    a shard P (each takes both directions; S P blocks cover half the
    card's SMs), the own-row copy's blocks (one an SM at most), a table in device
    memory of what the kernel reads a field (uploaded once), and the
    launch's record packed once."""

    def __init__(self, s, rows_in, halo, axis, stride, n_axis, lo, hi, device):
        specs = _field_specs()
        if rows_in > MAX_ROWS_IN or len(specs) > MAX_FIELDS or not 0 <= axis < 3:
            raise ValueError(f"halo exchange: rows_in {rows_in} (at most {MAX_ROWS_IN}), "
                             f"{len(specs)} fields (at most {MAX_FIELDS}), axis {axis}")
        n_in, n_out = s * rows_in, s * (rows_in + 2 * halo)
        self.device = device
        self.dtypes = tuple(d for d, _ in specs)
        self.shapes = tuple((n_in,) + tr for _, tr in specs)
        offsets, off, self.groups = [0] * len(specs), 0, []
        for dt in _GROUPS:
            esz = dt.itemsize
            start, sizes, items = off, [], []
            for k, (d, tr) in enumerate(specs):
                if d is dt:
                    n = n_out * math.prod(tr)
                    offsets[k] = off
                    items.append((k, len(sizes), (n_out,) + tr))
                    sizes.append(n)
                    off += n * esz
                    if off % 16:
                        sizes.append((16 - off % 16) // esz)
                        off += 16 - off % 16
            self.groups.append((start, off, dt, sizes, items))
        if sum(len(g[4]) for g in self.groups) != len(specs):
            raise TypeError("halo exchange: a BodyState field outside float32, int32, bool")
        self.overflow_at, self.nbytes = off, off + 8 * s
        sms = _sm_count(device)
        parts = max(-(-halo // _CHUNK), min(-(-sms // (2 * s)), max(1, halo // 32)), 1)
        bytes_ = [d.itemsize * math.prod(tr) for d, tr in specs]
        copy_blocks = max(1, min(sms, -(-n_in * sum(bytes_) // (16 * _THREADS))))
        # What the kernel reads from device memory: each field's output
        # offset and bytes a row, then each axis position's thresholds as
        # one word (the low one's float32 bits, the high one's << 32); and
        # the ghost blocks' item map: both directions' C = ceil(H / P)
        # places, field-major, a unit a 32-bit word where a row is whole
        # words (a float32 or int32 field is 4-byte aligned), else a byte,
        # packed as place | unit << 8 | field << 12 | direction << 17 |
        # byte << 18.
        thr = (np.asarray(lo, np.float32).view(np.uint32).astype(np.uint64)
               | (np.asarray(hi, np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)))
        self.table_host = np.concatenate([np.asarray(offsets + bytes_, np.int64),
                                          thr.view(np.int64)])
        self.table = torch.as_tensor(self.table_host, device=device)
        chunk = -(-halo // parts)
        items = []
        for e in (0, 1):
            for k, b in enumerate(bytes_):
                byte = b % 4 != 0
                units = b if byte else b // 4
                if units > 16:
                    raise ValueError(f"halo exchange: {BODY_FIELDS[k]} has {units} units a row "
                                     "(at most 16)")
                pl, w = np.divmod(np.arange(chunk * units), units)
                items.append(pl | w << 8 | k << 12 | e << 17 | int(byte) << 18)
        self.map_host = np.concatenate(items).astype(np.int32)
        self.map = torch.as_tensor(self.map_host, device=device)
        nf = len(specs)
        self.record = struct.pack("=15q", self.table.data_ptr(), nf, BODY_FIELDS.index("pos"),
                                  ALIVE_F, AWAKE_F, s, rows_in, halo, axis, stride, n_axis, parts,
                                  copy_blocks, self.map.data_ptr(), self.map_host.size)
        self.srcs = struct.Struct(f"={nf}q")
        self.parts, self.copy_blocks = parts, copy_blocks

    def outputs(self, buf):
        """The 23 output fields as views of ``buf``, and its overflow counts."""
        outs = [None] * len(self.dtypes)
        for start, end, dt, sizes, items in self.groups:
            parts = torch.split(buf[start:end].view(dt), sizes)
            for k, j, shape in items:
                outs[k] = parts[j] if len(shape) == 1 else parts[j].view(shape)
        ov = buf[self.overflow_at:].view(torch.int32).view(-1, 2)
        return outs, ov


def exchange(src: BodyState, n_shards: int, halo: int, axis: int, stride: int, n_axis: int,
             lo_thr, hi_thr, overflow: torch.Tensor | None = None):
    """KAD: one exchange phase over all shards, one launch.  ``src`` holds
    S contiguous blocks of rows_in rows; returns (combined [S * (rows_in +
    2H)], overflow int32 [S, 2]), the counts written into ``overflow`` when
    the caller passes one.  On the card the combined fields are views of
    one allocation, checked against and launched from a plan of their
    shape (only the pointers are packed a call)."""
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
    lo = np.ascontiguousarray(lo_thr, np.float32)
    hi = np.ascontiguousarray(hi_thr, np.float32)
    if lo.shape != (n_axis,) or hi.shape != (n_axis,):
        raise ValueError(f"thresholds: expected [{n_axis}] each")
    key = (n_shards, rows_in, halo, axis, stride, n_axis, lo.tobytes(), hi.tobytes(), dev)
    plan = build.plan(_plans, key, lambda: _Plan(n_shards, rows_in, halo, axis, stride,
                                                 n_axis, lo, hi, dev))
    ins = [getattr(src, f) for f in BODY_FIELDS]
    try:
        build.check_all(plan.device, ins, BODY_FIELDS, plan.dtypes, plan.shapes)
    except (TypeError, ValueError):
        ins = [t.contiguous() for t in ins]
        build.check_all(plan.device, ins, BODY_FIELDS, plan.dtypes, plan.shapes)
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    outs, ov = plan.outputs(buf)
    if overflow is None:
        overflow = ov
    else:
        build.check(overflow, "overflow", torch.int32, (n_shards, 2), dev)
    build.launch_packed("halo_exchange", _HEAD.pack(buf.data_ptr(), overflow.data_ptr())
                        + plan.record + plan.srcs.pack(*(t.data_ptr() for t in ins)))
    launches += 1
    return BodyState(**dict(zip(BODY_FIELDS, outs))), overflow


def bytes_moved(src: BodyState, n_shards: int, halo: int) -> int:
    """Bytes one phase must move: every input row read once, every output
    row written once."""
    row = sum(row_bytes(getattr(src, f)) for f in BODY_FIELDS)
    return (2 * src.capacity + 2 * n_shards * halo) * row

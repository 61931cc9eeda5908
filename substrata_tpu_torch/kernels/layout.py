"""The compacted contact layout's chain (kernel KT): combo grouping,
the touching scatter, contact compaction and the incidence table.

Replaces the plain stages of K3 and K5:
``substrata_tpu/physics/narrowphase.py:pair_contacts`` :666-720 (one stable
argsort of the pair list by combo code, each present code's bucket a slice
of the sorted order) and :792-796 (the per-pair touching scatter),
``narrowphase.py:compact_contacts`` :1054 (touching rows first, then the
speculative ones) and ``solver.py:build_incidence`` :96 (each body's
entries in ascending (entry, side) order, the first ``cpb`` kept).

Each wrapper runs its ``*_plain`` twin for CPU tensors and the launches of
``csrc/layout.cu`` for CUDA ones.  Contacts travel as the tuple of
``narrowphase.CONTACT_FIELDS`` (a, b, point, normal, penetration, valid,
friction, restitution, key).
"""

from __future__ import annotations

import ctypes

import torch

from substrata_tpu_torch.kernels import build

launches = {"layout_group": 0, "layout_touching": 0, "layout_compact": 0,
            "layout_incidence": 0}

NUM_CODES = 16
SAME_TYPE_CODES = (0, 5, 10, 15)
MIXED_FRACTION = 4
INC_LIST = 64          # csrc/layout.cu:kIncList


def bucket_cap(code: int, max_pairs: int, p: int) -> int:
    """A code's bucket size: ``max_pairs`` slots for the same-type codes,
    ``max(64, max_pairs // 4)`` for the others, at most the pair list."""
    cap = (max_pairs if code in SAME_TYPE_CODES
           else max(64, max_pairs // MIXED_FRACTION))
    return min(cap, p)


def _slices(active, max_pairs: int, p: int):
    """(code, cap, offset) of each active code's bucket in the
    concatenated slot space, in code order."""
    out, off = [], 0
    for code in active:
        cap = bucket_cap(code, max_pairs, p)
        out.append((code, cap, off))
        off += cap
    return out, off


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------

def group_plain(shape_type, pair_a, pair_b, pair_valid, active, max_pairs: int):
    """Twin of the grouping.  Returns ([(code, src, ba, bb, bvalid)] per
    active code, overflow [] i32, None)."""
    p = pair_a.shape[0]
    dev = pair_a.device
    a = torch.clamp(pair_a, min=0)
    b = torch.clamp(pair_b, min=0)
    codes = torch.clamp(shape_type[a.long()] * 4 + shape_type[b.long()], 0, NUM_CODES - 1)
    sort_codes = torch.where(pair_valid, codes, NUM_CODES)
    order = torch.argsort(sort_codes, stable=True)
    sorted_codes = sort_codes[order]
    # starts[c] = number of codes below c (the run boundaries).
    starts = torch.searchsorted(sorted_codes, torch.arange(
        NUM_CODES + 1, dtype=sorted_codes.dtype, device=dev))
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for code in range(NUM_CODES):
        if code not in active:
            overflow = overflow + (starts[code + 1] - starts[code])
            continue
        cap = bucket_cap(code, max_pairs, p)
        start = torch.minimum(starts[code], torch.full_like(starts[code], p - cap))
        idx = start + torch.arange(cap, device=dev)
        # Mask slots outside this code's run (the slice may span neighbours).
        src = torch.where(sorted_codes[idx] == code, order[idx], -1)
        overflow = overflow + torch.clamp(starts[code + 1] - starts[code] - cap, min=0)
        srcs = torch.clamp(src, min=0)
        out.append((code, src, a[srcs], b[srcs], src >= 0))
    return out, overflow.to(torch.int32), None


def group(shape_type, pair_a, pair_b, pair_valid, active, max_pairs: int):
    """KT's grouping: the pair list by combo code, as one stable sort.

    Returns ([(code, src, ba, bb, bvalid)] for each code of ``active``
    (ascending), overflow [] i32, slot_of_pair): ``src`` is each bucket
    slot's pair index (-1 empty), ``ba``/``bb`` its bodies (0 on empty
    slots), ``bvalid`` its occupancy; ``slot_of_pair`` [P] i32 is each
    pair's slot in the concatenated buckets (-1 none; None from the twin).
    """
    if pair_a.device.type == "cpu":
        return group_plain(shape_type, pair_a, pair_b, pair_valid, active, max_pairs)
    global launches
    dev = pair_a.device
    p = pair_a.shape[0]
    n = shape_type.shape[0]
    for t, name, dt, shp in ((pair_a, "pair_a", torch.int32, (p,)),
                             (pair_b, "pair_b", torch.int32, (p,)),
                             (pair_valid, "pair_valid", torch.bool, (p,)),
                             (shape_type, "shape_type", torch.int32, (n,))):
        build.check(t, name, dt, shp, dev)
    slices, total = _slices(active, max_pairs, p)
    i32 = dict(dtype=torch.int32, device=dev)
    ints = torch.empty((2 * p + 3 * total + 1,), **i32)
    order, slot_of_pair = ints[:p], ints[p:2 * p]
    src, ba, bb = (ints[2 * p + k * total:2 * p + (k + 1) * total] for k in range(3))
    overflow = ints[2 * p + 3 * total:]
    bvalid = torch.empty((total,), dtype=torch.bool, device=dev)
    mask = sum(1 << code for code in active)
    build.launch("layout_group", pair_a, pair_b, pair_valid, shape_type, p, max_pairs, mask,
                 order, src, ba, bb, bvalid, slot_of_pair, overflow)
    launches["layout_group"] += 1
    out = [(code, src[off:off + cap], ba[off:off + cap], bb[off:off + cap],
            bvalid[off:off + cap]) for code, cap, off in slices]
    return out, overflow.reshape(()), slot_of_pair


def touching_plain(srcs, touches, p: int):
    """Twin of the touching scatter: each bucket slot's flag to its pair."""
    dev = touches[0].device
    touching = torch.zeros((p + 1,), dtype=torch.bool, device=dev)
    for src, btouch in zip(srcs, touches):
        dst = torch.where(src >= 0, src, p)
        touching.index_put_((dst,), btouch | touching[dst])
    return touching[:p]


def touching(srcs, touches, p: int, slot_of_pair=None):
    """KT's touching: per-pair flags [P] bool from each bucket's per-slot
    flags (``touches``, in ``group``'s bucket order); one gather launch
    through ``slot_of_pair`` on the card."""
    if touches[0].device.type == "cpu":
        return touching_plain(srcs, touches, p)
    global launches
    dev = touches[0].device
    if len(touches) > NUM_CODES:
        raise ValueError(f"{len(touches)} buckets: at most {NUM_CODES}")
    build.check(slot_of_pair, "slot_of_pair", torch.int32, (p,), dev)
    offs = [0]
    for src, t in zip(srcs, touches):
        build.check(t, "touch", torch.bool, tuple(src.shape), dev)
        offs.append(offs[-1] + t.shape[0])
    rows = (ctypes.c_void_p * len(touches))(*[t.data_ptr() for t in touches])
    off_arr = (ctypes.c_int * len(offs))(*offs)
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    build.launch("layout_touching", slot_of_pair, rows, off_arr, len(touches), p, out)
    launches["layout_touching"] += 1
    return out


# ---------------------------------------------------------------------------
# Compaction
# ---------------------------------------------------------------------------

def compact_plain(rows, max_active: int):
    """Twin of the compaction.  ``rows`` is the CONTACT_FIELDS tuple;
    returns (compacted tuple of ``max_active`` rows, overflow [] i32)."""
    a, b, point, normal, pen, valid, fric, rest, key = rows
    dev = a.device
    touching = valid & (pen > 0.0)
    spec = valid & ~touching
    n_touch = touching.sum()
    idx_t = torch.cumsum(touching.long(), 0) - 1
    idx_s = n_touch + torch.cumsum(spec.long(), 0) - 1
    out_idx = torch.where(touching, idx_t, idx_s)
    keep = valid & (out_idx < max_active)
    dst = torch.where(keep, out_idx, max_active)

    def put(x, fill):
        buf = torch.full((max_active + 1,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=dev)
        buf.index_put_((dst,), x)
        return buf[:max_active]

    ia = put(a, -1)
    cvalid = ia >= 0
    return (torch.where(cvalid, ia, 0), torch.where(cvalid, put(b, -1), -1),
            put(point, 0.0), put(normal, 0.0), put(pen, 0.0), cvalid, put(fric, 0.0),
            put(rest, 0.0), torch.where(cvalid, put(key, -1), 0)), \
        torch.clamp(n_touch - max_active, min=0).to(torch.int32)


def compact(rows, max_active: int):
    """KT's compaction: valid contacts into ``max_active`` rows, touching
    (penetration > 0) first, then speculative, each in row order; empty
    rows a = 0, b = -1, key = 0, zeros.  Returns (tuple, overflow [] i32:
    the touching rows that found no room)."""
    if rows[0].device.type == "cpu":
        return compact_plain(rows, max_active)
    global launches
    a = rows[0]
    dev = a.device
    c = a.shape[0]
    shapes = [(c,), (c,), (c, 3), (c, 3), (c,), (c,), (c,), (c,), (c,)]
    dtypes = [torch.int32, torch.int32, torch.float32, torch.float32, torch.float32,
              torch.bool, torch.float32, torch.float32, torch.int32]
    names = ("a", "b", "point", "normal", "penetration", "valid", "friction", "restitution",
             "key")
    for t, name, dt, shp in zip(rows, names, dtypes, shapes):
        build.check(t, name, dt, shp, dev)
    m = max_active
    n_tiles = max((c + 1023) // 1024, 1)
    # The tile counts lead the buffer: the kernel reads them as int2.
    ints = torch.empty((2 * n_tiles + 3 * m + 1,), dtype=torch.int32, device=dev)
    tile_cnt, rest = ints[:2 * n_tiles], ints[2 * n_tiles:]
    o_a, o_b, o_key = rest[:m], rest[m:2 * m], rest[2 * m:3 * m]
    overflow = rest[3 * m:]
    floats = torch.empty((9 * m,), dtype=torch.float32, device=dev)
    o_point = floats[:3 * m].view(m, 3)
    o_normal = floats[3 * m:6 * m].view(m, 3)
    o_pen, o_fric, o_rest = floats[6 * m:7 * m], floats[7 * m:8 * m], floats[8 * m:]
    o_valid = torch.empty((m,), dtype=torch.bool, device=dev)
    build.launch("layout_compact", *rows, c, m, tile_cnt, o_a, o_b, o_point, o_normal, o_pen,
                 o_valid, o_fric, o_rest, o_key, overflow)
    launches["layout_compact"] += 1
    return (o_a, o_b, o_point, o_normal, o_pen, o_valid, o_fric, o_rest, o_key), \
        overflow.reshape(())


# ---------------------------------------------------------------------------
# Incidence
# ---------------------------------------------------------------------------

def _check_key_bits(n_bodies: int, c: int):
    if n_bodies.bit_length() + max(c.bit_length(), 1) + 1 > 32:
        raise ValueError("capacity*entries too large for the packed 32-bit key")


def incidence_plain(entry_a, entry_b, entry_occ, n_bodies: int, cpb: int):
    """Twin of the incidence table (one sort of packed keys)."""
    c = entry_a.shape[0]
    dev = entry_a.device
    cbits = max(c.bit_length(), 1)
    _check_key_bits(n_bodies, c)
    static_b = entry_b < 0
    cidx = torch.arange(c, dtype=torch.int64, device=dev)
    body_a = torch.where(entry_occ, entry_a.long(), n_bodies)
    body_b = torch.where(entry_occ & ~static_b, entry_b.long(), n_bodies)
    key = torch.cat([(body_a << (cbits + 1)) | (cidx << 1) | 1,
                     (body_b << (cbits + 1)) | (cidx << 1)])
    skey = torch.sort(key).values
    sb = skey >> (cbits + 1)
    idx = torch.arange(2 * c, device=dev)
    start = torch.ones(2 * c, dtype=torch.bool, device=dev)
    start[1:] = sb[1:] != sb[:-1]
    rank = idx - torch.cummax(torch.where(start, idx, 0), dim=0).values
    in_cap = (rank < cpb) & (sb < n_bodies)
    slot = torch.where(in_cap, sb * cpb + rank, n_bodies * cpb)
    entry = skey & ((1 << (cbits + 1)) - 1)
    packed = torch.full((n_bodies * cpb + 1,), -1, dtype=torch.int64, device=dev)
    packed.index_put_((slot,), torch.where(in_cap, entry, -1))
    packed = packed[:-1].reshape(n_bodies, cpb)
    table = torch.where(packed >= 0, packed >> 1, -1).to(torch.int32)
    sign = torch.where(packed >= 0, torch.where((packed & 1) > 0, 1.0, -1.0), 0.0)
    counts = (table >= 0).sum(dim=1).to(torch.float32)
    return table, sign, counts


def incidence(entry_a, entry_b, entry_occ, n_bodies: int, cpb: int):
    """KT's incidence table.  Returns (table [N, CPB] i32 (-1 empty), sign
    [N, CPB] f32 (+1 body is entry a, -1 entry b), counts [N] f32): each
    body's entries in ascending (entry, side) order, the first ``cpb``
    kept."""
    if entry_a.device.type == "cpu":
        return incidence_plain(entry_a, entry_b, entry_occ, n_bodies, cpb)
    global launches
    dev = entry_a.device
    c = entry_a.shape[0]
    _check_key_bits(n_bodies, c)
    # entry_a and entry_b may be strided views (an entry's first row of wm).
    st = entry_a.stride(0)
    for t, name in ((entry_a, "entry_a"), (entry_b, "entry_b")):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != c \
                or t.stride(0) != st:
            raise ValueError(f"{name}: expected int32 [{c}] at stride {st} on {dev}")
    build.check(entry_occ, "entry_occ", torch.bool, (c,), dev)
    n = n_bodies
    ints = torch.empty((n * cpb + n * (1 + INC_LIST),), dtype=torch.int32, device=dev)
    table = ints[:n * cpb].view(n, cpb)
    scratch = ints[n * cpb:]
    floats = torch.empty((n * cpb + n,), dtype=torch.float32, device=dev)
    sign, counts = floats[:n * cpb].view(n, cpb), floats[n * cpb:]
    build.launch("layout_incidence", entry_a, entry_b, st, entry_occ, c, n, cpb, scratch, table,
                 sign, counts)
    launches["layout_incidence"] += 1
    return table, sign, counts

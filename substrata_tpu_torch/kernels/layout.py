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
import functools
import struct

import torch

from substrata_tpu_torch.kernels import build

launches = {"layout_group": 0, "layout_touching": 0, "layout_compact": 0,
            "layout_incidence": 0}

NUM_CODES = 16
SAME_TYPE_CODES = (0, 5, 10, 15)
MIXED_FRACTION = 4
INC_LIST = 64          # csrc/layout.cu:kIncList
SMALLEST_NORMAL = float(torch.finfo(torch.float32).tiny)   # csrc/layout.cu:kSmallestNormal
_INC_PACK = struct.Struct("=11q")    # csrc/layout.cu:layout_incidence
_inc_plans = {}


def bucket_cap(code: int, max_pairs: int, p: int) -> int:
    """A code's bucket size: ``max_pairs`` slots for the same-type codes,
    ``max(64, max_pairs // 4)`` for the others, at most the pair list."""
    cap = (max_pairs if code in SAME_TYPE_CODES
           else max(64, max_pairs // MIXED_FRACTION))
    return min(cap, p)


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


GROUP_TILE = 512      # csrc/layout.cu:kGroupTile


@functools.lru_cache(maxsize=64)
def _group_layout(active: tuple, max_pairs: int, p: int):
    """One grouping call's fixed parts: the code mask, the slot count, and
    the split sizes of its buffer, one bool allocation read as int32 words
    for src, ba and bb (each in ``active``'s buckets), slot_of_pair, the
    overflow and the scratch (packed [P], tile counts [tiles, 17]), then
    as bytes for bvalid."""
    caps = [bucket_cap(code, max_pairs, p) for code in active]
    total = sum(caps)
    tiles = max(-(-p // GROUP_TILE), 1)
    words = 3 * total + p + 1 + p + (NUM_CODES + 1) * tiles
    tail = -total % 4
    return (sum(1 << code for code in active), total, 4 * words + total + tail,
            caps * 3 + [words - 3 * total + (total + tail) // 4], [4 * words] + caps + [tail])


def group(shape_type, pair_a, pair_b, pair_valid, active, max_pairs: int):
    """KT's grouping: the pair list by combo code, as one stable sort.

    Returns ([(code, src, ba, bb, bvalid)] for each code of ``active``
    (ascending), overflow [] i32, slot_of_pair): ``src`` is each bucket
    slot's pair index (-1 empty), ``ba``/``bb`` its bodies (those of pair 0
    on empty slots), ``bvalid`` its occupancy; ``slot_of_pair`` [P] i32 is
    each pair's slot in the concatenated buckets (-1 none; None from the
    twin).  On the card every output is a view of one buffer.
    """
    global launches
    if pair_a.device.type == "cpu":
        return group_plain(shape_type, pair_a, pair_b, pair_valid, active, max_pairs)
    dev = pair_a.device
    p = pair_a.shape[0]
    check = build.check
    check(pair_a, "pair_a", torch.int32, (p,), dev)
    check(pair_b, "pair_b", torch.int32, (p,), dev)
    check(pair_valid, "pair_valid", torch.bool, (p,), dev)
    check(shape_type, "shape_type", torch.int32, (shape_type.shape[0],), dev)
    active = tuple(active)
    mask, total, nbytes, word_split, byte_split = _group_layout(active, max_pairs, p)
    buf = torch.empty((nbytes,), dtype=torch.bool, device=dev)
    ints = buf.view(torch.int32)
    ptr = buf.data_ptr()
    o_slot = ptr + 12 * total
    rc = build.kernel("layout_group")(
        pair_a.data_ptr(), pair_b.data_ptr(), pair_valid.data_ptr(), shape_type.data_ptr(), p,
        max_pairs, mask, o_slot + 4 * p + 4, ptr, ptr + 4 * total, ptr + 8 * total,
        ptr + byte_split[0], o_slot, o_slot + 4 * p, build.stream())
    build.raise_if(rc, "layout_group")
    launches["layout_group"] += 1
    # The port records no gradients, so the slices need none of split's
    # autograd view tracking (a third of a view's host cost).
    k = len(active)
    words = ints.unsafe_split_with_sizes(word_split)
    out = list(zip(active, words[:k], words[k:2 * k], words[2 * k:3 * k],
                   buf.unsafe_split_with_sizes(byte_split)[1:k + 1]))
    return (out, ints.as_strided((), (), 3 * total + p),
            ints.as_strided((p,), (1,), 3 * total))


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
    # The jitted reference's ``pen > 0`` reads a denormal as 0 (XLA's CPU
    # compares with denormals-are-zero, as the TPU does): touching means
    # at least the smallest normal float.
    touching = valid & (pen >= SMALLEST_NORMAL)
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


# csrc/layout.cu:layout_compact: the 9 contact fields, the plan's block
# scratch, the output buffer, C, max_active.
_COMPACT_PACK = struct.Struct("=13q")
COMPACT_WARPS = 8           # csrc/layout.cu:kCompactWarps
_COMPACT_NAMES = ("a", "b", "point", "normal", "penetration", "valid", "friction",
                  "restitution", "key")
_COMPACT_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.float32,
                   torch.bool, torch.float32, torch.float32, torch.int32)
_compact_plans = {}


class _CompactPlan:
    """The compaction's checks and scratch for one (C, max_active, device,
    stream): the fields' shapes, one 64-bit count a block (each launch
    writes its blocks' before the grid barrier reads them, so nothing is
    reset; keyed by stream, so two streams never share it; one word for
    each block the rows could need at a group of 32 a warp, of which the
    kernel launches at most csrc/layout.cu:kCompactMaxBlocks) and the
    split of the output buffer: a, b, key and the overflow as int32, point, normal,
    penetration, friction and restitution as float32, then valid as
    bytes."""

    def __init__(self, c, m, device):
        self.device = device
        self.shapes = ((c,), (c,), (c, 3), (c, 3), (c,), (c,), (c,), (c,), (c,))
        groups = -(-c // 32)
        self.blocks = torch.empty((max(-(-groups // COMPACT_WARPS), 1),), dtype=torch.int64,
                                  device=device)
        tail = (m + 3) // 4
        self.words = 12 * m + 1 + tail
        self.split = [m, m, m, 1, 9 * m, tail]
        self.floats = [3 * m, 3 * m, m, m, m]


def compact(rows, max_active: int):
    """KT's compaction: valid contacts into ``max_active`` rows, touching
    (penetration > 0) first, then speculative, each in row order; empty
    rows a = 0, b = -1, key = 0, zeros.  Returns (tuple, overflow [] i32:
    the touching rows that found no room).  On the card one cooperative
    launch from one packed argument, checked against a plan of its shape;
    the outputs are views of one fresh allocation."""
    if rows[0].device.type == "cpu":
        return compact_plain(rows, max_active)
    global launches
    dev = rows[0].device
    c, m = rows[0].shape[0], max_active
    plan = build.plan(_compact_plans, (c, m, dev, build.stream()),
                      lambda: _CompactPlan(c, m, dev))
    build.check_all(plan.device, rows, _COMPACT_NAMES, _COMPACT_DTYPES, plan.shapes)
    buf = torch.empty((plan.words,), dtype=torch.int32, device=dev)
    build.launch_packed("layout_compact", _COMPACT_PACK.pack(
        *(t.data_ptr() for t in rows), plan.blocks.data_ptr(), buf.data_ptr(), c, m))
    launches["layout_compact"] += 1
    o_a, o_b, o_key, overflow, floats, flags = buf.unsafe_split_with_sizes(plan.split)
    point, normal, pen, fric, rest = floats.view(torch.float32).unsafe_split_with_sizes(
        plan.floats)
    return (o_a, o_b, point.view(m, 3), normal.view(m, 3), pen, flags.view(torch.bool)[:m],
            fric, rest, o_key), overflow.view(())


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
    kept.  On the card: two launches from one packed argument, the
    outputs one allocation of their own."""
    if entry_a.device.type == "cpu":
        return incidence_plain(entry_a, entry_b, entry_occ, n_bodies, cpb)
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
    # The plan is the scratch of one (N, C, CPB, device, stream): N per-body
    # counters, zeroed here and set back to 0 by every select pass, then N *
    # 64 list slots.  Keyed by stream, so two streams never share counters.
    key = (n, c, cpb, dev, build.stream())
    scratch = build.plan(_inc_plans, key, lambda: torch.zeros(
        n * (1 + INC_LIST), dtype=torch.int32, device=dev))
    out = torch.empty((2 * n * cpb + n,), dtype=torch.int32, device=dev)
    table = out[:n * cpb].view(n, cpb)
    floats = out[n * cpb:].view(torch.float32)
    sign, counts = floats[:n * cpb].view(n, cpb), floats[n * cpb:]
    try:
        build.launch_packed("layout_incidence", _INC_PACK.pack(
            entry_a.data_ptr(), entry_b.data_ptr(), entry_occ.data_ptr(), scratch.data_ptr(),
            table.data_ptr(), sign.data_ptr(), counts.data_ptr(), st, c, n, cpb))
    except RuntimeError:
        # A launch that failed after the append pass leaves counters set:
        # the next call gets a zeroed plan.
        _inc_plans.pop(key, None)
        raise
    launches["layout_incidence"] += 1
    return table, sign, counts

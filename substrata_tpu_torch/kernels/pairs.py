"""The broadphase pair finder (kernel KS).

Replaces K2, ``substrata_tpu/physics/broadphase.py:find_pairs`` (:115) and
the margins of ``_pairs_rebuild`` (:364): gather each body's candidates
from the 14-bucket half stencil of KP's flagged cell table
(``kernels/cell_table.py``), keep its ``pairs_per_body`` closest, compact
the slot-major rows (and the oversize bodies' rows) into ``max_pairs``
packed keys and sort-dedup them.

Integer semantics follow the reference exactly: the cell hash multiplies
in int32 with wraparound and reduces modulo the bucket count as uint32,
packed keys are uint32 (int64 in the twin), sorts are stable, and the
per-row top-K takes the lower column on ties, as ``lax.top_k`` does.  The
rebuild's margins repeat the reference's jitted arithmetic to the bit: the
speed is XLA's norm (an fma chain and a correctly rounded square root) and
``0.08 + speed * window * dt`` contracts into one fma.  Nothing here reads
a value back to the host.

``find_pairs`` runs ``find_pairs_plain`` for CPU tensors and, for CUDA
ones, KP's cell table and the six launches of ``csrc/pairs.cu`` from one
packed argument buffer: a world shape's plan (``_Plan``) is checked and
sized once, and a call's outputs and scratch are one new allocation.
"""

from __future__ import annotations

import struct

import torch

from substrata_tpu_torch.kernels import build, cell_table
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.physics.state import MotionType, ShapeType

launches = 0

MAX_OVERSIZE = 64
MAX_PPB = 16            # csrc/pairs.cu:kMaxPpb
_TBL_IDX_MASK = 0xFFFF
PAIR_EMPTY = 0xFFFFFFFF
MAX_CAP = 18            # csrc/pairs.cu: 14 * cap <= kListCap
_CTRL_SLOTS = 8         # csrc/pairs.cu:kCtrlSlots


def _half_offsets(device):
    """Own cell + the 13 lexicographically positive (dz, dy, dx) neighbours,
    in the reference's order: cell codes o = 9(dz+1) + 3(dy+1) + (dx+1)
    from 13 (the own cell) to 26.  Built on the device, no upload."""
    o = torch.arange(13, 27, device=device, dtype=torch.int32)
    return torch.stack([o % 3 - 1, (o // 3) % 3 - 1, o // 9 - 1], dim=1)


def _cell_table(body, config):
    return cell_table.cell_table(
        body.pos, body.alive, body.collidable, body.awake, body.motion_type,
        body.bound_radius, num_buckets=config.grid_dim * config.grid_dim,
        cap=config.cell_capacity, rcp_cell=fp.recip(config.cell_size),
        cell_size=config.cell_size, with_flags=True)


def _dist2(d):
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _compact(mask, size: int, fill: int = -1):
    """Indices of the first ``size`` true entries of a 1-D mask, padded
    with ``fill`` — ``jnp.nonzero(mask, size=, fill_value=)`` without a
    host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.long(), 0) - 1
    dst = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.index_put_((dst,), torch.arange(n, device=mask.device))
    return out[:size]


def rebuild_margins_plain(body, dt, config):
    """The rebuild's per-body margins [N] and reuse window [] i32
    (broadphase.py:_pairs_rebuild :364-382)."""
    interval = config.pair_rebuild_interval
    speed = fp.sqrt(fp.dot3(body.linvel, body.linvel))
    speed = torch.where(body.alive & body.awake, speed, 0.0)
    vmax = speed.max()
    margin_cap = 0.6 * config.cell_size
    step = torch.clamp(vmax * dt, min=1e-6)
    # A true division, as the reference's (torch's scalar / tensor would
    # multiply by the reciprocal).  A NaN speed leaves a NaN window, which
    # XLA and the card convert to 0 (the CPU's own conversion gives INT_MIN).
    window = torch.nan_to_num(
        torch.clamp(torch.floor(torch.full_like(step, margin_cap) / step), 1, interval),
        nan=0.0).to(torch.int32)
    margin = fp.fma(speed * window.to(torch.float32), dt, 0.08)
    return margin, window


def find_pairs_plain(body, config, margin=0.08, has_oversize: bool = True):
    """The twin.  Returns (pair_a [P] i32, pair_b [P] i32, pair_valid [P]
    bool, num_pairs [] i32, overflow [] i32)."""
    n = body.capacity
    dev = body.device
    cap = config.cell_capacity
    num_buckets = config.grid_dim * config.grid_dim
    table, cells, overflow = _cell_table(body, config)

    collidable = body.alive & body.collidable
    moving = body.awake & (body.motion_type != int(MotionType.STATIC))
    is_static = body.motion_type == int(MotionType.STATIC)
    small = 2.0 * body.bound_radius <= config.cell_size
    if not isinstance(margin, torch.Tensor):
        margin = torch.full((n,), float(margin), device=dev)
    infl_radius = body.bound_radius + 0.5 * margin.expand(n)
    sp = body.shape_params
    inner_radius = torch.where(
        body.shape_type == int(ShapeType.BOX), sp[:, :3].min(dim=1).values,
        torch.where(body.shape_type == int(ShapeType.HULL),
                    0.5 * body.bound_radius, sp[:, 0]))

    # --- Regular pass: half-stencil neighbourhood search.
    hb = cell_table.hash_cells(cells[:, None, :] + _half_offsets(dev)[None, :, :],
                               num_buckets)                            # [N, 14]
    noff = hb.shape[1]
    cand = table[hb.reshape(-1)].reshape(n, noff * cap)
    k = cand.shape[1]
    jj = torch.where(cand >= 0, cand & _TBL_IDX_MASK, -1).long()
    j_moving = (cand & cell_table.TBL_MOVING) > 0
    j_static = (cand & cell_table.TBL_STATIC) > 0
    j_small = (cand & cell_table.TBL_SMALL) > 0
    ii = torch.arange(n, device=dev)[:, None]
    jj_safe = torch.clamp(jj, min=0)
    own_col = torch.arange(k, device=dev) < cap
    mask = torch.where(own_col[None, :], jj > ii, (jj >= 0) & (jj != ii))
    mask &= collidable[:, None]
    mask &= moving[:, None] | j_moving
    mask &= ~(is_static[:, None] & j_static)
    mask &= small[:, None] & j_small
    d2 = _dist2(body.pos[:, None, :] - body.pos[jj_safe])
    r = infl_radius[:, None] + infl_radius[jj_safe]
    mask &= d2 <= r * r
    r_tight = inner_radius[:, None] + inner_radius[jj_safe]
    tight = mask & (d2 <= r_tight * r_tight)

    # Per-row top-K by proximity; the stable descending sort keeps the lower
    # column first on ties, as lax.top_k does.
    ppb = config.pairs_per_body
    score = torch.where(mask, r * r - d2, -1e9)
    sel = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :ppb]
    sel_mask = torch.gather(mask, 1, sel)
    sel_j = torch.gather(jj_safe, 1, sel)
    sel_tight = torch.gather(tight, 1, sel)
    # Hash collisions can bring one neighbour in twice: dedup the selection.
    for j in range(1, ppb):
        dup = torch.any((sel_j[:, :j] == sel_j[:, j:j + 1]) & sel_mask[:, :j], dim=1)
        sel_mask[:, j] &= ~dup
    row_overflow = torch.clamp(tight.sum(dim=1) - (sel_mask & sel_tight).sum(dim=1), min=0)

    # Slot-major emission of (min, max) pairs.
    sel_i = ii.expand(n, ppb)
    flat_i = torch.minimum(sel_i, sel_j).T.reshape(-1)
    flat_j = torch.maximum(sel_i, sel_j).T.reshape(-1)
    flat_mask = sel_mask.T.reshape(-1)
    flat_tight = (sel_mask & sel_tight).T.reshape(-1)
    overflow = overflow + row_overflow.sum()

    oversize = body.alive & (2.0 * body.bound_radius > config.cell_size)
    if has_oversize:
        os_idx = _compact(oversize, MAX_OVERSIZE)
        os_valid = os_idx >= 0
        os_i = torch.clamp(os_idx, min=0)[:, None].expand(MAX_OVERSIZE, n)
        os_j = torch.arange(n, device=dev)[None, :].expand(MAX_OVERSIZE, n)
        oi = os_i[:, 0]
        ok = collidable[oi][:, None] & collidable[None, :] & (os_j != os_i)
        ok &= moving[oi][:, None] | moving[None, :]
        ok &= ~(is_static[oi][:, None] & is_static[None, :])
        rr = infl_radius[oi][:, None] + infl_radius[None, :]
        ok &= _dist2(body.pos[oi][:, None, :] - body.pos[None, :, :]) <= rr * rr
        os_mask = os_valid[:, None] & ok
        a = torch.minimum(os_i, os_j)
        b = torch.maximum(os_i, os_j)
        os_mask &= ~(oversize[None, :] & (os_j < os_i))
        os_overflow = oversize.sum() - os_valid.sum()
        all_a = torch.cat([flat_i, a.reshape(-1)])
        all_b = torch.cat([flat_j, b.reshape(-1)])
        all_mask = torch.cat([flat_mask, os_mask.reshape(-1)])
        all_tight = torch.cat([flat_tight, os_mask.reshape(-1)])
    else:
        os_overflow = oversize.sum()
        all_a, all_b, all_mask, all_tight = flat_i, flat_j, flat_mask, flat_tight

    # Stream compaction of packed (a << 16 | b) keys, then sort-dedup.
    mp = config.max_pairs
    out_idx = torch.cumsum(all_mask.long(), 0) - 1
    num_pairs = all_mask.sum().to(torch.int32)
    keep = all_mask & (out_idx < mp)
    dst = torch.where(keep, out_idx, mp)
    packed = (all_a << 16) | all_b
    buf = torch.full((mp + 1,), PAIR_EMPTY, dtype=torch.int64, device=dev)
    buf.index_put_((dst,), torch.where(keep, packed, PAIR_EMPTY))
    buf = torch.sort(buf[:mp]).values
    dup = torch.zeros(mp, dtype=torch.bool, device=dev)
    dup[1:] = buf[1:] == buf[:-1]
    pair_valid = (buf != PAIR_EMPTY) & ~dup
    pair_a = torch.where(pair_valid, buf >> 16, -1).to(torch.int32)
    pair_b = torch.where(pair_valid, buf & 0xFFFF, -1).to(torch.int32)
    pair_overflow = (all_tight & ~keep).sum()
    return (pair_a, pair_b, pair_valid, num_pairs,
            (overflow + os_overflow + pair_overflow).to(torch.int32))


def scratch_ints(n: int, ppb: int, max_pairs: int, has_oversize: bool) -> int:
    """int32 words of KS's scratch (csrc/pairs.cu:find_pairs' layout): ctrl,
    the oversize list, hist, offs and speed [N], the prep blocks' maxima and
    counts, the oversize words, the slot-major keys, buf, lidx and tmp
    [max_pairs], (8-byte aligned) the two look-backs' states, the slot
    bits (bytes)."""
    n_sel = ppb * n
    n_rows = n_sel + (MAX_OVERSIZE * n if has_oversize else 0)
    n_blocks = -(-n // 256)
    words = (_CTRL_SLOTS + MAX_OVERSIZE + 3 * n + 2 * n_blocks + -(-n // 32) + n_sel
             + 3 * max_pairs)
    words += words & 1
    return words + 2 * (-(-n_rows // 1024) + -(-n // 1024)) + -(-n_sel // 4)


_NAMES = ("pos", "linvel", "alive", "awake", "collidable", "motion_type", "bound_radius",
          "shape_type", "shape_params")
_DTYPES = (torch.float32, torch.float32, torch.bool, torch.bool, torch.bool, torch.int32,
           torch.float32, torch.int32, torch.float32)
# The launcher's argument buffer: 20 pointers, 9 sizes, 4 floats as
# doubles (csrc/pairs.cu:find_pairs).
_PACK = struct.Struct("=29q4d")
_MAX_PLANS = 8
_plans: dict = {}


class _Plan:
    """What one world shape and configuration fix for every call: the
    bodies' shapes, the launcher's sizes and the layout of the one int32
    buffer that holds a call's outputs and scratch (pair_a, pair_b, the
    three counters, the margins, pair_valid, then the scratch at an even
    word)."""

    def __init__(self, n, sp, config, has_oversize, device):
        ppb, mp, cap = config.pairs_per_body, config.max_pairs, config.cell_capacity
        if not 1 <= ppb <= MAX_PPB or n > (1 << 16):
            raise ValueError(f"KS takes pairs_per_body in [1, {MAX_PPB}] and at most 65,536 "
                             f"bodies (got {ppb}, {n})")
        if not 1 <= cap <= MAX_CAP:
            raise ValueError(f"KS takes cell_capacity in [1, {MAX_CAP}] (got {cap})")
        self.device = device
        self.shapes = ((n, 3), (n, 3), (n,), (n,), (n,), (n,), (n,), (n,), tuple(sp.shape))
        self.n, self.mp = n, mp
        self.o_margin = 2 * mp + 4
        self.o_pv = self.o_margin + n
        self.o_scratch = self.o_pv + -(-mp // 4)
        self.o_scratch += self.o_scratch & 1
        self.words = self.o_scratch + scratch_ints(n, ppb, mp, has_oversize)
        self.kp = dict(num_buckets=config.grid_dim * config.grid_dim, cap=cap,
                       rcp_cell=fp.recip(config.cell_size), cell_size=config.cell_size,
                       with_flags=True)
        self.sizes = (sp.stride(0), n, config.grid_dim * config.grid_dim, cap, ppb, mp,
                      int(bool(has_oversize)))
        self.interval = config.pair_rebuild_interval
        self.margin_cap = 0.6 * config.cell_size
        self.cell_size = float(config.cell_size)


def _plan(body, config, has_oversize):
    sp = body.shape_params
    key = (config, bool(has_oversize), body.device, body.capacity, tuple(sp.shape),
           sp.stride(0))
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= _MAX_PLANS:
            _plans.pop(next(iter(_plans)))
        plan = _plans[key] = _Plan(body.capacity, sp, config, has_oversize, body.device)
    return plan


def _launch(body, config, has_oversize, rebuild, const_margin, dt):
    """KP's cell table, then KS's six launches from one packed argument
    buffer; the outputs are views of one new int32 buffer."""
    global launches
    plan = _plan(body, config, has_oversize)
    coll = body.collidable
    dyn = (body.pos, body.linvel, body.alive, body.awake, coll, body.motion_type,
           body.bound_radius, body.shape_type, body.shape_params)
    build.check_all(plan.device, dyn, _NAMES, _DTYPES, plan.shapes)
    table, cells, cell_over = cell_table.cell_table(
        body.pos, body.alive, coll, body.awake, body.motion_type, body.bound_radius, **plan.kp)
    mp, n = plan.mp, plan.n
    ints = torch.empty((plan.words,), dtype=torch.int32, device=plan.device)
    base = ints.data_ptr()
    pa, pb = ints[:mp], ints[mp:2 * mp]
    num_pairs, overflow, steps_left = (ints[2 * mp + k] for k in range(3))
    margin = ints[plan.o_margin:plan.o_pv].view(torch.float32)
    pv = ints[plan.o_pv:plan.o_scratch].view(torch.bool)[:mp]
    build.launch_packed("find_pairs", _PACK.pack(
        *[t.data_ptr() for t in dyn], table.data_ptr(), cells.data_ptr(), cell_over.data_ptr(),
        base + 4 * plan.o_scratch, base + 4 * plan.o_margin, base, base + 4 * mp,
        base + 4 * plan.o_pv, base + 8 * mp, base + 8 * mp + 4, base + 8 * mp + 8,
        *plan.sizes, int(rebuild), plan.interval, float(const_margin), float(dt),
        plan.margin_cap, plan.cell_size))
    launches += 1
    return pa, pb, pv, num_pairs, overflow, steps_left, margin


def find_pairs(body, config, margin=0.08, has_oversize: bool = True):
    """KS with one margin for every body: (pair_a [P] i32, pair_b [P] i32,
    pair_valid [P] bool, num_pairs [] i32, overflow [] i32); pair_a <
    pair_b.  A per-body [N] margin runs the twin on the CPU only."""
    if body.device.type == "cpu":
        return find_pairs_plain(body, config, margin=margin, has_oversize=has_oversize)
    if isinstance(margin, torch.Tensor):
        raise ValueError("KS takes a scalar margin (per-body margins: pairs_rebuild)")
    return _launch(body, config, has_oversize, False, margin, 0.0)[:5]


def pairs_rebuild_plain(body, dt, config, has_oversize: bool = True):
    """The twin of ``pairs_rebuild``."""
    margin, window = rebuild_margins_plain(body, dt, config)
    out = find_pairs_plain(body, config, margin=margin, has_oversize=has_oversize)
    return out + ((window - 1).to(torch.int32), margin)


def pairs_rebuild(body, dt, config, has_oversize: bool = True):
    """KS at a rebuild: find_pairs with speed-scaled per-body margins and
    an adaptive reuse window.  Returns (pa, pb, pv, num, ov, steps_left,
    margin [N])."""
    if body.device.type == "cpu":
        return pairs_rebuild_plain(body, dt, config, has_oversize)
    return _launch(body, config, has_oversize, True, 0.0, dt)

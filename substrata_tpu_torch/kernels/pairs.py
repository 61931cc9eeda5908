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

``find_pairs`` runs ``find_pairs_plain`` for CPU tensors and the launches
of ``csrc/pairs.cu`` (after KP's) for CUDA ones.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build, cell_table
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.physics.state import MotionType, ShapeType

launches = 0

MAX_OVERSIZE = 64
MAX_PPB = 16            # csrc/pairs.cu:kMaxPpb
_TBL_IDX_MASK = 0xFFFF
PAIR_EMPTY = 0xFFFFFFFF
_CTRL_SLOTS = 5         # csrc/pairs.cu:kCtrlSlots


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
    # multiply by the reciprocal).
    window = torch.clamp(torch.floor(torch.full_like(step, margin_cap) / step),
                         1, interval).to(torch.int32)
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
    """int32 words of KS's scratch (csrc/pairs.cu:find_pairs' layout)."""
    n_sel = ppb * n
    n_rows = n_sel + (MAX_OVERSIZE * n if has_oversize else 0)
    n_tiles = (n_rows + 1023) // 1024
    return (_CTRL_SLOTS + MAX_OVERSIZE + 3 * n + n_tiles + n_sel + 3 * max_pairs
            + (n_sel + 3) // 4)


def _launch(body, config, has_oversize, rebuild, const_margin, dt, margin_in=None):
    global launches
    dev = body.device
    n = body.capacity
    ppb = config.pairs_per_body
    mp = config.max_pairs
    if not 1 <= ppb <= MAX_PPB or n > (1 << 16):
        raise ValueError(f"KS takes pairs_per_body in [1, {MAX_PPB}] and at most 65,536 "
                         f"bodies (got {ppb}, {n})")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    sp = body.shape_params
    for t, name, dtp, shp in ((body.pos, "pos", f32, (n, 3)),
                              (body.linvel, "linvel", f32, (n, 3)),
                              (body.alive, "alive", b8, (n,)), (body.awake, "awake", b8, (n,)),
                              (body.collidable, "collidable", b8, (n,)),
                              (body.motion_type, "motion_type", i32, (n,)),
                              (body.bound_radius, "bound_radius", f32, (n,)),
                              (body.shape_type, "shape_type", i32, (n,)),
                              (sp, "shape_params", f32, tuple(sp.shape))):
        build.check(t, name, dtp, shp, dev)
    table, cells, cell_over = _cell_table(body, config)
    ints = torch.empty((2 * mp + 4 + scratch_ints(n, ppb, mp, has_oversize),), dtype=i32,
                       device=dev)
    pa, pb = ints[:mp], ints[mp:2 * mp]
    num_pairs, overflow, steps_left = (ints[2 * mp + k:2 * mp + k + 1].reshape(())
                                       for k in range(3))
    scratch = ints[2 * mp + 4:]
    pv = torch.empty((mp,), dtype=b8, device=dev)
    margin = torch.empty((n,), dtype=f32, device=dev)
    build.launch("find_pairs", body.pos, body.linvel, body.alive, body.awake, body.collidable,
                 body.motion_type, body.bound_radius, body.shape_type, sp, sp.stride(0), n,
                 table, cells, cell_over, config.grid_dim * config.grid_dim,
                 config.cell_capacity, ppb, mp, int(bool(has_oversize)), int(rebuild),
                 float(const_margin), float(np.float32(dt)),
                 float(np.float32(0.6 * config.cell_size)), config.pair_rebuild_interval,
                 float(config.cell_size), margin, scratch, pa, pb, pv, num_pairs, overflow,
                 steps_left)
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

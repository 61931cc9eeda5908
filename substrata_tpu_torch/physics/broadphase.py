"""Uniform-grid (spatial hash) broadphase with temporal pair reuse.

Counterpart of ``substrata_tpu/physics/broadphase.py`` (programs K1 and K2
of ROADMAP.md queue 2): hash every body's cell into a bucket table (kernel
KP, ``kernels/cell_table.py``), then, in plain torch (K2), gather
candidates from the 14-bucket half stencil,
keep each body's ``pairs_per_body`` closest, compact into ``max_pairs``
packed keys and dedup by sort.

Integer semantics follow the reference exactly: the cell hash multiplies
in int32 with wraparound and reduces modulo the bucket count as uint32
(done here in int64 with a 32-bit mask), packed keys are uint32 (int64
here), sorts are stable, and the per-row top-K takes the lower column on
ties, as ``lax.top_k`` does.  Nothing here reads a value back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from substrata_tpu_torch.kernels import cell_table
from substrata_tpu_torch.physics.state import (BodyState, MotionType,
                                               ShapeType, SimConfig, _Replace)

MAX_OVERSIZE = 64
_TBL_IDX_MASK = 0xFFFF
_PAIR_EMPTY = 0xFFFFFFFF


def _half_offsets(device):
    """Own cell + the 13 lexicographically positive (dz, dy, dx) neighbours,
    in the reference's order: cell codes o = 9(dz+1) + 3(dy+1) + (dx+1)
    from 13 (the own cell) to 26.  Built on the device, no upload."""
    o = torch.arange(13, 27, device=device, dtype=torch.int32)
    return torch.stack([o % 3 - 1, (o // 3) % 3 - 1, o // 9 - 1], dim=1)


def recip(c: float) -> float:
    """float32 ``1 / c``: the reference divides by a static config value
    (``cell_size``), which XLA folds into a multiply by this reciprocal."""
    return float(np.float32(1.0) / np.float32(c))


def build_cell_table(body: BodyState, config: SimConfig, with_flags: bool = False):
    """Bucket -> body-slot table (kernel KP on the card, its twin on the CPU).

    Returns (table [num_buckets+1, cap] i32 with -1 padding, cells [N, 3]
    i32, overflow [] i32 — bodies dropped because their bucket was full)."""
    return cell_table.cell_table(
        body.pos, body.alive, body.collidable, body.awake, body.motion_type,
        body.bound_radius, num_buckets=config.grid_dim * config.grid_dim,
        cap=config.cell_capacity, rcp_cell=recip(config.cell_size),
        cell_size=config.cell_size, with_flags=with_flags)


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


def find_pairs(body: BodyState, config: SimConfig, margin=0.08,
               has_oversize: bool = True):
    """Padded candidate pair list.

    Returns (pair_a [P] i32, pair_b [P] i32, pair_valid [P] bool,
    num_pairs [] , overflow []); pair_a < pair_b.  ``margin`` is a scalar
    or per-body [N] speculative margin."""
    n = body.capacity
    dev = body.device
    cap = config.cell_capacity
    num_buckets = config.grid_dim * config.grid_dim
    table, cells, overflow = build_cell_table(body, config, with_flags=True)

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
    d = body.pos[:, None, :] - body.pos[jj_safe]
    d2 = torch.sum(d * d, dim=-1)
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
        dd = body.pos[oi][:, None, :] - body.pos[None, :, :]
        rr = infl_radius[oi][:, None] + infl_radius[None, :]
        ok &= torch.sum(dd * dd, dim=-1) <= rr * rr
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
    buf = torch.full((mp + 1,), _PAIR_EMPTY, dtype=torch.int64, device=dev)
    buf.index_put_((dst,), torch.where(keep, packed, _PAIR_EMPTY))
    buf = torch.sort(buf[:mp]).values
    dup = torch.zeros(mp, dtype=torch.bool, device=dev)
    dup[1:] = buf[1:] == buf[:-1]
    pair_valid = (buf != _PAIR_EMPTY) & ~dup
    pair_a = torch.where(pair_valid, buf >> 16, -1).to(torch.int32)
    pair_b = torch.where(pair_valid, buf & 0xFFFF, -1).to(torch.int32)
    pair_overflow = (all_tight & ~keep).sum()
    return (pair_a, pair_b, pair_valid, num_pairs,
            (overflow + os_overflow + pair_overflow).to(torch.int32))


# ---------------------------------------------------------------------------
# Temporal pair caching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PairCache(_Replace):
    """Pair list reused across steps, with the pair-entry incidence table
    of the solver's blocked contact layout (rebuilt with the pairs)."""

    pair_a: torch.Tensor      # [P] i32
    pair_b: torch.Tensor      # [P] i32
    pair_valid: torch.Tensor  # [P] bool
    num_pairs: torch.Tensor   # [] i32
    steps_left: torch.Tensor  # [] i32; <= 0 forces a rebuild
    inc_table: torch.Tensor   # [N, CPB] i32 (-1 empty)
    inc_sign: torch.Tensor    # [N, CPB] f32


def empty_pair_cache(config: SimConfig, *, device) -> PairCache:
    p = config.max_pairs
    i32 = dict(dtype=torch.int32, device=device)
    return PairCache(
        pair_a=torch.full((p,), -1, **i32),
        pair_b=torch.full((p,), -1, **i32),
        pair_valid=torch.zeros((p,), dtype=torch.bool, device=device),
        num_pairs=torch.zeros((), **i32),
        steps_left=torch.zeros((), **i32),
        inc_table=torch.full((config.capacity, config.contacts_per_body), -1, **i32),
        inc_sign=torch.zeros((config.capacity, config.contacts_per_body),
                             dtype=torch.float32, device=device),
    )


def _pairs_rebuild(body: BodyState, dt, config: SimConfig, has_oversize: bool = True):
    """find_pairs with speed-scaled per-body margins and an adaptive reuse
    window.  Returns (pa, pb, pv, num, ov, steps_left)."""
    interval = config.pair_rebuild_interval
    speed = torch.sqrt(torch.sum(body.linvel * body.linvel, dim=-1))
    speed = torch.where(body.alive & body.awake, speed, 0.0)
    vmax = speed.max()
    margin_cap = 0.6 * config.cell_size
    window = torch.clamp(torch.floor(margin_cap / torch.clamp(vmax * dt, min=1e-6)),
                         1, interval).to(torch.int32)
    margin = 0.08 + speed * window.to(torch.float32) * dt
    pa, pb, pv, num, ov = find_pairs(body, config, margin=margin,
                                     has_oversize=has_oversize)
    return pa, pb, pv, num, ov, window - 1


def find_pairs_cached(body: BodyState, cache: PairCache, dt, config: SimConfig,
                      rebuild: bool, has_oversize: bool = True):
    """find_pairs with temporal reuse; ``rebuild`` is chosen by the host
    (PhysicsWorld.think, from the previous step's digest).

    Returns (pair_a, pair_b, pair_valid, num_pairs, overflow, new_cache)."""
    if rebuild:
        pa, pb, pv, num, ov, left = _pairs_rebuild(body, dt, config, has_oversize)
    else:
        pa, pb, pv, num, ov, left = (
            cache.pair_a, cache.pair_b, cache.pair_valid, cache.num_pairs,
            torch.zeros((), dtype=torch.int32, device=body.device),
            cache.steps_left - 1)
    return pa, pb, pv, num, ov, cache.replace(
        pair_a=pa, pair_b=pb, pair_valid=pv, num_pairs=num, steps_left=left)

"""Uniform-grid (spatial hash) broadphase with temporal pair reuse.

Counterpart of ``substrata_tpu/physics/broadphase.py`` (programs K1 and K2
of ROADMAP.md queue 2): hash every body's cell into a bucket table (kernel
KP, ``kernels/cell_table.py``), then gather candidates from the 14-bucket
half stencil, keep each body's ``pairs_per_body`` closest, compact into
``max_pairs`` packed keys and dedup by sort (kernel KS,
``kernels/pairs.py``, which holds the plain twin and its integer rules).
Nothing here reads a value back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import cell_table, pairs
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.physics.state import BodyState, SimConfig, _Replace


def build_cell_table(body: BodyState, config: SimConfig, with_flags: bool = False):
    """Bucket -> body-slot table (kernel KP on the card, its twin on the CPU).

    Returns (table [num_buckets+1, cap] i32 with -1 padding, cells [N, 3]
    i32, overflow [] i32 — bodies dropped because their bucket was full)."""
    return cell_table.cell_table(
        body.pos, body.alive, body.collidable, body.awake, body.motion_type,
        body.bound_radius, num_buckets=config.grid_dim * config.grid_dim,
        cap=config.cell_capacity, rcp_cell=fp.recip(config.cell_size),
        cell_size=config.cell_size, with_flags=with_flags)


def find_pairs(body: BodyState, config: SimConfig, margin=0.08,
               has_oversize: bool = True):
    """Padded candidate pair list (kernel KS; its twin on the CPU).

    Returns (pair_a [P] i32, pair_b [P] i32, pair_valid [P] bool,
    num_pairs [] , overflow []); pair_a < pair_b.  ``margin`` is a scalar
    or (on the CPU) a per-body [N] speculative margin."""
    return pairs.find_pairs(body, config, margin=margin, has_oversize=has_oversize)


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
    window (kernel KS).  Returns (pa, pb, pv, num, ov, steps_left)."""
    return pairs.pairs_rebuild(body, dt, config, has_oversize)[:6]


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

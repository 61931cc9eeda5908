"""Spatial domain decomposition of ONE physics world, its shards on one
card (K20c-e).

Counterpart of ``substrata_tpu/parallel/spatial.py``: space is split into
x-slabs (or x-y tiles), each shard owns the bodies inside its slab in a
fixed-capacity block of rows, and every step each shard receives a
fixed-size halo of its neighbours' boundary bodies, steps its own and the
ghost bodies with the cold ``physics_step`` and keeps only its own.  The
reference runs the shards on a device mesh and moves the halos with
``ppermute``; here the shards are blocks of one contiguous state on one
card, kernel KAD writes every shard's rows and ghosts into one combined
buffer (``kernels/halo.py``), a loop steps the shards, and kernel KAE
keeps each shard's own rows and counts (``kernels/shard_reduce.py``).

Correctness model (the reference's): with ``halo_width`` at least twice
the largest interaction diameter, every contact of a shard's own body is
reproduced on that shard, so the sharded step matches the unsharded one
to rounding; the ghosts' post-step state is discarded.  Callers re-run
``partition_by_slab`` every few steps as bodies drift.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import halo as kad
from substrata_tpu_torch.kernels import shard_reduce
from substrata_tpu_torch.parallel.mesh import Mesh
from substrata_tpu_torch.physics.state import (BODY_FIELDS, BodyState, SimConfig, SimParams,
                                               StaticWorld)
from substrata_tpu_torch.physics.step import physics_step


def _take(body: BodyState, take: np.ndarray, valid: np.ndarray) -> BodyState:
    """Rows ``take`` of every field (on the body's device); ``alive`` is
    ``valid`` and ``awake`` is masked by it.  Unfilled slots take row 0."""
    dev = body.device
    idx = torch.as_tensor(take, device=dev)
    out = BodyState(**{f: getattr(body, f)[idx] for f in BODY_FIELDS})
    ok = torch.as_tensor(valid, device=dev)
    return out.replace(alive=ok, awake=out.awake & ok)


def _group(alive: np.ndarray, cell: np.ndarray, n_cells: int, local_cap: int, what: str):
    n = alive.shape[0]
    owner_slot = np.full(n, -1, np.int64)
    take = np.zeros(n_cells * local_cap, np.int64)
    valid = np.zeros(n_cells * local_cap, bool)
    for s in range(n_cells):
        ids = np.nonzero(alive & (cell == s))[0]
        if len(ids) > local_cap:
            raise ValueError(f"{what} {s} holds {len(ids)} bodies > local_cap {local_cap}")
        take[s * local_cap:s * local_cap + len(ids)] = ids
        valid[s * local_cap:s * local_cap + len(ids)] = True
        owner_slot[ids] = s * local_cap + np.arange(len(ids))
    return take, valid, owner_slot


def partition_by_slab(body: BodyState, n_slabs: int, local_cap: int, x_min: float,
                      x_max: float):
    """Host-side: re-order a world's bodies into ``n_slabs`` blocks of
    ``local_cap`` slots by x-slab.  Returns (BodyState [n_slabs *
    local_cap] on the body's device, owner_slot: original slot -> new slot,
    -1 for a dead slot).  Raises if a slab overflows ``local_cap``."""
    alive = body.alive.cpu().numpy()
    pos_x = body.pos[:, 0].cpu().numpy()
    slab_w = (x_max - x_min) / n_slabs
    slab = np.clip(((pos_x - x_min) / slab_w).astype(np.int32), 0, n_slabs - 1)
    take, valid, owner_slot = _group(alive, slab, n_slabs, local_cap, "slab")
    return _take(body, take, valid), owner_slot


def partition_by_tile(body: BodyState, px: int, py: int, local_cap: int, x_min: float,
                      x_max: float, y_min: float, y_max: float):
    """Host-side: re-order a world's bodies into px * py tile blocks (tile
    index x-major, y fastest, matching a ("sx", "sy") mesh).  Returns
    (BodyState [px * py * local_cap], owner_slot)."""
    alive = body.alive.cpu().numpy()
    pos = body.pos.cpu().numpy()
    wx = (x_max - x_min) / px
    wy = (y_max - y_min) / py
    tx = np.clip(((pos[:, 0] - x_min) / wx).astype(np.int32), 0, px - 1)
    ty = np.clip(((pos[:, 1] - y_min) / wy).astype(np.int32), 0, py - 1)
    take, valid, owner_slot = _group(alive, tx * py + ty, px * py, local_cap, "tile")
    return _take(body, take, valid), owner_slot


def shard_partitioned(body: BodyState, mesh: Mesh) -> BodyState:
    """Move a partitioned BodyState to the mesh's device (its capacity
    axis holds the shards' blocks in mesh order)."""
    return BodyState(**{f: getattr(body, f).to(mesh.device) for f in BODY_FIELDS})


def _ghosts(combined: BodyState, n_shards: int, rows_in: int, halo: int, first: int):
    def block(t):
        rows = t.reshape((n_shards, rows_in + 2 * halo) + tuple(t.shape[1:]))
        return rows[:, rows_in + first * halo:rows_in + (first + 1) * halo].reshape(
            (n_shards * halo,) + tuple(t.shape[1:]))
    return BodyState(**{f: block(getattr(combined, f)) for f in BODY_FIELDS})


def halo_exchange(local: BodyState, halo_cap: int, halo_width: float, x_min: float,
                  x_max: float, axis_name: str, n_dev: int):
    """The exchange of the x-slabs, every shard at once: ``local`` holds the
    n_dev shards' blocks.  Returns (from_left [n_dev * halo_cap], from_right
    [n_dev * halo_cap], overflow int32 [n_dev]) — the reference's per-device
    results in mesh order: the boundary bodies each shard receives (dead
    rows past the sender's count, all-zero rows at the ends) and each
    shard's count of boundary bodies that did not fit."""
    lo, hi = kad.thresholds(x_min, x_max, n_dev, halo_width)
    combined, ov = kad.exchange(local, n_dev, halo_cap, 0, 1, n_dev, lo, hi)
    rows_in = local.capacity // n_dev
    return (_ghosts(combined, n_dev, rows_in, halo_cap, 0),
            _ghosts(combined, n_dev, rows_in, halo_cap, 1), ov.sum(1).to(torch.int32))


def _axis_exchange(local: BodyState, coord_axis: int, halo_cap: int, halo_width: float,
                   lo: float, hi: float, axis_name: str, n_dev: int, *, mesh: Mesh):
    """One exchange along the mesh axis ``axis_name`` (of size n_dev) over
    every shard of ``mesh``; returns (from_low, from_high, overflow [S])."""
    lo_t, hi_t = kad.thresholds(lo, hi, n_dev, halo_width)
    combined, ov = kad.exchange(local, mesh.size, halo_cap, coord_axis,
                                mesh.stride(axis_name), n_dev, lo_t, hi_t)
    rows_in = local.capacity // mesh.size
    return (_ghosts(combined, mesh.size, rows_in, halo_cap, 0),
            _ghosts(combined, mesh.size, rows_in, halo_cap, 1), ov.sum(1).to(torch.int32))


def _halo_config(config: SimConfig, combined_cap: int) -> SimConfig:
    return SimConfig(
        capacity=combined_cap,
        max_pairs=config.max_pairs,
        max_contacts_per_pair=config.max_contacts_per_pair,
        grid_dim=config.grid_dim,
        cell_capacity=config.cell_capacity,
        cell_size=config.cell_size,
        solver_iters=config.solver_iters,
        static_contacts_per_body=config.static_contacts_per_body,
        max_tri_candidates=config.max_tri_candidates,
        contacts_per_body=config.contacts_per_body,
        max_active_contacts=config.max_active_contacts,
        pairs_per_body=config.pairs_per_body,
        pair_rebuild_interval=1,        # ghosts change every step: no caching
        present_shape_types=config.present_shape_types,
    )


def _step_shards(combined: BodyState, n_shards: int, world, dt, params, cfg, keep: int,
                 overflow: torch.Tensor):
    cap = cfg.capacity
    stepped = [physics_step(BodyState(**{f: getattr(combined, f)[d * cap:(d + 1) * cap]
                                         for f in BODY_FIELDS}),
                            world, dt, params, cfg)[0] for d in range(n_shards)]
    new_body, counts = shard_reduce.keep_count(stepped, keep, overflow)
    return new_body, counts[0], counts[1]


def spatial_world_step(body: BodyState, world: StaticWorld, hull_cv, dt, params: SimParams,
                       config: SimConfig, mesh: Mesh, halo_cap: int, halo_width: float,
                       x_min: float, x_max: float):
    """One step of ONE world in x-slabs: ``body`` as ``partition_by_slab``
    lays it out, on the mesh's device.  KAD exchanges the halos, each shard
    takes the cold step with ``pair_rebuild_interval`` 1 on its local + 2
    halo_cap rows, KAE keeps the local rows.  ``hull_cv`` as in
    ``multi_world_step``.  Returns (new_body, awake count, halo overflow)."""
    n = mesh.size
    local_cap = body.capacity // n
    cfg = _halo_config(config, local_cap + 2 * halo_cap)
    lo, hi = kad.thresholds(x_min, x_max, n, halo_width)
    combined, ov = kad.exchange(body, n, halo_cap, 0, 1, n, lo, hi)
    return _step_shards(combined, n, world, dt, params, cfg, local_cap, ov)


def spatial_world_step_2d(body: BodyState, world: StaticWorld, hull_cv, dt, params: SimParams,
                          config: SimConfig, mesh: Mesh, halo_cap: int, halo_width: float,
                          x_min: float, x_max: float, y_min: float, y_max: float):
    """One step of ONE world in px x py tiles over a 2-D ("sx", "sy") mesh:
    ``body`` as ``partition_by_tile`` lays it out.  An x-phase exchange,
    then a y-phase packing from the local rows and the x-ghosts (corners
    included), each shard stepped on local + 4 halo_cap rows, the local
    rows kept.  Returns (new_body, awake count, halo overflow)."""
    ax_x, ax_y = mesh.axis_names[0], mesh.axis_names[1]
    px, py = mesh.shape
    s = px * py
    local_cap = body.capacity // s
    cfg = _halo_config(config, local_cap + 4 * halo_cap)
    ov = torch.empty((2, s, 2), dtype=torch.int32, device=body.device)
    lo, hi = kad.thresholds(x_min, x_max, px, halo_width)
    with_x, _ = kad.exchange(body, s, halo_cap, 0, mesh.stride(ax_x), px, lo, hi, ov[0])
    lo, hi = kad.thresholds(y_min, y_max, py, halo_width)
    combined, _ = kad.exchange(with_x, s, halo_cap, 1, mesh.stride(ax_y), py, lo, hi, ov[1])
    return _step_shards(combined, s, world, dt, params, cfg, local_cap, ov)

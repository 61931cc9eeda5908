"""Batched ray queries against the bodies and the static world.

Counterpart of ``substrata_tpu/physics/queries.py``: ``trace_rays`` (the
reference's traceRay batched over a leading ray axis: bodies with the hull
library's plane clip, the heightfield and the static trimesh) and
``any_hits`` (doesRayHitAnything).  Particles trace one short motion ray
each per tick, vehicles one suspension ray per wheel, the client one
occlusion ray per audible source, and ``PhysicsWorld.trace_ray`` one ray
per call.  The work is kernel KH (``kernels/ray_trace.py``); the
primitive tests are importable from here as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import pairs
from substrata_tpu_torch.kernels import ray_trace as kray
from substrata_tpu_torch.kernels.ray_trace import (  # noqa: F401
    BIG, _ray_box, _ray_capsule, _ray_hull_planes, _ray_sphere, _ray_triangle)
from substrata_tpu_torch.physics import broadphase
from substrata_tpu_torch.physics.state import BodyState, SimConfig, StaticWorld, _Replace


@dataclasses.dataclass
class RayHits(_Replace):
    t: torch.Tensor         # [R] hit distance, BIG on a miss
    normal: torch.Tensor    # [R, 3]
    body: torch.Tensor      # [R] i32 body slot, or a trimesh hit's owner id
                            # (a virtual anchor's id >= capacity), -1 = none
    material: torch.Tensor  # [R] i32 trimesh material index, else 0
    hit: torch.Tensor       # [R] bool


def oversize_slots(body: BodyState, config: SimConfig):
    """The first MAX_OVERSIZE alive bodies wider than a cell, -1 padded
    (int32, no host sync)."""
    oversize = body.alive & (2.0 * body.bound_radius > config.cell_size)
    return pairs._compact(oversize, pairs.MAX_OVERSIZE).to(torch.int32)


def trace_rays(origins, dirs, max_ts, body: BodyState, world: StaticWorld,
               config: SimConfig, n_steps: int = 16, exclude=None,
               collidable_only: bool = True, table=None, k_cand: int = 16,
               dedup: bool = True, body_steps: int | None = None) -> RayHits:
    """First hit of each ray among the bodies, the heightfield and the
    static trimesh.

    origins/dirs: [R, 3] (dirs unit), max_ts: [R]; exclude: [R] body slot
    to skip (a vehicle's own chassis for its wheel rays), -1 = none.
    ``table``: a cell table from ``broadphase.build_cell_table`` to share
    between the ray batches of one tick; built here when None."""
    r = origins.shape[0]
    if exclude is None:
        exclude = torch.full((r,), -1, dtype=torch.int32, device=origins.device)
    if table is None:
        table, _, _ = broadphase.build_cell_table(body, config)
    t, n, bi, hit, mat = kray.ray_trace(
        origins, dirs, max_ts, body, table, oversize_slots(body, config),
        world.heightfield, world.has_heightfield, exclude.to(torch.int32), world.hulls,
        world.trimesh, cell_size=config.cell_size, grid_dim=config.grid_dim, n_steps=n_steps,
        body_steps=body_steps or n_steps, collidable_only=collidable_only, k=k_cand,
        dedup=dedup)
    return RayHits(t=t, normal=n, body=bi, material=mat, hit=hit)


def any_hits(origins, dirs, max_ts, body: BodyState, world: StaticWorld,
             config: SimConfig, n_steps: int = 16):
    """doesRayHitAnything over a batch of rays -> hit [R] bool."""
    return trace_rays(origins, dirs, max_ts, body, world, config, n_steps=n_steps).hit

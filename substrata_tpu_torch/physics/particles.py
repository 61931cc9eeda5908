"""Point particles with ray-traced collisions.

Counterpart of ``substrata_tpu/physics/particles.py`` (the reference's
ParticleManager::think): each tick every particle traces its motion ray
(kernel KH); on a hit its velocity reflects about the normal, scaled by
its restitution, and it continues for the rest of the tick; particles that
die on a surface or in the water raise a foam event; the rest is gravity,
quadratic air drag and the opacity and width fades (kernel KI).

State is fixed-capacity SoA; a flush of spawns scatters into a
host-managed ring cursor with one launch (kernel KY, ``kernels/spawn.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from substrata_tpu_torch.kernels import particles_triton as kpart
from substrata_tpu_torch.kernels import spawn as kspawn
from substrata_tpu_torch.physics import queries
from substrata_tpu_torch.physics.state import (BodyState, SimConfig, SimParams, StaticWorld,
                                               _Replace)

AIR_RHO = kpart.AIR_RHO
DRAG_CD = kpart.DRAG_CD
MAX_DRAG_ACCEL = kpart.MAX_DRAG_ACCEL
SURFACE_NUDGE = kpart.SURFACE_NUDGE

# Sprite types (ParticleManager.h:25-60).
TYPE_SMOKE = 0
TYPE_FOAM = 1


@dataclasses.dataclass
class ParticleState(_Replace):
    pos: torch.Tensor          # [P, 3]
    vel: torch.Tensor          # [P, 3]
    area: torch.Tensor         # [P]
    mass: torch.Tensor         # [P]
    restitution: torch.Tensor  # [P]
    width: torch.Tensor        # [P]
    dwidth_dt: torch.Tensor    # [P]
    opacity: torch.Tensor      # [P]
    dopacity_dt: torch.Tensor  # [P]
    theta: torch.Tensor        # [P] sprite rotation
    sprite_type: torch.Tensor  # [P] i32
    die_on_hit: torch.Tensor   # [P] bool (die_when_hit_surface)
    alive: torch.Tensor        # [P] bool

    @property
    def capacity(self):
        return self.pos.shape[0]


PARTICLE_FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState))


def zero_particles(capacity: int, *, device) -> ParticleState:
    p = capacity
    f = dict(dtype=torch.float32, device=device)
    return ParticleState(
        pos=torch.zeros((p, 3), **f), vel=torch.zeros((p, 3), **f),
        area=torch.full((p,), 1e-4, **f), mass=torch.full((p,), 1e-6, **f),
        restitution=torch.full((p,), 0.5, **f), width=torch.full((p,), 0.1, **f),
        dwidth_dt=torch.zeros((p,), **f), opacity=torch.zeros((p,), **f),
        dopacity_dt=torch.zeros((p,), **f), theta=torch.zeros((p,), **f),
        sprite_type=torch.zeros((p,), dtype=torch.int32, device=device),
        die_on_hit=torch.zeros((p,), dtype=torch.bool, device=device),
        alive=torch.zeros((p,), dtype=torch.bool, device=device),
    )


def motion_rays(ps: ParticleState, dt):
    """Each particle's motion ray over the tick -> (unit dirs [P, 3],
    lengths [P], at least 1e-6)."""
    v = ps.vel
    speed = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    dirs = v / torch.clamp(speed, min=1e-9)[:, None]
    return dirs, torch.clamp(speed * torch.tensor(np.float32(dt)), min=1e-6)


def particles_step(ps: ParticleState, body: BodyState, world: StaticWorld, dt,
                   params: SimParams, config: SimConfig, n_ray_steps: int = 4,
                   table=None):
    """One tick for all particles -> (new_state, foam_events [P] bool: the
    particles that died on the water surface this tick)."""
    dirs, max_ts = motion_rays(ps, dt)
    # Motion rays are shorter than a cell: one midpoint sample covers the
    # segment (body_steps=1) and no body repeats, so no dedup.
    hits = queries.trace_rays(ps.pos, dirs, max_ts, body, world, config,
                              n_steps=n_ray_steps, table=table, body_steps=1, dedup=False)
    pos, vel, opacity, width, alive, foam = kpart.particles_update(
        ps, hits.t, hits.normal, hits.hit, dt, params.water_z)
    return ps.replace(pos=pos, vel=vel, opacity=opacity, width=width, alive=alive), foam


class ParticleManager:
    """Host facade (ParticleManager.h API shape): add_particle / think /
    render data.  Spawns are queued and scattered in one batched update; a
    ring cursor recycles the oldest slots when full."""


    def __init__(self, physics_world, capacity: int = 16_384):
        self.world = physics_world
        self.state = zero_particles(capacity, device=physics_world.device)
        self._cursor = 0
        self._pending: list[dict] = []
        self._maybe_alive = False
        self._ticks_since_check = 0
        self.foam_decal_events: list[np.ndarray] = []
        self.on_foam_decal = None  # callback(pos, width): the terrain decal hook

    def add_particle(self, pos, vel, area=1e-4, mass=1e-6, restitution=0.5,
                     width=0.1, dwidth_dt=0.0, opacity=1.0, dopacity_dt=-0.5,
                     theta=0.0, sprite_type=TYPE_SMOKE, die_when_hit_surface=False):
        self._pending.append(dict(
            pos=np.asarray(pos, np.float32), vel=np.asarray(vel, np.float32),
            area=area, mass=mass, restitution=restitution, width=width,
            dwidth_dt=dwidth_dt, opacity=opacity, dopacity_dt=dopacity_dt,
            theta=theta, sprite_type=sprite_type, die_on_hit=die_when_hit_surface))

    def _flush_spawns(self):
        """Every pending spawn of this flush in one packed host buffer, one
        host -> device copy (pinned on the card) and one KY launch."""
        if not self._pending:
            return
        self._maybe_alive = True
        rows = kspawn.pack_rows(self._pending)
        self._pending = []
        self.state = kspawn.spawn_rows(self.state, self.world._upload(rows), self._cursor)
        self._cursor = (self._cursor + len(rows)) % self.state.capacity

    def think(self, dt: float):
        """ParticleManager::think (ParticleManager.cpp:145-271)."""
        had_pending = bool(self._pending)
        self._flush_spawns()
        if not had_pending and not self._maybe_alive:
            return  # nothing to simulate: skip the device step entirely
        w = self.world
        w._flush()
        self.state, foam = particles_step(self.state, w.state, w.static_world, dt,
                                          w.params, w.config)
        # Cheap host-side liveness heuristic: re-check occasionally.
        self._ticks_since_check += 1
        if self._ticks_since_check >= 60:
            self._ticks_since_check = 0
            self._maybe_alive = self.num_alive > 0
        if self.on_foam_decal is not None:
            fm = foam.cpu().numpy()
            if fm.any():
                pos = self.state.pos.cpu().numpy()[fm]
                width = self.state.width.cpu().numpy()[fm]
                for p, wd in zip(pos, width):
                    foam_pos = p.copy()
                    foam_pos[2] = float(self.world.water_z)
                    self.on_foam_decal(foam_pos, float(wd))

    @property
    def num_alive(self) -> int:
        return int(self.state.alive.sum())

    def get_render_data(self):
        """(pos [P,3], width [P], theta [P], opacity [P], sprite_type [P],
        alive [P]): the transform data the GL layer consumes."""
        s = self.state
        return tuple(x.cpu().numpy() for x in (s.pos, s.width, s.theta, s.opacity,
                                               s.sprite_type, s.alive))

"""Host-side PhysicsWorld facade.

Counterpart of ``substrata_tpu/physics/world.py``: the same
``PhysicsWorld`` / ``PhysicsObject`` surface for the synchronous tick.
The body state lives on ``device`` as a ``BodyState``; host mutations are
queued and flushed as batched scatters at the next ``think``, and each
``think`` reads back exactly one small packed array (the event digest).

Not in this slice (ROADMAP.md queue 1): the fused serving tick
(``think_with_player``, which needs the character and its capsule combos),
pipelined readback, batched snapshot transforms, virtual anchors, static
mesh instances and trimeshes, hulls and snapshots.  Each raises
NotImplementedError naming its item.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field as dfield
from typing import Any

import numpy as np
import torch

from substrata_tpu_torch.physics import broadphase, queries, shapes as shape_factories, solver
from substrata_tpu_torch.physics.state import (
    BodyState, Heightfield, Layer, MotionType, ShapeType, SimConfig,
    SimParams, default_sim_params, default_static_world, flat_heightfield,
    zero_body_state,
)
from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.physics.step import StepEvents, physics_step

USERDATA_WORLD_OBJECT = 0
USERDATA_PARCEL = 1
USERDATA_INSTANCE = 2
USERDATA_AVATAR = 3

_SLICE2 = "ROADMAP.md queue 1, slice 2: facade completion"
_SLICE3 = "ROADMAP.md queue 1, slice 3: the other shapes"
_LATER = ("ROADMAP.md queue 1, slice 5b: the character with its capsule combos, "
          "and the serving tick")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


@dataclass(eq=False)  # identity hashing — objects live in activation sets
class PhysicsObject:
    """Host mirror of one body."""

    shape: shape_factories.PhysicsShape
    pos: np.ndarray = dfield(default_factory=lambda: np.zeros(3, np.float32))
    rot: np.ndarray = dfield(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: np.ndarray = dfield(default_factory=lambda: np.ones(3, np.float32))
    linvel: np.ndarray = dfield(default_factory=lambda: np.zeros(3, np.float32))
    angvel: np.ndarray = dfield(default_factory=lambda: np.zeros(3, np.float32))
    motion_type: int = int(MotionType.STATIC)
    friction: float = 0.5
    restitution: float = 0.0
    collidable: bool = True
    is_sensor: bool = False
    userdata: Any = None
    userdata_type: int = USERDATA_WORLD_OBJECT
    gravity_factor: float = 1.0
    use_zero_linear_drag: bool = False
    smooth_translation: np.ndarray = dfield(default_factory=lambda: np.zeros(3, np.float32))
    smooth_rotation: np.ndarray = dfield(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    slot: int = -1
    underwater: bool = False

    @property
    def mass(self) -> float:
        return self.shape.mass


# --- Device-side host-write programs (scatters of in-range slots). ---------

def _scatter_updates(state: BodyState, idx, **fields) -> BodyState:
    """Write full records for slots ``idx``; resets their sleep timers."""
    new = {}
    for name, val in fields.items():
        t = getattr(state, name).clone()
        t[idx] = val
        new[name] = t
    st = state.sleep_timer.index_fill(0, idx, 0.0)
    return state.replace(sleep_timer=st, **new)


def _scatter_velocities(state: BodyState, idx, linvel, angvel) -> BodyState:
    lv, av = state.linvel.clone(), state.angvel.clone()
    lv[idx] = linvel
    av[idx] = angvel
    return state.replace(linvel=lv, angvel=av, awake=state.awake.index_fill(0, idx, True),
                         sleep_timer=state.sleep_timer.index_fill(0, idx, 0.0))


def _wake_in_regions(state: BodyState, centers, radii) -> BodyState:
    """Wake every dynamic body whose bound sphere overlaps a (centre,
    radius) region, +0.3 m slack for host-mirror staleness."""
    d2 = torch.sum((state.pos[:, None, :] - centers[None]) ** 2, -1)
    r = radii[None] + state.bound_radius[:, None] + 0.3
    hit = torch.any(d2 <= r * r, dim=1) & state.alive & state.dynamic
    return state.replace(awake=state.awake | hit,
                         sleep_timer=torch.where(hit, 0.0, state.sleep_timer))


def _apply_transforms_wake(state: BodyState, idx, pos, rot, vidx, linvel, angvel,
                           centers, radii) -> BodyState:
    """Transform-only host writes, velocities only for the slots ``vidx``
    that provided them, then the region wake."""
    p, q = state.pos.clone(), state.quat.clone()
    lv, av = state.linvel.clone(), state.angvel.clone()
    p[idx] = pos
    q[idx] = rot
    lv[vidx] = linvel
    av[vidx] = angvel
    new = state.replace(pos=p, quat=q, linvel=lv, angvel=av,
                        awake=state.awake.index_fill(0, idx, True),
                        sleep_timer=state.sleep_timer.index_fill(0, idx, 0.0))
    return _wake_in_regions(new, centers, radii)


def _transform_block(state: BodyState):
    """[N, 14] f32 readback block: pos3 | quat4 | linvel3 | angvel3 | underwater."""
    return torch.cat([state.pos, state.quat, state.linvel, state.angvel,
                      state.underwater.to(torch.float32)[:, None]], dim=1)


_EVK = 64      # event-digest slots per class (wakes / sleeps / water)
_EVT = 128     # touching-pair slots in the digest
_DIGEST_HEAD = 200 + 2 * _EVT + 1


def _pack_bits(mask):
    """Bool [N] -> int32 words [ceil(N/32)], bit j of word w = mask[32w+j]."""
    n = mask.shape[0]
    words = (n + 31) // 32
    m = torch.zeros(words * 32, dtype=torch.int64, device=mask.device)
    m[:n] = mask.to(torch.int64)
    v = (m.reshape(words, 32) << torch.arange(32, device=mask.device)).sum(dim=1)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    bits = (words.astype(np.uint32)[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(-1)[:n].astype(bool)


def _event_digest(events: StepEvents, num_contacts, num_awake, steps_left):
    """Everything the host reads per tick, as ONE int32 array.

    Layout (the reference's, world.py:235-277):
      [0:64] newly-awake slots (-1 pad), [64:128] newly-asleep,
      [128:192] entered-water, [192:196] counts (awake, asleep, water,
      touching events), [196:200] num_pairs, broadphase_overflow,
      num_contacts, num_awake, [200:456] touching pairs (a, b), [456]
      pair-cache steps_left;
    then the newly-awake, newly-asleep and entered-water masks bit-packed,
    which the host reads only when a class overflows its 64 slots — so
    the tick still needs no second transfer.  Built with cumsum ranks, no
    host sync."""
    up = broadphase._compact(events.newly_awake, _EVK)
    down = broadphase._compact(events.newly_asleep, _EVK)
    wet = broadphase._compact(events.entered_water, _EVK)
    touch = broadphase._compact(events.contact_touching, _EVT)
    tsafe = torch.clamp(touch, min=0)
    ta = torch.where(touch >= 0, events.contact_pair_a[tsafe].long(), -1)
    tb = torch.where(touch >= 0, events.contact_pair_b[tsafe].long(), -1)
    dev = up.device
    counts = torch.stack([
        events.newly_awake.sum(), events.newly_asleep.sum(),
        events.entered_water.sum(), events.contact_touching.sum(),
        events.num_pairs.to(torch.int64), events.broadphase_overflow.to(torch.int64),
        torch.as_tensor(num_contacts, device=dev).to(torch.int64),
        torch.as_tensor(num_awake, device=dev).to(torch.int64)])
    head = torch.cat([up, down, wet, counts, torch.stack([ta, tb], dim=1).reshape(-1),
                      torch.as_tensor(steps_left, device=dev).to(torch.int64).reshape(1)])
    return torch.cat([head.to(torch.int32), _pack_bits(events.newly_awake),
                      _pack_bits(events.newly_asleep), _pack_bits(events.entered_water)])


class PhysicsWorld:
    """The engine-facing world object, one per simulated world."""

    TIER_DIVS = (1, 4, 16)
    TIER_CALM_STEPS = 30
    TIER_HEADROOM = 2

    def __init__(self, config: SimConfig | None = None,
                 params: SimParams | None = None,
                 auto_tier: bool | None = None,
                 pin_all_shape_types: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.config = copy.copy(config) if config is not None else SimConfig()
        self._base_config = copy.copy(self.config)
        if auto_tier is None:
            auto_tier = self.config.capacity >= 2048
        self.auto_tier = auto_tier
        self._tier = 0
        self._calm_steps = 0
        self.config.present_shape_types = ((True, True, True, True)
                                           if pin_all_shape_types
                                           else (False, False, False, False))
        self.params = params or default_sim_params(device=self.device)
        self.state = zero_body_state(self.config.capacity, device=self.device)
        self.solver_cache = solver.empty_solver_cache(
            solver.cache_size_for(self.config), device=self.device)
        self.pair_cache = broadphase.empty_pair_cache(self.config, device=self.device)
        self._cache_stale = False
        self._force_pair_rebuild = True
        self._host_steps_left = 0
        self._wake_regions: list[tuple[np.ndarray, float]] = []
        self._world_asleep = False
        self._oversize_slots: set[int] = set()
        self.static_world = default_static_world(ground_z=-1e10, device=self.device)
        self.water_buoyancy_enabled = False
        self._water_z = -1e10

        self.objects: dict[int, PhysicsObject] = {}
        self._free = list(range(self.config.capacity - 1, -1, -1))
        self._dirty: dict[int, tuple] = {}
        self._vel_dirty: dict[int, PhysicsObject] = {}
        self._xform_dirty: dict[int, tuple] = {}

        self.activated_obs: set[PhysicsObject] = set()
        self.newly_activated_obs: set[PhysicsObject] = set()
        self.event_listener: Any = None

        self.last_events = None
        self.last_diags = None
        self._steps = 0
        self._nonstatic_objs = None
        self._prev_sync_block = None
        self._structural_dirty = False

    # ------------------------------------------------------------------
    # Water
    # ------------------------------------------------------------------
    @property
    def water_z(self):
        return self._water_z

    @water_z.setter
    def water_z(self, z):
        self._water_z = float(z)
        wz = torch.tensor(z if self.water_buoyancy_enabled else -1e10,
                          dtype=torch.float32, device=self.device)
        self.params = self.params.replace(water_z=wz)
        self.static_world = self.static_world.replace(water_z=wz)

    def set_water_buoyancy_enabled(self, enabled: bool):
        self.water_buoyancy_enabled = bool(enabled)
        self.water_z = self._water_z

    # ------------------------------------------------------------------
    # Static environment
    # ------------------------------------------------------------------
    def set_heightfield(self, heights, origin, cell_w):
        h = np.asarray(heights, np.float32)
        hf = Heightfield(
            heights=torch.as_tensor(h, device=self.device),
            origin=torch.as_tensor(np.asarray(origin, np.float32), device=self.device),
            cell_w=torch.tensor(float(cell_w), dtype=torch.float32, device=self.device),
            is_flat=bool(h.size) and bool(np.all(h == h.flat[0])))
        self.static_world = self.static_world.replace(
            heightfield=hf, has_heightfield=torch.tensor(True, device=self.device))

    def set_ground_plane(self, z: float = 0.0):
        self.static_world = self.static_world.replace(
            heightfield=flat_heightfield(z=z, device=self.device),
            has_heightfield=torch.tensor(True, device=self.device))

    def set_static_trimesh(self, verts, tris, tri_mats=None):
        _not_ported("static trimesh geometry", _SLICE3)

    def add_static_mesh_instance(self, verts, tris, tri_mats=None, owner_slot: int = -1):
        _not_ported("static mesh instances", _SLICE3)

    def remove_static_mesh_instance(self, inst_id: int):
        _not_ported("static mesh instances", _SLICE3)

    # ------------------------------------------------------------------
    # Object management
    # ------------------------------------------------------------------
    def add_object(self, ob: PhysicsObject) -> PhysicsObject:
        if not self._free:
            raise RuntimeError(f"PhysicsWorld at capacity {self.config.capacity}")
        if ob.shape.shape_type == int(ShapeType.HULL):
            _not_ported("convex hull bodies (hull interning)", _SLICE3)
        if not np.allclose(ob.scale, 1.0):
            ob.shape = shape_factories.scaled(ob.shape, ob.scale)
        slot = self._free.pop()
        ob.slot = slot
        self.objects[slot] = ob
        self._nonstatic_objs = None
        self._structural_dirty = True
        self._dirty[slot] = (ob, True)
        st = int(ob.shape.shape_type)
        if not self.config.present_shape_types[st]:
            cfg = copy.copy(self.config)
            cfg.present_shape_types = tuple(
                p or (i == st) for i, p in enumerate(cfg.present_shape_types))
            self.config = cfg
        return ob

    def add_virtual_anchor(self, ob: PhysicsObject) -> PhysicsObject:
        _not_ported("virtual anchors", _SLICE2)

    def remove_object(self, ob: PhysicsObject):
        if ob.slot < 0:
            return
        slot = ob.slot
        self.objects.pop(slot, None)
        self._nonstatic_objs = None
        self._structural_dirty = True
        self.activated_obs.discard(ob)
        dead = PhysicsObject(shape=shape_factories.make_sphere(1e-4))
        dead.slot = slot
        dead.collidable = False
        self._dirty[slot] = (dead, False)
        ob.slot = -1
        self._free.append(slot)
        # Warm-start entries are keyed by slot: a reused slot must not
        # inherit them.
        self._cache_stale = True
        self._wake_regions.append((np.asarray(ob.pos, np.float32),
                                   float(ob.shape.bound_radius)))

    # ------------------------------------------------------------------
    # Transform / velocity setters
    # ------------------------------------------------------------------
    def set_new_ob_to_world_transform(self, ob: PhysicsObject, pos, rot,
                                      linvel=None, angvel=None, scale=None):
        old_pos = ob.pos
        old_vel = ob.linvel
        ob.pos = np.asarray(pos, np.float32)
        ob.rot = np.asarray(rot, np.float32)
        if np.linalg.norm(ob.pos - old_pos) > 0.5 * ob.shape.bound_radius + 0.1:
            self._wake_regions.append((old_pos, ob.shape.bound_radius))
        if linvel is not None:
            ob.linvel = np.asarray(linvel, np.float32)
        if angvel is not None:
            ob.angvel = np.asarray(angvel, np.float32)
        window_travel = (float(np.linalg.norm(old_vel))
                         * self.config.pair_rebuild_interval / 60.0)
        if (np.linalg.norm(ob.pos - old_pos) > 0.08 + window_travel
                or (linvel is not None
                    and np.linalg.norm(ob.linvel) > np.linalg.norm(old_vel) + 0.25)):
            self._structural_dirty = True
        if scale is not None and not np.allclose(scale, ob.scale):
            ob.scale = np.asarray(scale, np.float32)
            ob.shape = shape_factories.scaled(ob.shape, ob.scale)
            self._dirty[ob.slot] = (ob, True)
        else:
            self._xform_dirty[ob.slot] = (ob, linvel is not None or angvel is not None)

    def set_new_ob_transforms_batch(self, obs, pos, rot, linvel, angvel):
        _not_ported("batched snapshot transforms (serving path)", _SLICE2)

    def set_linear_and_angular_vel(self, ob: PhysicsObject, linvel, angvel,
                                   activate: bool = True):
        ob.linvel = np.asarray(linvel, np.float32)
        ob.angvel = np.asarray(angvel, np.float32)
        self._structural_dirty = True
        self._vel_dirty[ob.slot] = ob

    # ------------------------------------------------------------------
    # Flush / think
    # ------------------------------------------------------------------
    def _dev(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _flush(self):
        """Upload pending host mutations as batched scatters."""
        if self._cache_stale:
            self.solver_cache = solver.empty_solver_cache(
                solver.cache_size_for(self.config), device=self.device)
            self._cache_stale = False
        if self._dirty:
            items = list(self._dirty.items())
            self._dirty.clear()
            for s, (o, a) in items:
                if a and 2.0 * float(o.shape.bound_radius) > self.config.cell_size:
                    self._oversize_slots.add(s)
                else:
                    self._oversize_slots.discard(s)
            obs = [o for _, (o, _a) in items]
            dyn = [o.motion_type == int(MotionType.DYNAMIC) for o in obs]

            def layer(o):
                moving = o.motion_type != int(MotionType.STATIC)
                if o.collidable:
                    return int(Layer.MOVING) if moving else int(Layer.NON_MOVING)
                return (int(Layer.MOVING_NON_COLLIDABLE) if moving
                        else int(Layer.NON_MOVING_NON_COLLIDABLE))

            f32, i32 = np.float32, np.int32
            idx = self._dev(np.array([s for s, _ in items], np.int64))
            self.state = _scatter_updates(
                self.state, idx,
                pos=self._dev(np.stack([o.pos for o in obs]).astype(f32)),
                quat=self._dev(np.stack([o.rot for o in obs]).astype(f32)),
                linvel=self._dev(np.stack([o.linvel for o in obs]).astype(f32)),
                angvel=self._dev(np.stack([o.angvel for o in obs]).astype(f32)),
                inv_mass=self._dev(np.array([o.shape.inv_mass if d else 0.0
                                             for o, d in zip(obs, dyn)], f32)),
                inv_inertia=self._dev(np.stack([o.shape.inv_inertia if d else np.zeros(3)
                                                for o, d in zip(obs, dyn)]).astype(f32)),
                friction=self._dev(np.array([o.friction for o in obs], f32)),
                restitution=self._dev(np.array([o.restitution for o in obs], f32)),
                motion_type=self._dev(np.array([o.motion_type for o in obs], i32)),
                layer=self._dev(np.array([layer(o) for o in obs], i32)),
                is_sensor=self._dev(np.array([o.is_sensor for o in obs], bool)),
                shape_type=self._dev(np.array([o.shape.shape_type for o in obs], i32)),
                shape_params=self._dev(np.stack([o.shape.params for o in obs]).astype(f32)),
                alive=self._dev(np.array([a for _, (_o, a) in items], bool)),
                awake=self._dev(np.array([o.motion_type != int(MotionType.STATIC)
                                          for o in obs], bool)),
                gravity_factor=self._dev(np.array([o.gravity_factor for o in obs], f32)),
                use_zero_linear_drag=self._dev(np.array([o.use_zero_linear_drag
                                                         for o in obs], bool)),
                bound_radius=self._dev(np.array([o.shape.bound_radius for o in obs], f32)),
                volume=self._dev(np.array([o.shape.volume for o in obs], f32)),
            )
        if self._xform_dirty or self._wake_regions:
            items = [(s, o, hv) for s, (o, hv) in self._xform_dirty.items()
                     if s not in self._dirty]
            self._xform_dirty.clear()
            regs = self._wake_regions
            self._wake_regions = []
            centers = np.array([c for c, _ in regs], np.float32).reshape(-1, 3)
            radii = np.array([r for _, r in regs], np.float32)
            if items:
                vel = [(s, o) for s, o, hv in items if hv]
                f32 = np.float32
                self.state = _apply_transforms_wake(
                    self.state, self._dev(np.array([s for s, _, _ in items], np.int64)),
                    self._dev(np.stack([o.pos for _, o, _ in items]).astype(f32)),
                    self._dev(np.stack([o.rot for _, o, _ in items]).astype(f32)),
                    self._dev(np.array([s for s, _ in vel], np.int64)),
                    self._dev(np.array([o.linvel for _, o in vel], f32).reshape(-1, 3)),
                    self._dev(np.array([o.angvel for _, o in vel], f32).reshape(-1, 3)),
                    self._dev(centers), self._dev(radii))
            elif regs:
                self.state = _wake_in_regions(self.state, self._dev(centers),
                                              self._dev(radii))
        if self._vel_dirty:
            items = list(self._vel_dirty.items())
            self._vel_dirty.clear()
            self.state = _scatter_velocities(
                self.state, self._dev(np.array([s for s, _ in items], np.int64)),
                self._dev(np.stack([o.linvel for _, o in items]).astype(np.float32)),
                self._dev(np.stack([o.angvel for _, o in items]).astype(np.float32)))

    def set_state(self, state: BodyState):
        """Replace the device body state wholesale (for tools that write it
        on the device, such as a benchmark's velocity kick); the next think
        rebuilds the pair list and steps even if the world was asleep."""
        self.state = state
        self.invalidate_pairs()
        self._world_asleep = False

    def invalidate_pairs(self):
        """Force a broadphase rebuild at the next step."""
        self._force_pair_rebuild = True
        self.pair_cache = self.pair_cache.replace(
            steps_left=torch.zeros((), dtype=torch.int32, device=self.device))

    def _tier_config(self, tier: int) -> SimConfig:
        cfg = copy.copy(self._base_config)
        cfg.present_shape_types = self.config.present_shape_types
        div = self.TIER_DIVS[tier]
        if div > 1:
            cfg.max_pairs = max(512, self._base_config.max_pairs // div)
            cfg.max_active_contacts = max(
                1024, self._base_config.max_active_contacts // div)
        return cfg

    def _switch_tier(self, tier: int):
        self._tier = tier
        self._calm_steps = 0
        self.config = self._tier_config(tier)
        self.solver_cache = solver.empty_solver_cache(
            solver.cache_size_for(self.config), device=self.device)
        self.pair_cache = broadphase.empty_pair_cache(self.config, device=self.device)
        self._force_pair_rebuild = True

    def think(self, dt: float):
        """One substep.  Reads back one packed digest and nothing else."""
        had_mutations = bool(self._dirty or self._vel_dirty
                             or self._xform_dirty or self._wake_regions)
        # A fully asleep world skips the step: nothing can change on the
        # device without a host mutation.
        if self._world_asleep and not had_mutations and self._steps > 0:
            self.newly_activated_obs = set()
            self._steps += 1
            return self.last_events
        self._flush()
        if had_mutations:
            if self._structural_dirty:
                self.invalidate_pairs()
                self._structural_dirty = False
            self._world_asleep = False
        rebuild = self._force_pair_rebuild or self._host_steps_left <= 0
        self._force_pair_rebuild = False
        (self.state, self.solver_cache, self.pair_cache, events,
         diags) = physics_step(
            self.state, self.static_world, dt, self.params, self.config,
            self.solver_cache, self.pair_cache, rebuild_pairs=rebuild,
            has_oversize=bool(self._oversize_slots))
        self.last_events = events
        self.last_diags = diags
        self._steps += 1
        self._dispatch_digest(events, diags)
        return events

    def _dispatch_digest(self, events, diags):
        """Read the digest (the tick's one device -> host copy) and update
        the host bookkeeping from it."""
        digest = _event_digest(events, diags.num_contacts, diags.num_awake,
                               self.pair_cache.steps_left).cpu().numpy()
        self._host_steps_left = int(digest[_DIGEST_HEAD - 1])
        self._world_asleep = int(digest[199]) == 0
        self._refresh_activation_sets(events, digest)
        if self.auto_tier:
            self._update_tier_from_digest(digest)

    def think_with_player(self, dt: float, player, cur_time: float = 0.0):
        _not_ported("the fused serving tick (think_with_player)", _LATER)

    def set_pipelined(self, depth: int):
        if depth > 0:
            _not_ported("pipelined readback", _SLICE2)

    def _refresh_activation_sets(self, events, digest):
        n_up, n_down, n_wet, n_touch = (int(digest[192]), int(digest[193]),
                                        int(digest[194]), int(digest[195]))
        cap = self.config.capacity
        words = (cap + 31) // 32
        masks = digest[_DIGEST_HEAD:]
        up = (np.nonzero(_unpack_bits(masks[:words], cap))[0] if n_up > _EVK
              else digest[0:_EVK][:n_up])
        down = (np.nonzero(_unpack_bits(masks[words:2 * words], cap))[0]
                if n_down > _EVK else digest[_EVK:2 * _EVK][:n_down])
        self.newly_activated_obs = set()
        for slot in up:
            ob = self.objects.get(int(slot))
            if ob is not None:
                self.activated_obs.add(ob)
                self.newly_activated_obs.add(ob)
        for slot in down:
            ob = self.objects.get(int(slot))
            if ob is not None:
                self.activated_obs.discard(ob)
        if self.event_listener is not None:
            wet = (np.nonzero(_unpack_bits(masks[2 * words:3 * words], cap))[0]
                   if n_wet > _EVK else digest[2 * _EVK:3 * _EVK][:n_wet])
            for slot in wet:
                ob = self.objects.get(int(slot))
                if ob is not None and hasattr(self.event_listener,
                                              "physics_object_entered_water"):
                    self.event_listener.physics_object_entered_water(ob)
            if n_touch > 0 and hasattr(self.event_listener, "contact_added"):
                if n_touch > _EVT:
                    # More touching pairs than digest slots: a listener
                    # that wants them all costs a second readback.
                    touching = events.contact_touching.cpu().numpy()
                    pa = events.contact_pair_a.cpu().numpy()
                    pb = events.contact_pair_b.cpu().numpy()
                    pairs = [(int(pa[i]), int(pb[i])) for i in np.nonzero(touching)[0]]
                else:
                    tp = digest[200:200 + 2 * _EVT].reshape(_EVT, 2)[:n_touch]
                    pairs = [(int(a), int(b)) for a, b in tp]
                for sa, sb in pairs:
                    oa = self.objects.get(sa)
                    obj_b = self.objects.get(sb)
                    if oa is not None and obj_b is not None:
                        self.event_listener.contact_added(oa, obj_b)

    def _update_tier_from_digest(self, digest):
        over = int(digest[197])
        num_pairs = int(digest[196])
        num_contacts = int(digest[198])
        if over > 0:
            if self._tier > 0:
                self._switch_tier(0)
            self._calm_steps = 0
            return
        nxt = self._tier + 1
        if nxt >= len(self.TIER_DIVS):
            return
        ncfg = self._tier_config(nxt)
        if (num_pairs * self.TIER_HEADROOM < ncfg.max_pairs
                and num_contacts * self.TIER_HEADROOM < ncfg.max_active_contacts):
            self._calm_steps += 1
            if self._calm_steps >= self.TIER_CALM_STEPS:
                self._switch_tier(nxt)
        else:
            self._calm_steps = 0

    # ------------------------------------------------------------------
    # Readback
    # ------------------------------------------------------------------
    def sync_transforms(self):
        """Pull pos/rot/vel of all bodies into the host mirrors with one
        packed readback; rows unchanged since the last sync are skipped."""
        block = _transform_block(self.state).cpu().numpy()
        if self._nonstatic_objs is None:
            static = int(MotionType.STATIC)
            self._nonstatic_objs = [(slot, ob) for slot, ob in self.objects.items()
                                    if ob.motion_type != static]
        if (self._prev_sync_block is not None
                and self._prev_sync_block.shape == block.shape):
            changed = (block != self._prev_sync_block).any(axis=1)
        else:
            changed = np.ones((block.shape[0],), bool)
        self._prev_sync_block = block
        for slot, ob in self._nonstatic_objs:
            if changed[slot]:
                ob.pos = block[slot, 0:3]
                ob.rot = block[slot, 3:7]
                ob.linvel = block[slot, 7:10]
                ob.angvel = block[slot, 10:13]
                ob.underwater = bool(block[slot, 13] > 0)

    # ------------------------------------------------------------------
    # Ray queries (kernel KH)
    # ------------------------------------------------------------------
    def trace_ray(self, origin, direction, max_t: float, n_steps: int = 16):
        """Single-ray traceRay; returns (hit, t, normal, ob, material)."""
        self._flush()
        hits = queries.trace_rays(
            self._dev(np.asarray(origin, np.float32)[None]),
            self._dev(np.asarray(direction, np.float32)[None]),
            self._dev(np.array([max_t], np.float32)),
            self.state, self.static_world, self.config, n_steps=n_steps)
        hit, t, n, body, mat = (x.cpu().numpy() for x in (
            hits.hit, hits.t, hits.normal, hits.body, hits.material))
        return (bool(hit[0]), float(t[0]), n[0], self.objects.get(int(body[0])),
                int(mat[0]))

    def trace_rays_batched(self, origins, dirs, max_ts, n_steps: int = 16):
        self._flush()
        return queries.trace_rays(
            self._dev(np.asarray(origins, np.float32)), self._dev(np.asarray(dirs, np.float32)),
            self._dev(np.asarray(max_ts, np.float32)), self.state, self.static_world,
            self.config, n_steps=n_steps)

    def does_ray_hit_anything(self, origin, direction, max_t: float) -> bool:
        hit, *_ = self.trace_ray(origin, direction, max_t)
        return hit

    # ------------------------------------------------------------------
    # Not in this slice
    # ------------------------------------------------------------------
    def save_snapshot(self, path: str):
        _not_ported("snapshots", _SLICE2)

    def load_snapshot(self, path: str):
        _not_ported("snapshots", _SLICE2)

    # ------------------------------------------------------------------
    # Diagnostics
    # ------------------------------------------------------------------
    def get_diagnostics(self) -> str:
        d = self.last_diags
        lines = [f"PhysicsWorld: {len(self.objects)}/{self.config.capacity} objects, "
                 f"steps={self._steps}"]
        if d is not None:
            lines.append(
                f"  pairs={int(d.num_pairs)} contacts={int(d.num_contacts)} "
                f"awake={int(d.num_awake)} max_pen={float(d.max_penetration):.4f} "
                f"tier={self._tier} (pairs cap {self.config.max_pairs}, "
                f"contacts cap {self.config.max_active_contacts})")
        return "\n".join(lines)

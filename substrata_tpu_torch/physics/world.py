"""Host-side PhysicsWorld facade.

Counterpart of ``substrata_tpu/physics/world.py``: the same
``PhysicsWorld`` / ``PhysicsObject`` surface for the synchronous tick and
the fused serving tick.  The body state lives on ``device`` as a
``BodyState``; host mutations are queued and flushed as batched scatters
at the next tick (transform writes and wake regions through kernel KM),
and each tick reads back exactly one small packed array: ``think`` the
event digest (kernel KN), ``think_with_player`` the digest and the
character's packed vector in one buffer.

Static geometry: a base static trimesh and per-object static mesh
instances merge into one device trimesh, rebuilt at the next flush; a
static mesh object's identity lives on a virtual anchor (an id at or above
``capacity`` that owns triangles and resolves ray hits, with no device
slot).  Convex hulls are interned, by content, into the world's hull
library (64 hulls of 32 vertices and 32 faces), uploaded at the flush.

Pipelined mode (``set_pipelined``): the digest, the character's packed
vector and the transform block go through ``runtime.readback`` rings and
are consumed ``depth`` ticks late; slots the host wrote since are kept
from stale blocks.  Not in this slice (ROADMAP.md queue 1, item 3):
snapshots, which raise NotImplementedError naming the item.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import math
from dataclasses import dataclass, field as dfield
from typing import Any

import numpy as np
import torch

from substrata_tpu_torch.kernels import character as _kl
from substrata_tpu_torch.kernels import pairs
from substrata_tpu_torch.kernels import serving_io
from substrata_tpu_torch.physics import broadphase, queries, shapes as shape_factories, solver
from substrata_tpu_torch.physics.character import player_update_packed, tick_scalars
from substrata_tpu_torch.physics.state import (
    BodyState, Heightfield, HullLibrary, Layer, MotionType, ShapeType, SimConfig,
    SimParams, build_trimesh, default_sim_params, default_static_world, empty_trimesh,
    flat_heightfield, zero_body_state,
)
from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.physics.step import physics_step
from substrata_tpu_torch.runtime.readback import PipelinedReadback

USERDATA_WORLD_OBJECT = 0
USERDATA_PARCEL = 1
USERDATA_INSTANCE = 2
USERDATA_AVATAR = 3

_SLICE2 = "ROADMAP.md queue 1, item 3: facade completion"


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


def _clone(tree):
    """A copy of a dataclass of tensors whose tensors are copies too."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).clone() for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


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


def _serving_tick(body, static_world, params, config, solver_cache, pair_cache, char,
                  tick_in, dt: float, readback, rebuild_pairs: bool, has_oversize: bool):
    """The whole serving substep, as the reference fuses it into one device
    program (world.py:161-199): the host's transform writes and wake
    regions (KM), the character update (KL) on the written state, the
    world step, then the event digest and the transform block (KN).  The
    digest and the character's packed vector land in ``readback`` (int32:
    the digest, then the packed floats' bits), so the host reads both
    with one copy."""
    body = serving_io.apply_tick_in(body, tick_in)
    table = broadphase.build_cell_table(body, config)[0]
    d = serving_io.digest_len(body.capacity)
    char2, packed = player_update_packed(
        char, body, static_world, tick_in[:serving_io.TIN_SCAL], params, config, table=table,
        os_idx=queries.oversize_slots(body, config), out=readback[d:].view(torch.float32))
    body2, sc, pc, events, diags = physics_step(
        body, static_world, dt, params, config, solver_cache, pair_cache,
        rebuild_pairs=rebuild_pairs, has_oversize=has_oversize)
    digest, tblock = serving_io.digest_tblock(events, diags.num_contacts, diags.num_awake,
                                              pc.steps_left, body2, out=readback[:d])
    return body2, sc, pc, events, diags, char2, packed, digest, tblock


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

        # Static geometry: the base trimesh and the mesh instances, merged
        # into static_world.trimesh at the next flush.
        self._base_trimesh = None
        self._mesh_instances: dict[int, tuple] = {}
        self._next_mesh_instance = 1
        self._static_trimesh_dirty = False
        # The hull library (host-built, uploaded at the next flush) and the
        # content key of each interned hull.
        self._hull_host = dict(verts=np.zeros((64, 32, 3), np.float32),
                               n_verts=np.zeros((64,), np.int32),
                               planes=np.zeros((64, 32, 4), np.float32),
                               n_faces=np.zeros((64,), np.int32))
        self._hull_ids: dict = {}
        self._num_hulls = 0
        self._hulls_dirty = False
        self._next_virtual = self.config.capacity   # virtual anchor ids

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
        self.last_sync_changed = None    # [N] bool; consumers skip unchanged rows
        self._structural_dirty = False
        # The last serving tick's transform block (KN) and the state it
        # describes: sync_transforms reads it while the state is still that one.
        self._pending_tblock = None
        self._tblock_state = None
        # Pipelined readback (set_pipelined): the rings, the events of the
        # steps whose digests are in flight, and slot -> syncs to skip.
        self._digest_pipeline = None
        self._sync_pipeline = None
        self._pending_events: list = []
        self._mirror_skip: dict[int, int] = {}

    def set_pipelined(self, depth: int):
        """Depth-N pipelined readbacks (0 = synchronous).  The host consumes
        each step's event digest (with the character's packed vector) and
        transform block ``depth`` steps late; host-side event bookkeeping
        (wake/sleep sets, listeners, tier switches) lags by as much, and
        pair rebuilds run on ``config.pair_rebuild_interval`` instead of the
        window the device reports (mutations still force them)."""
        if depth > 0:
            self._digest_pipeline = PipelinedReadback(depth)
            self._sync_pipeline = PipelinedReadback(depth)
        else:
            self._digest_pipeline = None
            self._sync_pipeline = None
        self._pending_events = []
        self._mirror_skip = {}

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
        """The base (world) static trimesh, kept apart from the mesh
        instances; the merged trimesh is rebuilt now."""
        self._base_trimesh = (np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                              None if tri_mats is None else np.asarray(tri_mats, np.int32))
        self._rebuild_static_trimesh()

    def add_static_mesh_instance(self, verts, tris, tri_mats=None,
                                 owner_slot: int = -1) -> int:
        """One static mesh object's world-space triangles, owned by
        ``owner_slot`` (a ray hit on them resolves to that object).  All
        instances merge into one device trimesh at the next flush.
        Returns an instance id for ``remove_static_mesh_instance``."""
        inst_id = self._next_mesh_instance
        self._next_mesh_instance += 1
        nt = len(tris)
        self._mesh_instances[inst_id] = (
            np.asarray(verts, np.float32), np.asarray(tris, np.int32),
            np.zeros((nt,), np.int32) if tri_mats is None else np.asarray(tri_mats, np.int32),
            int(owner_slot))
        self._static_trimesh_dirty = True
        return inst_id

    def remove_static_mesh_instance(self, inst_id: int):
        """Drop an instance; bodies resting on its triangles wake (a wake
        region over its bounding sphere)."""
        inst = self._mesh_instances.pop(inst_id, None)
        if inst is not None:
            self._static_trimesh_dirty = True
            v = inst[0]
            if len(v):
                center = 0.5 * (v.min(axis=0) + v.max(axis=0))
                radius = float(np.linalg.norm(v.max(axis=0) - center))
                self._wake_regions.append((center, radius))

    def _rebuild_static_trimesh(self):
        self._static_trimesh_dirty = False
        parts = []
        if self._base_trimesh is not None:
            bv, bt, bm = self._base_trimesh
            parts.append((bv, bt, np.zeros((len(bt),), np.int32) if bm is None else bm, -1))
        parts.extend(self._mesh_instances.values())
        if not parts:
            self.static_world = self.static_world.replace(
                trimesh=empty_trimesh(device=self.device))
            return
        verts, tris, mats, owners = [], [], [], []
        off = 0
        for v, t, m, owner in parts:
            verts.append(v)
            tris.append(t + off)
            mats.append(m)
            owners.append(np.full((len(t),), owner, np.int32))
            off += len(v)
        self.static_world = self.static_world.replace(trimesh=build_trimesh(
            np.concatenate(verts), np.concatenate(tris), np.concatenate(mats),
            tri_owner=np.concatenate(owners), device=self.device))

    # ------------------------------------------------------------------
    # Object management
    # ------------------------------------------------------------------
    def add_object(self, ob: PhysicsObject) -> PhysicsObject:
        if not self._free:
            raise RuntimeError(f"PhysicsWorld at capacity {self.config.capacity}")
        if not np.allclose(ob.scale, 1.0):
            ob.shape = shape_factories.scaled(ob.shape, ob.scale)
        if ob.shape.shape_type == int(ShapeType.HULL) and ob.shape.hull_verts is not None:
            ob.shape.params[0] = self._intern_hull(ob.shape)
        slot = self._free.pop()
        ob.slot = slot
        self.objects[slot] = ob
        self._nonstatic_objs = None
        self._structural_dirty = True
        self._note_host_write(slot)
        self._dirty[slot] = (ob, True)
        st = int(ob.shape.shape_type)
        if not self.config.present_shape_types[st]:
            cfg = copy.copy(self.config)
            cfg.present_shape_types = tuple(
                p or (i == st) for i, p in enumerate(cfg.present_shape_types))
            self.config = cfg
        return ob

    def add_virtual_anchor(self, ob: PhysicsObject) -> PhysicsObject:
        """An identity-only object: an id in the virtual space (>= capacity)
        that owns static-trimesh triangles and resolves ray hits through
        ``self.objects``, with no device body slot."""
        vid = self._next_virtual
        self._next_virtual += 1
        ob.slot = vid
        self.objects[vid] = ob
        return ob

    def remove_object(self, ob: PhysicsObject):
        if ob.slot < 0:
            return
        if ob.slot >= self.config.capacity:      # virtual anchor
            self.objects.pop(ob.slot, None)
            ob.slot = -1
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

    def _intern_hull(self, shape) -> int:
        """The hull's library slot, by content (sha1 of its vertices and
        planes: objects instancing one model share one hull).  Vertices pad
        with the first vertex, planes with zeros."""
        key = hashlib.sha1(
            np.ascontiguousarray(shape.hull_verts).tobytes()
            + (np.ascontiguousarray(shape.hull_planes).tobytes()
               if shape.hull_planes is not None else b"")).digest()
        cached = self._hull_ids.get(key)
        if cached is not None:
            return cached
        lib = self._hull_host
        cap, mv, mf = lib["verts"].shape[0], lib["verts"].shape[1], lib["planes"].shape[1]
        if self._num_hulls >= cap:
            raise RuntimeError("hull library full")
        h = self._num_hulls
        self._hull_ids[key] = h
        v = shape.hull_verts[:mv]
        lib["verts"][h] = 0.0
        lib["verts"][h, :len(v)] = v
        if len(v) < mv:
            lib["verts"][h, len(v):] = v[0]
        lib["n_verts"][h] = len(v)
        pl = (shape.hull_planes[:mf] if shape.hull_planes is not None
              else np.zeros((0, 4), np.float32))
        lib["planes"][h] = 0.0
        lib["planes"][h, :len(pl)] = pl
        lib["n_faces"][h] = len(pl)
        self._hulls_dirty = True
        self._num_hulls += 1
        return h

    # ------------------------------------------------------------------
    # Transform / velocity setters
    # ------------------------------------------------------------------
    def set_new_ob_to_world_transform(self, ob: PhysicsObject, pos, rot,
                                      linvel=None, angvel=None, scale=None):
        if ob.slot >= self.config.capacity:      # virtual anchor: mirror only
            ob.pos = np.asarray(pos, np.float32)
            ob.rot = np.asarray(rot, np.float32)
            return
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
        self._note_host_write(ob.slot)
        if scale is not None and not np.allclose(scale, ob.scale):
            ob.scale = np.asarray(scale, np.float32)
            ob.shape = shape_factories.scaled(ob.shape, ob.scale)
            if ob.shape.shape_type == int(ShapeType.HULL) and ob.shape.hull_verts is not None:
                ob.shape.params[0] = self._intern_hull(ob.shape)
            self._dirty[ob.slot] = (ob, True)
        else:
            self._xform_dirty[ob.slot] = (ob, linvel is not None or angvel is not None)

    def set_new_ob_transforms_batch(self, obs, pos, rot, linvel, angvel):
        """``set_new_ob_to_world_transform`` for K objects at once, for the
        snapshot playback of remote objects: one vectorised pass makes the
        teleport-wake and pair-invalidation tests, then a loop writes the
        mirrors.  No scale or shape changes; velocities always given."""
        K = len(obs)
        if K == 0:
            return
        pos = np.asarray(pos, np.float32)
        rot = np.asarray(rot, np.float32)
        linvel = np.asarray(linvel, np.float32)
        angvel = np.asarray(angvel, np.float32)
        old_pos = np.stack([o.pos for o in obs])
        old_vel = np.stack([o.linvel for o in obs])
        brad = np.fromiter((o.shape.bound_radius for o in obs), np.float32, K)
        dist = np.linalg.norm(pos - old_pos, axis=1)
        teleport = dist > 0.5 * brad + 0.1
        window_travel = (np.linalg.norm(old_vel, axis=1)
                         * self.config.pair_rebuild_interval / 60.0)
        structural = ((dist > 0.08 + window_travel)
                      | (np.linalg.norm(linvel, axis=1)
                         > np.linalg.norm(old_vel, axis=1) + 0.25))
        if structural.any():
            self._structural_dirty = True
        for k in np.nonzero(teleport)[0]:
            self._wake_regions.append((old_pos[k].copy(), float(brad[k])))
        depth_skip = (self._sync_pipeline.depth + 1
                      if self._sync_pipeline is not None else None)
        cap = self.config.capacity
        for k, ob in enumerate(obs):
            ob.pos = pos[k]
            ob.rot = rot[k]
            ob.linvel = linvel[k]
            ob.angvel = angvel[k]
            s = ob.slot
            if s >= cap:           # virtual anchor: mirror only
                continue
            if depth_skip is not None:
                self._mirror_skip[s] = depth_skip
            self._xform_dirty[s] = (ob, True)

    def set_linear_and_angular_vel(self, ob: PhysicsObject, linvel, angvel,
                                   activate: bool = True):
        ob.linvel = np.asarray(linvel, np.float32)
        ob.angvel = np.asarray(angvel, np.float32)
        self._structural_dirty = True
        self._note_host_write(ob.slot)
        self._vel_dirty[ob.slot] = ob

    def _note_host_write(self, slot: int):
        """Pipelined mode: keep a host-written mirror from being regressed
        by the transform blocks still in flight (see sync_transforms).
        Virtual anchors have no device row to protect."""
        if self._sync_pipeline is not None and slot < self.config.capacity:
            self._mirror_skip[slot] = self._sync_pipeline.depth + 1

    def note_motion_type_changed(self, ob: PhysicsObject):
        """Callers that flip ob.motion_type directly must drop the cached
        list of non-static objects."""
        self._nonstatic_objs = None

    def move_kinematic_object(self, ob: PhysicsObject, pos, rot, dt):
        """MoveKinematic parity: velocities such that the body arrives at
        (pos, rot) after dt, so contacts feel the motion.  Host numpy only;
        the write goes out with the next tick's transform writes."""
        pos = np.asarray(pos, np.float32)
        rot = np.asarray(rot, np.float32)
        # A jump beyond the per-step margin budget, or a material speed-up,
        # invalidates the cached pairs (their margins were built slower).
        prev_speed = float(np.linalg.norm(ob.linvel))
        delta = float(np.linalg.norm(pos - ob.pos))
        ob.linvel = (pos - ob.pos) / max(dt, 1e-9)
        if (delta > prev_speed * dt + 0.08
                or float(np.linalg.norm(ob.linvel)) > prev_speed + 0.25):
            self._structural_dirty = True
        # Angular velocity from the delta quaternion rot * conj(ob.rot).
        r, c = rot, ob.rot
        cx, cy, cz, cw = -c[0], -c[1], -c[2], c[3]
        dq = np.array([
            r[3] * cx + r[0] * cw + r[1] * cz - r[2] * cy,
            r[3] * cy - r[0] * cz + r[1] * cw + r[2] * cx,
            r[3] * cz + r[0] * cy - r[1] * cx + r[2] * cw,
            r[3] * cw - r[0] * cx - r[1] * cy - r[2] * cz], np.float32)
        if dq[3] < 0.0:
            dq = -dq
        sin_half = float(np.linalg.norm(dq[:3]))
        angle = 2.0 * math.atan2(sin_half, float(dq[3]))
        axis = np.array([1.0, 0.0, 0.0], np.float32) if sin_half < 1e-8 else dq[:3] / sin_half
        ob.angvel = axis * np.float32(angle / max(dt, 1e-9))
        ob.pos = pos
        ob.rot = rot
        self._note_host_write(ob.slot)
        self._xform_dirty[ob.slot] = (ob, True)

    def activate_object(self, ob: PhysicsObject):
        self._vel_dirty[ob.slot] = ob

    # ------------------------------------------------------------------
    # Flush / think
    # ------------------------------------------------------------------
    def _dev(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _upload(self, buf: np.ndarray):
        """A host float32 buffer on the device: on the card through pinned
        memory with a non-blocking copy (no synchronisation; the caching
        host allocator keeps the block until the copy has run)."""
        t = torch.from_numpy(buf)
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _flush(self, defer_xforms: bool = False):
        """Upload pending host mutations as batched scatters.  With
        ``defer_xforms`` the transform writes and wake regions are returned
        as (items, regions) instead, when they fit one serving-tick input
        (128 writes, 64 regions)."""
        deferred = None
        if self._static_trimesh_dirty:
            self._rebuild_static_trimesh()
            # New static geometry can sit under sleeping bodies; a rebuild
            # is rare (stream-in, removal), so a full wake is fine.
            self.invalidate_pairs()
        if self._hulls_dirty:
            self.static_world = self.static_world.replace(hulls=HullLibrary(
                **{k: torch.as_tensor(v.copy(), device=self.device)
                   for k, v in self._hull_host.items()}))
            self._hulls_dirty = False
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
            if defer_xforms and len(items) <= serving_io.TIN_K and len(regs) <= serving_io.TIN_R:
                deferred = (items, regs)
            else:
                # As the reference's chunks: 128 writes and 64 regions each,
                # the rest padded (a padded region wakes every dynamic body).
                k, rk = serving_io.TIN_K, serving_io.TIN_R
                for c in range(max(-(-len(items) // k), -(-len(regs) // rk), 1)):
                    buf = serving_io.empty_tick_in(self.config.capacity)
                    serving_io.pack_writes(buf, items[c * k:(c + 1) * k],
                                           regs[c * rk:(c + 1) * rk])
                    self.state = serving_io.apply_tick_in(self.state, self._upload(buf))
        if self._vel_dirty:
            items = list(self._vel_dirty.items())
            self._vel_dirty.clear()
            self.state = _scatter_velocities(
                self.state, self._dev(np.array([s for s, _ in items], np.int64)),
                self._dev(np.stack([o.linvel for _, o in items]).astype(np.float32)),
                self._dev(np.stack([o.angvel for _, o in items]).astype(np.float32)))
        return deferred

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
        digest, _ = serving_io.digest_tblock(
            events, diags.num_contacts, diags.num_awake, self.pair_cache.steps_left,
            self.state, with_block=False)
        self._dispatch_digest(events, digest, rebuild)
        return events

    def _dispatch_digest(self, events, readback, rebuild, on_extra=None):
        """The tick's one copy back: ``readback`` holds the digest and, for
        the serving tick, the character's packed vector (``on_extra`` takes
        it as float32).  Read now, or, pipelined, push it and consume the
        one dispatched ``depth`` steps ago; the rebuild cadence then runs
        on the host from the config's interval."""
        d = serving_io.digest_len(self.config.capacity)
        if self._digest_pipeline is not None:
            self._host_steps_left = (self.config.pair_rebuild_interval - 1 if rebuild
                                     else self._host_steps_left - 1)
            self._pending_events.append((events, on_extra))
            host = self._digest_pipeline.push(readback)
            if host is None:
                self.newly_activated_obs = set()
                return
            events, on_extra = self._pending_events.pop(0)
        else:
            host = readback.cpu().numpy()
        self._read_digest(events, host[:d])
        if on_extra is not None:
            on_extra(host[d:].view(np.float32))

    def _read_digest(self, events, digest):
        """Update the host bookkeeping from a step's digest.  Pipelined, the
        world counts as fully asleep only once every step in flight has
        confirmed it."""
        if self._digest_pipeline is None:
            self._host_steps_left = int(digest[serving_io.DIGEST_HEAD - 1])
        self._world_asleep = int(digest[199]) == 0 and not self._pending_events
        self._refresh_activation_sets(events, digest)
        if self.auto_tier:
            self._update_tier_from_digest(digest)

    def think_with_player(self, dt: float, player, cur_time: float = 0.0):
        """``think`` with the player character: the pending transform writes
        and wake regions, the character update, the world step, the event
        digest and the transform block as one serving tick (the order of
        GUIClient.cpp:6418-6432).  The host makes one copy to the device
        (the packed tick input, from pinned memory) and one back (the digest
        and the character's packed vector in one buffer); ``player`` is a
        physics.character.PlayerPhysics."""
        had_mutations = bool(self._dirty or self._vel_dirty
                             or self._xform_dirty or self._wake_regions)
        # No fully-asleep skip: the player updates every tick.
        deferred = self._flush(defer_xforms=True)
        if had_mutations:
            if self._structural_dirty:
                self.invalidate_pairs()
                self._structural_dirty = False
            self._world_asleep = False
        rebuild = self._force_pair_rebuild or self._host_steps_left <= 0
        self._force_pair_rebuild = False
        cap = self.config.capacity
        buf = serving_io.empty_tick_in(cap)
        buf[:serving_io.TIN_SCAL] = player.tick_scalars(dt, cur_time)
        if deferred is not None:
            serving_io.pack_writes(buf, *deferred)
        d = serving_io.digest_len(cap)
        k = _kl.n_rows(self.config.cell_size, self.config.cell_capacity,
                       pairs.MAX_OVERSIZE)
        readback = torch.empty(d + _kl.N_PACKED_HEAD + k, dtype=torch.int32,
                               device=self.device)
        (self.state, self.solver_cache, self.pair_cache, events, diags, player.state,
         _packed, _digest, self._pending_tblock) = _serving_tick(
            self.state, self.static_world, self.params, self.config, self.solver_cache,
            self.pair_cache, player.state, self._upload(buf), float(dt), readback, rebuild,
            bool(self._oversize_slots))
        self._tblock_state = self.state
        self.last_events = events
        self.last_diags = diags
        self._steps += 1
        self._dispatch_digest(events, readback, rebuild, on_extra=player._consume_packed)
        player.zero_move_desired_vel()
        # The kinematic proxy follows the foot every tick.
        self.move_kinematic_object(player.proxy, player._capsule_center(), player.proxy.rot, dt)
        return events

    def prewarm_tiers(self, player=None, dt: float = 1 / 60.0):
        """Step every auto tier once, rebuild and reuse, on throwaway copies
        of the state (the reference compiles its tier ladder this way; the
        port has nothing to compile, but a tier's first step also sizes the
        allocator's blocks and Triton's specialisations).  With ``player``
        the fused serving tick runs, as a serving client ticks.  No live
        state changes."""
        if not self.auto_tier:
            return
        has_os = bool(self._oversize_slots)
        for tier in range(len(self.TIER_DIVS)):
            cfg = self._tier_config(tier)
            sc0 = solver.empty_solver_cache(solver.cache_size_for(cfg), device=self.device)
            pc0 = broadphase.empty_pair_cache(cfg, device=self.device)
            for rebuild in (True, False):
                if player is None:
                    physics_step(_clone(self.state), self.static_world, dt, self.params, cfg,
                                 _clone(sc0), _clone(pc0), rebuild_pairs=rebuild,
                                 has_oversize=has_os)
                    continue
                buf = serving_io.empty_tick_in(cfg.capacity)
                buf[:serving_io.TIN_SCAL] = tick_scalars(dt, np.zeros(3), False, False, False,
                                                         player.proxy.slot)
                k = _kl.n_rows(cfg.cell_size, cfg.cell_capacity, pairs.MAX_OVERSIZE)
                readback = torch.empty(serving_io.digest_len(cfg.capacity) + _kl.N_PACKED_HEAD
                                       + k, dtype=torch.int32, device=self.device)
                _serving_tick(_clone(self.state), self.static_world, self.params, cfg,
                              _clone(sc0), _clone(pc0), _clone(player.state), self._upload(buf),
                              float(dt), readback, rebuild, has_os)

    def _refresh_activation_sets(self, events, digest):
        n_up, n_down, n_wet, n_touch = (int(digest[192]), int(digest[193]),
                                        int(digest[194]), int(digest[195]))
        cap = self.config.capacity
        words = (cap + 31) // 32
        masks = digest[serving_io.DIGEST_HEAD:]
        evk, evt = serving_io.EVK, serving_io.EVT
        up = (np.nonzero(serving_io.unpack_bits(masks[:words], cap))[0] if n_up > evk
              else digest[0:evk][:n_up])
        down = (np.nonzero(serving_io.unpack_bits(masks[words:2 * words], cap))[0]
                if n_down > evk else digest[evk:2 * evk][:n_down])
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
            wet = (np.nonzero(serving_io.unpack_bits(masks[2 * words:3 * words], cap))[0]
                   if n_wet > evk else digest[2 * evk:3 * evk][:n_wet])
            for slot in wet:
                ob = self.objects.get(int(slot))
                if ob is not None and hasattr(self.event_listener,
                                              "physics_object_entered_water"):
                    self.event_listener.physics_object_entered_water(ob)
            if n_touch > 0 and hasattr(self.event_listener, "contact_added"):
                if n_touch > evt:
                    # More touching pairs than digest slots: a listener
                    # that wants them all costs a second readback.
                    touching = events.contact_touching.cpu().numpy()
                    pa = events.contact_pair_a.cpu().numpy()
                    pb = events.contact_pair_b.cpu().numpy()
                    pairs = [(int(pa[i]), int(pb[i])) for i in np.nonzero(touching)[0]]
                else:
                    tp = digest[200:200 + 2 * evt].reshape(evt, 2)[:n_touch]
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
        packed readback (the last serving tick's transform block while the
        state is still that tick's, else one packed now); rows unchanged
        since the last sync are skipped.

        Pipelined, the block consumed is the one dispatched ``depth`` syncs
        ago; slots the host wrote since (adds, kinematic moves, snapshot
        inserts) are skipped until the ring has caught up, so a
        host-authoritative mirror never regresses to a stale device value."""
        block_dev = (self._pending_tblock if self._tblock_state is self.state
                     else serving_io.transform_block(self.state))
        self._pending_tblock = self._tblock_state = None
        if self._sync_pipeline is not None:
            block = self._sync_pipeline.push(block_dev)
            if block is None:
                return
            for slot in list(self._mirror_skip):
                left = self._mirror_skip[slot] - 1
                if left <= 0:
                    del self._mirror_skip[slot]
                else:
                    self._mirror_skip[slot] = left
        else:
            block = block_dev.cpu().numpy()
        if self._nonstatic_objs is None:
            static = int(MotionType.STATIC)
            self._nonstatic_objs = [(slot, ob) for slot, ob in self.objects.items()
                                    if ob.motion_type != static]
        if (self._prev_sync_block is not None
                and self._prev_sync_block.shape == block.shape):
            changed = (block != self._prev_sync_block).any(axis=1)
        else:
            changed = np.ones((block.shape[0],), bool)
        skip = self._mirror_skip
        for slot in skip:
            changed[slot] = True
        self._prev_sync_block = block
        self.last_sync_changed = changed
        for slot, ob in self._nonstatic_objs:
            if changed[slot] and slot not in skip:
                ob.pos = block[slot, 0:3]
                ob.rot = block[slot, 3:7]
                ob.linvel = block[slot, 7:10]
                ob.angvel = block[slot, 10:13]
                ob.underwater = bool(block[slot, 13] > 0)

    def read_object_state(self, ob: PhysicsObject):
        """Synchronous live read of one body's (pos, rot, linvel, angvel),
        for rare mid-tick consumers."""
        self._flush()
        blk = serving_io.transform_block(self.state)[ob.slot].cpu().numpy()
        return blk[0:3], blk[3:7], blk[7:10], blk[10:13]

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
                 f"{self._num_hulls} hulls, steps={self._steps}"]
        if d is not None:
            lines.append(
                f"  pairs={int(d.num_pairs)} contacts={int(d.num_contacts)} "
                f"awake={int(d.num_awake)} max_pen={float(d.max_penetration):.4f} "
                f"tier={self._tier} (pairs cap {self.config.max_pairs}, "
                f"contacts cap {self.config.max_active_contacts})")
        return "\n".join(lines)

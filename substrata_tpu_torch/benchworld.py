"""The 10,000-box bench world (bench.py:105-154), its churn kick
(bench.py:212-221), the 256-source audio scene of bench.py:83-102 and the
character, vehicles, particles and Winter scripts of bench.py:157-209,
rebuilt on the port for chip_smoke.py and profile_tick.py; the coupled
physics + audio tick of bench.py's window 2 (bench.py:337-341), the full
tick of its window 3 (bench.py:311-342), the serving world: the bench world
with a walking player through ``PhysicsWorld.think_with_player``, and the
12,000-object mesh world of tools/bench_networked.py (BASELINE.json
config 5) with the client's frame: ``think_with_player`` and the audio
occlusion rays (substrata_tpu/client_app.py:916-945); and BASELINE.json's
config 4, 10,000 particles over heightfield terrain with TerrainSystem LOD
and TerrainScattering, plus 64 posed avatars, through the client frame's
terrain, avatar and particle steps (``terrain_world``, ``terrain_tick``);
and the client's own frame, ``ClientApp.timer_event`` with three audio
blocks, over config 5's world loaded through ``create_object`` with 256
sources, 8 vehicles, 512 Winter objects, 4 path platforms and 8 Lua
objects (``client_world``, ``client_tick``)."""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
import wave

import numpy as np
import torch

from substrata_tpu_torch.avatar_graphics import AvatarGraphicsManager
from substrata_tpu_torch.audio.mix import (default_listener, mix_block, room_from_aabb,
                                           zero_sources)
from substrata_tpu_torch.client_app import ClientApp, PlayerInput
from substrata_tpu_torch.kernels import winter as kwinter
from substrata_tpu_torch.physics import broadphase, queries, shapes
from substrata_tpu_torch.physics.character import (EYE_HEIGHT, PlayerPhysics,
                                                   init_character_state, player_update_packed,
                                                   tick_scalars)
from substrata_tpu_torch.physics.particles import ParticleManager, particles_step, zero_particles
from substrata_tpu_torch.physics.state import MotionType, SimConfig
from substrata_tpu_torch.physics.terrain import TerrainScattering, TerrainSystem
from substrata_tpu_torch.physics.vehicles.manager import (
    BikePhysics, BoatPhysics, CarPhysics, HoverCarPhysics, VehicleInputs, VehicleManager,
    _apply_vehicle_deltas, vehicles_update)
from substrata_tpu_torch.physics.world import PhysicsObject, PhysicsWorld
from substrata_tpu_torch.scripting import WinterScriptEvaluator
from substrata_tpu_torch.shared.avatar import Avatar
from substrata_tpu_torch.shared.bmesh import write_bmesh
from substrata_tpu_torch.shared.world_object import WorldObject

N_BODIES = 10_000
N_SOURCES = 256
N_PARTICLES = 2048    # the reference's own cap (ParticleManager.cpp:88)
N_VEHICLES = 8        # two each of car, bike, boat, hovercar
N_WINTER = 512        # bench.py:69: 256 instances of each of 2 sources
WINTER_SOURCES = (    # bench.py:192-198
    "def evalRotation(float time, WinterEnv env) vec3 : "
    "vec3(0.0, 0.0, time * 0.5 + env.instance_index)",
    "def evalTranslation(float time, WinterEnv env) vec3 : "
    "vec3(sin(time) * 2.0, cos(time * 0.7) * 2.0, 0.0)")
N_OBJECTS = 12_000    # tools/bench_networked.py:37-38
N_DYNAMIC = 512
AUDIBLE_DIST = 100.0             # client_app.py:66-67
AUDIO_OCCLUSION_MAX_DIST = 60.0
# The unit cube of tools/bench_networked.py:93-97 (its "cube.bmesh").
CUBE_VERTS = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)],
                      np.float32)
CUBE_TRIS = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                     np.int32)
DT = 1.0 / 60.0
TICK_FRAMES = 800     # 48 kHz / 60 Hz: one tick of audio per step
POOL_SAMPLES = 1 << 20


def bench_config() -> SimConfig:
    return SimConfig(capacity=10_240, max_pairs=16_384, grid_dim=128, cell_size=1.4,
                     cell_capacity=6, solver_iters=7, pairs_per_body=10,
                     pair_rebuild_interval=6, max_active_contacts=36_864,
                     contacts_per_body=8)


def bench_world(device, n_bodies: int = N_BODIES, cfg: SimConfig | None = None):
    """Boxes of half-extent 0.4 in 3 layers over ~70 x 70 m on a ground
    plane, positions from seed 0."""
    w = PhysicsWorld(cfg or bench_config(), device=device)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    layers = 3
    side = int(np.ceil((n_bodies / layers) ** 0.5))
    n = 0
    for iz in range(layers):
        for ix in range(side):
            for iy in range(side):
                if n >= n_bodies:
                    break
                pos = np.array([(ix - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                                (iy - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                                0.6 + iz * 1.2], np.float32)
                w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]),
                                           pos=pos, motion_type=int(MotionType.DYNAMIC)))
                n += 1
    return w


def kick(state, gen: torch.Generator):
    """Random velocity kick in [-1.5, 1.5] m/s (z halved) to every dynamic
    body, and a full wake."""
    k = torch.rand(state.linvel.shape, generator=gen, device=state.linvel.device) * 3.0 - 1.5
    k[:, 2] *= 0.5
    dyn = state.alive & state.dynamic
    return state.replace(linvel=torch.where(dyn[:, None], state.linvel + k, state.linvel),
                         awake=state.awake | dyn,
                         sleep_timer=torch.where(dyn, 0.0, state.sleep_timer))


def bench_audio(device, n_sources: int = N_SOURCES):
    """256 looping spatial sources on the full-quality path (HRIR + room
    reverb): a sin(0.03 i) pool of 2^20 samples, offsets and rates in
    [0.8, 1.25] from seed 1, 20% of the sources occluded, and the room of
    a 120 x 120 x 10 m box.  Returns (sources, pool, listener, room)."""
    rng = np.random.default_rng(1)
    src = zero_sources(n_sources, device=device)
    pool = torch.as_tensor(np.sin(np.arange(POOL_SAMPLES) * 0.03).astype(np.float32),
                           device=device)
    offsets = rng.integers(0, POOL_SAMPLES - 48000, n_sources)
    buf_offset, buf_len, delta = src.buf_offset.clone(), src.buf_len.clone(), src.delta.clone()
    buf_offset[:, 0] = torch.as_tensor(offsets.astype(np.int32), device=device)
    buf_len[:, 0] = 48000
    delta[:, 0] = torch.as_tensor(rng.uniform(0.8, 1.25, n_sources).astype(np.float32),
                                  device=device)
    occ = (rng.random(n_sources) < 0.2).astype(np.float32)
    src = src.replace(alive=torch.ones_like(src.alive), looping=torch.ones_like(src.looping),
                      buf_offset=buf_offset, buf_len=buf_len, delta=delta,
                      num_occlusions=torch.as_tensor(occ, device=device))
    room = room_from_aabb([-60, -60, 0], [60, 60, 10], 0.6, device=device)
    return src, pool, default_listener(device=device), room


def physics_audio_tick(world, src, pool, listener, room, src_idx):
    """One tick of bench.py's window 2: ``think``, then the sources follow
    bodies ``src_idx`` (position and velocity, gathered on the device) and
    one tick of audio (800 frames, HRIR on, room on) is mixed.  Returns
    (sources, out [800, 2], room); the digest read of ``think`` is the
    tick's only device -> host copy."""
    world.think(DT)
    st = world.state
    src = src.replace(pos=st.pos[src_idx], vel=st.linvel[src_idx])
    return mix_block(src, pool, listener, room=room, use_hrtf=True, block=TICK_FRAMES)


class BenchScripts:
    """bench.py:192-207's Winter batch: both sources over the 256 float32
    instance indices ``widx`` (as int32, as the reference takes them) with
    ``num_instances`` 512, in ONE ``kernels.winter.Batch`` (uploaded
    once), so a tick's evaluation is one KR launch and adds no copy."""

    def __init__(self, device, n_winter: int = N_WINTER):
        half = n_winter // 2
        codes = [WinterScriptEvaluator(src, device=device).code() for src in WINTER_SOURCES]
        self.batch = kwinter.Batch([c for c, _ in codes], [r for _, r in codes],
                                   [(0, half), (half, half)], device)
        widx = kwinter.to_int32(torch.arange(half, dtype=torch.float32, device=device))
        self.idx = torch.cat([widx, widx])
        self.n_inst = torch.full((n_winter,), n_winter, dtype=torch.int32, device=device)
        self.out = None

    def time(self, t: float) -> torch.Tensor:
        return torch.full((self.batch.size,), float(np.float32(t)), dtype=torch.float32,
                          device=self.idx.device)

    def evaluate(self, t: float) -> torch.Tensor:
        """[512, 6]: each instance's axis-angle rotation and translation
        at time t (a source without a hook gives zeros there)."""
        self.out = kwinter.winter_eval(self.batch, self.time(t), self.idx, self.n_inst)
        return self.out


def bench_fulltick(world, device, n_particles: int = N_PARTICLES,
                   n_vehicles: int = N_VEHICLES):
    """bench.py:157-209: vehicles of the four types in turn on the first
    ``n_vehicles`` bodies, all driven with forward 0.6 and right 0.15
    (inputs built once, on the device), ``n_particles`` bouncing particles
    from seed 3 in a 70 x 70 x 7 m box, the character at eye (0, 0, 3)
    (bench.py:168; no proxy body, as there) and the Winter batch.
    Returns (vehicle arrays, vehicle inputs, particles, character,
    BenchScripts)."""
    vm = VehicleManager(world, capacity=n_vehicles)
    classes = [CarPhysics, BikePhysics, BoatPhysics, HoverCarPhysics]
    first = [world.objects[s] for s in sorted(world.objects)[:n_vehicles]]
    for i in range(n_vehicles):
        classes[i % 4](vm, first[i])
        vm.set_active(i, True)
    f = dict(dtype=torch.float32, device=device)
    vinputs = VehicleInputs(
        forward=torch.full((n_vehicles,), 0.6, **f), right=torch.full((n_vehicles,), 0.15, **f),
        up=torch.zeros((n_vehicles,), **f),
        brake=torch.zeros((n_vehicles,), dtype=torch.bool, device=device),
        handbrake=torch.zeros((n_vehicles,), dtype=torch.bool, device=device))
    rng = np.random.default_rng(3)
    ps = zero_particles(n_particles, device=device)
    ps = ps.replace(
        pos=torch.as_tensor(rng.uniform([-35, -35, 1], [35, 35, 8], (n_particles, 3))
                            .astype(np.float32), device=device),
        vel=torch.as_tensor(rng.normal(0, 2, (n_particles, 3)).astype(np.float32),
                            device=device),
        opacity=torch.ones_like(ps.opacity),
        alive=torch.ones_like(ps.alive))   # die_on_hit False: they bounce forever
    return (vm.veh, vinputs, ps, init_character_state([0.0, 0.0, 3.0], device=device),
            BenchScripts(device))


def walk_dir(t: float) -> np.ndarray:
    """The bench's walking direction at time t, (cos 0.3t, sin 0.3t, 0),
    in float32 as bench.py:322-323 computes it."""
    a = np.float32(0.3) * np.float32(t)
    return np.array([np.cos(a), np.sin(a), 0.0], np.float32)


def walk_input(t: float) -> np.ndarray:
    """The bench's walking player: full speed (3 m/s) along walk_dir(t)."""
    return np.float32(3.0) * walk_dir(t)


def full_tick(world, veh, vinputs, ps, src, pool, listener, room, src_idx, char, t: float,
              scripts: BenchScripts):
    """One tick of bench.py's window 3 (bench.py:311-342): one cell table
    shared by the wheel rays, the character and the particle rays, the
    vehicles and their velocity deltas, the character walking at time
    ``t`` (no jump, fly or sit, no excluded body), ``think``, the
    particles, the Winter batch at time ``t`` (its [512, 6] result stays
    on the device, in ``scripts.out``), the sources following bodies
    ``src_idx``, and one tick of audio.  Returns (veh, particles,
    sources, out [800, 2], room, character); the character's 8 scalars go
    up with a non-blocking copy, and the digest read of ``think`` is the
    tick's only device -> host copy.  ``char=None`` leaves the character
    out."""
    world._flush()
    cfg = world.config
    table, _, _ = broadphase.build_cell_table(world.state, cfg)
    veh, dv, dw, slots = vehicles_update(veh, vinputs, world.state, world.static_world, DT,
                                         world.params, cfg, table=table)
    world.state = _apply_vehicle_deltas(world.state, slots, dv, dw)
    if char is not None:
        scal = world._upload(tick_scalars(DT, walk_input(t), False, False, False, -1))
        char, _packed = player_update_packed(char, world.state, world.static_world, scal,
                                             world.params, cfg, table=table,
                                             os_idx=queries.oversize_slots(world.state, cfg))
    world._world_asleep = False       # driven chassis must step
    world.think(DT)
    st = world.state
    ps, _foam = particles_step(ps, st, world.static_world, DT, world.params, cfg, table=table)
    scripts.evaluate(t)
    src = src.replace(pos=st.pos[src_idx], vel=st.linvel[src_idx])
    src, out, room = mix_block(src, pool, listener, room=room, use_hrtf=True, block=TICK_FRAMES)
    return veh, ps, src, out, room, char


def serving_world(device, n_bodies: int = N_BODIES, cfg: SimConfig | None = None,
                  eye_pos=(0.0, 0.0, 1.67)):
    """The bench world and one PlayerPhysics at ``eye_pos`` (eye height at
    the origin, inside the pile, by default), whose kinematic capsule proxy
    makes the world mixed (box-box, box-capsule, capsule-capsule combos:
    the compacted contact layout).  Returns (world, player)."""
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    return w, PlayerPhysics(w, eye_pos=eye_pos)


def serving_tick(world, player, t: float):
    """One serving tick: the player walks as the bench's character does
    (bench.py:322-323) and ``think_with_player`` runs the fused tick."""
    player.process_move(walk_dir(t))
    return world.think_with_player(DT, player, cur_time=t)


def mesh_config() -> SimConfig:
    """tools/bench_networked.py:79-80."""
    return SimConfig(capacity=4_096, max_pairs=8_192, grid_dim=64, cell_size=4.0,
                     solver_iters=7, pair_rebuild_interval=6)


def mesh_layout(n_objects: int = N_OBJECTS, n_dynamic: int = N_DYNAMIC) -> np.ndarray:
    """The objects' positions [n_objects, 3] (float64) in the reference's
    rng call order (tools/bench_networked.py:57-64): x, y, then z U(2, 6)
    for a dynamic object; a static one draws no third number."""
    rng = np.random.default_rng(0)
    return np.array([[rng.uniform(-180, 180), rng.uniform(-180, 180),
                      0.4 if i >= n_dynamic else rng.uniform(2, 6)]
                     for i in range(n_objects)])


def mesh_triangles(n_objects: int = N_OBJECTS, n_dynamic: int = N_DYNAMIC):
    """The static cubes' world-space triangles as the world merges them:
    (verts [8 S, 3] f32, tris [12 S, 3] i32)."""
    pos = mesh_layout(n_objects, n_dynamic)[n_dynamic:].astype(np.float32)
    verts = (CUBE_VERTS[None] + pos[:, None]).reshape(-1, 3)
    tris = (CUBE_TRIS[None] + 8 * np.arange(len(pos), dtype=np.int32)[:, None, None])
    return verts, tris.reshape(-1, 3)


def mesh_world(device, n_objects: int = N_OBJECTS, n_dynamic: int = N_DYNAMIC,
               cfg: SimConfig | None = None):
    """The mesh world of tools/bench_networked.py:57-64 and :93-98, loaded as
    ClientApp._load_physics_for_object loads it (client_app.py:241-297):
    ``n_objects`` unit cubes at xy U(±180) from seed 0, the first
    ``n_dynamic`` at z U(2, 6) as convex hulls of the cube (mass 50, the
    WorldObject default; friction 0.5, restitution 0.2), the rest at z = 0.4
    as world-space triangles of the static trimesh, each owned by a virtual
    anchor; the ground plane at z = 0 (client_app.py:111) and one
    PlayerPhysics at eye (0, 0, 1.67).  Returns (world, player, the
    dynamic bodies' slots on the device: the occlusion rays' sources)."""
    w = PhysicsWorld(cfg or mesh_config(), device=device)
    w.set_ground_plane(0.0)
    hull = shapes.make_convex_hull(CUBE_VERTS, mass=50.0)
    anchor_shape = shapes.make_box([0.05, 0.05, 0.05])
    ident = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    mats = np.zeros((len(CUBE_TRIS),), np.int32)
    slots = []
    for i, pos in enumerate(mesh_layout(n_objects, n_dynamic)):
        dyn = i < n_dynamic
        shape = hull if dyn else anchor_shape
        body_pos, body_rot = shape.body_pose_from_mesh(pos, ident)
        ob = PhysicsObject(shape=shape, pos=body_pos, rot=body_rot,
                           motion_type=int(MotionType.DYNAMIC if dyn else MotionType.STATIC),
                           friction=0.5, restitution=0.2, collidable=dyn)
        if dyn:
            slots.append(w.add_object(ob).slot)
        else:
            anchor = w.add_virtual_anchor(ob)
            w.add_static_mesh_instance(CUBE_VERTS + np.asarray(pos, np.float32), CUBE_TRIS,
                                       mats, owner_slot=anchor.slot)
    player = PlayerPhysics(w, eye_pos=(0.0, 0.0, EYE_HEIGHT))
    return w, player, torch.as_tensor(np.array(slots, np.int64), device=device)


def occlusion_rays(cam, src_pos):
    """The client's audio-occlusion rays (client_app.py:924-936), one per
    source, built on the device: from the camera ``cam`` [3] toward each
    source, ``max_t = min(max(d - 1, 0), 60)``; a source beyond 100 m or
    nearer than 1e-3 m gets ``max_t = 0`` and ``keep`` False.  Returns
    (origins, dirs, max_ts, keep)."""
    to = src_pos - cam[None, :]
    d = torch.sqrt(to[:, 0] * to[:, 0] + to[:, 1] * to[:, 1] + to[:, 2] * to[:, 2])
    keep = (d <= AUDIBLE_DIST) & (d >= 1e-3)
    dirs = to / torch.clamp(d, min=1e-3)[:, None]
    max_ts = torch.where(keep, torch.clamp(torch.clamp(d - 1.0, min=0.0),
                                           max=AUDIO_OCCLUSION_MAX_DIST), 0.0)
    return cam[None, :].expand_as(to).contiguous(), dirs.contiguous(), max_ts, keep


def mesh_tick(world, player, t: float, sources):
    """The client's frame on the mesh world: the player walks as the
    bench's does (``serving_tick``), then the audio-occlusion pass traces
    one ray (``n_steps=16``) from the camera (the character's eye, on the
    device) to each source body ``sources`` and reads the masked hit mask
    back once, as client_app.py:940 does.  Returns (events, hit [S] numpy
    bool)."""
    events = serving_tick(world, player, t)
    ch = player.state
    cam = torch.cat([ch.pos[:2], (ch.pos[2:] + EYE_HEIGHT) - ch.campos_z_delta[None]])
    o, d, mt, keep = occlusion_rays(cam, world.state.pos[sources])
    hits = queries.trace_rays(o, d, mt, world.state, world.static_world, world.config,
                              n_steps=16)
    return events, (hits.hit & keep).cpu().numpy()


# ---------------------------------------------------------------------------
# BASELINE.json config 4: particles over heightfield terrain, plus avatars.
# ---------------------------------------------------------------------------

TERRAIN_RES = 1025        # 1 m cells over TerrainSystem's default 1024 m
TERRAIN_EXTENT = 1024.0
N_BURST = 10_000          # BASELINE config 4's 10k particles
N_STREAM = 84             # a frame's new particles from frame 1 (2 s lives)
N_AVATARS = 64
MOVE_EVERY = 30           # the camera jumps 40 m along +x every 30 frames
MOVE_DIST = 40.0
BURST_RADIUS = 50.0


def terrain_config() -> SimConfig:
    """ClientApp's world (substrata_tpu/client_app.py:105-107)."""
    return SimConfig(capacity=16_384 // 2, max_pairs=16_384, grid_dim=96, cell_size=4.0)


def terrain_heightmap(res: int = TERRAIN_RES, extent: float = TERRAIN_EXTENT, seed: int = 0):
    """tests/test_terrain.py's hills over ``extent`` at ``res``^2 samples
    plus seeded noise (sigma 5 cm).  Returns (heights [res, res] f32,
    cell_w, origin [2] f32)."""
    xs = np.linspace(-extent / 2, extent / 2, res)
    h = np.sin(xs[:, None] * 0.05) * np.cos(xs[None, :] * 0.03) * 8.0
    h = h + np.random.default_rng(seed).normal(0.0, 0.05, (res, res))
    return (h.astype(np.float32), float(extent / (res - 1)),
            np.array([-extent / 2, -extent / 2], np.float32))


def host_height(heights, origin, cell_w, x, y):
    """The bilinear height at world (x, y) on the host, in float64: where
    the scene's host code (the emitter, the avatars' feed, the camera
    jumps) puts things on the ground without a device read."""
    hx, hy = heights.shape
    u = np.clip((np.asarray(x, np.float64) - origin[0]) / cell_w, 0.0, hx - 1.001)
    v = np.clip((np.asarray(y, np.float64) - origin[1]) / cell_w, 0.0, hy - 1.001)
    i0, j0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    fu, fv = u - i0, v - j0
    h00, h10 = heights[i0, j0].astype(np.float64), heights[i0 + 1, j0].astype(np.float64)
    h01, h11 = heights[i0, j0 + 1].astype(np.float64), heights[i0 + 1, j0 + 1].astype(np.float64)
    return (h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv)
            + h01 * (1 - fu) * fv + h11 * fu * fv)


@dataclasses.dataclass
class TerrainScene:
    """The client frame's objects for BASELINE config 4 (the fields a
    ``ClientApp`` holds: client_app.py:108-121), the avatars and their
    scripted motion, and the particle emitter's generator."""

    world: object
    player: object
    terrain: object
    scattering: object
    particles: object
    graphics: object
    avatars: list
    motion: np.ndarray        # [A, 3]: speed (m/s), heading at t = 0, turn rate (rad/s)
    heights: np.ndarray
    origin: np.ndarray
    cell_w: float
    rng: np.random.Generator
    n_burst: int
    n_stream: int


def terrain_world(device, res: int = TERRAIN_RES, n_burst: int = N_BURST,
                  n_stream: int = N_STREAM, n_avatars: int = N_AVATARS,
                  cfg: SimConfig | None = None, seed: int = 0) -> TerrainScene:
    """BASELINE config 4 at full width, built as ClientApp builds its
    client (client_app.py:105-121): the world with ClientApp's SimConfig
    and ground plane, TerrainSystem (chunk_res 16, MAX_DEPTH 6),
    TerrainScattering (32 m cells, radius 4, 64 points, seed 1234) whose
    trees are static capsules (at most 16 per cell, tests/test_terrain.py:
    112-116), ParticleManager (16,384 slots), the player at the origin and
    AvatarGraphicsManager; then ``populate_terrain_scene``: a ``res``^2
    heightmap at 1 m cells (at the default size), the walking player on
    it, ``n_avatars`` avatars around it."""
    w = PhysicsWorld(cfg or terrain_config(), device=device)
    w.set_ground_plane(0.0)
    terrain = TerrainSystem(w)
    scattering = TerrainScattering(terrain)
    particles = ParticleManager(w)
    player = PlayerPhysics(w, eye_pos=(0.0, 0.0, EYE_HEIGHT))
    graphics = AvatarGraphicsManager(device=device)

    def make_tree(pos, scale):
        return w.add_object(PhysicsObject(
            shape=shapes.make_capsule(0.2 * scale, 1.5 * scale),
            pos=np.asarray(pos, np.float32) + np.array([0, 0, 1.7], np.float32),
            motion_type=int(MotionType.STATIC)))

    scattering.make_tree_physics = make_tree
    return populate_terrain_scene(w, player, terrain, scattering, particles, graphics, Avatar,
                                  res=res, n_burst=n_burst, n_stream=n_stream,
                                  n_avatars=n_avatars, seed=seed)


def populate_terrain_scene(world, player, terrain, scattering, particles, graphics,
                           avatar_cls, res: int = TERRAIN_RES, n_burst: int = N_BURST,
                           n_stream: int = N_STREAM, n_avatars: int = N_AVATARS,
                           seed: int = 0) -> TerrainScene:
    """Load the heightmap of ``terrain_heightmap(res, seed=seed)`` (1,024 m
    wide: 1 m cells at res 1025, 8 m at 129), stand the player on it and place the
    avatars, through the facades' public methods only (the tests hand the
    reference package's objects to it too).  Avatar i sits on a ring 5-30
    m around the player: every fourth idles, the others walk (1.2-2 m/s)
    or run (7 m/s) along slowly turning headings; avatar 0 sits on a seat
    (a sitting constraint) and avatar 1 waves."""
    h, cw, origin = terrain_heightmap(res, seed=seed)
    terrain.set_heightmap(h, origin, cw)
    z0 = float(host_height(h, origin, cw, 0.0, 0.0))
    player.set_position([0.0, 0.0, z0 + 0.05 + EYE_HEIGHT])
    rng = np.random.default_rng(seed + 1)
    motion = np.zeros((n_avatars, 3))
    avatars = []
    for i in range(n_avatars):
        r, a = rng.uniform(5.0, 30.0), rng.uniform(0.0, 2 * np.pi)
        kind = i % 4
        speed = 0.0 if kind == 0 else (7.0 if kind == 2 else rng.uniform(1.2, 2.0))
        motion[i] = (speed, rng.uniform(0.0, 2 * np.pi), rng.uniform(-0.3, 0.3))
        av = avatar_cls(uid=i + 1, name=f"avatar{i}")
        x, y = r * math.cos(a), r * math.sin(a)
        av.pos = np.array([x, y, float(host_height(h, origin, cw, x, y)) + EYE_HEIGHT])
        av.rotation = np.array([0.0, 0.0, motion[i, 1]])
        av.anim_state = 0
        av.entered_vehicle_uid = 1 if i == 0 else 0
        avatars.append(av)
        graphics.update_avatar(av, 0.0)
    seated = graphics.by_uid[1]
    pc = seated.pose_constraint
    seat = np.eye(4, dtype=np.float32)
    seat[:3, 3] = avatars[0].pos - np.array([0.0, 0.0, EYE_HEIGHT - 0.45])
    pc.seat_to_world = seat
    pc.upper_body_rot_angle, pc.upper_leg_rot_angle, pc.lower_leg_rot_angle = 0.1, 1.3, -0.5
    if n_avatars > 1:
        graphics.by_uid[2].perform_gesture("Wave")
    return TerrainScene(world=world, player=player, terrain=terrain, scattering=scattering,
                        particles=particles, graphics=graphics, avatars=avatars, motion=motion,
                        heights=h, origin=origin, cell_w=cw,
                        rng=np.random.default_rng(seed + 2), n_burst=n_burst,
                        n_stream=n_stream)


def emit_particles(scene: TerrainScene, frame: int, centre):
    """The frame's spawns: ``n_burst`` at frame 0, ``n_stream`` after, in a
    50 m disc around ``centre``, 2-20 m above the terrain, velocities
    within +-5 m/s; a burst particle lives U(0, 2) s, a stream one 2 s
    (opacity 1 fading at -1 / life)."""
    n = scene.n_burst if frame == 0 else scene.n_stream
    rng = scene.rng
    r = BURST_RADIUS * np.sqrt(rng.random(n))
    a = rng.uniform(0.0, 2 * np.pi, n)
    x, y = centre[0] + r * np.cos(a), centre[1] + r * np.sin(a)
    z = host_height(scene.heights, scene.origin, scene.cell_w, x, y) + rng.uniform(2.0, 20.0, n)
    vel = rng.uniform(-5.0, 5.0, (n, 3))
    life = np.maximum(rng.uniform(0.0, 2.0, n), 1e-3) if frame == 0 else np.full(n, 2.0)
    for i in range(n):
        scene.particles.add_particle(pos=[x[i], y[i], z[i]], vel=vel[i], opacity=1.0,
                                     dopacity_dt=-1.0 / life[i])


def move_avatars(scene: TerrainScene, t: float):
    """Each avatar along its heading at time ``t`` (heading0 + rate t), on
    the terrain (the feed a client receives from the server)."""
    for av, (speed, h0, rate) in zip(scene.avatars, scene.motion):
        heading = h0 + rate * t
        x = av.pos[0] + speed * DT * math.cos(heading)
        y = av.pos[1] + speed * DT * math.sin(heading)
        z = float(host_height(scene.heights, scene.origin, scene.cell_w, x, y)) + EYE_HEIGHT
        av.pos = np.array([x, y, z])
        av.rotation = np.array([0.0, 0.0, heading])


def terrain_tick(scene: TerrainScene, frame: int):
    """One client frame of BASELINE config 4 in ``ClientApp.timer_event``'s
    order (client_app.py:548-660): the player walks as the bench's does
    (its camera jumps 40 m along +x every 30 frames), ``think_with_player``;
    the terrain clamp (one height read, :575-580); every avatar's state
    machine, then ONE ``pose_all`` (:596-601, :947-980); the frame's
    particle spawns and ``particles.think`` (:640-642); terrain LOD and
    scattering around the camera (:656-660).  Returns the camera [4]."""
    p, t = scene.player, frame * DT
    if frame > 0 and frame % MOVE_EVERY == 0:
        eye = p.get_eye_position()
        x, y = float(eye[0]) + MOVE_DIST, float(eye[1])
        z = float(host_height(scene.heights, scene.origin, scene.cell_w, x, y))
        p.set_position([x, y, z + 0.05 + EYE_HEIGHT])
    p.process_move(walk_dir(t))
    scene.world.think_with_player(DT, p, cur_time=t)
    cam = p._last_campos.copy()
    eye = p.get_eye_position()
    ground = scene.terrain.eval_terrain_height(float(eye[0]), float(eye[1]))
    if eye[2] - EYE_HEIGHT < ground - 0.5:
        p.set_position([eye[0], eye[1], ground + 0.3 + EYE_HEIGHT])
    move_avatars(scene, t)
    for av in scene.avatars:
        scene.graphics.update_avatar(av, DT)
    scene.graphics.pose_all()
    emit_particles(scene, frame, cam)
    scene.particles.think(DT)
    scene.terrain.update_campos(cam)
    scene.scattering.update_campos(cam)
    return cam


# ---------------------------------------------------------------------------
# The client's own frame: ClientApp.timer_event over BASELINE config 5's
# mesh world with the full tick's content.
# ---------------------------------------------------------------------------

N_CLIENT_SOURCES = 256    # bench.py's headline: 256 sources on 10k-class physics
N_CLIENT_VEHICLES = 8     # two each of <car/>, <bike/>, <boat/>, <hover_car/>
N_PLATFORMS = 4           # <follow_path> loops
N_LUA = 8
N_SOUNDS = 4              # seeded mono WAVs, 1-2 s at 48 kHz
DRIVE_FROM = 90           # the player enters car 0 at this frame
VEHICLE_TAGS = ("car", "bike", "boat", "hover_car")
LUA_SCRIPT = """--lua
touches = 0
timer_fires = 0
addEventListener("onUserTouchedObject", this_object.uid, function(av, ob)
  touches = touches + 1
end)
createTimer(function() timer_fires = timer_fires + 1 end, 0.5, true)
"""


class FrameClock:
    """The app's clock: ``client_tick`` sets ``t`` (1/60 s a frame)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@dataclasses.dataclass
class ClientScene:
    """An offline ``ClientApp`` and the uids ``client_tick`` and its checks
    need."""

    app: object
    clock: FrameClock
    sound_dir: str
    car_uids: list          # every vehicle, two of each tag in VEHICLE_TAGS order
    lua_uids: list
    winter_uids: list
    platform_uids: list
    source_uids: list
    build_s: float = 0.0
    drive_from: int = DRIVE_FROM   # the frame the player enters car 0


def write_sounds(path: str, n: int = N_SOUNDS, seed: int = 0) -> list:
    """``n`` seeded mono 16-bit WAVs of 1-2 s at 48 kHz (a tone, its
    overtone and noise) under ``path``; returns their paths."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        frames = int(rng.uniform(1.0, 2.0) * 48_000)
        t = np.arange(frames) / 48_000.0
        f0 = rng.uniform(110.0, 880.0)
        x = (0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
             + 0.05 * rng.standard_normal(frames))
        name = os.path.join(path, f"sound{k}.wav")
        with wave.open(name, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(48_000)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        out.append(name)
    return out


def _clear_spot(rng, blocked: np.ndarray, lane: tuple, radius: float = 20.0) -> np.ndarray:
    """A seeded point within ``radius`` m of the origin whose lane
    (x +- lane[0], y from -lane[1] to +lane[2]) holds none of ``blocked``."""
    for _ in range(10_000):
        p = rng.uniform(-radius, radius, 2)
        if np.hypot(*p) > radius or np.hypot(*p) < 4.0:
            continue
        d = blocked[:, :2] - p
        if not np.any((np.abs(d[:, 0]) < lane[0]) & (d[:, 1] > -lane[1]) & (d[:, 1] < lane[2])):
            return p
    raise RuntimeError("no clear spot for a vehicle")


def populate_client_world(app, world_object_cls, write_bmesh_fn, sound_dir: str,
                          n_objects: int = N_OBJECTS, n_dynamic: int = N_DYNAMIC,
                          n_sources: int = N_CLIENT_SOURCES,
                          n_vehicles: int = N_CLIENT_VEHICLES, n_winter: int = N_WINTER,
                          n_platforms: int = N_PLATFORMS, n_lua: int = N_LUA,
                          seed: int = 0) -> ClientScene:
    """Load the client world into ``app`` through ``create_object`` alone,
    as a client loads a world (so the tests hand the reference's ClientApp
    and WorldObject to it too):

    - ``app.resources["cube.bmesh"]`` first (tools/bench_networked.py:90-98);
    - ``n_objects`` unit cubes at ``mesh_layout`` (seed 0, +-180 m), the
      first ``n_dynamic`` dynamic (convex hulls, z 2-6 m), the rest static
      (their triangles on virtual anchors in the static trimesh);
    - ``audio_source_url`` on the first ``n_sources`` dynamic cubes, one of
      ``N_SOUNDS`` seeded WAVs each (the sources follow their bodies);
    - ``n_vehicles`` XML vehicles, two each of car, bike, boat and
      hovercar, on dynamic 0.5 m boxes of mass 800 at clear seeded spots
      within 20 m of the origin (car 0's 8 m lane along +y is clear);
    - ``n_winter`` Winter objects, bench.py's two scripts on half each:
      collidable 0.5 m boxes with no model (kinematic once scripted) at
      4-8 m over +-60 m;
    - ``n_platforms`` ``<follow_path>`` platforms, 5 m squares (20 m
      loops) at 2 m around the origin;
    - ``n_lua`` ``--lua`` objects counting ``onUserTouchedObject`` with a
      0.5 s repeating timer, in a row 0.8 m to the right of the player's
      walk, 0.5 m apart from 0.8 m out, where its capsule brushes them."""
    t0 = time.perf_counter()
    app.resources["cube.bmesh"] = write_bmesh_fn(CUBE_VERTS, CUBE_TRIS)
    collide, dynamic = 1, 8          # COLLIDABLE_FLAG, DYNAMIC_FLAG
    sounds = write_sounds(sound_dir, seed=seed)
    layout = mesh_layout(n_objects, n_dynamic)
    source_uids = []
    for i, pos in enumerate(layout):
        dyn = i < n_dynamic
        ob = world_object_cls(model_url="cube.bmesh", pos=np.array(pos),
                              flags=collide | (dynamic if dyn else 0))
        if dyn and i < n_sources:
            ob.audio_source_url = sounds[i % len(sounds)]
        app.create_object(ob)
        if ob.audio_source_url:
            source_uids.append(ob.uid)
    rng = np.random.default_rng(seed + 7)
    blocked = layout.copy()
    car_uids = []
    for k in range(n_vehicles):
        lane = (2.0, 2.0, 8.0) if k == 0 else (1.5, 1.5, 1.5)
        p = _clear_spot(rng, blocked, lane)
        blocked = np.vstack([blocked, [p[0], p[1], 0.5]])
        ob = world_object_cls(flags=collide | dynamic, pos=np.array([p[0], p[1], 0.6]),
                              mass=800.0,
                              script=f"<script><{VEHICLE_TAGS[(k // 2) % 4]}/></script>")
        app.create_object(ob)
        car_uids.append(ob.uid)
    winter_uids = []
    for k in range(n_winter):
        ob = world_object_cls(flags=collide, pos=np.array(
            [rng.uniform(-60, 60), rng.uniform(-60, 60), rng.uniform(4, 8)]),
            script=WINTER_SOURCES[k * len(WINTER_SOURCES) // max(n_winter, 1)])
        app.create_object(ob)
        winter_uids.append(ob.uid)
    platform_uids = []
    for k in range(n_platforms):
        a = 2 * math.pi * k / max(n_platforms, 1)
        cx, cy = 12 * math.cos(a), 12 * math.sin(a)
        corners = [(cx, cy), (cx + 5, cy), (cx + 5, cy + 5), (cx, cy + 5)]
        wps = "".join(f"<waypoint><pos>{x:.3f} {y:.3f} 2</pos><type>Station</type>"
                      f"<pause_time>0</pause_time></waypoint>" for x, y in corners)
        ob = world_object_cls(flags=collide, pos=np.array([cx, cy, 2.0]),
                              script=f"<script><follow_path><speed>4</speed>{wps}"
                                     f"</follow_path></script>")
        app.create_object(ob)
        platform_uids.append(ob.uid)
    lua_uids = []
    walk = np.array([0.2, 1.0]) / np.hypot(0.2, 1.0)
    side = np.array([walk[1], -walk[0]])
    for k in range(n_lua):
        xy = walk * (0.8 + 0.5 * k) + side * 0.8       # the walking capsule brushes them
        ob = world_object_cls(flags=collide, pos=np.array([xy[0], xy[1], 0.5]),
                              script=LUA_SCRIPT)
        app.create_object(ob)
        lua_uids.append(ob.uid)
    return ClientScene(app=app, clock=app.clock, sound_dir=sound_dir, car_uids=car_uids,
                       lua_uids=lua_uids, winter_uids=winter_uids,
                       platform_uids=platform_uids, source_uids=source_uids,
                       build_s=time.perf_counter() - t0)


def client_world(device, cfg: SimConfig | None = None, sound_dir: str | None = None,
                 **sizes) -> ClientScene:
    """The offline client frame's world at full width: a ``ClientApp`` on
    ``device`` with tools/bench_networked.py's SimConfig (4,096 slots,
    8,192 pairs, grid 64, 4 m cells, 7 iterations, pair rebuild every 6
    ticks), ``pipeline_depth=0``, audio on and a ``FrameClock``, loaded by
    ``populate_client_world`` (12,000 cubes, 256 sources, 8 vehicles, 512
    Winter objects, 4 platforms, 8 Lua objects; ``sizes`` cut them).  The
    WAVs go to ``sound_dir`` (a new temporary directory by default)."""
    app = ClientApp(config=cfg or mesh_config(), clock=FrameClock(), enable_audio=True,
                    pipeline_depth=0, device=device)
    return populate_client_world(app, WorldObject, write_bmesh,
                                 sound_dir or tempfile.mkdtemp(prefix="client_world_"), **sizes)


def client_input(frame: int, drive_from: int = DRIVE_FROM):
    """The player's keys: walk (forward 1, right 0.2) before
    ``drive_from``, then drive car 0 (forward 0.6, right 0.15)."""
    if frame < drive_from:
        return PlayerInput(forward=1.0, right=0.2)
    return PlayerInput(forward=0.6, right=0.15)


def client_tick(scene: ClientScene, frame: int):
    """One client frame: the clock at frame / 60 s, the player enters car 0
    at ``scene.drive_from``, ``app.timer_event(1/60, client_input(frame))``,
    then one 60 Hz tick of audio, ``app.audio.render(3)`` (768 frames).
    Returns the audio [768, 2] (None without audio)."""
    app = scene.app
    scene.clock.t = frame * DT
    if frame == scene.drive_from and scene.car_uids:
        app.enter_vehicle(scene.car_uids[0])
    app.timer_event(DT, client_input(frame, scene.drive_from))
    return app.audio.render(3) if app.audio is not None else None

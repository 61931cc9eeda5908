"""substrata_tpu_torch.PhysicsWorld: the golden box scenes of
test_jolt_fidelity.py with the same fixtures and the same tolerances, slot
reuse, SimConfig parity with the reference, and the import boundary
(the port never loads jax)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import SimConfig

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_golden(name):
    d = np.load(os.path.join(FIXTURES, f"golden_{name}.npz"))
    return d["pos"], d["quat"]


def make_world(**kw):
    cfg = SimConfig(capacity=32, max_pairs=256, grid_dim=16, cell_size=2.0,
                    solver_iters=10, **kw)
    w = PhysicsWorld(cfg, device="cpu")
    w.set_ground_plane(0.0)
    return w


def run_engine(w, obs, steps):
    pos = np.zeros((steps, len(obs), 3))
    for t in range(steps):
        w.think(1 / 60)
        w.sync_transforms()
        for i, ob in enumerate(obs):
            pos[t, i] = ob.pos
    return pos


def test_five_box_stack_rests_exactly():
    """Same scene and bounds as test_jolt_fidelity.py:135."""
    w = make_world()
    obs = [w.add_object(PhysicsObject(
        shape=shapes.make_box([0.4, 0.4, 0.4]),
        pos=np.array([0, 0, 0.4 + 0.82 * i], np.float32),
        motion_type=int(MotionType.DYNAMIC))) for i in range(5)]
    run_engine(w, obs, 300)
    for i, ob in enumerate(obs):
        assert abs(ob.pos[2] - (0.4 + 0.8 * i)) < 0.05, (i, ob.pos)
        assert np.linalg.norm(ob.pos[:2]) < 0.1, (i, ob.pos)
        q = np.asarray(ob.rot)
        assert abs(abs(q[3]) - 1.0) < 0.01, (i, q)


def test_rotated_box_stack_matches_golden():
    """Same scene, fixture and bounds as test_jolt_fidelity.py:229."""
    gpos, _ = load_golden("rotated_box_stack")
    w = make_world()
    s, c = np.sin(np.pi / 8), np.cos(np.pi / 8)
    lo = w.add_object(PhysicsObject(
        shape=shapes.make_box([0.5, 0.5, 0.3]),
        pos=np.array([0, 0, 0.3], np.float32),
        motion_type=int(MotionType.DYNAMIC)))
    hi = w.add_object(PhysicsObject(
        shape=shapes.make_box([0.3, 0.3, 0.3]),
        pos=np.array([0, 0, 1.3], np.float32),
        rot=np.array([0.0, 0.0, s, c], np.float32),
        motion_type=int(MotionType.DYNAMIC)))
    pos = run_engine(w, [lo, hi], len(gpos))
    assert abs(pos[-1, 0, 2] - gpos[-1, 0, 2]) < 0.03, (pos[-1, 0, 2], gpos[-1, 0, 2])
    assert abs(pos[-1, 1, 2] - gpos[-1, 1, 2]) < 0.06, (pos[-1, 1, 2], gpos[-1, 1, 2])
    assert np.linalg.norm(pos[-1, 1, :2]) < 0.15, pos[-1, 1]


def _golden_sphere_bounce():
    gpos, _ = load_golden("sphere_bounce")
    w = make_world()
    s = w.add_object(PhysicsObject(shape=shapes.make_sphere(0.3),
                                   pos=np.array([0, 0, 2.0], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    s.restitution = 0.6
    w._dirty[s.slot] = (s, True)
    ez, gz = run_engine(w, [s], len(gpos))[:, 0, 2], gpos[:, 0, 2]
    assert abs(ez[-1] - gz[-1]) < 0.02, (ez[-1], gz[-1])

    def first_apex(z):
        imp = int(np.argmax(z < 0.35))
        k = imp + int(np.argmax(np.diff(z[imp:]) < 0))
        return k, z[k]
    (kt_g, apex_g), (kt_e, apex_e) = first_apex(gz), first_apex(ez)
    assert abs(apex_e - apex_g) < 0.08 and abs(kt_e - kt_g) <= 4, (apex_e, apex_g)
    assert float(np.mean(np.abs(ez - gz))) < 0.12


def _golden_two_spheres():
    gpos, _ = load_golden("two_spheres")
    w = make_world()
    a = w.add_object(PhysicsObject(shape=shapes.make_sphere(0.3),
                                   pos=np.array([-1.5, 0, 0.3], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    b = w.add_object(PhysicsObject(shape=shapes.make_sphere(0.3),
                                   pos=np.array([1.5, 0, 0.3], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    a.restitution = b.restitution = 0.3
    w._dirty[a.slot] = (a, True)
    w._dirty[b.slot] = (b, True)
    w.set_linear_and_angular_vel(a, np.array([3.0, 0, 0], np.float32), np.zeros(3, np.float32))
    pos = run_engine(w, [a, b], len(gpos))
    err = np.abs(pos[:, :, 0] - gpos[:, :, 0])
    assert float(err.mean()) < 0.08 and float(err.max()) < 0.3, (err.mean(), err.max())
    assert np.all(pos[:, 0, 0] <= pos[:, 1, 0] + 1e-3)


def _golden_capsule_drop():
    gpos, _ = load_golden("capsule_drop")
    w = make_world()
    rot = np.array([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)], np.float32)
    c = w.add_object(PhysicsObject(shape=shapes.make_capsule(0.25, 0.4),
                                   pos=np.array([0, 0, 1.5], np.float32), rot=rot,
                                   motion_type=int(MotionType.DYNAMIC)))
    pos = run_engine(w, [c], len(gpos))
    assert abs(pos[-1, 0, 2] - gpos[-1, 0, 2]) < 0.02, (pos[-1, 0, 2], gpos[-1, 0, 2])
    assert np.linalg.norm(pos[-1, 0, :2] - gpos[-1, 0, :2]) < 0.2


def _golden_capsule_on_capsule():
    gpos, _ = load_golden("capsule_on_capsule")
    w = make_world()
    qy = np.array([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)], np.float32)
    qx = np.array([np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)], np.float32)
    lo = w.add_object(PhysicsObject(shape=shapes.make_capsule(0.25, 0.4),
                                    pos=np.array([0, 0, 0.25], np.float32), rot=qy,
                                    motion_type=int(MotionType.DYNAMIC)))
    hi = w.add_object(PhysicsObject(shape=shapes.make_capsule(0.25, 0.4),
                                    pos=np.array([0, 0, 1.4], np.float32), rot=qx,
                                    motion_type=int(MotionType.DYNAMIC)))
    pos = run_engine(w, [lo, hi], len(gpos))
    assert abs(pos[-1, 0, 2] - gpos[-1, 0, 2]) < 0.04, (pos[-1, 0, 2], gpos[-1, 0, 2])
    assert abs(pos[-1, 1, 2] - gpos[-1, 1, 2]) < 0.08, (pos[-1, 1, 2], gpos[-1, 1, 2])
    assert pos[-1, 1, 2] > pos[-1, 0, 2] + 0.3


GOLDEN_CURVED = {"sphere_bounce": _golden_sphere_bounce, "two_spheres": _golden_two_spheres,
                 "capsule_drop": _golden_capsule_drop,
                 "capsule_on_capsule": _golden_capsule_on_capsule}


@pytest.mark.parametrize("scene", list(GOLDEN_CURVED))
def test_curved_golden_scenes(scene):
    """The sphere and capsule scenes of test_jolt_fidelity.py, with the
    same fixtures and the same bounds (sphere worlds are single-combo code
    0; capsule worlds code 10)."""
    GOLDEN_CURVED[scene]()


def test_sphere_rolls_down_slope_analytic():
    """A solid sphere rolling without slipping down a 15-degree heightfield
    slope accelerates at 5/7 g sin(theta) (rel 0.15, the bound of
    test_jolt_fidelity.py:153)."""
    theta = np.deg2rad(15.0)
    xs = np.linspace(-60, 60, 31)
    hgrid = np.broadcast_to(-np.tan(theta) * xs[:, None], (31, 31)).astype(np.float32)
    w = PhysicsWorld(SimConfig(capacity=16, max_pairs=64, grid_dim=16, cell_size=4.0,
                               solver_iters=10), device="cpu")
    w.set_heightfield(hgrid, origin=[-60, -60], cell_w=4.0)
    r = 0.3
    s = w.add_object(PhysicsObject(shape=shapes.make_sphere(r), friction=0.8,
                                   pos=np.array([0, 0, r / np.cos(theta)], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    for _ in range(30):
        w.think(1 / 60)
    w.sync_transforms()
    v0 = float(s.linvel[0])
    for _ in range(60):
        w.think(1 / 60)
    w.sync_transforms()
    a_meas = (float(s.linvel[0]) - v0) / 1.0 / np.cos(theta)
    a_true = 5.0 / 7.0 * 9.81 * np.sin(theta)
    assert a_meas == pytest.approx(a_true, rel=0.15), (a_meas, a_true)


def test_remove_and_readd_in_one_tick_reuses_slot_cleanly():
    """Slot reuse: a body removed and a new one added before the next tick
    takes the freed slot; the new body starts from its own state (no
    inherited velocity or warm-start impulses) and rests on the ground."""
    w = make_world()
    a = w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]),
                                   pos=np.array([0, 0, 0.4], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    b = w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]),
                                   pos=np.array([0, 0, 1.2], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    run_engine(w, [a, b], 30)
    slot = b.slot
    w.remove_object(b)
    c = w.add_object(PhysicsObject(shape=shapes.make_box([0.3, 0.3, 0.3]),
                                   pos=np.array([3.0, 0, 0.3], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    assert c.slot == slot and b.slot == -1
    pos = run_engine(w, [a, c], 120)
    assert abs(pos[-1, 1, 2] - 0.3) < 0.02 and abs(pos[-1, 1, 0] - 3.0) < 0.02
    assert abs(pos[-1, 0, 2] - 0.4) < 0.02
    assert w.state.shape_params[slot, 0].item() == pytest.approx(0.3)
    assert set(w.objects) == {a.slot, c.slot}


def test_simconfig_matches_reference():
    """Same field set and defaults, same validation and auto value."""
    assert vars(SimConfig()) == vars(jstate.SimConfig())
    kw = dict(capacity=10_240, max_pairs=16_384, grid_dim=128, cell_size=1.4,
              cell_capacity=6, solver_iters=7, pairs_per_body=10,
              pair_rebuild_interval=6, contacts_per_body=8)
    assert vars(SimConfig(**kw)) == vars(jstate.SimConfig(**kw))
    assert SimConfig(**kw) == SimConfig(**kw)
    assert hash(SimConfig(**kw)) == hash(SimConfig(**kw))
    with pytest.raises(ValueError):
        SimConfig(capacity=70_000)
    with pytest.raises(ValueError):
        SimConfig(capacity=65_536, max_active_contacts=1 << 20)


def test_unported_entry_points_raise():
    """Snapshots still raise; the pipelined readback and the batched
    snapshot transforms no longer do, nor hulls, static trimeshes and rays
    against them."""
    w = make_world()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w.save_snapshot("unused.npz")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w.load_snapshot("unused.npz")
    w.set_pipelined(2)
    assert w._digest_pipeline.depth == 2 and w._sync_pipeline.depth == 2
    w.set_pipelined(0)
    assert w._digest_pipeline is None and w._sync_pipeline is None
    w.set_new_ob_transforms_batch([], np.zeros((0, 3)), np.zeros((0, 4)),
                                  np.zeros((0, 3)), np.zeros((0, 3)))
    hull = shapes.make_convex_hull(np.eye(3))              # a degenerate (planar) cloud
    assert hull.shape_type == 3 and len(hull.hull_verts) == 3
    w.set_static_trimesh(np.array([[-5, -5, 0.2], [5, -5, 0.2], [0, 5, 0.2]], np.float32),
                         np.array([[0, 1, 2]], np.int32))
    assert w.static_world.n_tris == 1
    hit, t, n, ob, mat = w.trace_ray([0, 0, 5], [0, 0, -1], 10.0)
    assert hit and t == pytest.approx(4.8, abs=1e-5) and ob is None and mat == 0


def test_import_leaves_jax_out():
    code = ("import sys, substrata_tpu_torch, substrata_tpu_torch.convert, "
            "substrata_tpu_torch.kernels, substrata_tpu_torch.audio, "
            "substrata_tpu_torch.audio.mix, substrata_tpu_torch.benchworld, "
            "substrata_tpu_torch.physics.queries, substrata_tpu_torch.physics.particles, "
            "substrata_tpu_torch.physics.vehicles, substrata_tpu_torch.kernels.ray_trace, "
            "substrata_tpu_torch.kernels.particles_triton, "
            "substrata_tpu_torch.kernels.vehicles, substrata_tpu_torch.profile_tick, "
            "substrata_tpu_torch.physics.character, substrata_tpu_torch.kernels.character, "
            "substrata_tpu_torch.kernels.closed_forms, substrata_tpu_torch.kernels.serving_io, "
            "substrata_tpu_torch.kernels.convex, substrata_tpu_torch.kernels.static_contacts, "
            "substrata_tpu_torch.physics.shapes, substrata_tpu_torch.physics.world, "
            "substrata_tpu_torch.scripting, substrata_tpu_torch.kernels.winter, "
            "substrata_tpu_torch.anim, substrata_tpu_torch.anim.pose, "
            "substrata_tpu_torch.avatar_graphics, substrata_tpu_torch.physics.terrain, "
            "substrata_tpu_torch.kernels.terrain, substrata_tpu_torch.kernels.spawn, "
            "substrata_tpu_torch.shared.avatar, substrata_tpu_torch.shared.parcel, "
            "substrata_tpu_torch.client_app, substrata_tpu_torch.loading, "
            "substrata_tpu_torch.net.snapshots, substrata_tpu_torch.shared.world_object, "
            "substrata_tpu_torch.shared.voxel, substrata_tpu_torch.shared.bmesh, "
            "substrata_tpu_torch.shared.gltf, substrata_tpu_torch.shared.model_formats, "
            "substrata_tpu_torch.shared.sub_url, substrata_tpu_torch.scripting.lua, "
            "substrata_tpu_torch.scripting.lua_api, substrata_tpu_torch.scripting.events, "
            "substrata_tpu_torch.scripting.path_controller, "
            "substrata_tpu_torch.scripting.xml_scripts, "
            "substrata_tpu_torch.kernels.audio_setup, "
            "substrata_tpu_torch.kernels.vehicle_setup, "
            "substrata_tpu_torch.kernels.bc1, substrata_tpu_torch.shared.texture_compress, "
            "substrata_tpu_torch.shared.png, substrata_tpu_torch.shared.resources, "
            "substrata_tpu_torch.shared.lod, substrata_tpu_torch.shared.records, "
            "substrata_tpu_torch.shared.guarded, substrata_tpu_torch.net.protocol, "
            "substrata_tpu_torch.net.tls, substrata_tpu_torch.net.timesync, "
            "substrata_tpu_torch.net.client, substrata_tpu_torch.net.server, "
            "substrata_tpu_torch.server_side.accounts, "
            "substrata_tpu_torch.server_side.site_data, substrata_tpu_torch.server_side.mcp, "
            "substrata_tpu_torch.server_side.asset_pipeline, "
            "substrata_tpu_torch.runtime.readback, "
            "substrata_tpu_torch.runtime.codecs, substrata_tpu_torch.parallel, "
            "substrata_tpu_torch.parallel.dryrun, substrata_tpu_torch.kernels.halo, "
            "substrata_tpu_torch.kernels.shard_reduce, "
            "scipy.spatial; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'substrata_tpu')]; "
            "assert not bad, bad; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_world_defaults_to_the_card():
    """The entry point runs on the card unless asked for the CPU, and
    never falls back to it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_gpu.py checks the default")
    with pytest.raises(RuntimeError, match="cuda"):
        PhysicsWorld(SimConfig(capacity=32, max_pairs=256, grid_dim=16))
    with pytest.raises(RuntimeError, match="cuda"):
        PhysicsWorld(SimConfig(capacity=32, max_pairs=256, grid_dim=16), device="cuda")


def test_client_entry_points_default_to_the_card():
    """The terrain and the avatars' manager land on the card unless asked
    for the CPU (or, for the terrain, on its world's device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from substrata_tpu_torch.avatar_graphics import AvatarGraphicsManager
    from substrata_tpu_torch.physics.terrain import TerrainSystem
    for make in (TerrainSystem, AvatarGraphicsManager):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    w = PhysicsWorld(SimConfig(capacity=32, max_pairs=256, grid_dim=16), device="cpu")
    assert TerrainSystem(w).device.type == "cpu"
    assert AvatarGraphicsManager(device="cpu").device.type == "cpu"


def _scripted_world(pkg_world, pkg_object, pkg_shapes, motion_dynamic):
    """One host script through either package's facade: a bilinear
    heightfield, water buoyancy, 12 separated boxes; after 20 thinks a
    teleport, a velocity write, a removal and an add; 25 more thinks."""
    rng = np.random.default_rng(3)
    if pkg_world is PhysicsWorld:
        w = PhysicsWorld(SimConfig(capacity=32, max_pairs=256, grid_dim=16, cell_size=2.0,
                                   solver_iters=7), device="cpu")
    else:
        w = pkg_world(jstate.SimConfig(capacity=32, max_pairs=256, grid_dim=16,
                                       cell_size=2.0, solver_iters=7))
    w.set_heightfield(rng.uniform(-0.2, 0.2, (17, 17)).astype(np.float32),
                      origin=[-10.0, -10.0], cell_w=1.25)
    w.set_water_buoyancy_enabled(True)
    w.water_z = 0.3
    obs = []
    for i in range(12):
        pos = np.array([(i % 4) * 2.5 - 4.0, (i // 4) * 2.5 - 3.0,
                        rng.uniform(0.8, 2.5)], np.float32)
        obs.append(w.add_object(pkg_object(shape=pkg_shapes.make_box([0.3, 0.3, 0.3]),
                                           pos=pos, motion_type=motion_dynamic)))
    trace = []
    for t in range(45):
        if t == 20:
            w.set_new_ob_to_world_transform(obs[0], [4.0, 4.0, 2.0],
                                            [0.0, 0.0, 0.38268343, 0.9238795])
            w.set_linear_and_angular_vel(obs[1], [2.0, 0.0, 3.0], [0.0, 1.0, 0.0])
            w.remove_object(obs[2])
            obs[2] = w.add_object(pkg_object(shape=pkg_shapes.make_box([0.25, 0.25, 0.25]),
                                             pos=np.array([0.0, 5.0, 1.5], np.float32),
                                             motion_type=motion_dynamic))
        w.think(1 / 60)
        w.sync_transforms()
        d = w.last_diags
        trace.append((np.stack([np.asarray(ob.pos) for ob in obs]),
                      (int(d.num_contacts), int(d.num_awake))))
    return trace


def test_facade_script_tracks_reference():
    """The port's PhysicsWorld against the reference's on the same host
    script.  Positions within 1e-3 m at every tick (the slice-1 bound of
    test_torch_step.py); contact and awake counts equal."""
    from substrata_tpu.physics import shapes as jshapes
    from substrata_tpu.physics.world import PhysicsObject as JObject
    from substrata_tpu.physics.world import PhysicsWorld as JWorld
    ref = _scripted_world(JWorld, JObject, jshapes, int(jstate.MotionType.DYNAMIC))
    port = _scripted_world(PhysicsWorld, PhysicsObject, shapes, int(MotionType.DYNAMIC))
    for t, ((jp, jcounts), (tp, tcounts)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(tp, jp, atol=1e-3, err_msg=f"tick {t}")
        assert tcounts == jcounts, t
    assert np.abs(port[-1][0] - port[19][0]).max() > 1.0      # the writes moved bodies


def _sleepy_world(pkg_world, pkg_object, pkg_shapes, motion_dynamic, state_mod):
    """Eight boxes dropped from 0.1 m (they come to rest and fall asleep)
    and one sliding across the ground; returns every sync's changed mask."""
    kw = dict(capacity=32, max_pairs=256, grid_dim=16, cell_size=2.0, solver_iters=7)
    w = (pkg_world(SimConfig(**kw), device="cpu") if pkg_world is PhysicsWorld
         else pkg_world(state_mod.SimConfig(**kw)))
    w.set_ground_plane(0.0)
    for i in range(8):
        w.add_object(pkg_object(shape=pkg_shapes.make_box([0.3, 0.3, 0.3]),
                                pos=np.array([i * 1.5 - 5.0, 2.0, 0.4], np.float32),
                                motion_type=motion_dynamic))
    slider = w.add_object(pkg_object(shape=pkg_shapes.make_box([0.3, 0.3, 0.3]),
                                     pos=np.array([-6.0, -3.0, 0.31], np.float32),
                                     motion_type=motion_dynamic))
    masks = []
    for t in range(150):
        if t == 100:
            w.set_linear_and_angular_vel(slider, [4.0, 0.0, 0.0], [0.0, 0.0, 0.0])
        w.think(1 / 60)
        w.sync_transforms()
        masks.append((np.array(w.last_sync_changed), int(w.last_diags.num_awake)))
    return masks


def test_sync_changed_mask_matches_reference():
    """``PhysicsWorld.last_sync_changed`` (the rows ``sync_transforms``
    found changed, which ClientApp's readback reads) equals the
    reference's at every sync after a think in which some bodies sleep
    (and as many on both sides): only the bodies that moved.  Before the
    boxes sleep the mask tracks bit-exact stillness, which the two solves
    reach a tick or two apart (rounding), so those syncs are not held."""
    from substrata_tpu.physics import shapes as jshapes
    from substrata_tpu.physics.world import PhysicsObject as JObject
    from substrata_tpu.physics.world import PhysicsWorld as JWorld
    assert PhysicsWorld(SimConfig(capacity=8, max_pairs=64, grid_dim=8),
                        device="cpu").last_sync_changed is None
    ref = _sleepy_world(JWorld, JObject, jshapes, int(jstate.MotionType.DYNAMIC), jstate)
    port = _sleepy_world(PhysicsWorld, PhysicsObject, shapes, int(MotionType.DYNAMIC), jstate)
    compared = 0
    for t, ((a, na), (b, nb)) in enumerate(zip(ref, port)):
        assert a.dtype == b.dtype == bool and a.shape == b.shape, t
        if na == nb < 9:
            np.testing.assert_array_equal(b, a, err_msg=f"sync {t}")
            compared += 1
    assert compared >= 80, compared
    assert port[0][0].all()
    asleep = port[99][0]
    assert not asleep[:9].any() and port[101][0][8], asleep

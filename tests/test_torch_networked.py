"""The pipelined readback, the batched snapshot transforms and the
networked ClientApp of substrata_tpu_torch on the CPU.

- The pipelined readback: a world at depth N (1 and 3) consumes at tick t
  the digest and the transform block that the synchronous world read at
  tick t - N, exactly (same scene, same inputs; both rebuild pairs every
  tick, so the host's rebuild cadence, which pipelining changes, is one).
- ``set_new_ob_transforms_batch`` leaves the reference's mirrors, dirty
  rows, wake regions and pair invalidation; 30 thinks later the bodies
  agree within 1e-4 m (the slice's box-world bound).
- tests/test_client_app.py's networked scenarios on the port: two
  networked apps replicate a falling box (the reference's
  ``test_networked_two_apps_replicate_physics``, :98) and the pipelined
  app settles and walks (``test_pipelined_tick_matches_world_state``,
  :246).
- The port's offline ClientApp at ``pipeline_depth=3`` against the
  reference's at the same depth on one small world and input: every
  object and the player's eye within 1e-4 m over 60 frames.  A networked
  run is not compared with the reference's numbers: its timing comes
  from the network, so it is held to invariants instead.
- bench_networked's networked frame at its smoke sizes (600 objects, 64
  dynamic): the world replicates, loads and ticks with the sender's
  stream; bodies finite, the digest consumed 3 ticks late.
- The touch message (``client_app.py:_process_player_contacts``): the
  player walks into an object and the server's script VM hears it.

The socket tests bind port 0, run plaintext (``tls_context=None``) and
bound every wait with a deadline."""

import time

import numpy as np
import pytest
import torch

from substrata_tpu import MotionType as JMotionType
from substrata_tpu import PhysicsObject as JPhysicsObject
from substrata_tpu import PhysicsWorld as JPhysicsWorld
from substrata_tpu import client_app as j_app
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as j_state
from substrata_tpu.shared import world_object as j_wo
from substrata_tpu_torch import benchworld
from substrata_tpu_torch import client_app as t_app
from substrata_tpu_torch.client_app import ClientApp, PlayerInput
from substrata_tpu_torch.net.client import Client
from substrata_tpu_torch.net.server import Server
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics import state as t_state
from substrata_tpu_torch.physics.state import MotionType, SimConfig
from substrata_tpu_torch.physics.world import PhysicsObject, PhysicsWorld
from substrata_tpu_torch.shared import world_object as t_wo
from substrata_tpu_torch.shared.world_object import DYNAMIC_FLAG, WorldObject

torch.set_num_threads(2)

DT = 1.0 / 60.0
PLAIN = {"tls_context": None}


def wait_for(pred, timeout=10.0, interval=0.02):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(interval)
    return False


# --- The pipelined readback --------------------------------------------------

def _pile(depth):
    w = PhysicsWorld(SimConfig(capacity=64, max_pairs=512, grid_dim=16, cell_size=2.0,
                               pair_rebuild_interval=1), device="cpu")
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    obs = [w.add_object(PhysicsObject(
        shape=shapes.make_box(np.array([0.4, 0.4, 0.4], np.float32)),
        pos=np.array([rng.uniform(-2, 2), rng.uniform(-2, 2), 0.5 + 0.9 * i], np.float32),
        motion_type=int(MotionType.DYNAMIC))) for i in range(12)]
    w.set_pipelined(depth)
    digests = []
    real = w._read_digest

    def capture(events, digest):
        digests.append(np.array(digest))
        return real(events, digest)
    w._read_digest = capture
    return w, obs, digests


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_readback_is_the_synchronous_run_depth_ticks_late(depth):
    ws, obs_s, dig_s = _pile(0)
    wp, obs_p, dig_p = _pile(depth)
    mir_s, mir_p = [], []
    for t in range(40):
        for w, obs, mir in ((ws, obs_s, mir_s), (wp, obs_p, mir_p)):
            w.think(DT)
            w.sync_transforms()
            mir.append(np.stack([np.concatenate([o.pos, o.rot, o.linvel, o.angvel])
                                 for o in obs]))
    assert len(dig_s) == 40 and len(dig_p) == 40 - depth
    for t in range(depth, 40):
        np.testing.assert_array_equal(dig_p[t - depth], dig_s[t - depth])
        # The mirrors skip host-written rows until the ring has caught up
        # (add_object marks depth + 1 syncs); from then on they are the
        # synchronous run's of depth ticks before.
        if t > 2 * depth:
            np.testing.assert_array_equal(mir_p[t], mir_s[t - depth])
    np.testing.assert_array_equal(wp.state.pos.numpy(), ws.state.pos.numpy())
    assert len(wp._digest_pipeline) == depth and len(wp._sync_pipeline) == depth


def test_pipelined_host_writes_are_not_regressed():
    """A kinematic body moved by the host keeps its host position in the
    mirror while stale blocks are still in flight."""
    w, obs, _ = _pile(3)
    kin = w.add_object(PhysicsObject(shape=shapes.make_box(np.array([0.5, 0.5, 0.5],
                                                                   np.float32)),
                                     pos=np.array([8.0, 8.0, 0.5], np.float32),
                                     motion_type=int(MotionType.KINEMATIC)))
    for t in range(12):
        target = np.array([8.0 + 0.05 * (t + 1), 8.0, 0.5], np.float32)
        w.move_kinematic_object(kin, target, kin.rot, DT)
        w.think(DT)
        w.sync_transforms()
        np.testing.assert_array_equal(kin.pos, target)


# --- The batched snapshot transforms ----------------------------------------

def _spheres(world_cls, obj_cls, shape_mod, mt, **kw):
    cfg_cls = SimConfig if world_cls is PhysicsWorld else j_state.SimConfig
    w = world_cls(cfg_cls(capacity=64, max_pairs=256, grid_dim=16, cell_size=4.0), **kw)
    w.set_ground_plane(0.0)
    obs = [w.add_object(obj_cls(shape=shape_mod.make_sphere(0.4),
                                pos=np.array([i * 2.0, 0, 1], np.float32),
                                motion_type=int(mt.DYNAMIC))) for i in range(12)]
    w.think(DT)
    return w, obs


def test_set_new_ob_transforms_batch_equals_the_reference():
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(12, 3)).astype(np.float32) * 3
    rot = np.tile(np.array([0, 0, 0, 1], np.float32), (12, 1))
    lv = rng.normal(size=(12, 3)).astype(np.float32)
    av = rng.normal(size=(12, 3)).astype(np.float32) * 0.1
    wr, orf = _spheres(JPhysicsWorld, JPhysicsObject, jshapes, JMotionType)
    wp, opt = _spheres(PhysicsWorld, PhysicsObject, shapes, MotionType, device="cpu")
    wr.set_new_ob_transforms_batch(orf, pos, rot, lv, av)
    wp.set_new_ob_transforms_batch(opt, pos, rot, lv, av)
    for a, b in zip(orf, opt):
        for f in ("pos", "rot", "linvel", "angvel"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f))
    assert wr._structural_dirty == wp._structural_dirty
    assert sorted(wr._xform_dirty) == sorted(wp._xform_dirty)
    assert len(wr._wake_regions) == len(wp._wake_regions) > 0
    for (ca, ra), (cb, rb) in zip(wr._wake_regions, wp._wake_regions):
        np.testing.assert_array_equal(ca, cb)
        assert ra == rb
    for _ in range(30):
        wr.think(DT)
        wp.think(DT)
    wr.sync_transforms()
    wp.sync_transforms()
    for a, b in zip(orf, opt):
        np.testing.assert_allclose(b.pos, np.asarray(a.pos), atol=1e-4)


# --- tests/test_client_app.py's networked and pipelined scenarios ------------

def small_cfg():
    return SimConfig(capacity=128, max_pairs=512, grid_dim=16, cell_size=4.0, solver_iters=6)


def make_app(**kw):
    return ClientApp(config=small_cfg(), enable_audio=False, device="cpu", **kw)


def test_networked_two_apps_replicate_physics():
    server = Server(port=0, udp_port=0, **PLAIN)
    server.start()
    try:
        ca = Client("127.0.0.1", server.port, **PLAIN)
        ca.start()
        cb = Client("127.0.0.1", server.port, **PLAIN)
        cb.start()
        app_a, app_b = make_app(client=ca), make_app(client=cb)
        ob = WorldObject(flags=DYNAMIC_FLAG | 1, pos=np.array([2.0, 0, 4.0]), mass=20.0)
        app_a.create_object(ob)
        gt = ca.world_state.global_time()
        slot = ca.world_state.slot_for(ob.uid)
        ca.world_state.ownership.try_claim(slot, ca.avatar_uid, gt)
        ob.physics_owner_id = ca.avatar_uid
        ca.send_ownership_taken(ob.uid, gt)
        for _ in range(150):
            app_a.timer_event(DT)
            app_b.timer_event(DT)
            time.sleep(0.002)
        assert ob.uid in app_b.objects
        with cb.world_state.lock:
            slot_b = cb.world_state._slot_by_uid.get(ob.uid)
        assert slot_b is not None
        assert cb.world_state.snapshots.next_i[slot_b] >= 2
        b_ob = app_b.objects[ob.uid]
        assert b_ob.physics_object.pos[2] < 3.5, b_ob.physics_object.pos
        ca.stop()
        cb.stop()
    finally:
        server.stop()


def test_pipelined_tick_matches_world_state():
    app = make_app(pipeline_depth=3)
    ob = WorldObject(flags=DYNAMIC_FLAG | 1, pos=np.array([2.0, 0, 3.0]), mass=20.0)
    app.create_object(ob)
    for _ in range(150):
        app.timer_event(DT, PlayerInput(forward=1.0))
    assert ob.pos[2] < 1.0, ob.pos
    assert np.isfinite(ob.pos).all()
    assert app.cam_pos[1] > 3.0, app.cam_pos
    assert app.player.on_ground


# --- The pipelined ClientApp against the reference's -------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run_pipelined_app(app_mod, state_mod, wo_mod, frames=60, **kw):
    clock = _Clock()
    app = app_mod.ClientApp(config=state_mod.SimConfig(**CFG), clock=clock,
                            enable_audio=False, pipeline_depth=3, **kw)
    # Bodies 3 m apart and off the player's path: each falls onto the
    # ground on its own (two float32 implementations part within ticks where
    # boxes land on each other or on the player's proxy, ROADMAP.md queue 3).
    uids = []
    for i in range(8):
        ob = wo_mod.WorldObject(flags=DYNAMIC_FLAG | 1, mass=10.0 + i,
                                pos=np.array([(-6.0, -3.0, 3.0, 6.0)[i % 4], 4.0 * (i // 4),
                                              1.0 + 0.6 * i]))
        app.create_object(ob)
        uids.append(ob.uid)
    app.create_object(wo_mod.WorldObject(flags=1, pos=np.array([3.0, 8.0, 0.5])))
    out = []
    for f in range(frames):
        clock.t = f * DT
        app.timer_event(DT, app_mod.PlayerInput(forward=1.0, right=0.2 if f > 30 else 0.0))
        out.append((np.array([app.objects[u].pos for u in uids], np.float64),
                    np.array(app.player.get_eye_position(), np.float64)))
    return out


CFG = dict(capacity=128, max_pairs=512, grid_dim=16, cell_size=4.0, solver_iters=6,
           pair_rebuild_interval=6)


def test_pipelined_client_app_agrees_with_the_reference():
    ref = _run_pipelined_app(j_app, j_state, j_wo)
    port = _run_pipelined_app(t_app, t_state, t_wo, device="cpu")
    for f, ((rp, re), (pp, pe)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pp, rp, atol=1e-4, err_msg=f"objects, frame {f}")
        np.testing.assert_allclose(pe, re, atol=1e-4, err_msg=f"eye, frame {f}")
    assert ref[-1][1][1] > 1.0          # the player walked


# --- bench_networked's frame at its smoke sizes ------------------------------

def test_networked_frame_smoke_sizes():
    cfg = SimConfig(capacity=512, max_pairs=2048, grid_dim=32, cell_size=4.0, solver_iters=7,
                    pair_rebuild_interval=6)
    sc = benchworld.networked_world("cpu", n_objects=600, n_dynamic=64, cfg=cfg,
                                    timeout=30.0)
    try:
        assert sc.viewer.world_state.num_objects() == 600 and len(sc.dyn_uids) == 64
        for _ in range(10):
            benchworld.networked_tick(sc)
        assert len(sc.app.objects) == 600
        sc.app.physics_world.prewarm_tiers(player=sc.app.player)
        benchworld.start_sender_stream(sc)
        for _ in range(20):
            benchworld.networked_tick(sc)
        w = sc.app.physics_world
        alive = w.state.alive.numpy()
        assert alive.sum() == 64 + 1                     # the hulls and the proxy
        assert np.isfinite(w.state.pos.numpy()[alive]).all()
        assert len(w._digest_pipeline) == 3 and len(w._sync_pipeline) == 3
        assert sc.snapshots_sent > 0
        ws = sc.viewer.world_state
        assert wait_for(lambda: ws.snapshots.next_i.max() > 0, 5.0)
        assert set(sc.app.phase_ms) >= {"think", "playback", "readback", "send"}
    finally:
        sc.close()


def test_touch_message_reaches_the_server():
    server = Server(port=0, udp_port=0, **PLAIN)
    server.start()
    try:
        c = Client("127.0.0.1", server.port, **PLAIN)
        c.start()
        app = make_app(client=c)
        ob = WorldObject(flags=1, pos=np.array([1.2, 0, 0.5]))
        app.create_object(ob)
        heard = []
        server.script_vm.handlers_for(ob.uid).on_user_touched_object.add(
            lambda av, uid: heard.append((av, uid)))
        for _ in range(120):
            app.timer_event(DT, PlayerInput(right=1.0))
            if heard:
                break
            time.sleep(0.002)
        assert wait_for(lambda: heard, 5.0)
        assert heard[0] == (c.avatar_uid, ob.uid)
        c.stop()
    finally:
        server.stop()

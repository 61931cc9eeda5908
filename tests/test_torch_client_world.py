"""A small client world through both ClientApps on the CPU: 600 cubes (32
dynamic hulls over the static trimesh), 16 audio sources on hulls, 4
vehicles (car, car, bike, bike), 16 Winter objects, 1 path platform and
2 Lua objects, built by ``benchworld.populate_client_world`` (which calls
only ``ClientApp.create_object``) and stepped 60 frames by
``benchworld.client_tick``; the player walks, enters car 0 at frame 30
and drives it.

Tolerances:
- every dynamic object within 1e-4 m of the reference at every frame
  until it can meet the static trimesh: the first frame, on either side,
  where it is within 2.5 m of a static cube's centre (across and up) or
  moves faster than 20 m/s.  The reference's trimesh sign rule kicks a
  hull there (ROADMAP.md queue 3): at this size one hull is thrown at ~90
  m/s at frame 7, one bounces beside a cube at 2-5 m/s from frame 12, and
  past such a kick the paths' last-bit differences grow with the body's
  speed.  The undriven vehicles are held so over frames 0-24 only:
  a bike bounces on its suspension (the chassis is a 1 m box) and that
  amplifies the last-bit differences of KJ's transcendentals (1e-5 of
  scale against the reference, test_torch_vehicles.py), measured 1.0e-4 m
  at frame 27 and 0.16 m at frame 45; past frame 24 they are held finite;
- the player's eye and car 0 within 1e-4 m over all 60 frames;
- the Lua counters, timers, messages and the app's log equal;
- the audio within 5e-5 (test_torch_audio.py's bound on mixed output)
  while every source's body is within 1e-3 m of the reference's (a
  thrown source body carries the paths' differences into the mix; here
  from frame ~50, measured 5.7e-4 at frame 59);
- ``phase_ms`` keys equal every frame.
"""

import numpy as np
import pytest
import torch

from substrata_tpu import client_app as j_app
from substrata_tpu.physics import state as j_state
from substrata_tpu.shared import bmesh as j_bmesh
from substrata_tpu.shared import world_object as j_wo
from substrata_tpu_torch import benchworld
from substrata_tpu_torch import client_app as t_app
from substrata_tpu_torch.physics import state as t_state
from substrata_tpu_torch.shared import bmesh as t_bmesh
from substrata_tpu_torch.shared import world_object as t_wo

torch.set_num_threads(2)

SIZES = dict(n_objects=600, n_dynamic=32, n_sources=16, n_vehicles=4, n_winter=16,
             n_platforms=1, n_lua=2)
CFG = dict(capacity=512, max_pairs=2048, grid_dim=32, cell_size=4.0, solver_iters=7,
           pair_rebuild_interval=6)
FRAMES = 60
DRIVE_FROM = 30
KICK_SPEED = 20.0
SIDES = {"reference": (j_app, j_state, j_wo, j_bmesh, {}),
         "port": (t_app, t_state, t_wo, t_bmesh, {"device": "cpu"})}


def run_side(name, sound_dir):
    app_mod, state_mod, wo_mod, bmesh_mod, kw = SIDES[name]
    app = app_mod.ClientApp(config=state_mod.SimConfig(**CFG), clock=benchworld.FrameClock(),
                            enable_audio=True, pipeline_depth=0, **kw)
    sc = benchworld.populate_client_world(app, wo_mod.WorldObject, bmesh_mod.write_bmesh,
                                          sound_dir, **SIZES)
    sc.drive_from = DRIVE_FROM
    dyn = [u for u, ob in app.objects.items() if ob.is_dynamic()]
    undriven = np.array([u in sc.car_uids[1:] for u in dyn])
    frames = []
    for f in range(FRAMES):
        audio = benchworld.client_tick(sc, f)
        frames.append(dict(
            pos=np.array([app.objects[u].pos for u in dyn], np.float64),
            speed=np.array([np.linalg.norm(app.objects[u].linear_vel) for u in dyn]),
            source=np.array([app.objects[u].audio_source is not None for u in dyn]),
            eye=np.array(app.player.get_eye_position(), np.float64),
            car=np.array(app.objects[sc.car_uids[0]].pos, np.float64),
            cam=np.array(app.cam_pos, np.float64), audio=audio,
            phases=list(app.phase_ms)))
    lua = [(ev.interp.globals.get("touches"), ev.interp.globals.get("timer_fires"),
            ev.hit_error) for ev in app.script_vm.lua_evaluators]
    winter = np.array([app.objects[u].pos for u in sc.winter_uids], np.float64)
    return dict(frames=frames, lua=lua, log=list(app.log_messages), undriven=undriven,
                winter=winter,
                messages=list(app.script_vm.messages_to_user),
                counts=(len(app.objects), len(app.vehicle_controllers),
                        len(app.path_controllers), len(app.scripts.scripted),
                        len(app.script_vm.lua_evaluators)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: run_side(name, str(tmp_path_factory.mktemp(name))) for name in SIDES}


STATIC_CUBES = benchworld.mesh_layout(SIZES["n_objects"], SIZES["n_dynamic"])[
    SIZES["n_dynamic"]:]


def near_trimesh(pos):
    """[D] bool: within 2.5 m of a static cube's centre across and up."""
    d = np.abs(pos[:, None, :] - STATIC_CUBES[None, :, :])
    return ((np.maximum(d[..., 0], d[..., 1]) < 2.5) & (d[..., 2] < 2.5)).any(axis=1)


def kick_frames(runs, near=True):
    """Each dynamic object's first frame, on either side, past KICK_SPEED
    or (``near``) within reach of the static trimesh (FRAMES if never)."""
    hit = np.array([(near_trimesh(a["pos"]) | near_trimesh(b["pos"]) if near else False)
                    | (np.maximum(a["speed"], b["speed"]) > KICK_SPEED)
                    for a, b in zip(runs["reference"]["frames"], runs["port"]["frames"])])
    return np.where(hit.any(axis=0), hit.argmax(axis=0), FRAMES)


def test_world_built_alike(runs):
    a, b = runs["reference"], runs["port"]
    assert a["counts"] == b["counts"] == (600 + 4 + 16 + 1 + 2, 4, 1, 16, 2)
    assert a["log"] == b["log"]


UNDRIVEN_FRAMES = 25


def test_dynamic_objects_agree_until_their_kick(runs):
    k = kick_frames(runs)
    assert (k == FRAMES).sum() >= len(k) // 2, k
    undriven = runs["port"]["undriven"]
    assert undriven.sum() == SIZES["n_vehicles"] - 1
    k = np.where(undriven, np.minimum(k, UNDRIVEN_FRAMES), k)
    for f in range(FRAMES):
        a, b = runs["reference"]["frames"][f], runs["port"]["frames"][f]
        assert np.all(np.isfinite(b["pos"]))
        live = k > f
        err = float(np.abs(a["pos"][live] - b["pos"][live]).max())
        assert err <= 1e-4, (f, err)


def test_player_and_driven_car_agree(runs):
    for f in range(FRAMES):
        a, b = runs["reference"]["frames"][f], runs["port"]["frames"][f]
        for key in ("eye", "car", "cam"):
            assert np.all(np.isfinite(b[key]))
            err = float(np.abs(a[key] - b[key]).max())
            assert err <= 1e-4, (f, key, err)
    a0 = runs["port"]["frames"][DRIVE_FROM - 1]["car"]
    assert np.linalg.norm(runs["port"]["frames"][-1]["car"] - a0) > 0.1


def test_lua_counters_and_messages_equal(runs):
    a, b = runs["reference"], runs["port"]
    assert a["lua"] == b["lua"]
    assert all(np.isfinite(t) and np.isfinite(n) and not err for t, n, err in b["lua"])
    assert a["messages"] == b["messages"]


def test_audio_agrees_while_its_sources_do(runs):
    src = runs["port"]["frames"][0]["source"]
    apart = [float(np.abs(a["pos"][src] - b["pos"][src]).max()) > 1e-3
             for a, b in zip(runs["reference"]["frames"], runs["port"]["frames"])]
    first = apart.index(True) if any(apart) else FRAMES
    assert first >= 30, first
    for f in range(FRAMES):
        a, b = runs["reference"]["frames"][f]["audio"], runs["port"]["frames"][f]["audio"]
        assert b.shape == (768, 2) and np.all(np.isfinite(b)) and np.abs(b).max() <= 1.0
        if f < first:
            err = float(np.abs(a - b).max())
            assert err <= 5e-5, (f, err)
    out = np.concatenate([r["audio"] for r in runs["port"]["frames"]])
    assert np.sqrt((out ** 2).mean()) > 0 and np.abs(out[:, 0] - out[:, 1]).max() > 0


def test_phase_keys_equal(runs):
    for a, b in zip(runs["reference"]["frames"], runs["port"]["frames"]):
        assert a["phases"] == b["phases"]


def test_winter_objects_agree(runs):
    """The Winter objects where both apps leave them: the rotated ones in
    place, the translated ones carried ~240 m off in 60 frames (the
    readback writes each moved body back into ``ob.pos``, to which the next
    frame adds the script's translation again: client_app.py:633 with
    :833, the reference's loop), within 1e-3 m."""
    a, b = runs["reference"]["winter"], runs["port"]["winter"]
    assert np.abs(a - b).max() <= 1e-3

"""substrata_tpu_torch's ClientApp against substrata_tpu's on the CPU: the
reference's offline scenarios of tests/test_client_app.py (the offline
tick, walking, the Winter rotation, the drivable vehicle, the voxel
object, touch events, the static and dynamic glTF meshes, the portal,
sub:// URLs and the pipelined tick), each run on both apps with the same
frame clock.  Every scenario keeps the reference's own assertions, on both
apps, and holds the port to the reference:

- bodies, the camera and the eye within 1e-4 m (the two physics steps
  agree to float32 rounding: the twins repeat XLA's arithmetic, sums can
  take another order; test_torch_mesh_world.py holds hulls to 1e-3 m);
- the Winter-driven rotation within 1e-6 (KR's twin against the jitted
  reference, test_torch_winter.py);
- ray hits, touch events, URLs and navigation exactly (URL positions
  within 1e-4 m);
- the pipelined tick (``pipeline_depth=3``) runs on the reference and
  raises NotImplementedError on the port (ROADMAP.md queue 1, item 3).
"""

import numpy as np
import pytest
import torch

from substrata_tpu import client_app as j_app
from substrata_tpu.physics import state as j_state
from substrata_tpu.shared import voxel as j_voxel
from substrata_tpu.shared import world_object as j_wo
from substrata_tpu_torch import client_app as t_app
from substrata_tpu_torch.physics import state as t_state
from substrata_tpu_torch.shared import sub_url as t_url
from substrata_tpu_torch.shared import voxel as t_voxel
from substrata_tpu_torch.shared import world_object as t_wo
from tests.test_gltf import make_cube_gltf

torch.set_num_threads(2)

DT = 1.0 / 60.0
POS_TOL = 1e-4


class Side:
    """One package's ClientApp and records, and a clock the scenario
    advances by DT each tick."""

    def __init__(self, app_mod, state_mod, wo_mod, voxel_mod, **app_kw):
        self.m, self.wo, self.voxel = app_mod, wo_mod, voxel_mod
        self.state_mod = state_mod
        self.app_kw = app_kw
        self.t = 0.0

    def clock(self):
        return self.t

    def make_app(self, **kw):
        cfg = self.state_mod.SimConfig(capacity=128, max_pairs=512, grid_dim=16,
                                       cell_size=4.0, solver_iters=6)
        return self.m.ClientApp(config=cfg, enable_audio=False, clock=self.clock,
                                **self.app_kw, **kw)

    def tick(self, app, inp=None):
        self.t += DT
        app.timer_event(DT, inp)


def sides():
    return (Side(j_app, j_state, j_wo, j_voxel),
            Side(t_app, t_state, t_wo, t_voxel, device="cpu"))


def both(scenario):
    """The scenario's observations on the reference, then on the port."""
    return [scenario(s) for s in sides()]


def close(a, b, tol=POS_TOL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(b)), what
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol, (what, err, a, b)


def offline_tick(s):
    app = s.make_app()
    ob = s.wo.WorldObject(flags=s.wo.DYNAMIC_FLAG | 1, pos=np.array([2.0, 0, 3.0]), mass=20.0)
    app.create_object(ob)
    for _ in range(120):
        s.tick(app)
    assert ob.pos[2] < 1.0, ob.pos
    assert np.isfinite(ob.pos).all()
    assert "objects" in app.get_diagnostics()
    return dict(pos=np.array(ob.pos), phases=sorted(app.phase_ms))


def test_offline_tick_with_objects():
    a, b = both(offline_tick)
    close(a["pos"], b["pos"], what="box")
    assert a["phases"] == b["phases"]


def player_walk(s):
    app = s.make_app()
    for _ in range(120):
        s.tick(app, s.m.PlayerInput(forward=1.0))
    assert app.cam_pos[1] > 3.0, app.cam_pos
    return app.cam_pos.copy()


def test_player_walk_in_app():
    a, b = both(player_walk)
    close(a, b, what="camera")


def winter_rotates(s):
    app = s.make_app()
    ob = s.wo.WorldObject(flags=1, pos=np.array([5.0, 0, 1.0]),
                          script="def evalRotation(float time, WinterEnv env) vec3 : "
                                 "vec3(0.0, 0.0, time * 1.0)")
    app.create_object(ob)
    for _ in range(31):
        s.tick(app)
    q = np.asarray(ob.physics_object.rot, np.float64)
    angle = 2 * np.arctan2(np.linalg.norm(q[:3]), abs(q[3]))
    assert angle > 0.01
    return q


def test_winter_scripted_object_rotates():
    a, b = both(winter_rotates)
    close(a, b, 1e-6, "rotation")


def vehicle_drives(s):
    app = s.make_app()
    ob = s.wo.WorldObject(flags=s.wo.DYNAMIC_FLAG | 1, pos=np.array([3.0, 0, 1.0]),
                          mass=800.0, script="<script><hover_car/></script>")
    app.create_object(ob)
    assert ob.uid in app.vehicle_controllers
    assert app.enter_vehicle(ob.uid)
    track = []
    for _ in range(90):
        s.tick(app, s.m.PlayerInput(forward=1.0))
        track.append(np.array(ob.pos))
    assert ob.pos[1] > 1.0, ob.pos
    cam = app.cam_pos.copy()
    app.exit_vehicle()
    assert app.driven_vehicle_uid == 0
    return dict(track=np.array(track), cam=cam, eye=app.player.get_eye_position())


def test_vehicle_script_object_becomes_drivable():
    a, b = both(vehicle_drives)
    close(a["track"], b["track"], what="vehicle")
    close(a["cam"], b["cam"], what="seat camera")
    close(a["eye"], b["eye"], what="exit position")


def voxel_object(s):
    app = s.make_app()
    vox = s.voxel.compress_voxel_group(np.array([[0, 0, 0], [1, 0, 0]]), np.array([0, 0]))
    ob = s.wo.WorldObject(object_type=int(s.wo.ObjectType.VOXEL_GROUP), flags=1,
                          pos=np.array([0.0, 5.0, 0.5]), voxel_data=vox)
    app.create_object(ob)
    assert ob.physics_object is not None
    hit, t, n, hit_ob, mat = app.physics_world.trace_ray([0, 5, 5], [0, 0, -1], 10.0)
    assert hit
    return dict(hit=hit, t=t, n=np.asarray(n), userdata=hit_ob.userdata is ob, mat=mat)


def test_voxel_object_physics():
    a, b = both(voxel_object)
    assert (a["hit"], a["userdata"], a["mat"]) == (b["hit"], b["userdata"], b["mat"])
    close(a["t"], b["t"], 1e-5, "ray t")
    close(a["n"], b["n"], 1e-6, "ray normal")


def touch_events(s):
    app = s.make_app()
    ob = s.wo.WorldObject(flags=1, pos=np.array([1.2, 0, 0.5]))
    app.create_object(ob)
    touched = []
    app.script_vm.handlers_for(ob.uid).on_user_touched_object.add(
        lambda av, uid: touched.append((uid, round(s.t / DT))))
    for _ in range(120):
        s.tick(app, s.m.PlayerInput(right=1.0))
        if touched:
            break
    assert touched and touched[0][0] == ob.uid
    return dict(touched=touched, eye=app.player.get_eye_position())


def test_touch_events_fire_scripts():
    a, b = both(touch_events)
    assert a["touched"] == b["touched"]
    close(a["eye"], b["eye"], what="eye")


def static_gltf(s):
    app = s.make_app()
    ob = s.wo.WorldObject(flags=1, pos=np.array([-4.0, -4.0, 2.0]),
                          scale=np.array([8.0, 8.0, 0.2]), model_url="plat.glb")
    app.create_object(ob)
    assert ob.physics_object.shape.shape_type == 1
    app.provide_resource("plat.glb", make_cube_gltf(as_glb=True))
    s.tick(app)
    hit, t, n, hit_ob, mat = app.physics_world.trace_ray([1.5, 1.5, 10.0], [0.0, 0.0, -1.0],
                                                         20.0)
    assert hit and abs((10.0 - t) - 2.2) < 0.05, (hit, t)
    assert hit_ob is not None and hit_ob.userdata is ob
    ball = s.wo.WorldObject(flags=s.wo.DYNAMIC_FLAG | 1, pos=np.array([1.5, 1.5, 4.0]),
                            mass=5.0)
    app.create_object(ball)
    for _ in range(240):
        s.tick(app)
    on = np.array(ball.pos)
    assert ball.pos[2] > 2.2, ball.pos
    # The reference's test then asserts that the ball falls to the ground
    # once the platform is removed; on both apps the trimesh sign rule
    # throws it instead (ROADMAP.md queue 3), hundreds of metres, where the
    # paths' last-bit differences grow with its speed: both are held to
    # finite positions and the same outcome only.
    app.remove_object(ob)
    for _ in range(240):
        s.tick(app)
    return dict(t=t, on=on, off=np.array(ball.pos))


@pytest.mark.slow
def test_static_gltf_mesh_collides_and_ray_hits():
    a, b = both(static_gltf)
    close(a["t"], b["t"], 1e-5, "ray t")
    close(a["on"], b["on"], what="ball on the platform")
    assert np.all(np.isfinite(a["off"])) and np.all(np.isfinite(b["off"]))
    assert (a["off"][2] < 1.0) == (b["off"][2] < 1.0), (a["off"], b["off"])


def dynamic_gltf(s):
    app = s.make_app()
    app.provide_resource("crate.glb", make_cube_gltf(as_glb=True))
    ob = s.wo.WorldObject(flags=s.wo.DYNAMIC_FLAG | 1, pos=np.array([3.0, 3.0, 3.0]),
                          mass=10.0, model_url="crate.glb")
    app.create_object(ob)
    assert ob.physics_object.shape.shape_type == 3
    for _ in range(240):
        s.tick(app)
    assert abs(ob.physics_object.pos[2] - 0.5) < 0.1, ob.physics_object.pos
    return dict(body=np.array(ob.physics_object.pos), mesh=np.array(ob.pos),
                angle=ob.angle)


def test_dynamic_gltf_mesh_becomes_convex_hull():
    a, b = both(dynamic_gltf)
    close(a["body"], b["body"], what="hull body")
    close(a["mesh"], b["mesh"], what="mesh pose")
    close(a["angle"], b["angle"], 1e-4, "axis-angle")


def portal(s):
    app = s.make_app()
    p = s.wo.WorldObject(object_type=int(s.wo.ObjectType.PORTAL), flags=1,
                         pos=np.array([0.0, 2.0, 0.9]),
                         target_url="sub://localhost?x=20.0&y=20.0&z=2.0&heading=90.0")
    app.create_object(p)
    frames = 0
    for _ in range(240):
        s.tick(app, s.m.PlayerInput(forward=1.0))
        frames += 1
        if app.cam_pos[0] > 10:
            break
    eye = app.player.get_eye_position()
    assert np.linalg.norm(np.asarray(eye[:2]) - [20.0, 20.0]) < 2.0, eye
    assert app.cam_heading_deg == 90.0
    assert len(app.navigation_stack) == 1
    assert app.navigation_stack[0].startswith("sub://localhost")
    stack = list(app.navigation_stack)
    assert app.navigate_back()
    eye2 = app.player.get_eye_position()
    assert np.linalg.norm(np.asarray(eye2[:2]) - [0.0, 2.0]) < 4.0, eye2
    return dict(frames=frames, eye=eye, stack=stack, eye2=eye2,
                heading=app.cam_heading_deg)


def test_portal_touch_teleports_player():
    a, b = both(portal)
    assert (a["frames"], a["heading"]) == (b["frames"], b["heading"])
    close(a["eye"], b["eye"], what="eye after the portal")
    close(a["eye2"], b["eye2"], what="eye after back navigation")
    ua, ub = t_url.parse_sub_url(a["stack"][0]), t_url.parse_sub_url(b["stack"][0])
    assert (ua.hostname, ua.worldname, ua.heading) == (ub.hostname, ub.worldname, ub.heading)
    close([ua.x, ua.y, ua.z], [ub.x, ub.y, ub.z], what="pushed URL position")


def sub_urls(s):
    from importlib import import_module
    mod = import_module(s.m.__name__.replace("client_app", "shared.sub_url"))
    u = mod.parse_sub_url("sub://substrata.info/nick/my+cool+world?x=1&y=2&z=3&heading=45")
    assert u.hostname == "substrata.info" and u.worldname == "nick/my cool world"
    assert u.has_position and (u.x, u.y, u.z) == (1.0, 2.0, 3.0) and u.heading == 45.0
    u2 = mod.parse_sub_url("substrata.info/parcel/10")
    assert u2.parcel_uid == 10
    made = mod.make_sub_url("h", "w", pos=(1, 2, 3), heading=7.0)
    u3 = mod.parse_sub_url(made)
    assert (u3.hostname, u3.worldname) == ("h", "w") and u3.has_position
    app = s.make_app()
    return dict(made=made, current=app.get_current_url(), u=vars(u), u2=vars(u2))


def test_sub_url_parse_roundtrip():
    a, b = both(sub_urls)
    assert a == b


def test_pipelined_tick_matches_world_state():
    ref, port = sides()
    app = ref.make_app(pipeline_depth=3)
    ob = ref.wo.WorldObject(flags=ref.wo.DYNAMIC_FLAG | 1, pos=np.array([2.0, 0, 3.0]),
                            mass=20.0)
    app.create_object(ob)
    for _ in range(150):
        ref.tick(app, ref.m.PlayerInput(forward=1.0))
    assert ob.pos[2] < 1.0 and np.isfinite(ob.pos).all()
    assert app.cam_pos[1] > 3.0 and app.player.on_ground
    with pytest.raises(NotImplementedError, match="pipelined readback"):
        port.make_app(pipeline_depth=3)


def test_client_app_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_gpu.py checks the default")
    with pytest.raises(RuntimeError, match="cuda"):
        t_app.ClientApp(enable_audio=False)

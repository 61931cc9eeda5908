"""substrata_tpu_torch's character controller (the plain twin of kernel KL)
against substrata_tpu.physics.character, and the reference's
PlayerPhysics scenarios on the port.

Tolerances: one update within 1e-5 m (and m/s) on position, velocity,
ground normal and velocity and the camera; 60 chained updates within
1e-4 m (float32 rounding of two implementations compounds over the
chain); on_ground, jumped and the touched-body list exact at every
update."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld, convert
from substrata_tpu_torch.physics import character as tchar
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.character import EYE_HEIGHT, PlayerPhysics
from substrata_tpu_torch.physics.state import SimConfig

from torch_port_helpers import jax_body, params_np, static_world_np

torch.set_num_threads(2)

DT = 1.0 / 60.0
CAPACITY = 64


def _body(a, i, st, prm, pos, motion, quat=(0, 0, 0, 1), vel=(0, 0, 0), angvel=(0, 0, 0)):
    prm = np.asarray(prm + [0.0] * (4 - len(prm)), np.float32)
    _, inv_mass, inv_inertia, vol, bound = jstate.compute_shape_mass_props(st, prm)
    dyn = motion == int(jstate.MotionType.DYNAMIC)
    a["pos"][i] = pos
    a["quat"][i] = quat
    a["linvel"][i] = vel
    a["angvel"][i] = angvel
    a["inv_mass"][i] = inv_mass if dyn else 0.0
    a["inv_inertia"][i] = inv_inertia if dyn else 0.0
    a["motion_type"][i] = motion
    a["layer"][i] = int(jstate.Layer.NON_MOVING if motion == 0 else jstate.Layer.MOVING)
    a["shape_type"][i] = st
    a["shape_params"][i] = prm
    a["alive"][i] = True
    a["awake"][i] = motion != 0
    a["bound_radius"][i] = bound
    a["volume"][i] = vol


STATIC, KINEMATIC, DYNAMIC = 0, 1, 2
SPHERE, BOX, CAPSULE = 0, 1, 2

# name: (bodies [(type, params, pos, motion, extra)], eye, move, jump, fly,
#        water_z, heightfield)
SCENES = {
    "flat_idle": ([], (0, 0, EYE_HEIGHT), (0, 0, 0), False, False, None, False),
    "walk": ([], (0, 0, EYE_HEIGHT), (3, 0, 0), False, False, None, False),
    "run_bumpy_ground": ([], (0, 0, 2.0), (15, 0, 0), False, False, None, True),
    "jump": ([], (0, 0, EYE_HEIGHT), (3, 0, 0), True, False, None, False),
    "fly": ([], (0, 0, 5.0), (0, 0, 3), False, True, None, False),
    "swim": ([], (0, 0, 3.0), (0, 0, 3), False, False, 10.0, False),
    "wall": ([(BOX, [0.25, 3.0, 2.0], (0.9, 0, 2.0), STATIC, {})],
             (0, 0, EYE_HEIGHT), (3, 0, 0), False, False, None, False),
    "step_0.25": ([(BOX, [1.0, 1.0, 0.125], (1.45, 0, 0.125), STATIC, {})],
                  (0, 0, EYE_HEIGHT), (3, 0, 0), False, False, None, False),
    "step_0.35": ([(BOX, [1.0, 1.0, 0.175], (1.4, 0, 0.175), STATIC, {})],
                  (0, 0, EYE_HEIGHT), (3, 0, 0), False, False, None, False),
    "step_0.45_blocks": ([(BOX, [1.0, 1.0, 0.225], (1.4, 0, 0.225), STATIC, {})],
                         (0, 0, EYE_HEIGHT), (3, 0, 0), False, False, None, False),
    "stick_to_floor": ([(BOX, [1.0, 2.0, 0.2], (-0.7, 0, 0.2), STATIC, {})],
                       (0, 0, 0.4 + EYE_HEIGHT), (3, 0, 0), False, False, None, False),
    "dynamic_candidates": ([
        (BOX, [0.3, 0.3, 0.3], (0.7, 0.2, 0.3), DYNAMIC,
         dict(vel=(0.5, 0, 0), angvel=(0, 0, 1.0))),
        (SPHERE, [0.35], (-0.2, 0.75, 0.35), DYNAMIC, dict(vel=(0, -0.3, 0))),
        (CAPSULE, [0.2, 0.4], (-0.6, -0.5, 0.2), DYNAMIC,
         dict(quat=(0, 0.70710677, 0, 0.70710677))),
        (BOX, [0.4, 0.4, 0.4], (0.3, -0.9, 1.4), DYNAMIC, dict(quat=(0.2, 0.1, 0.3, 0.9273618)))],
        (0, 0, EYE_HEIGHT), (1.5, 1.5, 0), False, False, None, False),
    # A box whose bottom face overlaps the top of the standing capsule by
    # 6 cm: the slide pushes out of it, then out of the ground, then out
    # of it again.
    "pressed_from_above": ([(BOX, [0.4, 0.4, 0.4], (0.1, 0, 2.24), DYNAMIC, {})],
                           (0, 0, EYE_HEIGHT), (0, 0, 0), False, False, None, False),
}


def _scene(name, cell_size):
    bodies, eye, move, jump, fly, water_z, bumpy = SCENES[name]
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(CAPACITY)).items()}
    for i, (st, prm, pos, motion, extra) in enumerate(bodies):
        _body(a, i, st, list(prm), pos, motion, **extra)
    # The player's kinematic capsule proxy, excluded from its own probes.
    proxy = len(bodies)
    foot = np.asarray(eye, np.float32) - [0, 0, EYE_HEIGHT]
    _body(a, proxy, CAPSULE, [0.3, 0.65], foot + [0, 0, 0.95], KINEMATIC)
    a = {k: np.ascontiguousarray(v) for k, v in a.items()}
    cfg = dict(capacity=CAPACITY, max_pairs=256, grid_dim=16, cell_size=cell_size,
               cell_capacity=6)
    sw = jstate.default_static_world(ground_z=0.0)
    if bumpy:
        rng = np.random.default_rng(4)
        hf = jstate.Heightfield(
            heights=jnp.asarray(rng.uniform(0.0, 0.3, (33, 33)).astype(np.float32)),
            origin=jnp.asarray([-40.0, -40.0], jnp.float32), cell_w=jnp.float32(2.5),
            is_flat=False)
        sw = sw.replace(heightfield=hf)
    params = jstate.default_sim_params()
    if water_z is not None:
        params = params.replace(water_z=jnp.float32(water_z))
    return a, cfg, sw, params, eye, np.asarray(move, np.float32), jump, fly, proxy


def _compare(name, cell_size, n_updates, tol):
    a, cfg, sw, params, eye, move, jump, fly, proxy = _scene(name, cell_size)
    jcfg = jstate.SimConfig(**cfg)
    jbody = jax_body(a)
    jc = jchar.init_character_state(eye)
    tcfg = SimConfig(**cfg)
    body = convert.body_state_from_numpy(a, device="cpu")
    tsw = convert.static_world_from_numpy(static_world_np(sw), device="cpu")
    tparams = convert.sim_params_from_numpy(params_np(params), device="cpu")
    tc = tchar.init_character_state(eye, device="cpu")
    ref0 = {f: np.asarray(getattr(jc, f)) for f in tchar.CHARACTER_FIELDS}
    for f, x in ref0.items():
        np.testing.assert_array_equal(getattr(tc, f).numpy(), x, err_msg=f)
    tc = convert.character_from_numpy(ref0, device="cpu")
    jumped_any = False
    for i in range(n_updates):
        jmp = jump and i < 6    # the jump press lasts JUMP_PERIOD (0.1 s)
        jc, jcam, jj, jt = jchar.character_update(
            jc, jbody, sw, jnp.asarray(move), jmp, fly, False, DT, params, jcfg, proxy)
        tc, tcam, tj, tt = tchar.character_update(
            tc, body, tsw, move, jmp, fly, False, DT, tparams, tcfg, proxy)
        msg = f"{name}, update {i}"
        for f in ("pos", "vel", "ground_normal", "ground_vel", "campos_z_delta"):
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       atol=tol, err_msg=f"{msg}: {f}")
        for f in ("on_ground", "gravity_enabled", "fly_mode", "sitting"):
            assert bool(getattr(tc, f)) == bool(getattr(jc, f)), (msg, f)
        np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), atol=tol, err_msg=msg)
        assert bool(tj) == bool(jj), msg
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=msg)
        jumped_any |= bool(jj)
    return tc, jumped_any


@pytest.mark.parametrize("name", list(SCENES))
def test_one_update_matches_reference(name):
    _compare(name, 1.4, 1, 1e-5)


@pytest.mark.parametrize("name,cell_size", [(n, 1.4) for n in SCENES]
                         + [("step_0.35", 4.0), ("dynamic_candidates", 4.0)])
def test_sixty_chained_updates_match_reference(name, cell_size):
    """Cell size 1.4 (the bench's: three gather centres, the steps and the
    wall oversize) and 4.0 (two centres, everything in the grid)."""
    tc, jumped = _compare(name, cell_size, 60, 1e-4)
    if name == "jump":
        assert jumped
    if name == "step_0.45_blocks":
        assert float(tc.pos[0]) < 0.5 and float(tc.pos[2]) < 0.1


def test_pressed_character_sinks_like_the_reference():
    """A body pressing on the capsule holds the foot in the ground: the
    collide-and-slide pushes out of the deepest contact three times an
    update, so whichever of the box and the ground is deeper at the start
    also takes the last push, and the foot alternates between the ground
    and the box's overlap (5.8 cm) below it, update by update.  The
    reference does the same: the port follows it within 1e-5 (one update)
    and 1e-4 (chained), and goes no deeper than the overlap."""
    for n, below in ((1, True), (2, False), (59, True)):
        tc, _ = _compare("pressed_from_above", 1.4, n, 1e-5 if n == 1 else 1e-4)
        z = float(tc.pos[2])
        assert (-0.06 < z < -0.055) if below else abs(z) < 1e-6, (n, tc.pos)


def test_packed_vector_layout():
    """``player_update_packed`` returns the state and the reference's
    packed vector [campos, jumped, on_ground, pos, vel, ground_vel,
    touched]; the touched rows cover the 6 static rows and every
    candidate row (3 centres x 27 cells x 6 + 64 oversize at cell 1.4)."""
    a, cfg, sw, params, eye, move, jump, fly, proxy = _scene("dynamic_candidates", 1.4)
    body = convert.body_state_from_numpy(a, device="cpu")
    tsw = convert.static_world_from_numpy(static_world_np(sw), device="cpu")
    tparams = convert.sim_params_from_numpy(params_np(params), device="cpu")
    c0 = tchar.init_character_state(eye, device="cpu")
    scal = torch.as_tensor(tchar.tick_scalars(DT, move, False, False, False, proxy))
    new, packed = tchar.player_update_packed(c0, body, tsw, scal, tparams, SimConfig(**cfg))
    assert packed.shape == (15 + 6 + 3 * 27 * 6 + 64,)
    np.testing.assert_array_equal(packed[6:9].numpy(), new.pos.numpy())
    np.testing.assert_array_equal(packed[9:12].numpy(), new.vel.numpy())
    assert float(packed[5]) == float(new.on_ground)
    touched = packed[15:].numpy()
    assert (touched[:6] == -1).all() and set(touched[touched >= 0].astype(int)) <= {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# The 13 scenarios of tests/test_character.py through the port's facade.
# ---------------------------------------------------------------------------

def make_world():
    w = PhysicsWorld(SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=4.0,
                               solver_iters=8), device="cpu")
    w.set_ground_plane(0.0)
    return w


def _static_box(w, he, pos):
    w.add_object(PhysicsObject(shape=shapes.make_box(he), pos=np.array(pos, np.float32),
                               motion_type=int(MotionType.STATIC)))


def _walk(p, n, move=(1, 0, 0), w=None, run=False):
    for i in range(n):
        p.process_move(list(move), runpressed=run)
        p.update(DT, cur_time=i * DT)
        if w is not None:
            w.think(DT)


def sc_spawn_no_gravity_until_move():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, 10.0))
    for _ in range(30):
        p.update(DT)
    assert abs(p.get_eye_position()[2] - 10.0) < 0.2


def sc_walk_on_flat_ground():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 120, w=w)
    eye = p.get_eye_position()
    assert eye[0] > 4.0 and abs(eye[2] - EYE_HEIGHT) < 0.25, eye


def sc_run_factor():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 60, run=True)
    assert p.get_eye_position()[0] > 10.0


def sc_jump():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 30)
    max_z, jumped = 0.0, False
    p.process_jump(cur_time=1.0)
    for i in range(90):
        _, j = p.update(DT, cur_time=1.0 + i * DT)
        jumped = jumped or j
        max_z = max(max_z, p.get_eye_position()[2])
    assert jumped and max_z - EYE_HEIGHT > 0.6, max_z


def sc_steps_up_stairs():
    w = make_world()
    for i in range(3):
        _static_box(w, [1.0, 2.0, 0.125 * (i + 1)], [1.5 + i * 2.0, 0, 0.125 * (i + 1)])
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    max_z = 0.0
    for i in range(260):
        p.process_move([1, 0, 0])
        p.update(DT, cur_time=i * DT)
        max_z = max(max_z, p.get_eye_position()[2])
    eye = p.get_eye_position()
    assert eye[0] > 4.5 and max_z > EYE_HEIGHT + 0.7, (max_z, eye)


def sc_steps_up_tall_single_step():
    w = make_world()
    _static_box(w, [1.0, 1.0, 0.175], [1.5, 0, 0.175])
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 180)
    assert p.get_eye_position()[0] > 2.6


def sc_step_above_limit_blocks():
    w = make_world()
    _static_box(w, [1.0, 1.0, 0.225], [1.5, 0, 0.225])
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 180)
    eye = p.get_eye_position()
    assert eye[0] < 0.5 and eye[2] < EYE_HEIGHT + 0.2, eye


def sc_blocked_by_wall():
    w = make_world()
    _static_box(w, [0.25, 3.0, 2.0], [2.0, 0, 2.0])
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 240)
    eye = p.get_eye_position()
    assert eye[0] < 1.8 and eye[2] < EYE_HEIGHT + 0.45, eye


def sc_fly_mode():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, 5.0))
    p.set_fly_mode_enabled(True)
    _walk(p, 120, move=(0, 0, 1))
    assert p.get_eye_position()[2] > 5.5


def sc_swim_up_in_water():
    w = make_world()
    w.set_water_buoyancy_enabled(True)
    w.water_z = 10.0
    w.set_ground_plane(0.0)
    p = PlayerPhysics(w, eye_pos=(0, 0, 3.0))
    _walk(p, 120, move=(0, 0, 1))
    assert p.get_eye_position()[2] > 3.5


def sc_pushes_dynamic_box():
    w = make_world()
    box = w.add_object(PhysicsObject(shape=shapes.make_box([0.3, 0.3, 0.3], density=100.0),
                                     pos=np.array([1.5, 0, 0.3], np.float32),
                                     motion_type=int(MotionType.DYNAMIC)))
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    _walk(p, 240, w=w)
    w.sync_transforms()
    assert box.pos[0] > 2.0, box.pos


def sc_scripted_input_trace_piecewise_kinematics():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    trace, t = [], 0.0

    def drive(n, move, run=False, jump=False):
        nonlocal t
        for k in range(n):
            p.process_move(move, runpressed=run)
            if jump and k == 0:
                p.process_jump(cur_time=t)
            p.update(DT, cur_time=t)
            w.think(DT)
            trace.append((p.get_eye_position().copy(), t))
            t += DT

    drive(120, [1, 0, 0])
    x_walk_end = trace[-1][0][0]
    drive(60, [0, 1, 0], run=True)
    y_run_end = trace[-1][0][1]
    drive(90, [0, 0, 0], jump=True)
    apex = max(e[2] for e, _ in trace[-90:])
    drive(60, [0, 0, 0])
    end_eye = trace[-1][0]
    assert 4.5 < x_walk_end < 6.5, x_walk_end
    assert 10.0 < y_run_end < 16.0, y_run_end
    assert 0.7 < apex - EYE_HEIGHT < 1.25, apex
    assert abs(end_eye[2] - EYE_HEIGHT) < 0.25, end_eye
    assert np.linalg.norm(end_eye[:2] - trace[-60][0][:2]) < 0.5


def sc_stick_to_floor_on_step_down():
    w = make_world()
    _static_box(w, [2.0, 2.0, 0.2], [-1.0, 0, 0.2])
    p = PlayerPhysics(w, eye_pos=(-1.0, 0, 0.4 + EYE_HEIGHT))
    on_lower = False
    for i in range(240):
        p.process_move([1, 0, 0])
        p.update(DT, cur_time=i * DT)
        w.think(DT)
        on_lower = on_lower or p.get_eye_position()[0] > 1.3
    assert on_lower, "never walked off the ledge"
    assert abs(p.get_eye_position()[2] - EYE_HEIGHT) < 0.25


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_spawn_no_gravity_until_move, sc_walk_on_flat_ground, sc_run_factor, sc_jump,
    sc_steps_up_stairs, sc_steps_up_tall_single_step, sc_step_above_limit_blocks,
    sc_blocked_by_wall, sc_fly_mode, sc_swim_up_in_water, sc_pushes_dynamic_box,
    sc_scripted_input_trace_piecewise_kinematics, sc_stick_to_floor_on_step_down)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_player_physics_scenarios(name):
    """tests/test_character.py's scenarios and bounds, on the port's
    PlayerPhysics (update() outside the serving tick, think() after it
    where the reference test steps the world)."""
    SCENARIOS[name]()


def test_set_pipelined_raises():
    w = make_world()
    p = PlayerPhysics(w, eye_pos=(0, 0, EYE_HEIGHT))
    p.set_pipelined(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p.set_pipelined(2)

"""substrata_tpu_torch.physics.vehicles against the reference.

``vehicles_update`` (the wheel rays by kernel KH's twin, the force models by
kernel KJ's twin on the CPU) on the same seeded chassis, vehicle arrays and
inputs as the reference's: all four types, with brake, handbrake, reverse,
righting and the unflip window, over flat ground and over a heightfield.
Velocity deltas and controller state agree within 1e-5 relative (plus an
absolute floor of 1e-5 times the largest magnitude, for values that cancel
to near zero); gear and wheel contact are equal.  The gap is rounding: XLA
contracts ``a * b + c`` and its transcendentals (atan2, tan, cos) differ
from the CPU libm in the last bits.

Then short (90 to 120 ticks) ``VehicleManager`` + ``think`` runs of the
car, hovercar, boat and bike scenarios of tests/test_vehicles.py through
both packages, compared by chassis trajectory, and the tick of bench.py's
window 3 (``benchworld.full_tick``: the character and the Winter batch
too) at a small size, chained 10 ticks against the same composition of
reference functions; the Winter results match the jitted reference's
(rotations exactly, sin and cos within 1 ulp)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.audio import mix as jmix
from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import particles as jpart
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics.vehicles import manager as jveh
from substrata_tpu.physics.world import PhysicsObject as JObject
from substrata_tpu.physics.world import PhysicsWorld as JWorld
from substrata_tpu.scripting.winter import WinterScriptEvaluator as JScript
from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld, benchworld, convert
from substrata_tpu_torch.physics import shapes as tshapes
from substrata_tpu_torch.physics import state as tstate
from substrata_tpu_torch.physics.vehicles import manager as tveh

from torch_port_helpers import (box_config_kwargs, box_world_arrays, jax_body, params_np,
                                static_world_np)

torch.set_num_threads(2)

DT = 1.0 / 60.0
NV = 8
_jupdate = jax.jit(jveh.vehicles_update, static_argnames=("config",))
STATE_FIELDS = ("steering", "prev_sus_len", "wheel_omega", "wheel_rot", "unflip_time",
                "shift_timer", "engine_rpm")


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0) if np.size(want) else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def _quat_z(angle):
    return np.array([0, 0, np.sin(angle / 2), np.cos(angle / 2)], np.float32)


def _scene(seed, flat=True):
    """Eight chassis (two of each type) among 56 boxes; chassis tilted,
    moving and spinning at random, one hovercar upside down, the boats
    afloat; water at z = 0.5."""
    rng = np.random.default_rng(seed)
    arrays = box_world_arrays(256, 64, seed, z0=0.39, dz=0.79)
    _, im, ii, vol, bound = jstate.compute_shape_mass_props(
        jstate.ShapeType.BOX, np.array([0.9, 1.8, 0.4, 0], np.float32), density=150.0)
    for i in range(NV):
        arrays["pos"][i] = [-20.0 + 5.0 * i, 18.0, 0.8 if i % 4 != 2 else 0.3]
        arrays["shape_params"][i] = [0.9, 1.8, 0.4, 0]
        arrays["inv_mass"][i], arrays["inv_inertia"][i] = im, ii
        arrays["volume"][i], arrays["bound_radius"][i] = vol, bound
        tilt = rng.normal(0, 0.15, 3).astype(np.float32)
        q = np.concatenate([tilt * 0.5, [1.0]]).astype(np.float32)
        arrays["quat"][i] = q / np.linalg.norm(q)
        arrays["linvel"][i] = rng.normal(0, 3, 3)
        arrays["angvel"][i] = rng.normal(0, 0.5, 3)
    arrays["quat"][7] = [1.0, 0.0, 0.0, 0.0]                    # a hovercar on its roof
    arrays["linvel"][0, 1] = 6.0                                # a car rolling forward
    kw = box_config_kwargs(256)
    sw = jstate.default_static_world(0.0, water_z=0.5)
    if not flat:
        h = rng.uniform(-0.3, 0.3, (33, 33)).astype(np.float32)
        sw = sw.replace(heightfield=jstate.Heightfield(
            heights=jnp.asarray(h), origin=jnp.asarray([-30.0, -30.0], jnp.float32),
            cell_w=jnp.float32(2.0)))
    p = jstate.default_sim_params().replace(water_z=jnp.float32(0.5))

    v = {k: np.array(x) for k, x in vars(jveh.zero_vehicles(NV)).items()}
    for i in range(NV):
        vt = i % 4
        v["vtype"][i], v["body_slot"][i] = vt, i
        if vt == jveh.VEHICLE_CAR:
            v["wheel_attach"][i] = [[-0.8, 1.2, -0.2], [0.8, 1.2, -0.2],
                                    [-0.8, -1.2, -0.2], [0.8, -1.2, -0.2]]
            v["n_wheels"][i] = 4
        elif vt == jveh.VEHICLE_BIKE:
            v["wheel_attach"][i, :2] = [[0, 0.9, -0.4], [0, -0.9, -0.4]]
            v["n_wheels"][i], v["wheel_radius"][i] = 2, 0.3
            v["engine_torque"][i], v["engine_max_rpm"][i] = 390.0, 10000.0
        v["propellor_os"][i] = [0, -2.0, -0.3]
        v["areas"][i] = [1.5, 4.0, 8.0]
    v["y_fwd_quat"][4] = _quat_z(np.pi / 2)                     # a model rotated 90 deg
    v["active"][:] = True
    v["active"][5] = False
    v["steering"] = rng.uniform(-0.3, 0.3, NV).astype(np.float32)
    v["prev_sus_len"] = rng.uniform(0.1, 0.5, (NV, 4)).astype(np.float32)
    v["wheel_omega"] = rng.normal(0, 5, (NV, 4)).astype(np.float32)
    v["wheel_rot"] = rng.uniform(0, 6, (NV, 4)).astype(np.float32)
    v["gear"] = rng.integers(0, 5, NV).astype(np.int32)
    v["shift_timer"] = np.where(rng.random(NV) < 0.5, 0.0, rng.uniform(0, 0.4, NV)
                                ).astype(np.float32)
    v["unflip_time"][3] = 0.5
    v["righting_active"][[0, 1]] = True
    return (arrays, sw, p, kw, v)


INPUTS = {
    "bench": dict(forward=0.6, right=0.15),
    "brake": dict(forward=0.0, brake=True),
    "handbrake": dict(forward=1.0, right=-0.7, handbrake=True),
    "reverse": dict(forward=-1.0, right=0.4),
    "hover_lift": dict(forward=0.3, right=-0.2, up=1.0),
}


def _inputs(kind):
    d = INPUTS[kind]
    return {"forward": np.full(NV, d.get("forward", 0.0), np.float32),
            "right": np.full(NV, d.get("right", 0.0), np.float32),
            "up": np.full(NV, d.get("up", 0.0), np.float32),
            "brake": np.full(NV, d.get("brake", False)),
            "handbrake": np.full(NV, d.get("handbrake", False))}


def _run_update(arrays, sw, p, kw, v, inp):
    jout = _jupdate(jveh.VehicleArrays(**{k: jnp.asarray(x) for k, x in v.items()}),
                    jveh.VehicleInputs(**{k: jnp.asarray(x) for k, x in inp.items()}),
                    jax_body(arrays), sw, jnp.float32(DT), p, jstate.SimConfig(**kw))
    tout = tveh.vehicles_update(
        convert.vehicles_from_numpy(v, device="cpu"),
        convert.vehicle_inputs_from_numpy(inp, device="cpu"),
        convert.body_state_from_numpy(arrays, device="cpu"),
        convert.static_world_from_numpy(static_world_np(sw), device="cpu"), DT,
        convert.sim_params_from_numpy(params_np(p), device="cpu"), tstate.SimConfig(**kw))
    return jout, tout


def _compare_update(jout, tout, what):
    (jv, jdv, jdw, jslots), (tv, tdv, tdw, tslots) = jout, tout
    _close(tdv.numpy(), np.asarray(jdv), f"{what}: dv")
    _close(tdw.numpy(), np.asarray(jdw), f"{what}: dw")
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    for f in STATE_FIELDS:
        _close(getattr(tv, f).numpy(), np.asarray(getattr(jv, f)), f"{what}: {f}")
    for f in ("gear", "wheel_contact"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(jv, f)),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("kind", list(INPUTS))
def test_vehicles_update_matches_reference(kind):
    arrays, sw, p, kw, v = _scene(1)
    jout, tout = _run_update(arrays, sw, p, kw, v, _inputs(kind))
    _compare_update(jout, tout, kind)
    contact = np.asarray(jout[0].wheel_contact)
    assert contact[[0, 2, 4, 6]].any() and np.abs(np.asarray(jout[1])).max() > 0.01


def test_vehicles_update_mixed_inputs_over_heightfield():
    """Per-vehicle random inputs, chained 30 ticks on frozen bodies (the
    controller state carries over), over a bilinear heightfield."""
    arrays, sw, p, kw, v = _scene(2, flat=False)
    rng = np.random.default_rng(9)
    jv = v
    for t in range(30):
        inp = {"forward": rng.uniform(-1, 1, NV).astype(np.float32),
               "right": rng.uniform(-1, 1, NV).astype(np.float32),
               "up": rng.uniform(0, 1, NV).astype(np.float32),
               "brake": rng.random(NV) < 0.3, "handbrake": rng.random(NV) < 0.3}
        jout, tout = _run_update(arrays, sw, p, kw, jv, inp)
        _compare_update(jout, tout, f"tick {t}")
        # The reference's new state feeds both: each tick compares one step.
        jv = {k: np.asarray(x) for k, x in vars(jout[0]).items()}


def _facade(pkg):
    if pkg == "ref":
        w = JWorld(jstate.SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=8.0,
                                    solver_iters=8))
        return w, jveh, JObject, jshapes
    w = PhysicsWorld(tstate.SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=8.0,
                                      solver_iters=8), device="cpu")
    return w, tveh, PhysicsObject, tshapes


def _scenario(pkg, name):
    w, m, obj, shp = _facade(pkg)
    w.set_ground_plane(0.0)
    vm = m.VehicleManager(w)
    dyn = int(MotionType.DYNAMIC)
    if name == "boat":
        w.set_water_buoyancy_enabled(True)
        w.water_z = 0.0
        w.set_ground_plane(-30.0)
        # Launched near its waterline, so the propeller is under water.
        body = w.add_object(obj(shape=shp.make_box([1.0, 2.5, 0.6], density=400.0),
                                pos=np.array([0, 0, 0.1], np.float32), motion_type=dyn))
        veh = m.BoatPhysics(vm, body, m.VehicleSettings(thrust_force=30000.0))
        plan = [(m.VehiclePhysicsInput(), 20), (m.VehiclePhysicsInput(forward=1.0), 100)]
    elif name == "bike":
        body = w.add_object(obj(shape=shp.make_box([0.25, 1.0, 0.5], density=300.0),
                                pos=np.array([0, 0, 1.0], np.float32), motion_type=dyn))
        veh = m.BikePhysics(vm, body, m.VehicleSettings(
            wheel_attach_os=np.array([[0, 0.9, -0.4], [0, -0.9, -0.4]], np.float32),
            wheel_radius=0.3))
        plan = [(m.VehiclePhysicsInput(), 60), (m.VehiclePhysicsInput(forward=0.15), 60)]
    else:
        z, dens = (1.5, 100.0) if name == "hovercar" else (0.8, 150.0)
        body = w.add_object(obj(shape=shp.make_box([0.9, 1.8, 0.4], density=dens),
                                pos=np.array([0, 0, z], np.float32), motion_type=dyn,
                                friction=0.3))
        cls = m.HoverCarPhysics if name == "hovercar" else m.CarPhysics
        veh = cls(vm, body)
        plan = [(m.VehiclePhysicsInput(forward=1.0, right=0.5 if name == "car" else 0.0),
                 90)]
    veh.player_entered(0)
    trace = []
    for inp, ticks in plan:
        veh.update(inp)
        for _ in range(ticks):
            vm.update(DT)
            w.think(DT)
            w.sync_transforms()
            trace.append(np.concatenate([np.asarray(body.pos), np.asarray(body.linvel)]))
    return np.array(trace), veh, body


# Trajectory tolerance (m, m/s): the physics step alone tracks the
# reference within 1e-3 m (tests/test_torch_step.py); contacts under a
# driven chassis carry that, plus the force models' last-bit differences,
# through 120 ticks.
TRAJ_TOL = 2e-3


@pytest.mark.parametrize("name", ["car", "hovercar", "boat", "bike"])
def test_vehicle_scenarios_match_reference(name):
    jtrace, _, _ = _scenario("ref", name)
    ttrace, veh, body = _scenario("port", name)
    np.testing.assert_allclose(ttrace, jtrace, atol=TRAJ_TOL, rtol=0)
    # The reference tests' own checks, at these shorter lengths.
    if name == "car":
        assert body.pos[1] > 1.0 and abs(body.pos[0]) > 0.05
    elif name == "hovercar":
        assert body.pos[2] > 0.4 and body.pos[1] > 0.5
    elif name == "boat":
        assert -1.5 < ttrace[19, 2] < 1.0 and body.pos[1] > 0.5 and body.use_zero_linear_drag
    else:
        rot, omega, contact, sus = veh.get_wheel_state()
        assert contact[:2].any() and body.pos[1] > 0.05


def test_input_bitflags_and_doppler():
    inp = tveh.VehiclePhysicsInput(forward=1.0, right=-1.0, up=1.0, handbrake=True)
    back = tveh.VehiclePhysicsInput.from_bitflags(inp.to_bitflags())
    assert (back.forward, back.right, back.up, back.handbrake) == (1.0, -1.0, 1.0, True)
    w, m, obj, shp = _facade("port")
    body = w.add_object(obj(shape=shp.make_box([0.9, 1.8, 0.4]),
                            pos=np.array([0, 0, 0.8], np.float32),
                            motion_type=int(MotionType.DYNAMIC)))
    car = m.CarPhysics(m.VehicleManager(w), body)
    body.linvel = np.array([0, 20.0, 0], np.float32)
    assert car.get_doppler_factor([0, 100, 0]) > 1.0 > car.get_doppler_factor([0, -100, 0])


# --- The full tick at a small size against the reference's composition. ---

SMALL = dict(n_bodies=200, n_sources=16, n_particles=256, n_vehicles=4)


def _jax_full_tick_setup():
    from substrata_tpu.physics.world import PhysicsWorld as W
    kw = box_config_kwargs(256)
    kw.pop("present_shape_types")
    w = W(jstate.SimConfig(**kw))
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    side = int(np.ceil((SMALL["n_bodies"] / 3) ** 0.5))
    n = 0
    for iz in range(3):
        for ix in range(side):
            for iy in range(side):
                if n >= SMALL["n_bodies"]:
                    break
                pos = np.array([(ix - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                                (iy - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                                0.6 + iz * 1.2], np.float32)
                w.add_object(JObject(shape=jshapes.make_box([0.4, 0.4, 0.4]), pos=pos,
                                     motion_type=int(MotionType.DYNAMIC)))
                n += 1
    nv = SMALL["n_vehicles"]
    vm = jveh.VehicleManager(w, capacity=nv)
    classes = [jveh.CarPhysics, jveh.BikePhysics, jveh.BoatPhysics, jveh.HoverCarPhysics]
    first = [w.objects[s] for s in sorted(w.objects)[:nv]]
    for i in range(nv):
        classes[i % 4](vm, first[i])
        vm.set_active(i, True)
    vin = jveh.VehicleInputs(forward=jnp.full((nv,), 0.6), right=jnp.full((nv,), 0.15),
                             up=jnp.zeros((nv,)), brake=jnp.zeros((nv,), bool),
                             handbrake=jnp.zeros((nv,), bool))
    rng = np.random.default_rng(3)
    npart = SMALL["n_particles"]
    ps = jpart.zero_particles(npart)
    ps = ps.replace(pos=jnp.asarray(rng.uniform([-35, -35, 1], [35, 35, 8],
                                                (npart, 3)).astype(np.float32)),
                    vel=jnp.asarray(rng.normal(0, 2, (npart, 3)).astype(np.float32)),
                    opacity=jnp.ones((npart,)), alive=jnp.ones((npart,), bool))
    src = _jax_sources()
    return w, vm.veh, vin, ps, src


def _jax_sources():
    """bench.py:83-102's scene with 16 sources: the arrays of the port's
    ``benchworld.bench_audio`` handed to the reference as its state."""
    src, pool, lis, room = benchworld.bench_audio("cpu", n_sources=SMALL["n_sources"])
    a = convert.to_numpy(src)
    jsrc = jmix.zero_sources(SMALL["n_sources"]).replace(
        **{k: jnp.asarray(x) for k, x in a.items()})
    jroom = jmix.room_from_aabb([-60, -60, 0], [60, 60, 10], reflectivity=0.6)
    return jsrc, jnp.asarray(pool.numpy()), jmix.default_listener(), jroom


def test_full_tick_small_matches_reference():
    w, veh, vin, ps, (src, pool, lis, room) = _jax_full_tick_setup()
    tw = benchworld.bench_world("cpu", n_bodies=SMALL["n_bodies"],
                                cfg=tstate.SimConfig(**{k: x for k, x in box_config_kwargs(256)
                                                        .items() if k != "present_shape_types"}))
    tveh_, tvin, tps, tchar, tscripts = benchworld.bench_fulltick(
        tw, "cpu", n_particles=SMALL["n_particles"], n_vehicles=SMALL["n_vehicles"])
    # bench.py:192-207's Winter batch, jitted as bench.py runs it.
    jevs = [JScript(s) for s in benchworld.WINTER_SOURCES]
    widx = jnp.arange(benchworld.N_WINTER // 2, dtype=jnp.float32)
    jwinter = jax.jit(lambda t: jnp.concatenate([jnp.concatenate(
        [ev.eval_rotation(jnp.broadcast_to(t, widx.shape), widx, benchworld.N_WINTER),
         ev.eval_translation(jnp.broadcast_to(t, widx.shape), widx, benchworld.N_WINTER)],
        axis=1) for ev in jevs]))
    jc = jchar.init_character_state([0.0, 0.0, 3.0])
    tsrc, tpool, tlis, troom = benchworld.bench_audio("cpu", n_sources=SMALL["n_sources"])
    idx = jnp.arange(SMALL["n_sources"])
    tidx = torch.arange(SMALL["n_sources"])
    cfg = w.config
    tt = np.float32(0.0)
    for t in range(10):
        w._flush()
        table = jbp.build_cell_table(w.state, cfg)[0]
        veh, dv, dw, slots = _jupdate(veh, vin, w.state, w.static_world, jnp.float32(DT),
                                      w.params, cfg, table=table)
        w.state = jveh._apply_vehicle_deltas(w.state, slots, dv, dw)
        jt = jnp.float32(tt)
        move = 3.0 * jnp.array([jnp.cos(0.3 * jt), jnp.sin(0.3 * jt), 0.0])
        jc, _, _, _ = jchar.character_update(jc, w.state, w.static_world, move, False, False,
                                             False, jnp.float32(DT), w.params, cfg,
                                             exclude_body=jnp.int32(-1), table=table)
        w._world_asleep = False
        w.think(DT)
        ps, _ = jpart.particles_step(ps, w.state, w.static_world, jnp.float32(DT), w.params,
                                     cfg, table=table)
        src = src.replace(pos=w.state.pos[idx], vel=w.state.linvel[idx])
        src, out, room = jmix.mix_block(src, pool, lis, room=room, use_hrtf=True, block=800)

        tveh_, tps, tsrc, tout, troom, tchar = benchworld.full_tick(
            tw, tveh_, tvin, tps, tsrc, tpool, tlis, troom, tidx, tchar, float(tt), tscripts)
        # Rotation exact; translation's sin and cos within 1 ulp of XLA's.
        got, want = tscripts.out.numpy(), np.asarray(jwinter(jt))
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        np.testing.assert_array_max_ulp(got[:, 3:], want[:, 3:], maxulp=1)
        tt = tt + np.float32(DT)
        what = f"tick {t}"
        np.testing.assert_allclose(tw.state.pos.numpy(), np.asarray(w.state.pos), atol=1e-3,
                                   err_msg=what)
        np.testing.assert_allclose(tps.pos.numpy(), np.asarray(ps.pos), atol=1e-3, err_msg=what)
        np.testing.assert_array_equal(tps.alive.numpy(), np.asarray(ps.alive))
        np.testing.assert_array_equal(tveh_.gear.numpy(), np.asarray(veh.gear))
        # The rpm follows the chassis speed, which carries the step's bound.
        np.testing.assert_allclose(tveh_.engine_rpm.numpy(), np.asarray(veh.engine_rpm),
                                   rtol=1e-4, err_msg=what)
        np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-4, err_msg=what)
        # The character reads the stepped pile: the step's bound again.
        np.testing.assert_allclose(tchar.pos.numpy(), np.asarray(jc.pos), atol=1e-3, err_msg=what)
        assert bool(tchar.on_ground) == bool(jc.on_ground), what
    assert np.asarray(veh.wheel_contact).any()


@jax.jit
def _jsetup(veh, body):
    """The reference's pre-ray setup (vehicles_update :607-630) as its
    jitted program computes it."""
    from substrata_tpu.maths import quat as jquat
    from substrata_tpu.maths import transform as jtmath
    v = veh.vtype.shape[0]
    slots = jnp.maximum(veh.body_slot, 0)
    pos, quat = body.pos[slots], body.quat[slots]
    mass = 1.0 / jnp.maximum(body.inv_mass[slots], 1e-9)
    iw = jtmath.world_inv_inertia(quat, body.inv_inertia[slots])
    inv_yq = jquat.conjugate(veh.y_fwd_quat)
    up_os = jnp.cross(jquat.rotate_vec(inv_yq, jnp.array([1.0, 0.0, 0.0])),
                      jquat.rotate_vec(inv_yq, jnp.array([0.0, 1.0, 0.0])))
    up_w = jquat.rotate_vec(quat, up_os)
    attach_w = pos[:, None, :] + jquat.rotate_vec(quat[:, None, :], veh.wheel_attach)
    return (pos, quat, body.linvel[slots], body.angvel[slots], mass, iw,
            attach_w.reshape(v * 4, 3),
            jnp.broadcast_to(-up_w[:, None, :], (v, 4, 3)).reshape(v * 4, 3),
            jnp.broadcast_to((veh.sus_max + veh.wheel_radius)[:, None], (v, 4)).reshape(v * 4),
            jnp.broadcast_to(slots[:, None], (v, 4)).reshape(v * 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_kab_setup_and_scatter_match_reference(seed):
    """KAB's twin (``chassis_and_wheel_rays``, ``_apply_vehicle_deltas``)
    against the reference's operations on the same seeded scene: the four
    vehicle types (a model rotated 90 degrees, a hovercar on its roof),
    vehicle 6's body gone (slot -1), 8 distinct slots.  Gathers, masks and
    slots exact; the rotations, inertia and mass within 1e-6 of each
    output's scale (XLA contracts the rotation's products into fmas, the
    twin rounds each as the kernel does); the scatter exact: each slot's
    delta is added once to float32 velocities in both."""
    arrays, sw, p, kw, v = _scene(seed)
    v["body_slot"][6] = -1
    jv = jveh.VehicleArrays(**{k: jnp.asarray(x) for k, x in v.items()})
    tv = convert.vehicles_from_numpy(v, device="cpu")
    body = convert.body_state_from_numpy(arrays, device="cpu")
    want = [np.asarray(x) for x in _jsetup(jv, jax_body(arrays))]
    chassis, rays = tveh.chassis_and_wheel_rays(tv, body)
    got = [x.numpy() for x in chassis + rays]
    names = ("pos", "quat", "linvel", "angvel", "mass", "iw", "origins", "dirs", "max_ts",
             "exclude")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name in ("pos", "quat", "linvel", "angvel", "max_ts", "exclude"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale, err_msg=name)

    rng = np.random.default_rng(seed + 10)
    dv = rng.normal(0, 2, (NV, 3)).astype(np.float32)
    dw = rng.normal(0, 1, (NV, 3)).astype(np.float32)
    arrays["awake"][:NV] = False
    arrays["sleep_timer"][:NV] = 0.7
    slots = v["body_slot"].astype(np.int32)
    jstate_out = jveh._apply_vehicle_deltas(jax_body(arrays), jnp.asarray(slots),
                                            jnp.asarray(dv), jnp.asarray(dw))
    body = convert.body_state_from_numpy(arrays, device="cpu")
    tstate_out = tveh._apply_vehicle_deltas(body, torch.as_tensor(slots), torch.as_tensor(dv),
                                            torch.as_tensor(dw))
    for f in ("linvel", "angvel", "awake", "sleep_timer"):
        np.testing.assert_array_equal(getattr(tstate_out, f).numpy(),
                                      np.asarray(getattr(jstate_out, f)), err_msg=f)
    assert not bool(tstate_out.awake[6]) and float(tstate_out.sleep_timer[6]) == np.float32(0.7)

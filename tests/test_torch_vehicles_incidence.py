"""KJ's twin (kernels/vehicles.py:vehicle_forces_plain) against the
reference's ``_vehicle_update_one`` under ``jax.vmap`` on
kernels/hard_cases.py's vehicle scenes, and KT's incidence twin
(kernels/layout.py:incidence_plain) against the reference's
``solver.build_incidence`` on its incidence scenes; and both wrappers'
CUDA branches (each one's plan per shape, the packed launch, the checks)
driven on ``meta`` tensors.

The vehicle scenes: each type active and inactive, every wheel airborne,
2 and 4 wheels, rpm on the shift edges, inputs and speed on the reverse
and brake edges, the hovercar's unflip window, a boat's propeller at the
water level and one float either side, chassis speeds up to 1e-3, the
righting controller, 1 and 33 vehicles.  Velocity deltas and controller
state agree within 1e-5 relative plus 1e-5 of the output's largest
magnitude (tests/test_torch_vehicles.py's tolerance: XLA contracts ``a * b
+ c`` and its transcendentals differ from the CPU libm in the last bits);
gear and wheel contact are equal.

The incidence scenes: no occupied entry, every b static, a body in exactly
64 and in 65 keys, one body in every entry, a body both a and b of one
entry, cpb 1, 8 and 16, a ragged body count, a pair-blocked stride of 4
and the largest packed key; table, sign and counts equal the reference's
exactly.  ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the
kernels to these twins on the same scenes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics.vehicles import manager as jveh
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import layout as kt
from substrata_tpu_torch.kernels import vehicles as kj

torch.set_num_threads(2)

# The reference's per-vehicle arguments, in _vehicle_update_one's order.
_REF_VEH = ("y_fwd_quat", "wheel_attach", "wheel_radius", "n_wheels", "sus_min", "sus_max",
            "spring_freq", "spring_damping", "max_steer", "engine_torque", "engine_max_rpm",
            "brake_torque", "handbrake_torque", "mu_long", "mu_lat", "steer_relax",
            "lean_spring", "lean_damping", "thrust_force", "propellor_os", "rudder_factor",
            "thrust_lateral", "areas", "steering", "prev_sus_len", "wheel_omega", "wheel_rot",
            "unflip_time", "righting_active", "gear", "shift_timer")
_ref_update = jax.jit(jax.vmap(jveh._vehicle_update_one, in_axes=(0,) * 47 + (None, None)))
_ref_incidence = jax.jit(jsolver.build_incidence, static_argnames=("n_bodies", "cpb"))
OUTPUTS = ("dv", "dw", "steering", "sus_len", "omega", "rot", "unflip", "contact", "gear",
           "shift_timer", "rpm")


def _ref_vehicles(scene):
    v, i = scene.veh, scene.inp
    pos, quat, lin, ang, mass, iw = scene.chassis
    args = ([v["vtype"], v["active"], pos, quat, lin, ang, mass, iw]
            + [i[k] for k in ("forward", "right", "up", "brake", "handbrake")]
            + [v[k] for k in _REF_VEH] + list(scene.hits))
    return _ref_update(*(jnp.asarray(x) for x in args), jnp.float32(scene.water_z),
                       jnp.float32(scene.dt))


@pytest.mark.parametrize("case", hard_cases.VEHICLE_CASES)
def test_vehicle_scene_twin_matches_reference(case):
    scene = hard_cases.vehicle_scene(case)
    got = kj.vehicle_forces(*hard_cases.vehicle_inputs(scene, "cpu"))
    want = _ref_vehicles(scene)
    for name, g, w in zip(OUTPUTS, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("contact", "gear"):
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
            continue
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"{case} {name}")
    gear0, contact = scene.veh["gear"], np.asarray(want[7])
    # The cases are really there.
    if case == "airborne":
        assert not contact.any()
    elif case == "shift_edges":
        shifted = np.asarray(want[8]) != gear0
        assert shifted.any() and not shifted.all()
    elif case == "unflip":
        u = np.asarray(want[6])
        assert u[0] == 1.0 and u[1] == 0.0 and u[2] == -1.0 and 0 < u[3] < 0.5 and u[7] == 0.5
    elif case == "prop_waterline":
        # Thrust and rudder turn the boat only with the propeller in the water.
        dw = np.abs(np.asarray(want[1])).sum(axis=1)
        assert dw[0] > 0 and dw[1] == 0.0 and dw[2] > 0
    elif case in ("types", "v33"):
        assert contact.any() and not scene.veh["active"].all()


@pytest.mark.parametrize("case", hard_cases.INCIDENCE_CASES)
def test_incidence_scene_twin_matches_reference(case):
    scene = hard_cases.incidence_scene(case)
    a, b, occ, n, cpb = hard_cases.incidence_inputs(scene, "cpu")
    got = kt.incidence(a, b, occ, n, cpb)
    want = _ref_incidence(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                          jnp.asarray(occ.numpy()), n_bodies=n, cpb=cpb)
    for name, g, w in zip(("table", "sign", "counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{case} {name}")
    keys = np.bincount(np.concatenate([a.numpy()[occ.numpy()],
                                       b.numpy()[occ.numpy() & (b.numpy() >= 0)]]),
                       minlength=n)
    if case in ("list_64", "list_65"):
        assert keys[5] == int(case[5:])
    elif case == "none_occupied":
        assert keys.sum() == 0 and (got[0].numpy() == -1).all()
    elif case == "one_body_everywhere":
        assert keys[3] == a.shape[0] and got[2][3] == cpb
    elif case == "key_bits":
        assert n.bit_length() + a.shape[0].bit_length() + 1 == 32
        with pytest.raises(ValueError):
            kt.incidence(a[:1].expand(2 * a.shape[0]).contiguous(), b[:1].expand(
                2 * a.shape[0]).contiguous(), occ[:1].expand(2 * a.shape[0]).contiguous(), n,
                cpb)


# --- KJ's and the incidence's CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if x is None or isinstance(x, (bool, int, float)):
        return x
    return x.replace(**{f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)})


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(kj, "_plans", {})
    monkeypatch.setattr(kt, "_inc_plans", {})
    return calls


@pytest.mark.parametrize("case", ["v1", "types", "v33"])
def test_vehicle_plan_packs_and_checks(recorded, case):
    """One plan per (V, device); the packed launch holds the 48 inputs in
    the kernel's order, one output buffer of 24 floats a vehicle, V and dt;
    the outputs are views of that buffer with the twin's shapes and dtypes;
    a bad argument raises before a launch."""
    scene = hard_cases.vehicle_scene(case)
    cpu_args = hard_cases.vehicle_inputs(scene, "cpu")
    args = [_meta(x) for x in cpu_args]
    nv = scene.veh["vtype"].shape[0]
    got = kj.vehicle_forces(*args)
    want = kj.vehicle_forces_plain(*cpu_args)
    assert [(tuple(g.shape), g.dtype) for g in got] == [(tuple(w.shape), w.dtype) for w in want]
    name, packed = recorded[-1]
    v = kj._PACK.unpack(packed)
    assert name == "vehicle_forces" and len(packed) == 51 * 8
    assert v[49] == nv and v[50] == float(np.float32(scene.dt))
    base = got[0]._base
    assert base is not None and tuple(base.shape) == (kj._OUT_FLOATS * nv,)
    assert all(g._base is base for g in got[:7]) and got[9]._base is base
    plan = next(iter(kj._plans.values()))
    assert plan.NAMES[:33] == kj.KERNEL_FIELDS and len(plan.NAMES) == 48
    assert dict(zip(plan.NAMES, plan.shapes))["wheel_attach"] == (nv, 4, 3)
    kj.vehicle_forces(*args)
    assert len(kj._plans) == 1 and len(recorded) == 2
    veh, inp = args[0], args[1]
    bads = (([veh.replace(gear=veh.gear.float())] + args[1:], TypeError),
            ([veh.replace(wheel_attach=torch.empty((nv, 4, 4), device="meta")[..., :3])]
             + args[1:], ValueError),
            ([veh.replace(areas=torch.empty((nv, 4), device="meta"))] + args[1:], ValueError),
            ([veh, inp.replace(brake=inp.brake.float())] + args[2:], TypeError),
            (args[:8] + [args[8][:, :3]] + args[9:], ValueError),
            (args[:11] + [torch.empty(1, device="meta")] + args[12:], ValueError))
    for bad, exc in bads:
        with pytest.raises(exc):
            kj.vehicle_forces(*bad)
    assert len(recorded) == 2


@pytest.mark.parametrize("case", ["ragged_n", "blocked_st4", "cpb16"])
def test_incidence_plan_packs_and_checks(recorded, case):
    """One plan per (N, C, CPB, device, stream): its zeroed counters and
    lists, never the outputs (a table kept by the caller is not written by
    the next call); the packed launch's pointers and sizes at the entries'
    stride; a bad argument raises before a launch; a failed launch drops
    the plan, so its counters are not reused."""
    scene = hard_cases.incidence_scene(case)
    a, b, occ, n, cpb = (_meta(x) for x in hard_cases.incidence_inputs(scene, "cpu"))
    a = torch.empty(a.shape[0] * scene.st, dtype=torch.int32, device="meta")[::scene.st]
    b = torch.empty_like(a.as_strided((a.shape[0] * scene.st,), (1,)))[::scene.st]
    table, sign, counts = kt.incidence(a, b, occ, n, cpb)
    assert tuple(table.shape) == (n, cpb) and table.dtype == torch.int32
    assert tuple(sign.shape) == (n, cpb) and sign.dtype == torch.float32
    assert tuple(counts.shape) == (n,) and counts.dtype == torch.float32
    name, packed = recorded[-1]
    v = kt._INC_PACK.unpack(packed)
    assert name == "layout_incidence" and v[7:] == (scene.st, a.shape[0], n, cpb)
    (key, scratch), = kt._inc_plans.items()
    assert key[:3] == (n, a.shape[0], cpb) and key[4] == 0
    assert tuple(scratch.shape) == (n * (1 + kt.INC_LIST),)
    for t in (table, sign, counts):
        assert t._base is not scratch and t is not scratch
    t2 = kt.incidence(a, b, occ, n, cpb)[0]
    assert t2._base is not table._base and len(kt._inc_plans) == 1
    kt.incidence(a, b, occ, n, cpb + 1)
    assert len(kt._inc_plans) == 2 and len(recorded) == 3
    bads = ((a.long(), b, occ), (a, b[:-1], occ), (a, b, occ[:-1]), (a, b, occ.int()))
    for ba, bb, bo in bads:
        with pytest.raises((TypeError, ValueError)):
            kt.incidence(ba, bb, bo, n, cpb)
    if scene.st > 1:
        with pytest.raises(ValueError):
            kt.incidence(a, b.contiguous(), occ, n, cpb)
    assert len(recorded) == 3


def test_incidence_launch_error_drops_plan(monkeypatch):
    def fail(name, args):
        raise RuntimeError("kernel layout_incidence failed to launch")
    monkeypatch.setattr(build, "launch_packed", fail)
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(kt, "_inc_plans", {})
    a, b, occ, n, cpb = (_meta(x) for x in hard_cases.incidence_inputs(
        hard_cases.incidence_scene("ragged_n"), "cpu"))
    with pytest.raises(RuntimeError):
        kt.incidence(a, b, occ, n, cpb)
    assert kt._inc_plans == {}

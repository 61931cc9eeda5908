"""substrata_tpu_torch.physics.integrate (kernel KD's plain twins and the
plain sleep pass) against substrata_tpu.physics.integrate.

Inputs: seeded boxes with random poses and velocities, half of them
straddling a water plane, some with zero linear drag, a few kinematic,
static or dead; handed to both packages as numpy.  Tolerances:
- apply_forces: 1e-5 absolute and relative on velocities (float32; the
  reference takes norms and the power 2/3 through other library calls,
  so the last bit or two can differ); the in-water mask equal;
- integrate_positions: 1e-6 absolute (unit quaternions, positions of a
  few metres: a few float32 ulps);
- update_sleeping: equal (comparisons, selections and one addition, in
  the same order on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.physics import integrate as jint
from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import sleep as ksleep
from substrata_tpu_torch.physics import integrate as tint

from torch_port_helpers import body_np, box_world_arrays, jax_body, params_np

torch.set_num_threads(2)

DT = 1.0 / 60.0
CAP = 64
N_BOXES = 48
WATER_Z = 0.5


def _arrays(seed):
    a = box_world_arrays(CAP, N_BOXES, seed, speed=2.0)
    rng = np.random.default_rng(seed + 100)
    q = rng.normal(size=(N_BOXES, 4)).astype(np.float32)
    a["quat"][:N_BOXES] = q / np.linalg.norm(q, axis=1, keepdims=True)
    a["pos"][:N_BOXES, 2] = rng.uniform(-1.0, 2.0, N_BOXES)
    a["use_zero_linear_drag"][:N_BOXES] = rng.random(N_BOXES) < 0.3
    a["linear_damping"][:N_BOXES] = rng.uniform(0.0, 0.5, N_BOXES)
    a["motion_type"][:4] = int(jstate.MotionType.KINEMATIC)
    a["motion_type"][4:6] = int(jstate.MotionType.STATIC)
    a["awake"][6:9] = False
    a["alive"][9] = False
    a["sleep_timer"][:N_BOXES] = rng.uniform(0.3, 0.6, N_BOXES)
    slow = rng.random(N_BOXES) < 0.5
    a["linvel"][:N_BOXES][slow] *= 1e-3
    a["angvel"][:N_BOXES][slow] *= 1e-3
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def _both(seed):
    arrays = _arrays(seed)
    jp = jstate.default_sim_params().replace(water_z=jnp.float32(WATER_Z))
    return (jax_body(arrays), jp, convert.body_state_from_numpy(arrays, device="cpu"),
            convert.sim_params_from_numpy(params_np(jp), device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_forces_and_integrate_match_reference(seed):
    jb, jp, tb, tp = _both(seed)
    jlin, jang, jwet = jint.apply_forces(jb, jnp.float32(DT), jp)
    tlin, tang, twet = tint.apply_forces(tb, DT, tp)
    np.testing.assert_array_equal(twet.numpy(), np.asarray(jwet))
    assert 5 < int(twet.sum()) < N_BOXES          # the water plane cuts the set
    np.testing.assert_allclose(tlin.numpy(), np.asarray(jlin), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tang.numpy(), np.asarray(jang), rtol=1e-5, atol=1e-5)

    lin = np.array(jlin)
    ang = np.array(jang)
    jpos, jq = jint.integrate_positions(jb, jnp.asarray(lin), jnp.asarray(ang),
                                        jnp.float32(DT))
    tpos, tq = tint.integrate_positions(tb, torch.from_numpy(lin), torch.from_numpy(ang), DT)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_update_sleeping_matches_reference(seed):
    jb, jp, tb, tp = _both(seed)
    rng = np.random.default_rng(seed + 200)
    c = 96
    ca = rng.integers(0, N_BOXES, c).astype(np.int32)
    cb = rng.integers(-1, N_BOXES, c).astype(np.int32)
    valid = rng.random(c) < 0.8
    imp = rng.uniform(0.0, 2e-4, c).astype(np.float32)
    pen = rng.uniform(-0.05, 0.15, c).astype(np.float32)
    deep = rng.random(CAP) < 0.1
    table, sign, _ = jsolver.build_incidence(jnp.asarray(ca), jnp.asarray(cb),
                                             jnp.asarray(valid), CAP, 8)
    table, sign = np.array(table), np.array(sign)
    lin, ang = np.array(body_np(jb)["linvel"]), np.array(body_np(jb)["angvel"])
    jres = jint.update_sleeping(
        jb, jnp.asarray(lin), jnp.asarray(ang), jnp.asarray(ca), jnp.asarray(cb),
        jnp.asarray(imp), jnp.asarray(valid), jnp.asarray(table), jnp.asarray(sign),
        jnp.float32(DT), jp, contact_pen=jnp.asarray(pen), extra_deep=jnp.asarray(deep))
    t = torch.from_numpy
    tres = ksleep.update_sleeping_plain(
        tb, t(lin), t(ang), t(ca), t(cb), t(imp), t(valid), t(table), t(sign), DT, tp,
        contact_pen=t(pen), extra_deep=t(deep))
    for name, jx, tx in zip(("awake", "sleep_timer", "linvel", "angvel"), jres, tres):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx), err_msg=name)
    awake0 = body_np(jb)["awake"]
    awake1 = tres[0].numpy()
    assert (awake0 & ~awake1).any() and (~awake0 & awake1).any()   # sleeps and wakes

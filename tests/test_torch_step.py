"""substrata_tpu_torch.physics.step against substrata_tpu.physics.step.

The same seeded box world (the bench world's shape cut to ~200 boxes in 3
touching layers, non-overflowing) goes through both packages' physics
step on the CPU.  Tolerances:
- one step: integer outputs (pairs, awake, events, counts) equal; float
  state within 1e-4 absolute — the port rounds at the same bf16 points as
  the reference, and the rest differs only in float summation order;
- 10 steps: positions within 1e-3 m (the ROADMAP's slice-1 bound), events
  and diagnostics counts equal at every step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics.step import physics_step as jstep

from substrata_tpu_torch import convert
from substrata_tpu_torch.physics import state as tstate
from substrata_tpu_torch.physics.step import physics_step as tstep

from torch_port_helpers import (body_np, box_config_kwargs, box_world_arrays,
                                jax_body, params_np, static_world_np)

torch.set_num_threads(2)

DT = 1.0 / 60.0
CAP = 256
N_BOXES = 200


def _setup(seed=0):
    arrays = box_world_arrays(CAP, N_BOXES, seed, z0=0.39, dz=0.79, speed=0.5)
    kw = box_config_kwargs(CAP)
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jw = jstate.default_static_world(ground_z=0.0)
    jp = jstate.default_sim_params()
    jsc = jsolver.empty_solver_cache(jsolver.cache_size_for(jcfg))
    jpc = jbp.empty_pair_cache(jcfg)
    j = dict(body=jax_body(arrays), world=jw, params=jp, config=jcfg,
             sc=jsc, pc=jpc)
    t = dict(body=convert.body_state_from_numpy(arrays, device="cpu"),
             world=convert.static_world_from_numpy(static_world_np(jw), device="cpu"),
             params=convert.sim_params_from_numpy(params_np(jp), device="cpu"), config=tcfg,
             sc=convert.solver_cache_from_numpy(np.asarray(jsc.data), device="cpu"),
             pc=convert.pair_cache_from_numpy(
                 {f: np.asarray(getattr(jpc, f)) for f in vars(jpc)}, device="cpu"))
    return j, t


def _jax_step(j, rebuild):
    body, sc, pc, ev, dg = jstep(j["body"], j["world"], jnp.zeros((64, 8, 3)),
                                 jnp.float32(DT), j["params"], j["config"],
                                 j["sc"], j["pc"], rebuild_pairs=rebuild,
                                 has_oversize=False)
    j.update(body=body, sc=sc, pc=pc)
    return ev, dg


def _torch_step(t, rebuild):
    body, sc, pc, ev, dg = tstep(t["body"], t["world"], DT, t["params"],
                                 t["config"], t["sc"], t["pc"],
                                 rebuild_pairs=rebuild, has_oversize=False)
    t.update(body=body, sc=sc, pc=pc)
    return ev, dg


def _events_equal(jev, tev):
    for f in ("contact_pair_a", "contact_pair_b", "contact_touching",
              "newly_awake", "newly_asleep", "entered_water", "num_pairs",
              "broadphase_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jev, f)),
                                      getattr(tev, f).numpy(), err_msg=f)


def _diags_equal(jdg, tdg):
    for f in ("num_pairs", "num_contacts", "num_awake"):
        assert int(getattr(jdg, f)) == int(getattr(tdg, f)), f
    np.testing.assert_allclose(float(jdg.max_penetration),
                               float(tdg.max_penetration), atol=1e-4)


@pytest.fixture(scope="module")
def one_step():
    j, t = _setup()
    jev, jdg = _jax_step(j, True)
    tev, tdg = _torch_step(t, True)
    first = (body_np(j["body"]), convert.to_numpy(t["body"]), jev, tev, jdg, tdg)
    jev, jdg = _jax_step(j, False)
    tev, tdg = _torch_step(t, False)
    second = (body_np(j["body"]), convert.to_numpy(t["body"]), jev, tev, jdg, tdg, j, t)
    return first, second


@pytest.mark.parametrize("which", ["rebuild", "reuse"])
def test_physics_step_matches_reference(one_step, which):
    res = one_step[0] if which == "rebuild" else one_step[1]
    jb, tb, jev, tev, jdg, tdg = res[:6]
    assert int(jdg.num_pairs) > 50 and int(jdg.num_contacts) > 200
    for f in ("pos", "quat", "linvel", "angvel", "sleep_timer"):
        np.testing.assert_allclose(tb[f], jb[f], atol=1e-4, err_msg=f)
    for f in ("awake", "underwater", "alive"):
        np.testing.assert_array_equal(tb[f], jb[f], err_msg=f)
    _events_equal(jev, tev)
    _diags_equal(jdg, tdg)


def test_pair_cache_and_incidence_carry(one_step):
    j, t = one_step[1][6:]
    for f in ("pair_a", "pair_b", "pair_valid", "num_pairs", "steps_left",
              "inc_table", "inc_sign"):
        np.testing.assert_array_equal(getattr(t["pc"], f).numpy(),
                                      np.asarray(getattr(j["pc"], f)), err_msg=f)


def test_ten_steps_track_reference():
    j, t = _setup(seed=1)
    j_left = t_left = 0
    for step in range(10):
        jev, jdg = _jax_step(j, j_left <= 0)
        tev, tdg = _torch_step(t, t_left <= 0)
        j_left, t_left = int(j["pc"].steps_left), int(t["pc"].steps_left)
        assert j_left == t_left, step
        _events_equal(jev, tev)
        _diags_equal(jdg, tdg)
    np.testing.assert_allclose(convert.to_numpy(t["body"])["pos"], body_np(j["body"])["pos"],
                               atol=1e-3)
    np.testing.assert_array_equal(convert.to_numpy(t["body"])["awake"],
                                  body_np(j["body"])["awake"])

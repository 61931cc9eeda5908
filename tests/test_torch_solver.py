"""substrata_tpu_torch.physics.solver (kernel KC's plain twin and the plain
setup) against substrata_tpu.physics.solver, from the same contacts.

Inputs: the reference's own contact rows for a seeded ~200-box world in
touching layers, handed to both solvers as numpy.  Tolerances:
- incidence table, signs and counts: equal;
- velocities and impulses: 1e-4 relative to the largest magnitude — both
  round the pair payloads to bf16 at the same points and differ only in
  float32 summation order;
- warm-start cache rows: equal keys, impulses as above, on the slots that
  exactly one row writes (a colliding write has no specified winner)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import integrate as jint
from substrata_tpu.physics import narrowphase as jnp_phase
from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import solve_setup
from substrata_tpu_torch.physics import narrowphase as tnp_phase
from substrata_tpu_torch.physics import solver as tsolver
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import (box_config_kwargs, box_world_arrays, jax_body,
                                params_np)

torch.set_num_threads(2)

# The reference's functions are meant to run jitted (eager op-by-op
# dispatch of the unrolled solve takes tens of seconds on the CPU).
_find_pairs = jax.jit(jbp.find_pairs, static_argnames=("config", "has_oversize"))
_pair_contacts = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))
_static_contacts = jax.jit(jnp_phase.static_contacts, static_argnames=("config",))
_build_incidence = jax.jit(jsolver.build_incidence, static_argnames=("n_bodies", "cpb"))
_solve_contacts = jax.jit(jsolver.solve_contacts, static_argnames=("config", "wm"))
_solve_positions = jax.jit(jsolver.solve_positions,
                           static_argnames=("config", "iters", "beta", "wm"))

DT = 1.0 / 60.0
CAP = 256
WM = 4


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _t_contacts(jc):
    return tnp_phase.Contacts(*[torch.tensor(np.asarray(getattr(jc, f)))
                                for f in tnp_phase.CONTACT_FIELDS])


@pytest.fixture(scope="module")
def scene():
    arrays = box_world_arrays(CAP, 200, 7, z0=0.39, dz=0.79, speed=0.5)
    kw = box_config_kwargs(CAP)
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jp = jstate.default_sim_params()
    jb = jax_body(arrays)
    lin, ang, _ = jint.apply_forces(jb, jnp.float32(DT), jp)
    jb = jb.replace(linvel=lin, angvel=ang)
    pa, pb, pv, _, _ = _find_pairs(jb, jcfg, has_oversize=False)
    pair_cts, _, _ = _pair_contacts(jb, pa, pb, pv, config=jcfg, blocked_wm=WM)
    static_cts = _static_contacts(jb, jstate.default_static_world(ground_z=0.0),
                                  jnp.zeros((64, 8, 3)), config=jcfg)
    q = pair_cts.capacity // WM
    e_a = pair_cts.a.reshape(q, WM)[:, 0]
    e_b = pair_cts.b.reshape(q, WM)[:, 0]
    table, sign, counts = _build_incidence(e_a, e_b, e_a >= 0, n_bodies=CAP,
                                           cpb=jcfg.contacts_per_body)
    # A warm cache: the reference's impulses from one solve of these contacts.
    cache0 = jsolver.empty_solver_cache(jsolver.cache_size_for(jcfg))
    warm = _solve_contacts(jb, static_cts, pair_cts, jnp.float32(DT), jp, config=jcfg,
                           cache=cache0, wm=WM, table=table, sign=sign)[6]
    tb = convert.body_state_from_numpy({k: np.asarray(getattr(jb, k))
                                        for k in tstate.BODY_FIELDS}, device="cpu")
    return dict(jb=jb, tb=tb, jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=convert.sim_params_from_numpy(params_np(jp), device="cpu"),
                jpair=pair_cts, jstatic=static_cts,
                tpair=_t_contacts(pair_cts), tstatic=_t_contacts(static_cts),
                e=(e_a, e_b), inc=(table, sign, counts), jwarm=warm,
                twarm=convert.solver_cache_from_numpy(np.asarray(warm.data), device="cpu"))


def test_build_incidence_equal(scene):
    e_a, e_b = (torch.tensor(np.asarray(x)) for x in scene["e"])
    t = tsolver.build_incidence(e_a, e_b, e_a >= 0, CAP, scene["tcfg"].contacts_per_body)
    for got, want in zip(t, scene["inc"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((t[0] >= 0).sum()) > 200


def test_cache_hash_equal():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 65536, 4000).astype(np.int32)
    k = rng.integers(0, 65536 * 4 + 9, 4000).astype(np.int32)
    for size in (1 << 10, 1 << 18):
        np.testing.assert_array_equal(
            solve_setup.cache_hash(torch.tensor(a), torch.tensor(k), size).numpy(),
            np.asarray(jsolver._cache_hash(jnp.asarray(a), jnp.asarray(k), size)))


@pytest.mark.parametrize("warm", [False, True])
def test_solve_contacts_matches_reference(scene, warm):
    s = scene
    table, sign, _ = s["inc"]
    jres = _solve_contacts(s["jb"], s["jstatic"], s["jpair"], jnp.float32(DT),
                           s["jp"], config=s["jcfg"], cache=s["jwarm"] if warm else None,
                           wm=WM, table=table, sign=sign)
    tres = tsolver.solve_contacts(s["tb"], s["tstatic"], s["tpair"], DT, s["tp"],
                                  s["tcfg"], s["twarm"] if warm else None, wm=WM,
                                  table=torch.tensor(np.asarray(table)),
                                  sign=torch.tensor(np.asarray(sign)))
    for i in (0, 1, 2, 5):           # linvel, angvel, pair and static lambda_n
        _close(tres[i].numpy(), jres[i])
    assert float(np.abs(np.asarray(jres[2])).max()) > 1e-3
    if warm:
        jd = np.asarray(jres[6].data)
        td = tres[6].data.numpy()
        a = np.concatenate([np.asarray(s["jstatic"].a), np.asarray(s["jpair"].a)])
        key = np.concatenate([np.asarray(s["jstatic"].key), np.asarray(s["jpair"].key)])
        valid = np.concatenate([np.asarray(s["jstatic"].valid),
                                np.asarray(s["jpair"].valid)]) & (a >= 0)
        h = np.asarray(jsolver._cache_hash(jnp.asarray(np.maximum(a, 0)), jnp.asarray(key),
                                           jd.shape[0]))[valid]
        slots, n_writes = np.unique(h, return_counts=True)
        single = slots[n_writes == 1]
        assert len(single) > 500
        np.testing.assert_array_equal(td[single, :2].view(np.int32),
                                      jd[single, :2].view(np.int32))
        _close(td[single, 2:], jd[single, 2:])


def test_solve_positions_matches_reference(scene):
    s = scene
    table, sign, _ = s["inc"]
    pos = s["jb"].pos + 0.01
    jpos = _solve_positions(pos, s["jb"], s["jstatic"], s["jpair"], table, sign,
                            s["jp"], config=s["jcfg"], wm=WM)
    tpos = tsolver.solve_positions(torch.tensor(np.asarray(pos)), s["tb"], s["tstatic"],
                                   s["tpair"], torch.tensor(np.asarray(table)),
                                   torch.tensor(np.asarray(sign)), s["tp"], s["tcfg"],
                                   wm=WM)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-5, rtol=0)
    assert float(np.abs(np.asarray(jpos) - np.asarray(pos)).max()) > 1e-4


def test_targets_divide_by_traced_dt(scene):
    """The reference's dt is traced (physics/step.py:53 leaves it out of the
    static names), so its solve targets divide by it; 1/60 has an inexact
    float32 reciprocal, and a multiply by it would round differently.  With
    the bodies at rest no restitution target competes, so the targets are
    the bias formula of solver.py:323-328, jitted with dt traced."""
    s = scene
    tb = s["tb"].replace(linvel=torch.zeros_like(s["tb"].linvel),
                         angvel=torch.zeros_like(s["tb"].angvel))
    rng = np.random.default_rng(1)
    pens = [rng.uniform(-0.05, 0.1, c.penetration.shape).astype(np.float32)
            for c in (s["tstatic"], s["tpair"])]
    tstatic, tpair = (c.replace(penetration=torch.as_tensor(p))
                      for c, p in zip((s["tstatic"], s["tpair"]), pens))
    table, sign, _ = s["inc"]
    setup = tsolver.prepare_solve(tb, tstatic, tpair, DT, s["tp"], s["tcfg"],
                                  wm=WM, table=torch.tensor(np.asarray(table)),
                                  sign=torch.tensor(np.asarray(sign)))

    @jax.jit
    def bias(pen, baumgarte, dt):
        return jnp.where(pen > 0.0, jnp.minimum((baumgarte / dt) * jnp.maximum(pen - 0.04, 0.0),
                                                3.0), pen / dt)

    for pen, got in zip(pens, (setup.rows.s_target, setup.rows.p_target)):
        want = np.asarray(bias(jnp.asarray(pen), s["jp"].baumgarte, jnp.float32(DT)))
        np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
        assert (pen * (np.float32(1) / np.float32(DT)) != pen / np.float32(DT)).sum() > 100

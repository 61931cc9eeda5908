"""Division by a static value, held against the reference where it rounds.

XLA's CPU compiler folds ``x / c`` for a compile-time constant ``c`` (a
static config field or a literal) into ``x * fl(1/c)``, and fuses a
multiply that an add follows into one rounding.  The port repeats both:
``maths.fp.recip`` for the cell indices of the cell table, the rays and
the character, one multiply-add for a ray's march point.  With the
bench's 1.4 m cells the reciprocal is inexact, so positions at k * 1.4
and one ulp either side are where a true division would pick another
cell.  Cells, tables, overflow counts, ray hits (t and normals too) and
character states are held equal, bit for bit; each test also checks that
its inputs do separate the two roundings."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import queries as jq
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.physics import broadphase as tbp
from substrata_tpu_torch.physics import character as tchar
from substrata_tpu_torch.physics import queries as tq
from substrata_tpu_torch.physics.state import SimConfig

from torch_port_helpers import (box_config_kwargs, box_world_arrays, jax_body, params_np,
                                static_world_np)

torch.set_num_threads(2)

CELL = np.float32(1.4)
CAP = 256
_jcell_table = jax.jit(jbp.build_cell_table, static_argnames=("config", "with_flags"))
_jtrace = jax.jit(jq.trace_rays, static_argnames=(
    "config", "n_steps", "collidable_only", "k_cand", "dedup", "body_steps"))


def lattice(rng, shape, k_lo, k_hi):
    """float32 values k * 1.4, and one ulp below or above, for random k
    other than 0: one ulp from 0 is a denormal, which XLA's CPU code
    flushes to zero (the reference then puts -1e-45 in cell 0, the port in
    cell -1; no position the physics makes is a denormal)."""
    k = rng.integers(k_lo, k_hi - 1, shape)
    base = np.where(k >= 0, k + 1, k).astype(np.float32) * CELL
    step = rng.integers(-1, 2, shape)
    return np.where(step < 0, np.nextafter(base, np.float32(-np.inf)),
                    np.where(step > 0, np.nextafter(base, np.float32(np.inf)), base))


def _split(x):
    """Where the true division puts a value in another cell."""
    return np.floor(x / CELL) != np.floor(x * (np.float32(1) / CELL))


def split_lattice(rng, n, k_lo, k_hi):
    """n lattice values of which the true division puts every other one in
    another cell."""
    pool = lattice(rng, 64 * n, k_lo, k_hi)
    out = lattice(rng, n, k_lo, k_hi)
    out[::2] = rng.choice(pool[_split(pool)], len(out[::2]))
    return out


def _lattice_world(seed):
    """200 boxes with centres on the ulp lattice within 70 m of the origin,
    as the bench world's are (a 1.4 m lattice splits only a few values of
    each hundred: 6.9999995 is the first)."""
    a = box_world_arrays(CAP, 200, seed)
    rng = np.random.default_rng(seed)
    a["pos"][:200] = np.stack([split_lattice(rng, 200, -50, 50),
                               split_lattice(rng, 200, -50, 50),
                               split_lattice(rng, 200, 0, 6)], axis=1)
    kw = box_config_kwargs(CAP)
    return a, jstate.SimConfig(**kw), SimConfig(**kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_table_on_the_ulp_lattice(seed):
    a, jcfg, tcfg = _lattice_world(seed)
    assert _split(a["pos"][:200]).any(axis=1).sum() >= 100
    tb = convert.body_state_from_numpy(a, device="cpu")
    for flags in (False, True):
        jt, jc, jo = _jcell_table(jax_body(a), jcfg, with_flags=flags)
        tt, tc, to = tbp.build_cell_table(tb, tcfg, with_flags=flags)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert int(to) == int(jo)


@pytest.mark.parametrize("n_steps,body_steps", [(4, 1), (16, None)])
def test_trace_rays_on_the_ulp_lattice(n_steps, body_steps):
    """Rays from lattice points, half straight down (their march points keep
    the origin's x and y), half in random directions, over the lattice
    world: hits, bodies, materials, t and normals equal."""
    a, jcfg, tcfg = _lattice_world(2)
    rng = np.random.default_rng(3)
    r = 256
    o = np.stack([split_lattice(rng, r, -50, 50), split_lattice(rng, r, -50, 50),
                  lattice(rng, r, 3, 6)], axis=1)
    d = np.zeros((r, 3), np.float32)
    d[:, 2] = -1.0
    rnd = rng.normal(size=(r // 2, 3)).astype(np.float32)
    d[r // 2:] = rnd / np.linalg.norm(rnd, axis=1, keepdims=True)
    mt = rng.uniform(0.5, 8.0, r).astype(np.float32)
    assert _split(o[: r // 2, :2]).all(axis=1).sum() >= 32
    sw = jstate.default_static_world(ground_z=0.0)
    tsw = convert.static_world_from_numpy(static_world_np(sw), device="cpu")
    kw = dict(n_steps=n_steps, body_steps=body_steps, dedup=body_steps is None)
    jh = _jtrace(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt), jax_body(a), sw, jcfg, **kw)
    th = tq.trace_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mt),
                       convert.body_state_from_numpy(a, device="cpu"), tsw, tcfg, **kw)
    hit = np.asarray(jh.hit)
    assert 0.1 < hit.mean() < 1.0
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.body.numpy(), np.asarray(jh.body))
    np.testing.assert_array_equal(th.material.numpy(), np.asarray(jh.material))
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(th.normal.numpy(), np.asarray(jh.normal))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_character_update_on_the_ulp_lattice(seed):
    """The character over the lattice world with its capsule centre's x and
    y where the true division picks another cell, among 40 boxes on the
    lattice around it, walking, for 10 updates."""
    a, jcfg, tcfg = _lattice_world(10 + seed)
    rng = np.random.default_rng(seed)
    eye = np.array([*split_lattice(rng, 2, -50, 50)[::2], *split_lattice(rng, 2, -50, 50)[::2],
                    1.67], np.float32)
    assert _split(eye[:2]).all()
    a["pos"][:40, :2] = eye[:2] + lattice(rng, (40, 2), -2, 3)
    a["pos"][:40, 2] = lattice(rng, 40, 0, 2) + np.float32(0.4)
    move = np.array([2.0, 1.0, 0.0], np.float32)
    sw = jstate.default_static_world(ground_z=0.0)
    params = jstate.default_sim_params()
    jbody = jax_body(a)
    body = convert.body_state_from_numpy(a, device="cpu")
    tsw = convert.static_world_from_numpy(static_world_np(sw), device="cpu")
    tparams = convert.sim_params_from_numpy(params_np(params), device="cpu")
    jc = jchar.init_character_state(eye)
    tc = tchar.init_character_state(eye, device="cpu")
    for i in range(10):
        jc, jcam, jj, jt = jchar.character_update(
            jc, jbody, sw, jnp.asarray(move), False, False, False, 1.0 / 60.0, params, jcfg, -1)
        tc, tcam, tj, tt = tchar.character_update(
            tc, body, tsw, move, False, False, False, 1.0 / 60.0, tparams, tcfg, -1)
        for f in ("pos", "vel", "ground_normal", "ground_vel", "campos_z_delta"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                          err_msg=f"update {i}: {f}")
        for f in ("on_ground", "gravity_enabled", "fly_mode", "sitting"):
            assert bool(getattr(tc, f)) == bool(getattr(jc, f)), (i, f)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"update {i}")

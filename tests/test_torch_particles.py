"""substrata_tpu_torch.physics.particles against the reference.

``particles_step`` (the ray by kernel KH's twin, the update by kernel KI's
twin on the CPU) on the same seeded particles and bodies as the reference's:
one call within 1e-5, then 60 chained ticks within 1e-4 with ``alive`` and
the foam events equal.  The gap is rounding: XLA contracts ``a * b + c``
into one rounding and the port rounds twice, and a bounce carries the last
bits of ``t`` into the position.  Then the scenarios of
tests/test_particles.py through both packages' ParticleManager."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import particles as jpart
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics.world import PhysicsWorld as JWorld
from substrata_tpu_torch import PhysicsWorld, convert
from substrata_tpu_torch.physics import particles as tpart
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import (box_config_kwargs, box_world_arrays, jax_body, params_np,
                                static_world_np)

torch.set_num_threads(2)

DT = 1.0 / 60.0
_jstep = jax.jit(jpart.particles_step, static_argnames=("config", "n_ray_steps"))
COMPARED = ("pos", "vel", "opacity", "width")


def particle_arrays(n, seed, die_frac=0.3, fade=True):
    """Seeded particles over the 200-box world: positions in its footprint
    (some below the water line), velocities N(0, 2), mixed die-on-hit."""
    rng = np.random.default_rng(seed)
    z = {k: np.array(v) for k, v in vars(jpart.zero_particles(n)).items()}
    z["pos"] = rng.uniform([-12, -12, -0.6], [12, 12, 4.0], (n, 3)).astype(np.float32)
    z["vel"] = rng.normal(0, 2, (n, 3)).astype(np.float32)
    z["vel"][: n // 8] = 0.0                      # at rest: no ray
    z["opacity"][:] = 1.0
    if fade:
        z["dopacity_dt"] = rng.uniform(-0.5, 0.0, n).astype(np.float32)
        z["dwidth_dt"] = rng.uniform(0.0, 0.2, n).astype(np.float32)
    z["restitution"] = rng.uniform(0.2, 0.9, n).astype(np.float32)
    z["die_on_hit"] = rng.random(n) < die_frac
    z["alive"][:] = True
    z["alive"][-3:] = False
    return z


def _scene(seed, water_z=0.25):
    arrays = box_world_arrays(256, 200, seed, z0=0.39, dz=0.79)
    kw = box_config_kwargs(256)
    sw = jstate.default_static_world(0.0, water_z=water_z)
    p = jstate.default_sim_params().replace(water_z=jnp.float32(water_z))
    return (jax_body(arrays), sw, p, jstate.SimConfig(**kw),
            convert.body_state_from_numpy(arrays, device="cpu"),
            convert.static_world_from_numpy(static_world_np(sw), device="cpu"),
            convert.sim_params_from_numpy(params_np(p), device="cpu"),
            tstate.SimConfig(**kw))


def _jparticles(a):
    return jpart.ParticleState(**{k: jnp.asarray(v) for k, v in a.items()})


def _check(jps, tps, jfoam, tfoam, tol, what):
    for f in COMPARED:
        np.testing.assert_allclose(getattr(tps, f).numpy(), np.asarray(getattr(jps, f)),
                                   atol=tol, rtol=0, err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(tps.alive.numpy(), np.asarray(jps.alive), err_msg=what)
    np.testing.assert_array_equal(tfoam.numpy(), np.asarray(jfoam), err_msg=what)


def test_particles_step_one_call():
    jb, jsw, jp, jcfg, tb, tsw, tp, tcfg = _scene(0)
    a = particle_arrays(256, 1)
    jps, jfoam = _jstep(_jparticles(a), jb, jsw, jnp.float32(DT), jp, jcfg)
    tps, tfoam = tpart.particles_step(convert.particles_from_numpy(a, device="cpu"), tb, tsw,
                                      DT, tp, tcfg)
    _check(jps, tps, jfoam, tfoam, 1e-5, "one call")
    assert np.asarray(jfoam).any() and not np.asarray(jps.alive).all()   # deaths happen


def test_particles_chained_60_ticks():
    jb, jsw, jp, jcfg, tb, tsw, tp, tcfg = _scene(2)
    a = particle_arrays(256, 3, die_frac=0.15)
    jps = _jparticles(a)
    tps = convert.particles_from_numpy(a, device="cpu")
    bounces = 0
    for t in range(60):
        jps, jfoam = _jstep(jps, jb, jsw, jnp.float32(DT), jp, jcfg)
        prev_vz = tps.vel[:, 2].clone()
        tps, tfoam = tpart.particles_step(tps, tb, tsw, DT, tp, tcfg)
        bounces += int(((prev_vz < -0.5) & (tps.vel[:, 2] > 0.1)).sum())
        _check(jps, tps, jfoam, tfoam, 1e-4, f"tick {t}")
    assert bounces > 20


# --- tests/test_particles.py's scenarios through both facades. -----------

def _make(pkg, **water):
    if pkg == "ref":
        from substrata_tpu.physics.particles import ParticleManager
        w = JWorld(jstate.SimConfig(capacity=32, max_pairs=64, grid_dim=16, cell_size=4.0))
    else:
        ParticleManager = tpart.ParticleManager
        w = PhysicsWorld(tstate.SimConfig(capacity=32, max_pairs=64, grid_dim=16,
                                          cell_size=4.0), device="cpu")
    w.set_ground_plane(water.pop("ground", 0.0))
    if water:
        w.set_water_buoyancy_enabled(True)
        w.water_z = water["water_z"]
    return w, ParticleManager(w, capacity=64)


SCENARIOS = {
    # name: (world kwargs, particle kwargs, ticks)
    "falls_and_bounces": ({}, dict(pos=[0, 0, 2.0], vel=[0, 0, 0], restitution=0.6,
                                   dopacity_dt=-0.01, mass=1e-3, area=1e-6), 180),
    "fades_and_dies": ({}, dict(pos=[0, 0, 5.0], vel=[0, 0, 0], opacity=1.0,
                                dopacity_dt=-2.0), 41),
    "die_when_hit_surface": ({}, dict(pos=[0, 0, 0.5], vel=[0, 0, -5.0], dopacity_dt=-0.01,
                                      die_when_hit_surface=True), 31),
    "foam_decal_on_water": (dict(water_z=1.0), dict(pos=[0, 0, 2.0], vel=[0, 0, -4.0],
                                                    dopacity_dt=-0.01,
                                                    die_when_hit_surface=True), 60),
    "water_buoyancy_clamp": (dict(water_z=5.0, ground=-10.0),
                             dict(pos=[0, 0, 2.0], vel=[0, 0, -2.0], dopacity_dt=-0.001), 30),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_particle_scenarios_match_reference(name):
    wkw, pkw, ticks = SCENARIOS[name]
    runs = {}
    for pkg in ("ref", "port"):
        w, pm = _make(pkg, **dict(wkw))
        decals = []
        pm.on_foam_decal = lambda pos, width, d=decals: d.append((np.array(pos), width))
        pm.add_particle(**pkw)
        trace = []
        for _ in range(ticks):
            pm.think(DT)
            trace.append((np.array(pm.state.pos)[0], np.array(pm.state.vel)[0],
                          pm.num_alive))
        runs[pkg] = (trace, decals)
    (jt, jd), (tt, td) = runs["ref"], runs["port"]
    for i, ((jp, jv, jn), (tp, tv, tn)) in enumerate(zip(jt, tt)):
        assert tn == jn, (name, i)
        np.testing.assert_allclose(tp, jp, atol=1e-4, err_msg=f"{name} tick {i}")
        np.testing.assert_allclose(tv, jv, atol=1e-3, err_msg=f"{name} tick {i}")
    assert len(td) == len(jd)
    for (tpos, tw), (jpos, jw) in zip(td, jd):
        np.testing.assert_allclose(tpos, jpos, atol=1e-5)
        assert abs(tw - jw) < 1e-6
    # The reference test's own assertions, on the port.
    if name == "falls_and_bounces":
        vz = np.array([v[2] for _, v, _ in tt])
        assert ((vz[:-1] < -1.0) & (vz[1:] > 0.5)).any()
    elif name in ("fades_and_dies", "die_when_hit_surface"):
        assert tt[0][2] == 1 and tt[-1][2] == 0
    elif name == "foam_decal_on_water":
        assert len(td) == 1 and abs(td[0][0][2] - 1.0) < 1e-5
    else:
        assert tt[-1][1][2] > 0.3


def test_scatter_spawn_wraps_the_ring():
    w, pm = _make("port")
    pm.state = tpart.zero_particles(4, device="cpu")
    for i in range(6):
        pm.add_particle(pos=[i, 0, 5], vel=[0, 0, 0])
    pm._flush_spawns()
    np.testing.assert_array_equal(pm.state.pos[:, 0].numpy(), [4, 5, 2, 3])
    assert pm.state.alive.all() and pm._cursor == 2


# --- Kernel KY's twin: a whole flush in one scatter. ---------------------

def _spawn_both(capacity, n, seed, pre=0):
    """``n`` seeded spawns flushed through both facades (after ``pre``
    spawns already flushed, so the cursor starts mid-ring)."""
    rng = np.random.default_rng(seed)
    rows = [dict(pos=rng.uniform(-50, 50, 3), vel=rng.uniform(-5, 5, 3),
                 area=float(rng.uniform(1e-5, 1e-3)), mass=float(rng.uniform(1e-7, 1e-5)),
                 restitution=float(rng.uniform(0, 1)), width=float(rng.uniform(0.05, 0.3)),
                 dwidth_dt=float(rng.uniform(0, 0.2)), opacity=1.0,
                 dopacity_dt=float(-1.0 / rng.uniform(0.1, 2.0)),
                 theta=float(rng.uniform(0, 6.3)), sprite_type=int(rng.integers(0, 2)),
                 die_when_hit_surface=bool(rng.random() < 0.3)) for _ in range(pre + n)]
    out = {}
    for pkg in ("ref", "port"):
        w, pm = _make(pkg)
        if pkg == "ref":
            pm.state = jpart.zero_particles(capacity)
        else:
            pm.state = tpart.zero_particles(capacity, device="cpu")
        for batch in (rows[:pre], rows[pre:]):
            for r in batch:
                pm.add_particle(**r)
            pm._flush_spawns()
        out[pkg] = ({f: np.asarray(getattr(pm.state, f)) for f in tpart.PARTICLE_FIELDS},
                    pm._cursor)
    return out


@pytest.mark.parametrize("capacity,n,pre", [(16_384, 10_000, 0), (16_384, 20_000, 5_000),
                                            (1_000, 2_600, 300)])
def test_spawn_flush_matches_reference(capacity, n, pre):
    out = _spawn_both(capacity, n, seed=capacity + n, pre=pre)
    (jf, jc), (tf, tc) = out["ref"], out["port"]
    assert tc == jc
    for f in tpart.PARTICLE_FIELDS:
        np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)

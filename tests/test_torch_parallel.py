"""substrata_tpu_torch.parallel against substrata_tpu.parallel on the CPU.

The reference runs its programs over the 8 host devices that
tests/conftest.py gives JAX (``shard_map``, ``psum``, ``ppermute``); the
port runs the same shards on one device, the shard axis leading, with
KAD's and KAE's twins.  The worlds are tiny, as the reference's dry run
keeps them.  What is held:

- the cold ``physics_step`` (no solver or pair cache) against the
  reference's for 10 steps: positions within 1e-3 m (the slice-1 bound),
  events and diagnostics equal at every step;
- ``partition_by_slab`` and ``partition_by_tile``: every field and
  ``owner_slot`` bit-equal, and the overflow ValueError;
- ``halo_exchange`` and ``_axis_exchange`` (KAD's twin): the received
  halos and overflow counts bit-equal to the reference's inside a
  4-device ``shard_map``, with the dead rows past the count, the zero rows
  at the ends, an overflowing halo, and bodies on each threshold and one
  ulp either side (XLA folds ``x_min + halo_width`` and computes each
  threshold as one fma: kernels/halo.py);
- the 1-D and 2-D spatial steps and the multi-world step: every owned
  body within 1e-3 m, awake and overflow counts equal;
- ``sharded_mix_block`` within tests/test_torch_audio.py's tolerances
  (the block 5e-5, the sources' state 1e-5, playheads 0.01 samples);
- the port's ``dryrun_multichip`` on the CPU runs to its end.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from substrata_tpu.audio import mix as jmix
from substrata_tpu.parallel import mesh as jmesh
from substrata_tpu.parallel import spatial as jspatial
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics.step import physics_step as jstep
from substrata_tpu.physics.world import PhysicsObject as JObject
from substrata_tpu.physics.world import PhysicsWorld as JWorld

from substrata_tpu_torch import convert
from substrata_tpu_torch.parallel import dryrun
from substrata_tpu_torch.parallel import mesh as tmesh
from substrata_tpu_torch.parallel import spatial as tspatial
from substrata_tpu_torch.physics import state as tstate
from substrata_tpu_torch.physics.step import physics_step as tstep

from torch_port_helpers import (FIELDS, body_np, box_config_kwargs, box_world_arrays,
                                jax_body, params_np, static_world_np)

torch.set_num_threads(2)

DT = 1.0 / 60.0
N_DEV = 4
X_MIN, X_MAX = -8.0, 8.0
POS_TOL = 1e-3
HCV = jnp.zeros((64, 8, 3), jnp.float32)


def _port_world(jw: JWorld):
    """The port's static world, params and config of a reference world."""
    return (convert.static_world_from_numpy(static_world_np(jw.static_world), device="cpu"),
            convert.sim_params_from_numpy(params_np(jw.params), device="cpu"),
            tstate.SimConfig(**{k: getattr(jw.config, k) for k in (
                "capacity", "max_pairs", "max_contacts_per_pair", "grid_dim",
                "cell_capacity", "cell_size", "solver_iters", "static_contacts_per_body",
                "max_tri_candidates", "contacts_per_body", "max_active_contacts",
                "pairs_per_body", "pair_rebuild_interval", "present_shape_types")}))


def _tbody(state):
    return convert.body_state_from_numpy(body_np(state), device="cpu")


def _equal(tb, jb, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f"{what} {f}")


def _spatial_world():
    """tests/test_spatial.py's world: sphere clusters straddling the slab
    boundaries at -4, 0, 4 and scattered boxes."""
    cfg = jstate.SimConfig(capacity=64, max_pairs=1024, grid_dim=16, cell_size=4.0,
                           solver_iters=6)
    w = JWorld(cfg)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(7)
    for c in (-4.0, 0.0, 4.0):
        for k in range(4):
            w.add_object(JObject(
                shape=jshapes.make_sphere(0.4),
                pos=np.array([c + (k % 2) * 0.5 - 0.25, (k // 2) * 0.5 - 0.25, 0.5 + 0.45 * k],
                             np.float32),
                motion_type=int(jstate.MotionType.DYNAMIC)))
    for _ in range(8):
        w.add_object(JObject(
            shape=jshapes.make_box([0.3, 0.3, 0.3]),
            pos=np.array([rng.uniform(X_MIN + 1, X_MAX - 1), rng.uniform(-2, 2), 1.5],
                         np.float32),
            motion_type=int(jstate.MotionType.DYNAMIC)))
    w._flush()
    return w


def _dryrun_world():
    """The reference dry run's world (``__graft_entry__.py:89-104``)."""
    cfg = jstate.SimConfig(capacity=32, max_pairs=128, grid_dim=8, cell_size=4.0,
                           solver_iters=2)
    w = JWorld(cfg)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    for i in range(12):
        sh = (jshapes.make_sphere(0.3) if i % 3 == 0
              else jshapes.make_box([0.3, 0.3, 0.3]) if i % 3 == 1
              else jshapes.make_capsule(0.2, 0.3))
        w.add_object(JObject(shape=sh, pos=np.array(
            [rng.uniform(-5, 5), rng.uniform(-5, 5), 1 + i * 0.5], np.float32),
            motion_type=int(jstate.MotionType.DYNAMIC)))
    w._flush()
    return w


# ---------------------------------------------------------------------------
# The cold step.
# ---------------------------------------------------------------------------

def test_cold_step_matches_reference_for_ten_steps():
    arrays = box_world_arrays(256, 200, 0, z0=0.39, dz=0.79, speed=0.5)
    kw = box_config_kwargs(256)
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jw = jstate.default_static_world(ground_z=0.0)
    jp = jstate.default_sim_params()
    tw = convert.static_world_from_numpy(static_world_np(jw), device="cpu")
    tp = convert.sim_params_from_numpy(params_np(jp), device="cpu")
    jb = jax_body(arrays)
    tb = convert.body_state_from_numpy(arrays, device="cpu")
    for step in range(10):
        jb, jev, jdg = jstep(jb, jw, HCV, jnp.float32(DT), jp, jcfg)
        tb, tev, tdg = tstep(tb, tw, DT, tp, tcfg)
        for f in ("contact_pair_a", "contact_pair_b", "contact_touching", "newly_awake",
                  "newly_asleep", "entered_water", "num_pairs", "broadphase_overflow"):
            np.testing.assert_array_equal(getattr(tev, f).numpy(), np.asarray(getattr(jev, f)),
                                          err_msg=f"step {step} {f}")
        for f in ("num_pairs", "num_contacts", "num_awake"):
            assert int(getattr(tdg, f)) == int(getattr(jdg, f)), (step, f)
        np.testing.assert_allclose(tb.pos.numpy(), np.asarray(jb.pos), rtol=0, atol=POS_TOL,
                                   err_msg=f"step {step}")
    assert int(tdg.num_pairs) > 100


def test_step_takes_both_caches_or_neither():
    from substrata_tpu_torch.physics import broadphase, solver
    cfg = tstate.SimConfig(capacity=32, max_pairs=128, grid_dim=8)
    args = (tstate.zero_body_state(32, device="cpu"), tstate.default_static_world(device="cpu"),
            DT, tstate.default_sim_params(device="cpu"), cfg)
    for caches in ((None, broadphase.empty_pair_cache(cfg, device="cpu")),
                   (solver.empty_solver_cache(1024, device="cpu"), None)):
        with pytest.raises(ValueError, match="both"):
            tstep(*args, *caches)
    assert len(tstep(*args)) == 3


# ---------------------------------------------------------------------------
# Partitions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_slabs,local_cap", [(4, 16), (3, 12), (5, 8)])
def test_partition_by_slab_bit_equal(n_slabs, local_cap):
    w = _spatial_world()
    jpart, jown = jspatial.partition_by_slab(w.state, n_slabs, local_cap, X_MIN, X_MAX)
    tpart, town = tspatial.partition_by_slab(_tbody(w.state), n_slabs, local_cap, X_MIN, X_MAX)
    _equal(tpart, jpart, "slab")
    np.testing.assert_array_equal(town, jown)
    # Dead tail slots are copies of body 0, dead and asleep.
    dead = ~tpart.alive.numpy()
    assert dead.any()
    np.testing.assert_array_equal(tpart.pos.numpy()[dead][0], np.asarray(w.state.pos)[0])


@pytest.mark.parametrize("px,py", [(2, 2), (4, 2), (3, 1)])
def test_partition_by_tile_bit_equal(px, py):
    w = _spatial_world()
    jpart, jown = jspatial.partition_by_tile(w.state, px, py, 16, X_MIN, X_MAX, -4.0, 4.0)
    tpart, town = tspatial.partition_by_tile(_tbody(w.state), px, py, 16, X_MIN, X_MAX,
                                             -4.0, 4.0)
    _equal(tpart, jpart, "tile")
    np.testing.assert_array_equal(town, jown)


def test_partition_overflow_raises_the_reference_error():
    w = _spatial_world()
    with pytest.raises(ValueError) as jerr:
        jspatial.partition_by_slab(w.state, N_DEV, 2, X_MIN, X_MAX)
    with pytest.raises(ValueError) as terr:
        tspatial.partition_by_slab(_tbody(w.state), N_DEV, 2, X_MIN, X_MAX)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jspatial.partition_by_tile(w.state, 2, 2, 2, X_MIN, X_MAX, -4.0, 4.0)
    with pytest.raises(ValueError) as terr:
        tspatial.partition_by_tile(_tbody(w.state), 2, 2, 2, X_MIN, X_MAX, -4.0, 4.0)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Halo exchange.
# ---------------------------------------------------------------------------

def _jhalo(part, halo_cap, halo_width, x_min, x_max, n=N_DEV):
    mesh = jmesh.make_mesh(n, axis="x")

    @partial(shard_map, mesh=mesh, in_specs=(P("x"),), out_specs=(P("x"), P("x"), P("x")),
             check_vma=False)
    def f(local):
        fl, fr, ov = jspatial.halo_exchange(local, halo_cap, halo_width, x_min, x_max, "x", n)
        return fl, fr, ov[None]
    return jax.jit(f)(part)


@pytest.mark.parametrize("halo_cap", [8, 3, 1])
def test_halo_exchange_bit_equal(halo_cap):
    w = _spatial_world()
    jpart, _ = jspatial.partition_by_slab(w.state, N_DEV, 16, X_MIN, X_MAX)
    jfl, jfr, jov = _jhalo(jpart, halo_cap, 2.5, X_MIN, X_MAX)
    tfl, tfr, tov = tspatial.halo_exchange(_tbody(jpart), halo_cap, 2.5, X_MIN, X_MAX, "x",
                                           N_DEV)
    _equal(tfl, jfl, "from_left")
    _equal(tfr, jfr, "from_right")
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))
    # Zero rows at both ends: shard 0 hears nothing from the left, the last
    # shard nothing from the right (quaternion 0, inv_mass 0 included).
    for f in FIELDS:
        assert not getattr(tfl, f)[:halo_cap].any(), f
        assert not getattr(tfr, f)[-halo_cap:].any(), f
    assert (int(tov.sum()) > 0) == (halo_cap < 8)
    if halo_cap == 8:
        assert 0 < int(tfl.alive.sum()) < tfl.alive.numel()     # dead rows past the count


def _edge_arrays(lo_thr, hi_thr, x_min, slab_w, local_cap, n):
    """Bodies on each shard's two thresholds and one ulp either side, and
    one in each slab's middle; float32 xy as the reference's world holds."""
    xs = []
    for d in range(n):
        for t in (lo_thr[d], hi_thr[d]):
            xs += [np.nextafter(t, np.float32(-1e9)), t, np.nextafter(t, np.float32(1e9))]
        xs.append(np.float32(x_min + (d + 0.5) * slab_w))
    xs = np.array(xs, np.float32)
    arrays = box_world_arrays(n * local_cap, len(xs), 3, layers=1)
    arrays["pos"][:len(xs), 0] = xs
    arrays["pos"][:len(xs), 1] = np.linspace(-2.0, 2.0, len(xs), dtype=np.float32)
    return arrays


@pytest.mark.parametrize("x_min,x_max,hw", [(-7.3, 9.1, 1.7), (-8.0, 8.0, 2.5)])
def test_halo_exchange_edges_within_an_ulp(x_min, x_max, hw):
    from substrata_tpu_torch.kernels import halo
    lo, hi = halo.thresholds(x_min, x_max, N_DEV, hw)
    arrays = _edge_arrays(lo, hi, x_min, (x_max - x_min) / N_DEV, 16, N_DEV)
    jpart, _ = jspatial.partition_by_slab(jax_body(arrays), N_DEV, 16, x_min, x_max)
    jfl, jfr, jov = _jhalo(jpart, 8, hw, x_min, x_max)
    tfl, tfr, tov = tspatial.halo_exchange(_tbody(jpart), 8, hw, x_min, x_max, "x", N_DEV)
    _equal(tfl, jfl, "from_left")
    _equal(tfr, jfr, "from_right")
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))
    # At least the body one ulp past each inner threshold crosses.
    assert int(tfl.alive.sum()) >= N_DEV - 1 and int(tfr.alive.sum()) >= N_DEV - 1


@pytest.mark.parametrize("coord_axis,axis_name", [(0, "sx"), (1, "sy")])
def test_axis_exchange_2d_bit_equal(coord_axis, axis_name):
    w = _spatial_world()
    jpart, _ = jspatial.partition_by_tile(w.state, 2, 2, 16, X_MIN, X_MAX, -4.0, 4.0)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("sx", "sy"))
    lo, hi = (X_MIN, X_MAX) if coord_axis == 0 else (-4.0, 4.0)

    @partial(shard_map, mesh=mesh, in_specs=(P(("sx", "sy")),),
             out_specs=(P(("sx", "sy")),) * 3, check_vma=False)
    def f(local):
        a, b, ov = jspatial._axis_exchange(local, coord_axis, 4, 2.5, lo, hi, axis_name, 2)
        return a, b, ov[None]
    ja, jb, jov = jax.jit(f)(jpart)
    ta, tb, tov = tspatial._axis_exchange(_tbody(jpart), coord_axis, 4, 2.5, lo, hi,
                                          axis_name, 2,
                                          mesh=tmesh.Mesh((2, 2), ("sx", "sy"), "cpu"))
    _equal(ta, ja, "from_low")
    _equal(tb, jb, "from_high")
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))


# ---------------------------------------------------------------------------
# The sharded steps.  Each reference spatial step is jitted once and
# reused: called bare, its shard_map compiles the step on every call.
# ---------------------------------------------------------------------------

_SPATIAL_STATIC = ("config", "mesh", "halo_cap", "halo_width", "x_min", "x_max")
_jspatial_step = jax.jit(jspatial.spatial_world_step, static_argnames=_SPATIAL_STATIC)
_jspatial_step_2d = jax.jit(jspatial.spatial_world_step_2d,
                            static_argnames=_SPATIAL_STATIC + ("y_min", "y_max"))

def _owned_close(tpart, jpart, what):
    alive = jpart.alive
    np.testing.assert_array_equal(tpart.alive.numpy(), np.asarray(alive))
    np.testing.assert_allclose(tpart.pos.numpy()[np.asarray(alive)],
                               np.asarray(jpart.pos)[np.asarray(alive)], rtol=0, atol=POS_TOL,
                               err_msg=what)


@pytest.mark.parametrize("halo_cap,steps", [(8, 3), (1, 1)])
def test_spatial_world_step_matches_reference(halo_cap, steps):
    w = _spatial_world()
    tworld, tparams, tcfg = _port_world(w)
    mesh = jmesh.make_mesh(N_DEV, axis="x")
    jpart, _ = jspatial.partition_by_slab(w.state, N_DEV, 16, X_MIN, X_MAX)
    tpart = _tbody(jpart)
    jpart = jspatial.shard_partitioned(jpart, mesh)
    tm = tmesh.make_mesh(N_DEV, axis="x", device="cpu")
    for step in range(steps):
        jpart, jaw, jov = _jspatial_step(
            jpart, w.static_world, HCV, jnp.float32(DT), w.params, config=w.config, mesh=mesh,
            halo_cap=halo_cap, halo_width=2.5, x_min=X_MIN, x_max=X_MAX)
        tpart, taw, tov = tspatial.spatial_world_step(
            tpart, tworld, None, DT, tparams, tcfg, tm, halo_cap=halo_cap, halo_width=2.5,
            x_min=X_MIN, x_max=X_MAX)
        assert int(taw) == int(jaw), step
        assert int(tov) == int(jov), step
        _owned_close(tpart, jpart, f"step {step}")
    assert int(taw) > 0
    assert (int(tov) > 0) == (halo_cap == 1)


def test_spatial_world_step_2d_matches_reference():
    w = _spatial_world()
    tworld, tparams, tcfg = _port_world(w)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("sx", "sy"))
    jpart, _ = jspatial.partition_by_tile(w.state, 2, 2, 16, X_MIN, X_MAX, -4.0, 4.0)
    tpart = _tbody(jpart)
    jpart = jspatial.shard_partitioned(jpart, mesh)
    tm = tmesh.Mesh((2, 2), ("sx", "sy"), "cpu")
    for step in range(3):
        jpart, jaw, jov = _jspatial_step_2d(
            jpart, w.static_world, HCV, jnp.float32(DT), w.params, config=w.config, mesh=mesh,
            halo_cap=4, halo_width=2.5, x_min=X_MIN, x_max=X_MAX, y_min=-4.0, y_max=4.0)
        tpart, taw, tov = tspatial.spatial_world_step_2d(
            tpart, tworld, None, DT, tparams, tcfg, tm, halo_cap=4, halo_width=2.5,
            x_min=X_MIN, x_max=X_MAX, y_min=-4.0, y_max=4.0)
        assert int(taw) == int(jaw), step
        assert int(tov) == int(jov), step
        _owned_close(tpart, jpart, f"step {step}")
    assert int(taw) > 0


def test_multi_world_step_matches_reference():
    w = _dryrun_world()
    tworld, tparams, tcfg = _port_world(w)
    n_worlds = 4
    states = jmesh.replicate_states(w.state, n_worlds)
    # Each world kicked with its own seeded velocities, so the worlds differ.
    lin = np.asarray(states.linvel).copy()
    for k in range(n_worlds):
        lin[k] += np.random.default_rng(100 + k).uniform(-1.5, 1.5, lin[k].shape) \
            * np.asarray(w.state.alive)[:, None]
    states = states.replace(linvel=jnp.asarray(lin.astype(np.float32)))
    tstates = tstate.BodyState(**{f: torch.as_tensor(np.array(getattr(states, f)))
                                  for f in FIELDS})
    mesh = jmesh.make_mesh(N_DEV)
    tm = tmesh.make_mesh(N_DEV, device="cpu")
    for step in range(2):
        states, jaw = jmesh.multi_world_step(states, w.static_world, HCV, jnp.float32(DT),
                                             w.params, w.config, mesh)
        tstates, taw = tmesh.multi_world_step(tstates, tworld, None, DT, tparams, tcfg, tm)
        assert int(taw) == int(jaw), step
        np.testing.assert_allclose(tstates.pos.numpy(), np.asarray(states.pos), rtol=0,
                                   atol=POS_TOL, err_msg=f"step {step}")
    assert int(taw) > 0
    assert np.abs(np.diff(tstates.pos.numpy(), axis=0)).max() > 1e-3      # worlds differ


def test_sharded_mix_block_matches_reference():
    n_src = 32 * N_DEV
    src = jmix.zero_sources(n_src)
    pool = jnp.sin(jnp.arange(4096, dtype=jnp.float32) * 0.05)
    src = src.replace(alive=src.alive.at[:].set(True), buf_len=src.buf_len.at[:, 0].set(4096),
                      looping=src.looping.at[:].set(True),
                      pos=src.pos.at[:, 1].set(jnp.linspace(1.0, 50.0, n_src)))
    tsrc, _ = dryrun.dryrun_sources(n_src, "cpu")
    tpool = torch.as_tensor(np.asarray(pool))       # torch's sin rounds otherwise
    lis = jmix.default_listener()
    tlis = convert.listener_from_numpy({f: np.asarray(getattr(lis, f)) for f in vars(lis)},
                                       device="cpu")
    mesh = jmesh.make_mesh(N_DEV)
    tm = tmesh.make_mesh(N_DEV, device="cpu")
    for blk in range(3):
        src, jblock = jmesh.sharded_mix_block(src, pool, lis, mesh)
        tsrc, tblock = tmesh.sharded_mix_block(tsrc, tpool, tlis, tm)
        np.testing.assert_allclose(tblock.numpy(), np.asarray(jblock), rtol=0, atol=5e-5,
                                   err_msg=f"block {blk}")
        for f in ("playhead",):
            np.testing.assert_allclose(getattr(tsrc, f).numpy(), np.asarray(getattr(src, f)),
                                       rtol=0, atol=0.01, err_msg=f"{f} {blk}")
        for f in ("prev_gain_l", "prev_gain_r", "doppler_factor", "mute_factor"):
            np.testing.assert_allclose(getattr(tsrc, f).numpy(), np.asarray(getattr(src, f)),
                                       rtol=0, atol=1e-5, err_msg=f"{f} {blk}")
    assert np.abs(np.asarray(jblock)).max() > 0.0


def test_dryrun_multichip_runs_on_the_cpu():
    msg = dryrun.dryrun_multichip(N_DEV, device="cpu")
    assert msg.startswith("dryrun_multichip OK") and "2x2 2-D tiles" in msg


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_gpu.py runs the card")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh(N_DEV)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.Mesh((2, 2), ("sx", "sy"))

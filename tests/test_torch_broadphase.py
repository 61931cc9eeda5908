"""substrata_tpu_torch.physics.broadphase against the reference.

Integer outputs must be equal: the int32-wrapping cell hash and its uint32
bucket modulo, the cell table, and — on ~200-body scenes that overflow
neither a bucket, nor pairs_per_body, nor max_pairs — the pair set (as a
set; the per-row top-K tie order only matters under overflow)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import cell_table
from substrata_tpu_torch.physics import broadphase as tbp
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import box_config_kwargs, box_world_arrays, jax_body

torch.set_num_threads(2)

CAP = 256
# Jitted, as the reference runs them (eager dispatch is slow on the CPU).
_jfind_pairs = jax.jit(jbp.find_pairs, static_argnames=("config", "has_oversize"))
_jcell_table = jax.jit(jbp.build_cell_table, static_argnames=("config", "with_flags"))
_jrebuild = jax.jit(jbp._pairs_rebuild, static_argnames=("config", "has_oversize"))
_jcached = jax.jit(jbp.find_pairs_cached,
                   static_argnames=("config", "rebuild", "has_oversize"))


def _scene(seed, speed=0.0):
    arrays = box_world_arrays(CAP, 200, seed, z0=0.39, dz=0.79, speed=speed)
    kw = box_config_kwargs(CAP)
    return (jax_body(arrays), convert.body_state_from_numpy(arrays, device="cpu"),
            jstate.SimConfig(**kw), tstate.SimConfig(**kw))


def test_hash_cells_wraps_like_int32():
    rng = np.random.default_rng(3)
    cells = np.concatenate([
        rng.integers(-200, 200, size=(500, 3)),
        rng.integers(-(1 << 20), 1 << 20, size=(500, 3)),   # products overflow int32
    ]).astype(np.int32)
    for nb in (1024, 16_384, 1000):
        want = np.asarray(jbp._hash_cells(jnp.asarray(cells), nb))
        got = cell_table.hash_cells(torch.tensor(cells), nb).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_table_equal(seed):
    jb, tb, jcfg, tcfg = _scene(seed)
    for flags in (False, True):
        jt, jc, jo = _jcell_table(jb, jcfg, with_flags=flags)
        tt, tc, to = tbp.build_cell_table(tb, tcfg, with_flags=flags)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int(to) == int(jo)


def _pair_set(a, b, v):
    a, b, v = np.asarray(a), np.asarray(b), np.asarray(v)
    return set(zip(a[v].tolist(), b[v].tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("oversize", [False, True])
def test_find_pairs_same_set(seed, oversize):
    jb, tb, jcfg, tcfg = _scene(seed)
    jpa, jpb, jpv, jn, jo = _jfind_pairs(jb, jcfg, has_oversize=oversize)
    tpa, tpb, tpv, tn, to = tbp.find_pairs(tb, tcfg, has_oversize=oversize)
    want = _pair_set(jpa, jpb, jpv)
    assert len(want) > 100
    assert _pair_set(tpa.numpy(), tpb.numpy(), tpv.numpy()) == want
    # Equal counters; the reference counts a tight neighbour that a bucket
    # hash collision listed twice as one drop, so the count may be small
    # but non-zero without any pair being lost.
    assert int(tn) == int(jn) and int(to) == int(jo) <= 2
    assert int(jn) < jcfg.max_pairs          # the scene does not overflow


def test_rebuild_margins_and_window():
    jb, tb, jcfg, tcfg = _scene(4, speed=3.0)
    dt = 1.0 / 60.0
    j = _jrebuild(jb, jnp.float32(dt), config=jcfg, has_oversize=False)
    t = tbp._pairs_rebuild(tb, dt, tcfg, has_oversize=False)
    assert _pair_set(t[0].numpy(), t[1].numpy(), t[2].numpy()) == _pair_set(*j[:3])
    assert int(t[5]) == int(j[5])            # reuse window (steps_left)


def test_pair_cache_reuse_returns_cached_list():
    jb, tb, jcfg, tcfg = _scene(5)
    dt = 1.0 / 60.0
    cache = tbp.empty_pair_cache(tcfg, device="cpu")
    pa, pb, pv, num, ov, cache = tbp.find_pairs_cached(tb, cache, dt, tcfg, rebuild=True)
    left = int(cache.steps_left)
    moved = tb.replace(pos=tb.pos + 0.3)     # reuse must not look at positions
    pa2, pb2, pv2, num2, ov2, cache2 = tbp.find_pairs_cached(moved, cache, dt, tcfg,
                                                              rebuild=False)
    assert torch.equal(pa2, pa) and torch.equal(pb2, pb) and torch.equal(pv2, pv)
    assert int(num2) == int(num) and int(ov2) == 0
    assert int(cache2.steps_left) == left - 1
    assert torch.equal(cache2.inc_table, cache.inc_table)
    jc = jbp.empty_pair_cache(jcfg)
    jres = _jcached(jb, jc, jnp.float32(dt), config=jcfg, rebuild=True)
    assert int(jres[5].steps_left) == left
    assert _pair_set(pa, pb, pv) == _pair_set(*jres[:3])

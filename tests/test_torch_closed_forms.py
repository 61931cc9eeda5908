"""substrata_tpu_torch's closed-form contacts (the plain twin of kernel KK)
and the mixed-combo pair_contacts against substrata_tpu.physics.narrowphase.

Tolerances: points, normals and penetrations within 1e-5 absolute
(float32 at unit scale; the two differ only in summation order and
multiply-add contraction).  Masks, keys, ids, touching flags and the
bucket overflow are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import broadphase as jbroad
from substrata_tpu.physics import narrowphase as jnp_phase
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import box_box as ka
from substrata_tpu_torch.kernels import closed_forms as kk
from substrata_tpu_torch.physics import narrowphase as tnp_phase
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import jax_body, mixed_world_arrays

torch.set_num_threads(2)

ATOL = 1e-5
N_PAIRS = 256
SPHERE, BOX, CAPSULE = 0, 1, 2


def _rows(rng, stype, n):
    """Packed per-side rows [n, 15] (pos, quat, type, params, friction,
    restitution, sensor) of one shape type at random poses."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    prm = np.zeros((n, 4), np.float32)
    if stype == SPHERE:
        prm[:, 0] = rng.uniform(0.2, 0.6, n)
    elif stype == BOX:
        prm[:, :3] = rng.uniform(0.2, 0.7, (n, 3))
    else:
        prm[:, 0] = rng.uniform(0.15, 0.4, n)
        prm[:, 1] = rng.uniform(0.2, 0.6, n)
    rows = np.zeros((n, 15), np.float32)
    rows[:, 0:3] = rng.uniform(-0.6, 0.6, (n, 3))
    rows[:, 3:7] = q
    rows[:, 7] = stype
    rows[:, 8:12] = prm
    return rows


@pytest.mark.parametrize("code", [0, 1, 2, 4, 5, 6, 8, 9, 10])
def test_closed_form_matches_reference(code):
    """Each closed form on 256 seeded pose pairs (bodies within touching
    range, about half of them in contact), against the reference's
    ``_CLOSED_FORM_KERNELS`` under jax.vmap."""
    rng = np.random.default_rng(100 + code)
    va, vb = _rows(rng, code // 4, N_PAIRS), _rows(rng, code % 4, N_PAIRS)
    jpts, jpens, jn, jval = (np.asarray(x) for x in jax.jit(
        jnp_phase._CLOSED_FORM_KERNELS[code])(jnp.asarray(va), jnp.asarray(vb)))
    ta, tb = torch.as_tensor(va), torch.as_tensor(vb)
    if code == 5:
        res = ka.box_box(ta[:, :3], ta[:, 3:7], ta[:, 8:11], tb[:, :3], tb[:, 3:7], tb[:, 8:11])
    else:
        res = kk.closed_form(code, ta[:, :3], ta[:, 3:7], ta[:, 8:12],
                             tb[:, :3], tb[:, 3:7], tb[:, 8:12])
    tpts, tpens, tn, tval = (x.numpy() for x in res)
    ntol = np.full(N_PAIRS, ATOL)
    if code in (6, 9):
        # The search rounds as the jitted reference's does (the thirds, the
        # segment point, the rotation's cross products and the distance's
        # norm are its multiply-adds: kernels/closed_forms.py), so t* and
        # with it the point and the normal follow the reference's on every
        # pair, the flat ones too: a segment parallel to a face (|f1 - f2|
        # < 3e-7 somewhere in the search, about 2 ulp at unit scale), where
        # the comparisons are rounding's choice.
        cap_, box_ = (tb, ta) if code == 6 else (ta, tb)
        gap = kk.capsule_box(cap_[:, :3], cap_[:, 3:7], cap_[:, 8], cap_[:, 9], box_[:, :3],
                             box_[:, 3:7], box_[:, 8:11], with_gap=True)[4].numpy()
        # A sphere centre within 1 cm outside the box has its normal from a
        # separation under 1 cm: 1e-7 m of rounding in the points moves it
        # by up to 1e-5 / separation, so there it is held to 1e-3.
        sep = cap_[:, 8].numpy() - jpens[:, 0]
        ntol = np.where((sep > 0) & (sep < 0.01), 1e-3, ATOL)
        assert 0 < (gap < 3e-7).mean() < 0.08, (gap < 3e-7).mean()
    np.testing.assert_array_equal(tval, jval)
    assert 0.2 < jval[:, 0].mean() < 0.95, jval[:, 0].mean()   # a real mix of contacts
    assert (np.abs(tn - jn) <= ntol[:, None]).all(), np.abs(tn - jn).max()
    np.testing.assert_allclose(tpens, jpens, atol=ATOL)
    np.testing.assert_allclose(tpts[jval], jpts[jval], atol=ATOL)


def test_closed_point_triangle_matches_reference():
    """``_closest_point_triangle`` (the character probe's trimesh rows;
    the port keeps it for slice 3) on random points and triangles,
    covering every Voronoi region."""
    rng = np.random.default_rng(5)
    p = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    v = rng.uniform(-1, 1, (3, 512, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jnp_phase._closest_point_triangle))(
        jnp.asarray(p), *(jnp.asarray(x) for x in v)))
    got = kk.closest_point_triangle(torch.as_tensor(p), *(torch.as_tensor(x) for x in v)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _mixed_world(seed, capacity=64):
    a = mixed_world_arrays(capacity, 60, seed)
    cfg = dict(capacity=capacity, max_pairs=256, grid_dim=16, cell_size=2.0,
               pairs_per_body=8, present_shape_types=(True, True, True, False))
    jcfg = jstate.SimConfig(**cfg)
    jbody = jax_body(a)
    pa, pb, pv, _, _ = jax.jit(jbroad.find_pairs, static_argnames=("config",))(
        jbody, config=jcfg)
    return a, cfg, jcfg, jbody, (np.asarray(pa), np.asarray(pb), np.asarray(pv))


@pytest.mark.parametrize("blocked_wm", [4, 0])
def test_mixed_pair_contacts_match_reference(blocked_wm):
    """A 60-body world of spheres, boxes and capsules (9 combo codes, one
    stable sort, per-code buckets) in the pair-blocked layout (every
    bucket padded to 4 rows a slot) and the compacted one (each code's own
    width): every contact row, the touching flags and the overflow equal
    the reference's, to 1e-5 on the float fields."""
    a, cfg, jcfg, jbody, (pa, pb, pv) = _mixed_world(11)
    assert pv.sum() > 40
    jc, jt, jov = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))(
        jbody, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(pv), config=jcfg,
        blocked_wm=blocked_wm)
    body = convert.body_state_from_numpy(a, device="cpu")
    tc, tt, tov = tnp_phase.pair_contacts(body, torch.as_tensor(pa), torch.as_tensor(pb),
                                          torch.as_tensor(pv), tstate.SimConfig(**cfg),
                                          blocked_wm=blocked_wm)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tov) == int(jov)
    assert tt.numpy().sum() > 10
    jvalid = np.asarray(jc.valid)
    for f in ("a", "b", "key", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), f)
    for f in ("friction", "restitution"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), atol=ATOL)
    for f in ("point", "normal", "penetration"):
        np.testing.assert_allclose(getattr(tc, f).numpy()[jvalid],
                                   np.asarray(getattr(jc, f))[jvalid], atol=ATOL, err_msg=f)


def test_bucket_overflow_counts_like_the_reference():
    """Buckets smaller than their runs (max_pairs 8: the same-type codes
    get 8 slots, fewer than the pile's sphere-sphere, box-box and
    capsule-capsule pairs): the overflow count, the touching flags and the
    kept rows still equal the reference's."""
    a = mixed_world_arrays(64, 60, 12)
    cfg = dict(capacity=64, max_pairs=8, grid_dim=16, cell_size=2.0, pairs_per_body=8,
               present_shape_types=(True, True, True, False))
    jcfg = jstate.SimConfig(**cfg)
    jbody = jax_body(a)
    # The pair list of a roomier config, so that runs exceed their buckets.
    pa, pb, pv, _, _ = jax.jit(jbroad.find_pairs, static_argnames=("config",))(
        jbody, config=jstate.SimConfig(**dict(cfg, max_pairs=256)))
    jc, jt, jov = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))(
        jbody, pa, pb, pv, config=jcfg, blocked_wm=0)
    body = convert.body_state_from_numpy(a, device="cpu")
    tc, tt, tov = tnp_phase.pair_contacts(body, *(torch.as_tensor(np.asarray(x))
                                                  for x in (pa, pb, pv)),
                                          tstate.SimConfig(**cfg), blocked_wm=0)
    assert int(jov) > 0 and int(tov) == int(jov)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(tc.key.numpy(), np.asarray(jc.key))


def test_single_combo_sphere_world_runs_in_place():
    """An all-sphere world is single-combo code 0: the bucket is the pair
    list in place (no sort), one manifold row per slot, as the reference
    emits it."""
    a = mixed_world_arrays(64, 40, 13, types=(SPHERE,))
    cfg = dict(capacity=64, max_pairs=256, grid_dim=16, cell_size=2.0, pairs_per_body=8,
               present_shape_types=(True, False, False, False))
    jcfg = jstate.SimConfig(**cfg)
    assert jnp_phase.blocked_manifold_width(jcfg, 64) == 1
    jbody = jax_body(a)
    pa, pb, pv, _, _ = jax.jit(jbroad.find_pairs, static_argnames=("config",))(
        jbody, config=jcfg)
    jc, jt, _ = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))(
        jbody, pa, pb, pv, config=jcfg, blocked_wm=1)
    body = convert.body_state_from_numpy(a, device="cpu")
    tc, tt, _ = tnp_phase.pair_contacts(body, *(torch.as_tensor(np.asarray(x))
                                                for x in (pa, pb, pv)),
                                        tstate.SimConfig(**cfg), blocked_wm=1)
    assert tc.capacity == 256
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.a.numpy(), np.asarray(jc.a))
    jvalid = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.numpy(), jvalid)
    np.testing.assert_allclose(tc.point.numpy()[jvalid], np.asarray(jc.point)[jvalid],
                               atol=ATOL)

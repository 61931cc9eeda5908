"""The compacted contact layout's chain (kernel KT's twin) and the pair
finder's rebuild margins (kernel KS's twin) against substrata_tpu.

Scenes: seeded piles of spheres, boxes, capsules and hulls (the hull
library shared by both packages), the reference's own pair lists and
contacts handed to both sides as numpy.  Everything here is exact:
- the grouping: each bucket slot's pair index, bodies and occupancy, read
  back from the reference's contacts (the pair-blocked layout marks an
  empty slot with a = -1; a valid pair's (a, b) names its index), the
  per-pair touching flags and the bucket overflow;
- the compaction, with room for every valid row and overflowing;
- the incidence table on the compacted rows, with bodies that have more
  entries than ``cpb``;
- the rebuild's per-body margins and reuse window, bit for bit, taken
  from inside the reference's jitted ``_pairs_rebuild``;
- the pair finder under truncation and with oversize bodies: the sorted
  pair buffer and its counters."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import narrowphase as jn
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import layout, pairs
from substrata_tpu_torch.physics import broadphase as tbp
from substrata_tpu_torch.physics import narrowphase as tn
from substrata_tpu_torch.physics import solver as tsolver
from substrata_tpu_torch.physics.state import SimConfig

from torch_port_helpers import box_config_kwargs, box_world_arrays, jax_body, mixed_world_arrays

torch.set_num_threads(2)

DT = 1.0 / 60.0
_find_pairs = jax.jit(jbp.find_pairs, static_argnames=("config", "has_oversize"))
_pair_contacts = jax.jit(jn.pair_contacts, static_argnames=("config", "blocked_wm"))
_compact = jax.jit(jn.compact_contacts, static_argnames=("max_active",))
_incidence = jax.jit(jsolver.build_incidence, static_argnames=("n_bodies", "cpb"))

OCTA = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                np.float32)
CUBE = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)],
                np.float32)
TET = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) * 0.5
HULLS = [CUBE * 0.6, OCTA * 0.35, TET]


def _library():
    """The same hull library for both packages."""
    lib = jstate.empty_hull_library()
    for h, c in enumerate(HULLS):
        s = jshapes.make_convex_hull(c)
        v = s.hull_verts
        pad = np.repeat(v[:1], 32, 0)
        pad[:len(v)] = v
        pl = np.zeros((32, 4), np.float32)
        pl[:len(s.hull_planes)] = s.hull_planes
        lib = lib.replace(verts=lib.verts.at[h].set(pad), n_verts=lib.n_verts.at[h].set(len(v)),
                          planes=lib.planes.at[h].set(pl),
                          n_faces=lib.n_faces.at[h].set(len(s.hull_planes)))
    arrays = {k: np.asarray(getattr(lib, k)) for k in ("verts", "n_verts", "planes", "n_faces")}
    return lib, convert.hull_library_from_numpy(arrays, device="cpu")


def _mixed_scene(seed, n=60, present=(True, True, True, True), max_pairs=256):
    """A pile of n spheres, boxes and capsules, about 40% of them turned
    into hulls, and the reference's pair list for it."""
    a = mixed_world_arrays(64, n, seed)
    rng = np.random.default_rng(seed)
    for i in rng.choice(n, int(0.4 * n), replace=False):
        h = int(rng.integers(len(HULLS)))
        a["shape_type"][i] = 3
        a["shape_params"][i] = [h, 0, 0, 0]
        a["bound_radius"][i] = float(np.linalg.norm(
            jshapes.make_convex_hull(HULLS[h]).hull_verts, axis=1).max())
    cfg = dict(capacity=64, max_pairs=max_pairs, grid_dim=16, cell_size=2.0, pairs_per_body=8,
               contacts_per_body=4, present_shape_types=present)
    jcfg = jstate.SimConfig(**cfg)
    jbody = jax_body(a)
    pa, pb, pv, _, _ = _find_pairs(jbody, config=jcfg)
    return dict(arrays=a, jbody=jbody, jcfg=jcfg, tcfg=SimConfig(**cfg),
                tbody=convert.body_state_from_numpy(a, device="cpu"),
                pairs=tuple(np.array(x) for x in (pa, pb, pv)))


SCENES = [(17, (True, True, True, True)), (23, (True, True, True, True)),
          (31, (True, True, True, False))]      # hulls present but not declared


@pytest.mark.parametrize("seed,present", SCENES)
def test_grouping_matches_reference(seed, present):
    s = _mixed_scene(seed, present=present)
    jlib, tlib = _library()
    pa, pb, pv = s["pairs"]
    index = {(int(x), int(y)): k for k, (x, y, v) in enumerate(zip(pa, pb, pv)) if v}
    tpairs = tuple(torch.as_tensor(x) for x in s["pairs"])
    buckets, overflow, _ = tn.buckets(s["tbody"], *tpairs, s["tcfg"])
    codes = [code for code, *_ in buckets]
    assert codes == tn._active_codes(s["tcfg"]) and len(codes) > 1
    src = np.concatenate([b[1].numpy() for b in buckets])
    ba = np.concatenate([b[2].numpy() for b in buckets])
    bb = np.concatenate([b[3].numpy() for b in buckets])
    bvalid = np.concatenate([b[4].numpy() for b in buckets])
    wm = 4
    jc, jt, jov = _pair_contacts(s["jbody"], *(jnp.asarray(x) for x in s["pairs"]),
                                 config=s["jcfg"], hulls=jlib, blocked_wm=wm)
    # Pair-blocked rows: a = -1 on an empty slot, else the slot's pair.
    ja, jb_ = np.asarray(jc.a)[::wm], np.asarray(jc.b)[::wm]
    want_src = np.array([index[(x, y)] if x >= 0 else -1 for x, y in zip(ja, jb_)])
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(bvalid, ja >= 0)
    np.testing.assert_array_equal(ba[bvalid], ja[bvalid])
    np.testing.assert_array_equal(bb, jb_)
    assert bvalid.sum() == pv.sum() - int(jov) > 50
    # Compacted rows keep the raw bodies of empty slots too (a[0], b[0]).
    jcc, jtc, jovc = _pair_contacts(s["jbody"], *(jnp.asarray(x) for x in s["pairs"]),
                                    config=s["jcfg"], hulls=jlib, blocked_wm=0)
    widths = np.repeat([tn._MANIFOLD_WIDTH[c] for c, *_ in buckets],
                       [len(b[1]) for b in buckets])
    np.testing.assert_array_equal(np.repeat(ba, widths), np.asarray(jcc.a))
    np.testing.assert_array_equal(np.repeat(bb, widths), np.asarray(jcc.b))
    assert int(overflow) == int(jov) == int(jovc)
    if not present[3]:
        assert int(overflow) > 0                 # the undeclared hull codes
    for blocked_wm, touch in ((wm, jt), (0, jtc)):
        tc, tt, tov = tn.pair_contacts(s["tbody"], *tpairs, s["tcfg"], hulls=tlib,
                                       blocked_wm=blocked_wm)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(touch))
        assert int(tov) == int(jov) and int(tt.sum()) > 10


def _compacted_inputs(seed):
    s = _mixed_scene(seed)
    jlib, _ = _library()
    jc, _, _ = _pair_contacts(s["jbody"], *(jnp.asarray(x) for x in s["pairs"]),
                              config=s["jcfg"], hulls=jlib, blocked_wm=0)
    return s, jc


def _t_contacts(jc):
    return tn.Contacts(*[torch.as_tensor(np.array(getattr(jc, f))) for f in tn.CONTACT_FIELDS])


@pytest.mark.parametrize("seed", [17, 23])
@pytest.mark.parametrize("room", ["enough", "overflow"])
def test_compact_contacts_matches_reference(seed, room):
    _, jc = _compacted_inputs(seed)
    valid = np.asarray(jc.valid)
    touching = valid & (np.asarray(jc.penetration) > 0)
    assert touching.sum() > 20 and (valid & ~touching).sum() > 5
    max_active = int(valid.sum()) + 37 if room == "enough" else int(touching.sum()) // 2
    want, jov = _compact(jc, max_active=max_active)
    got, tov = tn.compact_contacts(_t_contacts(jc), max_active)
    for f in tn.CONTACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(tov) == int(jov)
    assert (int(tov) > 0) == (room == "overflow")


@pytest.mark.parametrize("seed", [17, 23])
@pytest.mark.parametrize("cpb", [1, 2])
def test_incidence_on_compacted_rows(seed, cpb):
    _, jc = _compacted_inputs(seed)
    ccts, _ = _compact(jc, max_active=512)
    a, b = np.array(ccts.a), np.array(ccts.b)
    occ = np.asarray(ccts.valid) & (a >= 0)
    jt, js, jcnt = _incidence(jnp.asarray(a), jnp.asarray(b), jnp.asarray(occ), n_bodies=64,
                              cpb=cpb)
    tt, ts, tcnt = tsolver.build_incidence(torch.as_tensor(a), torch.as_tensor(b),
                                           torch.as_tensor(occ), 64, cpb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    per_body = np.bincount(np.concatenate([a[occ], b[occ & (b >= 0)]]), minlength=64)
    assert (per_body > cpb).sum() >= 3           # bodies that drop entries


def _reference_margins(jbody, jcfg, dt):
    """The per-body margins _pairs_rebuild hands to find_pairs, taken from
    inside the reference's own jitted function."""
    def capture(body, config, margin=0.08, has_oversize=True):
        return margin, margin, margin, jnp.int32(0), jnp.int32(0)
    orig = jbp.find_pairs
    jbp.find_pairs = capture
    try:
        out = jax.jit(jbp._pairs_rebuild, static_argnames=("config", "has_oversize"))(
            jbody, jnp.float32(dt), config=jcfg, has_oversize=False)
    finally:
        jbp.find_pairs = orig
    return np.asarray(out[0]), int(out[5]) + 1


@pytest.mark.parametrize("seed,speed", [(4, 3.0), (7, 10.0), (8, 0.7), (9, 40.0)])
def test_rebuild_margins_bit_equal(seed, speed):
    arrays = box_world_arrays(256, 200, seed, z0=0.39, dz=0.79, speed=speed)
    kw = box_config_kwargs(256)
    want, window = _reference_margins(jax_body(arrays), jstate.SimConfig(**kw), DT)
    tb = convert.body_state_from_numpy(arrays, device="cpu")
    margin, got_window = pairs.rebuild_margins_plain(tb, DT, SimConfig(**kw))
    np.testing.assert_array_equal(margin.numpy().view(np.int32), want.view(np.int32))
    assert int(got_window) == window
    out = tbp._pairs_rebuild(tb, DT, SimConfig(**kw), has_oversize=False)
    assert int(out[5]) == window - 1
    assert len(np.unique(want)) > 100            # per-body margins, not one value


def _oversize_arrays(seed):
    """The box scene with a few bodies grown past the cell size."""
    arrays = box_world_arrays(256, 200, seed, z0=0.39, dz=0.79, speed=1.0)
    for i in (3, 50, 120, 180):
        arrays["bound_radius"][i] = 1.6
        arrays["shape_type"][i] = 0
        arrays["shape_params"][i] = [1.4, 0, 0, 0]
    return arrays


@pytest.mark.parametrize("case", ["truncated", "oversize", "oversize_truncated"])
def test_find_pairs_buffer_matches_reference(case):
    """The sorted pair buffer itself (not just the set) and its counters,
    when max_pairs cuts the rows and with oversize bodies."""
    arrays = _oversize_arrays(11) if case.startswith("oversize") else \
        box_world_arrays(256, 200, 11, z0=0.39, dz=0.79)
    kw = box_config_kwargs(256)
    kw["present_shape_types"] = (True, True, False, False)
    if case.endswith("truncated"):
        kw["max_pairs"] = 64
    jcfg, tcfg = jstate.SimConfig(**kw), SimConfig(**kw)
    jres = _find_pairs(jax_body(arrays), config=jcfg, has_oversize=True)
    tres = tbp.find_pairs(convert.body_state_from_numpy(arrays, device="cpu"), tcfg,
                          has_oversize=True)
    for got, want in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tres[3]) == int(jres[3]) and int(tres[4]) == int(jres[4])
    if case.endswith("truncated"):
        assert int(jres[3]) > kw["max_pairs"] and int(jres[4]) > 0
    if case == "oversize":
        big = {3, 50, 120, 180}
        pa, pb, pv = (np.asarray(x) for x in jres[:3])
        assert sum(1 for x, y, v in zip(pa, pb, pv) if v and (x in big or y in big)) > 10


def test_bucket_caps_match_the_reference_rule():
    for mp in (64, 256, 16_384):
        for code in range(16):
            same = code in (0, 5, 10, 15)
            want = min(mp if same else max(64, mp // 4), mp)
            assert layout.bucket_cap(code, mp, mp) == want

"""KO's twin (kernels/convex.py) and KZ's twin (kernels/pose.py) against
the reference on kernels/hard_cases.py's hull-contact and pose scenes, a
mixed world's hull rows written at their buckets' offsets of one buffer,
and both wrappers' CUDA branches (KO's bucket table, KZ's plan, the packed
launches, the checks) driven on ``meta`` tensors.

The hull-contact scenes: every hull code, a mesh step's sparse buckets,
empty and full buckets, ragged slot counts, cube faces at one depth, the
0.98 bias and the contact margin to float32 rounding, separated pairs,
sensors on either side, a 32-vertex hull and the pair-blocked layout.  A
bucket's occupied slots go through the reference's
``_make_convex_kernel`` (jitted once a code, on rows padded to one size),
and its rows through the epilogue of the reference's ``pair_contacts``
(narrowphase.py:729-775, written out below in numpy): ids and keys exact,
friction and restitution within 1e-5; the valid and touching masks exact
except on slots whose decisions (the axis choice, the margin, a row's
depth against the margin or the prune) lie within 1e-5 of a threshold,
where either branch is a correct rounding (as
tests/test_torch_box_positions.py treats KA's); points, normals and depths
within 1e-5 on the rows both keep (tests/test_torch_hulls.py's tolerance:
XLA contracts and orders the SAT's sums its own way).

The pose scenes: 1, 63, 64, 65 and 256 joints, clips at their first and
last frames, looping and clamped, every override, post rotation and grab,
and padded avatars, against the jitted ``PoseKernel`` built on the same
skeleton and clips: each matrix within 1e-5 of its scale
(tests/test_torch_anim.py's tolerance).  ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold the kernels to these twins on the same scenes, bit
for bit."""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.anim import pose as jpose
from substrata_tpu.anim.clips import AnimationClip as JClip
from substrata_tpu.anim.clips import ClipBank as JBank
from substrata_tpu.anim.skeleton import Skeleton as JSkeleton
from substrata_tpu.physics import narrowphase as jn
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.anim import pose as apose
from substrata_tpu_torch.kernels import build, contact_rows, hard_cases
from substrata_tpu_torch.kernels import convex as ko
from substrata_tpu_torch.kernels import pose as kz
from substrata_tpu_torch.physics import narrowphase as tnp
from substrata_tpu_torch.physics.state import HullLibrary

torch.set_num_threads(2)

ATOL = 1e-5
POSE_TOL = 1e-5
FIELDS = ("a", "b", "point", "normal", "penetration", "valid", "friction", "restitution",
          "key")
REF_ROWS = 2048     # the reference's kernel runs on rows padded to this size

_kernels = {}


def _jlib():
    lib = hard_cases.convex_library(hard_cases.convex_hulls())
    return jstate.empty_hull_library(len(lib["n_verts"])).replace(
        **{k: jnp.asarray(v) for k, v in lib.items()})


def _ref_manifold(code, bodies, a, b):
    """The reference's convex kernel on pairs (a, b): (pts, pens, normal,
    valid) as numpy, jitted once a code on REF_ROWS rows."""
    fn = _kernels.get(code)
    if fn is None:
        fn = _kernels[code] = jax.jit(jn._make_convex_kernel(code // 4, code % 4, _jlib()))

    def rows(ids, st):
        n = len(ids)
        pad = np.zeros(REF_ROWS, np.int64)
        pad[:n] = ids
        out = np.concatenate([bodies["pos"][pad], bodies["quat"][pad],
                              np.full((REF_ROWS, 1), st, np.float32),
                              bodies["shape_params"][pad], np.zeros((REF_ROWS, 3), np.float32)],
                             1)
        return jnp.asarray(out)
    out = []
    for i in range(0, len(a), REF_ROWS):
        part = fn(rows(a[i:i + REF_ROWS], code // 4), rows(b[i:i + REF_ROWS], code % 4))
        n = min(REF_ROWS, len(a) - i)
        out.append([np.asarray(x)[:n] for x in part])
    if not out:
        return (np.zeros((0, 4, 3), np.float32), np.zeros((0, 4), np.float32),
                np.zeros((0, 3), np.float32), np.zeros((0, 4), bool))
    return tuple(np.concatenate(x) for x in zip(*out))


def _ref_bucket(code, wm, blocked, bodies, ba, bb, bv):
    """One bucket's rows as the reference's pair_contacts emits them
    (narrowphase.py:717-775), its convex kernel run on the occupied slots:
    the speculative prune, sensor, friction, restitution, the width and the
    key."""
    cap = len(ba)
    pts = np.zeros((cap, 4, 3), np.float32)
    pens = np.full((cap, 4), -1e9, np.float32)
    normal = np.tile(np.array([0, 0, 1], np.float32), (cap, 1))
    valid = np.zeros((cap, 4), bool)
    occ = np.flatnonzero(bv)
    pts[occ], pens[occ], normal[occ], valid[occ] = _ref_manifold(code, bodies, ba[occ], bb[occ])
    valid &= bv[:, None]
    near = np.any(valid & (pens > -0.01), axis=1)
    deepest = np.argmax(np.where(valid, pens, -1e9), axis=1)
    valid &= near[:, None] | (np.arange(4)[None, :] == deepest[:, None])
    sensor = bodies["is_sensor"][ba] | bodies["is_sensor"][bb]
    fr = np.sqrt(np.maximum(bodies["friction"][ba] * bodies["friction"][bb], np.float32(0)))
    re = np.maximum(bodies["restitution"][ba], bodies["restitution"][bb])
    a = np.where(bv, ba, -1) if blocked else ba
    slot = np.tile(np.arange(wm, dtype=np.int32), cap)
    return (np.repeat(a, wm), np.repeat(bb, wm), pts[:, :wm].reshape(-1, 3),
            np.repeat(normal, wm, axis=0), pens[:, :wm].reshape(-1),
            (valid[:, :wm] & ~sensor[:, None]).reshape(-1), np.repeat(fr, wm),
            np.repeat(re, wm), np.repeat(bb, wm) * 4 + slot + 9, valid.any(axis=1))


def _near_threshold(code, scene, ba, bb, want, wm):
    """The slots whose SAT decisions (the axis choice with its 0.98 bias,
    face B against face A, the separation against the margin) or whose rows'
    depths (against the margin and the prune's -1 cm) lie within ATOL of a
    threshold: there either branch is a correct rounding."""
    lib = hard_cases.convex_library(hard_cases.convex_hulls())
    b = scene.bodies

    def side(ids):
        return b["pos"][ids], b["quat"][ids], None, b["shape_params"][ids]
    fa, fb, x = (t.double().numpy() for t in hard_cases._cx_seps(code, side(ba), side(bb), lib))
    face = np.maximum(fa, fb)
    gap = np.minimum.reduce([np.abs(x - (face * 0.98 + 0.001)), np.abs(fb - (fa * 0.98 + 0.001)),
                             np.abs(np.maximum(face, x) - 0.04)])
    pen = want[4].reshape(-1, wm).astype(np.float64)
    row_gap = np.minimum(np.abs(pen + 0.04), np.abs(pen + 0.01)).min(axis=1)
    return np.minimum(gap, row_gap) < ATOL


@pytest.mark.parametrize("case", hard_cases.CONVEX_CASES)
def test_convex_scene_twin_matches_reference(case):
    scene = hard_cases.convex_scene(case)
    buckets, wms, blocked, *rows, lib = hard_cases.convex_inputs(scene, "cpu")
    got = ko.convex_buckets(buckets, wms, blocked, *rows, lib)
    touching, near_slots = 0, 0
    for (code, ba, bb, bv), wm, g in zip(buckets, wms, got):
        ba_n, bb_n, bv_n = ba.numpy(), bb.numpy(), bv.numpy()
        want = _ref_bucket(code, wm, blocked, scene.bodies, ba_n, bb_n, bv_n)
        far = ~(_near_threshold(code, scene, ba_n, bb_n, want, wm) & bv_n)
        near_slots += int((~far).sum())
        far_rows = np.repeat(far, wm)
        both = far_rows & want[5] & g[5].numpy()
        what = f"{case} code {code}"
        for i in (0, 1, 8):
            np.testing.assert_array_equal(g[i].numpy(), want[i], err_msg=f"{what} {FIELDS[i]}")
        for i in (6, 7):
            np.testing.assert_allclose(g[i].numpy(), want[i], atol=ATOL, rtol=0,
                                       err_msg=f"{what} {FIELDS[i]}")
        np.testing.assert_array_equal(g[5].numpy()[far_rows], want[5][far_rows],
                                      err_msg=f"{what} valid")
        np.testing.assert_array_equal(g[9].numpy()[far], want[9][far], err_msg=f"{what} touch")
        for i in (2, 3, 4):
            np.testing.assert_allclose(g[i].numpy()[both], want[i][both], atol=ATOL, rtol=0,
                                       err_msg=f"{what} {FIELDS[i]}")
        touching += int(want[9].sum())
    # The cases are really there.
    if case in ("all_empty", "separated"):
        assert touching == 0
    else:
        assert touching > 0
    if case in ("bias_ties", "margin_ties"):
        assert near_slots >= 64, near_slots
    elif case == "hull_32":
        assert int(lib.n_verts[4]) == 32
    elif case == "blocked_wm4":
        assert blocked and set(wms) == {4} and any(bool((g[0] == -1).any()) for g in got)
    elif case == "ragged":
        assert all(b[1].shape[0] % 4 for b in buckets)


def test_convex_tie_scenes_sit_at_their_thresholds():
    """The tie scenes' pairs sit at their decision to float32 rounding: the
    margin scene's separations within 1e-5 of the 4 cm margin, the bias
    scene's chosen decision within 1e-5 of its threshold."""
    lib = hard_cases.convex_library(hard_cases.convex_hulls())
    for case in ("margin_ties", "bias_ties"):
        scene = hard_cases.convex_scene(case)
        b = scene.bodies
        near = 0
        for code, ba, bb, _ in scene.buckets:
            side = (lambda ids, st: (b["pos"][ids], b["quat"][ids], None,
                                     b["shape_params"][ids]))
            fa, fb, x = hard_cases._cx_seps(code, side(ba, code // 4), side(bb, code % 4), lib)
            if case == "margin_ties":
                d = torch.maximum(torch.maximum(fa, fb), x) - 0.04
            else:
                d = torch.minimum((x - (torch.maximum(fa, fb) * 0.98 + 0.001)).abs(),
                                  (fb - (fa * 0.98 + 0.001)).abs())
            near += int((d.abs() < 1e-5).sum())
        assert near > 100, (case, near)


# --- The mixed world's hull rows at their offsets of one buffer.

def test_pair_contacts_hull_rows_equal_the_joined_buckets():
    """``pair_contacts`` runs every hull bucket in one call, writing KO's
    rows at their buckets' offsets of the step's buffer: every field equals
    the buckets' own calls joined in code order, to the bit."""
    from torch_port_helpers import mixed_world_arrays
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics.state import SimConfig
    lib = hard_cases.convex_library(hard_cases.convex_hulls())
    tlib = convert.hull_library_from_numpy(lib, device="cpu")
    a = mixed_world_arrays(64, 60, 17)
    rng = np.random.default_rng(17)
    for i in rng.choice(60, 24, replace=False):
        a["shape_type"][i] = 3
        a["shape_params"][i] = [rng.integers(4), 0, 0, 0]
    cfg = SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=2.0, pairs_per_body=8,
                    present_shape_types=(True, True, True, True))
    body = convert.body_state_from_numpy(a, device="cpu")
    ia, ib = np.triu_indices(60, 1)
    near = np.linalg.norm(a["pos"][ia] - a["pos"][ib], axis=1) < 2.0
    pa = np.full(256, -1, np.int32)
    pb = np.full(256, -1, np.int32)
    m = min(int(near.sum()), 256)
    pa[:m], pb[:m] = ia[near][:m], ib[near][:m]
    pa, pb = torch.as_tensor(pa), torch.as_tensor(pb)
    pv = pa >= 0
    for blocked_wm in (0, 4):
        tc, _, _ = tnp.pair_contacts(body, pa, pb, pv, cfg, hulls=tlib, blocked_wm=blocked_wm)
        groups = tnp.buckets(body, pa, pb, pv, cfg)[0]
        assert sum(c in ko.CODES for c, *_ in groups) > 1
        rows = [tnp._bucket_rows(c, blocked_wm or tnp._MANIFOLD_WIDTH[c], bool(blocked_wm), body,
                                 ba, bb, bv, tlib)[:9] for c, _, ba, bb, bv in groups]
        for i, name in enumerate(FIELDS):
            g, w = getattr(tc, name), torch.cat([r[i] for r in rows])
            assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                               w.view(torch.int32) if w.is_floating_point() else w), name


# --- KZ's twin against the reference.

def _jpose_kernel(scene):
    skel = JSkeleton(list(scene.names), scene.parents, scene.rest_trans, scene.rest_rot,
                     scene.rest_scale)
    bank = JBank(skel, [JClip(n, r, t, loop) for n, r, t, loop in scene.clips])
    return jpose.PoseKernel(skel, bank)


@pytest.mark.parametrize("case", hard_cases.POSE_CASES)
def test_pose_scene_twin_matches_reference(case):
    scene = hard_cases.pose_scene(case)
    bank, rig, p = hard_cases.pose_inputs(scene, "cpu")
    got = kz.pose(bank, rig, p)
    want = _jpose_kernel(scene)(jpose.PoseParams(**{k: jnp.asarray(v)
                                                   for k, v in scene.arrays.items()}))
    for name, g, w in zip(("joints_obj", "joints_world", "skin"), got, want):
        g, w = g.double().numpy(), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), (case, name)
        scale = np.maximum(np.abs(w).max(axis=(-1, -2), keepdims=True), 1.0)
        err = (np.abs(g - w) / scale).max()
        assert err <= POSE_TOL, f"{case} {name}: {err:.3g} of scale"
    nj = len(scene.names)
    assert got.shape == (3, len(scene.arrays["clip_a"]), nj, 4, 4)
    if case == "j256":
        assert nj * 16 > 1024 and rig.n_levels > 1
    elif case == "every_option":
        assert bool((rig.joint_slot >= 0).sum() == kz.NUM_SLOTS)
        assert bool((rig.joint_finger >= 0).sum() == 30)


# --- KO's and KZ's CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


def _meta_lib(lib):
    return HullLibrary(**{f: _meta(getattr(lib, f))
                          for f in ("verts", "n_verts", "planes", "n_faces")})


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(ko, "_plans", {})
    monkeypatch.setattr(kz, "_plans", {})
    return calls


@pytest.mark.parametrize("case", ["every_code", "mesh_step", "ragged", "blocked_wm4"])
def test_convex_plan_packs_and_checks(recorded, case):
    """One plan per layout (codes, slots, widths, offsets, placement,
    device): its bucket table (code, width, first block, slots, offsets)
    with 8 blocks a tile of 32 slots, aligned to buckets, packed after the
    launch's 29 words; the outputs views of one contact buffer with the
    twin's shapes and dtypes; a bad argument raises before a launch."""
    scene = hard_cases.convex_scene(case)
    buckets, wms, blocked, *rows, lib = hard_cases.convex_inputs(scene, "cpu")
    mb = [(c, *(_meta(t) for t in x)) for c, *x in buckets]
    mrows = [_meta(t) for t in rows]
    mlib = _meta_lib(lib)
    got = ko.convex_buckets(mb, wms, blocked, *mrows, mlib)
    want = ko.convex_buckets(buckets, wms, blocked, *rows, lib)
    for g, w in zip(got, want):
        assert [(tuple(x.shape), x.dtype) for x in g] == [(tuple(y.shape), y.dtype) for y in w]
    (key, plan), = ko._plans.items()
    caps = [b[1].shape[0] for b in buckets]
    size = 49 * sum(c * w for c, w in zip(caps, wms)) + sum(caps)
    assert all(x.untyped_storage().nbytes() == size for g in got for x in g)
    name, packed = recorded[-1]
    v = ko._PACK.unpack(packed[:ko._PACK.size])
    nb, m = len(buckets), ko.MAX_BUCKETS
    first = np.cumsum([0] + [-(-c // 32) * 8 for c in caps]).tolist()
    assert name == "convex_buckets"
    assert len(packed) == ko._PACK.size + 4 * m + ko._BUCKET.size * m
    assert v[23:] == (int(blocked), nb, first[-1], int(lib.capacity), 32, 32)
    assert plan.blocks == first[-1] and key[:3] == (tuple(b[0] for b in buckets), tuple(caps),
                                                    tuple(wms))
    rows_at = np.cumsum([0] + [c * w for c, w in zip(caps, wms)])[:-1].tolist()
    table = packed[ko._PACK.size:]
    firsts = struct.unpack(f"={m}i", table[:4 * m])
    assert list(firsts[:nb]) == first[:-1] and set(firsts[nb:]) <= {ko._NO_BLOCK}
    recs = [ko._BUCKET.unpack_from(table, 4 * m + ko._BUCKET.size * k) for k in range(nb)]
    assert [list(r[3:]) for r in recs] == [[c, w, b0, n] for c, w, b0, n in
                                           zip(key[0], wms, first, caps)]
    assert [r[1] for r in recs] == rows_at and [r[0] for r in recs] == list(key[3])
    ko.convex_buckets(mb, wms, blocked, *mrows, mlib)
    assert len(ko._plans) == 1 and len(recorded) == 2
    code, ba, bb, bv = mb[0]
    n = mrows[0].shape[0]
    bads = (([(code, ba.long(), bb, bv)] + mb[1:], mrows, TypeError),
            ([(code, ba, bb[:-1], bv)] + mb[1:], mrows, ValueError),
            ([(code, ba, bb, bv.int())] + mb[1:], mrows, TypeError),
            ([(5, ba, bb, bv)] + mb[1:], mrows, ValueError),
            (mb, [mrows[0][:, :2]] + mrows[1:], ValueError),
            (mb, mrows[:5] + [torch.empty(n, device="meta")], TypeError),
            (mb * 8, mrows, ValueError))
    for bad_b, bad_rows, exc in bads:
        with pytest.raises(exc):
            ko.convex_buckets(bad_b, wms * 8 if len(bad_b) > len(mb) else wms, blocked,
                              *bad_rows, mlib)
    with pytest.raises(ValueError):
        ko.convex_buckets(mb, (5,) * len(mb), blocked, *mrows, mlib)
    big = HullLibrary(verts=torch.empty((5, 33, 3), device="meta"), n_verts=mlib.n_verts,
                      planes=mlib.planes, n_faces=mlib.n_faces)
    with pytest.raises(ValueError):
        ko.convex_buckets(mb, wms, blocked, *mrows, big)
    assert len(recorded) == 2


def test_convex_buckets_write_into_caller_rows(recorded):
    """With ``out``, the plan's table places each bucket's rows and flags
    at the offsets given and the launch writes the caller's fields
    (nothing is returned); ``convex_rows`` with its 10 outputs writes them
    at offset 0; rows too few for the buckets raise."""
    scene = hard_cases.convex_scene("every_code")
    buckets, wms, blocked, *rows, lib = hard_cases.convex_inputs(scene, "cpu")
    mb = [(c, *(_meta(t) for t in x)) for c, *x in buckets]
    mrows = [_meta(t) for t in rows]
    mlib = _meta_lib(lib)
    caps = [b[1].shape[0] for b in buckets]
    r = sum(c * w for c, w in zip(caps, wms))
    fields, touch = contact_rows.contact_buffer(r + 64, sum(caps) + 8, "meta")
    rows_at = (64 + np.cumsum([0] + [c * w for c, w in zip(caps, wms)])[:-1]).tolist()
    touch_at = (8 + np.cumsum([0] + caps)[:-1]).tolist()
    assert ko.convex_buckets(mb, wms, blocked, *mrows, mlib,
                             out=(fields, touch, rows_at, touch_at)) is None
    (key, plan), = ko._plans.items()
    assert [x[5] for x in plan.host_table] == rows_at
    assert [x[6] for x in plan.host_table] == touch_at
    code, ba, bb, bv = mb[0]
    outs = contact_rows.outputs(None, caps[0] * wms[0], caps[0], "meta")
    assert ko.convex_rows(code, wms[0], blocked, *mrows, ba, bb, bv, mlib, out=outs) is outs
    rec = ko._BUCKET.unpack_from(recorded[-1][1], ko._PACK.size + 4 * ko.MAX_BUCKETS)
    assert rec[:3] == (0, 0, 0) and rec[3:] == (code, wms[0], 0, caps[0])
    fields2, touch2 = contact_rows.contact_buffer(r, sum(caps), "meta")
    with pytest.raises(ValueError):
        ko.convex_buckets(mb, wms, blocked, *mrows, mlib, out=(fields2, touch2, rows_at,
                                                               touch_at))
    assert len(recorded) == 2


@pytest.mark.parametrize("case", ["j1", "j65", "j256"])
def test_pose_plan_packs_and_checks(recorded, case):
    """One plan per (A, J, bank rows, clips, grab rows, device); the packed
    launch's 23 input pointers, the output, f_cap, n_half, A, J, the slots,
    the levels and the clips; a bad argument raises before a launch."""
    scene = hard_cases.pose_scene(case)
    bank, rig, p = hard_cases.pose_inputs(scene, "cpu")
    mbank = type("Bank", (), dict(rot=_meta(bank.rot), trans=_meta(bank.trans),
                                  n_frames=_meta(bank.n_frames), looping=_meta(bank.looping),
                                  f_cap=bank.f_cap))
    mrig = dataclasses.replace(rig, **{f: _meta(getattr(rig, f)) for f in (
        "parent", "depth", "joint_slot", "joint_finger", "grab_quats", "rest_scale",
        "inverse_bind")})
    mp = apose.PoseParams(**{f: _meta(getattr(p, f))
                             for f in apose.PoseParams.__dataclass_fields__})
    out = kz.pose(mbank, mrig, mp)
    a, nj = p.count, len(scene.names)
    assert tuple(out.shape) == (3, a, nj, 4, 4) and out.dtype == torch.float32
    name, packed = recorded[-1]
    v = kz._PACK.unpack(packed)
    assert name == "pose_avatars" and len(packed) == kz._PACK.size
    assert v[24:] == (bank.f_cap, 15, a, nj, kz.NUM_SLOTS, rig.n_levels,
                      bank.n_frames.shape[0])
    kz.pose(mbank, mrig, mp)
    assert len(kz._plans) == 1 and len(recorded) == 2
    bads = ((mbank, dataclasses.replace(mrig, depth=mrig.depth.long()), mp, TypeError),
            (mbank, dataclasses.replace(mrig, rest_scale=mrig.rest_scale[:, :2]), mp,
             ValueError),
            (mbank, mrig, dataclasses.replace(mp, blend=mp.blend[:-1]), ValueError),
            (mbank, mrig, dataclasses.replace(mp, post_mask=mp.post_mask.int()), TypeError))
    for bb_, br, bp, exc in bads:
        with pytest.raises(exc):
            kz.pose(bb_, br, bp)
    assert len(recorded) == 2

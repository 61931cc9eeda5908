"""KK's twin (kernels/closed_forms.py) and KAA's setup twin
(kernels/audio_setup.py:audio_setup_plain) against the reference on
kernels/hard_cases.py's closed-form and audio-setup scenes; the mixed
world's contact rows written at their buckets' offsets of one buffer, as
the joined buckets were; and both wrappers' CUDA branches (the bucket
table's plan, the packed launches, the checks) driven on ``meta``
tensors.

The closed-form scenes: every code, empty buckets, a bucket's first and
last slot, a warp of one pair, of 4, 5 and 32 distinct pairs, capsules
parallel to a box face, sensors on either side, the pair-blocked layout
at widths 1, 2 and 4, a single-combo world's stale ids, ragged bucket
sizes and mixed piles through the grouping.  A bucket's twin rows are
held against the reference's ``_CLOSED_FORM_KERNELS[code]`` and the
per-bucket epilogue of its ``pair_contacts`` (narrowphase.py:729-775,
written out below on the reference's own functions); the pair scenes go
through both packages' ``pair_contacts``.  Tolerances are
tests/test_torch_closed_forms.py's: points, normals and depths within
1e-5 on the valid rows (a capsule-box normal within 1e-3 where the
capsule's sphere centre lies within 1 cm outside the box: its direction
comes from a separation under 1 cm, so 1e-7 m of rounding in the points
moves it by up to 1e-5 / separation), friction and restitution within
1e-5; ids, masks, keys and touching exact.

The audio-setup scenes: 1, 31, 32, 33, 512 and 1,024 sources, 1 and 3
layers, sources at the listener, behind it, straight above and below it,
on the azimuth wrap, dead, paused and finished sources, the Doppler
clamps, occlusion and a mute rate of 0, each with HRTF on and off.
Tolerances are tests/test_torch_audio.py's: every field exact, but the
pan's cos and sin (HRTF off) within 1e-6 of the gains' scale; an HRIR bin
may differ only where its pre-round value lies within 1e-5 of a
half-integer, and none does on these scenes.  ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold the kernels to these twins on the same
scenes."""

import struct
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.physics import narrowphase as jnp_phase
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.kernels import audio_setup as kaa
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import closed_forms as kk
from substrata_tpu_torch.kernels import contact_rows
from substrata_tpu_torch.physics import narrowphase as tnp

from test_torch_audio import _jsetup
from torch_port_helpers import jax_body

torch.set_num_threads(2)

ATOL = 1e-5
FIELDS = ("a", "b", "point", "normal", "penetration", "valid", "friction", "restitution",
          "key")


@jax.jit
def _pview(body):
    return jnp.concatenate([body.pos, body.quat, body.shape_type.astype(jnp.float32)[:, None],
                            body.shape_params, body.friction[:, None],
                            body.restitution[:, None],
                            body.is_sensor.astype(jnp.float32)[:, None]], axis=1)


def _ref_bucket(code, wm, blocked, pview, ba, bb, bvalid):
    """One bucket's rows as the reference's pair_contacts emits them
    (narrowphase.py:717-770): its closed form, the speculative prune,
    sensor, friction, restitution, the width's padding and the key."""
    cap = ba.shape[0]
    bva, bvb = pview[ba], pview[bb]
    pts, pens, normal, valid = jnp_phase._CLOSED_FORM_KERNELS[code](bva, bvb)
    valid = valid & bvalid[:, None]
    near_pts = jnp.any(valid & (pens > -0.01), axis=1)
    deepest = jnp.argmax(jnp.where(valid, pens, -1e9), axis=1)
    keep1 = jnp.arange(pens.shape[1])[None, :] == deepest[:, None]
    valid = valid & (near_pts[:, None] | keep1)
    sensor_b = (bva[:, 14] > 0) | (bvb[:, 14] > 0)
    fr_b = jnp_phase.combine_friction(bva[:, 12], bvb[:, 12])
    re_b = jnp_phase.combine_restitution(bva[:, 13], bvb[:, 13])
    if pts.shape[1] < wm:
        padw = wm - pts.shape[1]
        pts = jnp.concatenate([pts, jnp.zeros((cap, padw, 3), pts.dtype)], axis=1)
        pens = jnp.concatenate([pens, jnp.full((cap, padw), -1e9, pens.dtype)], axis=1)
        valid = jnp.concatenate([valid, jnp.zeros((cap, padw), bool)], axis=1)
    cw = cap * wm
    slotw = jnp.tile(jnp.arange(wm, dtype=jnp.int32), cap)
    a_entry = jnp.where(bvalid, ba, -1) if blocked else ba
    return (jnp.repeat(a_entry, wm)[:cw], jnp.repeat(bb, wm)[:cw], pts[:, :wm].reshape(cw, 3),
            jnp.repeat(normal, wm, axis=0)[:cw], pens[:, :wm].reshape(cw),
            (valid[:, :wm] & ~sensor_b[:, None]).reshape(cw), jnp.repeat(fr_b, wm)[:cw],
            jnp.repeat(re_b, wm)[:cw], jnp.repeat(bb, wm)[:cw] * 4 + slotw + 9,
            jnp.any(valid, axis=1))


_ref_bucket_jit = jax.jit(_ref_bucket, static_argnums=(0, 1, 2))


def _normal_tol(code, wm, scene, ba, bb, jpens):
    """Each row's normal tolerance: 1e-3 for a capsule-box slot whose
    capsule sphere lies within 1 cm outside the box, else 1e-5."""
    tol = np.full(ba.shape[0], ATOL)
    if code in (6, 9):
        cap_side = bb if code == 6 else ba
        rc = scene.bodies["shape_params"][cap_side, 0]
        sep = rc - jpens.reshape(-1, wm)[:, 0]
        tol = np.where((sep > 0) & (sep < 0.01), 1e-3, ATOL)
    return np.repeat(tol, wm)


def _assert_rows(got, want, what, normal_tol=None):
    jvalid = np.asarray(want[5])
    for i, name in enumerate(FIELDS + ("touching",)):
        g, w = got[i].numpy(), np.asarray(want[i])
        assert g.shape == w.shape, (what, name)
        if name in ("point", "penetration", "friction", "restitution"):
            mask = jvalid if name in ("point", "penetration") else np.ones_like(jvalid)
            np.testing.assert_allclose(g[mask], w[mask], atol=ATOL, rtol=0,
                                       err_msg=f"{what} {name}")
        elif name == "normal":
            tol = np.full(jvalid.shape, ATOL) if normal_tol is None else normal_tol
            err = np.abs(g - w).max(axis=1)
            assert (err[jvalid] <= tol[jvalid]).all(), (what, float(err[jvalid].max()))
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", hard_cases.CLOSED_FORM_CASES)
def test_closed_form_scene_twin_matches_reference(case):
    scene = hard_cases.closed_form_scene(case)
    if scene.pairs is not None:
        (body, pa, pb, pv, cfg), kw = hard_cases.closed_form_pair_inputs(scene, "cpu")
        tc, tt, tov = tnp.pair_contacts(body, pa, pb, pv, cfg, **kw)
        jcfg = jstate.SimConfig(**scene.cfg)
        jc, jt, jov = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))(
            jax_body(scene.bodies), *(jnp.asarray(x) for x in scene.pairs), config=jcfg,
            blocked_wm=scene.blocked_wm)
        assert int(tov) == int(jov)
        _assert_rows([getattr(tc, f) for f in FIELDS] + [tt],
                     [getattr(jc, f) for f in FIELDS] + [jt], case)
        assert 0 < int(np.asarray(jt).sum())
        if case == "single_combo":
            assert (scene.pairs[0] < 0).any() and not scene.pairs[2].all()
        return
    buckets, wms, blocked, *rows = hard_cases.closed_form_inputs(scene, "cpu")
    got = kk.closed_form_buckets(buckets, wms, blocked, *rows)
    pview = _pview(jax_body(scene.bodies))
    touching = 0
    for (code, ba, bb, bv), wm, g in zip(buckets, wms, got):
        ba_n, bb_n = ba.numpy(), bb.numpy()
        want = _ref_bucket_jit(code, wm, blocked, pview, jnp.asarray(ba_n), jnp.asarray(bb_n),
                               jnp.asarray(bv.numpy()))
        tol = _normal_tol(code, wm, scene, ba_n, bb_n, np.asarray(want[4]))
        _assert_rows(g, want, f"{case} code {code}", tol)
        touching += int(np.asarray(want[9]).sum())
    # The cases are really there.
    if case == "all_empty":
        assert touching == 0
    else:
        assert touching > 0
    if case.startswith("distinct_"):
        k = int(case[-1])
        for _, ba, bb, _ in buckets:
            key = (ba.long() << 32 | bb.long()).reshape(-1, 32)
            assert all(len(set(w.tolist())) == k for w in key)
    elif case == "sensors":
        assert scene.bodies["is_sensor"].sum() > 0
    elif case.startswith("blocked_wm"):
        assert blocked and set(wms) == {int(case[-1])}
        assert any(bool((g[0] == -1).any()) for g in got)


@pytest.mark.parametrize("case", hard_cases.AUDIO_SETUP_CASES)
def test_audio_setup_scene_twin_matches_reference(case):
    scene = hard_cases.audio_setup_scene(case)
    src = scene.sources
    s, nl = src["delta"].shape
    # Named tuples: pytrees that jax.jit takes, with the fields _jsetup reads.
    jsrc = namedtuple("Sources", list(src) + ["buf_len"])(
        *(jnp.asarray(v) for v in src.values()), jnp.zeros((s, nl), jnp.int32))
    jlis = namedtuple("Listener", list(scene.listener))(
        *(jnp.asarray(v) for v in scene.listener.values()))
    jsetup = jax.jit(_jsetup, static_argnums=(2, 3, 4))
    for use_hrtf in (True, False):
        args = hard_cases.audio_setup_inputs(scene, "cpu", use_hrtf)
        got = kaa.setup_views(kaa.audio_setup(*args), s, nl)
        want = jsetup(jsrc, jlis, scene.block, scene.block / kaa.ENGINE_RATE, use_hrtf)
        for name, w in want.items():
            g, w = got[name].numpy(), np.asarray(w)
            if name in ("gl", "gr") and not use_hrtf:
                scale = max(float(np.abs(w).max()), 1.0)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale,
                                           err_msg=f"{case} {name}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{case} HRTF {use_hrtf}: {name}")
        if case == "azimuth_wrap" and use_hrtf:
            # Every source behind the listener on x = +-0, +-1e-3, +-1e-30
            # lands in azimuth bin 8 (atan2 at +-pi).
            behind = got["dir_idx"].numpy()[:s // 2] // 3
            assert (behind == 8).all(), behind
        elif case == "doppler_clamp":
            dop = np.asarray(want["dop_smooth"])
            assert dop.size == s
        elif case == "at_listener":
            assert (np.linalg.norm(src["pos"] - scene.listener["pos"], axis=1) == 0).any()


def test_audio_setup_scenes_reach_their_edges():
    """The Doppler factor reaches both clamps and the divisor's floor; the
    elevation both clamps; the mute rate 0 leaves every fade where it is."""
    from substrata_tpu_torch.maths.fp import dot3
    sc = hard_cases.audio_setup_scene("doppler_clamp")
    to = sc.sources["pos"] - sc.listener["pos"]
    dirn = to / np.linalg.norm(to, axis=1, keepdims=True)
    v_src = (sc.sources["vel"] * dirn).sum(axis=1)
    v_lis = float(sc.listener["vel"] @ dirn[0])
    raw = (343.0 - (dirn @ sc.listener["vel"])) / np.maximum(343.0 + v_src, 1.0)
    assert (raw > 2.0).any() and (raw < 0.5).any() and (343.0 + v_src < 1.0).any()
    assert np.isfinite(v_lis)
    sc = hard_cases.audio_setup_scene("behind_above")
    t = torch.as_tensor(sc.sources["pos"])
    up = dot3(t, torch.as_tensor(sc.listener["up"])[None])
    flat = (t[:, 0] == 0) & (t[:, 1] == 0)
    assert bool((flat & (up > 0)).any()) and bool((flat & (up < 0)).any())
    sc = hard_cases.audio_setup_scene("mute_rate_0")
    v = kaa.setup_views(kaa.audio_setup(*hard_cases.audio_setup_inputs(sc, "cpu", True)), 64, 3)
    np.testing.assert_array_equal(v["mute"].numpy(), sc.sources["mute_factor"])


# --- The mixed world's rows at their offsets of one buffer.

def _joined(body, pa, pb, pv, cfg, blocked_wm):
    """The mixed world's rows as the bucket rows joined one after another
    (each bucket's own call, then a cat of each field)."""
    groups, _, _ = tnp.buckets(body, pa, pb, pv, cfg)
    rows, touches = [], []
    for code, _, ba, bb, bv in groups:
        r = tnp._bucket_rows(code, blocked_wm or tnp._MANIFOLD_WIDTH[code], bool(blocked_wm),
                             body, ba, bb, bv, None)
        rows.append(r[:9])
        touches.append(r[9])
    return [torch.cat([r[i] for r in rows]) for i in range(9)], groups, touches


@pytest.mark.parametrize("case", ["grouped_mixed", "grouped_blocked"])
def test_pair_contacts_rows_equal_the_joined_buckets(case):
    """``pair_contacts`` writes KA's, KK's and KO's rows at their buckets'
    offsets of one allocation: every field equals the bucket rows joined
    in code order, to the bit, and the touching flags equal the scatter of
    the buckets' own."""
    from substrata_tpu_torch.kernels import layout as kt
    scene = hard_cases.closed_form_scene(case)
    (body, pa, pb, pv, cfg), kw = hard_cases.closed_form_pair_inputs(scene, "cpu")
    tc, tt, _ = tnp.pair_contacts(body, pa, pb, pv, cfg, **kw)
    want, groups, touches = _joined(body, pa, pb, pv, cfg, kw["blocked_wm"])
    assert any(c == tnp._BOX_BOX for c, *_ in groups)
    assert sum(c in kk.CODES for c, *_ in groups) > 1
    for name, w in zip(FIELDS, want):
        g = getattr(tc, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w), name
    assert torch.equal(tt, kt.touching_plain([g[1] for g in groups], touches, pa.shape[0]))
    # The fields are views of one buffer.
    store = tc.a.untyped_storage().data_ptr()
    assert all(getattr(tc, f).untyped_storage().data_ptr() == store for f in FIELDS)


def test_contact_buffer_views():
    """``contact_buffer``'s fields: the Contacts dtypes and shapes, views of
    one allocation that do not overlap."""
    fields, touch = contact_rows.contact_buffer(10, 7, "cpu")
    want = ((torch.int32, (10,)), (torch.int32, (10,)), (torch.float32, (10, 3)),
            (torch.float32, (10, 3)), (torch.float32, (10,)), (torch.bool, (10,)),
            (torch.float32, (10,)), (torch.float32, (10,)), (torch.int32, (10,)))
    assert [(f.dtype, tuple(f.shape)) for f in fields] == list(want)
    assert touch.dtype == torch.bool and tuple(touch.shape) == (7,)
    spans = sorted((f.data_ptr(), f.data_ptr() + f.numel() * f.element_size())
                   for f in fields + (touch,))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] - spans[0][0] == 49 * 10 + 7


# --- KK's and KAA's CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(kk, "_plans", {})
    monkeypatch.setattr(kaa, "_plans", {})
    return calls


@pytest.mark.parametrize("case", ["every_code", "all_empty", "ragged", "blocked_wm2"])
def test_closed_form_plan_packs_and_checks(recorded, case):
    """One plan per layout (codes, slots, widths, offsets, placement,
    device): its bucket table (code, width, first block, slots, offsets)
    with blocks aligned to buckets, packed after the launch's 22 words; the
    outputs views of one contact buffer with the twin's shapes and dtypes;
    a bad argument raises before a launch."""
    scene = hard_cases.closed_form_scene(case)
    buckets, wms, blocked, *rows = hard_cases.closed_form_inputs(scene, "cpu")
    mb = [(c, *(_meta(t) for t in x)) for c, *x in buckets]
    mrows = [_meta(t) for t in rows]
    got = kk.closed_form_buckets(mb, wms, blocked, *mrows)
    want = kk.closed_form_buckets(buckets, wms, blocked, *rows)
    for g, w in zip(got, want):
        assert [(tuple(x.shape), x.dtype) for x in g] == [(tuple(y.shape), y.dtype) for y in w]
    (key, plan), = kk._plans.items()
    caps = [b[1].shape[0] for b in buckets]
    size = 49 * sum(c * w for c, w in zip(caps, wms)) + sum(caps)
    assert all(x.untyped_storage().nbytes() == size for g in got for x in g)
    name, packed = recorded[-1]
    v = kk._PACK.unpack(packed[:kk._PACK.size])
    nb, m = len(buckets), kk.MAX_BUCKETS
    blocks = sum(-(-c // kk._BLOCK) for c in caps)
    assert name == "closed_form_buckets"
    assert len(packed) == kk._PACK.size + 4 * m + kk._BUCKET.size * m
    assert v[19:] == (int(blocked), nb, blocks)
    assert plan.blocks == blocks and key[:3] == (tuple(b[0] for b in buckets), tuple(caps),
                                                 tuple(wms))
    rows_at = np.cumsum([0] + [c * w for c, w in zip(caps, wms)])[:-1].tolist()
    first = np.cumsum([0] + [-(-c // kk._BLOCK) for c in caps])[:-1].tolist()
    assert [r[:4] for r in plan.host_table] == [[c, w, b0, n] for c, w, b0, n in
                                                zip(key[0], wms, first, caps)]
    assert [r[5] for r in plan.host_table] == rows_at == list(key[4])
    # The packed table: the first blocks (unused entries past every block),
    # then a record a bucket (offsets; code, width, first block, slots).
    table = packed[kk._PACK.size:]
    firsts = struct.unpack(f"={m}i", table[:4 * m])
    assert list(firsts[:nb]) == first and set(firsts[nb:]) <= {kk._NO_BLOCK}
    recs = [kk._BUCKET.unpack_from(table, 4 * m + kk._BUCKET.size * k) for k in range(nb)]
    assert [list(r[3:]) for r in recs] == [[c, w, b0, n] for c, w, b0, n in
                                           zip(key[0], wms, first, caps)]
    assert [r[1] for r in recs] == rows_at and [r[0] for r in recs] == list(key[3])
    kk.closed_form_buckets(mb, wms, blocked, *mrows)
    assert len(kk._plans) == 1 and len(recorded) == 2
    code, ba, bb, bv = mb[0]
    n = mrows[0].shape[0]
    bads = (([(code, ba.long(), bb, bv)] + mb[1:], mrows, TypeError),
            ([(code, ba, bb[:-1], bv)] + mb[1:], mrows, ValueError),
            ([(code, ba, bb, bv.int())] + mb[1:], mrows, TypeError),
            ([(5, ba, bb, bv)] + mb[1:], mrows, ValueError),
            (mb, [mrows[0][:, :2]] + mrows[1:], ValueError),
            (mb, mrows[:5] + [torch.empty(n, device="meta")], TypeError),
            (mb * 17, mrows, ValueError))
    for bad_b, bad_rows, exc in bads:
        with pytest.raises(exc):
            kk.closed_form_buckets(bad_b, wms * 17 if len(bad_b) > len(mb) else wms, blocked,
                                   *bad_rows)
    with pytest.raises(ValueError):
        kk.closed_form_buckets(mb, (5,) * len(mb), blocked, *mrows)
    assert len(recorded) == 2


def test_closed_form_buckets_write_into_caller_rows(recorded):
    """With ``out``, the plan's table places each bucket's rows and flags
    at the offsets given, the launch writes the caller's fields (nothing is
    returned), and rows too few for the buckets raise."""
    scene = hard_cases.closed_form_scene("every_code")
    buckets, wms, blocked, *rows = hard_cases.closed_form_inputs(scene, "cpu")
    mb = [(c, *(_meta(t) for t in x)) for c, *x in buckets]
    mrows = [_meta(t) for t in rows]
    caps = [b[1].shape[0] for b in buckets]
    r = sum(c * w for c, w in zip(caps, wms))
    fields, touch = contact_rows.contact_buffer(r + 64, sum(caps) + 8, "meta")
    rows_at = (64 + np.cumsum([0] + [c * w for c, w in zip(caps, wms)])[:-1]).tolist()
    touch_at = (8 + np.cumsum([0] + caps)[:-1]).tolist()
    assert kk.closed_form_buckets(mb, wms, blocked, *mrows,
                                  out=(fields, touch, rows_at, touch_at)) is None
    (key, plan), = kk._plans.items()
    assert [r[5] for r in plan.host_table] == rows_at
    assert [r[6] for r in plan.host_table] == touch_at
    assert key[4:6] == (tuple(rows_at), tuple(touch_at))
    fields2, touch2 = contact_rows.contact_buffer(r, sum(caps), "meta")
    with pytest.raises(ValueError):
        kk.closed_form_buckets(mb, wms, blocked, *mrows, out=(fields2, touch2, rows_at, touch_at))
    assert len(recorded) == 1


def test_closed_form_bucket_layouts():
    """Buckets laid out as KT's grouping lays them (views of one array
    each for ba, bb and bvalid) launch in place, at their slot offsets;
    buckets in separate tensors raise (the kernel reads every bucket's
    slots from the first's arrays), but for a lone bucket."""
    scene = hard_cases.closed_form_scene("ragged")
    buckets = hard_cases.closed_form_inputs(scene, "cpu")[0]
    caps = [b[1].shape[0] for b in buckets]
    assert kk.slot_offsets(buckets) == tuple(np.cumsum([0] + caps)[:-1].tolist())
    spread = [(c, ba.clone(), bb.clone(), bv.clone()) for c, ba, bb, bv in buckets]
    with pytest.raises(ValueError):
        kk.slot_offsets(spread)
    assert kk.slot_offsets(spread[:1]) == (0,)
    groups = hard_cases.closed_form_inputs(hard_cases.closed_form_scene("grouped_mixed"),
                                           "cpu")[0]
    assert len(groups) > 1


@pytest.mark.parametrize("case", ["s1", "s33", "s1024", "l1"])
def test_audio_setup_plan_packs_and_checks(recorded, case):
    """One plan per (S, L, device); the packed launch's 18 input pointers,
    dop_alpha and dt_block as doubles, S, L, use_hrtf and the buffer; one
    buffer of (L + 9) S words; a bad argument raises before a launch."""
    scene = hard_cases.audio_setup_scene(case)
    args = [_meta(x) for x in hard_cases.audio_setup_inputs(scene, "cpu", True)]
    s, nl = scene.sources["delta"].shape
    buf = kaa.audio_setup(*args)
    assert tuple(buf.shape) == ((nl + kaa.SETUP_WORDS) * s,) and buf.dtype == torch.float32
    name, packed = recorded[-1]
    v = kaa._PACK.unpack(packed)
    assert name == "audio_setup" and len(packed) == 24 * 8
    assert v[18] == float(np.float32(kaa.dop_alpha(scene.block)))
    assert v[19] == float(np.float32(scene.block / kaa.ENGINE_RATE))
    assert v[20:23] == (s, nl, 1)
    kaa.audio_setup(*args[:20], False)
    assert kaa._PACK.unpack(recorded[-1][1])[22] == 0
    assert len(kaa._plans) == 1 and len(recorded) == 2
    bads = ((4, args[4][:, :2], ValueError), (0, args[0].float(), TypeError),
            (6, args[6][:-1], ValueError), (15, torch.empty(4, device="meta"), ValueError),
            (12, args[12].double(), TypeError))
    for k, bad, exc in bads:
        with pytest.raises(exc):
            kaa.audio_setup(*args[:k], bad, *args[k + 1:])
    assert len(recorded) == 2

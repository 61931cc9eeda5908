"""KM's twin (kernels/serving_io.py:apply_tick_in_plain) against the
JITTED reference, and the fetch's twin (kernels/audio_mix.py:
audio_fetch_plain, the first part of KF) against the reference's
``_fetch_all`` and layer mix, on kernels/hard_cases.py's tick-input and
fetch scenes; the scenes that feed KF's own cases through a fetch; and
both wrappers' CUDA branches driven on ``meta`` tensors.

The region wake's squared distance is ``jnp.sum((pos - centre) ** 2,
-1)``, which the reference only ever runs jitted (``_scatter_transforms_wake``
and the fused serving tick, substrata_tpu/physics/world.py:161, :288).
XLA contracts that sum into fma(d2, d2, fma(d1, d1, d0 d0)); the eager
call rounds each product apart.  On bodies within a few ulps of a
region's reach the two wake different bodies, so the twin is held to the
jitted reference, exactly, on every case, and the plain sum it used
before is shown to differ on the boundary scene.

The fetch is held as tests/test_torch_audio.py holds it: samples within
1e-5 (the reference interpolates by a one-hot and triangular contraction
at HIGHEST precision, the twin by the lerp itself), playheads within 1
ulp.  ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the kernels
to these twins, to the bit, on the same scenes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.audio import mix as jm
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics import world as jworld
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import audio_mix as kaudio
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import serving_io as km

from torch_port_helpers import FIELDS

torch.set_num_threads(2)


def _jit_apply(bodies, tin):
    """The reference's jitted transform writes and region wake."""
    b = jstate.BodyState(**{k: jnp.asarray(bodies[k]) for k in FIELDS})
    j = jnp.asarray(tin)
    out = jworld._scatter_transforms_wake(
        b, jax.lax.bitcast_convert_type(j[km.O_IDX:km.O_POS], jnp.int32),
        j[km.O_POS:km.O_ROT].reshape(-1, 3), j[km.O_ROT:km.O_LV].reshape(-1, 4),
        j[km.O_LV:km.O_AV].reshape(-1, 3), j[km.O_AV:km.O_VOK].reshape(-1, 3),
        j[km.O_VOK:km.O_CTR] > 0, j[km.O_CTR:km.O_RAD].reshape(-1, 3), j[km.O_RAD:])
    return {f: np.asarray(getattr(out, f)) for f in km.STATE_OUT}


def _plain_sum_wake(st, tin):
    """The region test as the twin computed it before: the plain sum of
    the three squares, each product rounded."""
    pos = km.apply_tick_in_plain(st, tin)[0]
    d = pos[:, None, :] - tin[km.O_CTR:km.O_RAD].reshape(km.TIN_R, 3)[None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    r = tin[km.O_RAD:][None] + st.bound_radius[:, None] + 0.3
    return torch.any(d2 <= r * r, dim=1) & st.alive & st.dynamic


def _words(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("case", hard_cases.TICK_IN_CASES)
def test_tick_in_cases_twin_matches_jitted_reference(case):
    """Every output of KM's twin equals the jitted reference's, word for
    word, on each hard tick-input case."""
    scene = hard_cases.tick_in_scene(case)
    st, tin = hard_cases.tick_in_inputs(scene, "cpu")
    got = km.apply_tick_in(st, tin)
    want = _jit_apply(scene.bodies, scene.tin)
    for f in km.STATE_OUT:
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(_words(g), _words(want[f]), err_msg=f"{case} {f}")
    # The cases are really there (woken by a region, not by a write).
    idx = scene.tin[km.O_IDX:km.O_POS].view(np.int32)
    written = np.zeros(st.capacity, bool)
    written[idx[(idx >= 0) & (idx < st.capacity)]] = True
    woke = got.awake.numpy() & ~scene.bodies["awake"] & ~written
    if case == "all_padded":
        assert np.array_equal(got.awake.numpy() | ~(scene.bodies["alive"]
                                                    & (scene.bodies["motion_type"] == 2)),
                              np.ones(st.capacity, bool))
    elif case == "nan_far":
        assert np.isnan(got.pos.numpy()).any() and not woke[1::7].any()
    elif case == "boundary":
        assert 0 < woke.sum() < st.capacity
    elif case == "slot_n":
        idx = scene.tin[km.O_IDX:km.O_POS].view(np.int32)
        assert (idx[:4] >= st.capacity).sum() == 2 and (idx[:4] < 0).sum() == 2


@pytest.mark.parametrize("padded", [False, True])
def test_region_test_rounds_as_jitted_reference(padded):
    """The boundary scene (2,048 sleeping bodies a few ulps in and out of
    8 regions' reach), with and without a padded region: the twin's wake
    equals the jitted reference's; without padding the plain sum of
    squares, the twin's region test before, wakes other bodies (a padded
    region wakes every dynamic body under either rounding)."""
    scene = hard_cases.tick_in_scene("boundary")
    if padded:
        scene.tin[km.O_RAD + km.TIN_R - 1] = np.float32(-1e9)
    st, tin = hard_cases.tick_in_inputs(scene, "cpu")
    want = _jit_apply(scene.bodies, scene.tin)
    got = km.apply_tick_in(st, tin)
    np.testing.assert_array_equal(got.awake.numpy(), want["awake"])
    np.testing.assert_array_equal(_words(got.sleep_timer.numpy()), _words(want["sleep_timer"]))
    idx = scene.tin[km.O_IDX:km.O_POS].view(np.int32)
    untouched = np.ones(st.capacity, bool)
    untouched[idx[(idx >= 0) & (idx < st.capacity)]] = False
    plain = _plain_sum_wake(st, tin).numpy()
    differs = int((plain != want["awake"])[untouched].sum())
    if padded:
        assert differs == 0 and want["awake"].all()
    else:
        assert differs > 0, "the boundary scene no longer tells the roundings apart"


def test_serving_tick_region_test_matches_fused_program():
    """The fused serving tick (``_serving_tick``, jitted as one program
    with the player and the step) wakes, on a boundary scene of 480
    sleeping spheres about 8 regions, exactly the bodies the twin's
    region test wakes; the plain sum would wake others.  The step keeps a
    woken body awake (its timer restarts at 0), and the spheres stand
    apart in the air, so nothing else wakes or sleeps in the tick."""
    cfg = jstate.SimConfig(capacity=512, max_pairs=1024, grid_dim=32, cell_size=1.4,
                           cell_capacity=6, solver_iters=7, pairs_per_body=10,
                           pair_rebuild_interval=6, contacts_per_body=8)
    w = jworld.PhysicsWorld(cfg)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(3)
    centres = np.array([[x, y, 20.0] for x in (-12.0, 12.0) for y in (-12.0, 0.0, 12.0, 24.0)],
                       np.float32)
    radii = rng.uniform(1.0, 1.5, 8).astype(np.float32)
    shape = jshapes.make_sphere(0.05)
    br = np.float32(shape.bound_radius)
    obs = []
    for j in range(8):
        reach = np.full(60, (radii[j] + br) + np.float32(0.3), np.float32)
        # 60 points spread over the sphere (a Fibonacci lattice), each
        # coordinate moved a few ulps; for the first 30 the move is one
        # where the plain sum of squares and the fma chain part ways.
        k = np.arange(60) + 0.5
        phi = np.arccos(1 - 2 * k / 60)
        th = np.pi * (1 + 5 ** 0.5) * k
        d = np.stack([np.cos(th) * np.sin(phi), np.sin(th) * np.sin(phi), np.cos(phi)], 1)
        p = (centres[j] + d * reach[:, None]).astype(np.float32)
        for m in range(60):
            for _ in range(400):
                q = p[m].copy()
                for _ in range(3):
                    step = rng.integers(-1, 2, size=3)
                    q = np.where(step > 0, np.nextafter(q, np.float32(np.inf)),
                                 np.where(step < 0, np.nextafter(q, np.float32(-np.inf)), q))
                e = (q - centres[j]).astype(np.float32)
                plain = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
                fused = np.float32(np.float64(e[2]) * e[2] + np.float32(
                    np.float64(e[1]) * e[1] + np.float32(e[0] * e[0])))
                if m >= 30 or (plain <= reach[m] * reach[m]) != (fused <= reach[m] * reach[m]):
                    break
            p[m] = q
        for q in p.astype(np.float32):
            obs.append(w.add_object(jworld.PhysicsObject(shape=shape, pos=q, motion_type=2)))
    player = jchar.PlayerPhysics(w, eye_pos=(0.0, -40.0, 1.67))
    seen = {}
    real = jworld._serving_tick

    def fused(body, *rest):
        tin = np.array(rest[7])
        tin[km.O_CTR:km.O_CTR + 24] = centres.reshape(-1)
        tin[km.O_RAD:km.O_RAD + 8] = radii
        tin[km.O_CTR + 24:km.O_RAD] = 900.0
        tin[km.O_RAD + 8:] = 0.5
        slots = np.array([o.slot for o in obs])
        asleep = np.zeros(body.awake.shape, bool)
        keep = np.ones(body.awake.shape, bool)
        keep[slots] = False
        body = body.replace(awake=jnp.asarray(np.asarray(body.awake) & keep | asleep),
                            sleep_timer=jnp.asarray(np.where(keep, np.asarray(body.sleep_timer),
                                                             np.float32(0.25))))
        seen["body"] = {k: np.array(np.asarray(getattr(body, k))) for k in FIELDS}
        seen["tin"] = tin
        out = real(body, *rest[:7], jnp.asarray(tin), *rest[8:])
        seen["awake"] = np.array(np.asarray(out[0].awake))
        return out
    jworld._serving_tick = fused
    try:
        w.think_with_player(1 / 60, player, cur_time=0.0)
    finally:
        jworld._serving_tick = real
    slots = np.array([o.slot for o in obs])
    st = convert.body_state_from_numpy(seen["body"], device="cpu")
    tin = torch.as_tensor(seen["tin"])
    twin = km.apply_tick_in_plain(st, tin)[4].numpy()
    np.testing.assert_array_equal(twin[slots], seen["awake"][slots])
    assert 0 < twin[slots].sum() < len(slots)
    plain = _plain_sum_wake(st, tin).numpy()
    assert (plain[slots] != seen["awake"][slots]).any()


def _ref_fetch(scene):
    """The reference's ``_fetch_all`` and layer mix (mix.py:310-316),
    jitted, on the scene's fetch."""
    f = scene.fetch
    s, nl = f["playhead"].shape
    zero = jm.zero_sources(s)
    src = zero.replace(**{k: jnp.asarray(f[k]) for k in ("buf_offset", "buf_len", "playhead",
                                                          "mix_factor", "looping",
                                                          "stream_mode", "stream_write_head")})
    if nl != zero.playhead.shape[1]:
        src = src.replace(delta=jnp.ones((s, nl), jnp.float32))

    def ref(src, pool, eff_delta, act):
        raw, heads = jm._fetch_all(pool, src, eff_delta, scene.block)
        layer_gain = src.mix_factor * (src.buf_len > 0)
        samples = jnp.einsum("slb,sl->sb", raw, layer_gain,
                             precision=jax.lax.Precision.HIGHEST)
        return samples * act[:, None], heads
    js, jh = jax.jit(ref)(src, jnp.asarray(f["pool"]), jnp.asarray(f["eff_delta"]),
                          jnp.asarray(f["active"]))
    return np.asarray(js), np.asarray(jh)


@pytest.mark.parametrize("case", hard_cases.FETCH_CASES)
def test_fetch_cases_twin_matches_reference(case):
    """The fetch's twin on each hard fetch case within 1e-5 of the
    reference's samples, its playheads within 1 ulp; and KF's CPU call is
    the twins chained (its new playheads the fetch's)."""
    scene = hard_cases.fetch_scene(case)
    args = hard_cases.fetch_inputs(scene, "cpu")
    ts, th = kaudio.audio_fetch_plain(*args[0])
    js, jh = _ref_fetch(scene)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-5, err_msg=case)
    np.testing.assert_array_max_ulp(th.numpy(), jh, maxulp=1)
    out = kaudio.audio_spatialise(*args)
    assert len(out) == 8 and torch.equal(out[7], th)
    if case == "inactive":
        assert not js.any()
    elif case == "len0_layer":
        assert (scene.fetch["buf_len"][:, 1] == 0).all()
    elif case == "stream_head_in_block":
        silent = (js == 0).sum(axis=1)
        assert ((silent > 0) & (silent < scene.block)).any()
    else:
        assert np.abs(js).max() > 0.05


@pytest.mark.parametrize("case", [("spatialise", c) for c in hard_cases.SPATIALISE_CASES]
                         + [("epilogue", c) for c in hard_cases.EPILOGUE_CASES],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_fed_scenes_keep_their_cases(case):
    """KF's own scenes fed through a fetch: the fetch plays each active,
    non-looping, non-streaming source's samples back exactly where its
    frames are in range (integer heads), and the epilogue scenes' new
    layer-0 heads are the cases' to the bit where they decide the finish
    (every source able to finish: not looping, not streaming, active)."""
    kind, name = case
    if kind == "spatialise":
        sc = hard_cases.spatialise_scene(name)
        fed = hard_cases.spatialise_fed(name)
        samples, ep = sc.arrays["samples"], sc.epilogue
    else:
        sc = hard_cases.epilogue_scene(name)
        fed = hard_cases.epilogue_fed(name)
        samples, ep = sc.spatialise["samples"], sc.epilogue
    args = hard_cases.fetch_inputs(fed, "cpu")
    got, heads = kaudio.audio_fetch_plain(*args[0])
    got, heads = got.numpy(), heads.numpy()
    b = samples.shape[1]
    plain = ep["active"] & ~ep["looping"] & ~ep["stream_mode"]
    if kind == "spatialise":
        h = np.floor(ep["new_heads"][:, 0])
        frames = (h - b)[:, None] + np.arange(b)[None] < ep["buf_len"][:, :1] - 1.0
        keep = plain[:, None] & frames & (h >= b)[:, None]
        assert keep.sum() > samples.size // 3
        np.testing.assert_array_equal(got[keep], samples[keep])
    else:
        able = plain & (ep["new_heads"][:, 0] >= b)
        np.testing.assert_array_equal(_words(heads[able, 0]), _words(ep["new_heads"][able, 0]))
    for k in ("looping", "stream_mode", "active"):
        assert np.array_equal(fed.fetch[k], ep[k])


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, tuple):
        return tuple(_meta(y) for y in x)
    if dataclasses.is_dataclass(x):
        return x.replace(**{f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(km, "_tick_plans", {})
    monkeypatch.setattr(kaudio, "_spatialise_plans", {})
    return calls


@pytest.mark.parametrize("case", ["n1", "n257", "writes_128"])
def test_tick_in_launch_args_and_checks(recorded, case):
    """KM's CUDA branch: one packed launch of the nine state fields, the
    tick input, one output buffer and N; the six outputs views of that
    buffer in its order; the plan made once per (N, device); a bad input
    raises before a launch."""
    st, tin = _meta(hard_cases.tick_in_inputs(hard_cases.tick_in_scene(case), "cpu"))
    n = st.capacity
    out = km.apply_tick_in(st, tin)
    out2 = km.apply_tick_in(st, tin)
    assert len(recorded) == 2 and len(km._tick_plans) == 1
    name, packed = recorded[0]
    v = km._TICK_PACK.unpack(packed)
    assert name == "apply_tick_in" and v[11] == n
    assert list(v[:10]) == [getattr(st, f).data_ptr() for f in km.STATE_IN] + [tin.data_ptr()]
    base = out.pos.untyped_storage()._cdata
    assert all(getattr(out, f).untyped_storage()._cdata == base for f in km.STATE_OUT)
    assert out2.pos.untyped_storage()._cdata != base
    shapes = [tuple(getattr(out, f).shape) for f in km.STATE_OUT]
    assert shapes == [(n, 3), (n, 4), (n, 3), (n, 3), (n,), (n,)]
    assert out.awake.dtype == torch.bool and out.sleep_timer.dtype == torch.float32
    assert out.quat.storage_offset() == 3 * n and out.sleep_timer.storage_offset() == 13 * n
    for bad, exc in ((st.replace(pos=st.pos.double()), TypeError),
                     (st.replace(awake=st.awake[:-1] if n > 1 else st.awake.int()),
                      (TypeError, ValueError)),
                     (st.replace(quat=torch.empty((n, 3), device="meta")), ValueError)):
        with pytest.raises(exc):
            km.apply_tick_in(bad, tin)
    with pytest.raises(ValueError):
        km.apply_tick_in(st, tin[:-1])
    assert len(recorded) == 2


@pytest.mark.parametrize("case", ["l1", "b16", "s33", "b1024"])
def test_fetch_spatialise_launch_args_and_checks(recorded, case):
    """KF with its fetch: one packed launch whose pointers are the fetch's
    ten tensors, KF's, the epilogue's four and the eight outputs (views of
    one buffer, the new playheads [S, L] last), then S, B, T, L, nw, the
    pool's rows, the HRTF flag and li_max; a bad
    argument raises before a launch."""
    scene = hard_cases.fetch_scene(case)
    args = _meta(hard_cases.fetch_inputs(scene, "cpu"))
    fetch = args[0]
    s, nl = scene.fetch["playhead"].shape
    b = scene.block
    out = kaudio.audio_spatialise(*args)
    assert len(out) == 8 and len(recorded) == 1
    name, packed = recorded[0]
    v = kaudio._SPATIALISE_PACK.unpack(packed)
    assert name == "audio_spatialise"
    assert list(v[:10]) == [t.data_ptr() for t in fetch[:10]]
    assert list(v[24:28]) == [t.data_ptr() for t in args[-1]]
    assert list(v[28:36]) == [t.data_ptr() for t in out]
    assert v[36:43] == (s, b, 64, nl, fetch[11], hard_cases.FETCH_POOL // 128, 1)
    assert v[43] == kaudio._li_max(fetch[11])
    assert tuple(out[7].shape) == (s, nl) and tuple(out[0].shape) == (s, b)
    assert len({t.untyped_storage()._cdata for t in out}) == 1
    bads = []
    for k, bad in ((0, fetch[0][:-64]), (1, fetch[1].float()), (3, fetch[3][:-1]),
                   (9, fetch[9].float())):
        f = list(fetch)
        f[k] = bad
        bads.append(((tuple(f),) + args[1:], (TypeError, ValueError)))
    f = list(fetch)
    f[10] = b + 16
    bads.append(((tuple(f),) + args[1:], ValueError))
    bads.append((args[:-1] + (args[-1][:3],), ValueError))
    bads.append((args[:-1] + ((args[-1][0].int(),) + args[-1][1:],), TypeError))
    for a, exc in bads:
        with pytest.raises(exc):
            kaudio.audio_spatialise(*a)
    assert len(recorded) == 1

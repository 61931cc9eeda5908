"""KN's twin (kernels/serving_io.py:digest_tblock_plain) against the
reference's ``_digest_core`` and ``_tblock_core`` on kernels/hard_cases.py's
digest scenes, and KF's twin (kernels/audio_mix.py:audio_spatialise_plain)
against the reference's low-pass and HRIR stage of ``mix_block`` on its
spatialise scenes; and both wrappers' CUDA branches (KN's plan per shape
and packed launch, KF's checks and launch arguments) driven on ``meta``
tensors.

The digest scenes: no entry set; every class exactly full (64 slots, 128
touching pairs); one over (the overflow that sends the host to the bit
words); every entry set; entries only at word and tile edges; N and P not
multiples of 32; 65,536 pair slots.  The digest head equals the
reference's, the bit words unpack to the masks, the transform block equals
the reference's, all exactly.

The spatialise scenes: 1, 255, 256, 800 and 1,024 frames, one tap, alpha
1 and 1e-4, no send, no HRTF, with the low-pass and the pan path mixed
among the sources.  The reference's stage (substrata_tpu/audio/mix.py
:361-403: the low-pass as its associative scan over affine maps, the
HRIR FIR as its einsum over windows, the ramps; the per-source operands
of its sums, the send and the level), transcribed here line for line
because mix_block returns only their sums, runs jitted on the same
inputs (tests/test_torch_audio.py holds the port's whole mix_block
against the reference's own, so a drift in mix.py shows there); the
twin's frame-by-frame recurrence and tap-by-tap fmas round differently,
so every output is held within 1e-5, tests/test_torch_audio.py's
tolerance for the mix's gains and for one block's signals (its 5e-5 covers
playheads drifting over ten chained blocks, which no scene here has).
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the kernels to
these twins, to the bit, on the same scenes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.physics import world as jworld
from substrata_tpu_torch.kernels import audio_mix as kaudio
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import serving_io as km

from torch_port_helpers import jax_body

torch.set_num_threads(2)

EV_FIELDS = ("contact_pair_a", "contact_pair_b", "contact_touching", "newly_awake",
             "newly_asleep", "entered_water", "num_pairs", "broadphase_overflow")


@pytest.mark.parametrize("case", hard_cases.DIGEST_CASES)
def test_digest_scene_twin_matches_reference(case):
    scene = hard_cases.digest_scene(case)
    ev, nc, na, sl, st = hard_cases.digest_inputs(scene, "cpu")
    dig, blk = km.digest_tblock(ev, nc, na, sl, st)
    out = torch.full((km.digest_len(st.capacity),), 7, dtype=torch.int32)
    dig_only, none = km.digest_tblock(ev, nc, na, sl, st, out=out, with_block=False)
    assert none is None and dig_only is out and torch.equal(out, dig)
    jev = type("E", (), {k: jnp.asarray(scene.events[k]) for k in EV_FIELDS})
    ref = np.asarray(jworld._digest_core(jev, *(jnp.int32(v) for v in scene.scalars)))
    dig = dig.numpy()
    np.testing.assert_array_equal(dig[:km.DIGEST_HEAD], ref)
    n = st.capacity
    words = (n + 31) // 32
    assert dig.shape == (km.DIGEST_HEAD + 3 * words,)
    masks = dig[km.DIGEST_HEAD:]
    for i, f in enumerate(("newly_awake", "newly_asleep", "entered_water")):
        np.testing.assert_array_equal(km.unpack_bits(masks[i * words:(i + 1) * words], n),
                                      scene.events[f])
    np.testing.assert_array_equal(blk.numpy(),
                                  np.asarray(jworld._tblock_core(jax_body(scene.bodies))))
    counts = [int(scene.events[f].sum()) for f in ("newly_awake", "newly_asleep",
                                                   "entered_water", "contact_touching")]
    assert list(dig[192:196]) == counts
    if case == "one_over":
        assert counts == [65, 65, 65, 129]
    if case == "edges":
        assert list(dig[:7]) == [31, 32, 255, 256, 1023, 1024, n - 1]


def _ref_stage(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank, dir_idx, prev_gl,
               prev_gr, gl, gr, ramp, gain, send_gain, use_hrtf):
    """A transcription of substrata_tpu/audio/mix.py:361-403, line for
    line, on given inputs: its low-pass scan, its HRIR windows and einsums,
    its ramps; returns the per-source operands of its sums (wl, wr, ws),
    the low-pass memory, the history and the level, as the twin does.
    tests/test_torch_audio.py is the test against the real mix_block."""
    block = samples.shape[1]
    a_el = jnp.broadcast_to((1.0 - alpha)[:, None], samples.shape)
    b_el = alpha[:, None] * samples

    def compose(lhs, rhs):
        return lhs[0] * rhs[0], rhs[1] + rhs[0] * lhs[1]

    cum_a, cum_b = jax.lax.associative_scan((lambda l, r: compose(l, r)), (a_el, b_el), axis=1)
    filtered = cum_a * lp_state[:, None] + cum_b
    lp_out = filtered[:, -1]
    samples = jnp.where(use_lp[:, None], filtered, samples)
    if use_hrtf:
        t = bank.shape[-1]
        h = bank.reshape(-1, 2, t)[dir_idx]
        x_ext = jnp.concatenate([hrir_hist, samples], axis=1)
        windows = jnp.stack([x_ext[:, t - 1 - k: t - 1 - k + block] for k in range(t)], axis=2)
        conv_l = jnp.einsum("sbt,st->sb", windows, h[:, 0])
        conv_r = jnp.einsum("sbt,st->sb", windows, h[:, 1])
        sig_l = jnp.where(spatial[:, None], conv_l, samples)
        sig_r = jnp.where(spatial[:, None], conv_r, samples)
        new_hist = x_ext[:, block:]
    else:
        sig_l = sig_r = samples
        new_hist = hrir_hist
    gl_t = prev_gl[:, None] + (gl[:, None] - prev_gl[:, None]) * ramp[None, :]
    gr_t = prev_gr[:, None] + (gr[:, None] - prev_gr[:, None]) * ramp[None, :]
    ws = None if send_gain is None else samples * send_gain[:, None]
    level = jnp.max(jnp.abs(samples), axis=1) * gain
    return gl_t * sig_l, gr_t * sig_r, ws, lp_out, new_hist, level


_jref_stage = jax.jit(_ref_stage, static_argnames=("use_hrtf",))


@pytest.mark.parametrize("case", hard_cases.SPATIALISE_CASES)
def test_spatialise_scene_twin_matches_reference(case):
    scene = hard_cases.spatialise_scene(case)
    args = hard_cases.spatialise_inputs(scene, "cpu")
    got = kaudio.audio_spatialise_plain(*args)
    jargs = [None if a is None else jnp.asarray(a.numpy()) for a in args[:-2]]
    want = _jref_stage(*jargs, use_hrtf=scene.use_hrtf)
    names = ("wl", "wr", "ws", "lp_out", "new_hist", "level")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None and case == "no_send"
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=f"{case} {name}")
    a = scene.arrays
    # The cases are really there: filtered and unfiltered, spatial and panned.
    assert a["use_lp"].any() and not a["use_lp"].all()
    assert a["spatial"].any() and not a["spatial"].all()
    if case == "alpha_one":
        lp = a["use_lp"]
        np.testing.assert_array_equal(got[3].numpy()[lp], a["samples"][lp, -1])


# --- KN's and KF's CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if x is None or isinstance(x, (bool, int)):
        return x
    if isinstance(x, tuple):
        return tuple(_meta(y) for y in x)
    return x.replace(**{f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)})


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(km, "_digest_plans", {})
    monkeypatch.setattr(kaudio, "_spatialise_plans", {})
    return calls


def test_plan_cache_keeps_the_newest():
    """``build.plan``: made once per key, the oldest dropped past the cap."""
    cache, made = {}, []

    def make(k):
        made.append(k)
        return [k]

    first = build.plan(cache, 0, lambda: make(0))
    assert build.plan(cache, 0, lambda: make(-1)) is first and made == [0]
    for k in range(1, build.MAX_PLANS + 1):
        build.plan(cache, k, lambda k=k: make(k))
    assert len(cache) == build.MAX_PLANS and 0 not in cache
    assert list(cache) == list(range(1, build.MAX_PLANS + 1))
@pytest.mark.parametrize("case", ["ragged_n", "p65536"])
def test_digest_plan_packs_and_checks(recorded, case):
    """One plan per (N, P): the packed sizes, a scratch of [ticket | 4
    counts a tile | the touching words] made once, the outputs' shapes;
    with ``out`` the digest goes there; a bad argument raises."""
    ev, nc, na, sl, st = (_meta(x) for x in hard_cases.digest_inputs(
        hard_cases.digest_scene(case), "cpu"))
    n, p = st.capacity, ev.contact_touching.shape[0]
    dig, blk = km.digest_tblock(ev, nc, na, sl, st)
    assert tuple(dig.shape) == (km.digest_len(n),) and dig.dtype == torch.int32
    assert tuple(blk.shape) == (n, 14) and blk.dtype == torch.float32
    name, packed = recorded[-1]
    v = km._DIGEST_PACK.unpack(packed)
    assert name == "digest_tblock" and len(packed) == 21 * 8 and v[19:] == (n, p)
    plan = next(iter(km._digest_plans.values()))
    tiles = -(-max(n, p) // km.DIGEST_TILE)
    assert plan.tiles == tiles and plan.scratch.shape == (1 + 4 * tiles + -(-p // 32),)
    out = torch.empty(km.digest_len(n), dtype=torch.int32, device="meta")
    got, none = km.digest_tblock(ev, nc, na, sl, st, out=out, with_block=False)
    assert got is out and none is None and km._DIGEST_PACK.unpack(recorded[-1][1])[17] == 0
    assert len(km._digest_plans) == 1 and len(recorded) == 2
    bads = ((ev.replace(newly_awake=ev.newly_awake[:-1]), st, None, ValueError),
            (ev.replace(contact_pair_a=ev.contact_pair_a.long()), st, None, TypeError),
            (ev, st.replace(pos=st.pos.double()), None, TypeError),
            (ev, st.replace(quat=torch.empty((n, 8), device="meta")[:, :4]), None, ValueError),
            (ev, st, out[:-1], ValueError))
    for e, s, o, exc in bads:
        with pytest.raises(exc):
            km.digest_tblock(e, nc, na, sl, s, out=o)
    assert len(recorded) == 2


@pytest.mark.parametrize("case", ["b255", "t1", "no_send", "no_hrtf"])
def test_spatialise_launch_args_and_checks(recorded, case):
    """KF's CUDA branch on the scene fed through a fetch
    (``hard_cases.spatialise_fed``): the launch's sizes and pointers (0
    for what the call has not), the outputs' shapes, and a bad argument
    raises before a launch."""
    scene = hard_cases.spatialise_scene(case)
    args = _meta(hard_cases.fetch_inputs(hard_cases.spatialise_fed(case), "cpu"))
    s, b = scene.arrays["samples"].shape
    t = scene.arrays["hrir_hist"].shape[1] + 1
    wl, wr, ws, lp_out, new_hist, level, ep, heads = kaudio.audio_spatialise(*args)
    name, packed = recorded[-1]
    v = kaudio._SPATIALISE_PACK.unpack(packed)
    assert name == "audio_spatialise" and len(v) == 44
    assert v[36:39] == (s, b, t) and v[42] == int(scene.use_hrtf)
    assert [tuple(x.shape) for x in (wl, wr, lp_out, new_hist, level, ep)] == [
        (s, b), (s, b), (s,), (s, t - 1), (s,), (2 * s,)]
    assert v[28] == wl.data_ptr() and v[29] == wr.data_ptr() and v[31] == lp_out.data_ptr()
    assert v[33] == level.data_ptr()
    if scene.use_hrtf:
        assert v[15] == args[6].data_ptr() and v[16] == args[7].data_ptr()
    else:
        assert v[15] == 0 and v[16] == 0
    if case == "no_send":
        assert ws is None and v[23] == 0 and v[30] == 0
    else:
        assert tuple(ws.shape) == (s, b) and v[30] == ws.data_ptr()
    for k, bad, exc in ((1, args[1].double(), TypeError), (2, args[2][:-1], ValueError),
                        (3, torch.empty(s, device="meta"), TypeError),
                        (13, torch.empty(b + 1, device="meta"), ValueError),
                        (5, torch.empty((s, t), device="meta"), ValueError)):
        a = list(args)
        a[k] = bad
        with pytest.raises(exc):
            kaudio.audio_spatialise(*a)
    if scene.use_hrtf:
        a = list(args)
        a[6] = torch.empty((2, 2, 2, t + 1), device="meta")
        with pytest.raises(ValueError):
            kaudio.audio_spatialise(*a)
    big = list(args)
    big[0] = args[0][:10] + (kaudio.MAX_BLOCK + 16, args[0][11])
    big[12] = torch.empty(kaudio.MAX_BLOCK + 16, device="meta")
    with pytest.raises(ValueError):
        kaudio.audio_spatialise(*big)
    assert len(recorded) == 1
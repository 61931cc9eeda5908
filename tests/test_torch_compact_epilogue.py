"""KT's contact compaction and KF's folded epilogue (the mix's finished
flags, level meter and alive mask): their plain twins against the
reference on ``kernels/hard_cases.py``'s ``COMPACT_CASES`` and
``EPILOGUE_CASES``, ``mix_block`` over blocks in which sources finish and
are removed, and both wrappers' CUDA branches driven on ``meta`` tensors,
which reach them without a card, with the launch recorded instead of
made.

Tolerances:
- The compaction: every output field exact, bit for bit (floats compared
  as their words, so -0.0 and NaN payloads count), and the overflow,
  against the jitted ``narrowphase.compact_contacts``: the twin moves
  rows and tests signs, as the reference's scatter does.
- The epilogue: finished and alive exact; the smoothed level bit for bit
  where it is a number and NaN where the reference's is, against the
  reference's expressions (mix.py:316-319, :433-444) jitted as
  ``tests/test_torch_audio.py`` builds them, on the level KF's twin
  computes from the scene.
- ``mix_block``: finished and alive exact every block; the output and
  the smoothed level within 5e-5 (the signal tolerance of
  ``tests/test_torch_audio.py``'s chained blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.audio import mix as jm
from substrata_tpu.physics import narrowphase as jn
from substrata_tpu_torch import convert
from substrata_tpu_torch.audio import mix as tm
from substrata_tpu_torch.kernels import audio_mix as kaudio
from substrata_tpu_torch.kernels import build, hard_cases, layout

torch.set_num_threads(2)

_compact = jax.jit(jn.compact_contacts, static_argnames=("max_active",))


def _words(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


# --- KT's compaction twin against the reference.

@pytest.mark.parametrize("case", hard_cases.COMPACT_CASES)
def test_compact_cases_twin_matches_reference(case):
    scene = hard_cases.compact_scene(case)
    rows, m = hard_cases.compact_inputs(scene, "cpu")
    jrows = jn.Contacts(**{k: jnp.asarray(v) for k, v in scene.rows.items()})
    want, jov = _compact(jrows, max_active=m)
    got, tov = layout.compact(rows, m)
    for name, x in zip(hard_cases.COMPACT_FIELDS, got):
        np.testing.assert_array_equal(_words(x.numpy()), _words(getattr(want, name)),
                                      err_msg=name)
    assert int(tov) == int(jov)
    n_touch, n_valid = scene.counts
    assert int(tov) == max(n_touch - m, 0)
    assert int(got[5].sum()) <= min(n_valid, m)
    if case == "pen_edges":
        # Only the smallest normal and 1e-3 touch; NaN and -0.0 rows land
        # among the speculative ones with their words.
        assert n_touch == 2 * (scene.rows["a"].shape[0] // 8)
        assert np.isnan(got[4].numpy()).any() and np.signbit(got[4].numpy()).any()
    if case == "a_minus_1":
        assert int(((scene.rows["a"] < 0) & scene.rows["valid"]).sum()) > 0
        assert int(got[5].sum()) < n_valid


# --- KF's folded epilogue: its twin against the reference.

@jax.jit
def _jepilogue(finished, looping, stream_mode, active, new_heads, buf_len, smoothed, alive,
               remove, level):
    """The reference's finished flags, level meter and alive mask, written
    as ``tests/test_torch_audio.py:_jepilogue`` writes them (the level's
    product first, so XLA fuses it as mix_block's program does)."""
    fin = finished | ((~looping) & (~stream_mode) & active
                      & (new_heads[:, 0] >= buf_len[:, 0].astype(jnp.float32) - 1.0))
    return fin, level * 0.1 + smoothed * 0.9, alive & ~(fin & remove)


@pytest.mark.parametrize("case", hard_cases.EPILOGUE_CASES)
def test_epilogue_cases_twin_matches_reference(case):
    # KF takes the case through a fetch whose new layer-0 heads are the
    # case's (hard_cases.epilogue_fed); its CPU call is the twins chained.
    scene = hard_cases.epilogue_scene(case)
    fed = hard_cases.epilogue_fed(case)
    args = hard_cases.fetch_inputs(fed, "cpu")
    out = kaudio.audio_spatialise(*args)
    assert len(out) == 8
    samples, heads = kaudio.audio_fetch_plain(*args[0])
    f = args[0]
    epi = (args[-1][0], f[6], f[7], f[9], heads, f[2]) + args[-1][1:]
    plain = kaudio.audio_spatialise_plain(samples, *args[1:-1], epi)
    for x, y in zip(out[:6], plain[:6]):
        assert (x is None and y is None) or np.array_equal(_words(x.numpy()), _words(y.numpy()))
    assert torch.equal(out[7], heads)
    level = plain[5]
    got = kaudio.epilogue_views(out[6], level.shape[0])
    e = dict(scene.epilogue, new_heads=heads.numpy())
    fin, smooth, alive = _jepilogue(*(jnp.asarray(e[k]) for k in hard_cases.EPILOGUE_FIELDS),
                                    jnp.asarray(level.numpy()))
    np.testing.assert_array_equal(got["finished"].numpy(), np.asarray(fin))
    np.testing.assert_array_equal(got["alive"].numpy(), np.asarray(alive))
    ts, js = got["smoothed_level"].numpy(), np.asarray(smooth)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    num = ~np.isnan(js)
    np.testing.assert_array_equal(_words(ts[num]), _words(js[num]))
    fin = np.asarray(fin)
    if case == "head_at_end":
        half = np.arange(fin.shape[0]) % 2 == 0
        assert fin[half].all() and not fin[~half].any()
    elif case in ("looping", "stream_mode", "inactive"):
        assert not fin.any()
    elif case == "remove_on_finish":
        assert fin.any() and (~fin).any() and (fin & ~np.asarray(alive)).any()
        assert (fin & np.asarray(alive)).any()
    elif case == "nan_level":
        assert np.isnan(js).sum() == (np.arange(js.shape[0]) % 4 == 1).sum()


# --- mix_block over blocks in which sources finish and are removed.

N_SRC = 24
POOL = 1 << 16


def _finishing_sources():
    """24 sources: 12 one-shots whose heads reach their ends in blocks 1-6
    of 256 frames (every other removed on finish), 4 looping, 4 streaming,
    2 paused, 2 already finished; 3 layers on the last 4 one-shots."""
    rng = np.random.default_rng(7)
    a = {k: np.array(np.asarray(v)) for k, v in vars(jm.zero_sources(N_SRC)).items()}
    a["alive"][:] = True
    a["buf_offset"][:, 0] = rng.integers(0, POOL - 9000, N_SRC)
    a["buf_len"][:, 0] = rng.integers(3000, 8000, N_SRC)
    a["delta"][:] = 1.0
    ends = a["buf_len"][:12, 0] - (np.arange(12) // 2 + 1) * 256 + 100
    a["playhead"][:12, 0] = ends
    a["remove_on_finish"][:12] = np.arange(12) % 2 == 0
    for j in (1, 2):
        a["buf_offset"][8:12, j] = rng.integers(0, POOL - 9000, 4)
        a["buf_len"][8:12, j] = rng.integers(3000, 8000, 4)
    a["mix_factor"][8:12] = rng.uniform(0.2, 1.0, (4, 3))
    a["looping"][12:16] = True
    a["remove_on_finish"][12:24] = True
    a["stream_mode"][16:20] = True
    a["stream_write_head"][16:20] = a["playhead"][16:20, 0] + 3000
    a["paused"][20:22] = True
    a["finished"][22:24] = True
    a["pos"][:] = rng.uniform(-10, 10, (N_SRC, 3))
    a["volume"][:] = rng.uniform(0.5, 1.0, N_SRC)
    a["smoothed_level"][:] = rng.uniform(0, 0.5, N_SRC)
    return {k: np.ascontiguousarray(v.astype(np.asarray(getattr(jm.zero_sources(1), k)).dtype))
            for k, v in a.items()}


def test_mix_block_sources_finish_and_go_as_reference():
    a = _finishing_sources()
    i = np.arange(POOL)
    pool = (0.5 * np.sin(i * 0.021) + 0.2 * np.sin(i * 0.0043)).astype(np.float32)
    lis = dict(pos=np.zeros(3, np.float32), right=np.array([1, 0, 0], np.float32),
               forward=np.array([0, 1, 0], np.float32), up=np.array([0, 0, 1], np.float32),
               vel=np.zeros(3, np.float32), master_volume=np.float32(0.9))
    jsrc = jm.SourceState(**{k: jnp.asarray(v) for k, v in a.items()})
    tsrc = convert.sources_from_numpy(a, device="cpu")
    jl = jm.Listener(**{k: jnp.asarray(v) for k, v in lis.items()})
    tl = convert.listener_from_numpy(lis, device="cpu")
    jpool, tpool = jnp.asarray(pool), torch.as_tensor(pool)
    finished_at = {}
    for blk in range(7):
        jsrc, jo = jm.mix_block(jsrc, jpool, jl, block=256)
        tsrc, to = tm.mix_block(tsrc, tpool, tl, block=256)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=5e-5,
                                   err_msg=f"block {blk}")
        tn = convert.to_numpy(tsrc)
        for k in ("finished", "alive"):
            assert np.array_equal(tn[k], np.asarray(getattr(jsrc, k))), (k, blk)
        np.testing.assert_allclose(tn["smoothed_level"], np.asarray(jsrc.smoothed_level),
                                   rtol=0, atol=5e-5, err_msg=f"block {blk}")
        for s in np.nonzero(tn["finished"][:12])[0]:
            finished_at.setdefault(int(s), blk)
    # Every one-shot finished, over several blocks; the removed ones died.
    assert sorted(finished_at) == list(range(12)) and len(set(finished_at.values())) >= 5
    assert not tn["alive"][:12:2].any() and tn["alive"][1:12:2].all()
    assert tn["alive"][12:20].all() and not tn["finished"][12:20].any()


# --- The CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, tuple):
        return tuple(_meta(y) for y in x)
    return x


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(layout, "_compact_plans", {})
    monkeypatch.setattr(kaudio, "_spatialise_plans", {})
    return calls


@pytest.mark.parametrize("case", ["c1", "c257", "m_past_c", "capacity"])
def test_compact_plan_packs_and_checks(recorded, case):
    """One plan per (C, max_active, device, stream) with one 64-bit count
    a possible block; one packed launch a call (the 9 fields, the plan's
    scratch, the output buffer, C, max_active); the
    outputs are views of one fresh allocation; a bad field raises before
    a launch."""
    scene = hard_cases.compact_scene(case)
    rows, m = hard_cases.compact_inputs(scene, "cpu")
    rows = _meta(rows)
    c = rows[0].shape[0]
    before = layout.launches["layout_compact"]
    out, ov = layout.compact(rows, m)
    assert layout.launches["layout_compact"] == before + 1
    name, packed = recorded[-1]
    v = layout._COMPACT_PACK.unpack(packed)
    plan = next(iter(layout._compact_plans.values()))
    assert name == "layout_compact" and len(packed) == 13 * 8
    assert v[11:] == (c, m)
    groups = -(-c // 32)
    assert plan.blocks.dtype == torch.int64
    assert plan.blocks.numel() == max(-(-groups // layout.COMPACT_WARPS), 1)
    shapes = [(m,), (m,), (m, 3), (m, 3), (m,), (m,), (m,), (m,), (m,)]
    dtypes = [torch.int32, torch.int32, torch.float32, torch.float32, torch.float32,
              torch.bool, torch.float32, torch.float32, torch.int32]
    base = out[0].untyped_storage()
    assert base.nbytes() == 4 * plan.words
    for t, shp, dt in zip(out, shapes, dtypes):
        assert tuple(t.shape) == shp and t.dtype == dt
        assert t.untyped_storage()._cdata == base._cdata
    assert ov.dim() == 0 and ov.dtype == torch.int32
    assert ov.untyped_storage()._cdata == base._cdata
    out2, _ = layout.compact(rows, m)
    assert out2[0].untyped_storage()._cdata != base._cdata and len(layout._compact_plans) == 1
    n_calls = len(recorded)
    for k, bad in ((4, rows[4].double()), (2, rows[2][:, :2]), (5, rows[5].int()),
                   (8, torch.empty((c + 1,), dtype=torch.int32, device="meta")),
                   (3, torch.empty((c, 6), device="meta")[:, ::2])):
        r = list(rows)
        r[k] = bad
        with pytest.raises((TypeError, ValueError)):
            layout.compact(tuple(r), m)
    assert len(recorded) == n_calls


@pytest.mark.parametrize("case", ["s1", "s33", "l1", "nan_level"])
def test_spatialise_epilogue_launch_args(recorded, case):
    """KF with the epilogue folded in: the epilogue's four own tensors
    follow the fetch's and KF's pointers in the packed launch, its buffer
    is [2 S] words beside lp_out, new_hist and level (one buffer with the
    new playheads); a bad epilogue raises before a launch."""
    fed = hard_cases.epilogue_fed(case)
    args = _meta(hard_cases.fetch_inputs(fed, "cpu"))
    epi = args[-1]
    s, nl = fed.fetch["playhead"].shape
    out = kaudio.audio_spatialise(*args)
    assert len(out) == 8 and tuple(out[6].shape) == (2 * s,) and out[6].dtype == torch.float32
    name, packed = recorded[-1]
    v = kaudio._SPATIALISE_PACK.unpack(packed)
    assert name == "audio_spatialise" and v[39] == nl
    assert list(v[24:28]) == [t.data_ptr() for t in epi] and v[34] == out[6].data_ptr()
    assert v[33] == out[5].data_ptr() and tuple(out[7].shape) == (s, nl)
    assert out[6].untyped_storage()._cdata == out[5].untyped_storage()._cdata \
        == out[3].untyped_storage()._cdata
    n_calls = len(recorded)
    for k, bad in ((0, epi[0].int()), (1, epi[1].double()), (2, epi[2][:-1] if s > 1 else
                                                             epi[2].float()),
                   (3, torch.empty((s + 1,), dtype=torch.bool, device="meta"))):
        e = list(epi)
        e[k] = bad
        with pytest.raises((TypeError, ValueError)):
            kaudio.audio_spatialise(*args[:-1], tuple(e))
    with pytest.raises(ValueError):
        kaudio.audio_spatialise(*args[:-1], epi[:3])
    assert len(recorded) == n_calls
    # The epilogue is part of every call: there is no call without it.
    with pytest.raises(TypeError):
        kaudio.audio_spatialise(*args[:-1])

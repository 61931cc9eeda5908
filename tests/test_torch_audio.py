"""substrata_tpu_torch.audio against substrata_tpu.audio on the CPU: the
windowed fetch, ten chained mix blocks (HRTF on and off, room on and off),
the AudioEngine scenarios of tests/test_audio.py on both engines, the WAV
reader and the resampler.

Inputs are made from seeds with numpy and handed to both packages.  The
port repeats the reference's float32 arithmetic, including the multiply-add
that XLA's CPU compiler fuses; the low-pass is a frame-by-frame recurrence
where the reference runs an associative scan, and sums run in index order.

Two tolerances are wider than 1e-5, because XLA fuses ``playhead + rate *
block`` into one multiply-add for layers 0 and 1 of the [S, 3] playheads
but not for layer 2 (its code generator's choice; the port fuses all
three).  Layers 0 and 1 stay bit-equal; a layer-2 playhead moves by up to
1 ulp per block, and a looping one carries that error through its wraps:
measured 0.0049 samples after ten 800-frame blocks.  So playheads are held
to 1 ulp on layers 0-1 and 0.01 samples on layer 2, and the signals that
the 3-layer sources feed (the output, the low-pass memory, the HRIR
history, the level) to 5e-5 (measured 1.7e-5 at 800 frames, 1.2e-7 at
256); gains, fades, Doppler factors and the delay lines stay at 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.audio import engine as jengine
from substrata_tpu.audio import mix as jm
from substrata_tpu_torch import convert
from substrata_tpu_torch.audio import engine as tengine
from substrata_tpu_torch.audio import mix as tm
from substrata_tpu_torch.audio.readers import read_sound_file, read_wav
from substrata_tpu_torch.audio.resampler import AudioResampler, resample

torch.set_num_threads(2)

S = 16
POOL = 1 << 17
BUF = 20_000


def pool_np():
    i = np.arange(POOL)
    return (0.6 * np.sin(i * 0.03) + 0.3 * np.sin(i * 0.0071)).astype(np.float32)


def sources_np(seed, stream_heads=True):
    """Numpy SourceState fields of 16 sources of every kind: looping,
    non-looping past the end, streaming with underflow, paused, finished,
    dead, 3-layer mix sources, occluded, stereo, moving (Doppler)."""
    rng = np.random.default_rng(seed)
    a = {k: np.array(np.asarray(v)) for k, v in vars(jm.zero_sources(S)).items()}
    a["alive"][:] = True
    a["alive"][10] = False
    a["looping"][:4] = True
    a["looping"][11:14] = True
    a["buf_offset"][:, 0] = rng.integers(0, POOL - BUF - 4000, S)
    a["buf_len"][:, 0] = rng.integers(4000, BUF, S)
    a["playhead"][:, 0] = rng.uniform(0, 3000, S)
    a["playhead"][4:6, 0] = a["buf_len"][4:6, 0] - rng.uniform(60, 100, 2)   # runs off the end
    a["playhead"][14:16, 0] = a["buf_len"][14:16, 0] + 50.0                   # already past it
    a["stream_mode"][6:8] = True
    if stream_heads:
        a["stream_write_head"][6:8] = a["playhead"][6:8, 0] + rng.uniform(40, 100, 2)
    a["paused"][8] = True
    a["finished"][9] = True
    for j in (1, 2):                                                         # mix sources
        a["buf_offset"][11:14, j] = rng.integers(0, POOL - BUF - 4000, 3)
        a["buf_len"][11:14, j] = rng.integers(4000, BUF, 3)
        a["playhead"][11:14, j] = rng.uniform(0, 3000, 3)
    a["mix_factor"][11:14] = rng.uniform(0.2, 1.0, (3, 3))
    a["delta"][:] = rng.uniform(0.5, 2.4, (S, 3))
    a["pos"][:] = rng.uniform(-20, 20, (S, 3))
    a["vel"][:] = rng.uniform(-15, 15, (S, 3))
    a["num_occlusions"][:] = (rng.random(S) < 0.3) * rng.integers(1, 3, S)
    a["spatial"][12:14] = False                                             # stereo
    a["volume"][:] = rng.uniform(0.5, 1.0, S)
    a["mute_target"][3] = 0.0
    a["mute_rate"][3] = 8.0
    a["remove_on_finish"][4:6] = True
    return {k: np.ascontiguousarray(v.astype(np.asarray(getattr(jm.zero_sources(1), k)).dtype))
            for k, v in a.items()}


def jax_sources(a):
    return jm.SourceState(**{k: jnp.asarray(v) for k, v in a.items()})


def listener_np():
    ang = 0.4
    return dict(pos=np.array([0.5, -0.3, 0.2], np.float32),
                right=np.array([np.cos(ang), -np.sin(ang), 0.0], np.float32),
                forward=np.array([np.sin(ang), np.cos(ang), 0.0], np.float32),
                up=np.array([0.0, 0.0, 1.0], np.float32),
                vel=np.array([2.0, -1.0, 0.5], np.float32),
                master_volume=np.float32(0.8))


def as_np(state):
    return {k: np.asarray(v) for k, v in vars(state).items()}


@pytest.mark.parametrize("block", [256, 800])
def test_fetch_matches_reference(block):
    """The port's fetch (KE's twin) against _fetch_all plus the layer mix
    of mix_block (mix.py:310-316), same eff_delta, Δ in [0.5, 2.5]."""
    a = sources_np(1)
    rng = np.random.default_rng(2)
    ed = rng.uniform(0.5, 2.5, (S, 3)).astype(np.float32)
    active = a["alive"] & ~a["paused"] & ~a["finished"]

    @jax.jit
    def ref(src, pool, eff_delta, act):
        raw, heads = jm._fetch_all(pool, src, eff_delta, block)
        layer_gain = src.mix_factor * (src.buf_len > 0)
        samples = jnp.einsum("slb,sl->sb", raw, layer_gain,
                             precision=jax.lax.Precision.HIGHEST)
        return samples * act[:, None], heads

    js, jh = ref(jax_sources(a), jnp.asarray(pool_np()), jnp.asarray(ed), jnp.asarray(active))
    tsrc = convert.sources_from_numpy(a, device="cpu")
    ts, th = tm.fetch(torch.as_tensor(pool_np()), tsrc, torch.as_tensor(ed),
                      torch.as_tensor(active), block)
    js, jh = np.asarray(js), np.asarray(jh)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-5)
    np.testing.assert_array_max_ulp(th.numpy(), jh, maxulp=1)
    # The cases are really there: silence from the inactive, the
    # underflowing and the finished-past-the-end sources; sound elsewhere.
    assert np.all(js[[8, 9, 10, 14, 15]] == 0)
    assert np.all(np.abs(js[[0, 1, 11, 12]]).max(axis=1) > 0.1)
    for s in (4, 5, 6, 7):   # end of buffer / stream write head inside the block
        nz = np.nonzero(js[s])[0]
        assert 0 < len(nz) < block and np.all(ts.numpy()[s, nz[-1] + 1:] == 0)


CASES = [(True, True, 800), (True, False, 256), (False, True, 256), (False, False, 800)]


@pytest.mark.parametrize("use_hrtf,with_room,block", CASES,
                         ids=[f"hrtf{int(h)}-room{int(r)}-b{b}" for h, r, b in CASES])
def test_mix_block_chain_matches_reference(use_hrtf, with_room, block):
    """Ten chained blocks, held as the module docstring says; finished and
    alive equal."""
    a = sources_np(3)
    lis = listener_np()
    jsrc, tsrc = jax_sources(a), convert.sources_from_numpy(a, device="cpu")
    jl = jm.Listener(**{k: jnp.asarray(v) for k, v in lis.items()})
    tl = convert.listener_from_numpy(lis, device="cpu")
    jpool, tpool = jnp.asarray(pool_np()), torch.as_tensor(pool_np())
    jr = jm.room_from_aabb([-8, -6, 0], [8, 6, 4], 0.7) if with_room else None
    tr = convert.room_from_numpy(as_np(jr), device="cpu") if with_room else None
    tol_out = 5e-5
    for blk in range(10):
        if with_room:
            jsrc, jo, jr = jm.mix_block(jsrc, jpool, jl, room=jr, use_hrtf=use_hrtf, block=block)
            tsrc, to, tr = tm.mix_block(tsrc, tpool, tl, room=tr, use_hrtf=use_hrtf, block=block)
            np.testing.assert_allclose(tr.delay_lines.numpy(), np.asarray(jr.delay_lines),
                                       rtol=0, atol=1e-5, err_msg=f"block {blk}")
            assert int(tr.write_idx) == int(jr.write_idx)
        else:
            jsrc, jo = jm.mix_block(jsrc, jpool, jl, use_hrtf=use_hrtf, block=block)
            tsrc, to = tm.mix_block(tsrc, tpool, tl, use_hrtf=use_hrtf, block=block)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=tol_out,
                                   err_msg=f"block {blk}")
        jn, tn = as_np(jsrc), convert.to_numpy(tsrc)
        for k in ("prev_gain_l", "prev_gain_r", "mute_factor", "doppler_factor"):
            np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=1e-5, err_msg=f"{k} {blk}")
        for k in ("lp_state", "hrir_hist", "smoothed_level"):    # signal, like out
            np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=tol_out, err_msg=f"{k} {blk}")
        np.testing.assert_array_max_ulp(tn["playhead"][:, :2], jn["playhead"][:, :2], maxulp=1)
        np.testing.assert_allclose(tn["playhead"][:, 2], jn["playhead"][:, 2], rtol=0, atol=0.01)
        for k in ("finished", "alive"):
            assert np.array_equal(tn[k], jn[k]), (k, blk)
    out = to.numpy()
    assert np.abs(out).max() > 0.01 and np.abs(out[:, 0] - out[:, 1]).max() > 0.001
    assert tn["finished"][[4, 5]].all() and not tn["alive"][[4, 5]].any()   # one-shots retired


# ---------------------------------------------------------------------------
# AudioEngine scenarios (tests/test_audio.py) on both engines.
# ---------------------------------------------------------------------------

class Pkg:
    """The names a scenario needs, from either package."""

    def __init__(self, port: bool):
        self.port = port
        eng = tengine if port else jengine
        self.AudioSource = eng.AudioSource
        self.STREAMING = eng.SOURCE_TYPE_STREAMING
        self.mix = tm if port else jm

    def engine(self, **kw):
        return (tengine.AudioEngine(device="cpu", **kw) if self.port
                else jengine.AudioEngine(**kw))

    def sources(self, arrays):
        return (convert.sources_from_numpy(arrays, device="cpu") if self.port
                else jax_sources(arrays))

    def listener(self):
        return (tm.default_listener(device="cpu") if self.port else jm.default_listener())

    def pool(self, x):
        return torch.as_tensor(x) if self.port else jnp.asarray(x)

    def room(self, *a):
        return (tm.room_from_aabb(*a, device="cpu") if self.port else jm.room_from_aabb(*a))


def sine(freq, seconds=0.5, rate=48_000, amp=0.5):
    t = np.arange(int(seconds * rate)) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


def zc_freq(x):
    return len(np.where(np.diff(np.signbit(x)))[0]) / 2 / (len(x) / 48_000)


def looping(p, pos, **kw):
    return p.AudioSource(pos=np.array(pos, np.float32), looping=True, remove_on_finish=False,
                         **kw)


def sc_render(p):
    eng = p.engine(max_sources=16)
    eng.add_source(looping(p, [0, 1, 0]), sound=sine(440))
    out = eng.render(4)
    assert out.shape == (4 * 256, 2) and rms(out) > 0.05 and np.abs(out).max() <= 1.0
    return out


def sc_distance(p):
    eng = p.engine(max_sources=16)
    near = eng.add_source(looping(p, [0, 1, 0]), sound=sine(440))
    out_near = eng.render(4)
    eng.remove_source(near)
    eng.add_source(looping(p, [0, 30, 0]), sound=sine(440))
    eng.render(1)
    out_far = eng.render(4)
    assert rms(out_far) < rms(out_near) * 0.2
    return np.concatenate([out_near, out_far])


def sc_pan(p):
    eng = p.engine(max_sources=16)
    eng.add_source(looping(p, [-5, 0.01, 0]), sound=sine(440))
    eng.render(1)
    out = eng.render(4)
    assert rms(out[:, 0]) > rms(out[:, 1]) * 2.0
    return out


def sc_one_shot_retires(p):
    eng = p.engine(max_sources=16)
    src = p.AudioSource(pos=np.zeros(3, np.float32), looping=False, remove_on_finish=True)
    eng.add_source(src, sound=sine(440, seconds=256 / 48_000 * 2))
    out = eng.render(4)
    assert src.slot == -1 and int(np.asarray(eng.sources.alive).sum()) == 0
    return out


def sc_occlusion(p):
    eng = p.engine(max_sources=16)
    src = eng.add_source(looping(p, [0, 2, 0]), sound=sine(440))
    eng.render(2)
    clear = eng.render(4)
    src.num_occlusions = 2
    eng.source_num_occlusions_updated(src)
    eng.render(2)
    occluded = eng.render(4)
    assert rms(occluded) < rms(clear) * 0.7
    return np.concatenate([clear, occluded])


def sc_doppler(p):
    eng = p.engine(max_sources=16)
    eng.add_source(looping(p, [0, 50, 0], vel=np.array([0, -30, 0], np.float32)),
                   sound=sine(440, seconds=2.0))
    out = eng.render(40)
    assert zc_freq(out[:, 0]) > 455
    return out


def sc_mix_sources(p):
    eng = p.engine(max_sources=16)
    src = eng.add_source(looping(p, [0, 1, 0]), mixes=[
        (sine(200), 1.0, 1.0), (sine(400), 1.0, 0.0), (sine(800), 1.0, 0.0)])
    low = eng.render(4)
    eng.set_source_mix_params(src, deltas=[1.0, 1.0, 1.5], factors=[0.0, 0.0, 1.0])
    eng.render(1)
    high = eng.render(4)
    assert zc_freq(high[:, 0]) > zc_freq(low[:, 0]) * 2
    return np.concatenate([low, high])


def sc_stream_underflow(p):
    eng = p.engine(max_sources=16)
    src = eng.add_source(p.AudioSource(pos=np.array([0, 1, 0], np.float32),
                                       source_type=p.STREAMING, remove_on_finish=False))
    silent = eng.render(2)
    assert rms(silent) < 1e-6
    eng.stream_samples(src, sine(440, seconds=0.2))
    out = eng.render(4)
    assert rms(out) > 0.05
    return np.concatenate([silent, out])


def sc_master_volume_and_mute(p):
    eng = p.engine(max_sources=16)
    src = eng.add_source(looping(p, [0, 1, 0]), sound=sine(440))
    eng.render(2)
    base = eng.render(4)
    eng.set_master_volume(0.25)
    quiet = eng.render(4)
    assert rms(quiet) == pytest.approx(rms(base) * 0.25, rel=0.2)
    eng.set_master_volume(1.0)
    eng.mute_source(src, fade_time=0.02)
    eng.render(6)
    muted = eng.render(4)
    assert rms(muted) < rms(base) * 0.05
    return np.concatenate([base, quiet, muted])


def _impulse_source(p, at, pos, pool_len=4096, looping=False):
    a = {k: np.array(np.asarray(v)) for k, v in vars(jm.zero_sources(4)).items()}
    a["alive"][0] = True
    a["buf_len"][0, 0] = pool_len
    a["looping"][0] = looping
    a["pos"][0] = pos
    return p.sources(a)


def sc_hrtf_itd_ild(p):
    """A source hard right reaches the right ear earlier and louder."""
    pool = np.zeros(4096, np.float32)
    pool[100] = 1.0
    _, out = p.mix.mix_block(_impulse_source(p, 100, [3.0, 0.0, 0.0]), p.pool(pool),
                             p.listener(), use_hrtf=True)
    out = np.asarray(out)
    left, right = out[:, 0], out[:, 1]
    n = len(left)
    keep = (np.fft.rfftfreq(4 * n, 1.0 / 48_000) < 1500.0).astype(float)
    lf = np.fft.irfft(np.fft.rfft(left, 4 * n) * keep)[:n]
    rf = np.fft.irfft(np.fft.rfft(right, 4 * n) * keep)[:n]
    lag = int(np.argmax(np.correlate(lf, rf, mode="full"))) - (n - 1)
    assert lag > 0 and np.abs(right).max() > 2.5 * max(np.abs(left).max(), 1e-9)
    return out


def sc_reverb_tail(p):
    pool = np.zeros(4096, np.float32)
    pool[10] = 1.0
    src = _impulse_source(p, 10, [0.0, 2.0, 0.0])
    room = p.room([-5, -5, 0], [5, 5, 3], 0.8)
    lis, outs, tail = p.listener(), [], 0.0
    for blk in range(8):
        src, out, room = p.mix.mix_block(src, p.pool(pool), lis, room=room)
        outs.append(np.asarray(out))
        if blk >= 2:
            tail += float(np.abs(outs[-1]).sum())
    assert tail > 0.01
    return np.concatenate(outs)


def sc_hrtf_off(p):
    pool = np.sin(np.arange(4096) * 0.1).astype(np.float32)
    _, out = p.mix.mix_block(_impulse_source(p, 0, [3.0, 0.0, 0.0], looping=True),
                             p.pool(pool), p.listener(), use_hrtf=False)
    out = np.asarray(out)
    assert np.abs(out[:, 1]).mean() > 5.0 * np.abs(out[:, 0]).mean()
    return out


def sc_head_turn_pushes_and_room(p):
    """The head turned half way round swaps the ears; position and volume
    pushes land on the next block; room effects on and off."""
    eng = p.engine(max_sources=16)
    src = eng.add_source(looping(p, [-5, 0.01, 0]), sound=sine(440))
    eng.render(1)
    facing = eng.render(4)
    eng.set_head_transform([0, 0, 0], [0, 0, 1, 0])         # 180 deg about z
    eng.render(1)
    turned = eng.render(4)
    assert rms(facing[:, 0]) > 2 * rms(facing[:, 1]) and rms(turned[:, 1]) > 2 * rms(turned[:, 0])
    src.pos = np.array([0, 3, 0], np.float32)
    src.volume = 0.5
    eng.source_position_updated(src)
    eng.source_volume_updated(src)
    eng.set_room_effects_from_aabb([-6, -6, 0], [6, 6, 3], 0.8)
    roomy = eng.render(6)
    eng.disable_room_effects()
    dry = eng.render(2)
    assert "1 sources" in eng.get_diagnostics()
    return np.concatenate([facing, turned, roomy, dry])


def sc_one_shot_file(p, tmp_path):
    """play_one_shot_sound loads a WAV once, resampled to 48 kHz, plays it
    and retires the source at its end."""
    import wave
    path = str(tmp_path / f"shot_{int(p.port)}.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(44_100)
        w.writeframes((sine(660, 0.01, rate=44_100) * 32767).astype(np.int16).tobytes())
    eng = p.engine(max_sources=16)
    src = eng.play_one_shot_sound(path, [0, 1, 0])
    assert eng.get_or_load_sound_file(path) == eng.sound_file_cache[path]
    out = eng.render(4)
    assert rms(out) > 0.01 and src.slot == -1
    return out


SCENARIOS = [sc_render, sc_distance, sc_pan, sc_one_shot_retires, sc_occlusion, sc_doppler,
             sc_mix_sources, sc_stream_underflow, sc_master_volume_and_mute, sc_hrtf_itd_ild,
             sc_reverb_tail, sc_hrtf_off, sc_head_turn_pushes_and_room]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__[3:] for f in SCENARIOS])
def test_engine_scenario_matches_reference(scenario):
    """Each scenario's property holds on the port, and its output equals
    the reference engine's within 1e-5."""
    port = scenario(Pkg(port=True))
    ref = scenario(Pkg(port=False))
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)


def test_one_shot_file_matches_reference(tmp_path):
    port = sc_one_shot_file(Pkg(port=True), tmp_path)
    ref = sc_one_shot_file(Pkg(port=False), tmp_path)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)


def test_pump_thread_and_device_callback():
    eng = tengine.AudioEngine(max_sources=16, device="cpu")
    eng.add_source(looping(Pkg(port=True), [0, 1, 0]), sound=sine(440))
    eng.start()
    try:
        import time
        deadline = time.time() + 20.0
        while eng._queued_frames() < 2 * 256 and time.time() < deadline:
            time.sleep(0.01)
        out = eng.read_output(2 * 256)
    finally:
        eng.shutdown()
    assert not eng._pump_thread.is_alive()
    assert rms(out) > 0.02
    out2 = eng.read_output(48_000 * 2)
    assert out2.shape == (96_000, 2)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_gpu.py checks the default")
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.AudioEngine(max_sources=4)


def test_wav_roundtrip_and_mp3_not_ported(tmp_path):
    import wave
    data = (sine(440, 0.1) * 32767).astype(np.int16)
    path = tmp_path / "t.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(data.tobytes())
    sf = read_wav(str(path))
    assert sf.sample_rate == 44100 and sf.num_channels == 1
    assert abs(sf.maxVal() - 0.5) < 0.01
    sf48 = read_sound_file(str(path), target_rate=48_000)
    assert sf48.sample_rate == 48_000
    assert len(sf48.buf) == pytest.approx(len(data) * 48_000 / 44_100, abs=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        read_sound_file(str(tmp_path / "x.mp3"))


def test_resampler_matches_reference():
    from substrata_tpu.audio import resampler as jres
    x = sine(1000, 0.2, rate=44100)
    y = resample(x, 44100, 48000)
    assert np.array_equal(y, jres.resample(x, 44100, 48000))
    assert zc_freq(y) == pytest.approx(1000, rel=0.02)
    r, jr = AudioResampler(44100, 48000), jres.AudioResampler(44100, 48000)
    x = sine(500, 0.1, rate=44100)
    pos, chunks = 0, []
    for _ in range(10):
        need = r.num_src_samples_needed(256)
        assert need == jr.num_src_samples_needed(256)
        chunk = x[pos:pos + need]
        if len(chunk) < need:
            break
        pos += need
        chunks.append(r.resample(chunk, 256))
        assert np.array_equal(chunks[-1], jr.resample(chunk, 256))
    assert zc_freq(np.concatenate(chunks)) == pytest.approx(500, rel=0.05)

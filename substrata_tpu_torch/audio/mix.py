"""The per-block spatial audio mix.

Counterpart of ``substrata_tpu/audio/mix.py``: for every active source pull
``block`` frames from the sample pool (looping, mix sources with per-layer
pitch, streaming ring buffers), resample, spatialise and downmix to stereo,
with the same state, the same fields and the same return tuple.

``mix_block`` runs three launches: KAA's setup (``kernels/audio_setup.py``:
Doppler, fades, distance and occlusion gains, pan, HRIR direction, every
field in one buffer), then KF fetches and resamples each source's frames,
low-passes, convolves with the HRIRs, ramps the gains and writes the new
playheads and the epilogue (the finished flags, the level meter, the alive
mask), and KG sums the sources and runs the reverb
(``kernels/audio_mix.py``).  Nothing in it copies from
the device to the host.  The reference's one-hot/triangular MXU contraction of the fetch is
TPU layout only; the port gathers and lerps directly, with the same
float32 index arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from substrata_tpu_torch.audio.hrtf import TAPS as HRIR_TAPS
from substrata_tpu_torch.audio.hrtf import hrir_bank_tensor
from substrata_tpu_torch.kernels import audio_mix as kern
from substrata_tpu_torch.kernels import audio_setup as kset
from substrata_tpu_torch.physics.state import _Replace

BLOCK = 256            # frames per block
ENGINE_RATE = 48_000   # Hz stereo f32 output
NUM_MIX_LAYERS = 3     # engine-sound layers
SPEED_OF_SOUND = 343.0

# Windowed-fetch contract: every buffer in the sample pool carries FETCH_PAD
# samples after its end holding a copy of its head (AudioEngine.load_sound),
# so looping reads never wrap inside a block.  DELTA_MAX bounds the
# effective playback rate so the per-block read span is known.
MAX_SUPERBLOCK = 1024
DELTA_MAX = 2.5
FETCH_PAD = int(MAX_SUPERBLOCK * DELTA_MAX) + 512  # 3072

# Reverb feedback-delay network.
FDN_LINES = 4
FDN_MAX_DELAY = 8192   # ~170 ms at 48 kHz
_FDN_MIX = kern.FDN_MIX

f32 = torch.float32


@dataclasses.dataclass
class RoomState(_Replace):
    """Room reverb state + parameters (from the containing object's AABB)."""

    delay_lines: torch.Tensor  # [FDN_LINES, FDN_MAX_DELAY]
    write_idx: torch.Tensor    # [] i32
    delays: torch.Tensor       # [FDN_LINES] i32 per-line delay
    feedback: torch.Tensor     # [] f32 decay gain
    wet: torch.Tensor          # [] f32 reverb send level (0 = off)


def default_room(*, device) -> RoomState:
    return RoomState(
        delay_lines=torch.zeros((FDN_LINES, FDN_MAX_DELAY), dtype=f32, device=device),
        write_idx=torch.zeros((), dtype=torch.int32, device=device),
        delays=torch.tensor([1323, 1811, 2203, 2707], dtype=torch.int32, device=device),
        feedback=torch.zeros((), dtype=f32, device=device),
        wet=torch.zeros((), dtype=f32, device=device),
    )


def room_from_aabb(aabb_min, aabb_max, reflectivity: float, *, device) -> RoomState:
    """Room parameters from the enclosing object's AABB: first-order
    reflection path lengths per dimension pair give the line delays,
    de-tuned by co-prime factors, and at least MAX_SUPERBLOCK so the FDN
    processes a whole block in parallel."""
    dims = np.maximum(np.asarray(aabb_max, np.float64)
                      - np.asarray(aabb_min, np.float64), 0.5)
    base = np.array([dims[0], dims[1], dims[2],
                     float(np.linalg.norm(dims)) * 0.5])
    delays = np.clip((base / 343.0 * ENGINE_RATE
                      * np.array([1.0, 1.13, 1.31, 1.53])).astype(np.int64),
                     MAX_SUPERBLOCK, FDN_MAX_DELAY - 1)
    refl = float(np.clip(reflectivity, 0.0, 0.98))
    return default_room(device=device).replace(
        delays=torch.as_tensor(delays.astype(np.int32), device=device),
        feedback=torch.tensor(np.float32(0.55 + 0.4 * refl), device=device),
        wet=torch.tensor(np.float32(0.25 * refl), device=device))


@dataclasses.dataclass
class SourceState(_Replace):
    """SoA state for all audio sources, capacity S."""

    # Playback
    buf_offset: torch.Tensor    # [S, L] i32 pool offset per mix layer
    buf_len: torch.Tensor       # [S, L] i32 (0 = layer unused)
    playhead: torch.Tensor      # [S, L] f32 fractional sample position
    delta: torch.Tensor         # [S, L] f32 playback rate (pitch * src_rate/48k)
    mix_factor: torch.Tensor    # [S, L] f32 per-layer gain (mix sources)
    looping: torch.Tensor       # [S] bool
    remove_on_finish: torch.Tensor  # [S] bool
    finished: torch.Tensor      # [S] bool
    paused: torch.Tensor        # [S] bool
    # Spatial
    pos: torch.Tensor           # [S, 3] world position
    vel: torch.Tensor           # [S, 3] for Doppler
    spatial: torch.Tensor       # [S] bool (False = plain stereo source)
    volume: torch.Tensor        # [S]
    mute_factor: torch.Tensor   # [S] current mute-fade volume factor
    mute_target: torch.Tensor   # [S] fade target (timed mute/unmute)
    mute_rate: torch.Tensor     # [S] fade rate per second
    num_occlusions: torch.Tensor  # [S] f32
    doppler_factor: torch.Tensor  # [S] smoothed doppler playback scale
    # DSP state
    lp_state: torch.Tensor      # [S] one-pole low-pass memory
    prev_gain_l: torch.Tensor   # [S] last block's gains (for ramps)
    prev_gain_r: torch.Tensor   # [S]
    smoothed_level: torch.Tensor  # [S] output level meter
    alive: torch.Tensor         # [S] bool
    # Streaming sources: layer 0 is a ring buffer; reads beyond the write
    # head zero-pad (underflow).
    stream_mode: torch.Tensor   # [S] bool
    stream_write_head: torch.Tensor  # [S] f32 absolute samples written
    # HRIR convolution history: the last TAPS-1 samples per source.
    hrir_hist: torch.Tensor     # [S, TAPS-1] f32

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self):
        return self.pos.device


SOURCE_FIELDS = tuple(f.name for f in dataclasses.fields(SourceState))


def zero_sources(capacity: int, *, device) -> SourceState:
    s, nl = capacity, NUM_MIX_LAYERS
    f = dict(dtype=f32, device=device)
    b = dict(dtype=torch.bool, device=device)
    mix_factor = torch.zeros((s, nl), **f)
    mix_factor[:, 0] = 1.0
    return SourceState(
        buf_offset=torch.zeros((s, nl), dtype=torch.int32, device=device),
        buf_len=torch.zeros((s, nl), dtype=torch.int32, device=device),
        playhead=torch.zeros((s, nl), **f),
        delta=torch.ones((s, nl), **f),
        mix_factor=mix_factor,
        looping=torch.zeros((s,), **b),
        remove_on_finish=torch.zeros((s,), **b),
        finished=torch.zeros((s,), **b),
        paused=torch.zeros((s,), **b),
        pos=torch.zeros((s, 3), **f),
        vel=torch.zeros((s, 3), **f),
        spatial=torch.ones((s,), **b),
        volume=torch.ones((s,), **f),
        mute_factor=torch.ones((s,), **f),
        mute_target=torch.ones((s,), **f),
        mute_rate=torch.zeros((s,), **f),
        num_occlusions=torch.zeros((s,), **f),
        doppler_factor=torch.ones((s,), **f),
        lp_state=torch.zeros((s,), **f),
        prev_gain_l=torch.zeros((s,), **f),
        prev_gain_r=torch.zeros((s,), **f),
        smoothed_level=torch.zeros((s,), **f),
        alive=torch.zeros((s,), **b),
        stream_mode=torch.zeros((s,), **b),
        stream_write_head=torch.zeros((s,), **f),
        hrir_hist=torch.zeros((s, HRIR_TAPS - 1), **f),
    )


@dataclasses.dataclass
class Listener(_Replace):
    pos: torch.Tensor      # [3]
    right: torch.Tensor    # [3] head frame
    forward: torch.Tensor  # [3]
    up: torch.Tensor       # [3]
    vel: torch.Tensor      # [3]
    master_volume: torch.Tensor  # []


LISTENER_FIELDS = tuple(f.name for f in dataclasses.fields(Listener))
ROOM_FIELDS = tuple(f.name for f in dataclasses.fields(RoomState))


def default_listener(*, device) -> Listener:
    def v(*x):
        return torch.tensor(x, dtype=f32, device=device)
    return Listener(pos=v(0.0, 0.0, 0.0), right=v(1.0, 0.0, 0.0),
                    forward=v(0.0, 1.0, 0.0), up=v(0.0, 0.0, 1.0),
                    vel=v(0.0, 0.0, 0.0),
                    master_volume=torch.tensor(1.0, dtype=f32, device=device))


def window_rows(block: int) -> int:
    """128-sample pool rows a block's read span can touch (mix.py:224)."""
    return (127 + int(block * DELTA_MAX) + 1) // 128 + 2


_RAMPS: dict = {}


def gain_ramp(block: int, device) -> torch.Tensor:
    """linspace(0, 1, block) on ``device``, made once; the kernel and the
    plain path take the same tensor."""
    key = (block, torch.device(device))
    if key not in _RAMPS:
        _RAMPS[key] = torch.linspace(0.0, 1.0, block, dtype=f32, device=device)
    return _RAMPS[key]


@dataclasses.dataclass
class MixSetup:
    """Per-source quantities of one block, computed before the kernels."""

    active: torch.Tensor      # [S] bool
    eff_delta: torch.Tensor   # [S, L] playback rate x Doppler, clipped
    dop_smooth: torch.Tensor  # [S]
    mute: torch.Tensor        # [S]
    gain: torch.Tensor        # [S]
    gl: torch.Tensor          # [S] target gains of this block
    gr: torch.Tensor
    alpha: torch.Tensor       # [S] low-pass coefficient
    use_lp: torch.Tensor      # [S] bool
    dir_idx: torch.Tensor | None  # [S] i32 az * N_EL + el (HRTF only)
    send_gain: torch.Tensor   # [S] reverb send


def prepare(src: SourceState, listener: Listener, block: int, dt_block: float,
            use_hrtf: bool) -> MixSetup:
    """The per-source setup of mix.py:294-359 and :376-392 (Doppler and
    its smoothing, fades, distance and occlusion gains, pan, low-pass
    coefficient and the HRIR direction) in one launch of KAA; the fields
    are views of its one output buffer."""
    buf = kset.audio_setup(
        src.alive, src.paused, src.finished, src.spatial, src.pos, src.vel, src.delta,
        src.doppler_factor, src.mute_factor, src.mute_target, src.mute_rate, src.volume,
        src.num_occlusions, listener.pos, listener.vel, listener.right, listener.forward,
        listener.up, kset.dop_alpha(block), dt_block, use_hrtf)
    v = kset.setup_views(buf, src.capacity, src.delta.shape[1])
    if not use_hrtf:
        v["dir_idx"] = None
    return MixSetup(**v)


def fetch_args(pool, src: SourceState, eff_delta, active, block: int):
    """The fetch's arguments over the state (``kernels.audio_mix.FETCH_NAMES``,
    the block, the window rows), as KF and ``audio_fetch_plain`` take them."""
    return (pool, src.buf_offset, src.buf_len, src.playhead, eff_delta, src.mix_factor,
            src.looping, src.stream_mode, src.stream_write_head, active, block,
            window_rows(block))


def mix_block(src: SourceState, pool: torch.Tensor, listener: Listener,
              dt_block=None, room: RoomState | None = None,
              use_hrtf: bool = True, block: int = BLOCK):
    """Mix one stereo block of ``block`` frames (default 256).

    Returns (new_src, out [B, 2]), or (new_src, out, new_room) when a
    RoomState is passed.  use_hrtf=True spatialises through the HRIR bank;
    False uses constant-power pan + head-shadow low-pass.  ``block`` is a
    multiple of 16 up to MAX_SUPERBLOCK (the physics+audio tick mixes one
    60 Hz tick, 800 frames, in one call)."""
    if block % 16 or block > MAX_SUPERBLOCK:
        raise ValueError(f"block {block}: a multiple of 16 up to {MAX_SUPERBLOCK}")
    if dt_block is None:
        dt_block = block / ENGINE_RATE
    dev = src.device
    st = prepare(src, listener, block, dt_block, use_hrtf)

    # The fetch, then the spatialiser; non-looping sources finish when
    # layer 0 passes the end; the level meter and the alive mask follow
    # (KF writes them beside the level).
    wl, wr, ws, lp_out, new_hist, _, ep, new_heads = kern.audio_spatialise(
        fetch_args(pool, src, st.eff_delta, st.active, block), src.lp_state, st.alpha,
        st.use_lp, src.spatial, src.hrir_hist, hrir_bank_tensor(dev) if use_hrtf else None,
        st.dir_idx, src.prev_gain_l, src.prev_gain_r, st.gl, st.gr, gain_ramp(block, dev),
        st.gain, st.send_gain if room is not None else None, use_hrtf,
        epilogue=(src.finished, src.smoothed_level, src.alive, src.remove_on_finish))
    ep = kern.epilogue_views(ep, src.capacity)
    if room is not None:
        out, lines, widx = kern.audio_downmix_reverb(
            wl, wr, ws, listener.master_volume, room.delay_lines, room.write_idx,
            room.delays, room.feedback, room.wet)
    else:
        out, _, _ = kern.audio_downmix_reverb(wl, wr, None, listener.master_volume)

    new_src = src.replace(
        playhead=new_heads, finished=ep["finished"], mute_factor=st.mute,
        doppler_factor=st.dop_smooth, lp_state=lp_out,
        prev_gain_l=st.gl, prev_gain_r=st.gr, smoothed_level=ep["smoothed_level"],
        hrir_hist=new_hist, alive=ep["alive"])
    if room is not None:
        return new_src, out, room.replace(delay_lines=lines, write_idx=widx)
    return new_src, out

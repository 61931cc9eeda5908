"""The per-block spatial audio mix.

Counterpart of ``substrata_tpu/audio/mix.py``: for every active source pull
``block`` frames from the sample pool (looping, mix sources with per-layer
pitch, streaming ring buffers), resample, spatialise and downmix to stereo,
with the same state, the same fields and the same return tuple.

``mix_block`` runs the per-source setup (Doppler, fades, distance and
occlusion gains, pan, HRIR direction) as plain torch on ``[S]`` tensors,
then three kernels (``kernels/audio_mix.py``): KE fetches and resamples,
KF low-passes, convolves with the HRIRs and ramps the gains, KG sums the
sources and runs the reverb.  Nothing in it copies from the device to the
host.  The reference's one-hot/triangular MXU contraction of the fetch is
TPU layout only; the port gathers and lerps directly, with the same
float32 index arithmetic.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from substrata_tpu_torch.audio.hrtf import N_EL, TAPS as HRIR_TAPS
from substrata_tpu_torch.audio.hrtf import hrir_bank_tensor, quantize_direction
from substrata_tpu_torch.kernels import audio_mix as kern
from substrata_tpu_torch.maths.fp import dot3, fma
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
    """The per-source setup of mix.py:294-359 and :376-392: Doppler and its
    smoothing, fades, distance and occlusion gains, pan, low-pass
    coefficient and the HRIR direction, on [S] tensors."""
    active = src.alive & ~src.paused & ~src.finished
    to_src = src.pos - listener.pos[None, :]
    dist = torch.sqrt(dot3(to_src, to_src))
    dirn = to_src / torch.clamp(dist, min=1e-6)[:, None]
    v_src = dot3(src.vel, dirn)                 # velocity away from listener
    v_lis = dot3(listener.vel[None, :], dirn)
    doppler = torch.clamp((SPEED_OF_SOUND - v_lis)
                          / torch.clamp(SPEED_OF_SOUND - (-v_src), min=1.0), 0.5, 2.0)
    doppler = torch.where(src.spatial, doppler, 1.0)
    dop_alpha = 1.0 - (1.0 - 0.2) ** (block / 256.0)
    dop_smooth = fma(doppler - src.doppler_factor, dop_alpha, src.doppler_factor)
    eff_delta = torch.clamp(src.delta * dop_smooth[:, None], 0.0, DELTA_MAX)

    mute = src.mute_factor + torch.clamp(src.mute_target - src.mute_factor,
                                         -src.mute_rate * dt_block, src.mute_rate * dt_block)
    dist_gain = torch.clamp(1.0 / torch.clamp(dist, min=1.0), max=1.0)
    occ_gain = 1.0 / (1.0 + src.num_occlusions)
    x = dot3(to_src, listener.right[None, :])
    y = dot3(to_src, listener.forward[None, :])
    pan = torch.clamp(x / torch.clamp(dist, min=1e-6), -1.0, 1.0)
    theta = (pan + 1.0) * (math.pi / 4.0)
    behind = y < 0.0
    gain = src.volume * mute * torch.where(src.spatial, dist_gain * occ_gain, 1.0)
    occluded = src.num_occlusions > 0
    if use_hrtf:
        # Direction is in the HRIRs; both channels carry the full gain.
        gl = gain * torch.where(src.spatial, 1.0, 0.70710678) * active
        gr = gl
        fc = torch.where(occluded, 800.0, 20000.0)
        use_lp = occluded
        zc = dot3(to_src, listener.up[None, :])
        ai, ei = quantize_direction(x, y, zc, dist)
        dir_idx = ai * N_EL + ei
    else:
        gl = gain * torch.where(src.spatial, torch.cos(theta), 0.70710678) * active
        gr = gain * torch.where(src.spatial, torch.sin(theta), 0.70710678) * active
        shadow = behind & src.spatial
        fc = torch.where(occluded, 800.0, torch.where(shadow, 3000.0, 20000.0))
        use_lp = occluded | shadow
        dir_idx = None
    alpha = torch.clamp(2.0 * math.pi * fc / ENGINE_RATE, 0.0, 1.0)
    send_gain = gain * active * src.spatial.to(f32)
    return MixSetup(active=active, eff_delta=eff_delta, dop_smooth=dop_smooth, mute=mute,
                    gain=gain, gl=gl, gr=gr, alpha=alpha, use_lp=use_lp, dir_idx=dir_idx,
                    send_gain=send_gain)


def fetch(pool, src: SourceState, eff_delta, active, block: int):
    """KE over the state: (samples [S, B] summed over the layers with their
    mix factors and masked by ``active``, new playheads [S, L])."""
    return kern.audio_fetch(pool, src.buf_offset, src.buf_len, src.playhead, eff_delta,
                            src.mix_factor, src.looping, src.stream_mode,
                            src.stream_write_head, active, block, window_rows(block))


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
    samples, new_heads = fetch(pool, src, st.eff_delta, st.active, block)

    # Non-looping sources finish when layer 0 passes the end.
    finished = src.finished | (
        (~src.looping) & (~src.stream_mode) & st.active
        & (new_heads[:, 0] >= src.buf_len[:, 0].to(f32) - 1.0))

    wl, wr, ws, lp_out, new_hist, level = kern.audio_spatialise(
        samples, src.lp_state, st.alpha, st.use_lp, src.spatial, src.hrir_hist,
        hrir_bank_tensor(dev) if use_hrtf else None, st.dir_idx,
        src.prev_gain_l, src.prev_gain_r, st.gl, st.gr, gain_ramp(block, dev),
        st.gain, st.send_gain if room is not None else None, use_hrtf)
    if room is not None:
        out, lines, widx = kern.audio_downmix_reverb(
            wl, wr, ws, listener.master_volume, room.delay_lines, room.write_idx,
            room.delays, room.feedback, room.wet)
    else:
        out, _, _ = kern.audio_downmix_reverb(wl, wr, None, listener.master_volume)

    smoothed = fma(level, 0.1, src.smoothed_level * 0.9)
    new_src = src.replace(
        playhead=new_heads, finished=finished, mute_factor=st.mute,
        doppler_factor=st.dop_smooth, lp_state=lp_out,
        prev_gain_l=st.gl, prev_gain_r=st.gr, smoothed_level=smoothed,
        hrir_hist=new_hist,
        alive=src.alive & ~(finished & src.remove_on_finish))
    if room is not None:
        return new_src, out, room.replace(delay_lines=lines, write_idx=widx)
    return new_src, out

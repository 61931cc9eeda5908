"""KAA: the audio mix's per-source setup and its plain twin.

Replace the per-source part of the device program
``substrata_tpu/audio/mix.py:mix_block`` (:276): the setup of :290-348
(Doppler and its smoothing, the playback rate per layer, fades, distance
and occlusion gains, pan, the low-pass cutoff) with the HRIR direction of
:376-392, in one launch per block (``csrc/audio_setup.cu``).  The
epilogue of :433-444 (the finished flag, the smoothed level, the alive
mask) went into KF's source blocks, which hold the level it reads
(``audio_mix.audio_spatialise(..., epilogue=...)``, twin
``audio_mix.audio_epilogue_plain``).

``audio_setup`` returns ONE float32 buffer of (L + 9) * S words; KF
reads its fields as views (``setup_views``).  It runs its twin for CPU
tensors; for CUDA tensors it launches the kernel or raises.  The twin
writes the same buffer, so the kernel and its twin compare word for
word.

Rounding (found by comparing with the jitted reference, not guessed): the
distance is the correctly rounded square root of the dot product's fma
chain; a division by a tensor divides; a division by a constant is a
multiply by its float32 reciprocal (``quantize_direction``); the low-pass
coefficients are three constants divided once on the host, so the twin
rounds alike on the CPU and on the card (where torch would multiply by the
reciprocal of a Python divisor).  Only atan2, cos and sin can part from
the reference's in the last bit.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from substrata_tpu_torch.audio.hrtf import N_EL, quantize_direction
from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths.fp import dot3, fma

launches = {"audio_setup": 0}

SPEED_OF_SOUND = 343.0
DELTA_MAX = 2.5
ENGINE_RATE = 48_000
# The [S] fields after eff_delta [S, L], in buffer order; "flags" holds
# active in its bytes [0, S) and use_lp in [S, 2S).
SETUP_FIELDS = ("dop_smooth", "mute", "gain", "gl", "gr", "alpha", "send_gain", "dir_idx",
                "flags")
SETUP_WORDS = len(SETUP_FIELDS)          # + L per source


def _lp_alpha(fc: float) -> float:
    """clip(2 pi fc / 48000, 0, 1), rounded as the reference's program."""
    f32 = np.float32
    return float(np.clip(f32(f32(fc) * f32(2 * math.pi)) / f32(ENGINE_RATE), 0.0, 1.0))


ALPHA_OCCLUDED, ALPHA_SHADOW, ALPHA_OPEN = (_lp_alpha(fc) for fc in (800.0, 3000.0, 20000.0))

f32, i32 = torch.float32, torch.int32


def setup_views(buf: torch.Tensor, s: int, nl: int) -> dict:
    """The fields of a setup buffer as contiguous views."""
    v = {"eff_delta": buf[:s * nl].view(s, nl)}
    for k, name in enumerate(SETUP_FIELDS[:-2]):
        v[name] = buf[(nl + k) * s:(nl + k + 1) * s]
    k = nl + SETUP_WORDS - 2
    v["dir_idx"] = buf[k * s:(k + 1) * s].view(i32)
    flags = buf[(k + 1) * s:(k + 2) * s].view(torch.uint8)
    v["active"] = flags[:s].view(torch.bool)
    v["use_lp"] = flags[s:2 * s].view(torch.bool)
    return v


def dop_alpha(block: int) -> float:
    """The per-block Doppler smoothing factor (0.2 per 256 frames)."""
    return float(np.float32(1.0 - (1.0 - 0.2) ** (block / 256.0)))


def audio_setup_plain(alive, paused, finished, spatial, pos, vel, delta, doppler_factor,
                      mute_factor, mute_target, mute_rate, volume, num_occlusions, l_pos, l_vel,
                      l_right, l_forward, l_up, dop_alpha: float, dt_block: float,
                      use_hrtf: bool):
    s, nl = delta.shape
    active = alive & ~paused & ~finished
    to_src = pos - l_pos[None, :]
    dist = fp.sqrt(dot3(to_src, to_src))
    dc = torch.clamp(dist, min=1e-6)
    dirn = to_src / dc[:, None]
    v_src = dot3(vel, dirn)                     # velocity away from listener
    v_lis = dot3(l_vel[None, :], dirn)
    doppler = torch.clamp((SPEED_OF_SOUND - v_lis)
                          / torch.clamp(SPEED_OF_SOUND - (-v_src), min=1.0), 0.5, 2.0)
    doppler = torch.where(spatial, doppler, 1.0)
    dop_smooth = fma(doppler - doppler_factor, dop_alpha, doppler_factor)
    eff_delta = torch.clamp(delta * dop_smooth[:, None], 0.0, DELTA_MAX)

    mute = mute_factor + torch.clamp(mute_target - mute_factor,
                                     -mute_rate * dt_block, mute_rate * dt_block)
    dist_gain = torch.clamp(1.0 / torch.clamp(dist, min=1.0), max=1.0)
    occ_gain = 1.0 / (1.0 + num_occlusions)
    x = dot3(to_src, l_right[None, :])
    y = dot3(to_src, l_forward[None, :])
    pan = torch.clamp(x / dc, -1.0, 1.0)
    theta = (pan + 1.0) * (math.pi / 4.0)
    behind = y < 0.0
    gain = volume * mute * torch.where(spatial, dist_gain * occ_gain, 1.0)
    occluded = num_occlusions > 0
    if use_hrtf:
        # Direction is in the HRIRs; both channels carry the full gain.
        gl = gain * torch.where(spatial, 1.0, 0.70710678) * active
        gr = gl
        alpha = torch.where(occluded, ALPHA_OCCLUDED, ALPHA_OPEN)
        use_lp = occluded
        zc = dot3(to_src, l_up[None, :])
        ai, ei = quantize_direction(x, y, zc, dist)
        dir_idx = ai * N_EL + ei
    else:
        gl = gain * torch.where(spatial, torch.cos(theta), 0.70710678) * active
        gr = gain * torch.where(spatial, torch.sin(theta), 0.70710678) * active
        shadow = behind & spatial
        alpha = torch.where(occluded, ALPHA_OCCLUDED,
                            torch.where(shadow, ALPHA_SHADOW, ALPHA_OPEN))
        use_lp = occluded | shadow
        dir_idx = torch.zeros((s,), dtype=i32, device=pos.device)
    send_gain = gain * active * spatial.to(f32)

    buf = torch.empty(((nl + SETUP_WORDS) * s,), dtype=f32, device=pos.device)
    v = setup_views(buf, s, nl)
    for name, val in (("eff_delta", eff_delta), ("dop_smooth", dop_smooth), ("mute", mute),
                      ("gain", gain), ("gl", gl), ("gr", gr), ("alpha", alpha),
                      ("send_gain", send_gain), ("dir_idx", dir_idx), ("active", active),
                      ("use_lp", use_lp)):
        v[name].copy_(val)
    return buf


SETUP_NAMES = ("alive", "paused", "finished", "spatial", "pos", "vel", "delta",
               "doppler_factor", "mute_factor", "mute_target", "mute_rate", "volume",
               "num_occlusions", "l_pos", "l_vel", "l_right", "l_forward", "l_up")
# csrc/audio_setup.cu:audio_setup: the 18 input pointers, dop_alpha and
# dt_block as doubles, S, L, use_hrtf, out.
_PACK = struct.Struct("=18q2d4q")
_plans = {}


def _setup_plan(s: int, nl: int, device):
    """The setup's checks for one (S, L, device): its 18 inputs' dtypes and
    shapes in the kernel's order."""
    return (device, (torch.bool,) * 4 + (f32,) * 14,
            ((s,),) * 4 + ((s, 3), (s, 3), (s, nl)) + ((s,),) * 6 + ((3,),) * 5)


def audio_setup(alive, paused, finished, spatial, pos, vel, delta, doppler_factor, mute_factor,
                mute_target, mute_rate, volume, num_occlusions, l_pos, l_vel, l_right,
                l_forward, l_up, dop_alpha: float, dt_block: float, use_hrtf: bool):
    """KAA's setup: ``audio_setup_plain`` for CPU tensors,
    ``csrc/audio_setup.cu`` for CUDA tensors (checked against the plan of
    its (S, L, device), launched from one packed argument).  Returns the
    setup buffer."""
    args = (alive, paused, finished, spatial, pos, vel, delta, doppler_factor, mute_factor,
            mute_target, mute_rate, volume, num_occlusions, l_pos, l_vel, l_right, l_forward,
            l_up)
    if pos.device.type == "cpu":
        return audio_setup_plain(*args, dop_alpha, dt_block, use_hrtf)
    dev = pos.device
    s, nl = delta.shape
    device, dtypes, shapes = build.plan(_plans, (s, nl, dev), lambda: _setup_plan(s, nl, dev))
    build.check_all(device, args, SETUP_NAMES, dtypes, shapes)
    buf = torch.empty(((nl + SETUP_WORDS) * s,), dtype=f32, device=dev)
    build.launch_packed("audio_setup", _PACK.pack(
        *(t.data_ptr() for t in args), float(np.float32(dop_alpha)),
        float(np.float32(dt_block)), s, nl, int(bool(use_hrtf)), buf.data_ptr()))
    launches["audio_setup"] += 1
    return buf

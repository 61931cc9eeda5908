"""The spatial audio mix kernels (KE, KF, KG) and their plain twins.

Replace the device program ``substrata_tpu/audio/mix.py:mix_block``
(:276) with ``_fetch_all`` (:201), in three launches per block:

  KE  audio_fetch           windowed fetch + linear-interp resample of the
                            [S, L] layers, range masks, layer mix, new
                            playheads (mix.py:201-272, :310-316);
  KF  audio_spatialise      one-pole low-pass, 64-tap HRIR FIR per ear (or
                            the pan path), per-source gain ramps, reverb
                            send and level (mix.py:350-403, :412-414, :433);
  KG  audio_downmix_reverb  left/right/send sums over the sources in a fixed
                            order, the 4-line FDN, wet mix, master volume
                            and clip (mix.py:404-431).

Each wrapper runs its ``*_plain`` twin for CPU tensors; for CUDA tensors it
launches ``csrc/audio_mix.cu`` or raises.  The twins repeat the kernels'
operations in the same order (sums over sources, layers and taps run in
index order), so on the card a kernel and its twin agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths.fp import float_mod, fma

launches = {"audio_fetch": 0, "audio_spatialise": 0, "audio_downmix_reverb": 0}

# Householder feedback matrix of the reverb FDN (orthogonal, fully mixing)
# and the send gain into each line; csrc/audio_mix.cu carries the same.
FDN_MIX = np.array([[0.5, 0.5, 0.5, 0.5],
                    [0.5, -0.5, 0.5, -0.5],
                    [0.5, 0.5, -0.5, -0.5],
                    [0.5, -0.5, -0.5, 0.5]], np.float32)
FDN_IN_GAIN = (1.0, 0.8, 0.6, 0.5)
MAX_BLOCK = 1024   # frames per launch of KF (its shared-memory window)
MAX_TAPS = 64

f32, i32 = torch.float32, torch.int32


def _index_sum(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


# ---------------------------------------------------------------------------
# KE: fetch
# ---------------------------------------------------------------------------

def _li_max(nw: int) -> float:
    return float(np.float32(nw * 128 - 1.001))


def audio_fetch_plain(pool, buf_offset, buf_len, playhead, eff_delta, mix_factor,
                      looping, stream_mode, stream_write_head, active,
                      block: int, nw: int):
    """Returns (samples [S, B], new_playhead [S, L]).

    The reference's float32 index arithmetic step for step: wrapped
    playhead, window row ``row0``, in-window position ``li``, its split
    into a 16-sample chunk ``qi`` and offset ``u``, and the lerp weights
    ``1 - |u - k|`` of the two samples around ``u``."""
    dev = pool.device
    n_rows = pool.shape[0] // 128
    lenf = torch.clamp(buf_len.to(f32), min=1.0)                      # [S, L]
    wrap = (looping | stream_mode)[:, None]
    ph = torch.where(wrap, float_mod(playhead, lenf), playhead)
    ph = torch.clamp(ph, min=0.0)
    ph_int = torch.floor(ph).to(i32)
    ph_frac = ph - ph_int.to(f32)
    start_i = buf_offset + torch.minimum(ph_int, torch.clamp(buf_len - 1, min=0))
    row0 = torch.clamp(start_i >> 7, 0, n_rows - nw)

    bf = torch.arange(block, dtype=f32, device=dev)
    ed = eff_delta[..., None]
    li = fma(ed, bf, ph_frac[..., None]) + (start_i - (row0 << 7)).to(f32)[..., None]
    li = torch.clamp(torch.clamp(li, min=0.0), max=_li_max(nw))
    qi = torch.floor(li * (1.0 / 16.0)).to(i32)
    u = li - 16.0 * qi.to(f32)                                        # [0, 16)
    k0 = torch.floor(u)
    w0 = 1.0 - torch.abs(u - k0)
    w1 = 1.0 - torch.abs(u - (k0 + 1.0))
    idx = (row0.to(torch.int64) << 7)[..., None] + 16 * qi.to(torch.int64) + k0.to(torch.int64)
    out = fma(pool[idx + 1], w1, pool[idx] * w0)

    sidx = fma(ed, bf, ph[..., None])                                 # rel. buffer
    t_abs = fma(ed, bf, playhead[..., None])                          # absolute
    in_range = torch.where(stream_mode[:, None, None],
                           t_abs < stream_write_head[:, None, None] - 1.0,
                           looping[:, None, None] | (sidx < lenf[..., None] - 1.0))
    out = out * in_range
    layer_gain = mix_factor * (buf_len > 0)
    samples = out[:, 0] * layer_gain[:, 0:1]
    for j in range(1, out.shape[1]):
        samples = fma(out[:, j], layer_gain[:, j:j + 1], samples)
    samples = samples * active[:, None]

    new_playhead = fma(eff_delta, block, playhead)
    new_playhead = torch.where((looping & ~stream_mode)[:, None],
                               float_mod(new_playhead, lenf), new_playhead)
    return samples, new_playhead


def audio_fetch(pool, buf_offset, buf_len, playhead, eff_delta, mix_factor,
                looping, stream_mode, stream_write_head, active, block: int, nw: int):
    """KE: ``audio_fetch_plain`` for CPU tensors, ``csrc/audio_mix.cu``
    for CUDA tensors."""
    if pool.device.type == "cpu":
        return audio_fetch_plain(pool, buf_offset, buf_len, playhead, eff_delta,
                                 mix_factor, looping, stream_mode, stream_write_head,
                                 active, block, nw)
    dev = pool.device
    s, nl = playhead.shape
    if pool.dim() != 1 or pool.shape[0] % 128 or pool.shape[0] < nw * 128:
        raise ValueError(f"pool: {tuple(pool.shape)} is not a flat multiple of 128 "
                         f"rows holding at least {nw} rows")
    for t, name, dt, shp in (
            (pool, "pool", f32, pool.shape), (buf_offset, "buf_offset", i32, (s, nl)),
            (buf_len, "buf_len", i32, (s, nl)), (playhead, "playhead", f32, (s, nl)),
            (eff_delta, "eff_delta", f32, (s, nl)), (mix_factor, "mix_factor", f32, (s, nl)),
            (looping, "looping", torch.bool, (s,)),
            (stream_mode, "stream_mode", torch.bool, (s,)),
            (stream_write_head, "stream_write_head", f32, (s,)),
            (active, "active", torch.bool, (s,))):
        build.check(t, name, dt, shp, dev)
    samples = torch.empty((s, block), dtype=f32, device=dev)
    new_playhead = torch.empty((s, nl), dtype=f32, device=dev)
    build.launch("audio_fetch", pool, buf_offset, buf_len, playhead, eff_delta,
                 mix_factor, looping, stream_mode, stream_write_head, active,
                 samples, new_playhead, s, nl, block, nw, pool.shape[0] // 128,
                 _li_max(nw))
    launches["audio_fetch"] += 1
    return samples, new_playhead


# ---------------------------------------------------------------------------
# KF: spatialise
# ---------------------------------------------------------------------------

def audio_spatialise_plain(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank,
                           dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain, send_gain,
                           use_hrtf: bool):
    """Returns (wl, wr, ws, lp_out, new_hist, level): the per-source
    left/right contributions ``gain ramp x signal`` [S, B], the reverb send
    ``samples x send_gain`` [S, B] (None without ``send_gain``), the
    low-pass memory, the HRIR history and the block's peak level."""
    s, b = samples.shape
    # One-pole low-pass y[n] = (1 - a) y[n-1] + a x[n], frame by frame;
    # its last value is kept whether or not the source uses it.
    a = 1.0 - alpha
    bx = alpha[:, None] * samples
    y = lp_state
    ys = []
    for n in range(b):
        y = fma(a, y, bx[:, n])
        ys.append(y)
    lp_out = y
    x = torch.where(use_lp[:, None], torch.stack(ys, dim=1), samples)
    if use_hrtf:
        t = bank.shape[-1]
        h = bank.reshape(-1, 2, t)[dir_idx.long()]                   # [S, 2, T]
        x_ext = torch.cat([hrir_hist, x], dim=1)                     # [S, B+T-1]
        conv = []
        for ear in range(2):
            acc = x_ext[:, t - 1:t - 1 + b] * h[:, ear, 0:1]
            for k in range(1, t):
                acc = fma(x_ext[:, t - 1 - k:t - 1 - k + b], h[:, ear, k:k + 1], acc)
            conv.append(acc)
        sig_l = torch.where(spatial[:, None], conv[0], x)
        sig_r = torch.where(spatial[:, None], conv[1], x)
        new_hist = x_ext[:, b:]
    else:
        sig_l = sig_r = x
        new_hist = hrir_hist
    gl_t = fma((gl - prev_gl)[:, None], ramp[None, :], prev_gl[:, None])
    gr_t = fma((gr - prev_gr)[:, None], ramp[None, :], prev_gr[:, None])
    ws = None if send_gain is None else x * send_gain[:, None]
    level = torch.max(torch.abs(x), dim=1).values * gain
    return gl_t * sig_l, gr_t * sig_r, ws, lp_out, new_hist.contiguous(), level


def audio_spatialise(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank, dir_idx,
                     prev_gl, prev_gr, gl, gr, ramp, gain, send_gain, use_hrtf: bool):
    """KF: ``audio_spatialise_plain`` for CPU tensors, one block per source
    of ``csrc/audio_mix.cu`` for CUDA tensors.  ``bank`` and ``dir_idx``
    are read only with ``use_hrtf``; ``send_gain`` None skips the send."""
    if samples.device.type == "cpu":
        return audio_spatialise_plain(samples, lp_state, alpha, use_lp, spatial, hrir_hist,
                                      bank, dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain,
                                      send_gain, use_hrtf)
    dev = samples.device
    s, b = samples.shape
    hl = hrir_hist.shape[1]
    t = hl + 1
    if b > MAX_BLOCK or t > MAX_TAPS:
        raise ValueError(f"KF takes up to {MAX_BLOCK} frames and {MAX_TAPS} taps "
                         f"(got {b}, {t})")
    args = [(samples, "samples", f32, (s, b)), (lp_state, "lp_state", f32, (s,)),
            (alpha, "alpha", f32, (s,)), (use_lp, "use_lp", torch.bool, (s,)),
            (spatial, "spatial", torch.bool, (s,)), (hrir_hist, "hrir_hist", f32, (s, hl)),
            (prev_gl, "prev_gl", f32, (s,)), (prev_gr, "prev_gr", f32, (s,)),
            (gl, "gl", f32, (s,)), (gr, "gr", f32, (s,)), (ramp, "ramp", f32, (b,)),
            (gain, "gain", f32, (s,))]
    if use_hrtf:
        args += [(bank, "bank", f32, tuple(bank.shape[:-2]) + (2, t)),
                 (dir_idx, "dir_idx", i32, (s,))]
    if send_gain is not None:
        args.append((send_gain, "send_gain", f32, (s,)))
    for a in args:
        build.check(*a, dev)
    wl = torch.empty((s, b), dtype=f32, device=dev)
    wr = torch.empty((s, b), dtype=f32, device=dev)
    ws = None if send_gain is None else torch.empty((s, b), dtype=f32, device=dev)
    lp_out = torch.empty((s,), dtype=f32, device=dev)
    new_hist = torch.empty((s, hl), dtype=f32, device=dev)
    level = torch.empty((s,), dtype=f32, device=dev)
    build.launch("audio_spatialise", samples, lp_state, alpha, use_lp, spatial, hrir_hist,
                 bank if use_hrtf else None, dir_idx if use_hrtf else None,
                 prev_gl, prev_gr, gl, gr, ramp, gain, send_gain,
                 wl, wr, ws, lp_out, new_hist, level, s, b, t, int(bool(use_hrtf)))
    launches["audio_spatialise"] += 1
    return wl, wr, ws, lp_out, new_hist, level


# ---------------------------------------------------------------------------
# KG: downmix + reverb
# ---------------------------------------------------------------------------

def audio_downmix_reverb_plain(wl, wr, ws, master_volume, delay_lines=None, write_idx=None,
                               delays=None, feedback=None, wet=None):
    """Returns (out [B, 2], new delay lines, new write index); the last two
    are None without a room (``ws`` None)."""
    s, b = wl.shape
    left = _index_sum(list(wl.unbind(0)))
    right = _index_sum(list(wr.unbind(0)))
    out = torch.stack([left, right], dim=1) * master_volume
    lines = widx = None
    if ws is not None:
        send = _index_sum(list(ws.unbind(0)))
        d = delay_lines.shape[1]
        bi = torch.arange(b, dtype=i32, device=wl.device)
        rpos = torch.remainder(write_idx - delays[:, None] + bi[None, :], d)
        taps = torch.gather(delay_lines, 1, rpos.long())              # [4, B]
        mixed = torch.stack([_index_sum([float(FDN_MIX[r, c]) * taps[c] for c in range(4)])
                             for r in range(4)]) * feedback
        new_vals = torch.stack([fma(send, g, mixed[r]) for r, g in enumerate(FDN_IN_GAIN)])
        wpos = torch.remainder(write_idx + bi, d).long()
        lines = delay_lines.clone()
        lines[:, wpos] = new_vals
        wet_l = (taps[0] + taps[2]) * wet
        wet_r = (taps[1] + taps[3]) * wet
        out = fma(torch.stack([wet_l, wet_r], dim=1), master_volume, out)
        widx = torch.remainder(write_idx + b, d)
    return torch.clamp(out, -1.0, 1.0), lines, widx


def audio_downmix_reverb(wl, wr, ws, master_volume, delay_lines=None, write_idx=None,
                         delays=None, feedback=None, wet=None):
    """KG: ``audio_downmix_reverb_plain`` for CPU tensors,
    ``csrc/audio_mix.cu`` for CUDA tensors.  The room's tensors stay on the
    card: the write index is read and advanced there."""
    if wl.device.type == "cpu":
        return audio_downmix_reverb_plain(wl, wr, ws, master_volume, delay_lines,
                                          write_idx, delays, feedback, wet)
    dev = wl.device
    s, b = wl.shape
    args = [(wl, "wl", f32, (s, b)), (wr, "wr", f32, (s, b)),
            (master_volume, "master_volume", f32, ())]
    room = ws is not None
    d = delay_lines.shape[1] if room else 0
    if room:
        if delay_lines.shape[0] != 4 or b > d:
            raise ValueError(f"delay lines {tuple(delay_lines.shape)}: need 4 lines "
                             f"of at least {b} samples")
        args += [(ws, "ws", f32, (s, b)), (delay_lines, "delay_lines", f32, (4, d)),
                 (write_idx, "write_idx", i32, ()), (delays, "delays", i32, (4,)),
                 (feedback, "feedback", f32, ()), (wet, "wet", f32, ())]
    for a in args:
        build.check(*a, dev)
    out = torch.empty((b, 2), dtype=f32, device=dev)
    lines = torch.empty_like(delay_lines) if room else None
    widx = torch.empty((), dtype=i32, device=dev) if room else None
    build.launch("audio_downmix_reverb", wl, wr, ws, master_volume,
                 delay_lines if room else None, write_idx if room else None,
                 delays if room else None, feedback if room else None,
                 wet if room else None, out, lines, widx, s, b, d, int(room))
    launches["audio_downmix_reverb"] += 1
    return out, lines, widx

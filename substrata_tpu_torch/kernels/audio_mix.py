"""The spatial audio mix kernels (KF, KG) and their plain twins.

Replace the device program ``substrata_tpu/audio/mix.py:mix_block``
(:276) with ``_fetch_all`` (:201), in two launches per block after KAA's
setup:

  KF  audio_spatialise      the windowed fetch + linear-interp resample of
                            the [S, L] layers, range masks, layer mix and
                            new playheads (mix.py:201-272, :310-316; twin
                            ``audio_fetch_plain``, KE's kernel before it
                            was folded in), then the one-pole low-pass,
                            64-tap HRIR FIR per ear (or the pan path),
                            per-source gain ramps, reverb send and level
                            (mix.py:350-403, :412-414, :433; twin
                            ``audio_spatialise_plain``), and KAA's epilogue
                            (the finished flag, the level meter, the alive
                            mask, :320-323, :434-444);
  KG  audio_downmix_reverb  left/right/send sums over the sources in a fixed
                            order, the 4-line FDN, wet mix, master volume
                            and clip (mix.py:404-431).

Each wrapper runs its plain twin for CPU tensors (KF's is
``fetch_spatialise_plain``: the fetch's twin chained into the
spatialiser's); for CUDA tensors it launches ``csrc/audio_mix.cu`` or
raises.  The twins repeat the kernels' operations in the same order (sums
over sources, layers and taps run in index order), so on the card a kernel
and its twin agree to rounding.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths.fp import float_mod, fma

launches = {"audio_spatialise": 0, "audio_downmix_reverb": 0}

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
# The fetch (KF's first part)
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


# ---------------------------------------------------------------------------
# KF: spatialise
# ---------------------------------------------------------------------------

def audio_spatialise_plain(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank,
                           dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain, send_gain,
                           use_hrtf: bool, epilogue):
    """Returns (wl, wr, ws, lp_out, new_hist, level, epilogue buffer): the
    per-source left/right contributions ``gain ramp x signal`` [S, B], the
    reverb send ``samples x send_gain`` [S, B] (None without
    ``send_gain``), the low-pass memory, the HRIR history, the block's
    peak level, and ``audio_epilogue_plain``'s buffer from that level and
    ``epilogue`` (``audio_spatialise``'s)."""
    out = _spatialise_plain(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank,
                            dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain, send_gain, use_hrtf)
    e = epilogue
    return out + (audio_epilogue_plain(*e[:6], out[5], *e[6:]),)


def _spatialise_plain(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank, dir_idx,
                      prev_gl, prev_gr, gl, gr, ramp, gain, send_gain, use_hrtf):
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


def epilogue_views(buf: torch.Tensor, s: int) -> dict:
    """The epilogue buffer's fields: the smoothed level [S] (f32), then
    finished and alive [S] as the next S words' bytes."""
    flags = buf[s:2 * s].view(torch.uint8)
    return {"smoothed_level": buf[:s], "finished": flags[:s].view(torch.bool),
            "alive": flags[s:2 * s].view(torch.bool)}


def audio_epilogue_plain(finished, looping, stream_mode, active, new_heads, buf_len, level,
                         smoothed_level, alive, remove_on_finish):
    """The twin of KF's folded epilogue (KAA's before): the finished
    flags, the smoothed level meter and the alive mask in one buffer of
    2 S words (``epilogue_views``)."""
    s = finished.shape[0]
    # Non-looping sources finish when layer 0 passes the end.
    fin = finished | ((~looping) & (~stream_mode) & active
                      & (new_heads[:, 0] >= buf_len[:, 0].to(f32) - 1.0))
    buf = torch.empty((2 * s,), dtype=f32, device=finished.device)
    v = epilogue_views(buf, s)
    v["smoothed_level"].copy_(fma(level, 0.1, smoothed_level * 0.9))
    v["finished"].copy_(fin)
    v["alive"].copy_(alive & ~(fin & remove_on_finish))
    return buf


FETCH_NAMES = ("pool", "buf_offset", "buf_len", "playhead", "eff_delta", "mix_factor",
               "looping", "stream_mode", "stream_write_head", "active")
EPILOGUE_NAMES = ("finished", "looping", "stream_mode", "active", "new_heads", "buf_len",
                  "smoothed_level", "alive", "remove_on_finish")
# The epilogue's fields KF takes beside the fetch's (which give it the
# looping, streaming and active flags, the lengths and the new heads).
EPILOGUE_OWN = ("finished", "smoothed_level", "alive", "remove_on_finish")
_SPATIALISE_NAMES = ("lp_state", "alpha", "use_lp", "spatial", "hrir_hist", "prev_gl",
                     "prev_gr", "gl", "gr", "ramp", "gain")
MAX_LAYERS = 3      # csrc/audio_mix.cu:kMaxLayers


def fetch_spatialise_plain(fetch, lp_state, alpha, use_lp, spatial, hrir_hist, bank, dir_idx,
                           prev_gl, prev_gr, gl, gr, ramp, gain, send_gain, use_hrtf: bool,
                           epilogue):
    """KF's twin: ``audio_fetch_plain(*fetch)`` chained into
    ``audio_spatialise_plain`` (with the epilogue's ``EPILOGUE_OWN`` fields
    and the fetch's flags, lengths and new heads).  Returns
    ``audio_spatialise_plain``'s seven outputs and the new playheads."""
    samples, heads = audio_fetch_plain(*fetch)
    _, _, buf_len, _, _, _, looping, stream_mode, _, active = fetch[:10]
    finished, smoothed_level, alive, remove_on_finish = epilogue
    out = audio_spatialise_plain(samples, lp_state, alpha, use_lp, spatial, hrir_hist, bank,
                                 dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain, send_gain,
                                 use_hrtf, (finished, looping, stream_mode, active, heads,
                                            buf_len, smoothed_level, alive, remove_on_finish))
    return out + (heads,)


_SPATIALISE_PACK = struct.Struct("=43qd")   # csrc/audio_mix.cu:audio_spatialise
_spatialise_plans: dict = {}


class _SpatialisePlan:
    """KF's checks and output layout for one (S, B, T, L, send, pool
    length, device): the names, dtypes and shapes of the checked inputs
    (the bank and the directions apart: their shapes are the bank's), and
    the split of the one buffer a call allocates: wl, wr (and ws) [S, B];
    lp_out [S], new_hist [S, T - 1], level [S], the epilogue's 2 S words
    (``epilogue_views``) and new_playhead [S, L]."""

    def __init__(self, s, b, t, nl, send, n_pool, device):
        self.device = device
        b8 = torch.bool
        self.names = FETCH_NAMES + _SPATIALISE_NAMES + (("send_gain",) if send else ()) \
            + EPILOGUE_OWN
        self.dtypes = (f32, i32, i32, f32, f32, f32, b8, b8, f32, b8) + (
            f32, f32, b8, b8, f32, f32, f32, f32, f32, f32, f32) + ((f32,) if send else ()) + (
            b8, f32, b8, b8)
        self.shapes = ((n_pool,),) + ((s, nl),) * 5 + ((s,),) * 4 + (
            (s,), (s,), (s,), (s,), (s, t - 1), (s,), (s,), (s,), (s,), (b,), (s,)) + (
            ((s,),) if send else ()) + ((s,),) * 4
        self.sizes = [s * b] * (3 if send else 2) + [s, s * (t - 1), s, 2 * s, s * nl]
        self.n_rows = n_pool // 128


def audio_spatialise(fetch, lp_state, alpha, use_lp, spatial, hrir_hist, bank, dir_idx,
                     prev_gl, prev_gr, gl, gr, ramp, gain, send_gain, use_hrtf: bool,
                     epilogue):
    """KF: ``fetch_spatialise_plain`` for CPU tensors; for CUDA tensors one
    block per source of ``csrc/audio_mix.cu``, which fetches its own
    frames, from one packed argument checked once per shape.

    ``fetch`` is ``audio_fetch_plain``'s arguments (``FETCH_NAMES``, then
    the block and the window rows ``nw``); ``bank`` and ``dir_idx`` are
    read only with ``use_hrtf``; ``send_gain`` None skips the send;
    ``epilogue`` is the mix's (finished, smoothed_level, alive,
    remove_on_finish), the rest of KAA's epilogue folded in.  Returns
    (wl, wr, ws, lp_out, new_hist, level, the epilogue's buffer
    (``epilogue_views``), new_playhead [S, L]), views of one new buffer."""
    if lp_state.device.type == "cpu":
        return fetch_spatialise_plain(fetch, lp_state, alpha, use_lp, spatial, hrir_hist, bank,
                                      dir_idx, prev_gl, prev_gr, gl, gr, ramp, gain, send_gain,
                                      use_hrtf, epilogue)
    if len(fetch) != len(FETCH_NAMES) + 2:
        raise ValueError(f"fetch: {len(FETCH_NAMES)} tensors ({', '.join(FETCH_NAMES)}), "
                         "the block and nw")
    if len(epilogue) != len(EPILOGUE_OWN):
        raise ValueError(f"epilogue: {len(EPILOGUE_OWN)} tensors ({', '.join(EPILOGUE_OWN)})")
    pool, block, nw = fetch[0], fetch[10], fetch[11]
    dev = lp_state.device
    s, nl = lp_state.shape[0], fetch[3].shape[-1]
    b = ramp.shape[0]
    t = hrir_hist.shape[1] + 1
    if b > MAX_BLOCK or t > MAX_TAPS or block != b or not 1 <= nl <= MAX_LAYERS:
        raise ValueError(f"KF takes up to {MAX_BLOCK} frames, {MAX_TAPS} taps and "
                         f"{MAX_LAYERS} layers, the ramp's length the block's "
                         f"(got {b}, {t}, {nl}; block {block})")
    if pool.dim() != 1 or pool.shape[0] % 128 or not 0 < nw * 128 <= pool.shape[0]:
        raise ValueError(f"pool: {tuple(pool.shape)} is not a flat multiple of 128 "
                         f"rows holding at least {nw} rows")
    send = send_gain is not None
    plan = build.plan(_spatialise_plans, (s, b, t, nl, send, pool.shape[0], dev),
                      lambda: _SpatialisePlan(s, b, t, nl, send, pool.shape[0], dev))
    ins = tuple(fetch[:10]) + (lp_state, alpha, use_lp, spatial, hrir_hist, prev_gl, prev_gr,
                               gl, gr, ramp, gain) + ((send_gain,) if send else ()) \
        + tuple(epilogue)
    build.check_all(plan.device, ins, plan.names, plan.dtypes, plan.shapes)
    if use_hrtf:
        build.check(bank, "bank", f32, tuple(bank.shape[:-2]) + (2, t), dev)
        build.check(dir_idx, "dir_idx", i32, (s,), dev)
    out = torch.empty((sum(plan.sizes),), dtype=f32, device=dev).unsafe_split_with_sizes(
        plan.sizes)
    wl, wr = out[0].view(s, b), out[1].view(s, b)
    ws = out[2].view(s, b) if send else None
    lp_out, new_hist, level, ep, heads = out[-5], out[-4].view(s, t - 1), out[-3], out[-2], \
        out[-1].view(s, nl)
    ptrs = [x.data_ptr() for x in ins[:10]] + [x.data_ptr() for x in ins[10:15]] + [
        bank.data_ptr() if use_hrtf else 0, dir_idx.data_ptr() if use_hrtf else 0] + [
        x.data_ptr() for x in (prev_gl, prev_gr, gl, gr, ramp, gain)] + [
        send_gain.data_ptr() if send else 0] + [x.data_ptr() for x in epilogue] + [
        x.data_ptr() if x is not None else 0
        for x in (wl, wr, ws, lp_out, new_hist, level, ep, heads)]
    build.launch_packed("audio_spatialise", _SPATIALISE_PACK.pack(
        *ptrs, s, b, t, nl, nw, plan.n_rows, int(bool(use_hrtf)), _li_max(nw)))
    launches["audio_spatialise"] += 1
    return wl, wr, ws, lp_out, new_hist, level, ep, heads


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


_DOWNMIX_PACK = struct.Struct("=16q")     # csrc/audio_mix.cu:audio_downmix_reverb
_MAX_PLANS = 8
_downmix_plans: dict = {}


class _DownmixPlan:
    """KG's checks and sizes for one (S, B, D, room, device): the input
    shapes, and the layout of the one float32 buffer a call's outputs come
    from (out [B, 2], the new lines [4, D], the write index as an int32)."""

    def __init__(self, s, b, d, room, device):
        if room and b > d:
            raise ValueError(f"delay lines of {d} samples: need at least {b}")
        self.device = device
        self.names = ("wl", "wr", "master_volume") + (
            ("ws", "delay_lines", "write_idx", "delays", "feedback", "wet") if room else ())
        self.dtypes = (f32, f32, f32) + ((f32, f32, i32, i32, f32, f32) if room else ())
        self.shapes = ((s, b), (s, b), ()) + (((s, b), (4, d), (), (4,), (), ()) if room else ())
        self.size = 2 * b + (4 * d + 1 if room else 0)
        self.sizes = (s, b, d, int(room))


def _downmix_plan(s, b, d, room, device):
    key = (s, b, d, room, device)
    plan = _downmix_plans.get(key)
    if plan is None:
        if len(_downmix_plans) >= _MAX_PLANS:
            _downmix_plans.pop(next(iter(_downmix_plans)))
        plan = _downmix_plans[key] = _DownmixPlan(s, b, d, room, device)
    return plan


def audio_downmix_reverb(wl, wr, ws, master_volume, delay_lines=None, write_idx=None,
                         delays=None, feedback=None, wet=None):
    """KG: ``audio_downmix_reverb_plain`` for CPU tensors,
    ``csrc/audio_mix.cu`` for CUDA tensors: checked once per (S, B, D) and
    launched from one packed argument buffer; the outputs are views of one
    new buffer.  The room's tensors stay on the card: the write index is
    read and advanced there."""
    if wl.device.type == "cpu":
        return audio_downmix_reverb_plain(wl, wr, ws, master_volume, delay_lines,
                                          write_idx, delays, feedback, wet)
    room = ws is not None
    s, b = wl.shape
    if room and (delay_lines.dim() != 2 or delay_lines.shape[0] != 4):
        raise ValueError(f"delay lines {tuple(delay_lines.shape)}: need 4 lines")
    plan = _downmix_plan(s, b, delay_lines.shape[1] if room else 0, room, wl.device)
    ins = (wl, wr, master_volume) + (
        (ws, delay_lines, write_idx, delays, feedback, wet) if room else ())
    build.check_all(plan.device, ins, plan.names, plan.dtypes, plan.shapes)
    buf = torch.empty((plan.size,), dtype=f32, device=plan.device)
    out = buf[:2 * b].view(b, 2)
    lines = widx = None
    room_ptrs = [0] * 6
    if room:
        d = plan.sizes[2]
        lines = buf[2 * b:2 * b + 4 * d].view(4, d)
        widx = buf[2 * b + 4 * d:].view(i32).reshape(())
        room_ptrs = [t.data_ptr() for t in ins[3:]]
    ptrs = (wl.data_ptr(), wr.data_ptr(), room_ptrs[0], master_volume.data_ptr(), *room_ptrs[1:],
            out.data_ptr(), 0 if lines is None else lines.data_ptr(),
            0 if widx is None else widx.data_ptr())
    build.launch_packed("audio_downmix_reverb", _DOWNMIX_PACK.pack(*ptrs, *plan.sizes))
    launches["audio_downmix_reverb"] += 1
    return out, lines, widx

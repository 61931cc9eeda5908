"""Sample-rate conversion (a numpy copy of ``substrata_tpu/audio/resampler.py``).

Reference: audio/AudioResampler.{h,cpp} — a streaming linear resampler used
per-source before Resonance (AudioEngine.cpp:382-494 numSrcSamplesNeeded /
resample).  In this engine the *streaming* per-source resampling happens
inside the mix kernel (playhead delta); this module provides the offline
load-time conversion (windowed-sinc for quality, linear for speed) plus a
streaming host-side class with the reference's API shape for parity.
"""

from __future__ import annotations

import numpy as np


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate:
        return x
    n_out = int(round(len(x) * dst_rate / src_rate))
    t = np.arange(n_out) * (src_rate / dst_rate)
    i0 = np.minimum(t.astype(np.int64), len(x) - 1)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = (t - i0).astype(np.float32)
    return (x[i0] * (1 - frac) + x[i1] * frac).astype(np.float32)


def resample(x: np.ndarray, src_rate: int, dst_rate: int, taps: int = 16) -> np.ndarray:
    """Windowed-sinc (Hann) polyphase resampling; falls back to linear for
    tiny inputs."""
    if src_rate == dst_rate:
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float32)
    if len(x) < taps * 2:
        return resample_linear(x, src_rate, dst_rate)
    ratio = dst_rate / src_rate
    n_out = int(round(len(x) * ratio))
    t = np.arange(n_out) / ratio                    # fractional src positions
    i0 = t.astype(np.int64)
    frac = t - i0
    half = taps // 2
    xp = np.pad(x, (half, half + 1))
    # Anti-aliasing cutoff for downsampling.
    cutoff = min(1.0, ratio) * 0.95
    k = np.arange(-half + 1, half + 1)[None, :]     # [1, taps]
    arg = (k - frac[:, None])                       # [n_out, taps]
    sinc = np.sinc(arg * cutoff) * cutoff
    window = 0.5 + 0.5 * np.cos(np.pi * np.clip(arg / half, -1, 1))
    kern = (sinc * window).astype(np.float32)
    idx = i0[:, None] + k + half
    out = np.einsum("ot,ot->o", xp[idx], kern)
    return out.astype(np.float32)


class AudioResampler:
    """Streaming API parity with audio/AudioResampler.h: the caller asks how
    many source samples the next output block needs, then feeds exactly
    that many."""

    def __init__(self, src_rate: int, dst_rate: int):
        self.src_rate = src_rate
        self.dst_rate = dst_rate
        self._frac_pos = 0.0
        self._last = np.zeros(1, np.float32)

    def num_src_samples_needed(self, n_out: int) -> int:
        end = self._frac_pos + n_out * (self.src_rate / self.dst_rate)
        return max(0, int(np.ceil(end)) - 0)

    def resample(self, src: np.ndarray, n_out: int) -> np.ndarray:
        """Consume src (>= num_src_samples_needed(n_out)) and produce n_out
        samples, carrying fractional position across calls."""
        buf = np.concatenate([self._last, np.asarray(src, np.float32)])
        t = self._frac_pos + np.arange(n_out) * (self.src_rate / self.dst_rate) + 1.0
        i0 = np.minimum(t.astype(np.int64), len(buf) - 1)
        i1 = np.minimum(i0 + 1, len(buf) - 1)
        frac = (t - i0).astype(np.float32)
        out = buf[i0] * (1 - frac) + buf[i1] * frac
        consumed = t[-1] + (self.src_rate / self.dst_rate) - 1.0
        whole = int(consumed)
        self._frac_pos = float(consumed - whole)
        self._last = buf[whole:whole + 1] if whole < len(buf) else buf[-1:]
        return out.astype(np.float32)

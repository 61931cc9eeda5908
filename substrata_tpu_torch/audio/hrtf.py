"""HRIR bank for binaural spatialisation.

Counterpart of ``substrata_tpu/audio/hrtf.py``, with its own copy of the
measured SADIE Subject_002 asset (order-3 ACN/SN3D spherical-harmonic
HRIRs, 16 channels x 256 taps at 48 kHz, in ``audio/assets/``).  The bank
is built in numpy exactly as the reference builds it: each grid direction
projects the SH HRIRs with real spherical harmonics, the right ear takes
the left-right mirror fold, and the whole bank is RMS-normalised.  When the
asset is missing the analytic spherical-head model (Brown & Duda 1998)
stands in, as in the reference.

Bank layout: [N_AZ, N_EL, 2 ears, TAPS] f32, azimuth over the full circle
(0 = front, positive = right), elevation over [-45, +45] deg.
``quantize_direction`` maps head-frame offsets to bank indices in torch.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from substrata_tpu_torch.maths.fp import float_mod, fma, recip, sqrt

N_AZ = 16
N_EL = 3
HEAD_RADIUS = 0.0875       # m (average human head)
SPEED_OF_SOUND = 343.0
RATE = 48_000

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "assets", "sadie_sh_hrir.npz")
_HAS_MEASURED = os.path.exists(_ASSET)
# Measured responses: 64 taps hold >= 99% of the rendered energy (window
# [8, 72) of the 256-tap SH HRIRs).  The analytic fallback keeps 48.
TAPS = 64 if _HAS_MEASURED else 48
_MEASURED_WINDOW_START = 8


def _ear_response(az: float, el: float, ear_sign: float) -> np.ndarray:
    """Analytic-fallback FIR taps for one ear via frequency sampling of the
    spherical-head model.  az/el radians; ear_sign +1 = right ear, -1 = left."""
    ear_az = ear_sign * np.pi / 2.0
    cos_inc = np.cos(el) * np.cos(az - ear_az)
    theta = np.arccos(np.clip(cos_inc, -1.0, 1.0))  # 0 = straight at ear

    # Woodworth ITD: extra path length around the head to the far ear.
    rel = az - ear_az
    rel = (rel + np.pi) % (2 * np.pi) - np.pi
    a = HEAD_RADIUS
    extra = np.where(np.abs(rel) < np.pi / 2,
                     a * (1.0 - np.cos(rel)),
                     a * (1.0 + np.abs(rel) - np.pi / 2))
    delay_s = min(extra / SPEED_OF_SOUND, (TAPS - 16) / RATE)

    # Brown-Duda head shadow with a(theta) in [0.1, 2].
    alpha = 1.05 + 0.95 * np.cos(theta * (180.0 / 150.0))
    w0 = SPEED_OF_SOUND / HEAD_RADIUS
    nfft = 128
    w = 2.0 * np.pi * np.fft.rfftfreq(nfft, 1.0 / RATE)
    h = (1.0 + 1j * alpha * w / (2.0 * w0)) / (1.0 + 1j * w / (2.0 * w0))

    # Elevation shelf and the fractional interaural delay (+1.5 samples of
    # causal headroom shared by both ears).
    shelf = 1.0 + 0.25 * np.sin(el) * (w / (w[-1] + 1e-9))
    h = h * shelf * np.exp(-1j * w * (delay_s + 1.5 / RATE))

    taps = np.fft.irfft(h, nfft)[:TAPS]
    win = np.ones(TAPS)
    win[TAPS // 2:] = 0.5 * (1 + np.cos(np.linspace(0, np.pi, TAPS - TAPS // 2)))
    return (taps * win).astype(np.float32)


def _sh_ambix_order3(az: float, el: float) -> np.ndarray:
    """Real spherical harmonics, ACN order / SN3D normalisation (AmbiX),
    through order 3.  az counter-clockwise from front (+ = left), el up."""
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    return np.array([
        1.0,
        sa * ce, se, ca * ce,
        np.sqrt(3) / 2 * np.sin(2 * az) * ce * ce,
        np.sqrt(3) / 2 * sa * np.sin(2 * el),
        0.5 * (3 * se * se - 1),
        np.sqrt(3) / 2 * ca * np.sin(2 * el),
        np.sqrt(3) / 2 * np.cos(2 * az) * ce * ce,
        np.sqrt(5 / 8) * np.sin(3 * az) * ce ** 3,
        np.sqrt(15) / 2 * np.sin(2 * az) * se * ce * ce,
        np.sqrt(3 / 8) * sa * ce * (5 * se * se - 1),
        0.5 * se * (5 * se * se - 3),
        np.sqrt(3 / 8) * ca * ce * (5 * se * se - 1),
        np.sqrt(15) / 2 * np.cos(2 * az) * se * ce * ce,
        np.sqrt(5 / 8) * np.cos(3 * az) * ce ** 3,
    ], np.float32)


# Left->right mirror: negate the sin-azimuth (m < 0) SH components.
_MIRROR = np.array([1, -1, 1, 1, -1, -1, 1, 1, 1,
                    -1, -1, -1, 1, 1, 1, 1], np.float32)


def _measured_bank() -> np.ndarray:
    d = np.load(_ASSET)
    sh = d["sh_hrir"].astype(np.float32)          # [16, 256]
    if int(d["rate"]) != RATE:
        raise ValueError("SADIE asset must be 48 kHz")
    w0 = _MEASURED_WINDOW_START
    bank = np.zeros((N_AZ, N_EL, 2, TAPS), np.float32)
    azs = np.linspace(0, 2 * np.pi, N_AZ, endpoint=False)   # + = RIGHT (ours)
    els = np.linspace(-np.pi / 4, np.pi / 4, N_EL)
    for i, az in enumerate(azs):
        for j, el in enumerate(els):
            y = _sh_ambix_order3(-az, el)         # AmbiX + = left
            left = (y[:, None] * sh).sum(0)
            right = ((y * _MIRROR)[:, None] * sh).sum(0)
            bank[i, j, 0] = left[w0:w0 + TAPS]
            bank[i, j, 1] = right[w0:w0 + TAPS]
    return bank


_BANK = None
_BANK_ON: dict = {}


def hrir_bank() -> np.ndarray:
    """[N_AZ, N_EL, 2, TAPS] FIR bank (built once; measured SADIE data when
    the asset ships, analytic spherical-head fallback otherwise)."""
    global _BANK
    if _BANK is None:
        if _HAS_MEASURED:
            bank = _measured_bank()
        else:
            bank = np.zeros((N_AZ, N_EL, 2, TAPS), np.float32)
            azs = np.linspace(0, 2 * np.pi, N_AZ, endpoint=False)
            els = np.linspace(-np.pi / 4, np.pi / 4, N_EL)
            for i, az in enumerate(azs):
                for j, el in enumerate(els):
                    bank[i, j, 0] = _ear_response(az, el, -1.0)  # left
                    bank[i, j, 1] = _ear_response(az, el, +1.0)  # right
        # Normalise overall energy so HRTF on/off is level-matched.
        rms = np.sqrt((bank ** 2).sum(axis=-1, keepdims=True).mean())
        _BANK = bank / max(rms, 1e-6) * 0.7071
    return _BANK


def hrir_bank_tensor(device) -> torch.Tensor:
    """The bank as a contiguous f32 tensor on ``device`` (one upload per
    device, made the first time the device asks)."""
    dev = torch.device(device)
    if dev not in _BANK_ON:
        _BANK_ON[dev] = torch.as_tensor(hrir_bank(), device=dev).contiguous()
    return _BANK_ON[dev]


def quantize_direction(x, y, z, dist=None):
    """Map head-frame direction components to (az_idx, el_idx) int32.

    x = right, y = forward, z = up components of the source offset.  The
    reference's operations as its jitted program rounds them: the
    horizontal length is ``sqrt(fma(x, x, y * y))`` correctly rounded,
    the divisions by 2 pi and pi / 2 are multiplies by their float32
    reciprocals, rounding is half to even and the modulo is jnp.mod's.
    Only atan2 can part from the reference's in the last bit, which moves
    a bin only where the pre-round value lies on a half-integer."""
    az = torch.atan2(x, y)                       # 0 front, +right
    el = torch.atan2(z, torch.clamp(sqrt(fma(x, x, y * y)), min=1e-6))
    ai = float_mod(torch.round(az * recip(2 * math.pi) * N_AZ), float(N_AZ)).to(torch.int32)
    ei = torch.clamp(torch.round((el + math.pi / 4) * recip(math.pi / 2) * (N_EL - 1)),
                     0, N_EL - 1).to(torch.int32)
    return ai, ei

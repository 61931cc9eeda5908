"""substrata_tpu_torch.audio.hrtf against substrata_tpu.audio.hrtf: the
port's own copy of the SADIE asset, the HRIR bank built from it, and the
direction quantiser."""

import os

import numpy as np
import torch

from substrata_tpu.audio import hrtf as jhrtf
from substrata_tpu_torch.audio import hrtf as thrtf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_asset_copy_is_byte_equal():
    with open(os.path.join(REPO, "substrata_tpu", "audio", "assets", "sadie_sh_hrir.npz"),
              "rb") as f:
        ref = f.read()
    with open(thrtf._ASSET, "rb") as f:
        port = f.read()
    assert port == ref
    assert thrtf._HAS_MEASURED and thrtf.TAPS == jhrtf.TAPS == 64


def test_bank_equals_reference_exactly():
    port, ref = thrtf.hrir_bank(), jhrtf.hrir_bank()
    assert port.dtype == ref.dtype == np.float32
    assert port.shape == ref.shape == (thrtf.N_AZ, thrtf.N_EL, 2, thrtf.TAPS)
    assert np.array_equal(port, ref)
    dev = thrtf.hrir_bank_tensor("cpu")
    assert dev.dtype == torch.float32 and np.array_equal(dev.numpy(), ref)


def test_quantize_direction_matches_reference():
    """10,000 seeded head-frame offsets, kept where both bin coordinates
    are at least 1e-3 of a bin from a rounding edge (there atan2 may round
    differently by an ulp in the two libraries)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    v = rng.normal(size=(10_000, 3)).astype(np.float32) * rng.uniform(0.1, 40, (10_000, 1)).astype(np.float32)
    x, y, z = (v[:, i].astype(np.float64) for i in range(3))
    az_bins = np.arctan2(x, y) / (2 * np.pi) * thrtf.N_AZ
    el = np.arctan2(z, np.maximum(np.hypot(x, y), 1e-6))
    el_bins = (el + np.pi / 4) / (np.pi / 2) * (thrtf.N_EL - 1)
    away = ((np.abs(az_bins - np.floor(az_bins) - 0.5) > 1e-3)
            & (np.abs(el_bins - np.floor(el_bins) - 0.5) > 1e-3))
    assert away.sum() > 9_000
    dist = np.linalg.norm(v, axis=1)
    jai, jei = jhrtf.quantize_direction(*(jnp.asarray(c) for c in (v[:, 0], v[:, 1], v[:, 2], dist)))
    tai, tei = thrtf.quantize_direction(*(torch.as_tensor(c) for c in (v[:, 0], v[:, 1], v[:, 2], dist)))
    assert tai.dtype == tei.dtype == torch.int32
    assert np.array_equal(tai.numpy()[away], np.asarray(jai)[away])
    assert np.array_equal(tei.numpy()[away], np.asarray(jei)[away])
    # Every bin of the grid is reached.
    assert len(set(zip(tai.numpy().tolist(), tei.numpy().tolist()))) == thrtf.N_AZ * thrtf.N_EL

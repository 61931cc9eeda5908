"""Spatial audio: the per-block mix (``mix.mix_block``: fetch + resample,
HRIR spatialisation, downmix + room reverb, on the card through kernels
KE, KF and KG) and the host-side ``AudioEngine`` around it.  Counterpart of
``substrata_tpu/audio``."""

from substrata_tpu_torch.audio.engine import AudioEngine, AudioSource  # noqa: F401
from substrata_tpu_torch.audio.readers import SoundFile, read_wav  # noqa: F401

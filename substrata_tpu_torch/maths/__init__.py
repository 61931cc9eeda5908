"""Quaternion and transform helpers over trailing-dim tensors."""

from substrata_tpu_torch.maths import quat  # noqa: F401
from substrata_tpu_torch.maths import transform  # noqa: F401

"""Where the port's state lives.

Every entry point (``PhysicsWorld``, ``AudioEngine``) runs on the card
unless the caller asks for the CPU; the internal factories take the device
as a required keyword.  Asking for CUDA where there is none raises: the
port never falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is False; "
            "pass device=\"cpu\" to run on the CPU")
    return dev

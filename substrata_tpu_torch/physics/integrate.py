"""Forces, integration and sleeping.

Counterpart of ``substrata_tpu/physics/integrate.py``.  ``apply_forces``
and ``integrate_positions`` are the Triton kernel KD
(``kernels/integrate_triton.py``, plain twins beside them);
sleeping is kernel KV's ``sleep_pass`` (``kernels/sleep.py``, which the
step calls; the reference's ``update_sleeping`` is its twin's core,
``update_sleeping_plain``).
"""

from __future__ import annotations

from substrata_tpu_torch.kernels.integrate_triton import (  # noqa: F401
    apply_forces, apply_forces_plain, integrate_positions,
    integrate_positions_plain,
)

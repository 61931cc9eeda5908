"""substrata_tpu_torch — the PyTorch/CUDA port of substrata_tpu.

The same SoA physics tick as ``substrata_tpu`` (which stays the reference),
written as plain PyTorch functions on tensors, with hand-written Hopper
kernels (``csrc/*.cu`` built by ``kernels/build.py``, and Triton in
``kernels/integrate_triton.py``) on the step's hot path.  A kernel wrapper
runs its plain PyTorch twin only for tensors that lie on the CPU; for a
CUDA tensor it launches the kernel or raises.

This package imports torch and numpy, never jax, flax or substrata_tpu.
"""

__version__ = "0.1.0"

from substrata_tpu_torch.physics.world import PhysicsWorld, PhysicsObject  # noqa: F401
from substrata_tpu_torch.physics.state import MotionType, ShapeType, SimConfig  # noqa: F401

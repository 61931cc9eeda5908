"""Skeletal animation: skeletons, clip banks, batched pose evaluation.

Counterpart of ``substrata_tpu/anim``: clips are resampled to a uniform
frame rate at load (sampling = two row gathers + nlerp), and ALL avatars'
skeletons are posed by one launch of kernel KZ per tick (sample -> blend
-> procedural overrides -> level-order forward kinematics -> skinning
matrices).
"""

from substrata_tpu_torch.anim.skeleton import Skeleton, build_default_humanoid
from substrata_tpu_torch.anim.clips import AnimationClip, ClipBank, CLIP_RATE
from substrata_tpu_torch.anim.pose import PoseKernel, PROC_SLOTS

__all__ = [
    "Skeleton", "build_default_humanoid",
    "AnimationClip", "ClipBank", "CLIP_RATE",
    "PoseKernel", "PROC_SLOTS",
]

"""Batched skeletal pose evaluation: every avatar in one launch (kernel KZ,
``kernels/pose.py``).

Counterpart of ``substrata_tpu/anim/pose.py`` (K15, ``PoseKernel._pose``
:182-241, jitted at :160).  Per avatar: sample clip A and clip B at their
fractional frames (wrap for a looping clip, clamp otherwise), nlerp between
the two frames, cross-fade A -> B by the blend weight; procedural rotation
overrides at the 18 named slots; finger-grab curls; local TRS matrices;
post-multiplied procedural transforms at the slots; level-order forward
kinematics; the root; skin = FK @ inverse bind.

``PoseKernel.__call__`` runs kernel KZ on the card and its plain twin on
the CPU (``kernels/pose.py``); this module holds the host side: the
parameters, their packing, the static rig tensors and the grab poses.

``pose_all``'s inputs travel as ONE packed host buffer (``pack_params``,
one pinned host -> device copy) and the three outputs come back in one
[3, A, J, 4, 4] tensor (one device -> host copy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from substrata_tpu_torch.anim.clips import ClipBank
from substrata_tpu_torch.anim.skeleton import Skeleton, _quat_mul_np, axis_angle_quat_np
from substrata_tpu_torch.kernels import pose as kz
from substrata_tpu_torch.kernels.pose import NUM_SLOTS, PARAM_LAYOUT, TORCH_DTYPE, Rig

# Named joints that procedural overrides / post-transforms can target.
# Order is the slot index used in PoseParams.override_* / post_*.
PROC_SLOTS = (
    "Hips", "Spine2", "Neck", "Head", "LeftEye", "RightEye",
    "LeftUpLeg", "RightUpLeg", "LeftLeg", "RightLeg", "LeftFoot",
    "RightFoot", "LeftArm", "RightArm", "LeftForeArm", "RightForeArm",
    "LeftHand", "RightHand",
)


@dataclasses.dataclass
class PoseParams:
    """Per-avatar pose inputs, batched on a leading avatar axis."""

    clip_a: torch.Tensor         # [A] i32: outgoing clip
    clip_b: torch.Tensor         # [A] i32: incoming/current clip
    frame_a: torch.Tensor        # [A] f32 fractional frame into clip_a
    frame_b: torch.Tensor        # [A] f32
    blend: torch.Tensor          # [A] f32 weight of clip_b (1 = fully b)
    grab_l: torch.Tensor         # [A] f32 0..1 left-hand finger curl
    grab_r: torch.Tensor         # [A] f32
    root: torch.Tensor           # [A, 4, 4] object -> world
    override_rot: torch.Tensor   # [A, S, 4] replaces sampled local rotation
    post_rot: torch.Tensor       # [A, S, 4] post-multiplied rotation
    override_mask: torch.Tensor  # [A, S] bool
    post_mask: torch.Tensor      # [A, S] bool

    @property
    def count(self) -> int:
        return self.clip_a.shape[0]


def _offsets(n: int):
    off, out = 0, []
    for name, dt, shp in PARAM_LAYOUT:
        size = n * int(np.prod(shp, dtype=np.int64)) * np.dtype(dt).itemsize
        out.append((name, dt, shp, off, size))
        off += (size + 3) // 4 * 4
    return out, off


def zero_pose_arrays(n: int) -> dict:
    """Numpy arrays of ``n`` neutral avatars (clip 0 at frame 0, blend 1, no
    overrides, identity root), in ``PARAM_LAYOUT`` order."""
    ident_q = np.tile(np.array([0, 0, 0, 1], np.float32), (n, NUM_SLOTS, 1))
    return dict(clip_a=np.zeros(n, np.int32), clip_b=np.zeros(n, np.int32),
                frame_a=np.zeros(n, np.float32), frame_b=np.zeros(n, np.float32),
                blend=np.ones(n, np.float32), grab_l=np.zeros(n, np.float32),
                grab_r=np.zeros(n, np.float32),
                root=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
                override_rot=ident_q, post_rot=ident_q.copy(),
                override_mask=np.zeros((n, NUM_SLOTS), bool),
                post_mask=np.zeros((n, NUM_SLOTS), bool))


def pack_params(arrays: dict) -> np.ndarray:
    """The fields of ``arrays`` (numpy, keyed as PoseParams) in one uint8
    host buffer, laid out by ``PARAM_LAYOUT``."""
    n = len(arrays["clip_a"])
    fields, total = _offsets(n)
    buf = np.zeros(total, np.uint8)
    for name, dt, shp, off, size in fields:
        buf[off:off + size] = np.ascontiguousarray(arrays[name], dt).reshape(-1).view(np.uint8)
    return buf


def params_from_packed(buf: torch.Tensor, n: int) -> PoseParams:
    """PoseParams as views into one packed uint8 tensor (``pack_params``)."""
    fields, total = _offsets(n)
    if buf.dtype != torch.uint8 or buf.numel() != total:
        raise ValueError(f"packed pose params: {buf.dtype} x {buf.numel()}, expected "
                         f"uint8 x {total} for {n} avatars")
    out = {}
    for name, dt, shp, off, size in fields:
        out[name] = buf[off:off + size].view(TORCH_DTYPE[dt]).view((n,) + shp)
    return PoseParams(**out)


def pose_params_from_arrays(arrays: dict, *, device) -> PoseParams:
    """PoseParams on ``device`` from numpy arrays (one copy)."""
    n = len(arrays["clip_a"])
    return params_from_packed(torch.as_tensor(pack_params(arrays), device=device), n)


def zero_pose_params(n: int, *, device) -> PoseParams:
    return pose_params_from_arrays(zero_pose_arrays(n), device=device)


# Grab finger poses (AvatarGraphics.cpp:512-568): absolute local rotations
# that REPLACE the animation rotation while gripping.  Finger segments 1-3
# bend around local X by 1.0/0.7/1.2 rad; thumbs get bespoke rotations
# (mirrored z for the right hand).
def _grab_quats(side_sign: float) -> np.ndarray:
    def q(*aas):
        out = np.array([0, 0, 0, 1], np.float32)
        for axis, ang in aas:
            out = _quat_mul_np(out, axis_angle_quat_np(axis, ang))
        return out

    s = side_sign
    j1, j2, j3 = 1.0, 0.7, 1.2
    rows = [q(((0, 0, 1), 0.5 * s), ((1, 0, 0), 0.9)),       # Thumb1
            q(((0, 0, 1), -0.2 * s)),                         # Thumb2
            q(((1, 0, 0), 0.9), ((0, 0, 1), -1.1 * s))]       # Thumb3
    for _f in ("Index", "Middle", "Ring", "Pinky"):
        rows += [q(((1, 0, 0), j1)), q(((1, 0, 0), j2)), q(((1, 0, 0), j3))]
    return np.stack(rows)


def _finger_joint_indices(skel: Skeleton, side: str) -> np.ndarray:
    names = []
    for f in ("Thumb", "Index", "Middle", "Ring", "Pinky"):
        names += [f"{side}Hand{f}{k}" for k in (1, 2, 3)]
    return np.array([skel.joint_index(n) for n in names], np.int32)


def build_rig(skeleton: Skeleton, *, device) -> Rig:
    nj = skeleton.num_joints
    slot = np.full(nj, -1, np.int32)
    for s, name in enumerate(PROC_SLOTS):
        j = skeleton.joint_index(name)
        if j >= 0:
            slot[j] = s
    finger = np.full(nj, -1, np.int32)
    fl = _finger_joint_indices(skeleton, "Left")
    fr = _finger_joint_indices(skeleton, "Right")
    if (fl >= 0).all() and (fr >= 0).all():
        finger[fl] = np.arange(len(fl))
        finger[fr] = len(fl) + np.arange(len(fr))
    levels = skeleton.levels()
    depth = np.zeros(nj, np.int32)
    for d, lvl in enumerate(levels):
        depth[lvl] = d
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return Rig(parent=t(skeleton.parents, torch.int32), depth=t(depth, torch.int32),
               joint_slot=t(slot), joint_finger=t(finger),
               grab_quats=t(np.concatenate([_grab_quats(+1.0), _grab_quats(-1.0)]),
                            torch.float32),
               rest_scale=t(skeleton.rest_scale, torch.float32),
               inverse_bind=t(skeleton.inverse_bind, torch.float32),
               levels=[(t(lvl.astype(np.int64)), t(skeleton.parents[lvl].astype(np.int64)))
                       for lvl in levels[1:] if len(lvl)],
               n_levels=len(levels))


class PoseKernel:
    """Pose evaluator for one (skeleton, clip bank) pair, on the bank's
    device.

    __call__(params) -> (joints_obj [A,J,4,4] object-space hierarchical
    transforms, joints_world [A,J,4,4] with the root applied, skin
    [A,J,4,4] skinning matrices = joints_obj @ inverse_bind), views of one
    [3, A, J, 4, 4] tensor (``call_packed``)."""

    def __init__(self, skeleton: Skeleton, bank: ClipBank):
        self.skeleton = skeleton
        self.bank = bank
        self.num_joints = skeleton.num_joints
        self.rig = build_rig(skeleton, device=bank.rot.device)

    def call_packed(self, params: PoseParams) -> torch.Tensor:
        return kz.pose(self.bank, self.rig, params)

    def __call__(self, params: PoseParams):
        out = self.call_packed(params)
        return out[0], out[1], out[2]

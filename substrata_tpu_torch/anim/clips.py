"""Animation clips + the packed device clip bank.

The reference samples keyframed GLB channels per node at play time
(glare-core AnimationData, consumed by OpenGLEngine's skinned-mesh path;
AvatarGraphics.cpp drives WHICH anim plays).  Keyframe search is a
per-channel binary search — hostile to a batched device kernel — so here
every clip is resampled to a uniform CLIP_RATE at load: sampling becomes
two row gathers + a lerp, identical cost for every clip and avatar.

Bank layout: rot [(C*F_cap), J*4] and trans [(C*F_cap), J*3] — 2-D
operands gathered by FLAT row index (clip * F_cap + frame), the fast TPU
gather layout (repo design rules).

Also provides the procedurally-authored default locomotion/gesture set
for the default humanoid rig (the reference ships these as .subanim files
converted from Mixamo GLBs — AvatarGraphics::processAnimationData; the
curves here are hand-authored equivalents so the engine animates with no
external assets).

A copy of ``substrata_tpu/anim/clips.py`` whose bank lives in torch tensors
on a chosen device (the authoring helpers are the reference's numpy code).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

import torch

from substrata_tpu_torch.anim.skeleton import Skeleton, _quat_mul_np, build_default_humanoid

CLIP_RATE = 24.0   # frames/s after resampling

# Cycle periods measured by the reference (AvatarGraphics.h:146-147).
WALK_CYCLE_PERIOD = 1.015
RUN_CYCLE_PERIOD = 0.7


@dataclass
class AnimationClip:
    name: str
    rot: np.ndarray      # [F, J, 4] local joint rotations (xyzw)
    trans: np.ndarray    # [F, J, 3] local joint translations
    looping: bool = True

    @property
    def num_frames(self) -> int:
        return self.rot.shape[0]

    @property
    def duration(self) -> float:
        return self.num_frames / CLIP_RATE


class ClipBank:
    """Clips packed into device tensors; host maps names to indices.
    ``n_frames_host`` keeps the frame counts on the host, so choosing a
    frame reads nothing back."""

    def __init__(self, skeleton: Skeleton, clips: list, *, device):
        self.skeleton = skeleton
        self.names = [c.name for c in clips]
        self.index = {c.name: i for i, c in enumerate(clips)}
        nj = skeleton.num_joints
        self.f_cap = max(c.num_frames for c in clips)
        c_n = len(clips)
        rot = np.zeros((c_n, self.f_cap, nj, 4), np.float32)
        trans = np.zeros((c_n, self.f_cap, nj, 3), np.float32)
        for i, c in enumerate(clips):
            assert c.rot.shape[1] == nj, \
                f"clip {c.name} has {c.rot.shape[1]} joints, rig has {nj}"
            f = c.num_frames
            rot[i, :f] = c.rot
            trans[i, :f] = c.trans
            rot[i, f:] = c.rot[-1]      # clamp pad (only read by non-loop)
            trans[i, f:] = c.trans[-1]
        self.n_frames_host = np.array([c.num_frames for c in clips], np.float32)
        self.rot = torch.as_tensor(rot.reshape(c_n * self.f_cap, nj * 4), device=device)
        self.trans = torch.as_tensor(trans.reshape(c_n * self.f_cap, nj * 3), device=device)
        self.n_frames = torch.as_tensor(self.n_frames_host, device=device)
        self.looping = torch.as_tensor(np.array([c.looping for c in clips]), device=device)
        self.durations = {c.name: c.duration for c in clips}

    def clip_index(self, name: str) -> int:
        return self.index.get(name, 0)


# ---------------------------------------------------------------------------
# Procedural authoring helpers


class _ClipBuilder:
    def __init__(self, skel: Skeleton, n_frames: int, looping=True):
        self.skel = skel
        self.n = n_frames
        self.looping = looping
        nj = skel.num_joints
        self.rot = np.tile(skel.rest_rot[None], (n_frames, 1, 1)).copy()
        self.trans = np.tile(skel.rest_trans[None], (n_frames, 1, 1)).copy()
        self.phase = (np.arange(n_frames) / n_frames if looping
                      else np.arange(n_frames) / max(n_frames - 1, 1))

    def rotate(self, joint: str, axis, angles):
        """Compose a per-frame axis-angle rotation onto a joint's rest
        rotation.  angles: scalar or [F]."""
        j = self.skel.joint_index(joint)
        if j < 0:
            return
        angles = np.broadcast_to(np.asarray(angles, np.float64), (self.n,))
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        h = 0.5 * angles
        dq = np.concatenate([axis[None] * np.sin(h)[:, None],
                             np.cos(h)[:, None]], axis=1)
        self.rot[:, j] = _quat_mul_np(self.rot[:, j], dq).astype(np.float32)

    def translate(self, joint: str, offsets):
        j = self.skel.joint_index(joint)
        if j >= 0:
            self.trans[:, j] += np.asarray(offsets, np.float32)

    def sin(self, amp, freq_cycles=1.0, phase=0.0):
        return amp * np.sin(2 * math.pi * (self.phase * freq_cycles) + phase)

    def done(self, name: str) -> AnimationClip:
        return AnimationClip(name=name, rot=self.rot.astype(np.float32),
                             trans=self.trans.astype(np.float32),
                             looping=self.looping)


def _arms_down(b: _ClipBuilder, angle=1.25):
    """Bring the T-pose arms down to the sides (idle/walk base pose)."""
    b.rotate("LeftArm", (0, 0, 1), -angle)
    b.rotate("RightArm", (0, 0, 1), angle)
    b.rotate("LeftForeArm", (0, 0, 1), -0.15)
    b.rotate("RightForeArm", (0, 0, 1), 0.15)


def _locomotion(skel, name, period, leg_amp, knee_amp, arm_amp, bob,
                backwards=False):
    n = max(int(round(period * CLIP_RATE)), 8)
    b = _ClipBuilder(skel, n)
    _arms_down(b)
    sgn = -1.0 if backwards else 1.0
    swing = b.sin(leg_amp)
    b.rotate("LeftUpLeg", (1, 0, 0), sgn * swing)
    b.rotate("RightUpLeg", (1, 0, 0), -sgn * swing)
    # Knee flexes on the back-swing half of each side's cycle.
    b.rotate("LeftLeg", (1, 0, 0), knee_amp * np.maximum(0.0, -b.sin(1.0, phase=0.5)))
    b.rotate("RightLeg", (1, 0, 0), knee_amp * np.maximum(0.0, b.sin(1.0, phase=0.5)))
    # Counter-phase arm swing.
    b.rotate("LeftArm", (1, 0, 0), -sgn * arm_amp * b.sin(1.0))
    b.rotate("RightArm", (1, 0, 0), sgn * arm_amp * b.sin(1.0))
    # Two footfalls per cycle -> vertical bob at 2x frequency.
    b.translate("Hips", np.stack([np.zeros(n), bob * np.abs(b.sin(1.0)),
                                  np.zeros(n)], axis=1))
    b.rotate("Spine", (1, 0, 0), 0.06 * sgn)     # slight forward lean
    return b.done(name)


def build_default_clips(skel: Skeleton) -> list:
    """The animation set the reference's state machine selects between
    (AvatarGraphics.cpp:1246-1292 anim indices + GestureUI set)."""
    clips = []

    # idle: breathing sway, 4 s loop
    b = _ClipBuilder(skel, int(4 * CLIP_RATE))
    _arms_down(b)
    b.rotate("Spine2", (1, 0, 0), 0.02 * np.sin(2 * math.pi * b.phase))
    b.rotate("Head", (0, 0, 1), 0.015 * np.sin(2 * math.pi * b.phase))
    clips.append(b.done("idle"))

    clips.append(_locomotion(skel, "walking", WALK_CYCLE_PERIOD,
                             leg_amp=0.55, knee_amp=0.7, arm_amp=0.35,
                             bob=0.02))
    clips.append(_locomotion(skel, "walking_backwards", WALK_CYCLE_PERIOD,
                             leg_amp=0.45, knee_amp=0.6, arm_amp=0.3,
                             bob=0.02, backwards=True))
    clips.append(_locomotion(skel, "running", RUN_CYCLE_PERIOD,
                             leg_amp=0.9, knee_amp=1.2, arm_amp=0.7,
                             bob=0.045))
    clips.append(_locomotion(skel, "running_backwards", RUN_CYCLE_PERIOD,
                             leg_amp=0.7, knee_amp=1.0, arm_amp=0.55,
                             bob=0.04, backwards=True))

    # in_air (jump): legs tucked, arms slightly out
    b = _ClipBuilder(skel, int(1 * CLIP_RATE))
    _arms_down(b, angle=0.9)
    b.rotate("LeftUpLeg", (1, 0, 0), -0.5)
    b.rotate("RightUpLeg", (1, 0, 0), -0.5)
    b.rotate("LeftLeg", (1, 0, 0), 0.8)
    b.rotate("RightLeg", (1, 0, 0), 0.8)
    clips.append(b.done("in_air"))

    # flying: superman-ish, legs trailing
    b = _ClipBuilder(skel, int(2 * CLIP_RATE))
    _arms_down(b, angle=0.6)
    b.rotate("Spine", (1, 0, 0), 0.25)
    b.rotate("LeftUpLeg", (1, 0, 0), 0.25)
    b.rotate("RightUpLeg", (1, 0, 0), 0.25)
    b.rotate("LeftArm", (1, 0, 0), -0.3 + 0.05 * np.sin(2 * math.pi * b.phase))
    b.rotate("RightArm", (1, 0, 0), -0.3 + 0.05 * np.sin(2 * math.pi * b.phase))
    clips.append(b.done("flying"))

    # floating (hovering, not moving)
    b = _ClipBuilder(skel, int(3 * CLIP_RATE))
    _arms_down(b, angle=1.0)
    b.translate("Hips", np.stack(
        [np.zeros(b.n), 0.03 * np.sin(2 * math.pi * b.phase),
         np.zeros(b.n)], axis=1))
    clips.append(b.done("floating"))

    # turn_left / turn_right: 57 frames at 60 fps in the reference
    # (AvatarGraphics.cpp:723) -> 0.95 s.
    for name, s in (("turn_left", 1.0), ("turn_right", -1.0)):
        b = _ClipBuilder(skel, int(0.95 * CLIP_RATE), looping=False)
        _arms_down(b)
        step = np.sin(math.pi * b.phase)
        b.rotate("LeftUpLeg", (1, 0, 0), 0.2 * s * step)
        b.rotate("RightUpLeg", (1, 0, 0), -0.2 * s * step)
        b.rotate("Spine", (0, 1, 0), 0.15 * s * step)
        clips.append(b.done(name))

    # sitting: neutral seated pose (PoseConstraint refines per seat)
    b = _ClipBuilder(skel, int(2 * CLIP_RATE))
    _arms_down(b, angle=1.1)
    b.rotate("LeftUpLeg", (1, 0, 0), -1.45)
    b.rotate("RightUpLeg", (1, 0, 0), -1.45)
    b.rotate("LeftLeg", (1, 0, 0), 1.35)
    b.rotate("RightLeg", (1, 0, 0), 1.35)
    clips.append(b.done("sitting"))

    # Gestures (GestureUI set: durations from avatar_graphics.GESTURES).
    b = _ClipBuilder(skel, int(2.5 * CLIP_RATE), looping=False)
    _arms_down(b)
    wave_env = np.sin(math.pi * np.minimum(b.phase * 1.25, 1.0))
    b.rotate("RightArm", (0, 0, 1), 2.4 * wave_env)      # raise arm
    b.rotate("RightForeArm", (0, 1, 0),
             0.5 * wave_env * np.sin(2 * math.pi * b.phase * 3))
    clips.append(b.done("Wave"))

    b = _ClipBuilder(skel, int(3.0 * CLIP_RATE), looping=False)
    _arms_down(b)
    clap_env = np.sin(math.pi * np.minimum(b.phase * 1.2, 1.0))
    clap = 0.5 + 0.35 * np.sin(2 * math.pi * b.phase * 4)
    b.rotate("LeftArm", (0, 1, 0), -clap_env * clap)
    b.rotate("RightArm", (0, 1, 0), clap_env * clap)
    b.rotate("LeftForeArm", (0, 1, 0), -clap_env * 0.9)
    b.rotate("RightForeArm", (0, 1, 0), clap_env * 0.9)
    clips.append(b.done("Clap"))

    b = _ClipBuilder(skel, int(8.0 * CLIP_RATE))
    _arms_down(b, angle=0.8)
    beat = 2 * math.pi * b.phase * 8            # 1 Hz beat over 8 s
    b.rotate("Hips", (0, 1, 0), 0.25 * np.sin(beat))
    b.translate("Hips", np.stack(
        [np.zeros(b.n), 0.05 * np.abs(np.sin(beat)), np.zeros(b.n)], axis=1))
    b.rotate("LeftArm", (1, 0, 0), -0.8 - 0.6 * np.sin(beat))
    b.rotate("RightArm", (1, 0, 0), -0.8 + 0.6 * np.sin(beat))
    b.rotate("Head", (0, 0, 1), 0.1 * np.sin(beat))
    clips.append(b.done("Dance"))

    return clips


def build_default_bank(skel: Skeleton | None = None, *, device) -> ClipBank:
    skel = skel or build_default_humanoid()
    return ClipBank(skel, build_default_clips(skel), device=device)

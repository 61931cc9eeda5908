"""Avatar animation: state machine, gestures, and skeletal pose output.

Behavioural port of gui_client/AvatarGraphics.{h,cpp} + AnimationManager +
GestureUI.  The engine owns WHICH animation plays, blend weights,
locomotion phase, procedural head-look / lean / eye saccades, sitting
pose constraints, IK hand-holds — and now the bone-level pose itself:
every avatar's skeleton is evaluated by ONE batched jitted kernel per
tick (anim/pose.py), producing per-joint object/world transforms and
skinning matrices (`updateAvatarGraphics` in the tick, GUIClient.cpp:8235
-> AvatarGraphics::setOverallTransform).

States: idle / walk / run (fwd+back) / fly / jump-in-air / sitting,
selected from velocity + anim_state bitflags (shared/Avatar.h:141),
blended over short transitions (0.3 s default, 0.2 walk, 0.1 run —
AvatarGraphics.cpp:225,697,711); gestures play as full-body clips with a
0.3 s blend-out (cpp:758-766).

Counterpart of ``substrata_tpu/avatar_graphics.py``: the state machine is
the reference's host code; ``pose_all`` poses every avatar with kernel KZ
(anim/pose.py), its inputs in one packed, pinned host -> device copy and
the three outputs read back in one device -> host copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

import torch

from substrata_tpu_torch.anim.clips import CLIP_RATE, ClipBank, build_default_clips
from substrata_tpu_torch.anim.pose import (PROC_SLOTS, PoseKernel,
                                           pack_params, params_from_packed, zero_pose_arrays)
from substrata_tpu_torch.anim.skeleton import (_quat_mul_np, axis_angle_quat_np,
                                               build_default_humanoid, quat_to_mat3_np)
from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.shared.avatar import (
    ANIM_STATE_FLYING, ANIM_STATE_IN_AIR, ANIM_STATE_MOVE_IMPULSE_ZERO,
)

ANIM_IDLE = "idle"
ANIM_WALK = "walking"
ANIM_WALK_BACK = "walking_backwards"
ANIM_RUN = "running"
ANIM_RUN_BACK = "running_backwards"
ANIM_FLY = "flying"
ANIM_FLOAT = "floating"
ANIM_JUMP = "in_air"
ANIM_SIT = "sitting"

WALK_RUN_THRESHOLD = 6.0   # m/s (AvatarGraphics.cpp:704 xyplane_speed > 6)
MOVE_THRESHOLD = 0.3
BLEND_TIME = 0.3           # default transition (cpp:225)
BLEND_TIME_WALK = 0.2
BLEND_TIME_RUN = 0.1

# Procedural head look (AvatarGraphics.cpp:905-945).
MAX_HEAD_YAW = 0.8
MAX_HEAD_PITCH = 0.8
NECK_FACTOR = 0.5
# Eye saccades (cpp:1138: 30 ms, rough value from wikipedia).
SACCADE_DURATION = 0.03
MAX_EYE_YAW = 0.4
MAX_EYE_PITCH = 0.3
# Lean (cpp:665-672).
LEAN_MAX_ACCEL = 10.2
LEAN_BLEND_FRAC = 0.03
LEAN_SCALE = -0.02

# Avatar positions on the wire are EYE positions; the model origin (feet)
# sits eye height below (AvatarGraphics.cpp:855: lowest bone translated up
# by the 1.67 m default eye height, minus a 3 cm ground-contact fudge).
AVATAR_EYE_HEIGHT = 1.67
_FEET_DROP = AVATAR_EYE_HEIGHT - 0.03

# Built-in gestures (GestureUI gesture list shape).
GESTURES = {
    "Wave": {"duration": 2.5, "animate_head": False},
    "Clap": {"duration": 3.0, "animate_head": False},
    "Dance": {"duration": 8.0, "animate_head": True},
    "Sit": {"duration": 1e9, "animate_head": False},
}
_GESTURE_CLIPS = {"Wave": "Wave", "Clap": "Clap", "Dance": "Dance",
                  "Sit": "sitting"}

# Model space is y-up facing +z; the world is z-up.  The root transform
# composes place(z-up) @ _MODEL_TO_WORLD (pre_ob_to_world parity).
_MODEL_TO_WORLD = np.array([[0, 0, 1, 0],
                            [1, 0, 0, 0],
                            [0, 1, 0, 0],
                            [0, 0, 0, 1]], np.float32)
# Seat space: forwards +y, right +x, up +z (PoseConstraint docs,
# AvatarGraphics.h:63).  Model (x,y,z) -> seat (-x, z, y).
_MODEL_TO_SEAT = np.array([[-1, 0, 0, 0],
                           [0, 0, 1, 0],
                           [0, 1, 0, 0],
                           [0, 0, 0, 1]], np.float32)


@dataclass
class PoseConstraint:
    """AvatarGraphics.h:56-81 — how a seat shapes the sitting pose.
    Angle semantics follow the reference (positive = bend forward);
    the kernel mapping negates where this rig's +x rotation differs."""

    sitting: bool = False
    seat_to_world: np.ndarray | None = None       # [4,4]
    upper_body_rot_angle: float = 0.0
    upper_leg_rot_angle: float = 0.0
    upper_leg_rot_around_thigh_bone_angle: float = 0.0
    upper_leg_apart_angle: float = 0.0
    lower_leg_rot_angle: float = 0.0
    lower_leg_apart_angle: float = 0.0
    rotate_foot_out_angle: float = 0.0
    arm_down_angle: float = 0.0
    arm_out_angle: float = 0.0
    upper_arm_shoulder_lift_angle: float = 0.0
    lower_arm_up_angle: float = 0.0
    left_hand_hold_point_ws: np.ndarray | None = None
    right_hand_hold_point_ws: np.ndarray | None = None


@dataclass
class AnimEvents:
    """Per-update outputs the app layer reacts to (footstep sounds etc.)."""

    footstrike: bool = False
    footstrike_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))


def _rx(a):
    return axis_angle_quat_np((1, 0, 0), a)


def _ry(a):
    return axis_angle_quat_np((0, 1, 0), a)


def _rz(a):
    return axis_angle_quat_np((0, 0, 1), a)


def _qmul(*qs):
    out = qs[0]
    for q in qs[1:]:
        out = _quat_mul_np(out, q)
    return out


class AvatarGraphics:
    def __init__(self, avatar=None, rng_seed: int | None = None):
        self.avatar = avatar
        self.cur_anim = ANIM_IDLE
        self.prev_anim = ANIM_IDLE
        self.blend = 1.0               # 0 -> prev, 1 -> cur
        self.blend_time = BLEND_TIME
        self.cur_t = 0.0               # seconds into cur_anim
        self.prev_t = 0.0
        self.locomotion_phase = 0.0    # walk cycle phase [0, 2pi)
        self.gesture: str | None = None
        self.gesture_time_left = 0.0
        self.gesture_animate_head = False
        self.sitting = False
        self.pose_constraint = PoseConstraint()
        self.last_pos = None
        self.last_vel = np.zeros(3)
        self.smoothed_speed = 0.0
        self.heading = 0.0
        self.root_transform = np.eye(4, dtype=np.float32)
        # Procedural look / lean state.
        self.cur_head_rot_z = 0.0
        self.look_pitch = 0.0
        self.cur_sideways_lean = 0.0
        self.cur_forwards_lean = 0.0
        # Eye saccades.
        self._rng = np.random.default_rng(rng_seed)
        self._eye_cur = np.zeros(2, np.float32)     # (yaw, pitch) rel head
        self._eye_next = np.zeros(2, np.float32)
        self._eye_t0 = 0.0
        self._eye_t1 = 0.0
        self._clock = 0.0
        # Filled by AvatarGraphicsManager.pose_all().
        self.joints_obj: np.ndarray | None = None    # [J,4,4] object space
        self.joints_world: np.ndarray | None = None  # [J,4,4]
        self.skin_matrices: np.ndarray | None = None
        self._ik_post: dict = {}     # side -> accumulated IK post quat

    # ------------------------------------------------------------------
    def perform_gesture(self, name: str):
        g = GESTURES.get(name)
        if g is None:
            return False
        self.gesture = name
        self.gesture_time_left = g["duration"]
        self.gesture_animate_head = g["animate_head"]
        return True

    def stop_gesture(self):
        self.gesture = None
        self.gesture_time_left = 0.0

    def set_sitting(self, sitting: bool, constraint: PoseConstraint | None = None):
        self.sitting = sitting
        if constraint is not None:
            self.pose_constraint = constraint
        self.pose_constraint.sitting = sitting

    # ------------------------------------------------------------------
    def _select_anim(self, speed_xy: float, anim_state: int,
                     moving_forwards: bool) -> tuple:
        if self.gesture is not None and self.gesture_time_left > 0.3:
            # Gestures play as the current clip, blending back to
            # locomotion 0.3 s before the end (AvatarGraphics.cpp:758).
            return _GESTURE_CLIPS.get(self.gesture, ANIM_IDLE), BLEND_TIME
        if self.sitting:
            return ANIM_SIT, BLEND_TIME
        if anim_state & ANIM_STATE_FLYING:
            moving = not (anim_state & ANIM_STATE_MOVE_IMPULSE_ZERO)
            return (ANIM_FLY if moving else ANIM_FLOAT), BLEND_TIME
        if anim_state & ANIM_STATE_IN_AIR:
            return ANIM_JUMP, BLEND_TIME
        if speed_xy > WALK_RUN_THRESHOLD:
            return (ANIM_RUN if moving_forwards else ANIM_RUN_BACK,
                    BLEND_TIME_RUN)
        if speed_xy > MOVE_THRESHOLD and not (anim_state & ANIM_STATE_MOVE_IMPULSE_ZERO):
            return (ANIM_WALK if moving_forwards else ANIM_WALK_BACK,
                    BLEND_TIME_WALK)
        return ANIM_IDLE, BLEND_TIME

    def update(self, pos, heading: float, anim_state: int, dt: float,
               look_pitch: float = 0.0) -> AnimEvents:
        """Per-tick update (updateAvatarGraphics parity).  Returns events.

        ``heading``: the direction the avatar faces (z-rotation, radians);
        also the look target for procedural head yaw when the body lags.
        """
        pos = np.asarray(pos, np.float64)
        ev = AnimEvents()
        self._clock += dt
        if self.last_pos is None:
            self.last_pos = pos.copy()
        vel = (pos - self.last_pos) / max(dt, 1e-6)
        self.last_pos = pos.copy()
        accel = (vel - self.last_vel) / max(dt, 1e-6)
        self.last_vel = vel.copy()
        speed_xy = float(np.linalg.norm(vel[:2]))
        self.smoothed_speed += (speed_xy - self.smoothed_speed) * min(1.0, 10.0 * dt)
        self.heading = heading
        self.look_pitch = look_pitch

        fwd = np.array([math.cos(heading), math.sin(heading)])
        moving_forwards = (speed_xy < 0.1
                           or float(fwd @ vel[:2]) > -0.1 * speed_xy)

        want, btime = self._select_anim(self.smoothed_speed, anim_state,
                                        moving_forwards)
        if want != self.cur_anim:
            self.prev_anim = self.cur_anim
            self.prev_t = self.cur_t
            self.cur_anim = want
            self.cur_t = 0.0
            self.blend = 0.0
            self.blend_time = btime
        self.blend = min(1.0, self.blend + dt / self.blend_time)
        self.cur_t += dt
        self.prev_t += dt

        # Locomotion phase advances with distance (stride ~1.7 m walk,
        # ~2.6 m run) so footfalls track ground speed.
        if self.cur_anim in (ANIM_WALK, ANIM_RUN, ANIM_WALK_BACK,
                             ANIM_RUN_BACK):
            stride = 1.7 if "walk" in self.cur_anim else 2.6
            old_phase = self.locomotion_phase
            self.locomotion_phase = (self.locomotion_phase
                                     + 2 * math.pi * self.smoothed_speed * dt / stride)
            # Footstrike at each half cycle.
            if int(old_phase / math.pi) != int(self.locomotion_phase / math.pi):
                ev.footstrike = True
                ev.footstrike_pos = pos.copy()
            self.locomotion_phase %= 2 * math.pi

        if self.gesture is not None:
            self.gesture_time_left -= dt
            if self.gesture_time_left <= 0:
                self.stop_gesture()

        # Head look: blend cur_head_rot_z toward the (clamped) camera yaw
        # (AvatarGraphics.cpp:918-925), the closest way around the circle.
        frac = min(0.2, 10.0 * dt)
        target = _wrap_angle_near(self.cur_head_rot_z, heading)
        self.cur_head_rot_z = self.cur_head_rot_z * (1 - frac) + target * frac

        # Lean from ground acceleration (cpp:663-680).
        if not (anim_state & (ANIM_STATE_IN_AIR | ANIM_STATE_FLYING)):
            side = np.array([-fwd[1], fwd[0]])
            sideways = float(np.clip(side @ accel[:2], -LEAN_MAX_ACCEL,
                                     LEAN_MAX_ACCEL))
            forwards = float(np.clip(fwd @ accel[:2], -LEAN_MAX_ACCEL,
                                     LEAN_MAX_ACCEL))
            self.cur_sideways_lean += (sideways - self.cur_sideways_lean) * LEAN_BLEND_FRAC
            self.cur_forwards_lean += (forwards - self.cur_forwards_lean) * LEAN_BLEND_FRAC
            if not np.isfinite(self.cur_sideways_lean):
                self.cur_sideways_lean = 0.0
            if not np.isfinite(self.cur_forwards_lean):
                self.cur_forwards_lean = 0.0

        # Eye saccades: pick a new target after each gap (cpp:1138-1160).
        if self._clock > self._eye_t1 + self._saccade_gap():
            self._eye_cur = self._eye_next
            self._eye_next = np.array(
                [self._rng.uniform(-MAX_EYE_YAW, MAX_EYE_YAW),
                 self._rng.uniform(-MAX_EYE_PITCH, MAX_EYE_PITCH)],
                np.float32)
            self._eye_t0 = self._clock
            self._eye_t1 = self._clock + SACCADE_DURATION

        self.root_transform = self._compute_root(pos, heading)
        return ev

    def _saccade_gap(self):
        # Deterministic per-state gap so update() stays replayable.
        return 0.4 + 2.6 * abs(math.sin(self._eye_t1 * 12.9898))

    def _compute_root(self, pos, heading: float) -> np.ndarray:
        pc = self.pose_constraint
        if self.sitting and pc.seat_to_world is not None:
            return (np.asarray(pc.seat_to_world, np.float32)
                    @ _MODEL_TO_SEAT)
        yaw = heading + math.pi / 2  # model +z (face) -> world heading
        cz, sz = math.cos(yaw), math.sin(yaw)
        place = np.array([[cz, -sz, 0, pos[0]],
                          [sz, cz, 0, pos[1]],
                          [0, 0, 1, pos[2] - _FEET_DROP],
                          [0, 0, 0, 1]], np.float32)
        lean = np.eye(4, dtype=np.float32)
        if abs(self.cur_sideways_lean) + abs(self.cur_forwards_lean) > 1e-6:
            # rotationAroundXAxis(side * -0.02) * rotationAroundYAxis(fwd
            # * -0.02) in model space (cpp:680).
            qx = _rx(self.cur_sideways_lean * LEAN_SCALE)
            qy = _ry(self.cur_forwards_lean * LEAN_SCALE)
            lean[:3, :3] = quat_to_mat3_np(_qmul(qx, qy))
        return place @ _MODEL_TO_WORLD @ lean

    # ------------------------------------------------------------------
    def get_pose_params(self) -> dict:
        """Pose parameters a renderer consumes: animation names + blend +
        phase + gesture override."""
        return {
            "anim": self.cur_anim,
            "prev_anim": self.prev_anim,
            "blend": self.blend,
            "phase": self.locomotion_phase,
            "gesture": self.gesture,
            "gesture_animate_head": self.gesture_animate_head,
            "root": self.root_transform,
        }

    def get_joint_world(self, name: str):
        """World transform [4,4] of a named joint from the last pose_all
        (None before the first pose or for unknown joints)."""
        mgr_skel = getattr(self, "_skeleton", None)
        if self.joints_world is None or mgr_skel is None:
            return None
        j = mgr_skel.joint_index(name)
        return None if j < 0 else self.joints_world[j]

    def get_last_head_position(self):
        m = self.get_joint_world("Head")
        return None if m is None else m[:3, 3]


def _wrap_angle_near(ref: float, angle: float) -> float:
    """angle shifted by 2*pi*k to land nearest ref (mod2PiDiff parity)."""
    d = (angle - ref + math.pi) % (2 * math.pi) - math.pi
    return ref + d


class AvatarGraphicsManager:
    """Per-avatar graphics registry driven by the client tick.

    `update_avatar` runs the per-avatar state machine (host); `pose_all`
    evaluates EVERY avatar's skeleton in one batched kernel call and
    stores joint transforms back on each AvatarGraphics.  The rig lives on
    ``device`` (default the card)."""

    def __init__(self, skeleton=None, bank=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.by_uid: dict[int, AvatarGraphics] = {}
        self._skeleton = skeleton
        self._bank = bank
        self._kernel = None
        self._params_cap = 0

    # -- lazy rig construction (the first pose_all uploads the bank) ----
    def _rig(self):
        if self._kernel is None:
            if self._skeleton is None:
                self._skeleton = build_default_humanoid()
            if self._bank is None:
                self._bank = ClipBank(self._skeleton, build_default_clips(self._skeleton),
                                      device=self.device)
            self._kernel = PoseKernel(self._skeleton, self._bank)
        return self._skeleton, self._bank, self._kernel

    def update_avatar(self, avatar, dt: float) -> AnimEvents:
        g = self.by_uid.get(avatar.uid)
        if g is None:
            g = AvatarGraphics(avatar, rng_seed=avatar.uid)
            self.by_uid[avatar.uid] = g
            avatar.graphics = g
        heading = float(avatar.rotation[2])
        g.set_sitting(avatar.entered_vehicle_uid != 0)
        return g.update(avatar.pos, heading, avatar.anim_state, dt)

    def remove_avatar(self, uid: int):
        self.by_uid.pop(uid, None)

    # ------------------------------------------------------------------
    def _clip_frame(self, bank, g: AvatarGraphics, name: str, t: float):
        ci = bank.clip_index(name)
        n = float(bank.n_frames_host[ci])
        if name in (ANIM_WALK, ANIM_RUN, ANIM_WALK_BACK, ANIM_RUN_BACK):
            frame = g.locomotion_phase / (2 * math.pi) * n
        else:
            frame = t * CLIP_RATE
        return ci, frame

    def pack_all(self):
        """The pose inputs of every avatar, padded to a power of two (at
        least 4) as the reference pads them: (graphics in order, padded
        count, numpy arrays keyed as PoseParams)."""
        skel, bank, _ = self._rig()
        graphics = list(self.by_uid.values())
        n = len(graphics)
        cap = max(4, 1 << (n - 1).bit_length())   # pad to pow2 buckets
        arr = zero_pose_arrays(cap)
        slot = {nm: i for i, nm in enumerate(PROC_SLOTS)}
        for i, g in enumerate(graphics):
            g._skeleton = skel
            arr["clip_b"][i], arr["frame_b"][i] = self._clip_frame(bank, g, g.cur_anim,
                                                                   g.cur_t)
            arr["clip_a"][i], arr["frame_a"][i] = self._clip_frame(bank, g, g.prev_anim,
                                                                   g.prev_t)
            arr["blend"][i] = g.blend
            arr["root"][i] = g.root_transform
            self._fill_procedural(g, i, slot, arr["override_rot"], arr["override_mask"],
                                  arr["post_rot"], arr["post_mask"], arr["grab_l"],
                                  arr["grab_r"], skel)
        return graphics, cap, arr

    def pose_all(self):
        """Evaluate every avatar's skeleton (one kernel launch); results are
        stored on each AvatarGraphics (joints_obj/joints_world/skin).  One
        host -> device copy of the packed inputs, one device -> host copy
        of the three outputs."""
        if not self.by_uid:
            return {}
        graphics, cap, arr = self.pack_all()
        buf = torch.from_numpy(pack_params(arr))
        if self.device.type != "cpu":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        out = self._kernel.call_packed(params_from_packed(buf, cap)).cpu().numpy()
        obj, world, skin = out[0], out[1], out[2]
        res = {}
        for i, g in enumerate(graphics):
            g.joints_obj = obj[i]
            g.joints_world = world[i]
            g.skin_matrices = skin[i]
            res[g.avatar.uid if g.avatar is not None else i] = world[i]
        return res

    # ------------------------------------------------------------------
    def _fill_procedural(self, g: AvatarGraphics, i: int, slot, ov_rot,
                         ov_mask, po_rot, po_mask, grab_l, grab_r, skel):
        pc = g.pose_constraint

        # Head/neck look-at (cpp:918-1010), suppressed while a gesture
        # animates the head.
        gesture_head = (g.gesture is not None and g.gesture_animate_head)
        if not gesture_head:
            yaw = float(np.clip(
                _wrap_angle_near(0.0, g.cur_head_rot_z - g.heading),
                -MAX_HEAD_YAW, MAX_HEAD_YAW))
            pitch = float(np.clip(g.look_pitch, -MAX_HEAD_PITCH,
                                  MAX_HEAD_PITCH))
            # Model space: yaw about +y (up), pitch about +x.
            for nm, f in (("Neck", NECK_FACTOR), ("Head", 1.0 - NECK_FACTOR)):
                po_rot[i, slot[nm]] = _qmul(_ry(yaw * f), _rx(pitch * f))
                po_mask[i, slot[nm]] = True
            # Eye saccade offsets relative to the head.
            u = 0.0 if g._eye_t1 <= g._eye_t0 else float(np.clip(
                (g._clock - g._eye_t0) / (g._eye_t1 - g._eye_t0), 0, 1))
            u = u * u * (3 - 2 * u)   # smoothStep (cpp:1099)
            ey = g._eye_cur * (1 - u) + g._eye_next * u
            eq = _qmul(_ry(float(ey[0])), _rx(float(ey[1])))
            for nm in ("LeftEye", "RightEye"):
                po_rot[i, slot[nm]] = eq
                po_mask[i, slot[nm]] = True

        if not pc.sitting:
            return

        # Sitting pose constraint (cpp:250-298).  Reference semantics:
        # positive upper_body/upper_leg angles bend forward; this rig's
        # +x rotation bends backward, hence the negations.
        po_rot[i, slot["Hips"]] = _rx(pc.upper_body_rot_angle)
        po_mask[i, slot["Hips"]] = True
        for side, sgn in (("Left", 1.0), ("Right", -1.0)):
            q_up = _qmul(_rx(-pc.upper_leg_rot_angle),
                         _ry(sgn * (pc.upper_leg_apart_angle
                                    + pc.upper_leg_rot_around_thigh_bone_angle)))
            po_rot[i, slot[f"{side}UpLeg"]] = q_up
            po_mask[i, slot[f"{side}UpLeg"]] = True
            q_low = _qmul(_rz(-sgn * pc.rotate_foot_out_angle),
                          _ry(sgn * pc.lower_leg_apart_angle),
                          _rx(-pc.lower_leg_rot_angle))
            po_rot[i, slot[f"{side}Leg"]] = q_low
            po_mask[i, slot[f"{side}Leg"]] = True

        for side, sgn, hold in (("Left", 1.0, pc.left_hand_hold_point_ws),
                                ("Right", -1.0, pc.right_hand_hold_point_ws)):
            if hold is not None and g.joints_obj is not None:
                self._arm_ik(g, i, slot, ov_rot, ov_mask, po_rot, po_mask,
                             side, sgn, np.asarray(hold, np.float64), skel)
                (grab_l if side == "Left" else grab_r)[i] = 1.0
            else:
                # No IK: arms shaped by the constraint angles (cpp:383-398).
                q_arm = _qmul(_rz(sgn * (pc.arm_down_angle - math.pi / 2)),
                              _rx(-pc.arm_out_angle))
                po_rot[i, slot[f"{side}Arm"]] = q_arm
                po_mask[i, slot[f"{side}Arm"]] = True
                po_rot[i, slot[f"{side}ForeArm"]] = _rx(-pc.lower_arm_up_angle)
                po_mask[i, slot[f"{side}ForeArm"]] = True

    def _arm_ik(self, g, i, slot, ov_rot, ov_mask, po_rot, po_mask,
                side, sgn, hold_ws, skel):
        """Two-bone arm IK toward a world-space hold point, using LAST
        tick's joint transforms exactly like the reference
        (AvatarGraphics.cpp:300-380: law-of-cosines elbow + rotate the
        shoulder so the wrist lands on the target)."""
        j_arm = skel.joint_index(f"{side}Arm")
        j_fore = skel.joint_index(f"{side}ForeArm")
        j_hand = skel.joint_index(f"{side}Hand")
        if min(j_arm, j_fore, j_hand) < 0:
            return
        upper_len = float(np.linalg.norm(skel.rest_trans[j_fore]))
        lower_len = float(np.linalg.norm(skel.rest_trans[j_hand]))
        shoulder_ws = g.joints_world[j_arm][:3, 3].astype(np.float64)
        c = float(np.linalg.norm(hold_ws - shoulder_ws))
        cos_gamma = np.clip(
            (upper_len ** 2 + lower_len ** 2 - c * c)
            / max(2 * upper_len * lower_len, 1e-9), -1.0, 1.0)
        gamma = float(np.arccos(cos_gamma))
        # Elbow: replace the animation rotation (cpp:344-346).
        ov_rot[i, slot[f"{side}ForeArm"]] = _rx(math.pi + gamma)
        ov_mask[i, slot[f"{side}ForeArm"]] = True
        po_rot[i, slot[f"{side}ForeArm"]] = np.array([0, 0, 0, 1], np.float32)
        po_mask[i, slot[f"{side}ForeArm"]] = True

        # Shoulder: rotate so the wrist direction aligns with the
        # shoulder->hold direction.  The correction is measured in the
        # CURRENT posed arm frame (which includes last tick's IK post
        # rotation), so it composes onto the accumulated post rotation —
        # an iterative solve converging over a few ticks, like the
        # reference's use of last-frame bone transforms (cpp:301-380).
        arm_ws = g.joints_world[j_arm].astype(np.float64)
        wrist_ws = g.joints_world[j_hand][:3, 3].astype(np.float64)
        v_cur = wrist_ws - shoulder_ws
        v_tgt = hold_ws - shoulder_ws
        nc, nt = np.linalg.norm(v_cur), np.linalg.norm(v_tgt)
        prev = g._ik_post.get(side, np.array([0, 0, 0, 1], np.float32))
        if nc > 1e-6 and nt > 1e-6:
            axis_ws = np.cross(v_cur / nc, v_tgt / nt)
            s = np.linalg.norm(axis_ws)
            if s > 1e-4:
                angle = float(np.arccos(np.clip(
                    (v_cur / nc) @ (v_tgt / nt), -1.0, 1.0)))
                # axis into the current arm frame (undo its world rotation)
                axis_local = arm_ws[:3, :3].T @ (axis_ws / s)
                prev = _qmul(prev, axis_angle_quat_np(axis_local, angle))
                prev = prev / max(np.linalg.norm(prev), 1e-9)
                g._ik_post[side] = prev.astype(np.float32)
        po_rot[i, slot[f"{side}Arm"]] = prev
        po_mask[i, slot[f"{side}Arm"]] = True
        # Hand grip pose (cpp:500-510).
        ov_rot[i, slot[f"{side}Hand"]] = _qmul(
            _rx(-0.6), _ry(-0.2), _rz(-0.5 * sgn))
        ov_mask[i, slot[f"{side}Hand"]] = True

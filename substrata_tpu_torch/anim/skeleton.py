"""Skeleton: joint hierarchy + rest pose + inverse bind matrices.

A copy of ``substrata_tpu/anim/skeleton.py`` (numpy only; the reference
package cannot be imported without jax).  Host-side data; the pose kernel
(anim/pose.py) takes the static parts (parents, levels, rest scale,
inverse bind) as device tensors built once.  Joint naming follows the
Mixamo convention the reference looks up (gui_client/AvatarGraphics.cpp:
1294-1364: "Hips", "Spine2", "Neck", "LeftUpLeg", "LeftLeg", "LeftFoot",
"LeftArm", "LeftForeArm", "LeftHandThumb1"...), so retargeting between the
default rig, Mixamo GLB clips and VRM avatars is a name join.

Object space is y-up (glTF convention, same as the reference's avatar
model space); the client's root transform maps it into the z-up world
(AvatarGraphics::setOverallTransform's pre_ob_to_world path).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _quat_mul_np(a, b):
    """xyzw quaternion product (numpy, broadcasting)."""
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def quat_to_mat3_np(q):
    """xyzw quaternion(s) [.., 4] -> rotation matrix [.., 3, 3]."""
    x, y, z, w = np.moveaxis(np.asarray(q, np.float64), -1, 0)
    m = np.empty(x.shape + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def trs_to_mat4_np(trans, rot, scale):
    """Compose T @ R @ S into 4x4 matrices (numpy)."""
    trans = np.asarray(trans, np.float64)
    m = np.zeros(trans.shape[:-1] + (4, 4))
    m[..., :3, :3] = quat_to_mat3_np(rot) * np.asarray(scale)[..., None, :]
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    return m


def axis_angle_quat_np(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    h = 0.5 * angle
    return np.concatenate([axis * np.sin(h), [np.cos(h)]]).astype(np.float32)


def mat3_to_quat_np(m) -> np.ndarray:
    """Rotation matrix [3, 3] -> xyzw quaternion (Shepperd's method)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s, 0.25 * s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s,
             0.25 * s, (m[1, 0] - m[0, 1]) / s]
    return np.asarray(q, np.float32)


@dataclass
class Skeleton:
    """Joint hierarchy in topological order (parents[i] < i, root = -1)."""

    names: list
    parents: np.ndarray            # [J] i32
    rest_trans: np.ndarray         # [J, 3] f32 local translation
    rest_rot: np.ndarray           # [J, 4] f32 local rotation (xyzw)
    rest_scale: np.ndarray         # [J, 3] f32 local scale
    inverse_bind: np.ndarray | None = None   # [J, 4, 4] f32
    _index: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.parents = np.asarray(self.parents, np.int32)
        self.rest_trans = np.asarray(self.rest_trans, np.float32)
        self.rest_rot = np.asarray(self.rest_rot, np.float32)
        self.rest_scale = np.asarray(self.rest_scale, np.float32)
        if not self._index:
            self._index = {n: i for i, n in enumerate(self.names)}
        assert np.all(self.parents < np.arange(self.num_joints)), \
            "skeleton joints must be topologically ordered"
        if self.inverse_bind is None:
            # Bind pose = rest pose: inverse of the rest-pose object-space
            # transform, so skin matrices are identity at rest.
            rest = self.rest_world()
            self.inverse_bind = np.linalg.inv(rest).astype(np.float32)
        self.inverse_bind = np.asarray(self.inverse_bind, np.float32)

    @property
    def num_joints(self) -> int:
        return len(self.names)

    def joint_index(self, name: str) -> int:
        """Index of a named joint, -1 if absent (getNodeIndex parity)."""
        return self._index.get(name, -1)

    def levels(self) -> list:
        """Joint indices grouped by tree depth (level-order FK schedule)."""
        depth = np.zeros(self.num_joints, np.int32)
        for j in range(self.num_joints):
            p = self.parents[j]
            depth[j] = 0 if p < 0 else depth[p] + 1
        out = []
        for d in range(int(depth.max()) + 1 if self.num_joints else 0):
            out.append(np.nonzero(depth == d)[0].astype(np.int32))
        return out

    def rest_world(self) -> np.ndarray:
        """[J, 4, 4] object-space joint transforms in the rest pose."""
        local = trs_to_mat4_np(self.rest_trans, self.rest_rot, self.rest_scale)
        world = np.empty_like(local)
        for j in range(self.num_joints):
            p = self.parents[j]
            world[j] = local[j] if p < 0 else world[p] @ local[j]
        return world

    def retarget_rotations(self, other: "Skeleton") -> np.ndarray:
        """Per-joint rest-rotation delta quats mapping OTHER's clip-local
        rotations onto this skeleton (the reference's retarget_adjustment,
        AvatarGraphics.cpp:324): joints are joined by name; unmatched
        joints get identity."""
        out = np.tile(np.array([0, 0, 0, 1], np.float32),
                      (self.num_joints, 1))
        for j, n in enumerate(self.names):
            oj = other.joint_index(n)
            if oj >= 0:
                # delta = rest_self * conj(rest_other)
                oc = other.rest_rot[oj] * np.array([-1, -1, -1, 1], np.float32)
                out[j] = _quat_mul_np(self.rest_rot[j], oc)
        return out


# ---------------------------------------------------------------------------
# Default humanoid rig: the 64-joint Mixamo-named skeleton the reference's
# default xbot avatar uses.  Rest pose = T-pose, y-up, metres, facing +z
# like the reference model space.

_IDENT_Q = (0.0, 0.0, 0.0, 1.0)


def build_default_humanoid() -> Skeleton:
    J = []          # (name, parent_name, local_trans, local_rot)

    def add(name, parent, t, rot=_IDENT_Q):
        J.append((name, parent, t, rot))

    add("Hips", None, (0.0, 0.95, 0.0))
    add("Spine", "Hips", (0.0, 0.10, 0.0))
    add("Spine1", "Spine", (0.0, 0.12, 0.0))
    add("Spine2", "Spine1", (0.0, 0.12, 0.0))
    add("Neck", "Spine2", (0.0, 0.14, 0.0))
    add("Head", "Neck", (0.0, 0.10, 0.0))
    add("LeftEye", "Head", (0.032, 0.06, 0.09))
    add("RightEye", "Head", (-0.032, 0.06, 0.09))

    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        add(f"{side}Shoulder", "Spine2", (sx * 0.06, 0.10, 0.0))
        add(f"{side}Arm", f"{side}Shoulder", (sx * 0.12, 0.0, 0.0))
        add(f"{side}ForeArm", f"{side}Arm", (sx * 0.27, 0.0, 0.0))
        add(f"{side}Hand", f"{side}ForeArm", (sx * 0.26, 0.0, 0.0))
        add(f"{side}UpLeg", "Hips", (sx * 0.09, -0.06, 0.0))
        add(f"{side}Leg", f"{side}UpLeg", (0.0, -0.42, 0.0))
        add(f"{side}Foot", f"{side}Leg", (0.0, -0.42, 0.0))
        add(f"{side}ToeBase", f"{side}Foot", (0.0, -0.06, 0.12))
        # Finger chains: thumb/index/middle/ring/pinky x 4 segments
        # (AvatarGraphics.cpp:1326-1364 drives all of these).  Finger
        # frames follow the Mixamo convention the reference's grab code
        # assumes (setProceduralRotation with xAxisRot curls): local +y
        # runs ALONG the bone, local +x is the curl axis, curling toward
        # the palm (-y world in T-pose, palms down).
        # left:  y_l = +x_w, z_l = -y_w, x_l = -z_w
        # right: y_l = -x_w, z_l = -y_w, x_l = +z_w
        if sx > 0:
            f_rot = tuple(mat3_to_quat_np(
                np.array([[0, 1, 0], [0, 0, -1], [-1, 0, 0]], np.float64)))
        else:
            f_rot = tuple(mat3_to_quat_np(
                np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)))
        fingers = [("Thumb", (0.03, -0.01, 0.03), 0.032),
                   ("Index", (0.09, 0.0, 0.03), 0.028),
                   ("Middle", (0.095, 0.0, 0.01), 0.030),
                   ("Ring", (0.09, 0.0, -0.01), 0.028),
                   ("Pinky", (0.085, 0.0, -0.03), 0.022)]
        for fname, base, seg in fingers:
            prev = f"{side}Hand"
            for k in range(1, 5):
                if k == 1:   # base offset in the (world-aligned) hand frame
                    add(f"{side}Hand{fname}{k}", prev,
                        (sx * base[0], base[1], base[2]), f_rot)
                else:        # along-bone offset in the finger frame (+y)
                    add(f"{side}Hand{fname}{k}", prev, (0.0, seg, 0.0))
                prev = f"{side}Hand{fname}{k}"

    names = [n for n, _, _, _ in J]
    index = {n: i for i, n in enumerate(names)}
    parents = np.array([index[p] if p is not None else -1
                        for _, p, _, _ in J], np.int32)
    trans = np.array([t for _, _, t, _ in J], np.float32)
    rots = np.array([r for _, _, _, r in J], np.float32)
    nj = len(names)
    return Skeleton(
        names=names, parents=parents, rest_trans=trans, rest_rot=rots,
        rest_scale=np.ones((nj, 3), np.float32))

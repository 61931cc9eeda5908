"""Every avatar's skeletal pose in one launch (kernel KZ).

Replaces K15, ``substrata_tpu/anim/pose.py:PoseKernel._pose`` (:182-241,
jitted at :160): per avatar, sample clip A and clip B at their fractional
frames (wrap for a looping clip, clamp otherwise), nlerp between the two
frames, cross-fade A -> B; procedural rotation overrides at the named
slots; finger-grab curls; local TRS matrices; post-multiplied procedural
rotations at the slots; level-order forward kinematics; the root; skin =
FK @ inverse bind.

``pose`` runs ``pose_plain`` for CPU tensors and the launch of
``csrc/pose.cu`` for CUDA ones (a block an avatar: the sampling a thread a
joint, the matrix products 16 lanes a joint).  The twin spells every 4-term dot as
((a0 b0 + a1 b1) + a2 b2) + a3 b3, one rounding per operation, which the
kernel repeats (built with -fmad=false): the two are bit-equal on the
card.  XLA picks its own summation order and contracts some products, so
the twin matches the reference to rounding (tests/test_torch_anim.py holds
it within 1e-5 of each matrix's scale).  The inputs' packed layout
(``PARAM_LAYOUT``) is the kernel's; ``anim/pose.py`` builds them.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp

NUM_SLOTS = 18           # anim.pose.PROC_SLOTS
GRAB_EPS = 1e-3

MAX_JOINTS = 256         # csrc/pose.cu:kMaxJoints
MAX_CLIPS = 256          # csrc/pose.cu:kMaxClips: the bank's clip table in shared memory

launches = 0
# csrc/pose.cu:PoseArgs: 23 input pointers (the bank, the packed parameters in
# PARAM_LAYOUT's order, the rig), the output; f_cap, n_half, A, J, S,
# n_levels and the bank's clip count.
_PACK = struct.Struct("=31q")
_plans = {}

# Field order, dtype and per-avatar shape of the packed inputs; every field
# starts on a 4-byte boundary (the masks come last).
PARAM_LAYOUT = (("clip_a", np.int32, ()), ("clip_b", np.int32, ()),
                ("frame_a", np.float32, ()), ("frame_b", np.float32, ()),
                ("blend", np.float32, ()), ("grab_l", np.float32, ()),
                ("grab_r", np.float32, ()), ("root", np.float32, (4, 4)),
                ("override_rot", np.float32, (NUM_SLOTS, 4)),
                ("post_rot", np.float32, (NUM_SLOTS, 4)),
                ("override_mask", np.bool_, (NUM_SLOTS,)),
                ("post_mask", np.bool_, (NUM_SLOTS,)))
TORCH_DTYPE = {np.int32: torch.int32, np.float32: torch.float32, np.bool_: torch.bool}


def _dot4(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]) \
        + a[..., 3] * b[..., 3]


def _nlerp(qa, qb, w):
    """Normalised lerp with the hemisphere fix; ``w`` broadcasts over the
    last axis; the length is floored at 1e-12 (``jnp.maximum``)."""
    dot = _dot4(qa, qb)[..., None]
    qb = torch.where(dot < 0.0, -qb, qb)
    q = qa + (qb - qa) * w
    n = fp.sqrt(_dot4(q, q))[..., None]
    return q / torch.clamp(n, min=1e-12)


def _quat_mat4(q, scale=None):
    """[.., 4] xyzw -> [.., 4, 4] rotation (columns times ``scale`` [.., 3])
    with a zero translation."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = torch.zeros(q.shape[:-1] + (4, 4), dtype=q.dtype, device=q.device)
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    if scale is not None:
        m[..., :3, :3] = m[..., :3, :3] * scale[..., None, :]
    m[..., 3, 3] = 1.0
    return m


def matmul4(a, b):
    """[.., 4, 4] @ [.., 4, 4], each entry ((a0 b0 + a1 b1) + a2 b2) + a3 b3."""
    return ((a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :])
            + a[..., :, 2:3] * b[..., 2:3, :]) + a[..., :, 3:4] * b[..., 3:4, :]


@dataclasses.dataclass
class Rig:
    """The static per-skeleton tensors KZ and its twin read."""

    parent: torch.Tensor         # [J] i32 (-1 for a root)
    depth: torch.Tensor          # [J] i32
    joint_slot: torch.Tensor     # [J] i32: its procedural slot, -1 = none
    joint_finger: torch.Tensor   # [J] i32: row of ``grab_quats``, -1 = none
    grab_quats: torch.Tensor     # [30, 4] f32: left hand's 15, then the right's
    rest_scale: torch.Tensor     # [J, 3] f32
    inverse_bind: torch.Tensor   # [J, 4, 4] f32
    levels: list                 # [(joints, parents)] i64 per level below the roots
    n_levels: int


def _sample(bank, clip, frame):
    """Clip ``clip`` [A] at ``frame`` [A] -> (rot [A, J, 4], trans [A, J, 3])."""
    a = clip.shape[0]
    clip = clip.long()
    nf = bank.n_frames[clip]
    loop = bank.looping[clip]
    f0 = torch.floor(frame)
    frac = (frame - f0)[:, None, None]

    def wrap(f):
        return torch.where(loop, fp.float_mod(f, nf),
                           torch.clamp(torch.clamp(f, min=0.0), max=nf - 1.0)).to(torch.int64)

    base = clip * bank.f_cap
    r0 = bank.rot[base + wrap(f0)].reshape(a, -1, 4)
    r1 = bank.rot[base + wrap(f0 + 1.0)].reshape(a, -1, 4)
    t0 = bank.trans[base + wrap(f0)].reshape(a, -1, 3)
    t1 = bank.trans[base + wrap(f0 + 1.0)].reshape(a, -1, 3)
    return _nlerp(r0, r1, frac), t0 + (t1 - t0) * frac


def pose_plain(bank, rig: Rig, p):
    """The twin of KZ: -> [3, A, J, 4, 4] (joints_obj, joints_world, skin)."""
    a = p.count
    qa, ta = _sample(bank, p.clip_a, p.frame_a)
    qb, tb = _sample(bank, p.clip_b, p.frame_b)
    w = p.blend[:, None, None]
    q = _nlerp(qa, qb, w)
    t = ta + (tb - ta) * w

    # Overrides at the slots, then the finger curls.
    has_slot = rig.joint_slot >= 0
    js = torch.clamp(rig.joint_slot, min=0).long()
    over = has_slot[None, :] & p.override_mask[:, js]
    q = torch.where(over[..., None], p.override_rot[:, js], q)
    has_f = rig.joint_finger >= 0
    jf = torch.clamp(rig.joint_finger, min=0).long()
    n_half = rig.grab_quats.shape[0] // 2
    grab = torch.where(jf[None, :] < n_half, p.grab_l[:, None], p.grab_r[:, None])
    ident = torch.zeros_like(q)
    ident[..., 3] = 1.0
    curled = _nlerp(ident, rig.grab_quats[jf][None].expand_as(q), grab[..., None])
    q = torch.where((has_f[None, :] & (grab > GRAB_EPS))[..., None], curled, q)

    local = _quat_mat4(q, rig.rest_scale[None])
    local[..., :3, 3] = t
    post = has_slot[None, :] & p.post_mask[:, js]
    local = torch.where(post[..., None, None], matmul4(local, _quat_mat4(p.post_rot[:, js])),
                        local)

    world = local.clone()
    for idx, par in rig.levels:
        world[:, idx] = matmul4(world[:, par], local[:, idx])
    out = torch.empty((3,) + world.shape, dtype=torch.float32, device=world.device)
    out[0] = world
    out[1] = matmul4(p.root[:, None], world)
    out[2] = matmul4(world, rig.inverse_bind[None])
    return out


class _Plan:
    """KZ's checks for one (A, J, bank rows, clips, grab rows, device): the
    23 inputs' names, dtypes and shapes in the kernel's order
    (``csrc/pose.cu:PoseArgs``)."""

    NAMES = ("bank rot", "bank trans", "n_frames", "looping") \
        + tuple(name for name, _, _ in PARAM_LAYOUT) \
        + ("parent", "depth", "joint_slot", "joint_finger", "grab_quats", "rest_scale",
           "inverse_bind")

    def __init__(self, a, nj, rows, c, g, device):
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        self.device = device
        self.dtypes = (f32, f32, f32, b8) + tuple(TORCH_DTYPE[dt] for _, dt, _ in PARAM_LAYOUT) \
            + (i32, i32, i32, i32, f32, f32, f32)
        self.shapes = ((rows, nj * 4), (rows, nj * 3), (c,), (c,)) \
            + tuple((a,) + shp for _, _, shp in PARAM_LAYOUT) \
            + ((nj,), (nj,), (nj,), (nj,), (g, 4), (nj, 3), (nj, 4, 4))


def pose(bank, rig: Rig, p):
    """KZ: every avatar's pose in one launch -> [3, A, J, 4, 4]; the twin
    for CPU tensors.  On the card the inputs are checked against the plan
    of their shapes and the launch takes one packed argument."""
    global launches
    if p.clip_a.device.type == "cpu":
        return pose_plain(bank, rig, p)
    dev = p.clip_a.device
    a, nj = p.count, rig.parent.shape[0]
    if nj > MAX_JOINTS:
        raise ValueError(f"KZ takes at most {MAX_JOINTS} joints a skeleton, got {nj}")
    rows, c, g = bank.rot.shape[0], bank.n_frames.shape[0], rig.grab_quats.shape[0]
    if not 1 <= c <= MAX_CLIPS:
        raise ValueError(f"KZ takes 1..{MAX_CLIPS} clips a bank, got {c}")
    plan = build.plan(_plans, (a, nj, rows, c, g, dev), lambda: _Plan(a, nj, rows, c, g, dev))
    ins = ((bank.rot, bank.trans, bank.n_frames, bank.looping)
           + tuple(getattr(p, name) for name, _, _ in PARAM_LAYOUT)
           + (rig.parent, rig.depth, rig.joint_slot, rig.joint_finger, rig.grab_quats,
              rig.rest_scale, rig.inverse_bind))
    build.check_all(plan.device, ins, plan.NAMES, plan.dtypes, plan.shapes)
    out = torch.empty((3, a, nj, 4, 4), dtype=torch.float32, device=dev)
    build.launch_packed("pose_avatars", _PACK.pack(
        *(t.data_ptr() for t in ins), out.data_ptr(), bank.f_cap, g // 2, a, nj, NUM_SLOTS,
        rig.n_levels, c))
    launches += 1
    return out

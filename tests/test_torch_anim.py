"""substrata_tpu_torch.anim and avatar_graphics against the reference.

The skeleton, the clip bank and the grab poses equal the reference's; the
pose (kernel KZ's twin on the CPU) on seeded random avatars with every
option on, a non-looping clip past its end and A = 37 padding, against the
jitted ``PoseKernel``: ``joints_obj``, ``joints_world`` and ``skin`` within
1e-5 of each matrix's scale (XLA orders the 4-term dots and contracts some
products its own way; the twin rounds once per operation).  Then the
scenarios of tests/test_anim_pose.py and tests/test_avatar_skeletal.py on
the port, and an AvatarGraphicsManager driving 8 avatars for 60 frames
(a gesture, sitting, head look, arm IK) against the reference's."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.anim import pose as jpose
from substrata_tpu.anim.clips import ClipBank as JBank
from substrata_tpu.anim.clips import build_default_clips as j_clips
from substrata_tpu.anim.skeleton import build_default_humanoid as j_humanoid
from substrata_tpu.avatar_graphics import AvatarGraphicsManager as JManager
from substrata_tpu.avatar_graphics import PoseConstraint as JConstraint
from substrata_tpu.shared.avatar import Avatar as JAvatar
from substrata_tpu_torch import convert
from substrata_tpu_torch.anim import PROC_SLOTS, ClipBank, PoseKernel, build_default_humanoid
from substrata_tpu_torch.anim import pose as tpose
from substrata_tpu_torch.anim.clips import AnimationClip, CLIP_RATE, build_default_clips
from substrata_tpu_torch.anim.skeleton import trs_to_mat4_np
from substrata_tpu_torch.avatar_graphics import (ANIM_IDLE, ANIM_RUN, ANIM_WALK,
                                                 AvatarGraphicsManager, PoseConstraint)
from substrata_tpu_torch.shared.avatar import Avatar

torch.set_num_threads(2)
TOL = 1e-5
S = tpose.NUM_SLOTS


@pytest.fixture(scope="module")
def rigs():
    jskel = j_humanoid()
    jbank = JBank(jskel, j_clips(jskel))
    skel = build_default_humanoid()
    bank = ClipBank(skel, build_default_clips(skel), device="cpu")
    return jskel, jbank, jpose.PoseKernel(jskel, jbank), skel, bank, PoseKernel(skel, bank)


@pytest.fixture(scope="module")
def converted_kernel(rigs):
    """The port's PoseKernel on the reference bank's own arrays."""
    _, jbank, _, skel, _, _ = rigs
    arrays = {f: np.asarray(getattr(jbank, f)) for f in ("rot", "trans", "n_frames", "looping")}
    return PoseKernel(skel, convert.clip_bank_from_numpy(skel, arrays, jbank.names,
                                                         device="cpu"))


def test_skeleton_bank_and_grab_equal_reference(rigs):
    jskel, jbank, _, skel, bank, _ = rigs
    assert skel.names == jskel.names and skel.num_joints == 64
    for f in ("parents", "rest_trans", "rest_rot", "rest_scale", "inverse_bind"):
        np.testing.assert_array_equal(getattr(skel, f), getattr(jskel, f), err_msg=f)
    assert [list(a) for a in skel.levels()] == [list(a) for a in jskel.levels()]
    assert len(skel.levels()) == 12
    assert bank.names == jbank.names and len(bank.names) == 14 and bank.f_cap == 192
    assert tuple(bank.rot.shape) == (2688, 256) and tuple(bank.trans.shape) == (2688, 192)
    for f in ("rot", "trans", "n_frames", "looping"):
        np.testing.assert_array_equal(getattr(bank, f).numpy(), np.asarray(getattr(jbank, f)),
                                      err_msg=f)
    for s in (1.0, -1.0):
        np.testing.assert_array_equal(tpose._grab_quats(s), jpose._grab_quats(s))
    np.testing.assert_array_equal(tpose._finger_joint_indices(skel, "Left"),
                                  jpose._finger_joint_indices(jskel, "Left"))


def random_pose_arrays(a, seed, n_clips, frames_hi=60.0):
    """Seeded avatars with every option on: random clips and frames (some
    negative, some past a clip's end), blends, unit overrides and post
    rotations on about half the slots, grabs in [0, 1] (some exactly 0 or
    under the 1e-3 threshold) and random rigid roots."""
    rng = np.random.default_rng(seed)
    arr = tpose.zero_pose_arrays(a)
    arr["clip_a"][:] = rng.integers(0, n_clips, a)
    arr["clip_b"][:] = rng.integers(0, n_clips, a)
    arr["frame_a"][:] = rng.uniform(-5.0, frames_hi, a)
    arr["frame_b"][:] = rng.uniform(-5.0, frames_hi, a)
    arr["blend"][:] = rng.uniform(0.0, 1.0, a)
    for k in ("override_rot", "post_rot"):
        q = rng.normal(size=(a, S, 4))
        arr[k][:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    arr["override_mask"][:] = rng.random((a, S)) < 0.4
    arr["post_mask"][:] = rng.random((a, S)) < 0.5
    for k in ("grab_l", "grab_r"):
        g = rng.uniform(0.0, 1.0, a)
        g[::5] = 0.0
        g[1::7] = 5e-4
        arr[k][:] = g
    for i in range(a):
        q = rng.normal(size=4)
        root = trs_to_mat4_np(rng.uniform(-50, 50, 3), q / np.linalg.norm(q), np.ones(3))
        arr["root"][i] = root.astype(np.float32)
    return arr


def _jparams(arr):
    return jpose.PoseParams(**{k: jnp.asarray(v) for k, v in arr.items()})


def assert_pose_close(got, want, what):
    """Each [4, 4] matrix within TOL of its own scale (its largest entry,
    at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(axis=(-1, -2), keepdims=True), 1.0)
    err = (np.abs(got - want) / scale).max()
    assert err <= TOL, f"{what}: {err:.3g} of scale"


CASES = {
    # name: (avatars, seed, frames up to)
    "all_options_64": (64, 0, 60.0),
    "past_clip_end": (16, 1, 400.0),
    "padded_37": (37, 2, 60.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pose_matches_reference(rigs, converted_kernel, case):
    _, jbank, jkern, _, _, _ = rigs
    kern = converted_kernel
    a, seed, hi = CASES[case]
    arr = random_pose_arrays(a, seed, len(jbank.names), hi)
    if case == "past_clip_end":
        wave = jbank.clip_index("Wave")
        arr["clip_a"][:] = wave
        arr["clip_b"][::2] = wave
    if case == "padded_37":
        # pose_all's padding: avatars 37-63 are neutral rows.
        pad = tpose.zero_pose_arrays(64)
        for k in arr:
            pad[k][:a] = arr[k]
        arr = pad
    want = jkern(_jparams(arr))
    got = kern(convert.pose_params_from_numpy(arr, device="cpu"))
    for name, g, w in zip(("joints_obj", "joints_world", "skin"), got, want):
        assert np.isfinite(g.numpy()).all()
        assert_pose_close(g.numpy(), w, f"{case} {name}")


def test_packed_params_round_trip():
    arr = random_pose_arrays(5, 3, 14)
    p = convert.pose_params_from_numpy(arr, device="cpu")
    for k, v in arr.items():
        np.testing.assert_array_equal(getattr(p, k).numpy(), v, err_msg=k)


# --- tests/test_anim_pose.py's scenarios on the port. --------------------

@pytest.fixture(scope="module")
def rig(rigs):
    return rigs[3], rigs[4], rigs[5]


def _params(n, **fields):
    arr = tpose.zero_pose_arrays(n)
    for k, v in fields.items():
        arr[k][...] = v
    return convert.pose_params_from_numpy(arr, device="cpu")


def _np(x):
    return [t.numpy() for t in x]


def test_default_humanoid_shape(rig):
    skel, _, _ = rig
    assert skel.num_joints == 64 and skel.joint_index("Hips") == 0
    for name in ("Neck", "Head", "LeftFoot", "RightHandPinky4", "LeftHandThumb1", "Spine2",
                 "LeftEye"):
        assert skel.joint_index(name) >= 0, name
    assert skel.parents[0] == -1 and (skel.parents[1:] >= 0).all()
    assert 1.4 < skel.rest_world()[skel.joint_index("Head"), 1, 3] < 1.8


def test_rest_pose_skin_is_identity(rig):
    skel, _, _ = rig
    rest_clip = AnimationClip("rest", rot=np.tile(skel.rest_rot[None], (2, 1, 1)),
                              trans=np.tile(skel.rest_trans[None], (2, 1, 1)))
    kern2 = PoseKernel(skel, ClipBank(skel, [rest_clip], device="cpu"))
    obj, world, skin = _np(kern2(tpose.zero_pose_params(3, device="cpu")))
    np.testing.assert_allclose(skin, np.tile(np.eye(4), (3, skel.num_joints, 1, 1)),
                               atol=2e-5)
    np.testing.assert_allclose(obj[0], skel.rest_world(), atol=2e-5)


def test_fk_matches_numpy_oracle(rig):
    skel, bank, kern = rig
    a = 4
    frames = np.random.default_rng(0).uniform(0, 20, a).astype(np.float32)
    ci = bank.clip_index("walking")
    obj, _, _ = _np(kern(_params(a, clip_a=ci, clip_b=ci, frame_a=frames, frame_b=frames)))
    clip = build_default_clips(skel)[ci]
    f = frames[2]
    f0, frac = int(np.floor(f)) % clip.num_frames, f - np.floor(f)
    f1 = (f0 + 1) % clip.num_frames
    q0, q1 = clip.rot[f0], clip.rot[f1]
    q1 = np.where(np.sum(q0 * q1, -1, keepdims=True) < 0, -q1, q1)
    q = q0 + (q1 - q0) * frac
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = clip.trans[f0] + (clip.trans[f1] - clip.trans[f0]) * frac
    local = trs_to_mat4_np(t, q, skel.rest_scale)
    ref = np.empty_like(local)
    for j in range(skel.num_joints):
        par = skel.parents[j]
        ref[j] = local[j] if par < 0 else ref[par] @ local[j]
    np.testing.assert_allclose(obj[2], ref, atol=1e-4)


def test_blend_midpoint_between_clips(rig):
    skel, bank, kern = rig
    obj, _, _ = _np(kern(_params(3, clip_a=bank.clip_index("idle"),
                                 clip_b=bank.clip_index("sitting"), blend=[0.0, 0.5, 1.0])))
    knee, foot = skel.joint_index("LeftLeg"), skel.joint_index("LeftFoot")
    z0, z05, z1 = (float(obj[i, knee, 2, 3]) for i in range(3))
    assert z0 < z05 < z1 and z1 > z0 + 0.25
    assert float(obj[2, foot, 2, 3]) > float(obj[0, foot, 2, 3]) + 0.2


def test_override_rotation_turns_head_only(rig):
    skel, _, kern = rig
    s_head = PROC_SLOTS.index("Head")
    arr = tpose.zero_pose_arrays(2)
    arr["override_rot"][1, s_head] = [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]
    arr["override_mask"][1, s_head] = True
    o, _, _ = _np(kern(convert.pose_params_from_numpy(arr, device="cpu")))
    head, leye = skel.joint_index("Head"), skel.joint_index("LeftEye")
    eye_off0 = o[0, leye, :3, 3] - o[0, head, :3, 3]
    eye_off1 = o[1, leye, :3, 3] - o[1, head, :3, 3]
    assert eye_off0[2] > 0.05
    assert abs(eye_off1[2]) < 0.04 and abs(eye_off1[0]) > 0.05
    np.testing.assert_allclose(o[0, 0], o[1, 0], atol=1e-6)


def test_post_transform_bends_leg_chain(rig):
    skel, _, kern = rig
    s = PROC_SLOTS.index("LeftUpLeg")
    arr = tpose.zero_pose_arrays(2)
    arr["post_rot"][1, s] = [-np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]
    arr["post_mask"][1, s] = True
    o, _, _ = _np(kern(convert.pose_params_from_numpy(arr, device="cpu")))
    knee = skel.joint_index("LeftLeg")
    assert o[0, knee, 1, 3] < o[0, 0, 1, 3] - 0.3
    assert o[1, knee, 2, 3] > o[0, knee, 2, 3] + 0.3


def test_grab_curls_fingers(rig):
    skel, _, kern = rig
    o, _, _ = _np(kern(_params(2, grab_r=[0.0, 1.0])))
    tip, hand = skel.joint_index("RightHandIndex4"), skel.joint_index("RightHand")
    d_open = np.linalg.norm(o[0, tip, :3, 3] - o[0, hand, :3, 3])
    d_curl = np.linalg.norm(o[1, tip, :3, 3] - o[1, hand, :3, 3])
    assert d_curl < d_open * 0.75
    ltip = skel.joint_index("LeftHandIndex4")
    np.testing.assert_allclose(o[0, ltip], o[1, ltip], atol=1e-6)


def test_root_transform_applies_to_world(rig):
    _, _, kern = rig
    root = np.eye(4, dtype=np.float32)
    root[:3, 3] = [10.0, 20.0, 30.0]
    obj, world, _ = _np(kern(_params(1, root=root[None])))
    np.testing.assert_allclose(world[0, 0, :3, 3], obj[0, 0, :3, 3] + [10, 20, 30], atol=1e-5)


def test_nonlooping_clip_clamps_at_end(rig):
    _, bank, kern = rig
    ci = bank.clip_index("Wave")
    nf = float(bank.n_frames_host[ci])
    f = np.array([nf - 1.0, nf + 50.0], np.float32)
    o, _, _ = _np(kern(_params(2, clip_a=ci, clip_b=ci, frame_a=f, frame_b=f)))
    np.testing.assert_allclose(o[0], o[1], atol=1e-5)


def test_walk_clip_is_periodic_and_antisymmetric(rig):
    skel, _, _ = rig
    walk = {c.name: c for c in build_default_clips(skel)}["walking"]
    assert abs(walk.duration - 1.015) < 0.06
    lu, ru = skel.joint_index("LeftUpLeg"), skel.joint_index("RightUpLeg")
    np.testing.assert_allclose(walk.rot[0, lu], walk.rot[walk.num_frames // 2, ru], atol=0.05)
    assert CLIP_RATE == 24.0


# --- tests/test_avatar_skeletal.py's scenarios on the port. --------------

def _avatar(uid, pos=(0, 0, 0), cls=Avatar):
    av = cls(uid=uid, name=f"a{uid}")
    av.pos = np.array(pos, np.float64)
    av.rotation = np.zeros(3)
    av.anim_state = 0
    av.entered_vehicle_uid = 0
    return av


@pytest.fixture(scope="module")
def mgr():
    return AvatarGraphicsManager(device="cpu")


def test_pose_all_batches_all_avatars(mgr):
    avs = [_avatar(i + 1, (i * 2.0, 0, 0)) for i in range(3)]
    for step in range(10):
        for k, av in enumerate(avs):
            av.pos = np.array([k * 2.0 + step * 0.05 * k, 0, 0])
            mgr.update_avatar(av, 1 / 60)
    poses = mgr.pose_all()
    assert set(poses) == {1, 2, 3}
    for jw in poses.values():
        assert jw.shape[1:] == (4, 4) and np.isfinite(jw).all()
    g = mgr.by_uid[3]
    hips, head = g.get_joint_world("Hips"), g.get_joint_world("Head")
    assert abs(hips[0, 3] - avs[2].pos[0]) < 0.2
    assert head[2, 3] > hips[2, 3] + 0.3
    for uid in (1, 2, 3):
        mgr.remove_avatar(uid)


def test_walk_changes_pose_over_time(mgr):
    av = _avatar(7)
    dt = 1 / 60
    feet = []
    for step in range(40):
        av.pos = np.array([step * 3.0 * dt, 0.0, 0.0])
        mgr.update_avatar(av, dt)
        if step > 20:
            mgr.pose_all()
            feet.append(mgr.by_uid[7].get_joint_world("LeftFoot")[:3, 3].copy())
    assert mgr.by_uid[7].cur_anim == ANIM_WALK
    feet = np.array(feet)
    assert feet[:, 2].max() - feet[:, 2].min() > 0.02
    mgr.remove_avatar(7)


def test_gesture_plays_and_expires(mgr):
    av = _avatar(8)
    dt = 1 / 60
    mgr.update_avatar(av, dt)
    g = mgr.by_uid[8]
    assert g.perform_gesture("Wave")
    for _ in range(int(1.2 / dt)):
        mgr.update_avatar(av, dt)
    assert g.cur_anim == "Wave"
    mgr.pose_all()
    hand_up = g.get_joint_world("RightHand")[2, 3]
    for _ in range(int(3.0 / dt)):
        mgr.update_avatar(av, dt)
    assert g.gesture is None and g.cur_anim == ANIM_IDLE
    mgr.pose_all()
    assert hand_up > g.get_joint_world("RightHand")[2, 3] + 0.2
    mgr.remove_avatar(8)


def test_sitting_constraint_shapes_legs(mgr):
    av = _avatar(9)
    seat = np.eye(4, dtype=np.float32)
    seat[:3, 3] = [5.0, 0.0, 1.0]
    pc = PoseConstraint(sitting=True, seat_to_world=seat, upper_body_rot_angle=0.2,
                        upper_leg_rot_angle=1.3, lower_leg_rot_angle=-0.5,
                        upper_leg_apart_angle=0.1)
    for _ in range(30):
        av.entered_vehicle_uid = 42
        mgr.update_avatar(av, 1 / 60)
        g = mgr.by_uid[9]
        g.set_sitting(True, pc)
    mgr.pose_all()
    hips = g.get_joint_world("Hips")[:3, 3]
    np.testing.assert_allclose(hips[:2], [5.0, 0.0], atol=0.3)
    knee, foot = g.get_joint_world("LeftLeg")[:3, 3], g.get_joint_world("LeftFoot")[:3, 3]
    assert knee[1] > hips[1] + 0.15 and knee[2] > foot[2]
    mgr.remove_avatar(9)


def test_head_look_rotates_head_not_hips(mgr):
    av = _avatar(10)
    for _ in range(5):
        mgr.update_avatar(av, 1 / 60)
    mgr.pose_all()
    g = mgr.by_uid[10]
    head0 = g.get_joint_world("Head")[:3, :3].copy()
    g.cur_head_rot_z = 0.0
    av.rotation = np.array([0.0, 0.0, 0.6])
    mgr.update_avatar(av, 1 / 60)
    mgr.pose_all()
    assert not np.allclose(head0, g.get_joint_world("Head")[:3, :3], atol=1e-4)
    mgr.remove_avatar(10)


def test_arm_ik_reaches_toward_hold_point(mgr):
    av = _avatar(11)
    for _ in range(3):
        av.entered_vehicle_uid = 5
        mgr.update_avatar(av, 1 / 60)
    g = mgr.by_uid[11]
    pc = PoseConstraint(sitting=True, seat_to_world=np.eye(4, dtype=np.float32),
                        upper_leg_rot_angle=1.0, lower_leg_rot_angle=-0.9)
    g.set_sitting(True, pc)
    mgr.update_avatar(av, 1 / 60)
    mgr.pose_all()
    wrist_before = g.get_joint_world("RightHand")[:3, 3].copy()
    hold = np.array([0.15, 0.45, 0.95])
    pc.right_hand_hold_point_ws = hold
    for _ in range(8):
        mgr.pose_all()
        err = np.linalg.norm(g.get_joint_world("RightHand")[:3, 3] - hold)
    assert err < np.linalg.norm(wrist_before - hold) and err < 0.25
    tip, hand = g.get_joint_world("RightHandIndex4")[:3, 3], g.get_joint_world("RightHand")[:3, 3]
    assert np.linalg.norm(tip - hand) < 0.16
    mgr.remove_avatar(11)


def test_run_transition_uses_fast_blend(mgr):
    av = _avatar(12)
    mgr.update_avatar(av, 1 / 60)
    for step in range(30):
        av.pos = np.array([(step + 1) * 8.0 / 60, 0.0, 0.0])
        mgr.update_avatar(av, 1 / 60)
    g = mgr.by_uid[12]
    assert g.cur_anim == ANIM_RUN and g.blend_time in (0.1, 0.2)
    mgr.remove_avatar(12)


# --- 8 avatars for 60 frames through both managers. ----------------------

def drive_managers(frames=60, n=8):
    """Both packages' managers on the same scripted avatars: walkers,
    a runner, an idler who turns his head, a waver (gesture at frame 5),
    one seated with a hand on a hold point (arm IK) from frame 10."""
    runs = {}
    for pkg, (M, A, C) in {"ref": (JManager, JAvatar, JConstraint),
                           "port": (lambda: AvatarGraphicsManager(device="cpu"), Avatar,
                                    PoseConstraint)}.items():
        mgr = M()
        avs = [_avatar(i + 1, (3.0 * i, -2.0 * i, 1.67), cls=A) for i in range(n)]
        seat = np.eye(4, dtype=np.float32)
        seat[:3, 3] = [4.0, 1.0, 0.5]
        pc = C(sitting=True, seat_to_world=seat, upper_body_rot_angle=0.1,
               upper_leg_rot_angle=1.3, lower_leg_rot_angle=-0.5)
        out = []
        for f in range(frames):
            for i, av in enumerate(avs):
                speed = (0.0, 1.5, 3.0, 8.0, 0.0, 1.0, 0.0, 2.0)[i % 8]
                heading = 0.3 * i + (0.8 if (i == 0 and f >= 20) else 0.0)
                av.rotation = np.array([0.0, 0.0, heading])
                av.pos = av.pos + np.array([math.cos(heading), math.sin(heading), 0.0]) \
                    * speed / 60
                if i == 6:
                    av.entered_vehicle_uid = 99
                mgr.update_avatar(av, 1 / 60)
            if f == 5:
                mgr.by_uid[5].perform_gesture("Wave")
            if f == 10:
                g = mgr.by_uid[7]
                pc.right_hand_hold_point_ws = np.array([4.2, 1.4, 1.3])
                g.set_sitting(True, pc)
            mgr.pose_all()
            out.append([(g.joints_obj.copy(), g.joints_world.copy(), g.skin_matrices.copy())
                        for g in mgr.by_uid.values()])
        runs[pkg] = out
    return runs


def test_manager_8_avatars_60_frames_match_reference():
    runs = drive_managers()
    for f, (jf, tf) in enumerate(zip(runs["ref"], runs["port"])):
        for i, (ja, ta) in enumerate(zip(jf, tf)):
            for name, j, t in zip(("obj", "world", "skin"), ja, ta):
                assert_pose_close(t, j, f"frame {f} avatar {i} {name}")

"""Build and bind the CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files compile with nvcc into ONE shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which
is loaded with ctypes.  Each source compiles in its own nvcc process, all
started together, and one more nvcc links them.  The build runs at first
use, into
``substrata_tpu_torch/_build/`` (listed in .gitignore), under a name that
carries a hash of the sources and flags, so an edit rebuilds.

Every exported function takes raw device pointers and the CUDA stream as
``c_void_p``, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; ``launch`` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No fused multiply-add contraction: each kernel repeats its plain
    # twin's operations in the same order, and separate rounding keeps the
    # two bit-comparable (a kernel that fuses says so with __fmaf_rn).
    "-fmad=false",
    "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float

# name -> argtypes (all return int = cudaError_t).
SIGNATURES = {
    # pair_a, pair_b, pair_valid, pos, quat, params, fric, rest, sensor,
    # P, out a, b, point, normal, pen, valid, fric, rest, key, touch, stream
    "box_box_rows": [P] * 9 + [I] + [P] * 10 + [P],
    # pos, quat, shape_type, shape_params, alive, layer, motion, sensor,
    # awake, fric, rest, heights, hf_origin, hf_cell_w, has_hf, hull verts,
    # hull n_verts, tri verts, tris, cell_tris, tri origin, tri cell_w, N,
    # HX, HY, flags (bit 0 = flat, bits 1-4 = present shape types, bit 5 =
    # trimesh), K, H, max hull verts, GX, GY, cell cap, candidates, out a,
    # b, point, normal, pen, valid, fric, rest, key, stream
    "static_contacts": [P] * 22 + [I] * 11 + [P] * 9 + [P],
    # static rows (dir, ang, r, k, target, fric, valid, y, l), pair rows
    # (dir, ang_a, ang_b, ra, rb, k, target, fric, valid, ab, y, l),
    # linvel, angvel, out (s_y, s_l, p_y, p_l, dlin_s, dang_s, block),
    # N, K, Q, WM, beta, warm, stream
    "solve_rows": [P] * 9 + [P] * 12 + [P] * 2 + [P] * 7 + [I] * 4 + [F, I] + [P],
    # tbl, w, im, block, dlin_s, dang_s, linvel, angvel, out linvel,
    # angvel, N, CPB, stream
    "solve_bodies": [P] * 8 + [P] * 2 + [I] * 2 + [P],
    # pool, buf_offset, buf_len, playhead, eff_delta, mix_factor, looping,
    # stream_mode, stream_write_head, active, out samples, new_playhead,
    # S, L, B, nw, n_rows, li_max, stream
    "audio_fetch": [P] * 10 + [P] * 2 + [I] * 5 + [F] + [P],
    # samples, lp_state, alpha, use_lp, spatial, hist, bank, dir_idx,
    # prev_gl, prev_gr, gl, gr, ramp, gain, send_gain, out wl, wr, ws,
    # lp_out, new_hist, level, S, B, T, use_hrtf, stream
    "audio_spatialise": [P] * 15 + [P] * 6 + [I] * 4 + [P],
    # wl, wr, ws, master_volume, lines, write_idx, delays, feedback, wet,
    # out, lines_out, write_idx_out, S, B, D, has_room, stream
    "audio_downmix_reverb": [P] * 9 + [P] * 3 + [I] * 4 + [P],
    # origins, dirs, max_ts, exclude, pos, quat, bound_radius, shape_type,
    # shape_params, alive, layer, table, os_idx, heights, hf_origin,
    # hf_cell_w, has_hf, hull planes, hull n_faces, tri verts, tris,
    # tri_mats, tri_owner, cell_tris, tri origin, tri cell_w, R,
    # num_buckets, cap, n_os, HX, HY, n_steps, body_steps, K, flags (bit 3
    # = trimesh), H, max hull faces, GX, GY, cell cap, 1 / cell_size, out t,
    # normal, body, hit, material, stream
    "ray_trace": [P] * 26 + [I] * 15 + [F] + [P] * 5 + [P],
    # 33 vehicle rows (kernels/vehicles.py:KERNEL_FIELDS), 5 inputs,
    # body_pos, body_quat, body_lin, body_ang, mass, iw, hit_t, hit_n,
    # hit_ok, water_z, V, dt, out dv, dw, steering, sus_len, omega, rot,
    # unflip, contact, gear, shift_timer, rpm, stream
    "vehicle_forces": [P] * 33 + [P] * 5 + [P] * 10 + [I, F] + [P] * 11 + [P],
    # ba, bb, bvalid, pos, quat, params, fric, rest, sensor, cap, code, wm,
    # blocked, out a, b, point, normal, pen, valid, fric, rest, key, touch,
    # stream
    "closed_form_rows": [P] * 9 + [I] * 4 + [P] * 10 + [P],
    # ba, bb, bvalid, pos, quat, params, fric, rest, sensor, hull verts,
    # n_verts, planes, n_faces, cap, code, wm, blocked, H, max verts, max
    # faces, out a, b, point, normal, pen, valid, fric, rest, key, touch,
    # stream
    "convex_rows": [P] * 13 + [I] * 7 + [P] * 10 + [P],
    # 9 character fields, pos, quat, linvel, angvel, shape_type, params,
    # bound_radius, alive, layer, sensor, table, os_idx, heights, hf_origin,
    # hf_cell_w, has_hf, water_z, scal, tri verts, tris, cell_tris, tri
    # origin, tri cell_w, num_buckets, cap, n_os, n_centers, HX, HY, flat,
    # GX, GY, cell cap (0 = no trimesh), 1 / cell_size, out 9 character fields,
    # packed, stream
    "character_update": [P] * 9 + [P] * 18 + [P] * 5 + [I] * 10 + [F] + [P] * 10 + [P],
    # pos, quat, linvel, angvel, awake, sleep_timer, alive, motion_type,
    # bound_radius, tick_in, N, out pos, quat, linvel, angvel, awake,
    # sleep_timer, stream
    "apply_tick_in": [P] * 10 + [I] + [P] * 6 + [P],
    # newly_awake, newly_asleep, entered_water, touching, pair_a, pair_b,
    # num_pairs, overflow, num_contacts, num_awake, steps_left, pos, quat,
    # linvel, angvel, underwater, N, P, out digest, block, stream
    "digest_tblock": [P] * 16 + [I] * 2 + [P] * 2 + [P],
    # pos, alive, collidable, awake, motion_type, bound_radius, N, buckets,
    # cap, 1 / cell_size, cell_size, with_flags, out cells, scratch, table,
    # overflow, stream
    "cell_table": [P] * 6 + [I] * 3 + [F, F, I] + [P] * 4 + [P],
    # body pos, quat, linvel, angvel, inv_mass, inv_inertia, awake, table,
    # sign; static a, point, normal, pen, valid, fric, rest, key; pair a,
    # b, point, normal, pen, valid, fric, rest, key; baumgarte,
    # restitution_threshold, cache (or null); N, K, Q, wm, CPB, H; dt; out
    # s_dir, s_ang, s_r, s_k, s_target, s_valid, p_dir, p_ang_a, p_ang_b,
    # p_ra, p_rb, p_k, p_target, p_valid, p_ab, tbl, w, im, y_s, y_p, hash
    # slot, valid; stream
    "solve_setup": [P] * 29 + [I] * 6 + [F] + [P] * 22 + [P],
    # cache, slot, valid, static a, key, pair a, key, lam_s, s_valid, lam_p,
    # p_valid, S, P, H, scratch last, out, stream
    "cache_refresh": [P] * 11 + [I] * 3 + [P] * 2 + [P],
    # code, segments, blocks, n_blocks, time, idx, n_inst, scratch [R, B],
    # B, out [B, 6], stream
    "winter_eval": [P] * 3 + [I] + [P] * 4 + [I] + [P] + [P],
    # pair a, b, valid, shape_type, P, max_pairs, active code mask, out
    # order, src, ba, bb, bvalid, slot_of_pair, overflow, stream
    "layout_group": [P] * 4 + [I] * 3 + [P] * 7 + [P],
    # slot_of_pair, host array of bucket flag pointers, host array of slot
    # offsets, n buckets, P, out, stream
    "layout_touching": [P] * 3 + [I] * 2 + [P] + [P],
    # 9 contact fields, C, max_active, tile scratch, 9 outputs, overflow,
    # stream
    "layout_compact": [P] * 9 + [I] * 2 + [P] + [P] * 9 + [P] + [P],
    # entry a, b, their stride, occupancy, C, N, CPB, scratch, out table,
    # sign, counts, stream
    "layout_incidence": [P, P, I, P, I, I, I, P, P, P, P, P],
    # pos0, inv_mass, awake, static valid, normal, pen, pair a, b, valid,
    # normal, pen, table, sign, slop; beta; N, K, Q, WM, CPB, iters; impulse
    # and position scratch, out, stream
    "solve_positions": [P] * 14 + [F] + [I] * 6 + [P] * 3 + [P],
    # awake, linvel, alive, motion_type, pair a, b, valid, N, P, out, stream
    "strike_wake": [P] * 7 + [I] * 2 + [P] + [P],
    # awake, prev_awake, sleep_timer, alive, motion_type, linvel, angvel,
    # contact a, b, valid, pen, lambda; lambda stride; static valid, pen,
    # table, sign, sleep_lin_vel, sleep_ang_vel, sleep_time, steps_left;
    # dt; N, wm, K, CPB; flag scratch, out awake, timer, linvel, angvel,
    # newly_awake, newly_asleep, steps_left; stream
    "sleep_pass": [P] * 12 + [I] + [P] * 8 + [F] + [I] * 4 + [P] * 8 + [P],
    # pos, linvel, alive, awake, collidable, motion_type, bound_radius,
    # shape_type, shape_params; its row stride, N; KP's table, cells,
    # overflow; buckets, cell cap, ppb, max_pairs, has_oversize, rebuild;
    # margin, dt, margin cap; interval; cell_size; out margins, scratch,
    # pair a, b, valid, num_pairs, overflow, steps_left; stream
    "find_pairs": [P] * 9 + [I] * 2 + [P] * 3 + [I] * 6 + [F] * 3 + [I] + [F] + [P] * 8 + [P],
    # bank rot, trans, n_frames, looping, f_cap; clip_a, clip_b, frame_a,
    # frame_b, blend, grab_l, grab_r, root, override_rot, post_rot,
    # override_mask, post_mask; parent, depth, joint_slot, joint_finger,
    # grab_quats, n_half; rest_scale, inverse_bind; A, J, S, n_levels; out,
    # stream
    # heights, origin, cell_w, xy, HX, HY, P, with_normals, out, stream
    "terrain_heights": [P] * 4 + [I] * 4 + [P] + [P],
    # heights, origin, cell_w, leaf_origin, leaf_width, HX, HY, L, res,
    # 1 / res, out, stream
    "terrain_chunks": [P] * 5 + [I] * 4 + [F] + [P] + [P],
    # heights, origin, cell_w, cells, HX, HY, C, K, key (2 x uint32),
    # scatter cell width, max slope cos, out, stream
    "terrain_scatter": [P] * 4 + [I] * 4 + [U] * 2 + [F] * 2 + [P] + [P],
    # 13 particle fields (pos ... alive), rows, cursor, n, cap, stream
    "spawn_rows": [P] * 13 + [P] + [I] * 3 + [P],
    "pose_avatars": [P] * 4 + [I] + [P] * 12 + [P] * 5 + [I] + [P] * 2 + [I] * 4 + [P] + [P],
    # alive, paused, finished, spatial, pos, vel, delta, doppler_factor,
    # mute_factor, mute_target, mute_rate, volume, num_occlusions; listener
    # pos, vel, right, forward, up; dop_alpha, dt_block; S, L, use_hrtf;
    # out, stream
    "audio_setup": [P] * 13 + [P] * 5 + [F] * 2 + [I] * 3 + [P] + [P],
    # finished, looping, stream_mode, active, new_heads, buf_len, level,
    # smoothed_level, alive, remove_on_finish; S, L; out, stream
    "audio_epilogue": [P] * 10 + [I] * 2 + [P] + [P],
    # body_slot, y_fwd_quat, wheel_attach, wheel_radius, sus_max; body pos,
    # quat, linvel, angvel, inv_mass, inv_inertia; V; out, stream
    "vehicle_setup": [P] * 11 + [I] + [P] + [P],
    # slots, dv, dw; V, N; linvel, angvel, awake, sleep_timer; stream
    "vehicle_scatter": [P] * 3 + [I] * 2 + [P] * 4 + [P],
}

_lib = None
build_seconds = None


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA kernels")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsubstrata_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu if the library for these sources is missing;
    returns its path.  ``verbose`` adds ``-Xptxas -v`` and prints nvcc's
    report (registers, shared memory, spills per kernel)."""
    global build_seconds
    out = library_path()
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    t0 = time.perf_counter()
    jobs = []
    for src, obj in zip(cu, objs):
        cmd = [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
            + ["-c", "-o", obj, src]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    report = []
    try:
        for cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{stdout}\n{stderr}")
            report.append(stdout + stderr)
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", tmp] + objs
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(report))
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _arg(x):
    if isinstance(x, torch.Tensor):
        return ctypes.c_void_p(x.data_ptr())
    return x


def launch(name: str, *args):
    """Call kernel launcher ``name`` on the current stream; tensors pass as
    device pointers.  Raises if the launch reported an error."""
    lib = library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib, name)(*[_arg(a) for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: "
                           f"{lib.kernel_error_string(rc).decode()} ({rc})")


def check(t: torch.Tensor, name: str, dtype, shape, device):
    """Wrapper-side argument validation before a pointer reaches a kernel."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

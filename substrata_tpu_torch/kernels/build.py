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
    # one host buffer of 8-byte slots (kernels/box_box.py:_PACK: pair_a,
    # pair_b, pair_valid, pos, quat, params, fric, rest, sensor, out a, b,
    # point, normal, pen, valid, fric, rest, key, touch, P), stream
    "box_box_rows": [P, P],
    # one host buffer of 8-byte slots (kernels/static_contacts.py:_PACK:
    # pos, quat, shape_type, shape_params, alive, layer, motion, sensor,
    # awake, fric, rest, heights, hf_origin, hf_cell_w, has_hf, hull verts,
    # hull n_verts, tri verts, tris, cell_tris, tri origin, tri cell_w, N,
    # HX, HY, flags (bit 0 = flat, bits 1-4 = present shape types, bit 5 =
    # trimesh), K, H, max hull verts, GX, GY, cell cap, candidates, out a,
    # b, point, normal, pen, valid, fric, rest, key), stream
    "static_contacts": [P, P],
    # one host buffer of 8-byte slots (kernels/solve.py:_PASS: the rows in
    # the solve's row layout, the state in, linvel, angvel, the state out,
    # dlin_s, dang_s, block, tbl, w, im, out linvel, angvel, N, K, Q, WM,
    # CPB, warm, beta as a double), stream
    "solve_pass": [P, P],
    # one host buffer of 8-byte slots (kernels/audio_mix.py:_SPATIALISE_PACK:
    # the fetch's pool, buf_offset, buf_len, playhead, eff_delta,
    # mix_factor, looping, stream_mode, stream_write_head, active; lp_state,
    # alpha, use_lp, spatial, hist, bank, dir_idx, prev_gl, prev_gr, gl, gr,
    # ramp, gain, send_gain; the epilogue's finished, smoothed_level, alive,
    # remove_on_finish; out wl, wr, ws, lp_out, new_hist, level, epilogue,
    # new_playhead; S, B, T, L, nw, n_rows, use_hrtf; li_max as a double),
    # stream
    "audio_spatialise": [P, P],
    # one host buffer of 8-byte slots (kernels/audio_mix.py:_DOWNMIX_PACK:
    # wl, wr, ws, master_volume, lines, write_idx, delays, feedback, wet,
    # out, lines_out, write_idx_out, S, B, D, has_room), stream
    "audio_downmix_reverb": [P, P],
    # one host buffer of 8-byte slots (kernels/ray_trace.py:_launch:
    # origins, dirs, max_ts, exclude, pos, quat, bound_radius, shape_type,
    # shape_params, alive, layer, table, os_idx, heights, hf_origin,
    # hf_cell_w, has_hf, hull planes, hull n_faces, tri verts, tris,
    # tri_mats, tri_owner, cell_tris, tri origin, tri cell_w, R,
    # num_buckets, cap, n_os, HX, HY, n_steps, body_steps, K, flags (bit 3
    # = trimesh), H, max hull faces, GX, GY, cell cap, 1 / cell_size as a
    # double, out t, normal, body, hit, material), stream
    "ray_trace": [P, P],
    # one host buffer of 8-byte slots (kernels/vehicles.py:_PACK: the 33
    # vehicle rows of KERNEL_FIELDS, 5 inputs, body_pos, body_quat,
    # body_lin, body_ang, mass, iw, hit_t, hit_n, hit_ok, water_z, the
    # output buffer, V, dt as a double), stream
    "vehicle_forces": [P, P],
    # one host buffer (kernels/closed_forms.py:_PACK: 8-byte slots ba, bb,
    # bvalid, pos, quat, params, fric, rest, sensor, out a, b, point,
    # normal, pen, valid, fric, rest, key, touch, blocked, buckets, blocks;
    # then the bucket table), stream
    "closed_form_buckets": [P, P],
    # one host buffer (kernels/convex.py:_PACK: 8-byte slots ba, bb, bvalid,
    # pos, quat, params, fric, rest, sensor, hull verts, n_verts, planes,
    # n_faces, out a, b, point, normal, pen, valid, fric, rest, key, touch,
    # blocked, buckets, blocks, H, max verts, max faces; then the bucket
    # table), stream
    "convex_buckets": [P, P],
    # one host buffer of 8-byte slots (kernels/character.py:_launch: 9
    # character fields, pos, quat, linvel, angvel, shape_type, params,
    # bound_radius, alive, layer, sensor, table, os_idx, heights, hf_origin,
    # hf_cell_w, has_hf, water_z, scal, tri verts, tris, cell_tris, tri
    # origin, tri cell_w, num_buckets, cap, n_os, n_centers, HX, HY, flat,
    # GX, GY, cell cap (0 = no trimesh), 1 / cell_size as a double, out 9
    # character fields, packed), stream
    "character_update": [P, P],
    # one host buffer of 8-byte slots (kernels/serving_io.py:_TICK_PACK:
    # pos, quat, linvel, angvel, awake, sleep_timer, alive, motion_type,
    # bound_radius, tick_in, out, N), stream
    "apply_tick_in": [P, P],
    # one host buffer of 8-byte slots (kernels/serving_io.py:_DIGEST_PACK:
    # newly_awake, newly_asleep, entered_water, touching, pair_a, pair_b,
    # num_pairs, overflow, num_contacts, num_awake, steps_left, pos, quat,
    # linvel, angvel, underwater, out digest, block, scratch, N, P), stream
    "digest_tblock": [P, P],
    # pos, alive, collidable, awake, motion_type, bound_radius, N, buckets,
    # cap, 1 / cell_size, cell_size, with_flags, out cells, scratch, table,
    # overflow, stream
    "cell_table": [P] * 6 + [I] * 3 + [F, F, I] + [P] * 4 + [P],
    # one host buffer of 8-byte slots (kernels/solve_setup.py:_PACK: body
    # pos, quat, linvel, angvel, inv_mass, inv_inertia, awake, table, sign;
    # static a, point, normal, pen, valid, fric, rest, key; pair a, b,
    # point, normal, pen, valid, fric, rest, key; baumgarte,
    # restitution_threshold, cache (or 0); N, K, Q, wm, CPB, H; dt as a
    # double; out s_dir, s_ang, s_r, s_k, s_target, s_valid, p_dir, p_ang_a,
    # p_ang_b, p_ra, p_rb, p_k, p_target, p_valid, p_ab, tbl, w, im, y_s,
    # y_p, hash slot, valid, body-term scratch), stream
    "solve_setup": [P, P],
    # cache, slot, valid, static a, key, pair a, key, lam_s, s_valid, lam_p,
    # p_valid, S, P, H, lam_s's row and component strides, lam_p's, scratch
    # last, out, stream
    "cache_refresh": [P] * 11 + [I] * 3 + [I] * 4 + [P] * 2 + [P],
    # code, segments, blocks, n_blocks, time, idx, n_inst, scratch [R, B],
    # B, out [B, 6], stream
    "winter_eval": [P] * 3 + [I] + [P] * 4 + [I] + [P] + [P],
    # pair a, b, valid, shape_type, P, max_pairs, active code mask, out
    # order, src, ba, bb, bvalid, slot_of_pair, overflow, stream
    "layout_group": [P] * 4 + [I] * 3 + [P] * 7 + [P],
    # slot_of_pair, host array of bucket flag pointers, host array of slot
    # offsets, n buckets, P, out, stream
    "layout_touching": [P] * 3 + [I] * 2 + [P] + [P],
    # one host buffer of 8-byte slots (kernels/layout.py:_COMPACT_PACK: 9
    # contact fields, block scratch, out, C, max_active, most blocks),
    # stream
    "layout_compact": [P, P],
    # one host buffer of 8-byte slots (kernels/layout.py:_INC_PACK: entry
    # a, b, occupancy, scratch, out table, sign, counts, stride, C, N, CPB),
    # stream
    "layout_incidence": [P, P],
    # one host buffer of 8-byte slots (kernels/positions.py:_PACK: pos0,
    # inv_mass, awake, static valid, normal, pen, pair a, b, valid, normal,
    # pen, table, sign, slop; position scratch, out; N, K, Q, WM, CPB, iters;
    # beta as a double), stream
    "solve_positions": [P, P],
    # awake, linvel, alive, motion_type, pair a, b, valid, N, P, out, stream
    "strike_wake": [P] * 7 + [I] * 2 + [P] + [P],
    # one host buffer of 8-byte slots (kernels/sleep.py:_PACK: awake,
    # prev_awake, sleep_timer, alive, motion_type, linvel, angvel, contact a,
    # b, valid, pen, lambda, static valid, pen, table, sign, sleep_lin_vel,
    # sleep_ang_vel, sleep_time, steps_left, scratch, out; lambda's row
    # stride, N, wm, K, CPB, log2 of the lanes a body; dt as a double), stream
    "sleep_pass": [P, P],
    # one host buffer of 8-byte slots (kernels/pairs.py:_PACK: pos, linvel,
    # alive, awake, collidable, motion_type, bound_radius, shape_type,
    # shape_params; KP's table, cells, overflow; scratch; out margins, pair
    # a, b, valid, num_pairs, overflow, steps_left; the shape_params row
    # stride, N, buckets, cell cap, ppb, max_pairs, has_oversize, rebuild,
    # interval; the margin, dt, margin cap and cell_size as doubles), stream
    "find_pairs": [P, P],
    # one host buffer of 8-byte slots (kernels/terrain.py:_FIELD_PACK and
    # _CALL_PACK: heights, origin, cell_w, HX, HY, xy, P, with_normals,
    # out), stream
    "terrain_heights": [P, P],
    # heights, origin, cell_w, leaf_origin, leaf_width, HX, HY, L, res,
    # 1 / res, out, stream
    "terrain_chunks": [P] * 5 + [I] * 4 + [F] + [P] + [P],
    # heights, origin, cell_w, cells, HX, HY, C, K, key (2 x uint32),
    # scatter cell width, max slope cos, out, stream
    "terrain_scatter": [P] * 4 + [I] * 4 + [U] * 2 + [F] * 2 + [P] + [P],
    # 13 particle fields (pos ... alive), rows, cursor, n, cap, stream
    "spawn_rows": [P] * 13 + [P] + [I] * 3 + [P],
    # one host buffer of 8-byte slots (kernels/pose.py:_PACK: bank rot,
    # trans, n_frames, looping; clip_a, clip_b, frame_a, frame_b, blend,
    # grab_l, grab_r, root, override_rot, post_rot, override_mask,
    # post_mask; parent, depth, joint_slot, joint_finger, grab_quats,
    # rest_scale, inverse_bind; out; f_cap, n_half, A, J, S, n_levels),
    # stream
    "pose_avatars": [P, P],
    # one host buffer of 8-byte slots (kernels/audio_setup.py:_PACK: alive,
    # paused, finished, spatial, pos, vel, delta, doppler_factor,
    # mute_factor, mute_target, mute_rate, volume, num_occlusions; listener
    # pos, vel, right, forward, up; dop_alpha, dt_block as doubles; S, L,
    # use_hrtf; out), stream
    "audio_setup": [P, P],
    # body_slot, y_fwd_quat, wheel_attach, wheel_radius, sus_max; body pos,
    # quat, linvel, angvel, inv_mass, inv_inertia; V; out, stream
    "vehicle_setup": [P] * 11 + [I] + [P] + [P],
    # slots, dv, dw; V, N; linvel, angvel, awake, sleep_timer; stream
    "vehicle_scatter": [P] * 3 + [I] * 2 + [P] * 4 + [P],
    # blocks [nb, 16, 3], out words [nb, 2], nb, stream
    "bc1_encode": [P, P, I] + [P],
    # one host buffer of 8-byte slots (kernels/halo.py:_HEAD and _Plan: the
    # output buffer, overflow; the plan's device table (output offsets, bytes
    # a row, thresholds); n fields, pos, alive and awake field indices, S,
    # rows_in, H, axis, stride, n_axis, P, copy blocks; the fields' source
    # pointers), stream
    "halo_exchange": [P, P],
    # host arrays of the shards' src field pointers (shard-major), dst
    # pointers and bytes per row, n fields, S, L, alive and awake field
    # indices, overflow, its length, out counts [2], stream
    "shard_keep_count": [P] * 3 + [I] * 5 + [P, I, P] + [P],
    # host array of W count pointers, W, out, stream
    "shard_world_count": [P, I, P] + [P],
    # host array of n block pointers, n, length, out, stream
    "shard_sum_clip": [P, I, I, P] + [P],
}

_lib = None
_fns = {}
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


def kernel(name: str):
    """The C launcher ``name`` with its argtypes set: pointers pass as ints
    (``tensor.data_ptr()``), the stream last (``stream()``); it returns a
    cudaError_t, which ``raise_if`` turns into an exception."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(library(), name)
    return fn


def stream() -> int:
    """The current CUDA stream of the current device, as a raw pointer."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def raise_if(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: "
                           f"{library().kernel_error_string(rc).decode()} ({rc})")


def launch(name: str, *args):
    """Call kernel launcher ``name`` on the current stream; tensors pass as
    device pointers.  Raises if the launch reported an error."""
    rc = kernel(name)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                      stream())
    raise_if(rc, name)


def launch_packed(name: str, args: bytes):
    """Call launcher ``name`` whose arguments come packed into one host
    buffer (``struct.pack`` of pointers and sizes, a wrapper keeping a
    world's constant ones): one ctypes argument instead of dozens."""
    raise_if(kernel(name)(args, stream()), name)


MAX_PLANS = 8   # shapes a wrapper keeps a plan for


def plan(cache: dict, key, make):
    """The plan ``cache`` holds for ``key``, made by ``make()`` on first use;
    past ``MAX_PLANS`` entries the oldest goes."""
    found = cache.get(key)
    if found is None:
        if len(cache) >= MAX_PLANS:
            cache.pop(next(iter(cache)))
        found = cache[key] = make()
    return found


def check_all(device, tensors, names, dtypes, shapes):
    """``check`` over parallel tuples, one cheap test per tensor on the path
    where all is well."""
    for t, dtype, shape in zip(tensors, dtypes, shapes):
        if not (t.dtype is dtype and t.shape == shape and t.is_contiguous()
                and t.device == device):
            for t_, name, dtype_, shape_ in zip(tensors, names, dtypes, shapes):
                check(t_, name, dtype_, shape_, device)


def check(t: torch.Tensor, name: str, dtype, shape, device):
    """Wrapper-side argument validation before a pointer reaches a kernel."""
    if t.dtype is dtype and t.device == device and t.shape == shape and t.is_contiguous():
        return
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    raise ValueError(f"{name}: not contiguous")

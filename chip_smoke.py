#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (substrata_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
1. device: requires CUDA; prints torch, the card and its power limit;
2. build: compiles the CUDA kernels from csrc/ (nvcc, sm_90a);
3. kernels: on the 10,000-box bench world after 30 ticks, each hand-written
   kernel (KA box-box, KB ground contacts, KC contact solve, KD forces and
   integration) against its plain PyTorch twin on the same inputs, with
   the tolerance stated beside it, and both timed (CUDA events around 20
   back-to-back calls, median of 5 rounds);
4. small worlds: the five-box stack rests at its analytic heights on the
   card, and a 200-box world steps on the card as the CPU path does
   (the CPU path is the one the tests hold against the JAX reference);
5. main path: the bench world through PhysicsWorld(cfg) (on the card by
   default), 180 think(1/60) calls with a seeded velocity kick (bench.py's
   churn) before ticks 31, 61, 91, 121 and 151; the invariants hold, every
   physics kernel's launch counter grew, and six more thinks make one
   synchronizing call each (the digest read);
6. audio kernels: bench.py's 256-source scene (HRIR on, room on, 800-frame
   blocks) with the sources on the bench world's bodies, after 30 mixed
   blocks: KE fetch, KF spatialise and KG downmix + reverb each against its
   plain twin on the same inputs, with the tolerance stated beside it, all
   timed as in phase 3, and the whole mix_block, kernel route vs plain;
7. physics + audio: bench.py's window 2 on the port, 180 physics_audio_tick
   calls (think, sources follow bodies, mix one tick) with phase 5's kick;
   the output is finite, within [-1, 1], not silent and not mono, the
   physics kernels and KE/KF/KG launched (the audio ones once per tick),
   six more ticks make one synchronizing call each (the digest: the mix
   adds none), and a 200-box, 16-source coupled world steps on the card as
   the CPU path does;
8. ray, particle and vehicle kernels: bench.py's full-tick scene (the bench
   world, 256 sources, 2,048 particles, 8 vehicles) after 30 full ticks:
   KH ray trace at the particles' shape and at the wheels' shape, KI
   particle update and KJ vehicle forces, each against its plain twin on
   the same inputs with the tolerance stated beside it, timed as in phase
   3; no single PyTorch call computes any of the three functions;
9. the full tick: bench.py's window 3, 180 benchworld.full_tick calls
   (one cell table, vehicles, the character walking as bench.py's does,
   think, particles, the two Winter scripts over 512 instances, sources
   follow bodies, the mix) with phase 5's kick; particles, vehicles and
   the character finite, no body below z = -0.5, phase 7's audio checks,
   every kernel launched (KH, KI, KJ, KL, KP, KQ at least once per tick,
   KR once), six more ticks make one synchronizing call each, the last
   script results finite and equal to KR's twin at the same time, and a
   200-box, 16-source, 256-particle, 4-vehicle full tick with the
   character and the scripts on the card matches the CPU path;
10. the character and serving-tick kernels: KK (sphere/box/capsule
   contacts) on 4,096 seeded random pairs of each of its eight combo codes
   and on the serving world's real buckets, KL (the character update) on
   the serving world at t = 0, 1, 2 s of the walk and on a step and a
   ledge that take its stair and stick branches, KM (the tick input) with
   128 writes and 64 regions on 10,240 bodies, KN (digest and transform
   block) on a real step's events, each against its plain twin with the
   tolerance stated beside it, timed as in phase 3;
11. the serving tick: benchworld.serving_world (the bench world and one
   PlayerPhysics at eye height), 180 think_with_player ticks of the
   walking player with phase 5's kick and one teleport (5 m up) every 30
   ticks; the invariants of phase 5, the character finite and on the
   ground (see char_ok), KK, KL, KM and KN launched every tick, six more
   ticks make one synchronizing call each and (where the profiler sees
   the card) one host->device and one device->host copy each, and a
   200-box serving world whose player pushes a small box (capsule-box
   contacts), with transform writes and a teleport, on the card matches
   the CPU path over 40 ticks;
12. the hull and trimesh kernels: KO (convex SAT contacts) on 4,096 seeded
   random pairs of each hull code and on the mesh world's real buckets,
   KB with hull samples and the static trimesh, KH on the client's
   occlusion rays and 2,048 seeded rays into the field, KL at t = 0, 1,
   2 s of the walk on the mesh world and on a trimesh step, each against
   its plain twin with the tolerance stated beside it, timed as in phase
   3 (the mesh world: tools/bench_networked.py's 12,000 unit cubes, 512
   dynamic hulls over 137,856 static triangles on virtual anchors);
13. the mesh world's client frames: 180 benchworld.mesh_tick calls
   (think_with_player of the walking player, then one occlusion ray per
   dynamic hull); the state finite, contacts > 0, KO, KB, KH, KL, KM and
   KN launched every frame, two synchronizing calls and (where the
   profiler sees the card) one host->device and two device->host copies a
   frame, ms per frame; the hulls' heights and the character's foot
   reported (see mesh_phase); and a 1,200-object mesh world on the card
   matches the CPU path (the hulls until the first trimesh kick, the
   character and the occlusion hits over 40 frames; see small_mesh_phase);
14. the cell table, the solve setup and the scripts: KP on the bench world
   after 30 ticks and on its bodies moved onto a 1.4 m lattice (k * 1.4
   and one ulp either side), both modes, exact; KQ's setup and refresh on
   the bench world (pair-blocked rows) and on the serving and mesh worlds
   (the compacted layout), within 1e-6 of each output's scale with masks,
   slots and the refreshed cache exact; KR on bench.py's two scripts and
   on a corpus of one script per builtin and per operator and a
   let/struct/user-function program, 4,096 instances each, in one launch,
   exact on arithmetic and within 1e-6 of scale on transcendentals; each
   timed as in phase 3;
15. the physics step's last stages: KS (pair finding with the rebuild's
   margins) at a rebuild of the bench world after 30 ticks; KT's grouping,
   touching, compaction and incidence table on the serving world (timed)
   and the mesh world; KU (position solve) and KV (strike wake, sleep
   pass) on the bench, serving and mesh worlds; each against its twin:
   KU within 1e-6 of the positions' scale, everything else exact (pairs,
   margins, counters, buckets, compacted rows, tables, flags, timers).
   Then torch.profiler over think rebuild ticks and serving ticks: no
   aten sort, argsort, cumsum, cummax or searchsorted runs inside a
   ``physics_step`` range;
16. the terrain, spawn and pose kernels: KW, KX, KY and KZ against their
   twins (see terrain_kernel_phase);
17. 180 benchworld.terrain_tick frames of BASELINE config 4 (see
   terrain_phase) and a small terrain world against the CPU path;
18. KAA (the audio mix's per-source setup and epilogue) on bench.py's
   256-source scene after 30 blocks, HRTF on (timed) and off, and KAB (the
   vehicles' pre-ray setup and delta scatter) on the full tick's 8
   vehicles after 30 ticks and with one vehicle's body gone, each against
   its twin: exact on masks, bins (but a bin whose pre-round value lies
   within 1e-5 of a half-integer, counted), arithmetic and the scatter,
   the pan's cos and sin within 1e-6 of the gains' scale; again on the
   client world's sources after 30 frames and its vehicles at frame 120;
19. the client frame: 180 benchworld.client_tick frames of the offline
   ClientApp over BASELINE config 5's 12,000-object world with 256
   sources, 8 vehicles, 512 Winter objects, 4 path platforms and 8 Lua
   objects (see client_phase), and a small client world on the card
   against the CPU path (see small_client_phase).

Every kernel also gets its bound: the least time the card could take for
the same work, the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its float32 operations over 67 TFLOP/s
(the H100 SXM's published peaks at 700 W), from this run's inputs.

The last lines are the kernels JSON (launches from phase 9's full ticks,
from phase 11's serving ticks for KK-KN and KT, from phase 5's thinks for
KS, KU and KV, and from phase 13's mesh frames for KO; KQ's two launches,
KT's four entry points and KV's two are separate entries; the grouping's
library_ms is torch.argsort(stable=True) on its codes),
the card's name and power limit, and {"ok": true, "device": {...}}.  TF32 stays off for matmuls and cuDNN
(the solver's small products must run in full float32).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DT = 1.0 / 60.0
TICKS = 180
KICK_EVERY = 30
REPS = 20
SYNC_TICKS = 6
N_DYNAMIC_RAYS = 512         # one occlusion ray per dynamic hull of the mesh world
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps=REPS, rounds=5):
    """ms per call: CUDA events around ``reps`` back-to-back calls, median
    of ``rounds``.  A call's time includes its wrapper's host work wherever
    that is longer than the device work (profile_tick gives device-only
    kernel times)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def device_us(fn, kernel, reps=REPS):
    """Device time (µs) per launch of the kernels whose names hold
    ``kernel``, over ``reps`` calls of ``fn`` under torch.profiler; None
    where the profiler records no device work."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return sum(us) / len(us) if us else None


def max_err(x, y, mask=None):
    d = (x.float() - y.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


def nbytes(*objs):
    """Bytes of every distinct tensor in ``objs`` (tensors, tuples, lists,
    dataclasses), each counted once."""
    seen = {}
    for t in _tensors(objs):
        seen[(t.data_ptr(), t.numel(), t.dtype)] = t.numel() * t.element_size()
    return sum(seen.values())


def bound(bytes_moved, flops):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the float32 operations over their peak."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(bytes_moved), flops=int(flops))


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain twin at the bench shapes.
# ---------------------------------------------------------------------------

def kernel_phase(w):
    from substrata_tpu_torch.kernels import box_box as ka
    from substrata_tpu_torch.kernels import integrate_triton as kd
    from substrata_tpu_torch.kernels import solve as kc
    from substrata_tpu_torch.kernels import static_contacts as kb
    from substrata_tpu_torch.physics import narrowphase, solver

    results = {}
    body, pc, cfg = w.state, w.pair_cache, w.config

    # KD: forces, then integration.  Tolerance 1e-6 absolute: same
    # operations in the same order, correctly rounded division/sqrt.
    lin_k, ang_k, wat_k = kd.apply_forces(body, DT, w.params)
    lin_p, ang_p, wat_p = kd.apply_forces_plain(body, DT, w.params)
    err = max(max_err(lin_k, lin_p), max_err(ang_k, ang_p))
    check(torch.equal(wat_k, wat_p), "KD apply_forces: in_water differs")
    check(err <= 1e-6, f"KD apply_forces: max abs err {err} > 1e-6")
    n = body.capacity
    forces_in = [getattr(body, k) for k in (
        "pos", "quat", "linvel", "angvel", "inv_mass", "inv_inertia", "gravity_factor",
        "linear_damping", "angular_damping", "bound_radius", "volume", "motion_type",
        "awake", "alive", "use_zero_linear_drag")] + [w.params.gravity, w.params.water_z]
    results["apply_forces"] = dict(
        max_abs_err=err, tol=1e-6,
        **bound(nbytes(forces_in, lin_k, ang_k, wat_k), FLOPS["apply_forces"] * n),
        ms=median_ms(lambda: kd.apply_forces(body, DT, w.params)),
        plain_ms=median_ms(lambda: kd.apply_forces_plain(body, DT, w.params)))
    pos_k, q_k = kd.integrate_positions(body, lin_p, ang_p, DT)
    pos_p, q_p = kd.integrate_positions_plain(body, lin_p, ang_p, DT)
    err = max(max_err(pos_k, pos_p), max_err(q_k, q_p))
    check(err <= 1e-6, f"KD integrate_positions: max abs err {err} > 1e-6")
    integ_in = [body.pos, body.quat, lin_p, ang_p, body.motion_type, body.awake, body.alive]
    results["integrate_positions"] = dict(
        max_abs_err=err, tol=1e-6,
        **bound(nbytes(integ_in, pos_k, q_k), FLOPS["integrate_positions"] * n),
        ms=median_ms(lambda: kd.integrate_positions(body, lin_p, ang_p, DT)),
        plain_ms=median_ms(lambda: kd.integrate_positions_plain(body, lin_p, ang_p, DT)))
    body = body.replace(linvel=lin_p, angvel=ang_p)

    # KA: box-box rows for the cached pair list.  Tolerance 1e-5 on points,
    # normals, penetrations; masks equal, except for pairs whose plain
    # decision quantities lie within 1e-5 of a threshold (reported).
    args = (body.pos, body.quat, body.shape_params, body.friction, body.restitution,
            body.is_sensor, pc.pair_a, pc.pair_b, pc.pair_valid)
    rk = ka.box_box_rows(*args)
    rp = ka.box_box_rows_plain(*args)
    for i, name in ((0, "a"), (1, "b"), (8, "key")):
        check(torch.equal(rk[i], rp[i]), f"KA: {name} differs")
    a = torch.clamp(pc.pair_a, min=0).long()
    b = torch.clamp(pc.pair_b, min=0).long()
    gap = ka.box_box(body.pos[a], body.quat[a], body.shape_params[a, :3],
                     body.pos[b], body.quat[b], body.shape_params[b, :3],
                     with_gap=True)[4]
    near = (gap < 1e-5) & pc.pair_valid
    near_rows = near.repeat_interleave(ka.WM)
    far_rows = ~near_rows
    check(torch.equal(rk[5][far_rows], rp[5][far_rows]), "KA: valid mask differs")
    check(torch.equal(rk[9][~near], rp[9][~near]), "KA: touching differs")
    both = far_rows & rp[5]
    err = max(max_err(rk[2], rp[2], both), max_err(rk[3], rp[3], both),
              max_err(rk[4], rp[4], both))
    check(err <= 1e-5, f"KA: max abs err {err} > 1e-5")
    check(torch.equal(rk[6], rp[6]) and torch.equal(rk[7], rp[7]), "KA: fric/rest differ")
    results["box_box_rows"] = dict(
        max_abs_err=err, tol=1e-5, valid_pairs=int(pc.pair_valid.sum()),
        **bound(nbytes(args, rk), FLOPS["box_box_rows"] * int(pc.pair_valid.sum())),
        valid_rows=int(rp[5].sum()), near_threshold_pairs=int(near.sum()),
        ms=median_ms(lambda: ka.box_box_rows(*args)),
        plain_ms=median_ms(lambda: ka.box_box_rows_plain(*args)))

    # KB: ground contacts.  Rows are compared per body by sample key (the
    # top-K order of equal depths is the kernel's own tie rule, checked in
    # the CPU tests); bodies with a sample within 1e-5 of the margin or of
    # the K-th/(K+1)-th cut are exempt from mask equality (reported).
    sw = w.static_world
    hf, has_hf = sw.heightfield, sw.has_heightfield
    k = min(cfg.static_contacts_per_body, 8)
    present = cfg.present_shape_types
    kb_args = (body, hf, has_hf, k, present, sw.hulls, sw.trimesh)
    sk = kb.static_contacts(*kb_args)
    sp = kb.static_contacts_plain(*kb_args)
    check(torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1]), "KB: a/b differ")
    pts, rad, slot_ok = kb.shape_sample_points(body, present, sw.hulls)
    h, hn = hf.sample_with_normal(pts.reshape(-1, 3)[:, :2])
    pen8 = ((h - (pts.reshape(-1, 3)[:, 2] - rad.repeat_interleave(8))) * hn[:, 2]).reshape(n, 8)
    srt = torch.sort(torch.clamp(pen8, max=0.5), dim=1, descending=True).values
    near_b = ((pen8 + 0.04).abs() < 1e-5).any(dim=1) | ((srt[:, k - 1] - srt[:, k]).abs() < 1e-5)
    order_k = torch.sort(sk[8].reshape(n, k), dim=1)
    order_p = torch.sort(sp[8].reshape(n, k), dim=1)
    idx_k = (torch.arange(n, device=body.device)[:, None] * k + order_k.indices).reshape(-1)
    idx_p = (torch.arange(n, device=body.device)[:, None] * k + order_p.indices).reshape(-1)
    far_b = (~near_b).repeat_interleave(k)
    vk, vp = sk[5][idx_k], sp[5][idx_p]
    check(torch.equal(order_k.values.reshape(-1)[far_b & vp],
                      order_p.values.reshape(-1)[far_b & vp]), "KB: selected samples differ")
    check(torch.equal(vk[far_b], vp[far_b]), "KB: valid mask differs")
    both = far_b & vp
    err = max(max_err(sk[2][idx_k], sp[2][idx_p], both),
              max_err(sk[3][idx_k], sp[3][idx_p], both),
              max_err(sk[4][idx_k], sp[4][idx_p], both))
    check(err <= 1e-5, f"KB: max abs err {err} > 1e-5")
    kb_in = [getattr(body, k) for k in ("pos", "quat", "shape_type", "shape_params", "alive",
                                        "layer", "motion_type", "is_sensor", "awake",
                                        "friction", "restitution")]
    results["static_contacts"] = dict(
        max_abs_err=err, tol=1e-5, valid_rows=int(sp[5].sum()),
        **bound(nbytes(kb_in, hf.heights, hf.origin, hf.cell_w, has_hf, sk),
                FLOPS["static_contacts"] * n),
        near_threshold_bodies=int(near_b.sum()),
        ms=median_ms(lambda: kb.static_contacts(*kb_args)),
        plain_ms=median_ms(lambda: kb.static_contacts_plain(*kb_args)))

    # KC: warm-start pre-apply + 7 iterations from the same setup.
    # Tolerance 1e-4 absolute on linvel/angvel: both round the pair
    # payloads at the same bf16 points; f32 sums may differ in order.
    wm = narrowphase.blocked_manifold_width(cfg, n)
    pair_cts, _, _ = narrowphase.pair_contacts(body, pc.pair_a, pc.pair_b,
                                               pc.pair_valid, cfg, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(body, w.static_world, cfg)
    setup = solver.prepare_solve(body, static_cts, pair_cts, DT, w.params, cfg,
                                 w.solver_cache, wm=wm, table=pc.inc_table,
                                 sign=pc.inc_sign)
    _, lk, ak = solver.iterate(setup, body.linvel, body.angvel, cfg.solver_iters,
                               step=kc.solve_iteration)
    _, lp, ap = solver.iterate(setup, body.linvel, body.angvel, cfg.solver_iters,
                               step=kc.solve_iteration_plain)
    err = max(max_err(lk, lp), max_err(ak, ap))
    check(err <= 1e-4, f"KC: max abs err {err} > 1e-4")
    st0 = setup.state0
    one = kc.solve_iteration(setup.rows, st0, body.linvel, body.angvel, 0.5)
    rows = int(setup.rows.s_valid.sum()) + int(setup.rows.p_valid.sum())
    results["solve_iteration"] = dict(
        max_abs_err=err, tol=1e-4, static_rows=int(setup.rows.s_valid.sum()),
        pair_rows=int(setup.rows.p_valid.sum()),
        **bound(nbytes(setup.rows, st0, body.linvel, body.angvel, one),
                FLOPS["solve_iteration"] * rows
                + FLOPS["solve_bodies"] * n * setup.rows.tbl.shape[1]),
        ms=median_ms(lambda: kc.solve_iteration(setup.rows, st0, body.linvel,
                                                body.angvel, 0.5)),
        plain_ms=median_ms(lambda: kc.solve_iteration_plain(setup.rows, st0, body.linvel,
                                                            body.angvel, 0.5)))
    return results


# ---------------------------------------------------------------------------
# Phase 4: small worlds.
# ---------------------------------------------------------------------------

def small_world_phase(device="cuda"):
    from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld
    from substrata_tpu_torch.benchworld import bench_world
    from substrata_tpu_torch.physics import shapes
    from substrata_tpu_torch.physics.state import SimConfig

    # Five-box stack (tests/test_jolt_fidelity.py:135 bounds), on the card.
    w = PhysicsWorld(SimConfig(capacity=32, max_pairs=256, grid_dim=16, cell_size=2.0,
                               solver_iters=10), device=device)
    w.set_ground_plane(0.0)
    obs = [w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]),
                                      pos=np.array([0, 0, 0.4 + 0.82 * i], np.float32),
                                      motion_type=int(MotionType.DYNAMIC)))
           for i in range(5)]
    for _ in range(300):
        w.think(DT)
    w.sync_transforms()
    for i, ob in enumerate(obs):
        check(abs(ob.pos[2] - (0.4 + 0.8 * i)) < 0.05, f"stack box {i} at {ob.pos}")
        check(np.linalg.norm(ob.pos[:2]) < 0.1, f"stack box {i} drifted {ob.pos}")
        check(abs(abs(float(ob.rot[3])) - 1.0) < 0.01, f"stack box {i} tipped {ob.rot}")
    stack = [float(ob.pos[2]) for ob in obs]

    # 200 boxes, 10 ticks on the card vs the CPU path (1e-3 m, the bound
    # the CPU tests hold the CPU path to against the reference).
    cfg = SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    worlds = [bench_world(dev, n_bodies=200, cfg=cfg) for dev in (device, "cpu")]
    for _ in range(10):
        for wd in worlds:
            wd.think(DT)
    err = max_err(worlds[0].state.pos.cpu(), worlds[1].state.pos)
    check(err <= 1e-3, f"200-box world: card vs CPU path {err} m > 1e-3")
    return {"stack_z": stack, "cuda_vs_cpu_200_boxes_max_pos_err_m": err}


# ---------------------------------------------------------------------------
# Phase 5: the main path.
# ---------------------------------------------------------------------------

def main_path_phase(device="cuda", n_bodies=10_000, cfg=None, sync=torch.cuda.synchronize):
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.benchworld import bench_world, kick
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    sync()
    kernels.reset_launch_counts()
    times = []
    for t in range(TICKS):
        if t > 0 and t % KICK_EVERY == 0:     # before ticks 31, 61, ...
            w.set_state(kick(w.state, gen))
        sync()
        t0 = time.perf_counter()
        w.think(DT)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    # Host syncs per think: the digest read is the one device -> host copy
    # a tick may make; count every synchronizing call over a few ticks
    # (the rebuild tick among them).  Turning the debug mode on warns once
    # that it is a prototype; that warning is not a sync.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(SYNC_TICKS):
            w.think(DT)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught
             if str(c.message).startswith("called a synchronizing CUDA operation")]
    check(len(syncs) == SYNC_TICKS,
          f"{len(syncs)} synchronizing calls in {SYNC_TICKS} thinks, expected one each")
    w.sync_transforms()
    st = w.state
    alive = st.alive
    check(bool(torch.isfinite(st.pos[alive]).all()), "non-finite positions")
    check(bool(torch.isfinite(st.quat[alive]).all()), "non-finite quaternions")
    min_z = float(st.pos[alive][:, 2].min())
    check(min_z >= -0.5, f"a body fell through the ground: z = {min_z}")
    d = w.last_diags
    pairs, contacts = int(d.num_pairs), int(d.num_contacts)
    check(pairs > 0 and contacts > 0, f"pairs {pairs}, contacts {contacts}")
    for name in PHYSICS_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    ev = w.last_events
    return dict(
        ms_per_think_median=float(np.median(times[30:])),
        ms_per_think_p90=float(np.percentile(times[30:], 90)),
        first_think_ms=times[0], pairs=pairs, contacts=contacts,
        awake=int(d.num_awake), max_penetration=float(d.max_penetration),
        broadphase_overflow=int(ev.broadphase_overflow), min_z=min_z,
        bodies=len(w.objects), launches=counts,
        syncs_per_think=len(syncs) / SYNC_TICKS)


# ---------------------------------------------------------------------------
# Phase 6: the audio kernels against their plain twins.
# ---------------------------------------------------------------------------

class plain_mix:
    """Within the block, mix_block runs the kernels' plain twins on CUDA
    tensors (for the kernel-route vs plain-route timing): KAA's and
    KE-KG's."""

    NAMES = {"audio_mix": ("audio_fetch", "audio_spatialise", "audio_downmix_reverb"),
             "audio_setup": ("audio_setup", "audio_epilogue")}

    def __enter__(self):
        import importlib
        self.saved = []
        for mod, names in self.NAMES.items():
            m = importlib.import_module(f"substrata_tpu_torch.kernels.{mod}")
            for n in names:
                self.saved.append((m, n, getattr(m, n)))
                setattr(m, n, getattr(m, n + "_plain"))

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def audio_kernel_phase(w, device="cuda", blocks=30, plain_reps=5):
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.audio.hrtf import hrir_bank_tensor
    from substrata_tpu_torch.benchworld import TICK_FRAMES, bench_audio
    from substrata_tpu_torch.kernels import audio_mix as ka

    b = TICK_FRAMES
    src, pool, lis, room = bench_audio(device)
    idx = torch.arange(src.capacity, device=device)
    src = src.replace(pos=w.state.pos[idx], vel=w.state.linvel[idx])
    for _ in range(blocks):
        src, _, room = mix.mix_block(src, pool, lis, room=room, use_hrtf=True, block=b)
    st = mix.prepare(src, lis, b, b / mix.ENGINE_RATE, True)
    results = {}

    # KE.  Tolerance 1e-6 absolute: the same float32 operations in the
    # same order; the lerp weights are exact, so only the interpolated
    # products round.
    nw = mix.window_rows(b)
    fargs = (pool, src.buf_offset, src.buf_len, src.playhead, st.eff_delta, src.mix_factor,
             src.looping, src.stream_mode, src.stream_write_head, st.active, b, nw)
    sk, hk = ka.audio_fetch(*fargs)
    sp, hp = ka.audio_fetch_plain(*fargs)
    err = max(max_err(sk, sp), max_err(hk, hp))
    check(err <= 1e-6, f"KE audio_fetch: max abs err {err} > 1e-6")
    used = (src.buf_len > 0)
    span = torch.floor(st.eff_delta * (b - 1)) + 2.0        # pool samples a layer reads
    pool_bytes = int((span * used).sum()) * 4
    results["audio_fetch"] = dict(
        max_abs_err=err, tol=1e-6,
        **bound(pool_bytes + nbytes(fargs[1:10], sk, hk), 30 * b * int(used.sum())),
        ms=median_ms(lambda: ka.audio_fetch(*fargs)),
        plain_ms=median_ms(lambda: ka.audio_fetch_plain(*fargs), reps=plain_reps))

    # KF.  Tolerance 1e-5 absolute: the same operations in the same order
    # (the low-pass frame by frame, the FIR tap by tap).
    bank = hrir_bank_tensor(device)
    ramp = mix.gain_ramp(b, device)
    sargs = (sp, src.lp_state, st.alpha, st.use_lp, src.spatial, src.hrir_hist, bank,
             st.dir_idx, src.prev_gain_l, src.prev_gain_r, st.gl, st.gr, ramp, st.gain,
             st.send_gain, True)
    fk = ka.audio_spatialise(*sargs)
    fp = ka.audio_spatialise_plain(*sargs)
    err = max(max_err(x, y) for x, y in zip(fk, fp))
    check(err <= 1e-5, f"KF audio_spatialise: max abs err {err} > 1e-5")
    rows = bank.reshape(-1, 2 * bank.shape[-1])[torch.unique(st.dir_idx).long()]
    taps = bank.shape[-1]
    n_spatial = int(src.spatial.sum())
    # No one library call does all of KF (low-pass, FIR, ramps); the FIR,
    # most of its work, is one grouped conv1d (cross-correlation, so the
    # taps are flipped).  Timed for reference, and checked against the
    # plain twin's FIR on the same signal.
    x_ext = torch.cat([src.hrir_hist, sp], dim=1)[None]                 # [1, S, B+T-1]
    h = bank.reshape(-1, 2, taps)[st.dir_idx.long()].flip(-1).reshape(-1, 1, taps)
    def fir():
        return torch.nn.functional.conv1d(x_ext, h, groups=src.capacity)
    one = torch.ones_like(st.gl)
    ref = ka.audio_spatialise_plain(sp, src.lp_state, st.alpha, torch.zeros_like(st.use_lp),
                                    torch.ones_like(src.spatial), src.hrir_hist, bank,
                                    st.dir_idx, one, one, one, one, ramp, st.gain, None, True)
    conv = fir()[0].reshape(src.capacity, 2, b)
    fir_err = max(max_err(conv[:, 0], ref[0]), max_err(conv[:, 1], ref[1]))
    check(fir_err <= 1e-5, f"conv1d FIR vs the plain FIR: {fir_err} > 1e-5")
    results["audio_spatialise"] = dict(
        max_abs_err=err, tol=1e-5, hrir_rows=int(rows.shape[0]),
        **bound(nbytes(sargs[:6], sargs[7:15], rows, fk),
                b * (n_spatial * 4 * taps + src.capacity * 12)),
        ms=median_ms(lambda: ka.audio_spatialise(*sargs)),
        plain_ms=median_ms(lambda: ka.audio_spatialise_plain(*sargs), reps=plain_reps),
        fir_conv1d_ms=median_ms(fir), fir_conv1d_max_abs_err=fir_err)

    # KG.  Tolerance 1e-5 absolute on out and the delay lines: the column
    # sums run in source order in both.
    gargs = (fp[0], fp[1], fp[2], lis.master_volume, room.delay_lines, room.write_idx,
             room.delays, room.feedback, room.wet)
    gk = ka.audio_downmix_reverb(*gargs)
    gp = ka.audio_downmix_reverb_plain(*gargs)
    err = max(max_err(gk[0], gp[0]), max_err(gk[1], gp[1]))
    check(err <= 1e-5, f"KG audio_downmix_reverb: max abs err {err} > 1e-5")
    check(torch.equal(gk[2], gp[2]), "KG: write index differs")
    results["audio_downmix_reverb"] = dict(
        max_abs_err=err, tol=1e-5,
        **bound(nbytes(gargs, gk), b * (3 * src.capacity + 40)),
        ms=median_ms(lambda: ka.audio_downmix_reverb(*gargs)),
        plain_ms=median_ms(lambda: ka.audio_downmix_reverb_plain(*gargs), reps=plain_reps))

    # The whole mix_block: kernel route, then the plain route, same inputs.
    def run():
        return mix.mix_block(src, pool, lis, room=room, use_hrtf=True, block=b)
    kernel_ms = median_ms(run)
    with plain_mix():
        plain_ms = median_ms(run, reps=plain_reps)
        _, out_p, _ = run()
    _, out_k, _ = run()
    err = max_err(out_k, out_p)
    check(err <= 1e-5, f"mix_block: kernel route vs plain route {err} > 1e-5")
    results["mix_block"] = dict(ms=kernel_ms, plain_ms=plain_ms, max_abs_err=err,
                                sources=src.capacity, frames=b)
    return results


# ---------------------------------------------------------------------------
# Phase 7: physics + audio, bench.py's window 2.
# ---------------------------------------------------------------------------

def out_checks(out):
    out = out.float()
    check(bool(torch.isfinite(out).all()), "non-finite audio")
    check(float(out.abs().max()) <= 1.0, "audio outside [-1, 1]")
    rms = float(out.pow(2).mean().sqrt())
    check(rms > 0.0, "silent audio")
    lr = float((out[:, 0] - out[:, 1]).abs().max())
    check(lr > 0.0, "left and right channels are equal")
    return rms, lr


def physics_audio_phase(device="cuda", n_bodies=10_000, cfg=None, sync=torch.cuda.synchronize):
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.benchworld import (bench_audio, bench_world, kick,
                                                physics_audio_tick)
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    src, pool, lis, room = bench_audio(device)
    src_idx = torch.arange(src.capacity, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    sync()
    kernels.reset_launch_counts()
    times = []
    for t in range(TICKS):
        if t > 0 and t % KICK_EVERY == 0:
            w.set_state(kick(w.state, gen))
        sync()
        t0 = time.perf_counter()
        src, out, room = physics_audio_tick(w, src, pool, lis, room, src_idx)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    rms, lr = out_checks(out)
    for name in PHYSICS_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the physics+audio path")
    for name in AUDIO_KERNELS:
        check(counts[name] == TICKS, f"kernel {name}: {counts[name]} launches in {TICKS} ticks")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(SYNC_TICKS):
            src, out, room = physics_audio_tick(w, src, pool, lis, room, src_idx)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught
             if str(c.message).startswith("called a synchronizing CUDA operation")]
    check(len(syncs) == SYNC_TICKS,
          f"{len(syncs)} synchronizing calls in {SYNC_TICKS} physics+audio ticks, "
          "expected one each (the digest)")
    return dict(
        ms_per_tick_median=float(np.median(times[30:])),
        ms_per_tick_p90=float(np.percentile(times[30:], 90)),
        first_tick_ms=times[0], out_rms=rms, out_max_lr_diff=lr, launches=counts,
        syncs_per_tick=len(syncs) / SYNC_TICKS, sources=src.capacity,
        frames_per_tick=int(out.shape[0]))


def small_coupled_phase(device="cuda"):
    """200 boxes and 16 sources, 10 coupled ticks on the card and on the
    CPU path; out within 1e-4 (the bodies agree to ~1e-7 m after 10 ticks,
    phase 4)."""
    from substrata_tpu_torch.benchworld import bench_audio, bench_world, physics_audio_tick
    from substrata_tpu_torch.physics.state import SimConfig
    cfg = SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    outs = {}
    for dev in (device, "cpu"):
        w = bench_world(dev, n_bodies=200, cfg=cfg)
        src, pool, lis, room = bench_audio(dev, n_sources=16)
        idx = torch.arange(16, device=dev)
        outs[dev] = []
        for _ in range(10):
            src, out, room = physics_audio_tick(w, src, pool, lis, room, idx)
            outs[dev].append(out.cpu())
    err = max(max_err(a, b) for a, b in zip(outs[device], outs["cpu"]))
    check(err <= 1e-4, f"coupled 200-box, 16-source world: card vs CPU path {err} > 1e-4")
    out_checks(outs[device][-1])
    return {"cuda_vs_cpu_200_boxes_16_sources_max_out_err": err}


# ---------------------------------------------------------------------------
# Phase 8: the ray, particle and vehicle kernels against their plain twins.
# ---------------------------------------------------------------------------

def ray_bound(args, kw, outs):
    """KH's bound from this run's data: the rays in and out, the table rows
    they read, the stage-1 fields of the distinct bodies they meet and the
    shape fields of the distinct survivors, and the heightfield."""
    from substrata_tpu_torch.kernels import ray_trace as kh
    o, d, mt, body, table, os_idx, hf, has_hf, ex = args[:9]
    buckets, cand, slotk, okk = kh.survivors(o, d, mt, body, table, os_idx,
                                             kw["cell_size"], kw["grid_dim"],
                                             kw["body_steps"], ex, kw["collidable_only"],
                                             kw["k"], kw["dedup"])
    rows = int(torch.unique(buckets).numel())
    bodies = int(torch.unique(cand[cand >= 0]).numel())
    surv = int(torch.unique(slotk[okk]).numel())
    hf_bytes = 4 if hf.is_flat else nbytes(hf.heights)
    moved = (nbytes(o, d, mt, ex, os_idx, has_hf, outs) + rows * table.shape[1] * 4
             + bodies * (12 + 4 + 1 + 4) + surv * (12 + 16 + 16 + 4) + hf_bytes)
    hf_ops = FLOPS["ray_hf_flat"] if hf.is_flat else FLOPS["ray_hf_step"] * (kw["n_steps"] + 10)
    ops = (int((cand >= 0).sum()) * FLOPS["ray_candidate"] + int(okk.sum()) * FLOPS["ray_shape"]
           + o.shape[0] * hf_ops)
    return bound(moved, ops), dict(rays=int(o.shape[0]), table_rows=rows,
                                   candidate_bodies=bodies, survivors=int(okk.sum()),
                                   hits=int(outs[3].sum()))


def fulltick_kernel_phase(device="cuda", n_bodies=10_000, cfg=None, warm=30, plain_reps=5):
    from substrata_tpu_torch.benchworld import bench_audio, bench_fulltick, bench_world, full_tick
    from substrata_tpu_torch.kernels import particles_triton as ki
    from substrata_tpu_torch.kernels import ray_trace as kh
    from substrata_tpu_torch.kernels import vehicles as kj
    from substrata_tpu_torch.physics import broadphase, queries
    from substrata_tpu_torch.physics.particles import motion_rays
    from substrata_tpu_torch.physics.vehicles.manager import chassis_and_wheel_rays

    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    veh, vin, ps, char, scripts = bench_fulltick(w, device)
    src, pool, lis, room = bench_audio(device)
    idx = torch.arange(src.capacity, device=device)
    for t in range(warm):
        veh, ps, src, _, room, char = full_tick(w, veh, vin, ps, src, pool, lis, room, idx, char,
                                                t * DT, scripts)
    body, cfg, sw = w.state, w.config, w.static_world
    table = broadphase.build_cell_table(body, cfg)[0]
    os_idx = queries.oversize_slots(body, cfg)
    hf, has_hf = sw.heightfield, sw.has_heightfield
    results = {}

    # KH at both call shapes.  hit and body exact; t and normal within 1e-6
    # (the same float32 operations in the same order).
    dirs, max_ts = motion_rays(ps, DT)
    none = torch.full((ps.capacity,), -1, dtype=torch.int32, device=device)
    (c_pos, c_quat, c_lin, c_ang, c_mass, c_iw), wheel = chassis_and_wheel_rays(veh, body)
    shapes = {
        "particles": ((ps.pos, dirs, max_ts, body, table, os_idx, hf, has_hf, none, sw.hulls,
                       sw.trimesh), dict(n_steps=4, body_steps=1, dedup=False)),
        "wheels": ((*wheel[:3], body, table, os_idx, hf, has_hf, wheel[3], sw.hulls,
                    sw.trimesh), dict(n_steps=4, body_steps=4, dedup=True)),
    }
    hits = {}
    for shape, (args, kw) in shapes.items():
        kw = dict(kw, cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, collidable_only=True,
                  k=16)
        rk = kh.ray_trace(*args, **kw)
        rp = kh.ray_trace_plain(*args, **kw)
        check(torch.equal(rk[3], rp[3]), f"KH {shape}: hit differs")
        check(torch.equal(rk[2], rp[2]), f"KH {shape}: body differs")
        err = max(max_err(rk[0], rp[0]), max_err(rk[1], rp[1]))
        check(err <= 1e-6, f"KH {shape}: max abs err {err} > 1e-6")
        b, counts = ray_bound(args, kw, rk)
        results[f"ray_trace_{shape}"] = dict(
            max_abs_err=err, tol=1e-6, **b, **counts,
            ms=median_ms(lambda: kh.ray_trace(*args, **kw)),
            plain_ms=median_ms(lambda: kh.ray_trace_plain(*args, **kw), reps=plain_reps))
        hits[shape] = rp

    # KI.  Tolerance 1e-6: the same operations, correctly rounded division
    # and square root, no fusion.
    t, n, _, hit, _ = hits["particles"]
    iargs = (ps, t, n, hit, DT, w.params.water_z)
    ik, ip = ki.particles_update(*iargs), ki.particles_update_plain(*iargs)
    err = max(max_err(x, y) for x, y in zip(ik[:4], ip[:4]))
    check(err <= 1e-6, f"KI: max abs err {err} > 1e-6")
    check(torch.equal(ik[4], ip[4]) and torch.equal(ik[5], ip[5]), "KI: alive or foam differ")
    ki_in = [getattr(ps, f) for f in ("pos", "vel", "area", "mass", "restitution", "width",
                                      "dwidth_dt", "opacity", "dopacity_dt", "die_on_hit",
                                      "alive")]
    results["particles_update"] = dict(
        max_abs_err=err, tol=1e-6,
        **bound(nbytes(ki_in, t, n, hit, w.params.water_z, ik),
                FLOPS["particles_update"] * ps.capacity),
        ms=median_ms(lambda: ki.particles_update(*iargs)),
        plain_ms=median_ms(lambda: ki.particles_update_plain(*iargs), reps=plain_reps))

    # KJ.  Tolerance 1e-5 of each output's largest magnitude (at least 1):
    # the same operations, CUDA's atan2/tan/cos/sin in both; gear and
    # contact exact.
    wt, wn, _, whit, _ = hits["wheels"]
    nv = veh.vtype.shape[0]
    jargs = (veh, vin, c_pos, c_quat, c_lin, c_ang, c_mass, c_iw, wt.reshape(nv, 4),
             wn.reshape(nv, 4, 3), whit.reshape(nv, 4) & (veh.body_slot >= 0)[:, None],
             w.params.water_z, DT)
    jk, jp = kj.vehicle_forces(*jargs), kj.vehicle_forces_plain(*jargs)
    err, rel = 0.0, 0.0
    for i, (x, y) in enumerate(zip(jk, jp)):
        if y.dtype in (torch.bool, torch.int32):
            check(torch.equal(x, y), f"KJ: output {i} differs")
            continue
        e = max_err(x, y)
        err, rel = max(err, e), max(rel, e / max(1.0, float(y.abs().max())))
    check(rel <= 1e-5, f"KJ: max err {rel} of the output's scale > 1e-5")
    kj_in = [getattr(veh, f) for f in kj.KERNEL_FIELDS] + list(vars(vin).values())
    results["vehicle_forces"] = dict(
        max_abs_err=err, max_err_of_scale=rel, tol=1e-5, vehicles=nv,
        contacts=int(jp[7].sum()),
        **bound(nbytes(kj_in, jargs[2:12], jk), FLOPS["vehicle_forces"] * nv),
        ms=median_ms(lambda: kj.vehicle_forces(*jargs)),
        plain_ms=median_ms(lambda: kj.vehicle_forces_plain(*jargs), reps=plain_reps))
    return results


# ---------------------------------------------------------------------------
# Phase 9: the full tick, bench.py's window 3.
# ---------------------------------------------------------------------------

def full_tick_phase(device="cuda", n_bodies=10_000, cfg=None, sync=torch.cuda.synchronize):
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.benchworld import (bench_audio, bench_fulltick, bench_world,
                                                full_tick, kick)
    from substrata_tpu_torch.kernels import winter as kr
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    veh, vin, ps, char, scripts = bench_fulltick(w, device)
    src, pool, lis, room = bench_audio(device)
    idx = torch.arange(src.capacity, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    sync()
    kernels.reset_launch_counts()
    times = []
    for t in range(TICKS):
        if t > 0 and t % KICK_EVERY == 0:
            w.set_state(kick(w.state, gen))
        sync()
        t0 = time.perf_counter()
        veh, ps, src, out, room, char = full_tick(w, veh, vin, ps, src, pool, lis, room, idx,
                                                  char, t * DT, scripts)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    rms, lr = out_checks(out)
    for name in PHYSICS_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the full tick")
    for name in AUDIO_KERNELS + ("winter_eval",):
        check(counts[name] == TICKS, f"kernel {name}: {counts[name]} launches in {TICKS} ticks")
    for name in FULLTICK_KERNELS + ("character_update", "cell_table", "solve_setup",
                                    "cache_refresh"):
        check(counts[name] >= TICKS, f"kernel {name}: {counts[name]} launches in {TICKS} ticks")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for t in range(TICKS, TICKS + SYNC_TICKS):
            veh, ps, src, out, room, char = full_tick(w, veh, vin, ps, src, pool, lis, room, idx,
                                                      char, t * DT, scripts)
        torch.cuda.set_sync_debug_mode("default")
    # The scripts' last result against KR's twin at the same time: the
    # rotation exact, the translation (sin, cos) within 1e-6 of its scale.
    t_last = (TICKS + SYNC_TICKS - 1) * DT
    want = kr.winter_eval_plain(scripts.batch, scripts.time(t_last), scripts.idx,
                                scripts.n_inst)
    got = scripts.out
    check(bool(torch.isfinite(got).all()), "non-finite script results")
    check(torch.equal(got[:, :3], want[:, :3]), "script rotations differ from KR's twin")
    winter_err = max_err(got[:, 3:], want[:, 3:])
    check(winter_err <= 1e-6 * max(1.0, float(want.abs().max())),
          f"script translations: max abs err {winter_err} vs KR's twin")
    syncs = [str(c.message).splitlines()[0] for c in caught
             if str(c.message).startswith("called a synchronizing CUDA operation")]
    check(len(syncs) == SYNC_TICKS,
          f"{len(syncs)} synchronizing calls in {SYNC_TICKS} full ticks, expected one each")
    st = w.state
    alive = st.alive
    check(bool(torch.isfinite(st.pos[alive]).all()), "non-finite positions")
    min_z = float(st.pos[alive][:, 2].min())
    check(min_z >= -0.5, f"a body fell through the ground: z = {min_z}")
    live = ps.alive
    check(bool(torch.isfinite(ps.pos[live]).all() and torch.isfinite(ps.vel[live]).all()),
          "non-finite particles")
    vstate = torch.cat([veh.steering[:, None], veh.prev_sus_len, veh.wheel_omega, veh.wheel_rot,
                        veh.unflip_time[:, None], veh.shift_timer[:, None],
                        veh.engine_rpm[:, None]], dim=1)
    check(bool(torch.isfinite(vstate).all()), "non-finite vehicle state")
    seen = char_ok(char, w, -1)
    return dict(**seen, winter_vs_twin_max_abs_err=winter_err,
        winter_rotation_z_max=float(got[:, 2].max()),
        ms_per_tick_median=float(np.median(times[30:])),
        ms_per_tick_p90=float(np.percentile(times[30:], 90)),
        first_tick_ms=times[0], out_rms=rms, out_max_lr_diff=lr, launches=counts,
        syncs_per_tick=len(syncs) / SYNC_TICKS, particles=ps.capacity,
        particles_alive=int(live.sum()), particle_min_z=float(ps.pos[live][:, 2].min()),
        vehicles=int(veh.vtype.shape[0]), wheel_contacts=int(veh.wheel_contact.sum()),
        vehicle_rpm=[float(x) for x in veh.engine_rpm.cpu()],
        vehicle_gear=[int(x) for x in veh.gear.cpu()], min_z=min_z,
        character_foot=[float(x) for x in char.pos.cpu()])


def small_fulltick_phase(device="cuda"):
    """200 boxes, 16 sources, 256 particles, 4 vehicles, the character and
    the scripts: 10 full ticks on the card and on the CPU path; bodies,
    particles, audio, the character and the script results within 1e-4."""
    from substrata_tpu_torch.benchworld import bench_audio, bench_fulltick, bench_world, full_tick
    from substrata_tpu_torch.physics.state import SimConfig
    cfg = SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    runs = {}
    for dev in (device, "cpu"):
        w = bench_world(dev, n_bodies=200, cfg=cfg)
        veh, vin, ps, char, scripts = bench_fulltick(w, dev, n_particles=256, n_vehicles=4)
        src, pool, lis, room = bench_audio(dev, n_sources=16)
        idx = torch.arange(16, device=dev)
        outs = []
        for t in range(10):
            veh, ps, src, out, room, char = full_tick(w, veh, vin, ps, src, pool, lis, room, idx,
                                                      char, t * DT, scripts)
            outs.append(out.cpu())
        runs[dev] = (w.state.pos.cpu(), ps.pos.cpu(), torch.stack(outs), veh.gear.cpu(),
                     char.pos.cpu(), scripts.out.cpu())
    (bk, pk, ok, gk, ck, sk), (bp, pp, op, gp, cp, sp) = runs[device], runs["cpu"]
    errs = dict(bodies=max_err(bk, bp), particles=max_err(pk, pp), out=max_err(ok, op),
                character=max_err(ck, cp), scripts=max_err(sk, sp))
    for what, e in errs.items():
        check(e <= 1e-4, f"small full tick: {what} card vs CPU path {e} > 1e-4")
    check(torch.equal(gk, gp), "small full tick: vehicle gears differ")
    return {f"cuda_vs_cpu_small_full_tick_max_{k}_err": v for k, v in errs.items()}


# ---------------------------------------------------------------------------
# Phase 10: the closed-form, character and serving-tick kernels.
# ---------------------------------------------------------------------------

def char_ok(char, world, exclude):
    """The character's state is finite and it stands on the ground: its
    foot is above z = -0.01 (the slide's touching depth), or a body
    touches its capsule and holds it lower.  The collide-and-slide pushes
    out of the deepest contact, three times a tick, so a body pressing
    on the capsule leaves the foot in the ground by up to that body's
    overlap, in the reference as here
    (tests/test_torch_character.py::test_pressed_character_sinks_like_the_reference).
    The lower sphere's centre stays above the ground (foot > -0.3) in
    every case.  Contacts are probed on the world's current state, one
    step after the character's update: a body within 5 cm counts (a few
    ticks of motion at the bench's speeds).  Returns what it saw."""
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.physics import broadphase, queries
    st = torch.cat([char.pos, char.vel, char.ground_normal, char.ground_vel,
                    char.campos_z_delta[None]])
    check(bool(torch.isfinite(st).all()), "non-finite character state")
    body, cfg, sw = world.state, world.config, world.static_world
    cyl_h = torch.where(char.sitting, kl.SITTING_HEIGHT, kl.CYLINDER_HEIGHT)
    cands = kl.gather_candidates(char.pos, char.pos, cyl_h, body,
                                 broadphase.build_cell_table(body, cfg)[0],
                                 queries.oversize_slots(body, cfg), cfg.cell_size, cfg.grid_dim,
                                 exclude)
    _, pen, _, bid, _, ok = kl.capsule_probe(char.pos[None], cyl_h, cands, sw.heightfield,
                                             sw.has_heightfield, sw.trimesh)
    near = ok[0] & (bid >= 0) & (pen[0] > -0.05)
    foot_z = float(char.pos[2])
    held = sorted({int(b) for b in bid[near].cpu()})
    deepest = float(pen[0][near].max()) if held else None
    check(foot_z > -0.3, f"the character fell through the ground: {char.pos}")
    check(foot_z > -0.01 or held,
          f"the character's foot is at z = {foot_z} with no body on its capsule")
    return dict(character_foot_z=foot_z, bodies_on_capsule=len(held),
                deepest_body_penetration=deepest)


def _random_pair_rows(gen, code, n, device):
    """Two sides of ``n`` bodies of the code's shape types at random poses
    within touching range: (pos, quat, params, friction, restitution,
    sensor) for 2n bodies, side a first."""
    cols = []
    for st in (code // 4, code % 4):
        q = torch.randn((n, 4), generator=gen, device=device)
        u = torch.rand((n, 4), generator=gen, device=device)
        prm = torch.zeros((n, 4), device=device)
        if st == 0:
            prm[:, 0] = 0.2 + 0.4 * u[:, 0]
        elif st == 1:
            prm[:, :3] = 0.2 + 0.5 * u[:, :3]
        else:
            prm[:, 0] = 0.15 + 0.25 * u[:, 0]
            prm[:, 1] = 0.2 + 0.4 * u[:, 1]
        cols.append((torch.rand((n, 3), generator=gen, device=device) * 1.2 - 0.6,
                     q / q.norm(dim=1, keepdim=True), prm))
    pos, quat, prm = (torch.cat([a, b]) for a, b in zip(*cols))
    fr = torch.rand(2 * n, generator=gen, device=device)
    re = torch.rand(2 * n, generator=gen, device=device)
    return pos, quat, prm, fr, re, torch.rand(2 * n, generator=gen, device=device) < 0.05


def _kk_compare(args):
    from substrata_tpu_torch.kernels import closed_forms as kk
    rk, rp = kk.closed_form_rows(*args), kk.closed_form_rows_plain(*args)
    for i, name in ((0, "a"), (1, "b"), (5, "valid"), (6, "friction"), (7, "restitution"),
                    (8, "key"), (9, "touching")):
        check(torch.equal(rk[i], rp[i]), f"KK code {args[0]}: {name} differs")
    return max(max_err(rk[i], rp[i], rp[5]) for i in (2, 3, 4)), rk, rp


def _kk_bytes(calls):
    """The bytes KK must move over ``calls`` [(args, rows)]: each bucket's
    slot arrays and its output rows, and the body fields (pose, shape,
    materials, sensor flag) of each distinct body that a valid slot names —
    the kernel reads no other body."""
    if not calls:
        return 0
    moved, bodies = 0, []
    for args, rows in calls:
        ba, bb, bvalid = args[9:12]
        moved += nbytes(ba, bb, bvalid, rows)
        bodies += [ba[bvalid], bb[bvalid]]
    per_body = sum(t[0].numel() * t.element_size() for t in args[3:9])
    return moved + per_body * int(torch.unique(torch.cat(bodies)).numel())


def _char_args(world, char, move, exclude, device):
    from substrata_tpu_torch.physics import broadphase, queries
    from substrata_tpu_torch.physics import character as tchar
    body, cfg, sw = world.state, world.config, world.static_world
    scal = torch.as_tensor(tchar.tick_scalars(DT, move, False, False, False, exclude),
                           device=device)
    args = ({f: getattr(char, f) for f in tchar.CHARACTER_FIELDS}, body, sw.heightfield,
            sw.has_heightfield, world.params.water_z, broadphase.build_cell_table(body, cfg)[0],
            queries.oversize_slots(body, cfg), scal)
    return args, dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, trimesh=sw.trimesh)


def _kl_compare(args, kw):
    """KL against its twin: packed vector and state within 1e-6 of the
    packed vector's scale, flags and the touched list exact.  Returns (the
    error of scale, the twin's new state)."""
    from substrata_tpu_torch.kernels import character as kl
    nk, pk = kl.character_packed(*args, **kw)
    npl, pp = kl.character_packed_plain(*args, **kw)
    check(torch.equal(pk[15:], pp[15:]), "KL: touched bodies differ")
    check(torch.equal(pk[4:6], pp[4:6]), "KL: jumped / on_ground differ")
    for f in ("on_ground", "gravity_enabled", "fly_mode", "sitting"):
        check(bool(nk[f]) == bool(npl[f]), f"KL: {f} differs")
    scale = max(1.0, float(pp.abs().max()))
    err = max(max_err(pk, pp), *(max_err(nk[f], npl[f]) for f in ("pos", "vel",
                                                                  "ground_normal",
                                                                  "ground_vel",
                                                                  "campos_z_delta")))
    check(err <= 1e-6 * scale, f"KL: max abs err {err} > 1e-6 of scale {scale}")
    return err / scale, npl


def _kl_work(args, kw):
    """KL's operations on these inputs, counted on the twin's run: the
    probes' rows and the closed forms they evaluated."""
    from substrata_tpu_torch.kernels import character as kl
    seen = dict(rows=0, box=0, other=0)
    probe, contacts = kl.capsule_probe, kl._contacts

    def count_probe(feet, cyl_h, c, *a):
        seen["rows"] += feet.shape[0] * (c.idx.shape[0] + kl.N_STATIC)
        return probe(feet, cyl_h, c, *a)

    def count_contacts(center, half_h, c, rows):
        boxy = (c.shape_type[rows] == 1) | (c.shape_type[rows] == 3)
        seen["box"] += int(boxy.sum())
        seen["other"] += int((~boxy).sum())
        return contacts(center, half_h, c, rows)
    kl.capsule_probe, kl._contacts = count_probe, count_contacts
    try:
        kl.character_packed_plain(*args, **kw)
    finally:
        kl.capsule_probe, kl._contacts = probe, contacts
    return (seen["rows"] * FLOPS["char_row"] + seen["box"] * FLOPS["capsule_box"]
            + seen["other"] * FLOPS["point_contact"]), seen


def serving_kernel_phase(device="cuda", n_bodies=10_000, cfg=None, plain_reps=5):
    from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld
    from substrata_tpu_torch.benchworld import serving_tick, serving_world, walk_input
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.kernels import closed_forms as kk
    from substrata_tpu_torch.kernels import serving_io as km
    from substrata_tpu_torch.physics import broadphase, narrowphase, shapes
    from substrata_tpu_torch.physics import character as tchar
    from substrata_tpu_torch.physics.state import SimConfig

    results = {}
    # KK on 4,096 seeded random pairs of each code, both layouts.  Points,
    # normals and depths within 1e-5; masks, keys and touching exact.
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    n = 4096
    ba = torch.arange(n, dtype=torch.int32, device=device)
    random_err, random_bounds = 0.0, {}
    for code in kk.CODES:
        pos, quat, prm, fr, re, sens = _random_pair_rows(gen, code, n, device)
        bv = torch.rand(n, generator=gen, device=device) < 0.9
        for wm, blocked in ((4, True), (narrowphase._MANIFOLD_WIDTH[code], False)):
            args = (code, wm, blocked, pos, quat, prm, fr, re, sens, ba, ba + n, bv)
            err, rk, _ = _kk_compare(args)
            check(err <= 1e-5, f"KK code {code}: max abs err {err} > 1e-5")
            random_err = max(random_err, err)
        ops = int(bv.sum()) * (FLOPS["capsule_box"] if code in (6, 9) else FLOPS["point_contact"])
        random_bounds[code] = bound(_kk_bytes([(args, rk)]), ops)["bound_ms"]

    # The serving world after 30 ticks: KK on its real buckets, KL at
    # t = 0, 1, 2 s of the walk, KM and KN.
    w, p = serving_world(device, n_bodies=n_bodies, cfg=cfg)
    w._flush()
    kl_cases, kl_errs = [], []
    for t in range(121):
        if t in (0, 60, 120):
            kl_cases.append(_char_args(w, p.state, walk_input(t * DT), p.proxy.slot, device))
            kl_errs.append(_kl_compare(*kl_cases[-1])[0])
        serving_tick(w, p, t * DT)
    body, pc, cfg = w.state, w.pair_cache, w.config
    bucket_list = narrowphase.buckets(body, pc.pair_a, pc.pair_b, pc.pair_valid, cfg)[0]
    kk_calls, valid_slots, kk_ops, real_err = [], {}, 0, 0.0
    for code, _, bba, bbb, bvalid in bucket_list:
        if code not in kk.CODES:
            continue
        args = (code, narrowphase._MANIFOLD_WIDTH[code], False, body.pos, body.quat,
                body.shape_params, body.friction, body.restitution, body.is_sensor, bba, bbb,
                bvalid)
        err, rk, _ = _kk_compare(args)
        real_err = max(real_err, err)
        kk_calls.append((args, rk))
        valid_slots[code] = int(bvalid.sum())
        kk_ops += valid_slots[code] * (FLOPS["capsule_box"] if code in (6, 9)
                                       else FLOPS["point_contact"])
    kk_args = [a for a, _ in kk_calls]
    results["closed_form_rows"] = dict(
        max_abs_err=max(random_err, real_err), tol=1e-5, random_pairs_per_code=n,
        bucket_slots={c: int(a[9].shape[0]) for c, a in zip(valid_slots, kk_args)},
        valid_slots=valid_slots, random_pairs_bound_ms=random_bounds,
        **bound(_kk_bytes(kk_calls), kk_ops),
        ms=median_ms(lambda: [kk.closed_form_rows(*a) for a in kk_args]),
        device_us_per_launch=device_us(lambda: [kk.closed_form_rows(*a) for a in kk_args],
                                       "closed_form_rows"),
        plain_ms=median_ms(lambda: [kk.closed_form_rows_plain(*a) for a in kk_args],
                           reps=plain_reps))

    # KL on a 0.35 m step (the stair branch) and off a 0.4 m ledge (the
    # stick branch), three chained updates each.
    for he, pos, eye in (([1.0, 1.0, 0.175], [1.35, 0, 0.175], (0.0, 0, 1.67)),
                         ([1.0, 2.0, 0.2], [-0.7, 0, 0.2], (0.40, 0, 2.07))):
        sw = PhysicsWorld(SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=1.4,
                                    cell_capacity=6), device=device)
        sw.set_ground_plane(0.0)
        sw.add_object(PhysicsObject(shape=shapes.make_box(he), pos=np.array(pos, np.float32),
                                    motion_type=int(MotionType.STATIC)))
        sw._flush()
        st = tchar.init_character_state(eye, device=device).replace(
            gravity_enabled=torch.ones((), dtype=torch.bool, device=device))
        for _ in range(3):
            a, kw = _char_args(sw, st, np.array([3.0, 0, 0], np.float32), -1, device)
            e, new = _kl_compare(a, kw)
            kl_errs.append(e)
            st = tchar.CharacterState(**new)
    args, kw = kl_cases[-1]
    ops, seen = _kl_work(args, kw)
    cand = args[5].shape[1] * kl.n_centers(kw["cell_size"]) * 27 + args[6].shape[0]
    moved = cand * (4 + 82) + args[6].shape[0] * 4 + nbytes(args[0], args[7]) \
        + (15 + cand + kl.N_STATIC) * 4
    results["character_update"] = dict(
        max_abs_err=max(kl_errs), max_err_of_scale=max(kl_errs), tol=1e-6,
        rows=cand + kl.N_STATIC, probe_rows=seen["rows"], contacts_evaluated=seen,
        **bound(moved, ops),
        ms=median_ms(lambda: kl.character_packed(*args, **kw)),
        device_us_per_launch=device_us(lambda: kl.character_packed(*args, **kw),
                                       "character_kernel"),
        plain_ms=median_ms(lambda: kl.character_packed_plain(*args, **kw), reps=plain_reps))

    # KM: 128 writes and 64 regions on the bench world's 10,240 bodies.
    rng = np.random.default_rng(2)
    nb = body.capacity
    buf = km.empty_tick_in(nb)
    buf[km.O_IDX:km.O_POS].view(np.int32)[:] = rng.permutation(nb)[:km.TIN_K]
    buf[km.O_POS:km.O_VOK] = rng.normal(size=km.O_VOK - km.O_POS)
    buf[km.O_VOK:km.O_CTR] = rng.integers(0, 2, km.TIN_K)
    buf[km.O_CTR:km.O_RAD] = rng.uniform(-35, 35, 3 * km.TIN_R)
    buf[km.O_RAD:] = rng.uniform(0.2, 2.0, km.TIN_R)
    tin = torch.as_tensor(buf, device=device)
    got, ref = km.apply_tick_in(body, tin), km.apply_tick_in_plain(body, tin)
    for f, x in zip(km.STATE_OUT, ref):
        check(torch.equal(getattr(got, f), x), f"KM: {f} differs")
    woke = int((got.awake & ~body.awake).sum())
    results["apply_tick_in"] = dict(
        max_abs_err=0.0, tol=0.0, bodies=nb, writes=km.TIN_K, regions=km.TIN_R,
        newly_awake=woke,
        **bound(nbytes([getattr(body, f) for f in km.STATE_IN], tin, ref),
                nb * (km.TIN_R * FLOPS["region_test"] + km.TIN_K)),
        ms=median_ms(lambda: km.apply_tick_in(body, tin)),
        device_us_per_launch=device_us(lambda: km.apply_tick_in(body, tin), "apply_tick_in"),
        plain_ms=median_ms(lambda: km.apply_tick_in_plain(body, tin), reps=plain_reps))

    # KN on the last serving step's events.
    ev, dg, sl = w.last_events, w.last_diags, w.pair_cache.steps_left
    dk, bk = km.digest_tblock(ev, dg.num_contacts, dg.num_awake, sl, body)
    dp, bp = km.digest_tblock_plain(ev, dg.num_contacts, dg.num_awake, sl, body)
    check(torch.equal(dk, dp), "KN: digest differs")
    check(torch.equal(bk, bp), "KN: transform block differs")
    kn_in = [ev.newly_awake, ev.newly_asleep, ev.entered_water, ev.contact_touching,
             ev.contact_pair_a, ev.contact_pair_b, body.pos, body.quat, body.linvel,
             body.angvel, body.underwater]
    results["digest_tblock"] = dict(
        max_abs_err=0.0, tol=0.0, bodies=nb, pairs=int(ev.contact_touching.shape[0]),
        touching=int(ev.contact_touching.sum()), newly_awake=int(ev.newly_awake.sum()),
        **bound(nbytes(kn_in, dp, bp), 0),
        ms=median_ms(lambda: km.digest_tblock(ev, dg.num_contacts, dg.num_awake, sl, body)),
        device_us_per_launch=device_us(
            lambda: km.digest_tblock(ev, dg.num_contacts, dg.num_awake, sl, body),
            "digest_tblock"),
        plain_ms=median_ms(lambda: km.digest_tblock_plain(ev, dg.num_contacts, dg.num_awake,
                                                          sl, body), reps=plain_reps))
    return results


# ---------------------------------------------------------------------------
# Phase 11: the serving tick.
# ---------------------------------------------------------------------------

def _copies(run, ticks):
    """Host->device and device->host copies the profiler sees over ``ticks``
    calls, and the kernels it sees (0 means it recorded no device work).
    A profiler session after earlier ones can miss its first device events,
    so the session opens with a fill and one call that are not counted; the
    count takes the device events that start inside a range opened after
    that call has finished."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda")
        run()
        torch.cuda.synchronize()
        with torch.profiler.record_function("counted_calls"):
            for _ in range(ticks):
                run()
            torch.cuda.synchronize()
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == "counted_calls")
    names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.start >= start]
    return (sum(n.startswith("Memcpy HtoD") for n in names),
            sum(n.startswith("Memcpy DtoH") for n in names), len(names))


def serving_phase(device="cuda", n_bodies=10_000, cfg=None, sync=torch.cuda.synchronize):
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.benchworld import kick, serving_tick, serving_world
    w, p = serving_world(device, n_bodies=n_bodies, cfg=cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    sync()
    kernels.reset_launch_counts()
    times = []
    for t in range(TICKS):
        if t > 0 and t % KICK_EVERY == 0:     # the churn kick, and one teleport
            w.set_state(kick(w.state, gen))
            ob = w.objects[(t // KICK_EVERY) * 1000]
            w.set_new_ob_to_world_transform(ob, np.asarray(ob.pos) + [0.0, 0.0, 5.0], ob.rot)
        sync()
        t0 = time.perf_counter()
        serving_tick(w, p, t * DT)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    for name in PHYSICS_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the serving tick")
    for name in SERVING_KERNELS:
        check(counts[name] >= TICKS, f"kernel {name}: {counts[name]} launches in {TICKS} ticks")
    state = dict(t=TICKS)

    def tick():
        serving_tick(w, p, state["t"] * DT)
        state["t"] += 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(SYNC_TICKS):
            tick()
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught
             if str(c.message).startswith("called a synchronizing CUDA operation")]
    check(len(syncs) == SYNC_TICKS,
          f"{len(syncs)} synchronizing calls in {SYNC_TICKS} serving ticks, expected one each")
    h2d, d2h, device_ops = _copies(tick, SYNC_TICKS)
    if device_ops:
        check(h2d == SYNC_TICKS and d2h == SYNC_TICKS,
              f"{h2d} host->device and {d2h} device->host copies in {SYNC_TICKS} serving "
              "ticks, expected one each")
    st = w.state
    alive = st.alive
    check(bool(torch.isfinite(st.pos[alive]).all()), "non-finite positions")
    check(bool(torch.isfinite(st.quat[alive]).all()), "non-finite quaternions")
    min_z = float(st.pos[alive][:, 2].min())
    check(min_z >= -0.5, f"a body fell through the ground: z = {min_z}")
    seen = char_ok(p.state, w, p.proxy.slot)
    d = w.last_diags
    return dict(**seen,
        ms_per_serving_tick_median=float(np.median(times[30:])),
        ms_per_serving_tick_p90=float(np.percentile(times[30:], 90)),
        first_tick_ms=times[0], launches=counts, syncs_per_tick=len(syncs) / SYNC_TICKS,
        h2d_copies_per_tick=h2d / SYNC_TICKS if device_ops else "not measured",
        d2h_copies_per_tick=d2h / SYNC_TICKS if device_ops else "not measured",
        pairs=int(d.num_pairs), contacts=int(d.num_contacts), awake=int(d.num_awake),
        max_penetration=float(d.max_penetration), min_z=min_z,
        player_eye=[float(x) for x in p.get_eye_position()], player_on_ground=p.on_ground,
        bodies=len(w.objects))


def push_world(device):
    """The small serving world: 199 boxes resting apart, one 0.2 m box in
    the path of a player at eye (0, 0, 1.67), which its capsule proxy
    pushes (capsule-box contacts; the box stays below the capsule's
    segment, see tests/test_torch_serving.py).  Returns (world, boxes,
    player)."""
    from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld
    from substrata_tpu_torch.physics import shapes
    from substrata_tpu_torch.physics.character import PlayerPhysics
    from substrata_tpu_torch.physics.state import SimConfig
    w = PhysicsWorld(SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                               cell_capacity=6, solver_iters=7, pairs_per_body=10,
                               pair_rebuild_interval=6, contacts_per_body=8), device=device)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    pos = [[1.0, 0.0, 0.099]] + [[-3.0 - (n % 14) * 1.7 + rng.uniform(-0.1, 0.1),
                                  (n // 14 - 7) * 1.7 + rng.uniform(-0.1, 0.1), 0.399]
                                 for n in range(199)]
    obs = [w.add_object(PhysicsObject(shape=shapes.make_box([he] * 3),
                                      pos=np.array(x, np.float32),
                                      motion_type=int(MotionType.DYNAMIC)))
           for he, x in zip([0.1] + [0.4] * 199, pos)]
    return w, obs, PlayerPhysics(w, eye_pos=(0.0, 0.0, 1.67))


def small_serving_phase(device="cuda"):
    """The small serving world on the card and on the CPU path, 40 ticks:
    the player walks as the bench's does, three boxes are moved 2 mm a
    tick and one is teleported 14 m at tick 15 (a wake region); bodies and
    the character within 1e-4, and the proxy pushes the box."""
    from substrata_tpu_torch.benchworld import walk_dir
    runs = {}
    for dev in (device, "cpu"):
        w, obs, p = push_world(dev)
        pushed = 0
        for t in range(40):
            p.process_move(walk_dir(t * DT))
            for k in (10, 20, 30):
                w.set_new_ob_to_world_transform(obs[k], np.asarray(obs[k].pos) + [0.002, 0, 0],
                                                obs[k].rot)
            if t == 15:
                w.set_new_ob_to_world_transform(obs[40], np.asarray(obs[40].pos) + [0, 14.0, 0],
                                                obs[40].rot, linvel=[0, 0, 0], angvel=[0, 0, 0])
            w.think_with_player(DT, p, cur_time=t * DT)
            pushed += any(b.slot == obs[0].slot for b in p.contacted_bodies)
        runs[dev] = (w.state.pos.cpu(), w.state.linvel.cpu(), p.state.pos.cpu(), pushed)
    errs = dict(bodies=max_err(runs[device][0], runs["cpu"][0]),
                velocities=max_err(runs[device][1], runs["cpu"][1]),
                character=max_err(runs[device][2], runs["cpu"][2]))
    for what, e in errs.items():
        check(e <= 1e-4, f"small serving world: {what} card vs CPU path {e} > 1e-4")
    check(runs[device][3] > 0, "small serving world: the player never touched the box")
    out = {f"cuda_vs_cpu_small_serving_max_{k}_err": v for k, v in errs.items()}
    out["small_serving_ticks_touching_the_box"] = runs[device][3]
    return out


# ---------------------------------------------------------------------------
# Phase 12: KO and the hull and trimesh branches of KB, KH and KL.
# ---------------------------------------------------------------------------

def hull_library(device):
    """Four hulls interned as a world interns them: a cube, an octahedron,
    a 60-point cloud (seed 9) and a tetrahedron."""
    from substrata_tpu_torch import PhysicsWorld
    from substrata_tpu_torch.physics import shapes
    from substrata_tpu_torch.physics.state import SimConfig
    w = PhysicsWorld(SimConfig(capacity=8, max_pairs=32, grid_dim=8), device=device)
    cube = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)])
    octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]) * 0.6
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]) * 0.8
    for v in (cube, octa, np.random.default_rng(9).normal(size=(60, 3)) * 0.4, tet):
        w._intern_hull(shapes.make_convex_hull(v))
    w._flush()
    return w.static_world.hulls


def _ko_compare(args):
    """KO against its twin: masks, ids, keys and touching exact; the error
    on the valid rows' points, normals and depths."""
    from substrata_tpu_torch.kernels import convex as ko
    rk, rp = ko.convex_rows(*args), ko.convex_rows_plain(*args)
    for i, name in ((0, "a"), (1, "b"), (5, "valid"), (6, "friction"), (7, "restitution"),
                    (8, "key"), (9, "touching")):
        check(torch.equal(rk[i], rp[i]), f"KO code {args[0]}: {name} differs")
    return max(max_err(rk[i], rp[i], rp[5]) for i in (2, 3, 4)), rk


def _side_sizes(stype, prm, hulls):
    """(vertices, faces) of each body of shape class ``stype`` as KO sees it."""
    if stype == 0:
        return torch.ones_like(prm[:, 0]), torch.zeros_like(prm[:, 0])
    if stype == 2:
        return torch.full_like(prm[:, 0], 2.0), torch.zeros_like(prm[:, 0])
    if stype == 1:
        return torch.full_like(prm[:, 0], 8.0), torch.full_like(prm[:, 0], 6.0)
    hid = torch.clamp(prm[:, 0].to(torch.int64), 0, hulls.capacity - 1)
    return hulls.n_verts[hid].float(), hulls.n_faces[hid].float()


def _ko_work(calls, hulls):
    """KO's bytes and operations over ``calls`` [(args, rows)]: each bucket's
    slot arrays and rows, the body rows (pose, shape, materials, sensor) of
    the distinct bodies that valid slots name, and the library rows of the
    distinct hulls among them; per valid slot, the SAT's dot products over
    the two sides' vertices and faces, the [Va, Vb] distances, the two
    auxiliary axes and the manifold."""
    moved, ops, bodies, hull_ids = 0, 0, [], []
    for args, rows in calls:
        code, prm, ba, bb, bv = args[0], args[5], args[9], args[10], args[11]
        moved += nbytes(ba, bb, bv, rows)
        sides = []
        for ids, st in ((ba[bv].long(), code // 4), (bb[bv].long(), code % 4)):
            bodies.append(ids)
            if st == 3:
                hull_ids.append(torch.clamp(prm[ids, 0].to(torch.int64), 0, hulls.capacity - 1))
            sides.append(_side_sizes(st, prm[ids], hulls))
        (va, fa), (vb, fb) = sides
        per = (20 * (va + vb) + 25 * (fa + fb) + 5 * (fa * vb + fb * va) + 8 * va * vb
               + 10 * (va + vb) + 6 * torch.maximum(va, vb) + 150)
        ops += int(per.sum())
    if bodies:
        moved += int(torch.unique(torch.cat(bodies)).numel()) * (12 + 16 + 16 + 4 + 4 + 1)
    if hull_ids:
        hid = torch.unique(torch.cat(hull_ids))
        moved += int((hulls.n_verts[hid] * 12 + hulls.n_faces[hid] * 16 + 8).sum())
    return bound(moved, ops)


def _kb_work(args, rows):
    """KB's bytes and operations on these inputs: the body fields, the rows
    out, the hull rows its hull bodies read, the cell entries its eligible
    bodies' samples read and the distinct triangles they test (48 bytes
    each), 600 operations a body and 150 a triangle test."""
    from substrata_tpu_torch.kernels import static_contacts as kb
    body, hf, has_hf, k, present, hulls, tm, kc = args
    n = body.capacity
    moved = nbytes([getattr(body, f) for f in (
        "pos", "quat", "shape_type", "shape_params", "alive", "layer", "motion_type",
        "is_sensor", "awake", "friction", "restitution")], hf.origin, hf.cell_w, has_hf, rows)
    moved += 4 if hf.is_flat else nbytes(hf.heights)
    hull_b = body.alive & (body.shape_type == 3)
    hid = torch.unique(torch.clamp(body.shape_params[hull_b, 0].to(torch.int64), 0,
                                   hulls.capacity - 1))
    moved += int((hulls.n_verts[hid] * 12).sum())
    tests = 0
    if tm.tris.shape[0] > 1:
        pts, _, slot_ok = kb.shape_sample_points(body, present, hulls)
        elig = (body.alive & body.collidable & body.dynamic & ~body.is_sensor & body.awake)
        sel = (slot_ok & elig[:, None]).reshape(-1)
        ci, cj = kb.trimesh_cells(tm, pts.reshape(-1, 3)[sel][:, :2])
        cand = tm.cell_tris[ci, cj][:, :min(tm.cell_tris.shape[2], kc)]
        tests = int((cand >= 0).sum())
        moved += int(cand.numel()) * 4 + int(torch.unique(cand[cand >= 0]).numel()) * 48
    return bound(moved, FLOPS["static_contacts"] * n + FLOPS["tri_test"] * tests), tests


def mesh_ray_bound(args, kw, outs):
    """KH's bound with the hull and trimesh branches: ray_bound's bytes and
    operations, plus the face planes of the hull survivors (16 bytes and 20
    operations a face), and the triangles the march reads (its cell
    entries, and 48 bytes per distinct triangle, 40 operations a test)."""
    from substrata_tpu_torch.kernels import ray_trace as kh
    from substrata_tpu_torch.kernels import static_contacts as kb
    b, counts = ray_bound(args, kw, outs)
    o, d, mt, body, table, os_idx, hf, has_hf, ex, hulls, tm = args
    _, _, slotk, okk = kh.survivors(o, d, mt, body, table, os_idx, kw["cell_size"],
                                    kw["grid_dim"], kw["body_steps"], ex, kw["collidable_only"],
                                    kw["k"], kw["dedup"])
    sk = slotk[okk].long()
    hs = sk[body.shape_type[sk] == 3]
    nf = hulls.n_faces[torch.clamp(body.shape_params[hs, 0].to(torch.int64), 0,
                                   hulls.capacity - 1)]
    moved, ops = b["bytes"] + int(nf.sum()) * 16, b["flops"] + int(nf.sum()) * 20
    tests = 0
    if tm.count:
        ts = kh.march_fractions(kw["n_steps"], o.device)[None, :] * mt[:, None]
        ps = o[:, None, :] + d[:, None, :] * ts[..., None]
        ci, cj = kb.trimesh_cells(tm, ps[..., :2])
        cand = tm.cell_tris[ci, cj][..., :min(tm.cell_tris.shape[2], kh.TRI_CAP)]
        tests = int((cand >= 0).sum())
        moved += int(cand.numel()) * 4 + int(torch.unique(cand[cand >= 0]).numel()) * 48
        ops += tests * FLOPS["ray_triangle"]
    counts.update(hull_faces=int(nf.sum()), triangle_tests=tests)
    return bound(moved, ops), counts


def _kl_mesh_work(args, kw):
    """KL's operations and bytes on the mesh world: _kl_work's, plus the
    trimesh rows' triangle tests (150 operations each) and the distinct
    triangles they read (48 bytes each)."""
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.kernels import static_contacts as kb
    seen = dict(tests=0, tris=[])
    rows = kl.trimesh_sphere_rows

    def count(tm, pts, rad, k):
        out = rows(tm, pts, rad, k)
        ci, cj = kb.trimesh_cells(tm, pts[:, :2])
        cand = tm.cell_tris[ci, cj][:, :k]
        seen["tests"] += int((cand >= 0).sum())
        seen["tris"].append(cand[cand >= 0])
        return out
    kl.trimesh_sphere_rows = count
    try:
        ops, probe = _kl_work(args, kw)
    finally:
        kl.trimesh_sphere_rows = rows
    tris = int(torch.unique(torch.cat(seen["tris"])).numel()) if seen["tris"] else 0
    return ops + seen["tests"] * FLOPS["tri_test"], tris * 48, dict(probe, triangle_tests=seen["tests"])


def mesh_kernel_phase(device="cuda", n_objects=12_000, n_dynamic=512, cfg=None, plain_reps=5):
    from substrata_tpu_torch import PhysicsWorld
    from substrata_tpu_torch.benchworld import mesh_tick, mesh_world, occlusion_rays, walk_input
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.kernels import convex as ko
    from substrata_tpu_torch.kernels import ray_trace as kh
    from substrata_tpu_torch.kernels import static_contacts as kb
    from substrata_tpu_torch.physics import broadphase, narrowphase, queries
    from substrata_tpu_torch.physics import character as tchar
    from substrata_tpu_torch.physics.character import EYE_HEIGHT
    from substrata_tpu_torch.physics.state import SimConfig

    results = {}
    # KO on 4,096 seeded random pairs of each hull code, both layouts.
    hulls = hull_library(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    n = 4096
    ba = torch.arange(n, dtype=torch.int32, device=device)
    random_err, random_bounds = 0.0, {}
    for code in ko.CODES:
        pos, quat, prm, fr, re, sens = _random_pair_rows(gen, code, n, device)
        for side, st in enumerate((code // 4, code % 4)):
            if st == 3:
                prm[side * n:(side + 1) * n, 0] = torch.randint(
                    0, 4, (n,), generator=gen, device=device).float()
        bv = torch.rand(n, generator=gen, device=device) < 0.9
        for wm, blocked in ((4, True), (narrowphase._MANIFOLD_WIDTH[code], False)):
            args = (code, wm, blocked, pos, quat, prm, fr, re, sens, ba, ba + n, bv, hulls)
            err, rk = _ko_compare(args)
            check(err <= 1e-5, f"KO code {code}: max abs err {err} > 1e-5")
            random_err = max(random_err, err)
        random_bounds[code] = _ko_work([(args, rk)], hulls)["bound_ms"]

    # The mesh world: KL at t = 0, 1, 2 s of the walk, then KO on its real
    # buckets, KB, KH on the occlusion rays and on 2,048 seeded rays.
    w, p, src = mesh_world(device, n_objects=n_objects, n_dynamic=n_dynamic, cfg=cfg)
    kl_cases, kl_errs = [], []
    for t in range(121):
        if t in (0, 60, 120):
            w._flush()
            kl_cases.append(_char_args(w, p.state, walk_input(t * DT), p.proxy.slot, device))
            kl_errs.append(_kl_compare(*kl_cases[-1])[0])
        mesh_tick(w, p, t * DT, src)
    body, pc, cfg, sw = w.state, w.pair_cache, w.config, w.static_world
    bucket_list = narrowphase.buckets(body, pc.pair_a, pc.pair_b, pc.pair_valid, cfg)[0]
    calls, real_err, valid_slots = [], 0.0, {}
    for code, _, bba, bbb, bvalid in bucket_list:
        if code not in ko.CODES:
            continue
        args = (code, narrowphase._MANIFOLD_WIDTH[code], False, body.pos, body.quat,
                body.shape_params, body.friction, body.restitution, body.is_sensor, bba, bbb,
                bvalid, sw.hulls)
        err, rk = _ko_compare(args)
        real_err = max(real_err, err)
        calls.append((args, rk))
        valid_slots[code] = int(bvalid.sum())
    ko_args = [a for a, _ in calls]
    results["convex_rows"] = dict(
        max_abs_err=max(random_err, real_err), tol=1e-5, random_pairs_per_code=n,
        random_pairs_bound_ms=random_bounds, valid_slots=valid_slots,
        bucket_slots={a[0]: int(a[9].shape[0]) for a in ko_args},
        **_ko_work(calls, sw.hulls),
        ms=median_ms(lambda: [ko.convex_rows(*a) for a in ko_args]),
        device_us_per_launch=device_us(lambda: [ko.convex_rows(*a) for a in ko_args],
                                       "convex_rows"),
        plain_ms=median_ms(lambda: [ko.convex_rows_plain(*a) for a in ko_args],
                           reps=plain_reps))

    # KB with hull samples and the trimesh.  Masks, ids and keys exact;
    # points, normals and depths within 1e-5 on the valid rows.
    kb_args = (body, sw.heightfield, sw.has_heightfield, min(cfg.static_contacts_per_body, 8),
               cfg.present_shape_types, sw.hulls, sw.trimesh, cfg.max_tri_candidates)
    sk, sp = kb.static_contacts(*kb_args), kb.static_contacts_plain(*kb_args)
    for i, name in ((0, "a"), (1, "b"), (5, "valid"), (8, "key")):
        check(torch.equal(sk[i], sp[i]), f"KB (mesh world): {name} differs")
    err = max(max_err(sk[i], sp[i], sp[5]) for i in (2, 3, 4))
    check(err <= 1e-5, f"KB (mesh world): max abs err {err} > 1e-5")
    b, tests = _kb_work(kb_args, sk)
    results["static_contacts_mesh"] = dict(
        max_abs_err=err, tol=1e-5, valid_rows=int(sp[5].sum()),
        trimesh_rows=int((sp[5] & (sp[3][:, 2].abs() < 0.999)).sum()), triangle_tests=tests, **b,
        ms=median_ms(lambda: kb.static_contacts(*kb_args)),
        device_us_per_launch=device_us(lambda: kb.static_contacts(*kb_args), "static_contacts"),
        plain_ms=median_ms(lambda: kb.static_contacts_plain(*kb_args), reps=plain_reps))

    # KH on the occlusion rays and on 2,048 seeded rays into the field:
    # hit, body (owner) and material exact, t and normal within 1e-6.
    ch = p.state
    cam = torch.cat([ch.pos[:2], (ch.pos[2:] + EYE_HEIGHT) - ch.campos_z_delta[None]])
    o, d, mt, keep = occlusion_rays(cam, body.pos[src])
    g = torch.Generator(device=device)
    g.manual_seed(21)
    ro = (torch.rand((2048, 3), generator=g, device=device)
          * torch.tensor([360.0, 360.0, 8.0], device=device)
          - torch.tensor([180.0, 180.0, -0.2], device=device))
    rd = torch.randn((2048, 3), generator=g, device=device)
    rd[:1024, 2] = -rd[:1024, 2].abs() - 0.5
    rd = rd / rd.norm(dim=1, keepdim=True)
    rt = torch.rand(2048, generator=g, device=device) * 60.0
    table = broadphase.build_cell_table(body, cfg)[0]
    os_idx = queries.oversize_slots(body, cfg)
    kw = dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, n_steps=16, body_steps=16,
              collidable_only=True, k=16, dedup=True)
    for name, (ro_, rd_, rt_) in (("occlusion", (o, d, mt)), ("field", (ro, rd, rt))):
        ex = torch.full((ro_.shape[0],), -1, dtype=torch.int32, device=device)
        args = (ro_, rd_, rt_, body, table, os_idx, sw.heightfield, sw.has_heightfield, ex,
                sw.hulls, sw.trimesh)
        rk, rp = kh.ray_trace(*args, **kw), kh.ray_trace_plain(*args, **kw)
        for i, what in ((2, "body"), (3, "hit"), (4, "material")):
            check(torch.equal(rk[i], rp[i]), f"KH ({name}): {what} differs")
        err = max(max_err(rk[0], rp[0]), max_err(rk[1], rp[1]))
        check(err <= 1e-6, f"KH ({name}): max abs err {err} > 1e-6")
        b, counts = mesh_ray_bound(args, kw, rk)
        results[f"ray_trace_{name}"] = dict(
            max_abs_err=err, tol=1e-6, **b, **counts,
            trimesh_hits=int((rp[3] & (rp[2] >= cfg.capacity)).sum()),
            body_hits=int((rp[3] & (rp[2] >= 0) & (rp[2] < cfg.capacity)).sum()),
            kept=int(keep.sum()) if name == "occlusion" else int(rt_.shape[0]),
            ms=median_ms(lambda: kh.ray_trace(*args, **kw)),
            device_us_per_launch=device_us(lambda: kh.ray_trace(*args, **kw), "ray_trace"),
            plain_ms=median_ms(lambda: kh.ray_trace_plain(*args, **kw), reps=plain_reps))

    # KL on a trimesh step (0.3 m, the stair branch), three chained updates.
    sw_ = PhysicsWorld(SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=1.4,
                                 cell_capacity=6), device=device)
    sw_.set_ground_plane(0.0)
    sw_.set_static_trimesh(np.array([[1.0, -3, 0.3], [5, -3, 0.3], [5, 3, 0.3], [1.0, 3, 0.3],
                                     [1.0, -3, 0.0], [1.0, 3, 0.0]], np.float32),
                           np.array([[0, 1, 2], [0, 2, 3], [4, 0, 3], [4, 3, 5]], np.int32))
    sw_._flush()
    st = tchar.init_character_state((0.6, 0, 1.67), device=device).replace(
        gravity_enabled=torch.ones((), dtype=torch.bool, device=device))
    for _ in range(3):
        a, kw_ = _char_args(sw_, st, np.array([3.0, 0, 0], np.float32), -1, device)
        e, new = _kl_compare(a, kw_)
        kl_errs.append(e)
        st = tchar.CharacterState(**new)
    args, kw_ = kl_cases[-1]
    ops, tri_bytes, seen = _kl_mesh_work(args, kw_)
    cand = args[5].shape[1] * kl.n_centers(kw_["cell_size"]) * 27 + args[6].shape[0]
    moved = cand * (4 + 82) + args[6].shape[0] * 4 + nbytes(args[0], args[7]) \
        + (15 + cand + kl.N_STATIC) * 4 + tri_bytes
    results["character_update_mesh"] = dict(
        max_abs_err=max(kl_errs), max_err_of_scale=max(kl_errs), tol=1e-6,
        rows=cand + kl.N_STATIC, contacts_evaluated=seen, **bound(moved, ops),
        ms=median_ms(lambda: kl.character_packed(*args, **kw_)),
        device_us_per_launch=device_us(lambda: kl.character_packed(*args, **kw_),
                                       "character_kernel"),
        plain_ms=median_ms(lambda: kl.character_packed_plain(*args, **kw_), reps=plain_reps))
    return results


# ---------------------------------------------------------------------------
# Phase 13: the mesh world's client frames.
# ---------------------------------------------------------------------------

def mesh_phase(device="cuda", n_objects=12_000, n_dynamic=512, cfg=None,
               sync=torch.cuda.synchronize):
    """180 client frames (``mesh_tick``) of the mesh world.  Checks:
    contacts > 0, KO, KB, KH, KL, KM and KN launched every frame, two
    synchronising calls and (where the profiler sees the card) one
    host->device and two device->host copies a frame, the character's
    state finite, and every hull whose state is not finite at the end was
    thrown (above 50 m or below -0.5 m) in an earlier frame.  The
    reference's trimesh rule (ROADMAP.md queue 3) throws hulls that rest on
    or beside static cubes, up or down, some of them ever faster, and can
    drag the character below the ground: the hulls' heights, the thrown
    and non-finite counts and the character's foot are reported, not
    bounded."""
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.benchworld import mesh_tick, mesh_world
    t0 = time.perf_counter()
    w, p, src = mesh_world(device, n_objects=n_objects, n_dynamic=n_dynamic, cfg=cfg)
    w._flush()
    build_s = time.perf_counter() - t0
    ct = w.static_world.trimesh.cell_tris
    placed = int(torch.unique(ct[ct >= 0]).numel())
    sync()
    kernels.reset_launch_counts()
    times, hits, heights = [], [], []
    for t in range(TICKS):
        sync()
        t1 = time.perf_counter()
        _, hit = mesh_tick(w, p, t * DT, src)
        sync()
        times.append((time.perf_counter() - t1) * 1e3)
        hits.append(int(hit.sum()))
        heights.append(w.state.pos[src, 2].clone())
    counts = kernels.launch_counts()
    for name in MESH_KERNELS:
        check(counts[name] >= TICKS, f"kernel {name}: {counts[name]} launches in {TICKS} frames")
    state = dict(t=TICKS)

    def tick():
        mesh_tick(w, p, state["t"] * DT, src)
        state["t"] += 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(SYNC_TICKS):
            tick()
        torch.cuda.set_sync_debug_mode("default")
    syncs = [c for c in caught
             if str(c.message).startswith("called a synchronizing CUDA operation")]
    check(len(syncs) == 2 * SYNC_TICKS,
          f"{len(syncs)} synchronizing calls in {SYNC_TICKS} frames, expected two each")
    h2d, d2h, device_ops = _copies(tick, SYNC_TICKS)
    if device_ops:
        check(h2d == SYNC_TICKS and d2h == 2 * SYNC_TICKS,
              f"{h2d} host->device and {d2h} device->host copies in {SYNC_TICKS} frames, "
              "expected one and two each")
    st = w.state
    alive = st.alive
    zs = torch.stack(heights)                                   # [frames, hulls]
    thrown = ((zs > 50.0) | (zs < -0.5)).any(dim=0)
    finite = (torch.isfinite(st.pos[src]).all(dim=1) & torch.isfinite(st.quat[src]).all(dim=1)
              & torch.isfinite(st.linvel[src]).all(dim=1))
    check(bool((finite | thrown).all()),
          "a hull that was never thrown has a non-finite state")
    check(bool(torch.isfinite(st.pos[alive & ~torch.isin(
        torch.arange(st.capacity, device=st.pos.device), src)]).all()),
          "the character's proxy has a non-finite state")
    ch = torch.cat([p.state.pos, p.state.vel, p.state.ground_normal, p.state.ground_vel])
    check(bool(torch.isfinite(ch).all()), "non-finite character state")
    d = w.last_diags
    check(int(d.num_contacts) > 0, "no contacts in the mesh world")
    z = torch.where(finite, st.pos[src][:, 2], torch.nan)
    ok_z = zs[:, ~thrown] if bool((~thrown).any()) else zs[:, :1]
    return dict(
        ms_per_mesh_tick_median=float(np.median(times[30:])),
        ms_per_mesh_tick_p90=float(np.percentile(times[30:], 90)), first_tick_ms=times[0],
        build_s=build_s, launches=counts, syncs_per_tick=len(syncs) / SYNC_TICKS,
        h2d_copies_per_tick=h2d / SYNC_TICKS if device_ops else "not measured",
        d2h_copies_per_tick=d2h / SYNC_TICKS if device_ops else "not measured",
        objects=len(w.objects), bodies=int(alive.sum()), triangles=w.static_world.n_tris,
        triangles_in_no_cell=w.static_world.n_tris - placed,
        full_cells=int((ct >= 0).all(dim=2).sum()), hull_library_rows=int(
            (w.static_world.hulls.n_verts > 0).sum()),
        pairs=int(d.num_pairs), contacts=int(d.num_contacts), awake=int(d.num_awake),
        max_penetration=float(d.max_penetration),
        hull_z_min=float(z.nanquantile(0.0)), hull_z_median=float(z.nanmedian()),
        hull_z_max=float(z.nanquantile(1.0)),
        hulls_below_minus_0_5=int((z < -0.5).sum()), hulls_above_50=int((z > 50).sum()),
        hulls_thrown=int(thrown.sum()), hulls_not_finite=int((~finite).sum()),
        first_frame_thrown=int(((zs > 50.0) | (zs < -0.5)).any(dim=1).nonzero()[0])
        if bool(thrown.any()) else None,
        unthrown_hull_z_range=[float(ok_z.min()), float(ok_z.max())],
        occlusion_hits_per_frame_median=float(np.median(hits)),
        character_foot=[float(x) for x in p.state.pos], player_on_ground=p.on_ground)


AGREE_FRAMES = 9   # frames 0-8: before the small mesh world's first trimesh kick


def small_mesh_phase(device="cuda"):
    """A 1,200-object mesh world (96 hulls) on the card and on the CPU path,
    40 client frames: the hulls within 1e-5 m over frames 0-8, the
    character within 1e-5 m and the occlusion hit masks equal over all 40.
    At frame 9 the reference's trimesh rule throws a hull up at ~270 m/s
    (body 84; ROADMAP.md queue 3), and from there that hull carries the
    two paths' last-bit difference (the contact solve's summation order,
    KC within 1e-4 of its twin) scaled by its speed: the first frame past
    1e-4 and the final gap are reported, not bounded."""
    from substrata_tpu_torch.benchworld import mesh_tick, mesh_world
    from substrata_tpu_torch.physics.state import SimConfig
    runs = {}
    for dev in (device, "cpu"):
        w, p, src = mesh_world(dev, n_objects=1200, n_dynamic=96, cfg=SimConfig(
            capacity=256, max_pairs=1024, grid_dim=32, cell_size=4.0, solver_iters=7,
            pair_rebuild_interval=6))
        frames = []
        for t in range(40):
            _, hit = mesh_tick(w, p, t * DT, src)
            frames.append((w.state.pos[src].cpu(), p.state.pos.cpu(), hit))
        runs[dev] = frames
    body_err = [max_err(a[0], b[0]) for a, b in zip(runs[device], runs["cpu"])]
    char_err = max(max_err(a[1], b[1]) for a, b in zip(runs[device], runs["cpu"]))
    early = max(body_err[:AGREE_FRAMES])
    check(early <= 1e-5, f"small mesh world: hulls card vs CPU path {early} > 1e-5 "
                         f"in frames 0-{AGREE_FRAMES - 1}")
    check(char_err <= 1e-5, f"small mesh world: character card vs CPU path {char_err} > 1e-5")
    check(all(np.array_equal(a[2], b[2]) for a, b in zip(runs[device], runs["cpu"])),
          "small mesh world: occlusion hit masks differ")
    past = [t for t, e in enumerate(body_err) if e > 1e-4]
    return dict(cuda_vs_cpu_small_mesh_hulls_err_frames_0_8=early,
                cuda_vs_cpu_small_mesh_character_err=char_err,
                small_mesh_first_frame_past_1e_4=past[0] if past else None,
                small_mesh_hulls_err_frame_39=body_err[-1],
                small_mesh_occlusion_hits=int(sum(int(f[2].sum()) for f in runs["cpu"])))


# ---------------------------------------------------------------------------
# Phase 14: the cell table (KP), the solve setup and refresh (KQ) and the
# Winter scripts (KR).
# ---------------------------------------------------------------------------

# One script per builtin and per operator (the translation hook reads
# env, the rotation hook time), and a let / struct / user-function script.
WINTER_CORPUS = [
    "time + 1.5", "time - 2.25", "time * 0.3", "time / 1.4", "time % 3.0",
    "toFloat(env.instance_index % 7)", "toFloat(env.instance_index / env.num_instances)",
    "if(time == 1.0, 1.0, 0.0) + if(time != 2.0, 1.0, 0.0)",
    "if(time < 0.0, 1.0, 0.0) + if(time <= 1.0, 1.0, 0.0) + if(time > 2.0, 1.0, 0.0)"
    " + if(time >= 3.0, 1.0, 0.0)",
    "if(time > 0.0 && env.instance_index > 3 || !(time < -50.0), 1.0, -1.0)", "-time",
    "sin(time)", "cos(time)", "tan(time * 0.01)", "asin(time * 0.009)", "acos(time * 0.009)",
    "atan(time)", "atan2(time, 3.0)", "sqrt(abs(time))", "abs(time)", "exp(time * 0.01)",
    "log(abs(time) + 1.0)", "floor(time)", "ceil(time)", "pow(abs(time), 1.5)",
    "pow(time, 3)", "mod(time, -2.5)", "min(time, 3.0)", "max(time, -2.0)", "fract(time)",
    "clamp(time, -1.0, 1.0)", "lerp(1.0, 5.0, time * 0.01)", "step(0.0, time)",
    "smoothstep(-50.0, 50.0, time)", "smootherstep(-50.0, 50.0, time)",
    "pulse(-10.0, 10.0, time)", "toFloat(env.instance_index)", "real(env.num_instances)",
    "toFloat(toInt(time * 3.0))", "toFloat(truncateToInt(time))", "toFloat(floorToInt(time))",
    "toFloat(ceilToInt(time))", "neg(time)", "recip(time)", "pi() * time",
    "if(time > 0.0, time * 2.0, 0.0 - 1.0)", "x(vec2(time, 1.0)) + y(vec2(1.0, time))",
    "z(vec3(time)) + w(vec4(1.0, 2.0, 3.0, time))",
    "e0(vec3(time, 1.0, 2.0)) + e1(vec3(1.0, time, 2.0)) + e2(vec3(1.0, 2.0, time))"
    " + e3(vec4(time))",
    "doti(vec3(time, 1.0, 2.0)) + dotj(vec3(1.0, time, 2.0)) + dotk(vec3(1.0, 2.0, time))",
    "dot(vec3(time, 1.0, 2.0), vec3(0.3, time, 0.7))",
    "x(cross(vec3(time, 1.0, 2.0), vec3(0.3, time, 0.7)))", "length(vec3(time, 1.0, 2.0))",
    "length2(vec3(time, 1.0, 2.0))", "dist(vec3(time, 0.0, 0.0), vec3(1.0, 2.0, 3.0))",
    "z(normalise(vec3(time, 1.0, 2.0)))", "y(normalize(vec3(1.0, time, 2.0)))",
    "toFloat(and(time > 0.0, env.instance_index > 3))",
    "toFloat(or(time > 0.0, env.instance_index > 3))", "toFloat(not(time > 0.0))",
    "toFloat(xor(time > 0.0, env.instance_index > 3))", "noise(time)", "noise01(time * 0.1)",
    "fbm(time * 0.1, 3)", "vec3(time, 4.0, 5.0)[1] + vec3(time, 4.0, 5.0)[-1]",
    "add(time, 1.0) * sub(time, 2.0) + div(time, 3.0) + mul(time, 0.25)",
    "toFloat(lt(time, 1.0)) + toFloat(lte(time, 1.0)) + toFloat(gt(time, 2.0))"
    " + toFloat(gte(time, 2.0)) + toFloat(eq(time, 1.0)) + toFloat(neq(time, 1.0))",
    "[time, time * 2.0, 3.0]v", "vec2(time, 2.0) * 2.0 + vec2(1.0) - vec2(time)",
]
WINTER_PROGRAMS = [
    "struct P { real amp, real freq }\n"
    "def wave(float x, P p) float : sin(x * p.freq) * p.amp\n"
    "def evalRotation(float time, WinterEnv env) vec3 :\n"
    "    let p = P(2.0, 3.0) i = toFloat(env.instance_index) in\n"
    "        vec3(wave(time, p), i * 0.1 + time, wave(time + i, P(0.5, 1.0)))\n"
    "def evalTranslation(float time, WinterEnv env) vec3 :\n"
    "    let a = time * 0.3 b = a + 1.0 in vec3(a * b, b / a, if(a > b, a, b))",
]
_TRANSCENDENTAL = re.compile(r"\b(sin|cos|tan|asin|acos|atan|atan2|exp|log|pow|sqrt|length"
                             r"|dist|normalise|normalize|noise|noise01|fbm)\(")


def _winter_sources():
    """(source, uses a transcendental) for the corpus and the programs."""
    out = []
    for e in WINTER_CORPUS:
        vec = e if e.startswith(("[", "vec")) else f"vec3({e}, 0.0, 0.0)"
        env = e.replace("time", "toFloat(env.instance_index) * 0.37")
        venv = env if env.startswith(("[", "vec")) else f"vec3(0.0, {env}, 0.0)"
        out.append(("def evalRotation(float time, WinterEnv env) vec3 : " + vec + "\n"
                    "def evalTranslation(float time, WinterEnv env) vec3 : " + venv,
                    bool(_TRANSCENDENTAL.search(e))))
    return out + [(p, True) for p in WINTER_PROGRAMS]


def _rows_compare(rk, rp, what):
    """KQ's rows and warm impulses against the twin's: masks, slots and
    keys exact, floats within 1e-6 of each output's scale."""
    worst = 0.0
    for f in dataclasses.fields(rk):
        a, b = getattr(rk, f.name), getattr(rp, f.name)
        if not a.dtype.is_floating_point:
            check(torch.equal(a, b), f"KQ {what}: {f.name} differs")
            continue
        fin = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), fin), f"KQ {what}: {f.name} finite mask differs")
        scale = max(1.0, float(b[fin].abs().max())) if bool(fin.any()) else 1.0
        err = max_err(a, b, fin) / scale
        check(err <= 1e-6, f"KQ {what}: {f.name} err {err} of its scale > 1e-6")
        worst = max(worst, err)
    return worst


def _solve_inputs(w):
    """The solve's inputs at the world's state, as physics_step forms them,
    with every dynamic body awake (as a kick, or the serving tick's wake
    regions, leave them): (body after forces, static rows, pair rows,
    table, sign, wm)."""
    from substrata_tpu_torch.physics import integrate, narrowphase, solver
    body, cfg, pc = w.state, w.config, w.pair_cache
    body = body.replace(awake=body.awake | (body.alive & body.dynamic))
    lin, ang, _ = integrate.apply_forces(body, DT, w.params)
    body = body.replace(linvel=lin, angvel=ang)
    n = body.capacity
    wm = narrowphase.blocked_manifold_width(cfg, n)
    pair_cts, _, _ = narrowphase.pair_contacts(body, pc.pair_a, pc.pair_b, pc.pair_valid, cfg,
                                               hulls=w.static_world.hulls, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(body, w.static_world, cfg)
    if wm:
        return body, static_cts, pair_cts, pc.inc_table, pc.inc_sign, wm
    pair_cts, _ = narrowphase.compact_contacts(pair_cts, cfg.max_active_contacts)
    table, sign, _ = solver.build_incidence(pair_cts.a, pair_cts.b,
                                            pair_cts.valid & (pair_cts.a >= 0), n,
                                            cfg.contacts_per_body)
    return body, static_cts, pair_cts, table, sign, 1


def _kq_compare(w, what, timed=False):
    """Both launches of KQ against the twin on one world's solve inputs."""
    from substrata_tpu_torch.kernels import solve as kc
    from substrata_tpu_torch.kernels import solve_setup as kq
    from substrata_tpu_torch.physics import solver
    body, static_cts, pair_cts, table, sign, wm = _solve_inputs(w)
    cache = w.solver_cache.data
    p = w.params
    dt_t = torch.full((), DT, dtype=torch.float32, device=body.device)
    args = (body, static_cts, pair_cts, table, sign)
    rk, ysk, ypk, (hk, vk) = kq.solve_setup(*args, p, DT, cache, wm)
    rp, ysp, ypp, (hp, vp) = kq.solve_setup_plain(*args, p.baumgarte, p.restitution_threshold,
                                                  dt_t, cache, wm)
    err = _rows_compare(rk, rp, what)
    for a, b, name in ((ysk, ysp, "y_s"), (ypk, ypp, "y_p")):
        e = max_err(a, b) / max(1.0, float(b.abs().max()))
        check(e <= 1e-6, f"KQ {what}: {name} err {e} of its scale > 1e-6")
        err = max(err, e)
    check(torch.equal(hk, hp) and torch.equal(vk, vp), f"KQ {what}: cache slots differ")
    setup = solver.SolveSetup(rp, kc.SolveState(ysp, ysp, ypp, ypp), True, table, sign,
                              (hp, vp))
    st, _, _ = solver.iterate(setup, body.linvel, body.angvel, w.config.solver_iters)
    rargs = (cache, hp, vp, static_cts, pair_cts, st.s_l, rp.s_valid, st.p_l, rp.p_valid)
    ck, cp = kq.cache_refresh(*rargs), kq.cache_refresh_plain(*rargs)
    check(torch.equal(ck.view(torch.int32), cp.view(torch.int32)),
          f"KQ {what}: refreshed cache differs")
    res = dict(max_abs_err=err, tol=1e-6, static_rows=int(rp.s_valid.sum()),
               pair_rows=int(rp.p_valid.sum()), wm=wm,
               cache_rows_written=int(vp.sum()))
    if timed:
        rows = static_cts.capacity + pair_cts.capacity
        # What the setup reads: the body fields, the contact fields it takes
        # (not b, but the pair b of each entry's first row), the incidence
        # table, and the cache probe of valid rows only (8 B of keys, 12 B
        # more per hit); then what it writes.
        setup_in = [getattr(body, k) for k in ("pos", "quat", "linvel", "angvel", "inv_mass",
                                               "inv_inertia", "awake")]
        setup_in += [getattr(c, k) for c in (static_cts, pair_cts)
                     for k in ("a", "point", "normal", "penetration", "valid", "friction",
                               "restitution", "key")]
        a_all = torch.cat([static_cts.a, pair_cts.a])
        key_all = torch.cat([static_cts.key, pair_cts.key])
        kk = cache[hp.long()][:, 0:2].contiguous().view(torch.int32)
        hits = int((vp & (kk[:, 0] == a_all) & (kk[:, 1] == key_all)).sum())
        probe = int(vp.sum()) * 8 + hits * 12 + (pair_cts.capacity // wm) * 4
        res["setup"] = dict(
            **bound(nbytes(setup_in, table, sign, rk, ysk, ypk, hk, vk) + probe,
                    FLOPS["solve_setup"] * rows),
            cache_hits=hits,
            ms=median_ms(lambda: kq.solve_setup(*args, p, DT, cache, wm)),
            plain_ms=median_ms(lambda: kq.solve_setup_plain(
                *args, p.baumgarte, p.restitution_threshold, dt_t, cache, wm), reps=3),
            device_us=device_us(lambda: kq.solve_setup(*args, p, DT, cache, wm),
                                "solve_setup_kernel"))
        written = int(vp.sum())
        res["refresh"] = dict(
            **bound(nbytes(cache, ck, hp, vp) + written * 20, 0),
            ms=median_ms(lambda: kq.cache_refresh(*rargs)),
            plain_ms=median_ms(lambda: kq.cache_refresh_plain(*rargs), reps=3),
            device_us=device_us(lambda: kq.cache_refresh(*rargs), "refresh_"))
    return res


def _lattice(rng, n, k_lo, k_hi):
    """float32 k * 1.4 and one ulp either side (k != 0: no denormals)."""
    k = rng.integers(k_lo, k_hi - 1, n)
    base = np.where(k >= 0, k + 1, k).astype(np.float32) * np.float32(1.4)
    step = rng.integers(-1, 2, n)
    return np.where(step < 0, np.nextafter(base, np.float32(-np.inf)),
                    np.where(step > 0, np.nextafter(base, np.float32(np.inf)), base))


def kpqr_phase(device="cuda", n_bodies=10_000, cfg=None, corpus_n=4096, plain_reps=5,
               mesh_objects=12_000, mesh_dynamic=512):
    from substrata_tpu_torch.benchworld import (BenchScripts, WINTER_SOURCES, bench_world,
                                                mesh_tick, mesh_world, serving_tick,
                                                serving_world)
    from substrata_tpu_torch.kernels import cell_table as kp
    from substrata_tpu_torch.kernels import winter as kr
    from substrata_tpu_torch.maths import fp
    from substrata_tpu_torch.scripting import WinterScriptEvaluator
    results = {}

    # KP: the bench world after 30 ticks, both modes; then the same bodies
    # moved onto the 1.4 m lattice, k * 1.4 and one ulp either side.
    # Table, cells and overflow exact.
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    for _ in range(30):
        w.think(DT)
    body, cfg = w.state, w.config
    rng = np.random.default_rng(14)
    n = body.capacity
    lat = np.stack([_lattice(rng, n, -50, 50), _lattice(rng, n, -50, 50),
                    _lattice(rng, n, 0, 6)], axis=1)
    on_lattice = body.replace(pos=torch.as_tensor(lat, device=body.device))
    splits = int((np.floor(lat / np.float32(1.4))
                  != np.floor(lat * (np.float32(1) / np.float32(1.4)))).sum())
    kw = dict(num_buckets=cfg.grid_dim * cfg.grid_dim, cap=cfg.cell_capacity,
              rcp_cell=fp.recip(cfg.cell_size), cell_size=cfg.cell_size)
    overflow = {}
    for name, b in (("bench", body), ("lattice", on_lattice)):
        a = (b.pos, b.alive, b.collidable, b.awake, b.motion_type, b.bound_radius)
        for flags in (False, True):
            tk = kp.cell_table(*a, with_flags=flags, **kw)
            tp = kp.cell_table_plain(*a, with_flags=flags, **kw)
            check(torch.equal(tk[0], tp[0]), f"KP {name} (flags {flags}): table differs")
            check(torch.equal(tk[1], tp[1]), f"KP {name} (flags {flags}): cells differ")
            check(int(tk[2]) == int(tp[2]), f"KP {name} (flags {flags}): overflow differs")
            overflow[f"{name}_flags_{int(flags)}"] = int(tp[2])
    a = (body.pos, body.alive, body.collidable, body.awake, body.motion_type, body.bound_radius)
    tk = kp.cell_table(*a, with_flags=True, **kw)
    results["cell_table"] = dict(
        max_abs_err=0.0, tol=0.0, overflow=overflow, lattice_true_division_splits=splits,
        **bound(nbytes(a, tk), FLOPS["cell_table"] * n),
        ms=median_ms(lambda: kp.cell_table(*a, with_flags=True, **kw)),
        plain_ms=median_ms(lambda: kp.cell_table_plain(*a, with_flags=True, **kw),
                           reps=plain_reps),
        device_us=device_us(lambda: kp.cell_table(*a, with_flags=True, **kw), "cell_"))

    # KQ: the bench world (pair-blocked rows), then the serving and mesh
    # worlds (mixed combos: the compacted layout).
    kq_bench = _kq_compare(w, "bench", timed=True)
    del w
    sw, player = serving_world(device, n_bodies=n_bodies)
    for t in range(60):                  # the pile has landed by then
        serving_tick(sw, player, t * DT)
    kq_serving = _kq_compare(sw, "serving")
    del sw, player
    mw, mplayer, sources = mesh_world(device, n_objects=mesh_objects, n_dynamic=mesh_dynamic)
    for t in range(60):
        mesh_tick(mw, mplayer, t * DT, sources)
    kq_mesh = _kq_compare(mw, "mesh")
    del mw, mplayer
    err = max(kq_bench["max_abs_err"], kq_serving["max_abs_err"], kq_mesh["max_abs_err"])
    results["solve_setup"] = dict(max_abs_err=err, tol=1e-6, bench=kq_bench,
                                  serving=kq_serving, mesh=kq_mesh, **kq_bench["setup"])
    results["cache_refresh"] = dict(max_abs_err=0.0, tol=0.0, **kq_bench["refresh"])

    # KR: bench.py's two scripts at its shape (512 instances), then the
    # corpus, each script over corpus_n seeded instances, all in one
    # launch.  Arithmetic exact; transcendentals within 1e-6 of scale.
    scripts = BenchScripts(device)
    tt = scripts.time(3.1)
    got = kr.winter_eval(scripts.batch, tt, scripts.idx, scripts.n_inst)
    want = kr.winter_eval_plain(scripts.batch, tt, scripts.idx, scripts.n_inst)
    check(torch.equal(got[:, :3], want[:, :3]), "KR bench: rotations differ")
    bench_err = max_err(got, want)
    check(bench_err <= 1e-6 * max(1.0, float(want.abs().max())), f"KR bench: err {bench_err}")
    srcs = _winter_sources()
    evs = [WinterScriptEvaluator(s, device=device) for s, _ in srcs]
    codes = [ev.code() for ev in evs]
    batch = kr.Batch([c for c, _ in codes], [r for _, r in codes],
                     [(k * corpus_n, corpus_n) for k in range(len(srcs))], device)
    b = batch.size
    time_in = torch.as_tensor(rng.uniform(-100, 100, b).astype(np.float32), device=device)
    idx_in = torch.as_tensor(rng.integers(0, 512, b).astype(np.int32), device=device)
    n_in = torch.full((b,), 512, dtype=torch.int32, device=device)
    got = kr.winter_eval(batch, time_in, idx_in, n_in)
    want = kr.winter_eval_plain(batch, time_in, idx_in, n_in)
    corpus_err, exact_scripts = 0.0, 0
    for k, (src, transcendental) in enumerate(srcs):
        s = slice(k * corpus_n, (k + 1) * corpus_n)
        g, wnt = got[s], want[s]
        check(torch.equal(torch.isnan(g), torch.isnan(wnt)), f"KR corpus {k}: NaN mask differs")
        fin = ~torch.isnan(wnt)
        if not transcendental:
            check(torch.equal(g[fin], wnt[fin]), f"KR corpus {k}: differs: {src!r}")
            exact_scripts += 1
            continue
        e = max_err(g, wnt, fin) / max(1.0, float(wnt[fin].abs().max()))
        check(e <= 1e-6, f"KR corpus {k}: err {e} of scale > 1e-6: {src!r}")
        corpus_err = max(corpus_err, e)
    bt = scripts.batch
    n_instr = sum(len(c) for c in bt.codes)
    results["winter_eval"] = dict(
        max_abs_err=max(bench_err, corpus_err), tol=1e-6, corpus_scripts=len(srcs),
        corpus_instances=b, corpus_exact_scripts=exact_scripts,
        bench_sources=list(WINTER_SOURCES),
        **bound(nbytes(bt.table, tt, scripts.idx, scripts.n_inst, got[:bt.size]),
                n_instr * (bt.size // len(bt.codes))),
        ms=median_ms(lambda: kr.winter_eval(bt, tt, scripts.idx, scripts.n_inst)),
        plain_ms=median_ms(lambda: kr.winter_eval_plain(bt, tt, scripts.idx, scripts.n_inst),
                           reps=plain_reps),
        device_us=device_us(lambda: kr.winter_eval(bt, tt, scripts.idx, scripts.n_inst),
                            "winter_kernel"))
    return results


# ---------------------------------------------------------------------------
# Phase 15: the pair finder (KS), the compacted layout's chain (KT), the
# position solve (KU) and sleeping (KV) against their twins, and the
# step's sort-free check.
# ---------------------------------------------------------------------------

def device_us_call(fn, prefix, reps=REPS):
    """Device time (µs) per call of ``fn``, summed over the kernels whose
    names hold ``prefix`` (for wrappers that launch several); None where
    the profiler records no device work."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and prefix in e.name]
    return sum(us) / reps if us else None


def _timed(fn, plain, prefix, bytes_moved, flops, plain_reps):
    return dict(**bound(bytes_moved, flops), ms=median_ms(fn),
                plain_ms=median_ms(plain, reps=plain_reps),
                device_us=device_us_call(fn, prefix))


def _forced(w):
    """The step's body after the forces, as the broadphase sees it."""
    from substrata_tpu_torch.physics import integrate
    lin, ang, _ = integrate.apply_forces(w.state, DT, w.params)
    return w.state.replace(linvel=lin, angvel=ang)


def _ks_compare(w, what, timed=False, plain_reps=5):
    """KS at a rebuild against its twin: pairs, counters, the reuse window
    and the margins exact."""
    from substrata_tpu_torch.kernels import pairs as ks
    body, cfg = _forced(w), w.config
    has_os = bool(w._oversize_slots)
    got = ks.pairs_rebuild(body, DT, cfg, has_os)
    want = ks.pairs_rebuild_plain(body, DT, cfg, has_os)
    names = ("pair_a", "pair_b", "pair_valid", "num_pairs", "overflow", "steps_left", "margins")
    for a, b, name in zip(got, want, names):
        check(a.dtype == b.dtype and torch.equal(a, b), f"KS {what}: {name} differs")
    n_os = int((body.alive & (2.0 * body.bound_radius > cfg.cell_size)).sum())
    res = dict(max_abs_err=0.0, tol=0.0, num_pairs=int(want[3]), overflow=int(want[4]),
               steps_left=int(want[5]), oversize_bodies=n_os, has_oversize=has_os)
    if timed:
        fields = [getattr(body, k) for k in ("pos", "linvel", "alive", "awake", "collidable",
                                             "motion_type", "bound_radius", "shape_type",
                                             "shape_params")]
        alive = int(body.alive.sum())
        ops = (alive * 14 * cfg.cell_capacity * FLOPS["pair_candidate"]
               + (min(n_os, 64) * body.capacity * FLOPS["pair_candidate"] if has_os else 0))
        res.update(_timed(lambda: ks.pairs_rebuild(body, DT, cfg, has_os),
                          lambda: ks.pairs_rebuild_plain(body, DT, cfg, has_os), "pairs_",
                          nbytes(fields, got[:6]), ops, plain_reps))
    return res


def _kt_compare(w, what, timed=False, plain_reps=5):
    """KT's four entry points against their twins on one mixed world's
    pair list: buckets, touching, the compacted rows and the incidence
    table, all exact."""
    from substrata_tpu_torch.kernels import layout as kt
    from substrata_tpu_torch.physics import narrowphase
    body, cfg, pc = _forced(w), w.config, w.pair_cache
    n, p = body.capacity, pc.pair_a.shape[0]
    active = narrowphase._active_codes(cfg)
    check(len(active) > 1, f"KT {what}: a single-combo world")
    gargs = (body.shape_type, pc.pair_a, pc.pair_b, pc.pair_valid, active, cfg.max_pairs)
    gk, ovk, slot = kt.group(*gargs)
    gp, ovp, _ = kt.group_plain(*gargs)
    for (ck, *tk), (cp, *tp) in zip(gk, gp):
        for x, y, name in zip(tk, tp, ("src", "ba", "bb", "bvalid")):
            check(ck == cp and torch.equal(x, y), f"KT {what}: code {cp} {name} differs")
    check(int(ovk) == int(ovp), f"KT {what}: bucket overflow {int(ovk)} != {int(ovp)}")
    srcs, touches, rows = [], [], []
    for code, src, ba, bb, bv in gp:
        r = narrowphase._bucket_rows(code, narrowphase._MANIFOLD_WIDTH[code], False, body, ba,
                                     bb, bv, w.static_world.hulls)
        srcs.append(src)
        touches.append(r[9])
        rows.append(r[:9])
    tk = kt.touching(srcs, touches, p, slot)
    tp = kt.touching_plain(srcs, touches, p)
    check(torch.equal(tk, tp), f"KT {what}: touching differs")
    contacts = tuple(torch.cat([r[i] for r in rows]) for i in range(9))
    m = cfg.max_active_contacts
    ck, cov_k = kt.compact(contacts, m)
    cp, cov_p = kt.compact_plain(contacts, m)
    for x, y, name in zip(ck, cp, narrowphase.CONTACT_FIELDS):
        check(torch.equal(x, y), f"KT {what}: compacted {name} differs")
    check(int(cov_k) == int(cov_p), f"KT {what}: contact overflow differs")
    occ = cp[5] & (cp[0] >= 0)
    cpb = cfg.contacts_per_body
    ik = kt.incidence(cp[0], cp[1], occ, n, cpb)
    ip = kt.incidence_plain(cp[0], cp[1], occ, n, cpb)
    for x, y, name in zip(ik, ip, ("table", "sign", "counts")):
        check(torch.equal(x, y), f"KT {what}: incidence {name} differs")
    per_body = torch.bincount(torch.cat([cp[0][occ].long(), cp[1][occ & (cp[1] >= 0)].long()]),
                              minlength=n)
    valid = contacts[5]
    res = dict(max_abs_err=0.0, tol=0.0, codes=active, bucket_slots=int(sum(len(g[1]) for g in gp)),
               pairs_bucketed=int(sum(int(g[4].sum()) for g in gp)), bucket_overflow=int(ovp),
               touching=int(tp.sum()), rows=int(valid.shape[0]), valid_rows=int(valid.sum()),
               touching_rows=int((valid & (contacts[4] > 0)).sum()),
               compacted=int(cp[5].sum()), contact_overflow=int(cov_p),
               bodies_over_cpb=int((per_body > cpb).sum()), cpb=cpb)
    if timed:
        pa, pb, pv = pc.pair_a, pc.pair_b, pc.pair_valid
        g_out = [t for _, *ts in gk for t in ts] + [slot, ovk]
        st_a = body.shape_type[torch.clamp(pa, min=0).long()]
        st_b = body.shape_type[torch.clamp(pb, min=0).long()]
        sort_codes = torch.where(pv, torch.clamp(st_a * 4 + st_b, 0, 15), 16)
        res["group"] = dict(
            **_timed(lambda: kt.group(*gargs), lambda: kt.group_plain(*gargs), "layout_group",
                     nbytes(pa, pb, pv, body.shape_type, g_out), 0, plain_reps),
            library_ms=median_ms(lambda: torch.argsort(sort_codes, stable=True)))
        res["touching"] = _timed(lambda: kt.touching(srcs, touches, p, slot),
                                 lambda: kt.touching_plain(srcs, touches, p), "layout_touching",
                                 nbytes(slot, touches, tk), 0, plain_reps)
        res["compact"] = _timed(lambda: kt.compact(contacts, m),
                                lambda: kt.compact_plain(contacts, m), "layout_compact",
                                nbytes(contacts, ck, cov_k), 0, plain_reps)
        ia = (cp[0], cp[1], occ, n, cpb)
        res["incidence"] = _timed(lambda: kt.incidence(*ia), lambda: kt.incidence_plain(*ia),
                                  "layout_inc", nbytes(cp[0], cp[1], occ, ik), 0, plain_reps)
    return res


def _kuv_compare(w, what, timed=False, plain_reps=5):
    """KU and KV against their twins on one world's step inputs: the
    positions within 1e-6 of the largest push the twin gives (below an ulp
    of the positions, so exact in practice); flags, timers, velocities and
    steps_left exact."""
    from substrata_tpu_torch.kernels import positions as ku
    from substrata_tpu_torch.kernels import sleep as kv
    from substrata_tpu_torch.physics import integrate, solver
    body, static_cts, pair_cts, table, sign, wm = _solve_inputs(w)
    cfg, prm, st, pc = w.config, w.params, w.state, w.pair_cache
    lin, ang, lam_p, *_ = solver.solve_contacts(body, static_cts, pair_cts, DT, prm, cfg,
                                                w.solver_cache, wm=wm, table=table, sign=sign)
    pos, _ = integrate.integrate_positions(body, lin, ang, DT)
    srows = (static_cts.valid, static_cts.normal, static_cts.penetration)
    prows = (pair_cts.a, pair_cts.b, pair_cts.valid, pair_cts.normal, pair_cts.penetration)
    uargs = (pos, body.inv_mass, body.awake, srows, prows, table, sign, prm.contact_slop)
    pk = ku.solve_positions(*uargs, iters=2, beta=0.25, wm=wm)
    pp = ku.solve_positions_plain(*uargs, 2, 0.25, wm)
    err, moved = max_err(pk, pp), float((pp - pos).abs().max())
    check(err <= 1e-6 * moved, f"KU {what}: err {err} > 1e-6 x the largest push {moved}")
    sargs = (st.awake, body.linvel, st.alive, st.motion_type, pc.pair_a, pc.pair_b,
             pc.pair_valid)
    sk, sp = kv.strike_wake(*sargs), kv.strike_wake_plain(*sargs)
    check(torch.equal(sk, sp), f"KV {what}: strike wake differs")
    vargs = (body, st.awake, lin, ang, (static_cts.valid, static_cts.penetration),
             (pair_cts.a, pair_cts.b, pair_cts.valid, pair_cts.penetration), lam_p, table, sign,
             wm, DT, prm, pc.steps_left)
    vk, vp = kv.sleep_pass(*vargs), kv.sleep_pass_plain(*vargs)
    for f in dataclasses.fields(vp):
        a, b = getattr(vk, f.name), getattr(vp, f.name)
        check(a.dtype == b.dtype and torch.equal(a, b), f"KV {what}: {f.name} differs")
    # Again with half the bodies asleep and every timer near its limit, so
    # that strikes, wakes, sleeps and the velocity zeroing all happen.
    gen = torch.Generator(device=body.device)
    gen.manual_seed(15)
    drowsy = st.awake & (torch.rand(st.awake.shape, generator=gen, device=body.device) < 0.5)
    sargs2 = (drowsy,) + sargs[1:]
    sk2, sp2 = kv.strike_wake(*sargs2), kv.strike_wake_plain(*sargs2)
    check(torch.equal(sk2, sp2), f"KV {what}: strike wake (half asleep) differs")
    body2 = body.replace(awake=sp2, sleep_timer=torch.full_like(body.sleep_timer, 0.49))
    vargs2 = (body2, drowsy) + vargs[2:]
    vk2, vp2 = kv.sleep_pass(*vargs2), kv.sleep_pass_plain(*vargs2)
    for f in dataclasses.fields(vp2):
        a, b = getattr(vk2, f.name), getattr(vp2, f.name)
        check(a.dtype == b.dtype and torch.equal(a, b), f"KV {what}: {f.name} (drowsy) differs")
    res = dict(max_abs_err=err, tol=1e-6 * moved, moved_max=moved,
               struck=int((sp2 & ~drowsy).sum()), newly_awake=int(vp2.newly_awake.sum()),
               newly_asleep=int(vp2.newly_asleep.sum()),
               steps_left=(int(pc.steps_left), int(vp2.steps_left)), wm=wm)
    if timed:
        n, cpb = body.capacity, table.shape[1]
        rows_s, rows_p = static_cts.capacity, pair_cts.capacity
        u_in = [pos, body.inv_mass, body.awake, srows, prows, table, sign]
        res["positions"] = _timed(lambda: ku.solve_positions(*uargs, iters=2, beta=0.25, wm=wm),
                                  lambda: ku.solve_positions_plain(*uargs, 2, 0.25, wm),
                                  "positions_", nbytes(u_in, pk),
                                  2 * FLOPS["position_row"] * (rows_s + rows_p)
                                  + 2 * FLOPS["position_slot"] * n * cpb, plain_reps)
        res["strike"] = _timed(lambda: kv.strike_wake(*sargs),
                               lambda: kv.strike_wake_plain(*sargs), "sleep_strike",
                               nbytes(sargs, sk), 6 * pc.pair_a.shape[0], plain_reps)
        v_in = [body.awake, st.awake, body.sleep_timer, body.alive, body.motion_type, lin, ang,
                vargs[4], vargs[5], lam_p, table, sign, pc.steps_left]
        v_out = [getattr(vk, f.name) for f in dataclasses.fields(vk)]
        res["sleep"] = _timed(lambda: kv.sleep_pass(*vargs), lambda: kv.sleep_pass_plain(*vargs),
                              "sleep_", nbytes(v_in, v_out), FLOPS["sleep_body"] * n,
                              plain_reps)
    return res


STEP_FORBIDDEN = ("aten::sort", "aten::argsort", "aten::cumsum", "aten::cummax",
                  "aten::_cummax_helper", "aten::searchsorted")


# aten ops that launch no device work of their own (allocation, views,
# metadata); every other aten op that calls none of those that do is one
# plain torch launch.
NO_LAUNCH = frozenset("aten::" + n for n in (
    "empty", "empty_strided", "empty_like", "view", "reshape", "_reshape_alias", "select",
    "slice", "as_strided", "expand", "expand_as", "unsqueeze", "squeeze", "t", "transpose",
    "permute", "detach", "alias", "resolve_conj", "resolve_neg", "lift_fresh", "unbind",
    "split", "narrow", "result_type", "contiguous", "to", "_to_copy", "clone", "zeros",
    "zeros_like", "full", "full_like", "ones", "ones_like", "zero_", "new_zeros", "new_empty",
    "new_full", "flatten", "unflatten", "chunk", "view_as", "diagonal", "split_with_sizes",
    "as_strided_", "resize_", "_unsafe_view", "numpy_T", "detach_"))


def _sort_free(run, ticks):
    """(physics_step ranges, aten ops inside them, plain torch launches
    inside them by op name, per step) over ``ticks`` calls of ``run``, from the CPU
    events of torch.profiler.  An op counts as a launch when it is not in
    NO_LAUNCH and none of its own aten children is outside it; the
    composite ops in NO_LAUNCH (``zeros``, ``to``, ``clone``) count through
    the ``fill_`` or ``copy_`` they call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(ticks):
            run()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in events if e.name == "physics_step"]
    inside = [e for e in events if e.name.startswith("aten::")
              and any(a <= e.time_range.start < b for a, b in ranges)]
    plain = {}
    for e in inside:
        if e.name in NO_LAUNCH or any(c.name.startswith("aten::") and c.name not in NO_LAUNCH
                                      for c in e.cpu_children):
            continue
        plain[e.name] = plain.get(e.name, 0) + 1
    steps = max(len(ranges), 1)
    plain = {k: v / steps for k, v in sorted(plain.items(), key=lambda kv: -kv[1])}
    return len(ranges), [e.name for e in inside], plain


def layout_phase(device="cuda", n_bodies=10_000, cfg=None, plain_reps=5, mesh_objects=12_000,
                 mesh_dynamic=512, ticks=6):
    from substrata_tpu_torch.benchworld import (bench_world, mesh_tick, mesh_world,
                                                serving_tick, serving_world)
    from substrata_tpu_torch.kernels import pairs as ks
    results = {}
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    for _ in range(30):
        w.think(DT)
    results["find_pairs"] = _ks_compare(w, "bench", timed=True, plain_reps=plain_reps)
    kuv_bench = _kuv_compare(w, "bench", timed=True, plain_reps=plain_reps)
    # The step launches no sort, argsort, cumsum, cummax or searchsorted:
    # think's rebuild ticks (pairs invalidated before each), then serving
    # ticks below.
    before = ks.launches

    def rebuild_tick():
        w.invalidate_pairs()
        w.think(DT)
    steps, inside, plain = _sort_free(rebuild_tick, ticks)
    check(steps == ticks and ks.launches - before >= ticks,
          f"{steps} physics_step ranges, {ks.launches - before} KS calls in {ticks} rebuild ticks")
    bad = sorted({name for name in inside if name in STEP_FORBIDDEN})
    check(not bad, f"think rebuild ticks: {bad} inside physics_step")
    sort_free = dict(think_rebuild_steps=steps, think_aten_ops_per_step=len(inside) / steps,
                     think_plain_launches=plain)
    del w

    sw, player = serving_world(device, n_bodies=n_bodies)
    for t in range(60):
        serving_tick(sw, player, t * DT)
    kt_serving = _kt_compare(sw, "serving", timed=True, plain_reps=plain_reps)
    kuv_serving = _kuv_compare(sw, "serving")
    state = dict(t=60)

    def tick():
        serving_tick(sw, player, state["t"] * DT)
        state["t"] += 1
    steps, inside, plain = _sort_free(tick, ticks)
    bad = sorted({name for name in inside if name in STEP_FORBIDDEN})
    check(steps == ticks and not bad, f"serving ticks: {steps} steps, {bad} inside physics_step")
    sort_free.update(serving_steps=steps, serving_aten_ops_per_step=len(inside) / steps,
                     serving_plain_launches=plain)
    del sw, player

    mw, mplayer, sources = mesh_world(device, n_objects=mesh_objects, n_dynamic=mesh_dynamic)
    for t in range(60):
        mesh_tick(mw, mplayer, t * DT, sources)
    kt_mesh = _kt_compare(mw, "mesh")
    kuv_mesh = _kuv_compare(mw, "mesh")
    del mw, mplayer

    kt = dict(serving=kt_serving, mesh=kt_mesh)
    for name in ("group", "touching", "compact", "incidence"):
        results[f"layout_{name}"] = dict(max_abs_err=0.0, tol=0.0, **kt_serving.pop(name))
    results["layout_group"]["worlds"] = kt
    kuv = dict(bench=kuv_bench, serving=kuv_serving, mesh=kuv_mesh)
    err = max(r["max_abs_err"] for r in kuv.values())
    tol = min(r["tol"] for r in kuv.values())
    results["solve_positions"] = dict(max_abs_err=err, tol=tol, **kuv_bench.pop("positions"),
                                      worlds=kuv)
    results["strike_wake"] = dict(max_abs_err=0.0, tol=0.0, **kuv_bench.pop("strike"))
    results["sleep_pass"] = dict(max_abs_err=0.0, tol=0.0, **kuv_bench.pop("sleep"))
    results["sort_free"] = sort_free
    return results


# ---------------------------------------------------------------------------
# Phase 16: KW (terrain heights and chunks), KX (scatter points), KY (spawn
# scatter) and KZ (pose) against their twins at BASELINE config 4's widths.
# ---------------------------------------------------------------------------

def _exact(got, want, what):
    check(got.dtype == want.dtype and torch.equal(got, want), f"{what}: differs from its twin")


def _scaled_err(got, want):
    """max |got - want| over the largest |want| (at least 1)."""
    return max_err(got, want) / max(float(want.abs().max()), 1.0)


def _kw_leaves(ts, cam):
    """The leaves a camera at ``cam`` refines the quadtree into, as the
    chunk call takes them (origins [L, 2], widths [L])."""
    ts._refine(ts.root, np.asarray(cam, np.float64))
    leaves = ts._unbuilt_leaves(ts.root, [])
    dev = ts.device
    return (torch.as_tensor(np.array([n.origin for n in leaves], np.float32), device=dev),
            torch.as_tensor(np.array([n.width for n in leaves], np.float32), device=dev))


def _random_pose_arrays(a, seed, n_clips):
    """Every option set: random clips, frames (some negative, some past a
    clip's end), blends, overrides and post rotations on ~half the slots,
    grabs (some 0 or under the 1e-3 threshold) and rigid roots."""
    from substrata_tpu_torch.anim import pose as apose
    from substrata_tpu_torch.anim.skeleton import trs_to_mat4_np
    rng = np.random.default_rng(seed)
    arr = apose.zero_pose_arrays(a)
    s = apose.NUM_SLOTS
    arr["clip_a"][:] = rng.integers(0, n_clips, a)
    arr["clip_b"][:] = rng.integers(0, n_clips, a)
    arr["frame_a"][:] = rng.uniform(-5.0, 400.0, a)
    arr["frame_b"][:] = rng.uniform(-5.0, 400.0, a)
    arr["blend"][:] = rng.uniform(0.0, 1.0, a)
    for k in ("override_rot", "post_rot"):
        q = rng.normal(size=(a, s, 4))
        arr[k][:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    arr["override_mask"][:] = rng.random((a, s)) < 0.4
    arr["post_mask"][:] = rng.random((a, s)) < 0.5
    for k in ("grab_l", "grab_r"):
        g = rng.uniform(0.0, 1.0, a)
        g[::5], g[1::7] = 0.0, 5e-4
        arr[k][:] = g
    for i in range(a):
        q = rng.normal(size=4)
        arr["root"][i] = trs_to_mat4_np(rng.uniform(-50, 50, 3), q / np.linalg.norm(q),
                                        np.ones(3)).astype(np.float32)
    return arr


def _fk_library(local, rig, root):
    """The FK as one batched torch.matmul per level, then the root and the
    inverse bind: KZ's library yardstick (the sampling and the local
    matrices left out)."""
    world = local.clone()
    for idx, par in rig.levels:
        world[:, idx] = torch.matmul(world[:, par], local[:, idx])
    return world, torch.matmul(root[:, None], world), torch.matmul(world, rig.inverse_bind)


def terrain_kernel_phase(device="cuda", res=None, n_points=65_536, n_avatars=64, plain_reps=5):
    from substrata_tpu_torch import benchworld as bw
    from substrata_tpu_torch.anim import pose as apose
    from substrata_tpu_torch.kernels import pose as kz
    from substrata_tpu_torch.kernels import spawn as ky
    from substrata_tpu_torch.kernels import terrain as kt
    from substrata_tpu_torch.physics.particles import zero_particles
    from substrata_tpu_torch.physics.terrain import TerrainSystem
    res = res or bw.TERRAIN_RES
    h, cw, origin = bw.terrain_heightmap(res)
    ts = TerrainSystem(device=device)
    ts.set_heightmap(h, origin, cw)
    hf = ts.heightfield
    field = (hf.heights, hf.origin, hf.cell_w)
    hscale = float(np.abs(h).max())
    rng = np.random.default_rng(16)
    out = {}

    # KW (a): heights and normals at 65,536 points over the map and past it.
    xy = torch.as_tensor(rng.uniform(-530, 530, (n_points, 2)).astype(np.float32),
                         device=device)
    errs = {}
    for normals in (False, True):
        got = kt.terrain_heights(*field, xy, normals)
        want = kt.terrain_heights_plain(*field, xy, normals)
        errs[normals] = (max_err(got[:, 0], want[:, 0]) / hscale,
                         max_err(got[:, 1:], want[:, 1:]) if normals else 0.0)
    kw_err = max(max(e) for e in errs.values())
    check(kw_err <= 1e-6, f"KW heights: {kw_err} of scale > 1e-6")
    gs_grid = ((xy - hf.origin) / hf.cell_w / (torch.tensor(h.shape, device=device) - 1)
               * 2 - 1).flip(-1).view(1, 1, -1, 2)
    hmap = hf.heights.view(1, 1, *h.shape)
    pts_bytes = n_points * (8 + 16 + 16)
    out["terrain_heights"] = dict(
        max_abs_err=kw_err, tol=1e-6, points=n_points, heights_err=errs[False][0],
        normals_err=errs[True][1],
        **bound(pts_bytes, kt.heights_flops(n_points, True)),
        ms=median_ms(lambda: kt.terrain_heights(*field, xy, True)),
        plain_ms=median_ms(lambda: kt.terrain_heights_plain(*field, xy, True),
                           reps=plain_reps),
        device_us=device_us(lambda: kt.terrain_heights(*field, xy, True), "heights_kernel"),
        library_ms=median_ms(lambda: torch.nn.functional.grid_sample(
            hmap, gs_grid, mode="bilinear", align_corners=True)),
        library_call="torch.nn.functional.grid_sample (bilinear heights, no normals)")
    one = xy[:1].contiguous()
    out["terrain_heights"]["clamp_query"] = dict(
        ms=median_ms(lambda: kt.terrain_heights(*field, one)),
        device_us=device_us(lambda: kt.terrain_heights(*field, one), "heights_kernel"),
        **bound(40, kt.heights_flops(1, False)))

    # KW (b): every leaf a camera at the origin builds.
    lo, lw = _kw_leaves(ts, [0.0, 0.0])
    n_leaf, cf, nv8 = lo.shape[0], kt.chunk_floats(16), 17 * 17 * 8
    got = kt.terrain_chunks(*field, lo, lw, 16)
    want = kt.terrain_chunks_plain(*field, lo, lw, 16)
    _exact(got[:, nv8:].contiguous().view(torch.int32), want[:, nv8:].contiguous().view(
        torch.int32), "KW chunk triangles")
    ch_err = _scaled_err(got[:, :nv8], want[:, :nv8])
    check(ch_err <= 1e-6, f"KW chunks: {ch_err} of scale > 1e-6")
    out["terrain_chunks"] = dict(
        max_abs_err=ch_err, tol=1e-6, leaves=n_leaf,
        **bound(n_leaf * (12 + cf * 4) + n_leaf * 289 * 16, n_leaf * 289 * 60),
        ms=median_ms(lambda: kt.terrain_chunks(*field, lo, lw, 16)),
        plain_ms=median_ms(lambda: kt.terrain_chunks_plain(*field, lo, lw, 16),
                           reps=plain_reps),
        device_us=device_us(lambda: kt.terrain_chunks(*field, lo, lw, 16), "chunks_kernel"),
        library_ms=None)

    # KX: the 81 cells around the origin, then one 9-cell column.
    def cells(xs, ys):
        return torch.as_tensor(np.array([[kx * 32.0, ky * 32.0] for kx in xs for ky in ys],
                                        np.float32), device=device)
    kx_res = {}
    for what, c in (("start_81", cells(range(-4, 5), range(-4, 5))),
                    ("move_9", cells([5], range(-4, 5)))):
        got = kt.terrain_scatter(*field, c, 32.0, 1234, 64)
        want = kt.terrain_scatter_plain(*field, c, 32.0, 1234, 64)
        _exact(got, want, f"KX {what}")
        kx_res[what] = dict(cells=c.shape[0], valid=int((got[..., 5] > 0.5).sum()))
    c81 = cells(range(-4, 5), range(-4, 5))
    out["terrain_scatter"] = dict(
        max_abs_err=0.0, tol=0.0, **kx_res,
        **bound(81 * 8 + 81 * 64 * (24 + 16), kt.scatter_flops(81, 64)),
        ms=median_ms(lambda: kt.terrain_scatter(*field, c81, 32.0, 1234, 64)),
        plain_ms=median_ms(lambda: kt.terrain_scatter_plain(*field, c81, 32.0, 1234, 64),
                           reps=plain_reps),
        device_us=device_us(lambda: kt.terrain_scatter(*field, c81, 32.0, 1234, 64),
                            "scatter_kernel"),
        library_ms=None)

    # KY: the 10,000-row burst into an empty ring, a 20,000-row flush that
    # wraps it from slot 10,000.
    def flush_rows(n, seed):
        g = np.random.default_rng(seed)
        rows = [dict(pos=g.uniform(-50, 50, 3), vel=g.uniform(-5, 5, 3), area=1e-4, mass=1e-6,
                     restitution=0.5, width=0.1, dwidth_dt=0.0, opacity=1.0,
                     dopacity_dt=float(-1.0 / g.uniform(0.01, 2.0)), theta=0.0,
                     sprite_type=int(g.integers(0, 2)), die_on_hit=bool(g.random() < 0.3))
                for _ in range(n)]
        return torch.as_tensor(ky.pack_rows(rows), device=device)
    burst = flush_rows(10_000, 1)
    for what, rows, cursor in (("burst_10000", burst, 0),
                               ("wrap_20000", flush_rows(20_000, 2), 10_000)):
        a = ky.spawn_rows(zero_particles(16_384, device=device), rows, cursor)
        b = ky.spawn_rows_plain(zero_particles(16_384, device=device), rows, cursor)
        for f in ky.STATE_FIELDS:
            _exact(getattr(a, f), getattr(b, f), f"KY {what} {f}")
    ring = zero_particles(16_384, device=device)
    out["spawn_rows"] = dict(
        max_abs_err=0.0, tol=0.0, rows=10_000,
        **bound(10_000 * (64 + 62), 0),
        ms=median_ms(lambda: ky.spawn_rows(ring, burst, 0)),
        plain_ms=median_ms(lambda: ky.spawn_rows_plain(ring, burst, 0), reps=plain_reps),
        device_us=device_us(lambda: ky.spawn_rows(ring, burst, 0), "spawn_kernel"),
        library_ms=None)

    # KZ: the 64 avatars at three moments of their walk (frames 0, 60,
    # 120), every option at random, and 37 avatars padded to 64.
    sc = bw.terrain_world(device, res=129, n_burst=0, n_stream=0, n_avatars=n_avatars)
    g = sc.graphics
    _, _, kern = g._rig()
    bank, rig = kern.bank, kern.rig
    moments = {}
    for frame in range(121):
        bw.move_avatars(sc, frame * DT)
        for av in sc.avatars:
            g.update_avatar(av, DT)
        if frame % 60 == 0:
            moments[f"walk_frame_{frame}"] = g.pack_all()[2]
    moments["all_options_64"] = _random_pose_arrays(64, 3, len(bank.names))
    pad = apose.zero_pose_arrays(64)
    part = _random_pose_arrays(37, 4, len(bank.names))
    for k in pad:
        pad[k][:37] = part[k]
    moments["padded_37"] = pad
    for what, arr in moments.items():
        p = apose.pose_params_from_arrays(arr, device=device)
        _exact(kz.pose(bank, rig, p), kz.pose_plain(bank, rig, p), f"KZ {what}")
    p = apose.pose_params_from_arrays(moments["walk_frame_60"], device=device)
    local = kz.pose_plain(bank, rig, p)[0]     # any [A, J, 4, 4] of the right shape
    a, nj = p.count, rig.parent.shape[0]
    out["pose_avatars"] = dict(
        max_abs_err=0.0, tol=0.0, avatars=a, joints=nj, moments=list(moments),
        **bound(a * nj * 4 * 28 + a * 500 + nj * 100 + 3 * a * nj * 64, a * nj * 600),
        ms=median_ms(lambda: kz.pose(bank, rig, p)),
        plain_ms=median_ms(lambda: kz.pose_plain(bank, rig, p), reps=plain_reps),
        device_us=device_us(lambda: kz.pose(bank, rig, p), "pose_kernel"),
        library_ms=median_ms(lambda: _fk_library(local, rig, p.root)),
        library_call="the FK as torch.matmul per level (11), then root and inverse bind")
    return out


# ---------------------------------------------------------------------------
# Phase 17: BASELINE config 4 + 64 avatars, 180 client frames.
# ---------------------------------------------------------------------------

TERRAIN_KERNELS = ("terrain_heights", "spawn_rows", "pose_avatars", "ray_trace",
                   "particles_update", "character_update", "apply_tick_in", "digest_tblock")


def _tree_ids(sc):
    return {id(o) for obs in sc.scattering.tree_physics_obs.values() for o in obs}


def _counted(run, frames):
    """Synchronizing calls (sync debug mode) and the profiler's copies over
    ``frames`` calls of ``run``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(frames):
            run()
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum(str(c.message).startswith("called a synchronizing CUDA operation")
                for c in caught)
    h2d, d2h, ops = _copies(run, frames)
    per = lambda x: x / frames if ops else "not measured"
    return dict(syncs_per_frame=syncs / frames, h2d_per_frame=per(h2d), d2h_per_frame=per(d2h),
                device_ops_per_frame=ops / frames)


def terrain_phase(device="cuda", sync=torch.cuda.synchronize, **size):
    from substrata_tpu_torch import benchworld as bw
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.physics.character import EYE_HEIGHT
    sc = bw.terrain_world(device, **size)
    hf = sc.terrain.heightfield
    sync()
    kernels.reset_launch_counts()
    times, alive_every_30, moves = [], {}, []
    min_alive = None
    for f in range(TICKS):
        before = _tree_ids(sc) if f > 0 and f % bw.MOVE_EVERY == 0 else None
        sync()
        t0 = time.perf_counter()
        bw.terrain_tick(sc, f)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        alive = sc.particles.num_alive
        if f >= 1:
            min_alive = alive if min_alive is None else min(min_alive, alive)
        if f % 30 == 0:
            alive_every_30[f] = alive
        if before is not None:
            after = _tree_ids(sc)
            moves.append(dict(frame=f, trees_evicted=len(before - after),
                              trees_added=len(after - before), trees=len(after)))
            check(before - after and after - before, f"frame {f}: the move left the trees as "
                  "they were")
    counts = kernels.launch_counts()
    for name in TERRAIN_KERNELS:
        check(counts[name] >= TICKS, f"kernel {name}: {counts[name]} launches in {TICKS} "
              "terrain frames")
    for name in ("terrain_chunks", "terrain_scatter"):
        check(counts[name] > 0, f"kernel {name} never launched in the terrain frames")
    n_burst = size.get("n_burst", bw.N_BURST)
    floor = 0.8 * n_burst
    check(min_alive > floor, f"alive particles fell to {min_alive} (<= {floor})")
    # The state.
    st, ps = sc.world.state, sc.particles.state
    check(bool(torch.isfinite(st.pos[st.alive]).all()), "non-finite body positions")
    live = ps.alive
    check(bool(torch.isfinite(ps.pos[live]).all()), "non-finite particle positions")
    ground = hf.heights_at(ps.pos[:, :2].contiguous())[:, 0]
    below = int((live & (ps.pos[:, 2] < ground - 0.05)).sum())
    for g in sc.graphics.by_uid.values():
        check(np.isfinite(g.joints_world).all() and np.isfinite(g.skin_matrices).all(),
              "non-finite joints")
    eye = sc.player.get_eye_position()
    foot_ground = sc.terrain.eval_terrain_height(float(eye[0]), float(eye[1]))
    foot_gap = float(eye[2] - EYE_HEIGHT - foot_ground)
    check(foot_gap > -0.3, f"the character's foot {foot_gap} m below the terrain")
    worst = 0.0
    for _, _, (verts, _, _, _) in sc.terrain.visible_chunks():
        z = sc.terrain.eval_terrain_heights(verts[:, :2])
        worst = max(worst, float(np.abs(verts[:, 2] - z).max()))
    check(worst <= 1e-5, f"a chunk vertex lies {worst} m off the terrain")
    # Syncs and copies: frames without a move, then move frames.
    state = dict(f=TICKS)

    def plain_frame():
        state["f"] += 1 if (state["f"] + 1) % bw.MOVE_EVERY else 2
        bw.terrain_tick(sc, state["f"])

    def move_frame():
        state["f"] = (state["f"] // bw.MOVE_EVERY + 1) * bw.MOVE_EVERY
        bw.terrain_tick(sc, state["f"])
    counted = dict(no_move=_counted(plain_frame, SYNC_TICKS), move=_counted(move_frame, 3))
    return dict(
        ms_per_terrain_tick_median=float(np.median(times[30:])),
        ms_per_terrain_tick_p90=float(np.percentile(times[30:], 90)),
        first_tick_ms=times[0], move_tick_ms=[times[m["frame"]] for m in moves],
        launches=counts, alive_every_30=alive_every_30, min_alive_from_frame_1=min_alive,
        moves=moves, particles_below_terrain=below, foot_above_terrain=foot_gap,
        chunk_vertex_max_off_terrain=worst, chunks=len(sc.terrain.visible_chunks()),
        chunks_built=sc.terrain.num_chunks_built, scatter_cells=len(sc.scattering.chunks),
        scatter_instances=sc.scattering.num_instances(), bodies=len(sc.world.objects),
        player_eye=[float(x) for x in eye], **counted)


def small_terrain_phase(device="cuda", frames=40):
    """The small terrain world (a 129 x 129 map, 512 burst particles then 8
    a frame, 8 avatars) on the card and on the CPU path for 40 frames:
    live particles within 1e-4 m (alive masks equal), the joints within
    1e-5 of each matrix's scale, the character within 1e-4 m, the chunks
    and the scatter points equal."""
    from substrata_tpu_torch import benchworld as bw
    from substrata_tpu_torch.physics.state import SimConfig
    cfg = SimConfig(capacity=2048, max_pairs=4096, grid_dim=32, cell_size=4.0)
    runs = {}
    for dev in (device, "cpu"):
        sc = bw.terrain_world(dev, res=129, n_burst=512, n_stream=8, n_avatars=8, cfg=cfg)
        for f in range(frames):
            bw.terrain_tick(sc, f)
        ps = sc.particles.state
        runs[dev] = dict(
            alive=ps.alive.cpu(), pos=ps.pos.cpu(), eye=sc.player.get_eye_position(),
            joints=[np.stack([g.joints_obj, g.joints_world, g.skin_matrices])
                    for g in sc.graphics.by_uid.values()],
            chunks=[(o, w, c) for o, w, c in sc.terrain.visible_chunks()],
            scatter={k: np.array([[*i.pos, i.scale, i.rot] for i in v])
                     for k, v in sc.scattering.chunks.items()})
    a, b = runs[device], runs["cpu"]
    check(torch.equal(a["alive"], b["alive"]), "small terrain world: alive masks differ")
    p_err = max_err(a["pos"], b["pos"], b["alive"])
    check(p_err <= 1e-4, f"small terrain world: particles card vs CPU path {p_err} > 1e-4")
    e_err = float(np.abs(a["eye"] - b["eye"]).max())
    check(e_err <= 1e-4, f"small terrain world: character {e_err} > 1e-4")
    j_err = 0.0
    for x, y in zip(a["joints"], b["joints"]):
        scale = np.maximum(np.abs(y).max(axis=(-1, -2), keepdims=True), 1.0)
        j_err = max(j_err, float((np.abs(x - y) / scale).max()))
    check(j_err <= 1e-5, f"small terrain world: joints {j_err} of scale > 1e-5")
    check(len(a["chunks"]) == len(b["chunks"]), "small terrain world: chunk counts differ")
    for (oa, wa, ca), (ob, wb, cb) in zip(a["chunks"], b["chunks"]):
        check(np.array_equal(oa, ob) and wa == wb and all(np.array_equal(x, y)
                                                          for x, y in zip(ca, cb)),
              "small terrain world: a chunk differs")
    check(list(a["scatter"]) == list(b["scatter"]) and all(
        np.array_equal(a["scatter"][k], b["scatter"][k]) for k in a["scatter"]),
        "small terrain world: scatter points differ")
    return dict(cuda_vs_cpu_small_terrain_particle_err=p_err,
                cuda_vs_cpu_small_terrain_character_err=e_err,
                cuda_vs_cpu_small_terrain_joint_err=j_err,
                small_terrain_alive=int(a["alive"].sum()), small_terrain_chunks=len(a["chunks"]))


# ---------------------------------------------------------------------------
# Phase 18: KAA (the mix's per-source setup and epilogue) and KAB (the
# vehicles' pre-ray setup and delta scatter) against their twins.
# ---------------------------------------------------------------------------

HRIR_EDGE = 1e-5   # a bin's pre-round value this close to a half-integer may move


def _kaa_args(src, lis, block, use_hrtf):
    from substrata_tpu_torch.kernels import audio_setup as kaa
    return (src.alive, src.paused, src.finished, src.spatial, src.pos, src.vel, src.delta,
            src.doppler_factor, src.mute_factor, src.mute_target, src.mute_rate, src.volume,
            src.num_occlusions, lis.pos, lis.vel, lis.right, lis.forward, lis.up,
            kaa.dop_alpha(block), block / kaa.ENGINE_RATE, use_hrtf)


def _hrir_edges(src, lis):
    """Sources whose HRIR bin hangs on atan2's last bit: a pre-round
    azimuth or elevation value within HRIR_EDGE of a half-integer."""
    import math
    from substrata_tpu_torch.audio.hrtf import N_AZ, N_EL
    from substrata_tpu_torch.maths.fp import dot3, fma, recip, sqrt
    to = src.pos - lis.pos[None]
    x, y, z = (dot3(to, v[None]) for v in (lis.right, lis.forward, lis.up))
    az = torch.atan2(x, y)
    el = torch.atan2(z, torch.clamp(sqrt(fma(x, x, y * y)), min=1e-6))
    pa = az * recip(2 * math.pi) * N_AZ
    pe = (el + math.pi / 4) * recip(math.pi / 2) * (N_EL - 1)

    def near(p):
        return (p - torch.floor(p) - 0.5).abs() <= HRIR_EDGE
    return near(pa) | near(pe)


def _kaa_compare(src, pool, lis, block, use_hrtf, what, timed=False, plain_reps=5):
    """KAA's setup and epilogue against their twins on one source state.
    Exact on masks, bins (but the edge sources, counted) and arithmetic;
    the pan's cos and sin (HRTF off) within 1e-6 of the gains' scale."""
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.kernels import audio_mix as ka
    from substrata_tpu_torch.kernels import audio_setup as kaa
    s, nl = src.delta.shape
    args = _kaa_args(src, lis, block, use_hrtf)
    bk, bp = kaa.audio_setup(*args), kaa.audio_setup_plain(*args)
    vk, vp = kaa.setup_views(bk, s, nl), kaa.setup_views(bp, s, nl)
    for name in ("active", "use_lp", "eff_delta", "dop_smooth", "mute", "gain", "alpha",
                 "send_gain"):
        _exact(vk[name], vp[name], f"KAA setup {what}: {name}")
    edges = _hrir_edges(src, lis) if use_hrtf else torch.zeros_like(src.alive)
    live = ~edges
    _exact(vk["dir_idx"][live], vp["dir_idx"][live], f"KAA setup {what}: dir_idx")
    moved = int((vk["dir_idx"] != vp["dir_idx"]).sum())
    if use_hrtf:
        _exact(vk["gl"], vp["gl"], f"KAA setup {what}: gl")
        _exact(vk["gr"], vp["gr"], f"KAA setup {what}: gr")
        err = 0.0
    else:
        err = max(_scaled_err(vk["gl"], vp["gl"]), _scaled_err(vk["gr"], vp["gr"]))
        check(err <= 1e-6, f"KAA setup {what}: gains {err} of scale > 1e-6")
    # The epilogue's inputs from this block's fetch and spatialise.
    samples, heads = mix.fetch(pool, src, vp["eff_delta"], vp["active"], block)
    level = ka.audio_spatialise(
        samples, src.lp_state, vp["alpha"], vp["use_lp"], src.spatial, src.hrir_hist,
        mix.hrir_bank_tensor(src.device) if use_hrtf else None,
        vp["dir_idx"] if use_hrtf else None, src.prev_gain_l, src.prev_gain_r, vp["gl"],
        vp["gr"], mix.gain_ramp(block, src.device), vp["gain"], None, use_hrtf)[5]
    eargs = (src.finished, src.looping, src.stream_mode, vp["active"], heads, src.buf_len,
             level, src.smoothed_level, src.alive, src.remove_on_finish)
    ek, ep = kaa.audio_epilogue(*eargs), kaa.audio_epilogue_plain(*eargs)
    ek, ep = kaa.epilogue_views(ek, s), kaa.epilogue_views(ep, s)
    for name in ("smoothed_level", "finished", "alive"):
        _exact(ek[name], ep[name], f"KAA epilogue {what}: {name}")
    res = {"audio_setup": dict(max_abs_err=err, tol="exact; gains 1e-6 of scale without HRTF",
                               sources=s, alive=int(src.alive.sum()), hrir_edge_sources=int(
                                   edges.sum()), hrir_bins_moved=moved, use_hrtf=use_hrtf),
           "audio_epilogue": dict(max_abs_err=0.0, tol="exact", sources=s)}
    if timed:
        res["audio_setup"].update(
            **bound(nbytes(args[:18], bk), FLOPS["audio_setup"] * s),
            ms=median_ms(lambda: kaa.audio_setup(*args)),
            device_us=device_us(lambda: kaa.audio_setup(*args), "audio_setup_kernel"),
            plain_ms=median_ms(lambda: kaa.audio_setup_plain(*args), reps=plain_reps))
        # The epilogue reads layer 0 of the heads and buffer lengths only.
        res["audio_epilogue"].update(
            **bound(nbytes(eargs[:4], eargs[6:], ek["smoothed_level"]) + 8 * s + 4 * s,
                    FLOPS["audio_epilogue"] * s),
            ms=median_ms(lambda: kaa.audio_epilogue(*eargs)),
            device_us=device_us(lambda: kaa.audio_epilogue(*eargs), "audio_epilogue_kernel"),
            plain_ms=median_ms(lambda: kaa.audio_epilogue_plain(*eargs), reps=plain_reps))
    return res


def _kab_compare(veh, state, what, timed=False, plain_reps=5, seed=0):
    """KAB's setup and scatter against their twins, exact (the setup's
    buffer word for word; the scatter on copies of the chassis rows, with
    seeded deltas)."""
    from substrata_tpu_torch.kernels import vehicle_setup as kab
    args = (veh.body_slot, veh.y_fwd_quat, veh.wheel_attach, veh.wheel_radius, veh.sus_max,
            state.pos, state.quat, state.linvel, state.angvel, state.inv_mass,
            state.inv_inertia)
    bk, bp = kab.vehicle_setup(*args), kab.vehicle_setup_plain(*args)
    _exact(bk.view(torch.int32), bp.view(torch.int32), f"KAB setup {what}")
    v = veh.body_slot.shape[0]
    gen = torch.Generator(device=state.pos.device).manual_seed(seed)
    dv = torch.randn((v, 3), generator=gen, device=state.pos.device)
    dw = torch.randn((v, 3), generator=gen, device=state.pos.device)

    def rows():
        return [state.linvel.clone(), state.angvel.clone(), state.awake.clone(),
                state.sleep_timer.clone()]
    rk, rp = rows(), rows()
    kab.vehicle_scatter(veh.body_slot, dv, dw, *rk)
    kab.vehicle_scatter_plain(veh.body_slot, dv, dw, *rp)
    for x, y, name in zip(rk, rp, ("linvel", "angvel", "awake", "sleep_timer")):
        _exact(x, y, f"KAB scatter {what}: {name}")
    n_body = int((veh.body_slot >= 0).sum())
    res = {"vehicle_setup": dict(max_abs_err=0.0, tol="exact", vehicles=v, with_body=n_body),
           "vehicle_scatter": dict(max_abs_err=0.0, tol="exact", vehicles=v, with_body=n_body)}
    if timed:
        res["vehicle_setup"].update(
            # Each vehicle reads its own row of the body state (4 + 12 + 16
            # + 12 + 12 + 4 + 12 bytes) and its settings; the buffer out.
            **bound(nbytes(args[:5], bk) + v * 72, FLOPS["vehicle_setup"] * v),
            ms=median_ms(lambda: kab.vehicle_setup(*args)),
            device_us=device_us(lambda: kab.vehicle_setup(*args), "vehicle_setup_kernel"),
            plain_ms=median_ms(lambda: kab.vehicle_setup_plain(*args), reps=plain_reps))
        res["vehicle_scatter"].update(
            # Slots and deltas in; each body's two velocity rows read and
            # written, its flag and timer written.
            **bound(nbytes(veh.body_slot, dv, dw) + n_body * (24 * 2 + 1 + 4),
                    FLOPS["vehicle_scatter"] * n_body),
            ms=median_ms(lambda: kab.vehicle_scatter(veh.body_slot, dv, dw, *rk)),
            device_us=device_us(lambda: kab.vehicle_scatter(veh.body_slot, dv, dw, *rk),
                                "vehicle_deltas_kernel"),
            plain_ms=median_ms(lambda: kab.vehicle_scatter_plain(veh.body_slot, dv, dw, *rp),
                               reps=plain_reps))
    return res


def setup_kernel_phase(device="cuda", n_bodies=10_000, cfg=None, blocks=30, warm=30,
                       plain_reps=5):
    """Phase 18's first half: KAA on bench.py's 256-source scene after
    ``blocks`` mixed blocks (HRTF on, the timed case, and off), KAB on the
    full tick's 8 vehicles after ``warm`` full ticks (and with one
    vehicle's body gone, slot -1)."""
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.benchworld import (TICK_FRAMES, bench_audio, bench_fulltick,
                                                bench_world, full_tick)
    w = bench_world(device, n_bodies=n_bodies, cfg=cfg)
    b = TICK_FRAMES
    src, pool, lis, room = bench_audio(device)
    idx = torch.arange(src.capacity, device=device)
    src = src.replace(pos=w.state.pos[idx], vel=w.state.linvel[idx])
    for _ in range(blocks):
        src, _, room = mix.mix_block(src, pool, lis, room=room, use_hrtf=True, block=b)
    res = _kaa_compare(src, pool, lis, b, True, "bench HRTF", timed=True, plain_reps=plain_reps)
    off = _kaa_compare(src, pool, lis, b, False, "bench pan")
    res["audio_setup"]["max_abs_err"] = max(res["audio_setup"]["max_abs_err"],
                                            off["audio_setup"]["max_abs_err"])
    res["audio_setup_pan"] = off["audio_setup"]
    veh, vin, ps, char, scripts = bench_fulltick(w, device)
    src, pool, lis, room = bench_audio(device)
    for t in range(warm):
        veh, ps, src, _, room, char = full_tick(w, veh, vin, ps, src, pool, lis, room, idx, char,
                                                t * DT, scripts)
    res.update(_kab_compare(veh, w.state, "full tick", timed=True, plain_reps=plain_reps))
    gone = veh.replace(body_slot=torch.where(torch.arange(veh.body_slot.shape[0],
                                                          device=device) == 5,
                                             -1, veh.body_slot).to(torch.int32))
    _kab_compare(gone, w.state, "full tick, vehicle 5 without a body", seed=1)
    return res


# ---------------------------------------------------------------------------
# Phase 19: the client frame, ClientApp.timer_event over BASELINE config 5.
# ---------------------------------------------------------------------------

CLIENT_FRAMES = TICKS
CLIENT_KERNELS = ("audio_setup", "audio_epilogue", "vehicle_setup", "vehicle_scatter")
KICK_SPEED = 20.0     # m/s: past this a body has been thrown (the trimesh sign rule)


def _winter_alike(app, t):
    """The app's Winter batch at time ``t`` through KR and through its twin."""
    from substrata_tpu_torch.kernels import winter as kr
    k = app.scripts.evaluate(t)
    saved = kr.winter_eval
    kr.winter_eval = kr.winter_eval_plain
    try:
        p = app.scripts.evaluate(t)
    finally:
        kr.winter_eval = saved
    return all(np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
               for a, b in zip(k, p)), len(k)


def client_phase(device="cuda", sync=torch.cuda.synchronize, frames=CLIENT_FRAMES, **size):
    """``frames`` benchworld.client_tick frames of the client world (see
    ``benchworld.client_world``): the player walks, enters car 0 at frame
    90 and drives it.  Checks: every body of the world finite except
    dynamic bodies thrown (above 50 m or below -0.5 m at some frame: the
    trimesh sign rule, reported as phase 13 reports it), no unthrown
    dynamic body below z = -0.5, the character finite while walking, car 0
    moved while driven, the audio finite, within [-1, 1], not silent and
    not mono, KAA's two entry points launched 3 times a frame and KAB's
    two once a frame (one vehicle update a frame), KE-KG 3 times, KJ and
    KR once, KH, KL and the step's kernels as their paths need, the Winter
    results equal to KR's twin at the last frame, every Lua counter
    finite.  Reports ms per frame (frames 31-``frames``), phase_ms, the
    syncs and copies of a driving and of a walking frame, and the build."""
    import tempfile
    from substrata_tpu_torch import benchworld as bw
    from substrata_tpu_torch import kernels
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="client_world_") as sounds:
        sc = bw.client_world(device, sound_dir=sounds, **size)
        app = sc.app
        app.physics_world._flush()
        sync()
        build_s = time.perf_counter() - t0
        pw = app.physics_world
        car = app.objects[sc.car_uids[0]]
        sync()
        kernels.reset_launch_counts()
        times, phases, outs, zs = [], [], [], []
        car0 = None
        compares, extra = {}, {}
        for f in range(frames):
            sync()
            t1 = time.perf_counter()
            out = bw.client_tick(sc, f)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
            phases.append(dict(app.phase_ms))
            outs.append(out)
            zs.append(pw.state.pos[:, 2].clone())
            if f < sc.drive_from:
                check(np.isfinite(app.player.get_eye_position()).all(),
                      f"frame {f}: the character is not finite")
            if f == sc.drive_from:
                car0 = np.array(car.pos, np.float64)
            # Phase 18 on this world: KAA on its sources after 30 frames,
            # KAB on its vehicles while car 0 is driven (frame 120).  The
            # comparisons' own launches are taken out of the counts.
            if f in (30, 120):
                c0 = kernels.launch_counts()
                eng = app.audio
                if f == 30:
                    for hrtf in (True, False):
                        compares[f"client_audio_hrtf_{hrtf}"] = _kaa_compare(
                            eng.sources, eng.pool, eng.listener, 256, hrtf,
                            f"client world, HRTF {hrtf}")["audio_setup"]
                else:
                    compares.update({f"client_{k}": v for k, v in _kab_compare(
                        app.vehicles.veh, pw.state, "client world, car 0 driven").items()})
                for k, v in kernels.launch_counts().items():
                    extra[k] = extra.get(k, 0) + v - c0[k]
        counts = {k: v - extra.get(k, 0) for k, v in kernels.launch_counts().items()}
        driven = frames - sc.drive_from
        for name, want in (("audio_setup", 3 * frames), ("audio_epilogue", 3 * frames),
                           ("audio_fetch", 3 * frames), ("audio_spatialise", 3 * frames),
                           ("audio_downmix_reverb", 3 * frames), ("vehicle_setup", frames),
                           ("vehicle_scatter", frames), ("vehicle_forces", frames),
                           ("winter_eval", frames)):
            check(counts[name] == want, f"kernel {name}: {counts[name]} launches in {frames} "
                  f"client frames, expected {want}")
        check(counts["ray_trace"] >= 2 * frames, "KH: fewer than two launches a frame "
              "(the wheels' rays and the occlusion rays)")
        check(counts["character_update"] >= sc.drive_from, "KL: not launched every walking frame")
        for name in CLIENT_STEP_KERNELS:
            check(counts[name] >= frames, f"kernel {name}: {counts[name]} launches in {frames} "
                  "client frames")
        ok, n_scripted = _winter_alike(app, float(np.float32((frames - 1) * DT)))
        check(ok, "the Winter results differ from KR's twin at the last frame")
        st = pw.state
        z_all = torch.stack(zs)
        dyn = st.alive & (st.motion_type == 2)
        thrown = ((z_all > 50.0) | (z_all < -0.5)).any(dim=0) & dyn
        finite = (torch.isfinite(st.pos).all(dim=1) & torch.isfinite(st.quat).all(dim=1)
                  & torch.isfinite(st.linvel).all(dim=1))
        check(bool((finite | thrown | ~st.alive).all()), "a body that was never thrown has a "
              "non-finite state")
        check(not bool((dyn & ~thrown & (st.pos[:, 2] < -0.5)).any()),
              "an unthrown dynamic body below z = -0.5")
        moved = float(np.linalg.norm(np.array(car.pos, np.float64) - car0))
        check(moved > 2.0, f"car 0 moved {moved} m while driven")
        rms, lr = out_checks(torch.as_tensor(np.concatenate(outs)))
        lua = [(float(ev.interp.globals.get("touches")), float(ev.interp.globals.get(
            "timer_fires"))) for ev in app.script_vm.lua_evaluators]
        check(len(lua) == len(sc.lua_uids) and all(np.isfinite(x).all() for x in lua),
              "a Lua counter is not a finite number")
        median_phase = {k: float(np.median([p.get(k, 0.0) for p in phases[30:]]))
                        for k in phases[-1]}

        # Syncs and copies: driving frames, then walking frames (the player
        # leaves the car; the frame numbers run on, the input is the walk).
        state = dict(f=frames)

        def frame():
            bw.client_tick(sc, state["f"])
            state["f"] += 1
        driving = _counted(frame, SYNC_TICKS)
        app.exit_vehicle()
        sc.drive_from = 1 << 30
        walking = _counted(frame, SYNC_TICKS)
        d = pw.last_diags
        zd = torch.where(finite & dyn, st.pos[:, 2], torch.nan)[dyn]
        res = dict(
            ms_per_client_frame_median=float(np.median(times[30:])),
            ms_per_client_frame_p90=float(np.percentile(times[30:], 90)),
            first_frame_ms=times[0], build_s=build_s, phase_ms_median=median_phase,
            launches=counts, driving=driving, walking=walking,
            objects=len(app.objects), bodies=int(st.alive.sum()), triangles=pw.static_world.n_tris,
            sources=len(sc.source_uids), vehicles=len(app.vehicle_controllers),
            winter_objects=n_scripted, path_controllers=len(app.path_controllers),
            lua_objects=len(lua), lua_counters=lua, car0_moved_m=moved,
            audio_rms=rms, audio_lr_max=lr, pairs=int(d.num_pairs), contacts=int(d.num_contacts),
            awake=int(d.num_awake), dynamic_thrown=int(thrown.sum()),
            dynamic_not_finite=int((dyn & ~finite).sum()),
            first_frame_thrown=int(((z_all > 50.0) | (z_all < -0.5))[:, dyn].any(dim=1)
                                   .nonzero()[0]) if bool(thrown.any()) else None,
            dynamic_z_median=float(zd.nanmedian()),
            player_eye=[float(x) for x in app.player.get_eye_position()],
            setup_compares=compares)
    return res


def _kicked(frames, statics=None):
    """Each dynamic object's first frame past KICK_SPEED or, with
    ``statics``, within 2.5 m (across and up) of a static cube's centre
    (len(frames) if never)."""
    hit = []
    for pos, speed in frames:
        near = False
        if statics is not None:
            d = np.abs(pos[:, None, :] - statics[None])
            near = ((np.maximum(d[..., 0], d[..., 1]) < 2.5) & (d[..., 2] < 2.5)).any(axis=1)
        hit.append(near | (speed > KICK_SPEED))
    hit = np.array(hit)
    return np.where(hit.any(axis=0), hit.argmax(axis=0), len(frames))


def small_client_phase(device="cuda", frames=40):
    """A small client world (600 cubes of which 32 dynamic, 16 sources, 4
    vehicles, 16 Winter objects, 1 platform, 2 Lua objects) on the card
    and on the CPU path over ``frames`` frames, car 0 driven from frame 20:
    each dynamic object within 1e-4 m until it comes within reach of the
    static trimesh (2.5 m of a static cube) or past 20 m/s on either path
    (the trimesh sign rule's kicks), the undriven vehicles over frames
    0-24 (a bike bounces on its suspension and carries the paths' last-bit
    differences), the player and car 0 within 1e-4 m over all frames, the
    Lua counters equal and the audio within 5e-5
    (tests/test_torch_audio.py's bound) while every source's body is
    within 1e-3 m on the two paths."""
    import tempfile
    from substrata_tpu_torch import benchworld as bw
    from substrata_tpu_torch.physics.state import SimConfig
    size = dict(n_objects=600, n_dynamic=32, n_sources=16, n_vehicles=4, n_winter=16,
                n_platforms=1, n_lua=2)
    runs = {}
    for dev in (device, "cpu"):
        with tempfile.TemporaryDirectory(prefix="client_world_") as sounds:
            sc = bw.client_world(dev, cfg=SimConfig(
                capacity=512, max_pairs=2048, grid_dim=32, cell_size=4.0, solver_iters=7,
                pair_rebuild_interval=6), sound_dir=sounds, **size)
            sc.drive_from = 20
            app = sc.app
            dyn = [u for u, ob in app.objects.items() if ob.is_dynamic()]
            rec = []
            for f in range(frames):
                audio = bw.client_tick(sc, f)
                rec.append(dict(
                    pos=np.array([app.objects[u].pos for u in dyn], np.float64),
                    speed=np.array([np.linalg.norm(app.objects[u].linear_vel) for u in dyn]),
                    eye=np.array(app.player.get_eye_position(), np.float64),
                    car=np.array(app.objects[sc.car_uids[0]].pos, np.float64), audio=audio))
            runs[dev] = dict(rec=rec, undriven=np.array([u in sc.car_uids[1:] for u in dyn]),
                             source=np.array([app.objects[u].audio_source is not None
                                              for u in dyn]),
                             lua=[(ev.interp.globals.get("touches"),
                                   ev.interp.globals.get("timer_fires"))
                                  for ev in app.script_vm.lua_evaluators])
    a, b = runs[device], runs["cpu"]
    statics = bw.mesh_layout(size["n_objects"], size["n_dynamic"])[size["n_dynamic"]:]
    k = np.minimum(_kicked([(x["pos"], x["speed"]) for x in a["rec"]], statics),
                   _kicked([(x["pos"], x["speed"]) for x in b["rec"]], statics))
    k = np.where(a["undriven"], np.minimum(k, 25), k)
    pos_err = max(float(np.abs(x["pos"][k > f] - y["pos"][k > f]).max())
                  for f, (x, y) in enumerate(zip(a["rec"], b["rec"])))
    check(pos_err <= 1e-4, f"small client world: objects card vs CPU path {pos_err} > 1e-4")
    char_err = max(float(np.abs(x[key] - y[key]).max()) for x, y in zip(a["rec"], b["rec"])
                   for key in ("eye", "car"))
    check(char_err <= 1e-4, f"small client world: player or car 0 {char_err} > 1e-4")
    check(a["lua"] == b["lua"], "small client world: Lua counters differ")
    src = a["source"]
    apart = [float(np.abs(x["pos"][src] - y["pos"][src]).max()) > 1e-3
             for x, y in zip(a["rec"], b["rec"])]
    first = apart.index(True) if any(apart) else frames
    check(first >= min(20, frames), f"small client world: a source's body 1e-3 m apart at "
          f"frame {first}")
    audio_err = max([float(np.abs(x["audio"] - y["audio"]).max())
                     for x, y in zip(a["rec"][:first], b["rec"][:first])] or [0.0])
    check(audio_err <= 5e-5, f"small client world: audio {audio_err} > 5e-5")
    return dict(cuda_vs_cpu_small_client_object_err=pos_err,
                cuda_vs_cpu_small_client_player_car_err=char_err,
                cuda_vs_cpu_small_client_audio_err=audio_err, small_client_audio_frames=first,
                small_client_objects_held_all_frames=int((k == frames).sum()),
                small_client_dynamic=int(len(k)), small_client_lua=a["lua"])


PHYSICS_KERNELS = ("box_box_rows", "static_contacts", "solve_iteration", "apply_forces",
                   "integrate_positions", "cell_table", "solve_setup", "cache_refresh",
                   "find_pairs", "layout_incidence", "solve_positions", "strike_wake",
                   "sleep_pass")
AUDIO_KERNELS = ("audio_fetch", "audio_spatialise", "audio_downmix_reverb")
FULLTICK_KERNELS = ("ray_trace", "particles_update", "vehicle_forces")
# Launched on every serving tick and every mesh frame (the compacted layout).
LAYOUT_KERNELS = ("layout_group", "layout_touching", "layout_compact", "layout_incidence",
                  "solve_positions", "strike_wake", "sleep_pass")
SERVING_KERNELS = ("closed_form_rows", "character_update", "apply_tick_in",
                   "digest_tblock") + LAYOUT_KERNELS
# Launched on every client frame (phase 19): think over hulls, boxes and the
# trimesh, the transform writes, the digest.
CLIENT_STEP_KERNELS = ("convex_rows", "static_contacts", "cell_table", "solve_setup",
                       "cache_refresh", "solve_positions", "strike_wake", "sleep_pass",
                       "apply_tick_in", "digest_tblock")
MESH_KERNELS = ("convex_rows", "static_contacts", "ray_trace", "character_update",
                "apply_tick_in", "digest_tblock", "cell_table", "solve_setup",
                "cache_refresh") + LAYOUT_KERNELS
# Float32 operations per item, counted from the kernels' sources (rounded
# up): per valid pair slot (KA), per body (KB, KD), per contact row and per
# body table slot (KC).
FLOPS = {"box_box_rows": 1000, "static_contacts": 600, "solve_iteration": 60,
         "solve_bodies": 18, "apply_forces": 100, "integrate_positions": 60,
         # KH per gathered candidate, per survivor's shape test, per ray on
         # flat ground, per march or bisection step on a heightfield; KI per
         # particle; KJ per vehicle.
         "ray_candidate": 25, "ray_shape": 150, "ray_hf_flat": 10, "ray_hf_step": 40,
         "particles_update": 90, "vehicle_forces": 3000,
         # KK and KL per closed form evaluated (capsule-box: the 14-step
         # ternary search; the point contacts), KL per probe row (the
         # sphere test, the reductions), KM per region test.
         "capsule_box": 1700, "point_contact": 120, "char_row": 30, "region_test": 12,
         # KB and KL per sphere-triangle test (closest point, sign, normal),
         # KH per ray-triangle test (Moller-Trumbore).
         "tri_test": 150, "ray_triangle": 40,
         # KP per body (the cell, the hash, the flags); KQ per contact row
         # (tangent basis, three directions' r x d, Iw (r x d) and masses,
         # the target, the warm probe).
         "cell_table": 20, "solve_setup": 400,
         # KS per stencil candidate (distance, radii, tests, score) and per
         # oversize row; KU per contact row and per table slot, each of its
         # two iterations; KV per body (speeds, its table slots' tests).
         "pair_candidate": 20, "position_row": 12, "position_slot": 6, "sleep_body": 100,
         # KAA per source (distance, Doppler, gains, pan, the HRIR bins'
         # two atan2; the epilogue's compare and fma), KAB per vehicle (the
         # matrix, inertia, five rotations) and per body written.
         "audio_setup": 150, "audio_epilogue": 6, "vehicle_setup": 330, "vehicle_scatter": 6}

KERNELS = [
    ("box_box_rows", "cuda", "substrata_tpu_torch/csrc/box_box.cu",
     "substrata_tpu/physics/narrowphase.py:631"),
    ("static_contacts", "cuda", "substrata_tpu_torch/csrc/static_contacts.cu",
     "substrata_tpu/physics/narrowphase.py:911"),
    ("solve_iteration", "cuda", "substrata_tpu_torch/csrc/solve_contacts.cu",
     "substrata_tpu/physics/solver.py:156"),
    ("apply_forces", "triton", "substrata_tpu_torch/kernels/integrate_triton.py",
     "substrata_tpu/physics/integrate.py:38"),
    ("integrate_positions", "triton", "substrata_tpu_torch/kernels/integrate_triton.py",
     "substrata_tpu/physics/integrate.py:93"),
    ("audio_fetch", "cuda", "substrata_tpu_torch/csrc/audio_mix.cu",
     "substrata_tpu/audio/mix.py:201"),
    ("audio_spatialise", "cuda", "substrata_tpu_torch/csrc/audio_mix.cu",
     "substrata_tpu/audio/mix.py:350"),
    ("audio_downmix_reverb", "cuda", "substrata_tpu_torch/csrc/audio_mix.cu",
     "substrata_tpu/audio/mix.py:404"),
    ("ray_trace", "cuda", "substrata_tpu_torch/csrc/ray_trace.cu",
     "substrata_tpu/physics/queries.py:243"),
    ("particles_update", "triton", "substrata_tpu_torch/kernels/particles_triton.py",
     "substrata_tpu/physics/particles.py:80"),
    ("vehicle_forces", "cuda", "substrata_tpu_torch/csrc/vehicles.cu",
     "substrata_tpu/physics/vehicles/manager.py:298"),
    ("closed_form_rows", "cuda", "substrata_tpu_torch/csrc/closed_forms.cu",
     "substrata_tpu/physics/narrowphase.py:564"),
    ("character_update", "cuda", "substrata_tpu_torch/csrc/character.cu",
     "substrata_tpu/physics/character.py:264"),
    ("apply_tick_in", "cuda", "substrata_tpu_torch/csrc/serving_io.cu",
     "substrata_tpu/physics/world.py:305"),
    ("digest_tblock", "cuda", "substrata_tpu_torch/csrc/serving_io.cu",
     "substrata_tpu/physics/world.py:258"),
    ("convex_rows", "cuda", "substrata_tpu_torch/csrc/convex.cu",
     "substrata_tpu/physics/narrowphase.py:404"),
    ("cell_table", "cuda", "substrata_tpu_torch/csrc/cell_table.cu",
     "substrata_tpu/physics/broadphase.py:70"),
    ("solve_setup", "cuda", "substrata_tpu_torch/csrc/solve_setup.cu",
     "substrata_tpu/physics/solver.py:156"),
    ("cache_refresh", "cuda", "substrata_tpu_torch/csrc/solve_setup.cu",
     "substrata_tpu/physics/solver.py:471"),
    ("winter_eval", "cuda", "substrata_tpu_torch/csrc/winter.cu",
     "substrata_tpu/scripting/winter.py:820"),
    ("find_pairs", "cuda", "substrata_tpu_torch/csrc/pairs.cu",
     "substrata_tpu/physics/broadphase.py:115"),
    ("layout_group", "cuda", "substrata_tpu_torch/csrc/layout.cu",
     "substrata_tpu/physics/narrowphase.py:683"),
    ("layout_touching", "cuda", "substrata_tpu_torch/csrc/layout.cu",
     "substrata_tpu/physics/narrowphase.py:793"),
    ("layout_compact", "cuda", "substrata_tpu_torch/csrc/layout.cu",
     "substrata_tpu/physics/narrowphase.py:1054"),
    ("layout_incidence", "cuda", "substrata_tpu_torch/csrc/layout.cu",
     "substrata_tpu/physics/solver.py:96"),
    ("solve_positions", "cuda", "substrata_tpu_torch/csrc/positions.cu",
     "substrata_tpu/physics/solver.py:477"),
    ("strike_wake", "cuda", "substrata_tpu_torch/csrc/sleep.cu",
     "substrata_tpu/physics/step.py:103"),
    ("sleep_pass", "cuda", "substrata_tpu_torch/csrc/sleep.cu",
     "substrata_tpu/physics/integrate.py:103"),
    ("terrain_heights", "cuda", "substrata_tpu_torch/csrc/terrain.cu",
     "substrata_tpu/physics/terrain.py:40"),
    ("terrain_chunks", "cuda", "substrata_tpu_torch/csrc/terrain.cu",
     "substrata_tpu/physics/terrain.py:54"),
    ("terrain_scatter", "cuda", "substrata_tpu_torch/csrc/terrain.cu",
     "substrata_tpu/physics/terrain.py:215"),
    ("spawn_rows", "cuda", "substrata_tpu_torch/csrc/particles_spawn.cu",
     "substrata_tpu/physics/particles.py:140"),
    ("pose_avatars", "cuda", "substrata_tpu_torch/csrc/pose.cu",
     "substrata_tpu/anim/pose.py:182"),
    ("audio_setup", "cuda", "substrata_tpu_torch/csrc/audio_setup.cu",
     "substrata_tpu/audio/mix.py:294"),
    ("audio_epilogue", "cuda", "substrata_tpu_torch/csrc/audio_setup.cu",
     "substrata_tpu/audio/mix.py:434"),
    ("vehicle_setup", "cuda", "substrata_tpu_torch/csrc/vehicle_setup.cu",
     "substrata_tpu/physics/vehicles/manager.py:609"),
    ("vehicle_scatter", "cuda", "substrata_tpu_torch/csrc/vehicle_setup.cu",
     "substrata_tpu/physics/vehicles/manager.py:664"),
]
# The run whose launches each kernel line reports: phase 9's full ticks,
# unless named here (phase 5's thinks, 11's serving ticks, 13's mesh
# frames, 17's terrain frames, 19's client frames).
LAUNCHES_FROM = {"closed_form_rows": "serving", "character_update": "serving",
                 "apply_tick_in": "serving", "digest_tblock": "serving", "convex_rows": "mesh",
                 "find_pairs": "think", "solve_positions": "think", "strike_wake": "think",
                 "sleep_pass": "think", "layout_group": "serving", "layout_touching": "serving",
                 "layout_compact": "serving", "layout_incidence": "serving",
                 "terrain_heights": "terrain", "terrain_chunks": "terrain",
                 "terrain_scatter": "terrain", "spawn_rows": "terrain",
                 "pose_avatars": "terrain", "audio_setup": "client",
                 "audio_epilogue": "client", "vehicle_setup": "client",
                 "vehicle_scatter": "client"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import triton
    from substrata_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} triton {triton.__version__} | "
        f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log(f"# build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)")

    from substrata_tpu_torch.benchworld import bench_world
    t0 = time.perf_counter()
    w = bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    torch.cuda.synchronize()
    log(f"# bench world: {len(w.objects)} boxes, 30 ticks in {time.perf_counter() - t0:.1f} s "
        f"| {w.get_diagnostics()}")
    kres = kernel_phase(w)
    for name, r in kres.items():
        log(f"# kernel {name}: {json.dumps(r)} | {smi}")
    del w

    small = small_world_phase()
    log(f"# small worlds: {json.dumps(small)} | {smi}")

    main_res = main_path_phase()
    log(f"# main path: {json.dumps(main_res)} | {smi}")
    log(f"# ms per think (median, ticks 31-{TICKS}, 10,000 boxes): "
        f"{main_res['ms_per_think_median']:.3f} | {smi}")

    w = bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    ares = audio_kernel_phase(w)
    del w
    for name, r in ares.items():
        log(f"# audio {name}: {json.dumps(r)} | {smi}")
    kres.update({k: v for k, v in ares.items() if k in AUDIO_KERNELS})

    pa_res = physics_audio_phase()
    pa_res.update(small_coupled_phase())
    log(f"# physics+audio: {json.dumps(pa_res)} | {smi}")
    log(f"# ms per physics+audio tick (median, ticks 31-{TICKS}, 10,000 boxes, 256 sources): "
        f"{pa_res['ms_per_tick_median']:.3f} (p90 {pa_res['ms_per_tick_p90']:.3f}); "
        f"ms per think alone (phase 5): {main_res['ms_per_think_median']:.3f} | {smi}")

    fres = fulltick_kernel_phase()
    for name, r in fres.items():
        log(f"# kernel {name}: {json.dumps(r)} | {smi}")
    # KH's line carries the particles' shape (2,048 of its rays per tick;
    # the wheels' 32 are in chip_smoke.json); no single PyTorch call
    # computes KH, KI or KJ, so library_ms is null.
    kres["ray_trace"] = dict(fres["ray_trace_particles"], max_abs_err=max(
        fres["ray_trace_particles"]["max_abs_err"], fres["ray_trace_wheels"]["max_abs_err"]))
    kres.update({k: v for k, v in fres.items() if k in FULLTICK_KERNELS})

    ft_res = full_tick_phase()
    ft_res.update(small_fulltick_phase())
    log(f"# full tick: {json.dumps(ft_res)} | {smi}")
    log(f"# ms per full tick (median, ticks 31-{TICKS}, 10,000 boxes, 256 sources, "
        f"2,048 particles, 8 vehicles): {ft_res['ms_per_tick_median']:.3f} "
        f"(p90 {ft_res['ms_per_tick_p90']:.3f}); physics + audio tick (phase 7): "
        f"{pa_res['ms_per_tick_median']:.3f} | {smi}")

    sres = serving_kernel_phase()
    for name, r in sres.items():
        log(f"# kernel {name}: {json.dumps(r)} | {smi}")
    kres.update(sres)

    sv_res = serving_phase()
    sv_res.update(small_serving_phase())
    log(f"# serving tick: {json.dumps(sv_res)} | {smi}")
    log(f"# ms per serving tick (median, ticks 31-{TICKS}, 10,000 boxes + the walking player): "
        f"{sv_res['ms_per_serving_tick_median']:.3f} (p90 {sv_res['ms_per_serving_tick_p90']:.3f});"
        f" full tick with the character (phase 9): {ft_res['ms_per_tick_median']:.3f}; think "
        f"(phase 5): {main_res['ms_per_think_median']:.3f} | {smi}")

    mk_res = mesh_kernel_phase()
    for name, r in mk_res.items():
        log(f"# kernel {name}: {json.dumps(r)} | {smi}")
    kres["convex_rows"] = mk_res["convex_rows"]

    me_res = mesh_phase()
    me_res.update(small_mesh_phase())
    log(f"# mesh world: {json.dumps(me_res)} | {smi}")
    log(f"# ms per mesh-world client frame (median, ticks 31-{TICKS}, 12,000 objects: 512 hulls "
        f"over {me_res['triangles']} static triangles, think_with_player + "
        f"{N_DYNAMIC_RAYS} occlusion rays): {me_res['ms_per_mesh_tick_median']:.3f} "
        f"(p90 {me_res['ms_per_mesh_tick_p90']:.3f}); serving tick (phase 11): "
        f"{sv_res['ms_per_serving_tick_median']:.3f} | {smi}")

    kpqr = kpqr_phase()
    for name, r in kpqr.items():
        log(f"# kernel {name}: {json.dumps(r)} | {smi}")
    kres.update(kpqr)

    lay = layout_phase()
    for name, r in lay.items():
        log(f"# phase 15 {name}: {json.dumps(r)} | {smi}")
    kres.update({k: v for k, v in lay.items() if k != "sort_free"})

    tk = terrain_kernel_phase()
    for name, r in tk.items():
        log(f"# phase 16 {name}: {json.dumps(r)} | {smi}")
    kres.update(tk)

    te_res = terrain_phase()
    te_res.update(small_terrain_phase())
    log(f"# terrain world: {json.dumps(te_res)} | {smi}")
    log(f"# ms per terrain client frame (median, ticks 31-{TICKS}, BASELINE config 4: a "
        f"1025^2 heightmap, ~10,000 particles, {te_res['bodies'] - 1} trees, 64 posed "
        f"avatars): {te_res['ms_per_terrain_tick_median']:.3f} "
        f"(p90 {te_res['ms_per_terrain_tick_p90']:.3f}) | {smi}")

    su = setup_kernel_phase()
    for name, r in su.items():
        log(f"# phase 18 {name}: {json.dumps(r)} | {smi}")
    kres.update({k: v for k, v in su.items() if k in CLIENT_KERNELS})

    cl_res = client_phase()
    su["client_world"] = cl_res.pop("setup_compares")
    log(f"# phase 18 client_world: {json.dumps(su['client_world'])} | {smi}")
    cl_res.update(small_client_phase())
    log(f"# client frame: {json.dumps(cl_res)} | {smi}")
    log(f"# ms per client frame (median, frames 31-{CLIENT_FRAMES}, BASELINE config 5's "
        f"12,000 objects, {cl_res['sources']} sources, {cl_res['vehicles']} vehicles, "
        f"{cl_res['winter_objects']} Winter objects, {cl_res['path_controllers']} platforms, "
        f"{cl_res['lua_objects']} Lua objects): {cl_res['ms_per_client_frame_median']:.3f} "
        f"(p90 {cl_res['ms_per_client_frame_p90']:.3f}); build {cl_res['build_s']:.1f} s | {smi}")

    # Launches: each kernel's count on its main path (LAUNCHES_FROM).
    runs = dict(think=main_res, full=ft_res, serving=sv_res, mesh=me_res, terrain=te_res,
                client=cl_res)
    launches = {name: runs[LAUNCHES_FROM.get(name, "full")]["launches"][name]
                for name, *_ in KERNELS}
    for name in ("find_pairs", "solve_positions", "strike_wake", "sleep_pass"):
        for run in ("think", "serving", "mesh"):
            check(runs[run]["launches"][name] > 0, f"kernel {name} never launched ({run})")
    out = {"kernels": [
        dict(name=name, route=route, source=src, replaces=rep,
             launches=launches[name], max_abs_err=kres[name]["max_abs_err"],
             ms=kres[name]["ms"], plain_ms=kres[name]["plain_ms"],
             bound_ms=kres[name]["bound_ms"], bound_by=kres[name]["bound_by"],
             library_ms=kres[name].get("library_ms"))
        for name, route, src, rep in KERNELS]}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, torch=torch.__version__, kernels=kres,
                       small_worlds=small, main_path=main_res, audio=ares,
                       physics_audio=pa_res, fulltick_kernels=fres, full_tick=ft_res,
                       serving_kernels=sres, serving_tick=sv_res, mesh_kernels=mk_res,
                       mesh_world=me_res, kpqr_kernels=kpqr, layout_kernels=lay,
                       terrain_kernels=tk, terrain_world=te_res, setup_kernels=su,
                       client_frame=cl_res),
                  f, indent=1)
    log(json.dumps(out))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

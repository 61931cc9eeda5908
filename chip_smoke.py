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
5. main path: the bench world through PhysicsWorld(cfg, device="cuda"),
   180 think(1/60) calls with a seeded velocity kick (bench.py's churn)
   before ticks 31, 61, 91, 121 and 151; the invariants hold, every
   kernel's launch counter grew, and six more thinks make one
   synchronizing call each (the digest read).

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  TF32 stays off for matmuls and cuDNN
(the solver's small products must run in full float32).
"""

import json
import os
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


def max_err(x, y, mask=None):
    d = (x.float() - y.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


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
    results["apply_forces"] = dict(
        max_abs_err=err, tol=1e-6,
        ms=median_ms(lambda: kd.apply_forces(body, DT, w.params)),
        plain_ms=median_ms(lambda: kd.apply_forces_plain(body, DT, w.params)))
    pos_k, q_k = kd.integrate_positions(body, lin_p, ang_p, DT)
    pos_p, q_p = kd.integrate_positions_plain(body, lin_p, ang_p, DT)
    err = max(max_err(pos_k, pos_p), max_err(q_k, q_p))
    check(err <= 1e-6, f"KD integrate_positions: max abs err {err} > 1e-6")
    results["integrate_positions"] = dict(
        max_abs_err=err, tol=1e-6,
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
        valid_rows=int(rp[5].sum()), near_threshold_pairs=int(near.sum()),
        ms=median_ms(lambda: ka.box_box_rows(*args)),
        plain_ms=median_ms(lambda: ka.box_box_rows_plain(*args)))

    # KB: ground contacts.  Rows are compared per body by sample key (the
    # top-K order of equal depths is the kernel's own tie rule, checked in
    # the CPU tests); bodies with a sample within 1e-5 of the margin or of
    # the K-th/(K+1)-th cut are exempt from mask equality (reported).
    hf, has_hf = w.static_world.heightfield, w.static_world.has_heightfield
    k = min(cfg.static_contacts_per_body, 8)
    present = cfg.present_shape_types
    sk = kb.static_contacts(body, hf, has_hf, k, present)
    sp = kb.static_contacts_plain(body, hf, has_hf, k, present)
    n = body.capacity
    check(torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1]), "KB: a/b differ")
    pts, rad, slot_ok = kb.shape_sample_points(body, present)
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
    results["static_contacts"] = dict(
        max_abs_err=err, tol=1e-5, valid_rows=int(sp[5].sum()),
        near_threshold_bodies=int(near_b.sum()),
        ms=median_ms(lambda: kb.static_contacts(body, hf, has_hf, k, present)),
        plain_ms=median_ms(lambda: kb.static_contacts_plain(body, hf, has_hf, k, present)))

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
    results["solve_iteration"] = dict(
        max_abs_err=err, tol=1e-4, static_rows=int(setup.rows.s_valid.sum()),
        pair_rows=int(setup.rows.p_valid.sum()),
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
    for name, c in counts.items():
        check(c > 0, f"kernel {name} never launched on the main path")
    ev = w.last_events
    return dict(
        ms_per_think_median=float(np.median(times[30:])),
        ms_per_think_p90=float(np.percentile(times[30:], 90)),
        first_think_ms=times[0], pairs=pairs, contacts=contacts,
        awake=int(d.num_awake), max_penetration=float(d.max_penetration),
        broadphase_overflow=int(ev.broadphase_overflow), min_z=min_z,
        bodies=len(w.objects), launches=counts,
        syncs_per_think=len(syncs) / SYNC_TICKS)


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
]


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

    out = {"kernels": [
        dict(name=name, route=route, source=src, replaces=rep,
             launches=main_res["launches"][name], max_abs_err=kres[name]["max_abs_err"],
             ms=kres[name]["ms"], plain_ms=kres[name]["plain_ms"])
        for name, route, src, rep in KERNELS]}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, torch=torch.__version__, kernels=kres,
                       small_worlds=small, main_path=main_res), f, indent=1)
    log(json.dumps(out))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

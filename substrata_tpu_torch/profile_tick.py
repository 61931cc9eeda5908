"""Where the time of one think() goes, on the card.

    python3 -m substrata_tpu_torch.profile_tick

On the 10,000-box bench world (kicked once, after 30 ticks):
1. host-clock ms per think, rebuild and reuse ticks apart;
2. one torch.profiler pass: device busy time per tick (sum of kernel
   times), kernel launches per tick, the top kernels;
3. a stage pass: each stage of physics_step wrapped with a synchronize on
   both sides, so its host time (launching + waiting) and device time
   (CUDA events) are its own.  The syncs remove overlap, so these are for
   attribution, not for the tick total.
Prints one JSON object and writes the trace to chiprun_out/tick_trace.json.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

from substrata_tpu_torch.benchworld import bench_world, kick
from substrata_tpu_torch.physics import broadphase, integrate, narrowphase, solver
from substrata_tpu_torch.physics import world as world_mod

DT = 1.0 / 60.0
STAGES = [(integrate, "apply_forces"), (broadphase, "find_pairs_cached"),
          (narrowphase, "pair_contacts"), (narrowphase, "static_contacts"),
          (solver, "build_incidence"), (solver, "prepare_solve"), (solver, "iterate"),
          (integrate, "integrate_positions"), (solver, "solve_positions"),
          (integrate, "update_sleeping"), (world_mod, "_event_digest")]
# Device-side names of the hand-written kernels (KA, KB, KC x2, KD x2).
PORT_KERNELS = ("box_box_rows_kernel", "static_contacts_kernel", "solve_rows_kernel",
                "solve_bodies_kernel", "apply_forces_kernel", "integrate_kernel")


def _timed(fn, name, acc):
    @functools.wraps(fn)
    def run(*a, **k):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn(*a, **k)
        e1.record()
        torch.cuda.synchronize()
        rec = acc.setdefault(name, [0.0, 0.0, 0])
        rec[0] += (time.perf_counter() - t0) * 1e3
        rec[1] += e0.elapsed_time(e1)
        rec[2] += 1
        return out
    return run


def main(ticks: int = 24):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    w = bench_world("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for t in range(60):
        if t == 30:
            w.set_state(kick(w.state, gen))
        w.think(DT)
    torch.cuda.synchronize()

    rebuild, reuse = [], []
    for _ in range(2 * ticks):
        is_rebuild = w._force_pair_rebuild or w._host_steps_left <= 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.think(DT)
        torch.cuda.synchronize()
        (rebuild if is_rebuild else reuse).append((time.perf_counter() - t0) * 1e3)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            w.think(DT)
        torch.cuda.synchronize()
    # Device-side events (kernels, copies, fills) run one at a time on the
    # stream, so their durations sum to the busy time.
    dev_evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_evs)
    by_name: dict = {}
    for e in dev_evs:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = {k: v for k, v in by_name.items() if any(p in k for p in PORT_KERNELS)}
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "tick_trace.json"))

    acc: dict = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name in STAGES]
    for mod, name, fn in saved:
        setattr(mod, name, _timed(fn, name, acc))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        w.think(DT)
    torch.cuda.synchronize()
    staged_ms = (time.perf_counter() - t0) * 1e3 / ticks
    for mod, name, fn in saved:
        setattr(mod, name, fn)

    out = dict(
        card=smi, bodies=len(w.objects),
        ms_per_think_rebuild=float(np.median(rebuild)), rebuild_ticks=len(rebuild),
        ms_per_think_reuse=float(np.median(reuse)), reuse_ticks=len(reuse),
        device_busy_ms_per_tick=busy_us / 1e3 / ticks,
        device_ops_per_tick=len(dev_evs) / ticks,
        top_kernels=[dict(name=name[:90], ms_per_tick=us / 1e3 / ticks,
                          calls_per_tick=n / ticks) for name, (us, n) in top],
        port_kernels={name[:60]: dict(ms_per_tick=us / 1e3 / ticks, us_per_launch=us / n,
                                      calls_per_tick=n / ticks)
                      for name, (us, n) in ours.items()},
        staged_ms_per_think=staged_ms,
        stages={name: dict(host_ms_per_tick=v[0] / ticks, device_ms_per_tick=v[1] / ticks,
                           calls_per_tick=v[2] / ticks) for name, v in acc.items()})
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""KP's cell table and KT's grouping on the card, for the port found under
``--root`` (default: this checkout).

For each wrapper: ms per call (CUDA events around back-to-back calls,
``chip_smoke.median_ms``), device µs per call (torch.profiler, summed over
the call's kernels) and the host's cost per call (``chip_smoke.host_cost``:
perf_counter over 200 calls without a synchronise, and the profiler's CPU
time), at four shapes: KP on the 10,000-box bench world after 30 thinks
and on the capacity tier's 65,536 bodies over grid 160; KT's grouping on
the serving world after 60 ticks and on 49,152 pairs.  Then the ticks that
run them, as chip_smoke.py's phases 5, 9 and 11 time them: the median ms
per think, full tick and serving tick.  ``--root`` may be an
unpacked earlier commit, so that its wrappers and this checkout's are
timed in one call on one card (run parent, change, change, parent):

    python3 substrata_tpu_torch/bench_sorts.py [--root DIR] [--tag NAME]

The helpers and the hard inputs come from this checkout; the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_sorts_<tag>.json.
"""

from __future__ import annotations

import sys

import bench_driver as bd

DT = bd.DT


def _timed(cs, run, prefix):
    return dict(ms=cs.median_ms(run), device_us=cs.device_us_call(run, prefix),
                **cs.host_cost(run))


def main():
    args, cs = bd.start("bench_sorts")
    root = args.root
    import numpy as np
    import torch
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import cell_table as kp
    from substrata_tpu_torch.kernels import layout as kt
    from substrata_tpu_torch.maths import fp
    from substrata_tpu_torch.physics import narrowphase
    bd.check_root(kp, root)
    hc = bd.hard_cases()
    build.build()
    build.library()
    out = dict(tag=args.tag, root=root, nvidia_smi=cs.nvidia_smi_line(),
               device=torch.cuda.get_device_name(0))

    def kp_entry(a, grid, cap):
        kw = dict(num_buckets=grid * grid, cap=cap, rcp_cell=fp.recip(1.4), cell_size=1.4,
                  with_flags=True)
        got, want = kp.cell_table(*a, **kw), kp.cell_table_plain(*a, **kw)
        cs.check(all(torch.equal(x, y) for x, y in zip(got, want)), "KP differs from its twin")
        return dict(bodies=a[0].shape[0], buckets=grid * grid,
                    **_timed(cs, lambda: kp.cell_table(*a, **kw), "cell_"))

    def kt_entry(gargs):
        gk, ovk, _ = kt.group(*gargs)
        gp, ovp, _ = kt.group_plain(*gargs)
        cs.check(int(ovk) == int(ovp) and all(
            torch.equal(x, y) for (_, *tk), (_, *tp) in zip(gk, gp) for x, y in zip(tk, tp)),
            "KT's grouping differs from its twin")
        st, pa, pb, pv = gargs[:4]
        codes = torch.where(pv, torch.clamp(st[torch.clamp(pa, min=0).long()] * 4
                                            + st[torch.clamp(pb, min=0).long()], 0, 15), 16)
        return dict(pairs=pa.shape[0], **_timed(cs, lambda: kt.group(*gargs), "layout_group"),
                    library_ms=cs.median_ms(lambda: torch.argsort(codes, stable=True)))

    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    s, cfg = w.state, w.config
    out["kp_bench"] = kp_entry((s.pos, s.alive, s.collidable, s.awake, s.motion_type,
                                s.bound_radius), cfg.grid_dim, cfg.cell_capacity)
    del w
    f = hc.cell_bodies("lattice", 65_536, 160, 6, seed=1)
    out["kp_capacity"] = kp_entry(tuple(torch.as_tensor(f[k], device="cuda") for k in (
        "pos", "alive", "collidable", "awake", "motion_type", "bound_radius")), 160, 6)

    sw, player = benchworld.serving_world("cuda")
    for t in range(60):
        benchworld.serving_tick(sw, player, t * DT)
    pc, cfg = sw.pair_cache, sw.config
    out["kt_serving"] = kt_entry((sw.state.shape_type, pc.pair_a, pc.pair_b, pc.pair_valid,
                                  narrowphase._active_codes(cfg), cfg.max_pairs))
    del sw, player
    st = np.random.default_rng(0).integers(0, 3, 10_240).astype(np.int32)
    pairs = hc.group_pairs("over_cap_clamped", st, 49_152, 49_152, seed=4)
    out["kt_capacity"] = kt_entry((torch.as_tensor(st, device="cuda"),)
                                  + tuple(torch.as_tensor(x, device="cuda") for x in pairs)
                                  + ([0, 1, 2, 4, 5, 6, 8, 9, 10], 49_152))
    out["ms_per_think"] = cs.main_path_phase()["ms_per_think_median"]
    out["ms_per_full_tick"] = cs.full_tick_phase()["ms_per_tick_median"]
    out["ms_per_serving_tick"] = cs.serving_phase()["ms_per_serving_tick_median"]
    return bd.finish("bench_sorts", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

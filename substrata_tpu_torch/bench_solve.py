#!/usr/bin/env python3
"""The contact solve on the card (KQ's setup and KC), for the port found
under ``--root`` (default: this checkout).

On the bench world after 30 ticks (chip_smoke phase 3's), the serving world
and the mesh world after 60 of their ticks (phase 14's), from the solve's
inputs as ``physics_step`` forms them (``chip_smoke._solve_inputs``):

- KQ's setup (``solve_setup``), after its rows are held against the twin
  (``chip_smoke._rows_compare``: within 1e-6 of each output's scale, masks,
  slots and table entries exact);
- one KC call (``solve_iteration``, one pass: its two launches, each also
  apart);
- the whole solve as the step runs it: ``prepare_solve`` (KQ) and
  ``iterate`` (the warm pass and the 7 iterations), with its final
  velocities held within 1e-4 of the twin's; its host cost less KQ's is the
  solve's own.

For each: ms per call (CUDA events around back-to-back calls,
``chip_smoke.median_ms``), device µs per call (torch.profiler,
``chip_smoke.device_us_call``; per launch ``chip_smoke.device_us``) and the
host's cost per call (``chip_smoke.host_cost``: perf_counter over 200 calls
without a synchronise, and the profiler's CPU time).  Then the think tick
(phase 5) and the serving tick (phase 11), unless ``--no-ticks``.
``--root`` may be an unpacked earlier commit, so that its wrappers and this
checkout's are timed in one call on one card (run parent, change, change,
parent):

    python3 substrata_tpu_torch/bench_solve.py [--root DIR] [--tag NAME] [--no-ticks]

The helpers come from this checkout, the port from ``--root``.  Prints one
JSON line, with the card's name and power limit, and writes it to
chiprun_out/bench_solve_<tag>.json.
"""

from __future__ import annotations

import sys

import bench_driver as bd

DT = bd.DT


def main():
    args, cs = bd.start("bench_solve", flags=("--no-ticks",))
    root = args.root
    import torch
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import solve as kc
    from substrata_tpu_torch.kernels import solve_setup as kq
    from substrata_tpu_torch.physics import solver
    bd.check_root(kc, root)
    build.build()
    build.library()
    out = dict(tag=args.tag, root=root, nvidia_smi=cs.nvidia_smi_line(),
               device=torch.cuda.get_device_name(0))

    def timed(run, prefix):
        return dict(ms=cs.median_ms(run), device_us=cs.device_us_call(run, prefix),
                    **cs.host_cost(run))

    def entry(w, what):
        body, static_cts, pair_cts, table, sign, wm = cs._solve_inputs(w)
        cfg, p, cache = w.config, w.params, w.solver_cache
        args_ = (body, static_cts, pair_cts, table, sign)
        dt_t = torch.full((), DT, dtype=torch.float32, device=body.device)
        rk, ysk, ypk, _ = kq.solve_setup(*args_, p, DT, cache.data, wm)
        rp = kq.solve_setup_plain(*args_, p.baumgarte, p.restitution_threshold, dt_t,
                                  cache.data, wm)[0]
        rows_err = cs._rows_compare(rk, rp, what)
        st0 = kc.SolveState(ysk, ysk, ypk, ypk)

        def prepare():
            return solver.prepare_solve(body, static_cts, pair_cts, DT, p, cfg, cache, wm=wm,
                                        table=table, sign=sign)

        def whole():
            return solver.iterate(prepare(), body.linvel, body.angvel, cfg.solver_iters)

        def one_pass():
            return kc.solve_iteration(rk, st0, body.linvel, body.angvel, 0.5)

        _, lk, ak = whole()
        _, lp, ap = solver.iterate(prepare(), body.linvel, body.angvel, cfg.solver_iters,
                                   step=kc.solve_iteration_plain)
        err = max(cs.max_err(lk, lp), cs.max_err(ak, ap))
        cs.check(err <= 1e-4, f"KC {what}: max abs err {err} > 1e-4")
        setup = timed(lambda: kq.solve_setup(*args_, p, DT, cache.data, wm), "setup_")
        kc_call = timed(one_pass, "solve_rows")
        bodies_us = cs.device_us_call(one_pass, "solve_bodies")
        kc_call["device_us_per_launch"] = dict(solve_rows=kc_call["device_us"],
                                               solve_bodies=bodies_us)
        kc_call["device_us"] = (None if bodies_us is None or kc_call["device_us"] is None
                                else kc_call["device_us"] + bodies_us)
        solve = dict(ms_with_setup=cs.median_ms(whole), **cs.host_cost(whole))
        solve["kc_device_us"] = sum(cs.device_us_call(whole, k) or 0.0
                                    for k in ("solve_rows", "solve_bodies"))
        solve["solve_host_us"] = solve["host_us"] - setup["host_us"]
        return dict(bodies=body.capacity, static_rows=int(rp.s_valid.sum()),
                    pair_rows=int(rp.p_valid.sum()), wm=wm, rows_err=rows_err, kc_err=err,
                    solve_setup=setup, kc_call=kc_call, solve=solve)

    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    out["bench"] = entry(w, "bench")
    del w
    sw, player = benchworld.serving_world("cuda")
    for t in range(60):
        benchworld.serving_tick(sw, player, t * DT)
    out["serving"] = entry(sw, "serving")
    del sw, player
    mw, mplayer, src = benchworld.mesh_world("cuda")
    for t in range(60):
        benchworld.mesh_tick(mw, mplayer, t * DT, src)
    out["mesh"] = entry(mw, "mesh")
    del mw, mplayer, src
    if not args.no_ticks:
        th = cs.main_path_phase()
        out["ms_per_think"] = th["ms_per_think_median"]
        out["ms_per_think_p90"] = th.get("ms_per_think_p90")
        sv = cs.serving_phase()
        out["ms_per_serving_tick"] = sv["ms_per_serving_tick_median"]
        out["ms_per_serving_tick_p90"] = sv["ms_per_serving_tick_p90"]
    return bd.finish("bench_solve", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

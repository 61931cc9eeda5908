#!/usr/bin/env python3
"""The box-box rows (KA) and the position solve (KU) on the card, for the
port found under ``--root`` (default: this checkout).

KA, each case held against its twin (the outputs not equal to the bit
listed, the points', normals' and depths' largest difference):

- ``bench``, ``serving``, ``mesh``, ``client``: the box-box call of the
  next step of the bench world (phase 5's, after 30 thinks), the serving
  world (phase 11's, after 60 ticks), the mesh world (phase 13's, after 60
  frames) and the client world (phase 19's, after 31 frames), its
  arguments captured inside that step (a world without a box-box bucket
  is recorded as such);
- every ``hard_cases.BOX_BOX_CASES`` scene, ``full`` (16,384 slots) timed.

KU, each case held against its twin (bit equality and the largest
difference recorded):

- ``bench``, ``serving``, ``mesh``: the position solve of the next step of
  those worlds, captured the same way;
- every ``hard_cases.POSITION_CASES`` scene, checked, not timed.

For the timed cases: ms per call (CUDA events, ``chip_smoke.median_ms``),
device µs per call and per launch and launches a call
(``chip_smoke.split_cost``), the host's cost per call, and the bound
(``chip_smoke.bound``; KA's bytes from ``chip_smoke.ka_bytes``).  Every
case's inputs and outputs are saved to chiprun_out/ka_ku_<tag>.pt; with
``--against TAG`` the run loads that file, runs its own kernels on the
saved inputs and lists every output that differs from the saved one, bit
for bit (the parent's run first, in the same call).  ``--ptxas`` rebuilds
the library with ``-Xptxas -v`` first and keeps the KA and KU kernels'
registers, stack and spills.  Then phases 5 (180 thinks), 9 (180 full
ticks), 11 (180 serving ticks) and 13 (180 mesh frames) unless
``--no-ticks`` (``--phases`` picks some of them); ``--ticks-only`` runs
those phases alone.  Run parent, change, change, parent in one call:

    python3 substrata_tpu_torch/bench_box_positions.py [--root DIR] [--tag NAME]
        [--against TAG] [--ptxas] [--no-ticks | --ticks-only]
        [--phases think,full_tick,serving,mesh]

The helpers come from this checkout (``bench_driver.py``), the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_box_positions_<tag>.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import tempfile

import bench_driver as bd

KA_OUTPUTS = ("a", "b", "point", "normal", "penetration", "valid", "friction", "restitution",
              "key", "touching")
TICK_PHASES = ("think", "full_tick", "serving", "mesh")


def _ptxas_report(build):
    """The -Xptxas -v lines of the KA and KU kernels: entry, registers,
    stack frame and spills."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        build.build(verbose=True)
    keep, on = [], False
    for line in buf.getvalue().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            on = "box_box" in line or "positions" in line
        if on:
            keep.append(line.strip())
    return keep


def main():
    args, cs = bd.start("bench_box_positions", against=True, ticks=TICK_PHASES,
                        flags=("--ptxas",))
    import torch
    from substrata_tpu_torch.kernels import box_box as ka
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import positions as ku
    bd.check_root(ka, args.root)
    out = bd.header(args, cs)
    if args.ptxas:
        out["ptxas"] = _ptxas_report(build)
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not args.ticks_only:
        _kernel_cases(args, cs, bd.hard_cases(), out, torch, ka, ku)
    if not args.no_ticks:
        bd.ticks(cs, out, args.phases.split(","),
                 {"ka": "box_box_rows", "ku": "solve_positions", "rebuild": "find_pairs"})
    return bd.finish("bench_box_positions", out, args.tag)


def _kernel_cases(args, cs, hc, out, torch, ka, ku):
    """KA's and KU's cases, timed and checked, saved for ``--against``,
    and the comparison with a saved run."""
    from substrata_tpu_torch import benchworld
    saved = {}

    def ka_entry(name, kargs, time_it):
        got, want = ka.box_box_rows(*kargs), ka.box_box_rows_plain(*kargs)
        apart = [oname for oname, g, w in zip(KA_OUTPUTS, got, want) if not cs.same_bits(g, w)]
        saved[f"ka_{name}"] = dict(args=bd.to_cpu(kargs), out=bd.to_cpu(tuple(got)))
        valid = kargs[8]
        r = dict(slots=int(kargs[6].shape[0]), valid_slots=int(valid.sum()),
                 valid_rows=int(want[5].sum()), touching=int(want[9].sum()),
                 outputs_apart_from_twin=apart,
                 max_abs_err=max(cs.max_err(got[i], want[i]) for i in (2, 3, 4)))
        if time_it:
            r.update(**cs.bound(cs.ka_bytes(kargs, got),
                                cs.FLOPS["box_box_rows"] * int(valid.sum())),
                     plain_ms=cs.median_ms(lambda: ka.box_box_rows_plain(*kargs), reps=5),
                     ms=cs.median_ms(lambda: ka.box_box_rows(*kargs)),
                     **cs.split_cost(lambda: ka.box_box_rows(*kargs)))
        return r

    def ku_entry(name, uargs, kw, time_it):
        pk = ku.solve_positions(*uargs, **kw)
        pp = ku.solve_positions_plain(*uargs, kw["iters"], kw["beta"], kw["wm"])
        saved[f"ku_{name}"] = dict(args=bd.to_cpu(uargs), kw=kw, out=pk.cpu())
        n, cpb = uargs[0].shape[0], uargs[5].shape[1]
        rows = uargs[3][0].shape[0] + uargs[4][0].shape[0]
        r = dict(bodies=n, rows=rows, cpb=cpb, wm=kw["wm"], iters=kw["iters"],
                 moved_max=float((pp - uargs[0]).abs().max()),
                 bit_equal_to_twin=bool(cs.same_bits(pk, pp)), max_abs_err=cs.max_err(pk, pp))
        if time_it:
            # Each input read once and the output written once; each
            # iteration's operations counted.
            r.update(**cs.bound(cs.nbytes(uargs) + cs.nbytes(pk),
                                kw["iters"] * (cs.FLOPS["position_row"] * rows
                                               + cs.FLOPS["position_slot"] * n * cpb)),
                     plain_ms=cs.median_ms(lambda: ku.solve_positions_plain(
                         *uargs, kw["iters"], kw["beta"], kw["wm"]), reps=5),
                     ms=cs.median_ms(lambda: ku.solve_positions(*uargs, **kw)),
                     **cs.split_cost(lambda: ku.solve_positions(*uargs, **kw)))
        return r

    def add_world(name, run, with_ku=True):
        ku_got = []
        ka_got = bd.captured(ka, "box_box_rows",
                             lambda: ku_got.extend(bd.captured(ku, "solve_positions", run)))
        if ka_got:
            out[f"ka_{name}"] = ka_entry(name, ka_got[-1][0], True)
        else:
            out[f"ka_{name}"] = dict(box_box_calls=0)
        cs.log(f"# ka {name} {json.dumps(out[f'ka_{name}'])}")
        if with_ku:
            cs.check(len(ku_got) == 1, f"{len(ku_got)} position solves in a {name} step")
            a, kw = ku_got[0]
            out[f"ku_{name}"] = ku_entry(name, a, kw, True)
            cs.log(f"# ku {name} {json.dumps(out[f'ku_{name}'])}")

    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(bd.DT)
    add_world("bench", lambda: w.think(bd.DT))
    del w

    sw, player = benchworld.serving_world("cuda")
    for t in range(60):
        benchworld.serving_tick(sw, player, t * bd.DT)
    add_world("serving", lambda: benchworld.serving_tick(sw, player, 60 * bd.DT))
    del sw, player

    mw, mp, msrc = benchworld.mesh_world("cuda")
    for t in range(60):
        benchworld.mesh_tick(mw, mp, t * bd.DT, msrc)
    add_world("mesh", lambda: benchworld.mesh_tick(mw, mp, 60 * bd.DT, msrc))
    del mw, mp, msrc

    with tempfile.TemporaryDirectory(prefix="client_world_") as sounds:
        sc = benchworld.client_world("cuda", sound_dir=sounds)
        for f in range(31):
            benchworld.client_tick(sc, f)
        add_world("client", lambda: benchworld.client_tick(sc, 31), with_ku=False)
        del sc

    out["ka_hard_cases"] = {}
    for case in hc.BOX_BOX_CASES:
        kargs = hc.box_box_inputs(hc.box_box_scene(case), "cuda")
        out["ka_hard_cases"][case] = ka_entry(f"hard_{case}", kargs, case == "full")
    cs.log(f"# ka hard {json.dumps(out['ka_hard_cases'])}")
    out["ku_hard_cases"] = {}
    for case in hc.POSITION_CASES:
        uargs, kw = hc.position_inputs(hc.position_scene(case), "cuda")
        out["ku_hard_cases"][case] = ku_entry(f"hard_{case}", uargs, kw, False)
    cs.log(f"# ku hard {json.dumps(out['ku_hard_cases'])}")

    bd.save_cases(saved, "ka_ku", args.tag)
    if args.against:
        ref = bd.load_cases("ka_ku", args.against)
        diffs = {}
        for key, s in ref.items():
            a = bd.to_cuda(s["args"])
            if key.startswith("ka_"):
                d = bd.row_diffs(KA_OUTPUTS, ka.box_box_rows(*a), s["out"])
            else:
                d = bd.row_diffs(("positions",), (ku.solve_positions(*a, **s["kw"]),),
                                 (s["out"],))
            if d:
                diffs[key] = d
        out["against"] = dict(tag=args.against, cases=len(ref), differing=diffs)
        cs.log(f"# against {args.against}: {json.dumps(out['against'])}")


if __name__ == "__main__":
    sys.exit(main())

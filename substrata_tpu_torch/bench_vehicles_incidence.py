#!/usr/bin/env python3
"""The vehicle forces (KJ) and KT's incidence table on the card, for the
port found under ``--root`` (default: this checkout).

KJ (``vehicles.vehicle_forces``), each case first held against its twin
(1e-5 of each output's scale, gear and contact exact; the outputs equal to
the bit are counted):

- ``fulltick``: the full tick's 8 vehicles (chip_smoke phase 8's scene:
  bench.py's window 3 after 30 full ticks, the wheel rays by KH);
- ``v33``: ``hard_cases.vehicle_scene("v33")``, 33 vehicles over a block
  boundary;
- every other ``hard_cases.VEHICLE_CASES`` scene, checked, not timed.

KT's incidence table (``layout.incidence``), each case first held against
its twin to the bit:

- ``serving``: the serving world (phase 10's: the bench world's 10,240
  slots and a walking player) after 60 serving ticks, on the compacted rows
  its next step hands the table (captured inside that step);
- ``capacity``: 65,536 bodies (``chip_smoke.incidence_capacity_inputs``:
  the lattice of bench_pairs_mix.py, the first 16,383 of KS's pairs as the
  entries, the most rows a 65,536-body world's 32-bit incidence key
  allows, physics/state.py's contact budget; cpb 8 as in the bench world);
- every ``hard_cases.INCIDENCE_CASES`` scene, checked, not timed.

Every case's inputs and outputs are saved to
chiprun_out/kj_kt_<tag>.pt; with ``--against TAG`` the run loads that
file, runs its own kernels on the saved inputs and lists every output
that differs from the saved one, bit for bit (a parent's run, then the
change's with ``--against parent``).

For the timed cases: ms per call (CUDA events, ``chip_smoke.median_ms``),
device µs per call and per launch by kernel name (``chip_smoke.launch_split``;
a memset counts as a launch), the host's cost per call
(``chip_smoke.host_cost``) and the bound (``chip_smoke.bound``).  Then
phase 9 (180 full ticks), phase 11 (180 serving ticks) and phase 19 (180
client frames) unless ``--no-ticks``.  Run parent, change, change, parent
in one call:

    python3 substrata_tpu_torch/bench_vehicles_incidence.py [--root DIR] [--tag NAME]
        [--against TAG] [--no-ticks]

The helpers come from this checkout, the port from ``--root``.  Prints one
JSON line, with the card's name and power limit, and writes it to
chiprun_out/bench_vehicles_incidence_<tag>.json.
"""

from __future__ import annotations

import json
import sys

import bench_driver as bd

OUT_DIR = bd.OUT_DIR
DT = bd.DT
KJ_OUTPUTS = ("dv", "dw", "steering", "sus_len", "omega", "rot", "unflip", "contact", "gear",
              "shift_timer", "rpm")
KT_OUTPUTS = ("table", "sign", "counts")


def _bits(t):
    import torch
    return t.view(torch.int32) if t.is_floating_point() else t


def _differing(got, want, names):
    """[(output, elements that differ, max abs difference)] of the outputs
    not equal to the bit."""
    import torch
    out = []
    for name, g, w in zip(names, got, want):
        w = w.to(g.device)
        if g.shape != w.shape or g.dtype != w.dtype:
            out.append((name, "shape or dtype", None))
            continue
        ne = _bits(g) != _bits(w)
        if bool(ne.any()):
            d = (g.float() - w.float()).abs()[ne]
            out.append((name, int(ne.sum()), float(torch.nan_to_num(d, nan=float("inf")).max())))
    return out


def _column(t, st, device):
    """A copy of entry column ``t`` on ``device`` at stride ``st`` (the rows
    between its entries filled with -2, never read)."""
    import torch
    rows = torch.full((t.shape[0] * st,), -2, dtype=t.dtype, device=device)
    rows[::st] = t.to(device)
    return rows.reshape(-1, st)[:, 0]


def main():
    args, cs = bd.start("bench_vehicles_incidence", against=True, flags=("--no-ticks",))
    root = args.root
    import torch
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import layout as kt
    from substrata_tpu_torch.kernels import ray_trace as kh
    from substrata_tpu_torch.kernels import vehicles as kj
    from substrata_tpu_torch.physics.vehicles.manager import VehicleArrays, VehicleInputs
    bd.check_root(kj, root)
    hc = bd.hard_cases()
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(tag=args.tag, root=root, nvidia_smi=cs.nvidia_smi_line(),
               device=torch.cuda.get_device_name(0))
    saved = {}

    def timed(fn):
        return dict(ms=cs.median_ms(fn), **cs.split_cost(fn))

    # --- KJ.
    def kj_entry(name, jargs, time_it):
        _, rel, jk, jp = cs._kj_compare(jargs, name)
        twin_bits = sum(int(cs.same_bits(x, y)) for x, y in zip(jk, jp))
        veh, inp = jargs[0], jargs[1]
        saved[f"kj_{name}"] = dict(
            veh={k: v.cpu() for k, v in vars(veh).items()},
            inp={k: v.cpu() for k, v in vars(inp).items()},
            rows=[t.cpu() for t in jargs[2:12]], dt=jargs[12], out=[t.cpu() for t in jk])
        nv = veh.vtype.shape[0]
        r = dict(vehicles=nv, max_err_of_scale=rel, outputs_bit_equal_to_twin=twin_bits,
                 contacts=int(jp[7].sum()))
        if time_it:
            kj_in = [getattr(veh, f) for f in kj.KERNEL_FIELDS] + list(vars(inp).values())
            r.update(**cs.bound(cs.nbytes(kj_in, jargs[2:12], jk),
                                cs.FLOPS["vehicle_forces"] * nv),
                     plain_ms=cs.median_ms(lambda: kj.vehicle_forces_plain(*jargs), reps=5),
                     **timed(lambda: kj.vehicle_forces(*jargs)))
        return r

    cases, (w, veh, vin, ps, chassis) = cs.fulltick_ray_cases("cuda")
    wargs, wkw = cases["wheels"]
    wt, wn, _, whit, _ = kh.ray_trace(*wargs, **wkw)
    nv = veh.vtype.shape[0]
    jargs = (veh, vin, *chassis, wt.reshape(nv, 4), wn.reshape(nv, 4, 3),
             whit.reshape(nv, 4) & (veh.body_slot >= 0)[:, None], w.params.water_z, DT)
    out["kj_fulltick"] = kj_entry("fulltick", jargs, True)
    cs.log(f"# kj fulltick {json.dumps(out['kj_fulltick'])}")
    del w, cases, ps
    hard = {}
    for case in hc.VEHICLE_CASES:
        r = kj_entry(case, hc.vehicle_inputs(hc.vehicle_scene(case), "cuda"), case == "v33")
        if case == "v33":
            out["kj_v33"] = r
            cs.log(f"# kj v33 {json.dumps(r)}")
        else:
            hard[case] = r
    out["kj_hard_cases"] = hard

    # --- KT's incidence table.
    def kt_entry(name, ia, time_it):
        ik, ip = kt.incidence(*ia), kt.incidence_plain(*ia)
        for oname, x, y in zip(KT_OUTPUTS, ik, ip):
            cs.check(cs.same_bits(x, y), f"KT incidence {name}: {oname} differs from its twin's")
        saved[f"kt_{name}"] = dict(ea=ia[0].cpu(), eb=ia[1].cpu(), st=ia[0].stride(0),
                                   occ=ia[2].cpu(), n=ia[3], cpb=ia[4],
                                   out=[t.cpu() for t in ik])
        n, cpb = ia[3], ia[4]
        per_body = ip[2]
        r = dict(bodies=n, entries=int(ia[0].shape[0]), stride=ia[0].stride(0), cpb=cpb,
                 occupied=int(ia[2].sum()), bodies_full=int((per_body == cpb).sum()),
                 bit_equal=True)
        if time_it:
            r.update(**cs.bound(cs.nbytes(ia[0], ia[1], ia[2], ik), 0),
                     plain_ms=cs.median_ms(lambda: kt.incidence_plain(*ia), reps=5),
                     **timed(lambda: kt.incidence(*ia)))
        return r

    sw, player = benchworld.serving_world("cuda")
    for t in range(60):
        benchworld.serving_tick(sw, player, t * DT)
    captured = []
    real = kt.incidence

    def capture(entry_a, entry_b, entry_occ, n_bodies, cpb):
        st = entry_a.stride(0)
        captured.append((_column(entry_a, st, entry_a.device),
                         _column(entry_b, st, entry_b.device), entry_occ.clone(), n_bodies, cpb))
        return real(entry_a, entry_b, entry_occ, n_bodies, cpb)
    kt.incidence = capture
    try:
        benchworld.serving_tick(sw, player, 60 * DT)
    finally:
        kt.incidence = real
    cs.check(len(captured) == 1, f"{len(captured)} incidence calls in a serving step")
    out["kt_serving"] = kt_entry("serving", captured[0], True)
    cs.log(f"# kt serving {json.dumps(out['kt_serving'])}")
    del sw, player, captured

    out["kt_capacity"] = kt_entry("capacity", cs.incidence_capacity_inputs("cuda"), True)
    cs.log(f"# kt capacity {json.dumps(out['kt_capacity'])}")
    out["kt_hard_cases"] = {case: kt_entry(case, hc.incidence_inputs(hc.incidence_scene(case),
                                                                     "cuda"), False)
                            for case in hc.INCIDENCE_CASES}

    bd.save_cases(saved, "kj_kt", args.tag)
    if args.against:
        ref = bd.load_cases("kj_kt", args.against)
        diffs = {}
        for key, s in ref.items():
            if key.startswith("kj_"):
                a = (VehicleArrays(**{k: v.cuda() for k, v in s["veh"].items()}),
                     VehicleInputs(**{k: v.cuda() for k, v in s["inp"].items()}),
                     *(t.cuda() for t in s["rows"]), s["dt"])
                got, names = kj.vehicle_forces(*a), KJ_OUTPUTS
            else:
                got = kt.incidence(_column(s["ea"], s["st"], "cuda"),
                                   _column(s["eb"], s["st"], "cuda"), s["occ"].cuda(), s["n"],
                                   s["cpb"])
                names = KT_OUTPUTS
            d = _differing(got, s["out"], names)
            if d:
                diffs[key] = d
        out["against"] = dict(tag=args.against, cases=len(ref), differing=diffs)
        cs.log(f"# against {args.against}: {json.dumps(out['against'])}")

    if not args.no_ticks:
        ft = cs.full_tick_phase()
        out["full_tick"] = dict(ms_median=ft["ms_per_tick_median"],
                                ms_p90=ft["ms_per_tick_p90"],
                                vehicle_launches=ft["launches"]["vehicle_forces"])
        sv = cs.serving_phase()
        out["serving"] = dict(ms_median=sv["ms_per_serving_tick_median"],
                              ms_p90=sv["ms_per_serving_tick_p90"],
                              incidence_launches=sv["launches"]["layout_incidence"])
        cl = cs.client_phase()
        out["client"] = dict(ms_median=cl["ms_per_client_frame_median"],
                             ms_p90=cl["ms_per_client_frame_p90"],
                             vehicle_launches=cl["launches"]["vehicle_forces"],
                             incidence_launches=cl["launches"]["layout_incidence"])
    return bd.finish("bench_vehicles_incidence", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

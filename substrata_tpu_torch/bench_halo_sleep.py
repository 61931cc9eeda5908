#!/usr/bin/env python3
"""The halo exchange (KAD) and the sleep pass (KV) on the card, for the
port found under ``--root`` (default: this checkout).

KAD, each case held against its twin (every byte of the combined state and
the overflow counts):

- ``slabs``: phase 22's exchange, the bench world after 30 thinks in 4
  x-slabs over [-52, 52] m (3,072 rows a slab, H = 512, 3 m wide);
- ``tile_x``, ``tile_y``: the two phases of its 2 x 2 tiles (H = 768),
  the y phase on the kernel's x phase;
- every ``hard_cases.HALO_CASES`` scene, each phase.

KV's sleep pass, each case held against its twin (every output to the bit):

- ``think``: the sleep pass of the bench world's next think after 30
  thinks, its arguments captured inside that step;
- ``drowsy``: the same with half the awake bodies asleep and every timer
  at 0.49 s (phase 15's second case);
- ``capacity``: 65,536 bodies with the first 16,383 of KS's pairs
  (``chip_smoke.kv_capacity_inputs``);
- for ``think`` and ``capacity``, the kernel at 1, 2, 4 and 8 lanes a body
  (``lanes_device_us``; a port whose plan has no lane count skips it);
- every ``hard_cases.SLEEP_CASES`` scene.

Every case is timed: ms per call (CUDA events, ``chip_smoke.median_ms``),
device µs per call and per launch and launches a call, each launch and
memset apart (``chip_smoke.split_cost``), the host's cost per call, the
plain twin's ms and the bound (``chip_smoke.bound``; KAD's bytes from
``halo.bytes_moved``).  Every case's inputs and outputs are saved to
chiprun_out/kad_kv_<tag>.pt; with ``--against TAG`` the run loads that
file, runs its own kernels on the saved inputs and lists every output
that differs from the saved one, bit for bit (the parent's run first, in
the same call; remove the files after: ~25 MB a run).  Then phase 5 (180
thinks) and phase 23's slab and tile steps (``bench_driver.PHASES``)
unless ``--no-ticks``; ``--ticks-only`` runs those phases alone.  Run
parent, change, change, parent in one call:

    python3 substrata_tpu_torch/bench_halo_sleep.py [--root DIR] [--tag NAME]
        [--against TAG] [--no-ticks | --ticks-only] [--phases think,slabs,tiles]

The helpers come from this checkout (``bench_driver.py``), the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_halo_sleep_<tag>.json.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import bench_driver as bd

TICK_PHASES = ("think", "slabs", "tiles")


def main():
    args, cs = bd.start("bench_halo_sleep", against=True, ticks=TICK_PHASES)
    import torch
    from substrata_tpu_torch.kernels import build, halo
    from substrata_tpu_torch.kernels import sleep as kv
    bd.check_root(halo, args.root)
    out = bd.header(args, cs)
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not args.ticks_only:
        _kernel_cases(args, cs, bd.hard_cases(), out, torch, halo, kv)
    if not args.no_ticks:
        bd.ticks(cs, out, args.phases.split(","), {"kad": "halo_exchange", "kv": "sleep_pass"})
    return bd.finish("bench_halo_sleep", out, args.tag)


def _kernel_cases(args, cs, hc, out, torch, halo, kv):
    """KAD's and KV's cases, timed and checked, saved for ``--against``,
    and the comparison with a saved run."""
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.parallel import spatial
    from substrata_tpu_torch.physics.state import BODY_FIELDS, BodyState
    kad_names = BODY_FIELDS + ("overflow",)
    kv_names = tuple(f.name for f in dataclasses.fields(kv.SleepOut))
    saved = {}

    def kad_entry(name, state, s, h, phase):
        got, ov = halo.exchange(state, s, h, *phase)
        want, ov_p = halo.exchange_plain(state, s, h, *phase)
        outs = [getattr(got, f) for f in BODY_FIELDS] + [ov]
        apart = [f for f, g, w in zip(kad_names, outs, [getattr(want, f) for f in BODY_FIELDS]
                                      + [ov_p]) if not cs._bytes_equal(g, w)]
        # The thresholds as floats (each a float32 exactly): the saved
        # file is loaded with torch.load's default weights_only.
        saved[f"kad_{name}"] = dict(state={f: getattr(state, f).cpu() for f in BODY_FIELDS},
                                    s=s, h=h, out=bd.to_cpu(outs),
                                    phase=phase[:3] + tuple([float(x) for x in t]
                                                            for t in phase[3:]))
        r = dict(shards=s, rows_in=state.capacity // s, halo=h, axis=phase[0],
                 overflow=ov.sum(1).tolist(), outputs_apart_from_twin=apart,
                 **cs.bound(halo.bytes_moved(state, s, h), 4 * state.capacity),
                 plain_ms=cs.median_ms(lambda: halo.exchange_plain(state, s, h, *phase), reps=5),
                 ms=cs.median_ms(lambda: halo.exchange(state, s, h, *phase)),
                 **cs.split_cost(lambda: halo.exchange(state, s, h, *phase)))
        cs.log(f"# kad {name} {json.dumps(r)}")
        return r, got

    def lane_sweep(vargs):
        """{lanes a body: device µs a call} of this port's kernel at 1, 2, 4
        and 8 lanes a body (none on a port whose plan has no lane count),
        every output checked against the twin."""
        kv.sleep_pass(*vargs)
        plan = next(reversed(getattr(kv, "_plans", {}).values()), None)
        if plan is None or not hasattr(plan, "g_shift"):
            return None
        want, base, out = kv.sleep_pass_plain(*vargs), plan.g_shift, {}
        try:
            for g in range(4):
                plan.g_shift = g
                got = kv.sleep_pass(*vargs)
                cs.check(all(cs.same_bits(getattr(got, f), getattr(want, f)) for f in kv_names),
                         f"KV with {1 << g} lanes a body differs from the twin")
                out[1 << g] = cs.device_us_call(lambda: kv.sleep_pass(*vargs), "sleep_")
        finally:
            plan.g_shift = base
        return out

    def kv_entry(name, vargs):
        got, want = kv.sleep_pass(*vargs), kv.sleep_pass_plain(*vargs)
        outs = [getattr(got, f) for f in kv_names]
        apart = [f for f, g in zip(kv_names, outs) if not cs.same_bits(g, getattr(want, f))]
        saved[f"kv_{name}"] = dict(args=_cpu_args(vargs), out=bd.to_cpu(outs))
        b = vargs[0]
        ins = [b.awake, vargs[1], b.sleep_timer, b.alive, b.motion_type, vargs[2], vargs[3],
               vargs[4], vargs[5], vargs[6], vargs[7], vargs[8], vargs[12]]
        r = dict(bodies=b.capacity, cpb=int(vargs[7].shape[1]), wm=vargs[9],
                 newly_awake=int(want.newly_awake.sum()),
                 newly_asleep=int(want.newly_asleep.sum()), steps_left=int(want.steps_left),
                 outputs_apart_from_twin=apart,
                 **cs.bound(cs.nbytes(ins, outs), cs.FLOPS["sleep_body"] * b.capacity),
                 plain_ms=cs.median_ms(lambda: kv.sleep_pass_plain(*vargs), reps=5),
                 ms=cs.median_ms(lambda: kv.sleep_pass(*vargs)),
                 **cs.split_cost(lambda: kv.sleep_pass(*vargs)))
        cs.log(f"# kv {name} {json.dumps(r)}")
        return r

    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(bd.DT)
    part, _ = spatial.partition_by_slab(w.state, cs.SLABS, cs.SLAB_CAP, *cs.SLAB_X)
    lo, hi = halo.thresholds(*cs.SLAB_X, cs.SLABS, cs.HALO_WIDTH)
    out["kad_slabs"], _ = kad_entry("slabs", part, cs.SLABS, cs.SLAB_HALO,
                                    (0, 1, cs.SLABS, lo, hi))
    tiles, _ = spatial.partition_by_tile(w.state, 2, 2, cs.SLAB_CAP, *cs.SLAB_X, *cs.SLAB_X)
    tlo, thi = halo.thresholds(*cs.SLAB_X, 2, cs.HALO_WIDTH)
    out["kad_tile_x"], gx = kad_entry("tile_x", tiles, 4, cs.TILE_HALO, (0, 2, 2, tlo, thi))
    out["kad_tile_y"], _ = kad_entry("tile_y", gx, 4, cs.TILE_HALO, (1, 1, 2, tlo, thi))
    out["kad_hard_cases"] = {}
    for case in hc.HALO_CASES:
        state, s, h, phases = hc.halo_inputs(hc.halo_scene(case), "cuda")
        for k, phase in enumerate(phases):
            out["kad_hard_cases"][f"{case}_{k}"], state = kad_entry(f"hard_{case}_{k}", state,
                                                                     s, h, phase)

    got = bd.captured(kv, "sleep_pass", lambda: w.think(bd.DT))
    cs.check(len(got) == 1, f"{len(got)} sleep passes in a think")
    vargs = got[0][0]
    out["kv_think"] = kv_entry("think", vargs)
    out["kv_think"]["lanes_device_us"] = lane_sweep(vargs)
    body = vargs[0]
    gen = torch.Generator(device=body.device)
    gen.manual_seed(15)
    drowsy = body.awake & (torch.rand(body.awake.shape, generator=gen, device=body.device) < 0.5)
    body2 = body.replace(awake=drowsy, sleep_timer=torch.full_like(body.sleep_timer, 0.49))
    out["kv_drowsy"] = kv_entry("drowsy", (body2, drowsy) + tuple(vargs[2:]))
    del w
    cap = cs.kv_capacity_inputs("cuda", hc)
    out["kv_capacity"] = kv_entry("capacity", cap)
    out["kv_capacity"]["lanes_device_us"] = lane_sweep(cap)
    out["kv_hard_cases"] = {}
    for case in hc.SLEEP_CASES:
        out["kv_hard_cases"][case] = kv_entry(f"hard_{case}",
                                              hc.sleep_inputs(hc.sleep_scene(case), "cuda"))

    bd.save_cases(saved, "kad_kv", args.tag)
    if args.against:
        ref = bd.load_cases("kad_kv", args.against)
        diffs = {}
        for key, sv in ref.items():
            if key.startswith("kad_"):
                state = BodyState(**{f: t.cuda() for f, t in sv["state"].items()})
                c, ov = halo.exchange(state, sv["s"], sv["h"], *sv["phase"])
                d = bd.row_diffs(kad_names, [getattr(c, f) for f in BODY_FIELDS] + [ov],
                                 sv["out"])
            else:
                r = kv.sleep_pass(*_cuda_args(sv["args"]))
                d = bd.row_diffs(kv_names, [getattr(r, f) for f in kv_names], sv["out"])
            if d:
                diffs[key] = d
        out["against"] = dict(tag=args.against, cases=len(ref), differing=diffs)
        cs.log(f"# against {args.against}: {json.dumps(out['against'])}")


def _cpu_args(vargs):
    """The sleep pass's arguments with the body and params as dicts of CPU
    tensors, lambda_p kept with its strides."""
    body, params = vargs[0], vargs[11]
    lam = vargs[6]
    return dict(body={f.name: getattr(body, f.name).cpu() for f in dataclasses.fields(body)},
                params={f.name: getattr(params, f.name).cpu()
                        for f in dataclasses.fields(params)},
                rest=bd.to_cpu(tuple(vargs[1:6]) + tuple(vargs[7:11]) + (vargs[12],)),
                lam=lam.cpu(), lam_stride=lam.stride(1))


def _cuda_args(sv):
    """``_cpu_args`` back on the card, lambda_p as a column of [Q, wm, s]."""
    import torch
    from substrata_tpu_torch.physics.state import BodyState, SimParams
    body = BodyState(**{k: t.cuda() for k, t in sv["body"].items()})
    params = SimParams(**{k: t.cuda() for k, t in sv["params"].items()})
    rest = bd.to_cuda(sv["rest"])
    q, wm = sv["lam"].shape
    lam3 = torch.zeros((q, wm, sv["lam_stride"]), dtype=torch.float32, device="cuda")
    lam3[..., 0] = sv["lam"].cuda()
    return (body,) + tuple(rest[:5]) + (lam3[..., 0],) + tuple(rest[5:9]) + (params, rest[9])


if __name__ == "__main__":
    sys.exit(main())

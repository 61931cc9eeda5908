#!/usr/bin/env python3
"""The hull contacts (KO) and the pose (KZ) on the card, for the port found
under ``--root`` (default: this checkout).

KO, each case held against its twin bucket by bucket (the outputs not
equal to the bit listed, the points', normals' and depths' largest
difference on the twin's valid rows):

- ``mesh``, ``client``: a step's hull buckets of the mesh world (phase
  13's, after 60 frames) and of the client world (phase 19's, after 31
  frames), taken from the world's pair list as the step groups it, in the
  world's layout; timed as the step calls KO, into one contact buffer at
  the buckets' offsets: one ``convex_buckets`` call where the port has it,
  else a ``convex_rows`` call a bucket into its views;
- ``random_<code>``: 4,096 seeded random pairs of each hull code (phase
  12's), one ``convex_rows`` call each, timed;
- every ``hard_cases.CONVEX_CASES`` scene, run as a step (``mesh_step``
  timed).

KZ, held against its twin to the bit: the terrain world's 64 avatars at
frames 0, 60 and 120 of their walk, every option at random on 64
avatars, 37 padded to 64 (phase 16's moments; frame 60 timed, with the
FK as ``torch.matmul`` per level as the library call), and every
``hard_cases.POSE_CASES`` scene.

For the timed cases: ms per call (CUDA events, ``chip_smoke.median_ms``),
device µs per call and per launch and launches a call
(``chip_smoke.split_cost``), the host's cost per call, and the bound
(``chip_smoke.bound``; KO's bytes and operations from
``chip_smoke._ko_work``).  Every case's inputs and outputs are saved to
chiprun_out/ko_kz_<tag>.pt (~30 MB a run, the clip banks with them:
remove them once the ``--against`` runs are done, or a call's output
outgrows the copy back); with ``--against TAG`` the run loads that
file, runs its own kernels on the saved inputs (KO a bucket at a time
through ``convex_rows``) and lists every output that differs from the
saved one, bit for bit (the parent's run first, in the same call).
``--ptxas`` rebuilds the library with ``-Xptxas -v`` first and keeps the
KO and KZ kernels' registers, stack and spills.  Then phases 13 (180 mesh
frames) and 17 (180 terrain frames) unless ``--no-ticks`` (``--phases``
picks one); ``--ticks-only`` runs those phases alone.  Run parent, change,
change, parent in one call:

    python3 substrata_tpu_torch/bench_convex_pose.py [--root DIR] [--tag NAME]
        [--against TAG] [--ptxas] [--no-ticks | --ticks-only] [--phases mesh,terrain]

The helpers come from this checkout (``bench_driver.py``), the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_convex_pose_<tag>.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import tempfile
from itertools import accumulate

import bench_driver as bd

KO_OUTPUTS = ("a", "b", "point", "normal", "penetration", "valid", "friction", "restitution",
              "key", "touching")
TICK_PHASES = ("mesh", "terrain")
HULL_FIELDS = ("verts", "n_verts", "planes", "n_faces")
RIG_FIELDS = ("parent", "depth", "joint_slot", "joint_finger", "grab_quats", "rest_scale",
              "inverse_bind", "levels", "n_levels")


def _ptxas_report(build):
    """The -Xptxas -v lines of the KO and KZ kernels: entry, registers,
    stack frame and spills."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        build.build(verbose=True)
    keep, on = [], False
    for line in buf.getvalue().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            on = "convex" in line or "pose" in line
        if on:
            keep.append(line.strip())
    return keep


def main():
    args, cs = bd.start("bench_convex_pose", against=True, ticks=TICK_PHASES,
                        flags=("--ptxas",))
    import torch
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import convex as ko
    bd.check_root(ko, args.root)
    if "convex_buckets" not in kernels.launch_counts():
        # A port from before the one-launch form counts KO as convex_rows;
        # chip_smoke's phases read the new name.
        counts = kernels.launch_counts
        kernels.launch_counts = lambda: {**counts(), "convex_buckets": counts()["convex_rows"]}
    out = bd.header(args, cs)
    if args.ptxas:
        out["ptxas"] = _ptxas_report(build)
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    out["one_launch"] = hasattr(ko, "convex_buckets")
    if not args.ticks_only:
        _kernel_cases(args, cs, bd.hard_cases(), out, torch)
    if not args.no_ticks:
        bd.ticks(cs, out, args.phases.split(","),
                 {"ko": "convex_buckets" if out["one_launch"] else "convex_rows",
                  "kz": "pose_avatars"})
    return bd.finish("bench_convex_pose", out, args.tag)


def _hull_dict(hulls):
    return {f: getattr(hulls, f).cpu() for f in HULL_FIELDS}


def _kernel_cases(args, cs, hc, out, torch):
    """KO's and KZ's cases, timed and checked, saved for ``--against``, and
    the comparison with a saved run."""
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.anim import pose as apose
    from substrata_tpu_torch.kernels import contact_rows
    from substrata_tpu_torch.kernels import convex as ko
    from substrata_tpu_torch.kernels import pose as kz
    from substrata_tpu_torch.physics import narrowphase
    from substrata_tpu_torch.physics.state import HullLibrary
    saved = {}
    one_launch = hasattr(ko, "convex_buckets")

    def ko_step(name, buckets, wms, blocked, rows, hulls, time_it):
        """One step's hull buckets: each bucket's rows against the twin's,
        and the step's call (``step``) against the buckets' own calls;
        saved a bucket at a time."""
        calls, apart, err = [], [], 0.0
        for k, ((code, ba, bb, bv), wm) in enumerate(zip(buckets, wms)):
            bargs = (code, wm, blocked, *rows, ba, bb, bv, hulls)
            got, want = ko.convex_rows(*bargs), ko.convex_rows_plain(*bargs)
            apart += [f"{code}:{o}" for o, g, w in zip(KO_OUTPUTS, got, want)
                      if not cs.same_bits(g, w)]
            err = max(err, *(cs.max_err(got[i], want[i], want[5]) for i in (2, 3, 4)))
            calls.append((bargs, got))
            saved[f"ko_{name}_{k}"] = dict(args=bd.to_cpu(bargs[:12]),
                                           hulls=_hull_dict(hulls), out=bd.to_cpu(tuple(got)))
        # The step's call: into one contact buffer at the buckets' offsets.
        caps = [int(b[1].shape[0]) for b in buckets]
        rows_at = list(accumulate((c * w for c, w in zip(caps, wms)), initial=0))
        touch_at = list(accumulate(caps, initial=0))
        fields, touch = contact_rows.contact_buffer(rows_at.pop(), touch_at.pop(), "cuda")
        views = [contact_rows.bucket_views(fields, touch, r0, c * w, t0, c)
                 for r0, t0, c, w in zip(rows_at, touch_at, caps, wms)]
        if one_launch:
            def step():
                ko.convex_buckets(buckets, wms, blocked, *rows, hulls,
                                  out=(fields, touch, rows_at, touch_at))
        else:
            def step():
                for (a, _), v in zip(calls, views):
                    ko.convex_rows(*a, out=v)
        step()
        same = all(cs.same_bits(g, w) for v, (_, rk) in zip(views, calls) for g, w in zip(v, rk))
        r = dict(buckets={int(b[0]): [int(b[1].shape[0]), int(b[3].sum())] for b in buckets},
                 blocked=bool(blocked), widths=list(wms),
                 touching=int(sum(int(rk[9].sum()) for _, rk in calls)),
                 outputs_apart_from_twin=apart, max_abs_err=err,
                 step_rows_equal_to_buckets=same)
        if time_it:
            r.update(**cs._ko_work(calls, hulls),
                     plain_ms=cs.median_ms(lambda: [ko.convex_rows_plain(*a) for a, _ in calls],
                                           reps=5),
                     ms=cs.median_ms(step), **cs.split_cost(step))
        return r

    def world_buckets(w):
        body, pc, cfg = w.state, w.pair_cache, w.config
        wm = narrowphase.blocked_manifold_width(cfg, body.capacity)
        groups = narrowphase.buckets(body, pc.pair_a, pc.pair_b, pc.pair_valid, cfg)[0]
        buckets = [(c, ba, bb, bv) for c, _, ba, bb, bv in groups if c in ko.CODES]
        rows = (body.pos, body.quat, body.shape_params, body.friction, body.restitution,
                body.is_sensor)
        return (buckets, tuple(wm or narrowphase._MANIFOLD_WIDTH[c] for c, *_ in buckets),
                bool(wm), rows, w.static_world.hulls)

    mw, mp, msrc = benchworld.mesh_world("cuda")
    for t in range(60):
        benchworld.mesh_tick(mw, mp, t * bd.DT, msrc)
    out["ko_mesh"] = ko_step("mesh", *world_buckets(mw), True)
    cs.log(f"# ko mesh {json.dumps(out['ko_mesh'])}")
    del mw, mp, msrc

    with tempfile.TemporaryDirectory(prefix="client_world_") as sounds:
        sc = benchworld.client_world("cuda", sound_dir=sounds)
        for f in range(31):
            benchworld.client_tick(sc, f)
        out["ko_client"] = ko_step("client", *world_buckets(sc.app.physics_world), True)
        cs.log(f"# ko client {json.dumps(out['ko_client'])}")
        del sc

    # 4,096 seeded random pairs of each hull code (phase 12's), compacted.
    hulls = cs.hull_library("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    n = 4096
    ba = torch.arange(n, dtype=torch.int32, device="cuda")
    for code in ko.CODES:
        pos, quat, prm, fr, re, sens = cs._random_pair_rows(gen, code, n, "cuda")
        for side, st in enumerate((code // 4, code % 4)):
            if st == 3:
                prm[side * n:(side + 1) * n, 0] = torch.randint(
                    0, 4, (n,), generator=gen, device="cuda").float()
        bv = torch.rand(n, generator=gen, device="cuda") < 0.9
        out[f"ko_random_{code}"] = ko_step(
            f"random_{code}", [(code, ba, ba + n, bv)], (narrowphase._MANIFOLD_WIDTH[code],),
            False, (pos, quat, prm, fr, re, sens), hulls, True)
    cs.log("# ko random " + json.dumps({c: out[f"ko_random_{c}"]["device_us_per_call"]
                                        for c in ko.CODES}))

    out["ko_hard_cases"] = {}
    for case in hc.CONVEX_CASES:
        buckets, wms, blocked, *rows, lib = hc.convex_inputs(hc.convex_scene(case), "cuda")
        out["ko_hard_cases"][case] = ko_step(f"hard_{case}", buckets, wms, blocked,
                                             tuple(rows), lib, case == "mesh_step")
    cs.log(f"# ko hard {json.dumps(out['ko_hard_cases'])}")

    # KZ: phase 16's moments, then the hard cases.
    def kz_entry(name, bank, rig, p, time_it, local=None):
        pk, pp = kz.pose(bank, rig, p), kz.pose_plain(bank, rig, p)
        saved[f"kz_{name}"] = dict(
            bank=dict(rot=bank.rot.cpu(), trans=bank.trans.cpu(), n_frames=bank.n_frames.cpu(),
                      looping=bank.looping.cpu(), f_cap=int(bank.f_cap)),
            rig={f: bd.to_cpu(getattr(rig, f)) for f in RIG_FIELDS},
            params={f: getattr(p, f).cpu() for f in apose.PoseParams.__dataclass_fields__},
            out=pk.cpu())
        a, nj = p.count, rig.parent.shape[0]
        r = dict(avatars=a, joints=nj, bit_equal_to_twin=bool(cs.same_bits(pk, pp)),
                 max_abs_err=cs.max_err(pk, pp))
        if time_it:
            r.update(**cs.bound(a * nj * 4 * 28 + a * 500 + nj * 100 + 3 * a * nj * 64,
                                a * nj * 600),
                     plain_ms=cs.median_ms(lambda: kz.pose_plain(bank, rig, p), reps=5),
                     ms=cs.median_ms(lambda: kz.pose(bank, rig, p)),
                     library_ms=cs.median_ms(lambda: cs._fk_library(local, rig, p.root)),
                     **cs.split_cost(lambda: kz.pose(bank, rig, p)))
        return r

    sc = benchworld.terrain_world("cuda", res=129, n_burst=0, n_stream=0, n_avatars=64)
    g = sc.graphics
    _, _, kern = g._rig()
    bank, rig = kern.bank, kern.rig
    moments = {}
    for frame in range(121):
        benchworld.move_avatars(sc, frame * bd.DT)
        for av in sc.avatars:
            g.update_avatar(av, bd.DT)
        if frame % 60 == 0:
            moments[f"walk_frame_{frame}"] = g.pack_all()[2]
    moments["all_options_64"] = cs._random_pose_arrays(64, 3, len(bank.names))
    pad = apose.zero_pose_arrays(64)
    part = cs._random_pose_arrays(37, 4, len(bank.names))
    for k in pad:
        pad[k][:37] = part[k]
    moments["padded_37"] = pad
    for what, arr in moments.items():
        p = apose.pose_params_from_arrays(arr, device="cuda")
        timed = what == "walk_frame_60"
        out[f"kz_{what}"] = kz_entry(what, bank, rig, p, timed,
                                     kz.pose_plain(bank, rig, p)[0] if timed else None)
    cs.log("# kz " + json.dumps({k: v for k, v in out.items() if k.startswith("kz_")}))
    out["kz_hard_cases"] = {}
    for case in hc.POSE_CASES:
        out["kz_hard_cases"][case] = kz_entry(f"hard_{case}",
                                              *hc.pose_inputs(hc.pose_scene(case), "cuda"),
                                              False)
    cs.log(f"# kz hard {json.dumps(out['kz_hard_cases'])}")

    bd.save_cases(saved, "ko_kz", args.tag)
    if args.against:
        ref = bd.load_cases("ko_kz", args.against)
        diffs = {}
        for key, s in ref.items():
            if key.startswith("ko_"):
                a = bd.to_cuda(s["args"])
                lib = HullLibrary(**{f: t.cuda() for f, t in s["hulls"].items()})
                d = bd.row_diffs(KO_OUTPUTS, ko.convex_rows(*a, lib), s["out"])
            else:
                bank = type("Bank", (), {k: bd.to_cuda(v) for k, v in s["bank"].items()})
                rig = kz.Rig(**{k: bd.to_cuda(v) for k, v in s["rig"].items()})
                p = apose.PoseParams(**{k: v.cuda() for k, v in s["params"].items()})
                d = bd.row_diffs(("pose",), (kz.pose(bank, rig, p).reshape(-1, 16),),
                                 (s["out"].reshape(-1, 16),))
            if d:
                diffs[key] = d
        out["against"] = dict(tag=args.against, cases=len(ref), differing=diffs)
        cs.log(f"# against {args.against}: {json.dumps(out['against'])}")


if __name__ == "__main__":
    sys.exit(main())

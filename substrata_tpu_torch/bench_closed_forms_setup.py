#!/usr/bin/env python3
"""The closed forms (KK) and the mix's per-source setup (KAA's setup) on
the card, for the port found under ``--root`` (default: this checkout).

KK, a step's closed-form buckets in one call where the port has
``closed_forms.closed_form_buckets`` and one ``closed_form_rows`` call per
bucket where it has not, each case first held against its twin
(``closed_form_rows_plain`` per bucket: points, normals and depths within
1e-5 on the valid rows, masks, ids, keys and touching exact):

- ``serving``: the serving world (chip_smoke phase 10's: the bench world's
  10,240 slots and a walking player) after 60 serving ticks, on the
  buckets of the pair list its next step hands ``pair_contacts`` (captured
  inside that step);
- ``mesh``: the mesh world (phase 12's: 12,000 objects, 512 hulls and the
  player) after 60 frames, captured the same way;
- ``fulltick``: the full tick's world (phase 9's) holds boxes only, one
  combo: its step has no closed-form bucket, which the case records;
- ``random_<code>``: phase 10's 4,096 seeded random pairs of each code
  (90% occupied, every pair distinct), pair-blocked at width 4;
- every ``hard_cases.CLOSED_FORM_CASES`` scene, checked, not timed.

KAA's setup (``audio_setup.audio_setup``), each case first held against
its twin (chip_smoke's ``_kaa_compare`` rules: exact, the pan's cos and
sin within 1e-6 of scale, an HRIR bin only on a half-integer edge):

- ``client_hrtf``, ``client_pan``: the client world's 512 sources after
  31 frames (phase 19's world), HRTF on and off;
- ``s1024``: ``hard_cases.audio_setup_scene("s1024")``, HRTF on;
- every ``hard_cases.AUDIO_SETUP_CASES`` scene, HRTF on and off, checked,
  not timed.

Every case's inputs and outputs are saved to chiprun_out/kk_kaa_<tag>.pt;
with ``--against TAG`` the run loads that file, runs its own kernels on the
saved inputs and lists every output that differs from the saved one, bit
for bit, with the rows (KK) or words (KAA) at fault and their codes (a
parent's run, then the change's with ``--against parent``).

For the timed cases: ms per call (CUDA events, ``chip_smoke.median_ms``),
device µs per call and per launch (``chip_smoke.split_cost``), the host's
cost per call (``chip_smoke.host_cost``) and the bound
(``chip_smoke.bound``).  Then phases 9 (180 full ticks), 11 (180 serving
ticks), 13 (180 mesh frames) and 19 (180 client frames) unless
``--no-ticks`` (``--phases`` picks some of them); ``--ticks-only`` runs
those phases alone.  Run parent, change, change, parent in one call:

    python3 substrata_tpu_torch/bench_closed_forms_setup.py [--root DIR] [--tag NAME]
        [--against TAG] [--no-ticks | --ticks-only]
        [--phases full_tick,serving,mesh,client]

The helpers come from this checkout (``bench_driver.py``), the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_closed_forms_setup_<tag>.json.
"""

from __future__ import annotations

import json
import sys
import tempfile

import bench_driver as bd

KK_OUTPUTS = ("a", "b", "point", "normal", "pen", "valid", "friction", "restitution", "key",
              "touching")
KK_FLOATS = (2, 3, 4)
BODY_ROWS = ("pos", "quat", "shape_params", "friction", "restitution", "is_sensor")
TICK_PHASES = ("full_tick", "serving", "mesh", "client")
DT = bd.DT


def _joined(buckets):
    """Saved buckets [(code, ba, bb, bvalid)] on the card as views of one
    array each for ba, bb and bvalid, in bucket order (as KT's grouping
    lays a step's buckets out, and KK's one launch reads them)."""
    import torch
    sizes = [b[1].shape[0] for b in buckets]
    ba, bb, bv = (torch.cat([b[i] for b in buckets]).cuda().split(sizes) for i in (1, 2, 3))
    return [(b[0], *x) for b, *x in zip(buckets, ba, bb, bv)]


def _written(buf, s, nl):
    """The bytes of a KAA setup buffer that the setup writes: every word
    but the flag word block's second half (its bytes [2S, 4S) are never
    written)."""
    import torch
    return buf.view(torch.uint8)[:4 * (nl + 8) * s + 2 * s]


def main():
    args, cs = bd.start("bench_closed_forms_setup", against=True, ticks=TICK_PHASES)
    import torch
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.kernels import audio_setup as kaa
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import closed_forms as kk
    from substrata_tpu_torch.physics import narrowphase
    bd.check_root(kk, args.root)
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    one_call = hasattr(kk, "closed_form_buckets")
    out = dict(bd.header(args, cs), kk_one_call=one_call)
    if not args.ticks_only:
        _kernel_cases(args, cs, bd.hard_cases(), out, one_call, torch, benchworld, kaa, kk,
                      narrowphase)
    if not args.no_ticks:
        bd.ticks(cs, out, args.phases.split(","),
                 {"kk": "closed_form_rows", "kaa": "audio_setup"})
    return bd.finish("bench_closed_forms_setup", out, args.tag)


def _kernel_cases(args, cs, hc, out, one_call, torch, benchworld, kaa, kk, narrowphase):
    """KK's and KAA's setup's cases, timed and checked, saved for
    ``--against``, and the comparison with a saved run."""
    saved = {}

    def kk_step(buckets, wms, blocked, rows):
        """A step's closed-form buckets: [10 outputs] per bucket."""
        if one_call:
            return kk.closed_form_buckets(buckets, tuple(wms), blocked, *rows)
        return [kk.closed_form_rows(c, wm, blocked, *rows, ba, bb, bv)
                for (c, ba, bb, bv), wm in zip(buckets, wms)]

    def kk_plain(buckets, wms, blocked, rows):
        return [kk.closed_form_rows_plain(c, wm, blocked, *rows, ba, bb, bv)
                for (c, ba, bb, bv), wm in zip(buckets, wms)]

    def kk_check(buckets, got, want, name):
        err = 0.0
        for (code, *_), g, w in zip(buckets, got, want):
            for i, oname in enumerate(KK_OUTPUTS):
                if i in KK_FLOATS:
                    err = max(err, cs.max_err(g[i], w[i], w[5]))
                else:
                    cs.check(torch.equal(g[i], w[i]),
                             f"KK {name} code {code}: {oname} differs from its twin's")
        cs.check(err <= 1e-5, f"KK {name}: max abs err {err} > 1e-5")
        return err

    def kk_entry(name, buckets, wms, blocked, rows, time_it):
        got = kk_step(buckets, wms, blocked, rows)
        want = kk_plain(buckets, wms, blocked, rows)
        err = kk_check(buckets, got, want, name)
        twin_bits = sum(int(cs.same_bits(x, y)) for g, w in zip(got, want)
                        for x, y in zip(g, w))
        saved[f"kk_{name}"] = dict(
            buckets=[(c, ba.cpu(), bb.cpu(), bv.cpu()) for c, ba, bb, bv in buckets],
            wms=tuple(wms), blocked=blocked, rows=[t.cpu() for t in rows],
            out=[[t.cpu() for t in g] for g in got])
        r = dict(buckets=[(c, int(ba.shape[0]), int(bv.sum())) for c, ba, _, bv in buckets],
                 distinct_pairs=[int(torch.unique(ba.long() * (1 << 32) + bb.long()).numel())
                                 for _, ba, bb, _ in buckets],
                 max_abs_err=err, outputs_bit_equal_to_twin=twin_bits,
                 outputs=10 * len(buckets), touching=sum(int(g[9].sum()) for g in got))
        if time_it:
            calls = [((c, wm, blocked, *rows, ba, bb, bv), g)
                     for (c, ba, bb, bv), wm, g in zip(buckets, wms, got)]
            ops = sum(int(bv.sum()) * (cs.FLOPS["capsule_box"] if c in (6, 9)
                                       else cs.FLOPS["point_contact"])
                      for c, _, _, bv in buckets)
            r.update(**cs.bound(cs._kk_bytes(calls), ops),
                     plain_ms=cs.median_ms(lambda: kk_plain(buckets, wms, blocked, rows),
                                           reps=3),
                     ms=cs.median_ms(lambda: kk_step(buckets, wms, blocked, rows)),
                     **cs.split_cost(lambda: kk_step(buckets, wms, blocked, rows)))
        return r

    def captured_step(run):
        """The closed-form buckets of the pair list that ``run()`` hands
        ``pair_contacts`` and the bodies' rows, taken inside that call."""
        got = []
        real = narrowphase.pair_contacts

        def capture(body, pair_a, pair_b, pair_valid, config, hulls=None, blocked_wm=0):
            groups = narrowphase.buckets(body, pair_a, pair_b, pair_valid, config)[0]
            buckets = [(c, ba, bb, bv) for c, _, ba, bb, bv in groups if c in kk.CODES]
            wms = [blocked_wm or narrowphase._MANIFOLD_WIDTH[c] for c, *_ in buckets]
            got.append((buckets, wms, bool(blocked_wm),
                        tuple(getattr(body, f).clone() for f in BODY_ROWS)))
            return real(body, pair_a, pair_b, pair_valid, config, hulls=hulls,
                        blocked_wm=blocked_wm)
        narrowphase.pair_contacts = capture
        try:
            run()
        finally:
            narrowphase.pair_contacts = real
        cs.check(len(got) == 1, f"{len(got)} pair_contacts calls in a step")
        return got[0]

    # --- KK on the serving world, the mesh world and the full tick's.
    sw, player = benchworld.serving_world("cuda")
    for t in range(60):
        benchworld.serving_tick(sw, player, t * DT)
    step = captured_step(lambda: benchworld.serving_tick(sw, player, 60 * DT))
    out["kk_serving"] = kk_entry("serving", *step, True)
    cs.log(f"# kk serving {json.dumps(out['kk_serving'])}")
    del sw, player, step

    mw, mp, msrc = benchworld.mesh_world("cuda")
    for t in range(60):
        benchworld.mesh_tick(mw, mp, t * DT, msrc)
    step = captured_step(lambda: benchworld.mesh_tick(mw, mp, 60 * DT, msrc))
    out["kk_mesh"] = kk_entry("mesh", *step, True)
    cs.log(f"# kk mesh {json.dumps(out['kk_mesh'])}")
    del mw, mp, msrc, step

    fw = benchworld.bench_world("cuda")
    fw._flush()
    codes = narrowphase._active_codes(fw.config)
    out["kk_fulltick"] = dict(active_codes=codes,
                              closed_form_buckets=[c for c in codes if c in kk.CODES])
    del fw

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    n = 4096
    ba = torch.arange(n, dtype=torch.int32, device="cuda")
    for code in kk.CODES:
        pos, quat, prm, fr, re, sens = cs._random_pair_rows(gen, code, n, "cuda")
        bv = torch.rand(n, generator=gen, device="cuda") < 0.9
        out[f"kk_random_{code}"] = kk_entry(f"random_{code}", [(code, ba, ba + n, bv)], [4],
                                            True, (pos, quat, prm, fr, re, sens), True)
    cs.log(f"# kk random {json.dumps({k: v for k, v in out.items() if 'random' in k})}")
    out["kk_hard_cases"] = {}
    for case in getattr(hc, "CLOSED_FORM_CASES", ()):
        a = hc.closed_form_inputs(hc.closed_form_scene(case), "cuda")
        out["kk_hard_cases"][case] = kk_entry(f"hard_{case}", *a[:3], a[3:], False)

    # --- KAA's setup.
    def kaa_entry(name, src_args, time_it):
        s, nl = src_args[6].shape
        use_hrtf = src_args[20]
        bk, bp = kaa.audio_setup(*src_args), kaa.audio_setup_plain(*src_args)
        vk, vp = kaa.setup_views(bk, s, nl), kaa.setup_views(bp, s, nl)
        for f in ("active", "use_lp", "eff_delta", "dop_smooth", "mute", "gain", "alpha",
                  "send_gain") + (("gl", "gr") if use_hrtf else ()):
            cs.check(cs.same_bits(vk[f], vp[f]), f"KAA {name}: {f} differs from its twin's")
        err = 0.0 if use_hrtf else max(cs._scaled_err(vk["gl"], vp["gl"]),
                                       cs._scaled_err(vk["gr"], vp["gr"]))
        cs.check(err <= 1e-6, f"KAA {name}: gains {err} of scale > 1e-6")
        moved = int((vk["dir_idx"] != vp["dir_idx"]).sum())
        saved[f"kaa_{name}"] = dict(args=[x.cpu() if isinstance(x, torch.Tensor) else x
                                          for x in src_args], out=bk.cpu())
        r = dict(sources=s, layers=nl, use_hrtf=use_hrtf, max_err_of_scale=err,
                 hrir_bins_moved_vs_twin=moved,
                 bytes_equal_to_twin=int((_written(bk, s, nl) == _written(bp, s, nl)).sum()),
                 bytes_written=int(_written(bk, s, nl).numel()))
        if time_it:
            r.update(**cs.bound(cs.nbytes(src_args[:18], _written(bk, s, nl)),
                                cs.FLOPS["audio_setup"] * s),
                     plain_ms=cs.median_ms(lambda: kaa.audio_setup_plain(*src_args), reps=5),
                     ms=cs.median_ms(lambda: kaa.audio_setup(*src_args)),
                     **cs.split_cost(lambda: kaa.audio_setup(*src_args)))
        return r

    with tempfile.TemporaryDirectory(prefix="client_world_") as sounds:
        sc = benchworld.client_world("cuda", sound_dir=sounds)
        for f in range(31):
            benchworld.client_tick(sc, f)
        eng = sc.app.audio
        src, lis = eng.sources, eng.listener
        for hrtf in (True, False):
            kargs = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                          for x in cs._kaa_args(src, lis, 256, hrtf))
            key = f"client_{'hrtf' if hrtf else 'pan'}"
            out[f"kaa_{key}"] = kaa_entry(key, kargs, True)
            cs.log(f"# kaa {key} {json.dumps(out[f'kaa_{key}'])}")
        del sc, eng, src, lis
    big = hc.audio_setup_scene("s1024")
    out["kaa_s1024"] = kaa_entry("s1024", hc.audio_setup_inputs(big, "cuda", True), True)
    cs.log(f"# kaa s1024 {json.dumps(out['kaa_s1024'])}")
    out["kaa_hard_cases"] = {}
    for case in getattr(hc, "AUDIO_SETUP_CASES", ()):
        scene = hc.audio_setup_scene(case)
        for hrtf in (True, False):
            key = f"{case}_{'hrtf' if hrtf else 'pan'}"
            out["kaa_hard_cases"][key] = kaa_entry(
                f"hard_{key}", hc.audio_setup_inputs(scene, "cuda", hrtf), False)

    bd.save_cases(saved, "kk_kaa", args.tag)
    if args.against:
        ref = bd.load_cases("kk_kaa", args.against)
        diffs = {}
        for key, s in ref.items():
            if key.startswith("kk_"):
                buckets = _joined(s["buckets"])
                got = kk_step(buckets, s["wms"], s["blocked"], [t.cuda() for t in s["rows"]])
                d = [x for (code, *_), g, w in zip(buckets, got, s["out"])
                     for x in bd.row_diffs(KK_OUTPUTS, g, w, code=code)]
            else:
                a = [x.cuda() if isinstance(x, torch.Tensor) else x for x in s["args"]]
                ns, nl = a[6].shape
                ne = _written(kaa.audio_setup(*a), ns, nl).cpu() != _written(s["out"], ns, nl)
                d = [dict(bytes=int(ne.sum()), first_words=(ne.nonzero()[:8, 0] // 4).tolist())] \
                    if bool(ne.any()) else []
            if d:
                diffs[key] = d
        out["against"] = dict(tag=args.against, cases=len(ref), differing=diffs)
        cs.log(f"# against {args.against}: {json.dumps(out['against'])}")


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""KT's contact compaction and the mix's per-source epilogue (KAA's
launch on a parent port, folded into KF's source blocks on a port whose
``audio_spatialise`` takes ``epilogue``) on the card, for the port found
under ``--root`` (default: this checkout).

KT's compaction, each case held against its twin (every field and the
overflow, bit for bit):

- ``serving``: the compaction of the serving world's step after 60
  serving ticks (chip_smoke phase 11's world), its arguments captured
  inside that step;
- every ``hard_cases.COMPACT_CASES`` scene, ``capacity`` (the 65,536-body
  tier's 196,608 rows into 16,383) among them.

The epilogue, each case held against ``audio_spatialise_plain`` and
``audio_epilogue_plain`` (KF's outputs within 1e-5, the epilogue's
fields exact, NaN where the twin's is):

- ``bench``: bench.py's 256 sources after 30 blocks of 800 frames with
  the room (chip_smoke phases 3 and 18's scene), one ``mix_block``;
- ``client``: the client world's 512 source slots after 31 frames
  (phase 19's world), one 256-frame ``mix_block`` as its engine mixes;
- every ``hard_cases.EPILOGUE_CASES`` scene: KF and the epilogue alone.

For ``bench`` and ``client`` the timed call is the whole ``mix_block``:
its device work by kernel (``split``: KF's and, on a parent, the
epilogue's own launch), launches a block and the host's µs a block.
Every case is timed: ms per call (CUDA events, ``chip_smoke.median_ms``),
device µs per call and per launch and launches a call
(``chip_smoke.split_cost``), the host's cost per call, the twin's ms and
the bound (``chip_smoke.bound``; the compaction's bytes by
``chip_smoke.compact_bytes``).  Every case's inputs and outputs are
saved to chiprun_out/kt_epilogue_<tag>.pt; with ``--against TAG`` the
run loads that file, runs its own kernels on the saved inputs and lists
every output that differs from the saved one, bit for bit (the parent's
run first, in the same call; remove the files after).  Then phase 11
(180 serving ticks) and phase 9 (180 full ticks) unless ``--no-ticks``;
``--ticks-only`` runs those phases alone.  Run parent, change, change,
parent in one call:

    python3 substrata_tpu_torch/bench_compact_epilogue.py [--root DIR] [--tag NAME]
        [--against TAG] [--no-ticks | --ticks-only] [--phases serving,full_tick]

The helpers come from this checkout (``bench_driver.py``), the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_compact_epilogue_<tag>.json.
"""

from __future__ import annotations

import inspect
import json
import sys
import tempfile

import bench_driver as bd

TICK_PHASES = ("serving", "full_tick")
DEV = "cuda"          # a CPU rehearsal of the cases sets "cpu" (the twins run)
EPILOGUE_OUT = ("smoothed_level", "finished", "alive")
MIX_FIELDS = ("playhead", "finished", "mute_factor", "doppler_factor", "lp_state",
              "prev_gain_l", "prev_gain_r", "smoothed_level", "hrir_hist", "alive")


def main():
    args, cs = bd.start("bench_compact_epilogue", against=True, ticks=TICK_PHASES)
    import torch
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import layout as kt
    bd.check_root(kt, args.root)
    out = bd.header(args, cs)
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not args.ticks_only:
        _kernel_cases(args, cs, bd.hard_cases(), out, torch, kt)
    if not args.no_ticks:
        bd.ticks(cs, out, args.phases.split(","),
                 {"kt_compact": "layout_compact", "kf": "audio_spatialise"})
    return bd.finish("bench_compact_epilogue", out, args.tag)


def _kernel_cases(args, cs, hc, out, torch, kt):
    """The compaction's and the epilogue's cases, timed and checked, saved
    for ``--against``, and the comparison with a saved run."""
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.kernels import audio_mix as ka
    from substrata_tpu_torch.kernels import audio_setup as kaa
    folded = "epilogue" in inspect.signature(ka.audio_spatialise).parameters
    views = ka.epilogue_views if folded else kaa.epilogue_views
    e_plain = ka.audio_epilogue_plain if folded else kaa.audio_epilogue_plain
    out["epilogue_folded_into_kf"] = folded
    saved = {}

    def kf_epilogue(sargs, epi):
        """KF and the epilogue as this port runs them."""
        if folded:
            return ka.audio_spatialise(*sargs, epi)
        f = ka.audio_spatialise(*sargs)
        return f + (kaa.audio_epilogue(*epi[:6], f[5], *epi[6:]),)

    def kf_outputs(got):
        """KF's six outputs and the epilogue's three fields (the buffer's
        other bytes are never written)."""
        v = views(got[6], got[5].shape[0])
        return tuple(got[:6]) + tuple(v[f] for f in EPILOGUE_OUT)

    def kf_epilogue_plain(sargs, epi):
        if folded:
            return ka.audio_spatialise_plain(*sargs, epi)
        f = ka.audio_spatialise_plain(*sargs)
        return f + (e_plain(*epi[:6], f[5], *epi[6:]),)

    def kt_entry(name, rows, m):
        got, ov = kt.compact(rows, m)
        want, ov_p = kt.compact_plain(rows, m)
        apart = [f for f, x, y in zip(hc.COMPACT_FIELDS, got, want) if not cs.same_words(x, y)]
        if int(ov) != int(ov_p):
            apart.append("overflow")
        saved[f"kt_{name}"] = dict(rows=_own(rows), m=m, out=_own(tuple(got) + (ov,)))
        valid = rows[5]
        r = dict(rows=int(valid.shape[0]), max_active=m, valid=int(valid.sum()),
                 overflow=int(ov_p), outputs_apart_from_twin=apart,
                 **cs.bound(cs.compact_bytes(rows, m), 0),
                 plain_ms=cs.median_ms(lambda: kt.compact_plain(rows, m), reps=5),
                 ms=cs.median_ms(lambda: kt.compact(rows, m)),
                 **cs.split_cost(lambda: kt.compact(rows, m)))
        cs.log(f"# kt {name} {json.dumps(r)}")
        return r

    def ep_entry(name, sargs, epi):
        got, want = kf_epilogue(sargs, epi), kf_epilogue_plain(sargs, epi)
        s = got[5].shape[0]
        kf_err = max(cs.max_err(x, y) for x, y in zip(got[:6], want[:6]) if y is not None)
        ek, ep = views(got[6], s), views(want[6], s)
        apart = [f for f in ("smoothed_level", "finished", "alive")
                 if not cs.same_bits(ek[f], ep[f])]
        saved[f"ep_{name}"] = dict(sargs=_own(sargs), epi=_own(epi),
                                   out=_own(kf_outputs(got)))
        r = dict(sources=s, frames=int(sargs[0].shape[1]), kf_max_abs_err=kf_err,
                 epilogue_apart_from_twin=apart, finished=int(ep["finished"].sum()),
                 alive=int(ep["alive"].sum()),
                 plain_ms=cs.median_ms(lambda: kf_epilogue_plain(sargs, epi), reps=3),
                 ms=cs.median_ms(lambda: kf_epilogue(sargs, epi)),
                 **cs.split_cost(lambda: kf_epilogue(sargs, epi)))
        cs.log(f"# epilogue {name} {json.dumps(r)}")
        return r

    def mix_entry(name, src, pool, lis, room, block):
        """One mix_block: checked through KF and the epilogue on its own
        inputs, its outputs saved, then timed whole."""
        setup = mix.prepare(src, lis, block, block / mix.ENGINE_RATE, True)
        samples, heads = mix.fetch(pool, src, setup.eff_delta, setup.active, block)
        sargs = (samples, src.lp_state, setup.alpha, setup.use_lp, src.spatial, src.hrir_hist,
                 mix.hrir_bank_tensor(DEV), setup.dir_idx, src.prev_gain_l,
                 src.prev_gain_r, setup.gl, setup.gr, mix.gain_ramp(block, DEV), setup.gain,
                 setup.send_gain if room is not None else None, True)
        epi = (src.finished, src.looping, src.stream_mode, setup.active, heads, src.buf_len,
               src.smoothed_level, src.alive, src.remove_on_finish)
        r = dict(kf_epilogue=ep_entry(name, sargs, epi))

        def block_call():
            return mix.mix_block(src, pool, lis, room=room, use_hrtf=True, block=block)
        res = block_call()
        saved[f"mix_{name}"] = dict(src=_fields(src), pool=pool.cpu(), lis=_fields(lis),
                                    room=_fields(room), block=block,
                                    out=_own(_mix_outputs(res)))
        r.update(ms=cs.median_ms(block_call), **cs.split_cost(block_call))
        cs.log(f"# mix {name} {json.dumps(r)}")
        return r

    # KT's compaction.
    sw, player = benchworld.serving_world(DEV)
    for t in range(60):
        benchworld.serving_tick(sw, player, t * bd.DT)
    got = bd.captured(kt, "compact", lambda: benchworld.serving_tick(sw, player, 60 * bd.DT))
    cs.check(len(got) == 1, f"{len(got)} compactions in a serving step")
    rows, m = got[0][0]
    out["kt_serving"] = kt_entry("serving", rows, m)
    del sw, player
    out["kt_hard_cases"] = {}
    for case in hc.COMPACT_CASES:
        crows, cm = hc.compact_inputs(hc.compact_scene(case), DEV)
        out["kt_hard_cases"][case] = kt_entry(f"hard_{case}", crows, cm)

    # The epilogue: bench.py's 256 sources, the client world's 512 slots.
    w = benchworld.bench_world(DEV)
    src, pool, lis, room = benchworld.bench_audio(DEV)
    idx = torch.arange(src.capacity, device=DEV)
    src = src.replace(pos=w.state.pos[idx], vel=w.state.linvel[idx])
    del w
    for _ in range(30):
        src, _, room = mix.mix_block(src, pool, lis, room=room, use_hrtf=True,
                                     block=benchworld.TICK_FRAMES)
    out["mix_bench"] = mix_entry("bench", src, pool, lis, room, benchworld.TICK_FRAMES)
    with tempfile.TemporaryDirectory(prefix="client_world_") as sounds:
        sc = benchworld.client_world(DEV, sound_dir=sounds)
        for f in range(31):
            benchworld.client_tick(sc, f)
        eng = sc.app.audio
        out["mix_client"] = mix_entry("client", eng.sources, eng.pool, eng.listener, eng.room,
                                      mix.BLOCK)
        del sc, eng
    out["epilogue_hard_cases"] = {}
    for case in hc.EPILOGUE_CASES:
        sargs, epi = hc.epilogue_inputs(hc.epilogue_scene(case), DEV)
        out["epilogue_hard_cases"][case] = ep_entry(f"hard_{case}", sargs, epi)

    bd.save_cases(saved, "kt_epilogue", args.tag)
    if args.against:
        ref = bd.load_cases("kt_epilogue", args.against)
        diffs = {}
        for key, sv in ref.items():
            if key.startswith("kt_"):
                g, ov = kt.compact(bd.to_cuda(sv["rows"]), sv["m"])
                d = bd.row_diffs(hc.COMPACT_FIELDS + ("overflow",), tuple(g) + (ov,), sv["out"])
            elif key.startswith("ep_"):
                got = kf_outputs(kf_epilogue(bd.to_cuda(sv["sargs"]), bd.to_cuda(sv["epi"])))
                names = ("wl", "wr", "ws", "lp_out", "new_hist", "level") + EPILOGUE_OUT
                kept = [(n, g, w) for n, g, w in zip(names, got, sv["out"]) if w is not None]
                d = bd.row_diffs(*zip(*kept))
            else:
                room = sv["room"] and mix.RoomState(**bd.to_cuda(sv["room"]))
                res = mix.mix_block(mix.SourceState(**bd.to_cuda(sv["src"])),
                                    bd.to_cuda(sv["pool"]), mix.Listener(**bd.to_cuda(sv["lis"])),
                                    room=room, use_hrtf=True, block=sv["block"])
                d = bd.row_diffs(MIX_FIELDS + ("out",), _mix_outputs(res), sv["out"])
            if d:
                diffs[key] = d
        out["against"] = dict(tag=args.against, cases=len(ref), differing=diffs)
        cs.log(f"# against {args.against}: {json.dumps(out['against'])}")


def _own(outs):
    """Tensors on the CPU, each its own (a call's outputs, and KAA's
    fields, are views of one buffer in several dtypes, which torch.save
    refuses)."""
    return bd.clone(bd.to_cpu(outs))


def _fields(state):
    """A state dataclass as {field: CPU tensor} (None stays None): the saved
    file is loaded with torch.load's default weights_only."""
    if state is None:
        return None
    import dataclasses
    return {f.name: _own(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _mix_outputs(res):
    """A mix_block's new source fields (MIX_FIELDS) and its stereo block."""
    src, block_out = res[0], res[1]
    return tuple(getattr(src, f) for f in MIX_FIELDS) + (block_out,)


if __name__ == "__main__":
    sys.exit(main())

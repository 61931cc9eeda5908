#!/usr/bin/env python3
"""KM (the serving tick's input apply) and the mix's fetch (KE's launch on
a parent port, folded into KF's source blocks on a port whose
``audio_spatialise`` takes the fetch's arguments) on the card, for the
port found under ``--root`` (default: this checkout).

KM, each case held against its twin (every output word for word):

- ``bench``: chip_smoke phase 10's input on the serving world after 121
  serving ticks (10,240 slots, 128 writes, 64 real regions);
- ``serving_input``: a serving tick's input on the same state (4 writes,
  one real region, the rest padded);
- every ``hard_cases.TICK_IN_CASES`` scene (``n65536``: the capacity
  tier).

The fetch and KF, each case held against the twins chained
(``audio_fetch_plain`` into ``audio_spatialise_plain``; every output and
the new playheads to the bit, NaN where the twin's is):

- ``bench``: bench.py's 256 sources after 30 blocks of 800 frames with
  the room (chip_smoke phase 6's scene), one ``mix_block``;
- ``client``: the client world's 512 source slots after 31 frames
  (phase 19's world), one 256-frame ``mix_block`` as its engine mixes;
- every ``hard_cases.FETCH_CASES`` scene, and the ``SPATIALISE_CASES`` and
  ``EPILOGUE_CASES`` scenes fed through a fetch (``spatialise_fed``,
  ``epilogue_fed``): the fetch and KF alone.

For ``bench`` and ``client`` the timed call is the whole ``mix_block``:
its device work by kernel (``split``: KF's and, on a parent, KE's own
launch), launches a block, and the host's µs a block as the median and
interquartile range of 400 blocks each timed alone (``host_blocks``).
Each KM case also counts the bodies whose region wake the plain sum of
the three squares would decide otherwise (``plain_sum_differs``: the
region test's repair).  Every case is timed: ms per call (CUDA
events, ``chip_smoke.median_ms``), device µs per call and per launch and
launches a call (``chip_smoke.split_cost``), the host's cost per call,
the twins' ms and the bound (``chip_smoke.bound``).  Every case's inputs
and outputs are saved to chiprun_out/km_fetch_<tag>.pt; with ``--against
TAG`` the run loads that file, runs its own kernels on the saved inputs
and lists every output that differs from the saved one, bit for bit (the
parent's run first, in the same call; remove the files after).  Then
phase 11 (180 serving ticks) and phase 9 (180 full ticks) unless
``--no-ticks``; ``--ticks-only`` runs those phases alone.  Run parent,
change, change, parent in one call:

    python3 substrata_tpu_torch/bench_tickin_fetch.py [--root DIR] [--tag NAME]
        [--against TAG] [--no-ticks | --ticks-only] [--phases serving,full_tick]

The parent is compared with the region test's repair applied to its KM
(the jitted reference's fma chain in its twin and its kernel), so that
the comparison measures the design: ``--repair-parent DIR`` makes that
edit in the port under DIR (an unpacked parent) and exits.

The helpers come from this checkout (``bench_driver.py``), the port from
``--root``.  Prints one JSON line, with the card's name and power limit,
and writes it to chiprun_out/bench_tickin_fetch_<tag>.json.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import bench_driver as bd

TICK_PHASES = ("serving", "full_tick")
DEV = "cuda"          # a CPU rehearsal of the cases sets "cpu" (the twins run)
HOST_BLOCKS = 400
EPILOGUE_OUT = ("smoothed_level", "finished", "alive")
KF_OUT = ("wl", "wr", "ws", "lp_out", "new_hist", "level") + EPILOGUE_OUT + ("new_playhead",)
MIX_FIELDS = ("playhead", "finished", "mute_factor", "doppler_factor", "lp_state",
              "prev_gain_l", "prev_gain_r", "smoothed_level", "hrir_hist", "alive")
# The region test's repair, as it reads in a parent port and after it.
REPAIR = {
    "substrata_tpu_torch/kernels/serving_io.py": (
        "    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]\n",
        "    d2 = fma(d[..., 2], d[..., 2], fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))\n"),
    "substrata_tpu_torch/csrc/serving_io.cu": (
        "    const float dd = d0 * d0 + d1 * d1 + d2 * d2;\n",
        "    const float dd = __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, d0 * d0));\n"),
}
REPAIR_IMPORT = ("from substrata_tpu_torch.kernels.pairs import _compact as compact\n",
                 "from substrata_tpu_torch.kernels.pairs import _compact as compact\n"
                 "from substrata_tpu_torch.maths.fp import fma\n")


def repair_parent(root):
    """Apply the region test's repair to the parent port under ``root``;
    raises unless each edit's text is found exactly once."""
    for rel, (old, new) in REPAIR.items():
        path = os.path.join(root, rel)
        with open(path) as fh:
            text = fh.read()
        edits = [(old, new)] + ([REPAIR_IMPORT] if rel.endswith(".py") else [])
        for a, b in edits:
            if text.count(a) != 1:
                raise RuntimeError(f"{path}: the text to repair is not there once: {a!r}")
            text = text.replace(a, b)
        with open(path, "w") as fh:
            fh.write(text)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--repair-parent":
        repair_parent(os.path.abspath(sys.argv[2]))
        return 0
    args, cs = bd.start("bench_tickin_fetch", against=True, ticks=TICK_PHASES)
    import torch
    from substrata_tpu_torch import kernels
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import serving_io as km
    bd.check_root(km, args.root)
    out = bd.header(args, cs)
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not args.ticks_only:
        _kernel_cases(args, cs, bd.hard_cases(), out, torch, km)
    if not args.no_ticks:
        counters = {"km": "apply_tick_in", "kf": "audio_spatialise", "ke": "audio_fetch"}
        have = kernels.launch_counts()
        bd.ticks(cs, out, args.phases.split(","),
                 {k: c for k, c in counters.items() if c in have})
    return bd.finish("bench_tickin_fetch", out, args.tag)


def _kernel_cases(args, cs, hc, out, torch, km):
    """KM's and the fetch's cases, timed and checked, saved for
    ``--against``, and the comparison with a saved run."""
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.kernels import audio_mix as ka
    from substrata_tpu_torch.physics.state import BodyState
    folded = not hasattr(ka, "audio_fetch")
    out["fetch_folded_into_kf"] = folded
    saved = {}

    def kf(fetch, kargs, epi):
        """The fetch and KF as this port runs them: (KF's six outputs, the
        epilogue's buffer, the new playheads)."""
        if folded:
            return ka.audio_spatialise(fetch, *kargs, epilogue=epi)
        samples, heads = ka.audio_fetch(*fetch)
        return ka.audio_spatialise(samples, *kargs, _epilogue9(fetch, heads, epi)) + (heads,)

    def kf_plain(fetch, kargs, epi):
        samples, heads = ka.audio_fetch_plain(*fetch)
        return ka.audio_spatialise_plain(samples, *kargs,
                                         _epilogue9(fetch, heads, epi)) + (heads,)

    def kf_outputs(got):
        """KF's six outputs, the epilogue's three fields (the buffer's other
        bytes are never written) and the new playheads."""
        v = ka.epilogue_views(got[6], got[5].shape[0])
        return tuple(got[:6]) + tuple(v[f] for f in EPILOGUE_OUT) + (got[7],)

    def km_entry(name, st, tin, timed=True):
        got, want = km.apply_tick_in(st, tin), km.apply_tick_in_plain(st, tin)
        apart = [f for f, y in zip(km.STATE_OUT, want)
                 if not cs.same_words(getattr(got, f), y)]
        saved[f"km_{name}"] = dict(state=_fields(st), tin=tin.cpu(),
                                   out=_own(tuple(getattr(got, f) for f in km.STATE_OUT)))
        r = dict(bodies=st.capacity, outputs_apart_from_twin=apart,
                 newly_awake=int((want[4] & ~st.awake).sum()),
                 plain_sum_differs=_plain_sum_differs(torch, km, st, tin, want))
        if timed:
            def run():
                return km.apply_tick_in(st, tin)
            r.update(**cs.bound(cs.nbytes([getattr(st, f) for f in km.STATE_IN], tin, want),
                                st.capacity * (km.TIN_R * cs.FLOPS["region_test"] + km.TIN_K)),
                     plain_ms=cs.median_ms(lambda: km.apply_tick_in_plain(st, tin), reps=5),
                     ms=cs.median_ms(run), **cs.split_cost(run))
        cs.log(f"# km {name} {json.dumps(r)}")
        return r

    def kf_entry(name, fetch, kargs, epi, timed=True):
        got, want = kf_outputs(kf(fetch, kargs, epi)), kf_outputs(kf_plain(fetch, kargs, epi))
        apart = [n for n, x, y in zip(KF_OUT, got, want)
                 if not (x is None and y is None or cs.same_bits(x, y))]
        saved[f"kf_{name}"] = dict(fetch=_own(fetch), kargs=_own(kargs), epi=_own(epi),
                                   out=_own(got))
        r = dict(sources=int(kargs[0].shape[0]), frames=int(fetch[10]),
                 layers=int(fetch[3].shape[1]), layers_used=int((fetch[2] > 0).sum()),
                 max_abs_err=max(cs.max_err(x, y) for x, y in zip(got, want) if y is not None
                                 and x.is_floating_point()),
                 outputs_apart_from_twin=apart)
        if timed:
            def run():
                return kf(fetch, kargs, epi)
            r.update(plain_ms=cs.median_ms(lambda: kf_plain(fetch, kargs, epi), reps=3),
                     ms=cs.median_ms(run), **cs.split_cost(run))
        cs.log(f"# kf {name} {json.dumps(r)}")
        return r

    def mix_entry(name, src, pool, lis, room, block):
        """One mix_block: checked through the fetch and KF on its own
        inputs, its outputs saved, then timed whole."""
        st = mix.prepare(src, lis, block, block / mix.ENGINE_RATE, True)
        fetch = (pool, src.buf_offset, src.buf_len, src.playhead, st.eff_delta, src.mix_factor,
                 src.looping, src.stream_mode, src.stream_write_head, st.active, block,
                 mix.window_rows(block))
        kargs = (src.lp_state, st.alpha, st.use_lp, src.spatial, src.hrir_hist,
                 mix.hrir_bank_tensor(DEV), st.dir_idx, src.prev_gain_l, src.prev_gain_r,
                 st.gl, st.gr, mix.gain_ramp(block, DEV), st.gain,
                 st.send_gain if room is not None else None, True)
        epi = (src.finished, src.smoothed_level, src.alive, src.remove_on_finish)
        r = dict(kf=kf_entry(name, fetch, kargs, epi))

        def block_call():
            return mix.mix_block(src, pool, lis, room=room, use_hrtf=True, block=block)
        res = block_call()
        saved[f"mix_{name}"] = dict(src=_fields(src), pool=pool.cpu(), lis=_fields(lis),
                                    room=_fields(room), block=block,
                                    out=_own(_mix_outputs(res)))
        r.update(ms=cs.median_ms(block_call), **cs.split_cost(block_call),
                 host_blocks=_host_blocks(torch, block_call))
        cs.log(f"# mix {name} {json.dumps(r)}")
        return r

    # KM: the serving world after 121 ticks, phase 10's input and a serving
    # tick's; the hard cases.
    import numpy as np
    sw, player = benchworld.serving_world(DEV)
    sw._flush()
    for t in range(121):
        benchworld.serving_tick(sw, player, t * bd.DT)
    body = sw.state
    nb = body.capacity
    rng = np.random.default_rng(2)
    buf = km.empty_tick_in(nb)
    buf[km.O_IDX:km.O_POS].view(np.int32)[:] = rng.permutation(nb)[:km.TIN_K]
    buf[km.O_POS:km.O_VOK] = rng.normal(size=km.O_VOK - km.O_POS)
    buf[km.O_VOK:km.O_CTR] = rng.integers(0, 2, km.TIN_K)
    buf[km.O_CTR:km.O_RAD] = rng.uniform(-35, 35, 3 * km.TIN_R)
    buf[km.O_RAD:] = rng.uniform(0.2, 2.0, km.TIN_R)
    tick = km.empty_tick_in(nb)
    tick[km.O_IDX:km.O_IDX + 4].view(np.int32)[:] = rng.permutation(nb)[:4]
    tick[km.O_POS:km.O_POS + 12] = rng.normal(size=12)
    tick[km.O_ROT:km.O_ROT + 16] = 0.5
    tick[km.O_CTR:km.O_CTR + 3] = rng.uniform(-35, 35, 3)
    tick[km.O_RAD] = 1.5
    out["km_bench"] = km_entry("bench", body, torch.as_tensor(buf, device=DEV))
    out["km_serving_input"] = km_entry("serving_input", body, torch.as_tensor(tick, device=DEV))
    del sw, player, body
    out["km_hard_cases"] = {}
    for case in hc.TICK_IN_CASES:
        st, tin = hc.tick_in_inputs(hc.tick_in_scene(case), DEV)
        out["km_hard_cases"][case] = km_entry(f"hard_{case}", st, tin,
                                              timed=case in ("n65536", "all_padded", "n10240"))

    # The mix: bench.py's 256 sources, the client world's 512 slots.
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
    out["kf_hard_cases"] = {}
    scenes = [(f"fetch_{c}", hc.fetch_scene(c)) for c in hc.FETCH_CASES]
    scenes += [(f"spatialise_{c}", hc.spatialise_fed(c)) for c in hc.SPATIALISE_CASES]
    scenes += [(f"epilogue_{c}", hc.epilogue_fed(c)) for c in hc.EPILOGUE_CASES]
    for name, scene in scenes:
        a = hc.fetch_inputs(scene, DEV)
        out["kf_hard_cases"][name] = kf_entry(f"hard_{name}", a[0], a[1:-1], a[-1],
                                              timed=name in ("fetch_b800", "fetch_s512"))

    bd.save_cases(saved, "km_fetch", args.tag)
    if args.against:
        ref = bd.load_cases("km_fetch", args.against)
        diffs = {}
        for key, sv in ref.items():
            if key.startswith("km_"):
                st = BodyState(**bd.to_cuda(sv["state"]))
                got = km.apply_tick_in(st, bd.to_cuda(sv["tin"]))
                d = bd.row_diffs(km.STATE_OUT, tuple(getattr(got, f) for f in km.STATE_OUT),
                                 sv["out"])
            elif key.startswith("kf_"):
                got = kf_outputs(kf(bd.to_cuda(sv["fetch"]), bd.to_cuda(sv["kargs"]),
                                    bd.to_cuda(sv["epi"])))
                kept = [(n, g, w) for n, g, w in zip(KF_OUT, got, sv["out"]) if w is not None]
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


def _epilogue9(fetch, heads, epi):
    """The epilogue's nine fields (``audio_mix.EPILOGUE_NAMES``) from the
    fetch's flags and lengths, its new heads and the four of its own."""
    return (epi[0], fetch[6], fetch[7], fetch[9], heads, fetch[2], epi[1], epi[2], epi[3])


def _plain_sum_differs(torch, km, st, tin, twin):
    """Bodies whose region wake the plain sum of the three squares (each
    product rounded, as an eager reference call rounds them) decides
    otherwise than KM's twin (its outputs ``twin``), which rounds the
    squared distance as the jitted reference contracts it; written and
    already awake bodies apart."""
    d = twin[0][:, None, :] - tin[km.O_CTR:km.O_RAD].reshape(km.TIN_R, 3)[None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    r = tin[km.O_RAD:][None] + st.bound_radius[:, None] + 0.3
    plain = torch.any(d2 <= r * r, dim=1) & st.alive & st.dynamic
    idx = tin[km.O_IDX:km.O_POS].view(torch.int32).long()
    idx = torch.where(idx < 0, idx + st.capacity, idx)
    written = torch.zeros_like(plain)
    written[idx[(idx >= 0) & (idx < st.capacity)]] = True
    fused = twin[4] & ~(st.awake | written)
    return int(((plain & ~(st.awake | written)) != fused).sum())


def _host_blocks(torch, call, n=HOST_BLOCKS):
    """The host's µs of each of ``n`` calls, each timed alone (no
    synchronise between them): median and interquartile range."""
    import numpy as np
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return dict(n=n, median_us=float(med), q1_us=float(q1), q3_us=float(q3),
                iqr_us=float(q3 - q1))


def _own(outs):
    """Tensors on the CPU, each its own (a call's outputs are views of one
    buffer in several dtypes, which torch.save refuses)."""
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

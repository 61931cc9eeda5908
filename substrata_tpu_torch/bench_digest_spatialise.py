#!/usr/bin/env python3
"""The event digest (KN) and the spatialiser (KF) on the card, for the port
found under ``--root`` (default: this checkout).

KN (``serving_io.digest_tblock``), each case first held against its twin,
the digest and the transform block to the bit:

- ``bench_block`` and ``bench_digest``: the serving world (chip_smoke
  phase 10's: the bench world's 10,240 slots and 16,384 pair slots, a
  walking player) after 121 serving ticks, on the last step's events,
  with the transform block (the serving tick) and without it (``think``);
- ``capacity``: 65,536 bodies over grid 160 (``hard_cases.cell_bodies``'s
  lattice made into bodies by ``hard_cases.pair_world``, as
  bench_pairs_mix.py builds them), its 49,152 pair slots from KS's rebuild,
  every found pair touching and 1% of the bodies in each body event class
  (seeded), with the block.

KF (``audio_mix.audio_spatialise``) on phase 6's scene (bench.py's 256
sources on the bench world's bodies after 30 thinks, 30 mixed blocks of
the size timed, HRIR on, the room's send): 800 frames (the tick) and 256
(the client's render block), each first held against its twin on every
output (within 1e-5, and counted equal to the bit).

For each: ms per call (CUDA events, ``chip_smoke.median_ms``), device µs
per call and per launch by kernel name (``chip_smoke.launch_split``), the
host's cost per call (``chip_smoke.host_cost``) and the bound
(``chip_smoke.bound``).  Then phase 11 (180 serving ticks) and phase 19
(180 client frames) unless ``--no-ticks``.  Run parent, change, change,
parent in one call:

    python3 substrata_tpu_torch/bench_digest_spatialise.py [--root DIR] [--tag NAME] [--no-ticks]

The helpers come from this checkout, the port from ``--root``.  Prints one
JSON line, with the card's name and power limit, and writes it to
chiprun_out/bench_digest_spatialise_<tag>.json.
"""

from __future__ import annotations

import json
import sys

import bench_driver as bd

DT = bd.DT


def main():
    args, cs = bd.start("bench_digest_spatialise", flags=("--no-ticks",))
    root = args.root
    import numpy as np
    import torch
    from substrata_tpu_torch import benchworld, convert
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.audio.hrtf import hrir_bank_tensor
    from substrata_tpu_torch.kernels import audio_mix as ka
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import pairs as ks
    from substrata_tpu_torch.kernels import serving_io as km
    from substrata_tpu_torch.physics.state import SimConfig
    from substrata_tpu_torch.physics.step import StepEvents
    bd.check_root(km, root)
    hc = bd.hard_cases()
    build.build()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(tag=args.tag, root=root, nvidia_smi=cs.nvidia_smi_line(),
               device=torch.cuda.get_device_name(0))

    def timed(fn):
        split = cs.launch_split(fn)
        return dict(ms=cs.median_ms(fn), device_us=sum(v[1] for v in split.values()),
                    launches=sum(v[0] for v in split.values()), split=split, **cs.host_cost(fn))

    def kn_entry(ev, nc, na, sl, body, with_block):
        dk, bk = km.digest_tblock(ev, nc, na, sl, body, with_block=with_block)
        dp, bp = km.digest_tblock_plain(ev, nc, na, sl, body, with_block)
        cs.check(torch.equal(dk, dp), "KN: digest differs from its twin's")
        cs.check(bk is None if bp is None else cs.same_bits(bk, bp),
                 "KN: transform block differs from its twin's")
        return dict(bodies=body.capacity, pairs=int(ev.contact_touching.shape[0]),
                    touching=int(ev.contact_touching.sum()),
                    newly_awake=int(ev.newly_awake.sum()), with_block=with_block,
                    bit_equal=True, **cs.bound(cs.kn_bytes(ev, (nc, na, sl), dp, body, bp), 0),
                    **timed(lambda: km.digest_tblock(ev, nc, na, sl, body,
                                                     with_block=with_block)))

    # KN at the serving world (phase 10's scene).
    w, p = benchworld.serving_world("cuda")
    w._flush()
    for t in range(121):
        benchworld.serving_tick(w, p, t * DT)
    ev, dg, sl = w.last_events, w.last_diags, w.pair_cache.steps_left
    for name, blk in (("bench_block", True), ("bench_digest", False)):
        out[f"kn_{name}"] = kn_entry(ev, dg.num_contacts, dg.num_awake, sl, w.state, blk)
        cs.log(f"# kn {name} {json.dumps(out[f'kn_{name}'])}")
    del w, p, ev, dg, sl

    # KN at 65,536 bodies.
    fields = hc.pair_world(hc.cell_bodies("lattice", 65_536, 160, 6, seed=1), seed=1,
                           max_bound=0.6928)
    cfg = SimConfig(capacity=65_536, max_pairs=49_152, grid_dim=160, cell_size=1.4,
                    cell_capacity=6, pairs_per_body=10, pair_rebuild_interval=6)
    body = convert.body_state_from_numpy(fields, device="cuda")
    pa, pb, pv = ks.pairs_rebuild(body, DT, cfg, False)[:3]
    rng = np.random.default_rng(5)

    def bmask():
        return torch.as_tensor(rng.random(65_536) < 0.01, device="cuda")
    i32 = torch.int32
    ev = StepEvents(contact_pair_a=pa, contact_pair_b=pb, contact_touching=pv.clone(),
                    newly_awake=bmask(), newly_asleep=bmask(), entered_water=bmask(),
                    num_pairs=pv.sum().to(i32), broadphase_overflow=torch.zeros((), dtype=i32,
                                                                              device="cuda"))
    sc = [torch.tensor(v, dtype=i32, device="cuda") for v in (40_000, 65_000, 3)]
    out["kn_capacity"] = kn_entry(ev, *sc, body, True)
    cs.log(f"# kn capacity {json.dumps(out['kn_capacity'])}")
    del body, ev, pa, pb, pv

    # KF on phase 6's scene.
    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    src, pool, lis, room = benchworld.bench_audio("cuda")
    idx = torch.arange(src.capacity, device="cuda")
    src = src.replace(pos=w.state.pos[idx], vel=w.state.linvel[idx])
    del w
    bank = hrir_bank_tensor("cuda")
    for b in (benchworld.TICK_FRAMES, mix.BLOCK):
        s_, room_ = src, room
        for _ in range(30):
            s_, _, room_ = mix.mix_block(s_, pool, lis, room=room_, use_hrtf=True, block=b)
        st = mix.prepare(s_, lis, b, b / mix.ENGINE_RATE, True)
        sp, heads = ka.audio_fetch_plain(pool, s_.buf_offset, s_.buf_len, s_.playhead,
                                         st.eff_delta, s_.mix_factor, s_.looping,
                                         s_.stream_mode, s_.stream_write_head, st.active, b,
                                         mix.window_rows(b))
        sargs = bd.kf_args(ka, (sp, s_.lp_state, st.alpha, st.use_lp, s_.spatial, s_.hrir_hist,
                                bank, st.dir_idx, s_.prev_gain_l, s_.prev_gain_r, st.gl, st.gr,
                                mix.gain_ramp(b, "cuda"), st.gain, st.send_gain, True),
                           (s_.finished, s_.looping, s_.stream_mode, st.active, heads,
                            s_.buf_len, s_.smoothed_level, s_.alive, s_.remove_on_finish))
        fk = ka.audio_spatialise(*sargs)
        fp = ka.audio_spatialise_plain(*sargs)
        err = max(cs.max_err(x, y) for x, y in zip(fk[:6], fp[:6]))
        cs.check(err <= 1e-5, f"KF b{b}: max abs err {err} > 1e-5")
        bits = cs.kf_bits(fk, fp, f"b{b}")
        taps = bank.shape[-1]
        rows = bank.reshape(-1, 2 * taps)[torch.unique(st.dir_idx).long()]
        n_spatial = int(s_.spatial.sum())
        out[f"kf_b{b}"] = dict(
            sources=int(sp.shape[0]), frames=b, use_lp=int(st.use_lp.sum()),
            spatial=n_spatial, max_abs_err=err, **bits,
            **cs.bound(cs.nbytes(sargs[:6], sargs[7:15], rows, fk),
                       b * (n_spatial * 4 * taps + int(sp.shape[0]) * 12)),
            **timed(lambda sargs=sargs: ka.audio_spatialise(*sargs)))
        cs.log(f"# kf b{b} {json.dumps(out[f'kf_b{b}'])}")

    if not args.no_ticks:
        sv = cs.serving_phase()
        out["serving"] = dict(ms_median=sv["ms_per_serving_tick_median"],
                              ms_p90=sv["ms_per_serving_tick_p90"],
                              digest_launches=sv["launches"]["digest_tblock"])
        cl = cs.client_phase()
        out["client"] = dict(ms_median=cl["ms_per_client_frame_median"],
                             ms_p90=cl["ms_per_client_frame_p90"],
                             digest_launches=cl["launches"]["digest_tblock"],
                             spatialise_launches=cl["launches"]["audio_spatialise"])
    return bd.finish("bench_digest_spatialise", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

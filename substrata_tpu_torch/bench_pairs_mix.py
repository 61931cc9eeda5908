#!/usr/bin/env python3
"""The pair finder (KS) and the downmix (KG) on the card, for the port
found under ``--root`` (default: this checkout).

KS at a rebuild (``pairs_rebuild`` on the body after the forces, as
``physics_step`` calls it; ``chip_smoke._forced``), each first held
against its twin on every output, bit for bit:

- ``bench``: the bench world after 30 thinks (chip_smoke phase 15's);
- ``fulltick``: the full tick's world (phase 9's: 8 vehicles, the
  character, particles) after 30 full ticks, with its own oversize flag;
- ``mesh``: the mesh world after 60 client frames (phase 13's);
- ``capacity``: 65,536 bodies over grid 160 (``hard_cases.cell_bodies``'s
  lattice, as phase 14 builds it for KP, its radii scaled to the bench's
  boxes; ``hard_cases.pair_world``).

For each: ms per call (CUDA events, ``chip_smoke.median_ms``), device µs
per call and per launch by kernel name (``chip_smoke.launch_split``), the
host's cost
per call (``chip_smoke.host_cost``), the same for KP's cell-table call
alone (KS's wrapper makes it), and KS's own share (the call less KP's).

KG (``audio_downmix_reverb``) on phase 6's scene (bench.py's 256 sources
after 30 mixed 800-frame blocks; the spatialised blocks from KF's twin):
800 frames with the room and without, and 256 frames with the room (the
client's render block), each held against its twin first (the write index
exact, out and lines within 1e-5 and counted equal to the bit); beside
each, the three ``torch.sum(dim=0)`` over [S, B] (the sums alone).

Then phase 9 (180 full ticks) and phase 19 (180 client frames) unless
``--no-ticks``.  Run parent, change, change, parent in one call:

    python3 substrata_tpu_torch/bench_pairs_mix.py [--root DIR] [--tag NAME] [--no-ticks]

The helpers come from this checkout, the port from ``--root``.  Prints one
JSON line, with the card's name and power limit, and writes it to
chiprun_out/bench_pairs_mix_<tag>.json.
"""

from __future__ import annotations

import json
import sys

import bench_driver as bd

DT = bd.DT


def main():
    args, cs = bd.start("bench_pairs_mix", flags=("--no-ticks",))
    root = args.root
    import torch
    from substrata_tpu_torch import benchworld, convert
    from substrata_tpu_torch.kernels import audio_mix as ka
    from substrata_tpu_torch.kernels import build, cell_table
    from substrata_tpu_torch.kernels import pairs as ks
    from substrata_tpu_torch.physics.state import SimConfig
    bd.check_root(ks, root)
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

    def ks_entry(body, cfg, has_os, what):
        got = ks.pairs_rebuild(body, DT, cfg, has_os)
        want = ks.pairs_rebuild_plain(body, DT, cfg, has_os)
        for a, b, name in zip(got, want, ("pair_a", "pair_b", "pair_valid", "num_pairs",
                                          "overflow", "steps_left", "margins")):
            cs.check(cs.same_bits(a, b), f"KS {what}: {name} differs")
        call = timed(lambda: ks.pairs_rebuild(body, DT, cfg, has_os))
        kp = timed(lambda: cell_table.cell_table(
            body.pos, body.alive, body.collidable, body.awake, body.motion_type,
            body.bound_radius, num_buckets=cfg.grid_dim * cfg.grid_dim,
            cap=cfg.cell_capacity, rcp_cell=ks.fp.recip(cfg.cell_size),
            cell_size=cfg.cell_size, with_flags=True))
        own = {k: v for k, v in call["split"].items() if k not in kp["split"]}
        n_os = int((body.alive & (2.0 * body.bound_radius > cfg.cell_size)).sum())
        return dict(bodies=body.capacity, num_pairs=int(want[3]), overflow=int(want[4]),
                    steps_left=int(want[5]), oversize_bodies=n_os, has_oversize=has_os,
                    call=call, kp=kp,
                    ks_own=dict(device_us=sum(v[1] for v in own.values()),
                                launches=sum(v[0] for v in own.values()),
                                host_us=call["host_us"] - kp["host_us"],
                                ms=call["ms"] - kp["ms"]))

    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    out["ks_bench"] = ks_entry(cs._forced(w), w.config, bool(w._oversize_slots), "bench")
    cs.log(f"# ks bench {json.dumps(out['ks_bench'])}")
    del w

    w = benchworld.bench_world("cuda")
    veh, vin, ps, char, scripts = benchworld.bench_fulltick(w, "cuda")
    src, pool, lis, room = benchworld.bench_audio("cuda")
    idx = torch.arange(src.capacity, device="cuda")
    for t in range(30):
        veh, ps, src, _, room, char = benchworld.full_tick(w, veh, vin, ps, src, pool, lis, room,
                                                           idx, char, t * DT, scripts)
    out["ks_fulltick"] = ks_entry(cs._forced(w), w.config, bool(w._oversize_slots), "fulltick")
    cs.log(f"# ks fulltick {json.dumps(out['ks_fulltick'])}")
    del w, veh, vin, ps, char, scripts

    mw, mplayer, msrc = benchworld.mesh_world("cuda")
    for t in range(60):
        benchworld.mesh_tick(mw, mplayer, t * DT, msrc)
    out["ks_mesh"] = ks_entry(cs._forced(mw), mw.config, bool(mw._oversize_slots), "mesh")
    cs.log(f"# ks mesh {json.dumps(out['ks_mesh'])}")
    del mw, mplayer, msrc

    fields = hc.pair_world(hc.cell_bodies("lattice", 65_536, 160, 6, seed=1), seed=1,
                           max_bound=0.6928)
    cfg = SimConfig(capacity=65_536, max_pairs=49_152, grid_dim=160, cell_size=1.4,
                    cell_capacity=6, pairs_per_body=10, pair_rebuild_interval=6)
    body = convert.body_state_from_numpy(fields, device="cuda")
    out["ks_capacity"] = ks_entry(body, cfg, False, "capacity")
    cs.log(f"# ks capacity {json.dumps(out['ks_capacity'])}")
    del body

    # KG on phase 6's scene.
    from substrata_tpu_torch.audio import mix
    from substrata_tpu_torch.audio.hrtf import hrir_bank_tensor
    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    src, pool, lis, room = benchworld.bench_audio("cuda")
    src = src.replace(pos=w.state.pos[idx], vel=w.state.linvel[idx])
    del w
    for b in (benchworld.TICK_FRAMES, mix.BLOCK):
        s_, room_ = src, room
        for _ in range(30):
            s_, _, room_ = mix.mix_block(s_, pool, lis, room=room_, use_hrtf=True, block=b)
        st = mix.prepare(s_, lis, b, b / mix.ENGINE_RATE, True)
        nw = mix.window_rows(b)
        sp, heads = ka.audio_fetch_plain(pool, s_.buf_offset, s_.buf_len, s_.playhead,
                                         st.eff_delta, s_.mix_factor, s_.looping,
                                         s_.stream_mode, s_.stream_write_head, st.active, b, nw)
        fp = ka.audio_spatialise_plain(*bd.kf_args(
            ka, (sp, s_.lp_state, st.alpha, st.use_lp, s_.spatial, s_.hrir_hist,
                 hrir_bank_tensor("cuda"), st.dir_idx, s_.prev_gain_l, s_.prev_gain_r, st.gl,
                 st.gr, mix.gain_ramp(b, "cuda"), st.gain, st.send_gain, True),
            (s_.finished, s_.looping, s_.stream_mode, st.active, heads, s_.buf_len,
             s_.smoothed_level, s_.alive, s_.remove_on_finish)))
        cases = {f"room_b{b}": (fp[0], fp[1], fp[2], lis.master_volume, room_.delay_lines,
                                room_.write_idx, room_.delays, room_.feedback, room_.wet)}
        if b == benchworld.TICK_FRAMES:
            cases[f"no_room_b{b}"] = (fp[0], fp[1], None, lis.master_volume)
        for name, gargs in cases.items():
            gk = ka.audio_downmix_reverb(*gargs)
            gp = ka.audio_downmix_reverb_plain(*gargs)
            err = max(cs.max_err(x, y) for x, y in zip(gk[:2], gp[:2]) if y is not None)
            cs.check(err <= 1e-5, f"KG {name}: max abs err {err} > 1e-5")
            if gp[2] is not None:
                cs.check(torch.equal(gk[2], gp[2]), f"KG {name}: write index differs")
            bits = {k: bool(torch.equal(x, y)) for k, x, y in zip(("out", "lines"), gk, gp)
                    if y is not None}
            sums = [t for t in gargs[:3] if t is not None]
            r = timed(lambda gargs=gargs: ka.audio_downmix_reverb(*gargs))
            lib = timed(lambda sums=sums: [torch.sum(t, dim=0) for t in sums])
            out[f"kg_{name}"] = dict(
                sources=int(fp[0].shape[0]), frames=b, max_abs_err=err, bit_equal=bits,
                **cs.bound(cs.nbytes(gargs, gk), b * (3 * fp[0].shape[0] + 40)), **r,
                plain_ms=cs.median_ms(lambda gargs=gargs: ka.audio_downmix_reverb_plain(*gargs),
                                      reps=5),
                library_sums=dict(ms=lib["ms"], device_us=lib["device_us"],
                                  host_us=lib["host_us"]))
            cs.log(f"# kg {name} {json.dumps(out[f'kg_{name}'])}")

    if not args.no_ticks:
        ft = cs.full_tick_phase()
        out["full_tick"] = dict(ms_median=ft["ms_per_tick_median"], ms_p90=ft["ms_per_tick_p90"],
                                find_pairs_launches=ft["launches"]["find_pairs"],
                                downmix_launches=ft["launches"]["audio_downmix_reverb"])
        cl = cs.client_phase()
        out["client"] = dict(ms_median=cl["ms_per_client_frame_median"],
                             ms_p90=cl["ms_per_client_frame_p90"],
                             find_pairs_launches=cl["launches"]["find_pairs"],
                             downmix_launches=cl["launches"]["audio_downmix_reverb"])
    return bd.finish("bench_pairs_mix", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""KB's static contacts and KW's heights call on the card, for the port
found under ``--root`` (default: this checkout).

For each wrapper call: ms per call (CUDA events around back-to-back calls,
``chip_smoke.median_ms``), device µs per call (torch.profiler,
``chip_smoke.device_us_call``) and the host's cost per call
(``chip_smoke.host_cost``: perf_counter over 200 calls without a
synchronise, and the profiler's CPU time).  The shapes are chip_smoke.py's:
KB on the 10,000-box bench world after 30 ticks (phase 3) and on the mesh
world after 120 client frames (phase 12), each after a comparison with its
twin (``rows_equal``: ids, valid and keys equal, the other fields within
1e-5 on the valid rows); KW's heights-only call at 65,536 points over the
1025^2 terrain beside ``grid_sample``'s bilinear heights at the same points
with the border clamp (phase 16), heights within 1e-6 of scale.  Then the
mesh world's client frame as phase 13 times it, unless ``--no-frames``.
``--root`` may be an unpacked earlier commit, so that its wrappers and this
checkout's are timed in one call on one card (run parent, change, change,
parent):

    python3 substrata_tpu_torch/bench_static.py [--root DIR] [--tag NAME] [--no-frames]

The helpers come from this checkout, the port from ``--root``.  Prints one
JSON line, with the card's name and power limit, and writes it to
chiprun_out/bench_static_<tag>.json.
"""

from __future__ import annotations

import sys

import numpy as np

import bench_driver as bd

DT = bd.DT


def main():
    args, cs = bd.start("bench_static", flags=("--no-frames",))
    root = args.root
    import torch
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import static_contacts as kb
    from substrata_tpu_torch.kernels import terrain as kt
    from substrata_tpu_torch.physics.terrain import TerrainSystem
    bd.check_root(kb, root)
    build.build()
    build.library()
    out = dict(tag=args.tag, root=root, nvidia_smi=cs.nvidia_smi_line(),
               device=torch.cuda.get_device_name(0))

    def timed(run, prefix):
        return dict(ms=cs.median_ms(run), device_us=cs.device_us_call(run, prefix),
                    **cs.host_cost(run))

    def kb_entry(w):
        sw, cfg = w.static_world, w.config
        kb_args = (w.state, sw.heightfield, sw.has_heightfield,
                   min(cfg.static_contacts_per_body, 8), cfg.present_shape_types, sw.hulls,
                   sw.trimesh, cfg.max_tri_candidates)
        rk, rp = kb.static_contacts(*kb_args), kb.static_contacts_plain(*kb_args)
        equal = all(torch.equal(rk[i], rp[i]) for i in (0, 1, 5, 8)) and max(
            cs.max_err(rk[i], rp[i], rp[5]) for i in (2, 3, 4)) <= 1e-5
        return dict(bodies=w.state.capacity, valid_rows=int(rp[5].sum()), rows_equal=equal,
                    **timed(lambda: kb.static_contacts(*kb_args), "static_contacts"))

    w = benchworld.bench_world("cuda")
    for _ in range(30):
        w.think(DT)
    w._flush()
    out["kb_bench"] = kb_entry(w)
    del w
    mw, mp, src = benchworld.mesh_world("cuda")
    for t in range(120):
        benchworld.mesh_tick(mw, mp, t * DT, src)
    mw._flush()
    out["kb_mesh"] = kb_entry(mw)
    del mw, mp, src

    h, cw, origin = benchworld.terrain_heightmap(benchworld.TERRAIN_RES)
    ts = TerrainSystem(device="cuda")
    ts.set_heightmap(h, origin, cw)
    hf = ts.heightfield
    field = (hf.heights, hf.origin, hf.cell_w)
    xy = torch.as_tensor(np.random.default_rng(16).uniform(-530, 530, (65_536, 2))
                         .astype(np.float32), device="cuda")
    got, want = kt.terrain_heights(*field, xy), kt.terrain_heights_plain(*field, xy)
    gs_grid = ((xy - hf.origin) / hf.cell_w / (torch.tensor(h.shape, device="cuda") - 1)
               * 2 - 1).flip(-1).view(1, 1, -1, 2)
    hmap = hf.heights.view(1, 1, *h.shape)
    out["kw_heights"] = dict(
        points=int(xy.shape[0]),
        err_of_scale=cs.max_err(got, want) / float(np.abs(h).max()),
        **timed(lambda: kt.terrain_heights(*field, xy), "heights_kernel"))
    out["grid_sample"] = timed(lambda: torch.nn.functional.grid_sample(
        hmap, gs_grid, mode="bilinear", padding_mode="border", align_corners=True), "")
    out["kw_ms_over_grid_sample_ms"] = out["kw_heights"]["ms"] / out["grid_sample"]["ms"]
    if not args.no_frames:
        me = cs.mesh_phase()
        out["ms_per_mesh_frame"] = me["ms_per_mesh_tick_median"]
        out["ms_per_mesh_frame_p90"] = me["ms_per_mesh_tick_p90"]
    return bd.finish("bench_static", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

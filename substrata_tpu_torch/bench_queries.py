#!/usr/bin/env python3
"""KH's ray trace and KL's character update on the card, for the port found
under ``--root`` (default: this checkout).

For each wrapper call: ms per call (CUDA events around back-to-back calls,
``chip_smoke.median_ms``), device µs per launch (torch.profiler,
``chip_smoke.device_us_call``) and the host's cost per call
(``chip_smoke.host_cost``: perf_counter over 200 calls without a
synchronise, and the profiler's CPU time), each after a check that the
kernel equals its twin on the same inputs.  The shapes are chip_smoke.py's:
KH at the particles' 2,048 rays and the wheels' 32 on bench.py's full-tick
scene after 30 full ticks (phase 8), and on the mesh world's 512 occlusion
rays and 2,048 seeded field rays after 120 client frames (phase 12); KL on
the serving world after 120 ticks of the walk (phase 10) and on the mesh
world (phase 12).  Then the mesh world's client frame as phase 13 times it
(KH sits in front of its readback), unless ``--no-frames``.  ``--root`` may
be an unpacked earlier commit, so that its wrappers and this checkout's are
timed in one call on one card (run parent, change, change, parent):

    python3 substrata_tpu_torch/bench_queries.py [--root DIR] [--tag NAME]

The helpers come from this checkout, the port from ``--root``.  Prints one
JSON line, with the card's name and power limit, and writes it to
chiprun_out/bench_queries_<tag>.json.
"""

from __future__ import annotations

import sys

import bench_driver as bd

DT = bd.DT


def main():
    args, cs = bd.start("bench_queries", flags=("--no-frames",))
    root = args.root
    import torch
    from substrata_tpu_torch import benchworld
    from substrata_tpu_torch.kernels import build
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.kernels import ray_trace as kh
    bd.check_root(kh, root)
    build.build()
    build.library()
    out = dict(tag=args.tag, root=root, nvidia_smi=cs.nvidia_smi_line(),
               device=torch.cuda.get_device_name(0))

    def timed(run, prefix):
        return dict(ms=cs.median_ms(run), device_us=cs.device_us_call(run, prefix),
                    **cs.host_cost(run))

    def kh_entry(ray_args, kw, *_):
        rp = cs._kh_compare(ray_args, kw, "bench_queries")[1]
        return dict(rays=int(ray_args[0].shape[0]), hits=int(rp[3].sum()),
                    **timed(lambda: kh.ray_trace(*ray_args, **kw), "ray_trace"))

    def kl_entry(char_args, kw):
        cs._kl_compare(char_args, kw)
        return timed(lambda: kl.character_packed(*char_args, **kw), "character_kernel")

    for shape, entry in cs.fulltick_ray_cases("cuda")[0].items():
        out[f"kh_{shape}"] = kh_entry(*entry)
    sw, player = benchworld.serving_world("cuda")
    for t in range(121):
        if t == 120:
            sw._flush()
            out["kl_serving"] = kl_entry(*cs._char_args(sw, player.state,
                                                        benchworld.walk_input(t * DT),
                                                        player.proxy.slot, "cuda"))
        benchworld.serving_tick(sw, player, t * DT)
    del sw, player
    mw, mp, src = benchworld.mesh_world("cuda")
    for t in range(121):
        if t == 120:
            mw._flush()
            out["kl_mesh"] = kl_entry(*cs._char_args(mw, mp.state, benchworld.walk_input(t * DT),
                                                     mp.proxy.slot, "cuda"))
        benchworld.mesh_tick(mw, mp, t * DT, src)
    for shape, entry in cs.mesh_ray_cases(mw, mp, src, "cuda").items():
        out[f"kh_{shape}"] = kh_entry(*entry)
    del mw, mp, src
    if not args.no_frames:
        me = cs.mesh_phase()
        out["ms_per_mesh_frame"] = me["ms_per_mesh_tick_median"]
        out["ms_per_mesh_frame_p90"] = me["ms_per_mesh_tick_p90"]
    return bd.finish("bench_queries", out, args.tag)


if __name__ == "__main__":
    sys.exit(main())

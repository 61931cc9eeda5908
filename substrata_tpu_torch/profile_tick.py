"""Where the time of one think(), of one physics + audio tick, of one full
tick and of one serving tick goes, on the card.

    python3 -m substrata_tpu_torch.profile_tick

On the 10,000-box bench world (kicked once, after 30 ticks):
1. host-clock ms per think, rebuild and reuse ticks apart, and ms per
   physics + audio tick and per mix_block with bench.py's 256 sources on
   the world's bodies;
2. one torch.profiler pass: device busy time per tick (sum of kernel
   times), kernel launches per tick, the top kernels;
3. a stage pass: each stage of physics_step wrapped with a synchronize on
   both sides, so its host time (launching + waiting) and device time
   (CUDA events) are its own.  The syncs remove overlap, so these are for
   attribution, not for the tick total;
4. the audio stage: profiler passes over the physics + audio tick and
   over mix_block alone (device busy ms and device ops per tick, each
   audio kernel's device time), and a stage pass over the mix's setup and
   its three kernels;
5. the full-tick stage: bench.py's vehicles, character, particles and
   Winter scripts on the same world (benchworld.full_tick: the cell
   table, vehicles, the character, think, particles, the scripts, the
   mix), host-clock ms per full tick with and without the character (in
   turns), a profiler pass (device busy ms, device ops, the cell-table,
   ray, character, particle, vehicle and script kernels' device times)
   and a stage pass over its parts;
6. the serving stage: a second bench world with a walking player
   (benchworld.serving_world, 30 ticks in), host-clock ms per
   think_with_player, a profiler pass and a stage pass over the tick's
   parts (tick input, character, step, each of its stages, digest);
7. the mesh stage: tools/bench_networked.py's 12,000-object mesh world
   (benchworld.mesh_world: 512 hulls over the merged static trimesh, a
   walking player, 30 frames in), host-clock ms per client frame
   (benchworld.mesh_tick: think_with_player and the occlusion rays), a
   profiler pass (device busy ms, device ops, the port kernels' device
   times) and a stage pass over the frame's parts (tick input, character,
   step, each of its stages, KO, the occlusion rays);
8. the terrain stage: BASELINE config 4 + 64 avatars
   (benchworld.terrain_world at full width, 30 frames in), host-clock ms
   per client frame (benchworld.terrain_tick: think_with_player, the
   terrain clamp, the avatars and one pose_all, the particle spawns and
   step, terrain LOD and scattering; the frames timed include one camera
   jump), a profiler pass (device busy ms, device ops, the port kernels'
   device times, KW-KZ among them) and a stage pass over the frame's
   parts.
Prints one JSON object and writes the trace to chiprun_out/tick_trace.json.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

from substrata_tpu_torch import benchworld
from substrata_tpu_torch.audio import mix
from substrata_tpu_torch.avatar_graphics import AvatarGraphicsManager
from substrata_tpu_torch.benchworld import (N_SOURCES, TICK_FRAMES, bench_audio, bench_fulltick,
                                            bench_world, full_tick, kick, physics_audio_tick)
from substrata_tpu_torch.kernels import (audio_mix, convex, layout, pairs, positions, serving_io,
                                         sleep)
from substrata_tpu_torch.kernels import particles_triton as kpart
from substrata_tpu_torch.kernels import spawn as kspawn
from substrata_tpu_torch.kernels import terrain as kterrain
from substrata_tpu_torch.kernels import vehicles as kveh
from substrata_tpu_torch.physics import broadphase, integrate, narrowphase, queries, solver
from substrata_tpu_torch.physics import particles as particles_mod
from substrata_tpu_torch.physics import terrain as terrain_mod
from substrata_tpu_torch.physics import world as world_mod

DT = 1.0 / 60.0
RANGES = ("physics_step",)       # record_function ranges (step.py)
# The step's stages; KS-KV's wrappers (pairs at a rebuild, the strike wake,
# KT's grouping, touching, compaction and incidence, the position solve and
# the sleep pass) each alone.
STEP_STAGES = [(integrate, "apply_forces"), (broadphase, "find_pairs_cached"),
               (pairs, "pairs_rebuild"), (sleep, "strike_wake"), (narrowphase, "pair_contacts"),
               (layout, "group"), (layout, "touching"), (narrowphase, "static_contacts"),
               (layout, "compact"), (layout, "incidence"), (solver, "prepare_solve"),
               (solver, "iterate"), (solver, "cache_refresh"),
               (integrate, "integrate_positions"), (positions, "solve_positions"),
               (sleep, "sleep_pass")]
STAGES = STEP_STAGES + [(serving_io, "digest_tblock")]
# Device-side names of the hand-written kernels (KA, KB, KC x2, KD x2, ...;
# KS-KV by prefix).
PORT_KERNELS = ("box_box_rows_kernel", "static_contacts_kernel", "solve_rows_kernel",
                "solve_bodies_kernel", "apply_forces_kernel", "integrate_kernel",
                "audio_fetch_kernel", "audio_spatialise_kernel", "audio_downmix_kernel",
                "ray_trace_kernel", "particles_kernel", "vehicle_forces_kernel",
                "closed_form_rows_kernel", "character_kernel", "apply_tick_in_kernel",
                "digest_tblock_kernel", "convex_rows_kernel", "cell_hash_kernel",
                "cell_rank_kernel", "solve_setup_kernel", "refresh_copy_kernel",
                "refresh_claim_kernel", "refresh_write_kernel", "winter_kernel", "pairs_",
                "layout_", "positions_", "sleep_", "heights_kernel", "chunks_kernel",
                "scatter_kernel", "spawn_kernel", "pose_kernel")
AUDIO_STAGES = [(mix, "prepare"), (audio_mix, "audio_fetch"), (audio_mix, "audio_spatialise"),
                (audio_mix, "audio_downmix_reverb")]
FULL_STAGES = [(broadphase, "build_cell_table"), (benchworld, "vehicles_update"),
               (queries, "trace_rays"), (kveh, "vehicle_forces"),
               (benchworld, "_apply_vehicle_deltas"), (world_mod.PhysicsWorld, "think"),
               (benchworld, "player_update_packed"), (benchworld, "particles_step"),
               (kpart, "particles_update"), (benchworld.BenchScripts, "evaluate"),
               (benchworld, "mix_block")]
SERVING_STAGES = [(serving_io, "apply_tick_in"), (world_mod, "player_update_packed"),
                  (world_mod, "physics_step")] + STEP_STAGES[1:] + [(serving_io, "digest_tblock")]
MESH_STAGES = SERVING_STAGES + [(convex, "convex_rows"), (benchworld.queries, "trace_rays")]
TERRAIN_STAGES = [(world_mod.PhysicsWorld, "think_with_player"),
                  (terrain_mod.TerrainSystem, "eval_terrain_height"),
                  (benchworld, "move_avatars"), (AvatarGraphicsManager, "update_avatar"),
                  (AvatarGraphicsManager, "pack_all"), (AvatarGraphicsManager, "pose_all"),
                  (benchworld, "emit_particles"), (particles_mod.ParticleManager, "_flush_spawns"),
                  (kspawn, "spawn_rows"), (particles_mod, "particles_step"),
                  (terrain_mod.TerrainSystem, "update_campos"),
                  (kterrain, "terrain_chunks"), (terrain_mod.TerrainScattering, "update_campos"),
                  (kterrain, "terrain_scatter")]

def _timed(fn, name, acc):
    @functools.wraps(fn)
    def run(*a, **k):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn(*a, **k)
        e1.record()
        torch.cuda.synchronize()
        rec = acc.setdefault(name, [0.0, 0.0, 0])
        rec[0] += (time.perf_counter() - t0) * 1e3
        rec[1] += e0.elapsed_time(e1)
        rec[2] += 1
        return out
    return run


def _device_summary(prof, ticks):
    """Device busy ms, device ops and port-kernel times per tick from a
    profiler pass over ``ticks`` ticks.  Device-side events (kernels,
    copies, fills) run one at a time on the stream, so their durations sum
    to the busy time."""
    by_name: dict = {}
    for e in prof.events():
        # The step's record_function range also shows on the device's
        # timeline; it is not device work.
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in RANGES:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    ops = sum(n for _, n in by_name.values())
    ours = {name[:60]: dict(ms_per_tick=us / 1e3 / ticks, us_per_launch=us / n,
                            calls_per_tick=n / ticks)
            for name, (us, n) in by_name.items() if any(p in name for p in PORT_KERNELS)}
    return busy_us / 1e3 / ticks, ops / ticks, by_name, ours


def _profiled(run, ticks):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            run()
        torch.cuda.synchronize()
    return prof


def _staged(stages, run, ticks):
    """Host and device ms per tick of each stage, synchronised around it."""
    acc: dict = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name in stages]
    for mod, name, fn in saved:
        setattr(mod, name, _timed(fn, name, acc))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            run()
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3 / ticks
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return total_ms, {name: dict(host_ms_per_tick=v[0] / ticks, device_ms_per_tick=v[1] / ticks,
                                 calls_per_tick=v[2] / ticks) for name, v in acc.items()}


def _host_ms(run, ticks):
    """Host-clock ms of each of ``ticks`` calls, synchronised around each."""
    times = []
    for _ in range(ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def audio_scene(w):
    """bench.py's 256 sources on the world's bodies: (one physics + audio
    tick, one mix_block alone), each advancing the shared state."""
    src, pool, lis, room = bench_audio("cuda")
    idx = torch.arange(src.capacity, device="cuda")
    state = dict(src=src, room=room)

    def coupled():
        state["src"], _, state["room"] = physics_audio_tick(w, state["src"], pool, lis,
                                                            state["room"], idx)

    def mix_only():
        state["src"], _, state["room"] = mix.mix_block(state["src"], pool, lis,
                                                       room=state["room"], block=TICK_FRAMES)
    return coupled, mix_only


def full_scene(w):
    """bench.py's vehicles, character, particles and Winter scripts and its
    256 sources on the world: (one full tick, one full tick without the
    character) per call, advancing the shared state."""
    veh, vin, ps, char, scripts = bench_fulltick(w, "cuda")
    src, pool, lis, room = bench_audio("cuda")
    idx = torch.arange(src.capacity, device="cuda")
    state = dict(veh=veh, ps=ps, src=src, room=room, char=char, t=0)

    def tick(with_char):
        (state["veh"], state["ps"], state["src"], _, state["room"], char) = full_tick(
            w, state["veh"], vin, state["ps"], state["src"], pool, lis, state["room"], idx,
            state["char"] if with_char else None, state["t"] * DT, scripts)
        if with_char:
            state["char"] = char
        state["t"] += 1
    return functools.partial(tick, True), functools.partial(tick, False)


def serving_scene():
    """A second bench world with a walking player: one serving tick per
    call."""
    w, player = benchworld.serving_world("cuda")
    state = dict(t=0)

    def serve():
        benchworld.serving_tick(w, player, state["t"] * DT)
        state["t"] += 1
    return serve


def mesh_scene():
    """The 12,000-object mesh world with its walking player: one client
    frame per call."""
    w, player, src = benchworld.mesh_world("cuda")
    state = dict(t=0)

    def frame():
        benchworld.mesh_tick(w, player, state["t"] * DT, src)
        state["t"] += 1
    return frame


def terrain_scene():
    """BASELINE config 4 + 64 avatars at full width; returns one client
    frame (each call the next frame, the camera jumping every 30)."""
    sc = benchworld.terrain_world("cuda")
    state = dict(f=0)

    def frame():
        benchworld.terrain_tick(sc, state["f"])
        state["f"] += 1
    return frame


def main(ticks: int = 24):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    w = bench_world("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for t in range(60):
        if t == 30:
            w.set_state(kick(w.state, gen))
        w.think(DT)
    torch.cuda.synchronize()

    rebuild, reuse = [], []
    for _ in range(2 * ticks):
        is_rebuild = w._force_pair_rebuild or w._host_steps_left <= 0
        (rebuild if is_rebuild else reuse).append(_host_ms(lambda: w.think(DT), 1)[0])
    # Host-clock passes run first: ticks timed after the profiler and stage
    # passes took about twice the host time (PERF.md, section 6).
    coupled, mix_only = audio_scene(w)
    for _ in range(30):
        coupled()
    coupled_ms, mix_ms = _host_ms(coupled, ticks), _host_ms(mix_only, ticks)
    full, full_no_char = full_scene(w)
    for _ in range(30):
        full()
    # With and without the character in turns (without, with, with,
    # without): the host's speed drifts within a call.
    full_ms, no_char_ms = [], []
    for _ in range(ticks // 2):
        no_char_ms += _host_ms(full_no_char, 1)
        full_ms += _host_ms(full, 2)
        no_char_ms += _host_ms(full_no_char, 1)
    n_bodies = len(w.objects)

    prof = _profiled(lambda: w.think(DT), ticks)
    busy_ms, ops, by_name, ours = _device_summary(prof, ticks)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "tick_trace.json"))
    staged_ms, stages = _staged(STAGES, lambda: w.think(DT), ticks)

    c_busy, c_ops, _, _ = _device_summary(_profiled(coupled, ticks), ticks)
    m_busy, m_ops, _, m_ours = _device_summary(_profiled(mix_only, ticks), ticks)
    staged_mix_ms, mix_stages = _staged(AUDIO_STAGES, mix_only, ticks)
    audio = dict(
        sources=N_SOURCES, frames_per_tick=TICK_FRAMES,
        ms_per_physics_audio_tick=float(np.median(coupled_ms)),
        physics_audio_device_busy_ms=c_busy, physics_audio_device_ops=c_ops,
        ms_per_mix_block=float(np.median(mix_ms)),
        mix_device_busy_ms=m_busy, mix_device_ops=m_ops,
        audio_kernels={k: v for k, v in m_ours.items() if "audio" in k},
        staged_ms_per_mix=staged_mix_ms, stages=mix_stages)

    f_busy, f_ops, _, f_ours = _device_summary(_profiled(full, ticks), ticks)
    staged_full_ms, full_stages = _staged(FULL_STAGES, full, ticks)
    full_tick_out = dict(
        ms_per_full_tick=float(np.median(full_ms)),
        ms_per_full_tick_without_character=float(np.median(no_char_ms)),
        device_busy_ms=f_busy, device_ops=f_ops,
        port_kernels=f_ours, staged_ms_per_tick=staged_full_ms, stages=full_stages)

    serve = serving_scene()
    for _ in range(30):
        serve()
    serve_ms = _host_ms(serve, ticks)
    s_busy, s_ops, _, s_ours = _device_summary(_profiled(serve, ticks), ticks)
    staged_serve_ms, serve_stages = _staged(SERVING_STAGES, serve, ticks)
    serving = dict(
        ms_per_serving_tick=float(np.median(serve_ms)), device_busy_ms=s_busy, device_ops=s_ops,
        port_kernels=s_ours, staged_ms_per_tick=staged_serve_ms, stages=serve_stages)

    frame = mesh_scene()
    for _ in range(30):
        frame()
    frame_ms = _host_ms(frame, ticks)
    g_busy, g_ops, _, g_ours = _device_summary(_profiled(frame, ticks), ticks)
    staged_frame_ms, frame_stages = _staged(MESH_STAGES, frame, ticks)
    mesh = dict(
        ms_per_mesh_frame=float(np.median(frame_ms)), device_busy_ms=g_busy, device_ops=g_ops,
        port_kernels=g_ours, staged_ms_per_frame=staged_frame_ms, stages=frame_stages)

    tframe = terrain_scene()
    for _ in range(30):
        tframe()
    tframe_ms = _host_ms(tframe, ticks)
    t_busy, t_ops, _, t_ours = _device_summary(_profiled(tframe, ticks), ticks)
    staged_t_ms, t_stages = _staged(TERRAIN_STAGES, tframe, ticks)
    terrain = dict(
        ms_per_terrain_frame=float(np.median(tframe_ms)), device_busy_ms=t_busy,
        device_ops=t_ops, port_kernels=t_ours, staged_ms_per_frame=staged_t_ms,
        stages=t_stages)

    out = dict(
        card=smi, bodies=n_bodies,
        ms_per_think_rebuild=float(np.median(rebuild)), rebuild_ticks=len(rebuild),
        ms_per_think_reuse=float(np.median(reuse)), reuse_ticks=len(reuse),
        device_busy_ms_per_tick=busy_ms, device_ops_per_tick=ops,
        top_kernels=[dict(name=name[:90], ms_per_tick=us / 1e3 / ticks,
                          calls_per_tick=n / ticks) for name, (us, n) in top],
        port_kernels=ours,
        staged_ms_per_think=staged_ms, stages=stages, audio=audio, full_tick=full_tick_out,
        serving_tick=serving, mesh_frame=mesh, terrain_frame=terrain)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

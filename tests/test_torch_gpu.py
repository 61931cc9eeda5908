"""Kernels KA-KZ, KAA-KAC on the card against their plain PyTorch twins, and the
entry points' default device.

These need a CUDA device and skip without one (the decision is made inside
the fixture, never at import).  The file imports torch, numpy and the port
only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances are chip_smoke.py's: KA exact, 1e-5 for KB rows (KB also on
kernels/hard_cases.py's static-contact scenes), 1e-4 for KC
velocities after warm start + 7 iterations and every one of those passes
exact (also on the hard solve scenes, and the planned whole solve equal to
the passes), 1e-6 for KD and KE, 1e-5 for
KF and KG, 1e-6 for KH (hit and body exact) and KI, 1e-5 of each output's
scale for KJ, 1e-5 for KK's rows (masks, keys and touching exact; also
on kernels/hard_cases.py's closed-form scenes, one launch a scene, the
joined layout to the same bits), 1e-6 of
scale for KL (flags and the touched list exact), KM and KN exact, KO
exact (also on kernels/hard_cases.py's hull-contact scenes, one launch a
scene, each bucket the same bits as its own call), KP exact, 1e-6 of each
output's scale for KQ's setup (masks, slots and table entries exact) and
its refreshed cache exact, KR within 1e-6 of scale (the bench rotations
exact), KS, KT and KV exact (pairs, margins, counters, buckets, compacted
rows, tables, flags, timers; KS also on kernels/hard_cases.py's pair
scenes and the cell table's hard inputs made into bodies, and its plan
per shape), KG's downmix also on hard_cases.py's downmix scenes, to the
bit where kernel and twin run the same operations, KU exact,
KW within 1e-6 of scale (its twin's fp.fma rounds twice where the kernel's
__fmaf_rn rounds once: they part only at an exact tie; the triangles
exact), KX, KY and KZ exact (KZ also on kernels/hard_cases.py's pose
scenes), and a small terrain frame on the card within 1e-4 m (particles, the character) and 1e-5 of scale (joints) of the CPU
path; KAA exact (HRTF on and off; the pan's cos and sin within 1e-6 of
the gains' scale, an HRIR bin only where its pre-round value lies within
1e-5 of a half-integer; also on hard_cases.py's audio-setup scenes), KAB
exact; KAC exact (words); KN and KF to the bit on
kernels/hard_cases.py's digest and spatialise scenes, KJ (1e-5 of scale,
gear and contact exact) and KT's incidence table (to the bit, a held table
not overwritten) on its vehicle and incidence scenes; ClientApp on the
card by default; the pipelined readback ring on the card; KAD (the halo
exchange) and KAE (the shard axis's keep, counts and clipped sum) exact,
and the sharded paths on the card within 1e-4 m (the mix 5e-5) of the CPU
path; KA and KU to the bit on kernels/hard_cases.py's box-box and
position scenes; KAD (every byte, the overflow counts, one launch a phase)
and KV's sleep pass (every output, three calls on one plan) to the bit on
its halo and sleep scenes; KT's compaction (every field and the overflow,
three calls on one plan) and KF with the epilogue folded in (its outputs
and the finished and alive flags; the levels NaN where the twin's are) to
the bit on the compaction and epilogue scenes.  Each kernel repeats its
twin's operations in the same order."""

import dataclasses

import numpy as np
import pytest
import torch

from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld, benchworld
from substrata_tpu_torch.audio import mix
from substrata_tpu_torch.audio.engine import AudioEngine
from substrata_tpu_torch.audio.hrtf import hrir_bank_tensor
from substrata_tpu_torch.benchworld import TICK_FRAMES, bench_audio
from substrata_tpu_torch.kernels import audio_mix as kaudio
from substrata_tpu_torch.kernels import box_box as ka
from substrata_tpu_torch.kernels import hard_cases
from substrata_tpu_torch.kernels import particles_triton as kpart
from substrata_tpu_torch.kernels import ray_trace as kray
from substrata_tpu_torch.kernels import vehicles as kveh
from substrata_tpu_torch.kernels import integrate_triton as kd
from substrata_tpu_torch.kernels import solve as kc
from substrata_tpu_torch.kernels import static_contacts as kb
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.physics import broadphase, narrowphase, queries, shapes, solver
from substrata_tpu_torch.physics.character import PlayerPhysics
from substrata_tpu_torch.physics.particles import motion_rays
from substrata_tpu_torch.physics.vehicles.manager import chassis_and_wheel_rays
from substrata_tpu_torch.physics.state import SimConfig

pytestmark = pytest.mark.gpu

DT = 1.0 / 60.0


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SimConfig(capacity=512, max_pairs=2048, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    w = PhysicsWorld(cfg, device="cuda")
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    for i in range(400):
        ix, iy, iz = i % 12, (i // 12) % 12, i // 144
        pos = np.array([ix * 1.7 + rng.uniform(-0.15, 0.15),
                        iy * 1.7 + rng.uniform(-0.15, 0.15), 0.45 + iz * 0.85], np.float32)
        w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]), pos=pos,
                                   motion_type=int(MotionType.DYNAMIC)))
    for _ in range(20):
        w.think(DT)
    return w


def test_box_box_kernel_matches_plain(world):
    s, pc = world.state, world.pair_cache
    args = (s.pos, s.quat, s.shape_params, s.friction, s.restitution, s.is_sensor,
            pc.pair_a, pc.pair_b, pc.pair_valid)
    rk, rp = ka.box_box_rows(*args), ka.box_box_rows_plain(*args)
    torch.cuda.synchronize()
    for i in range(10):
        assert _same_bits(rk[i], rp[i]), i
    assert int(rp[5].sum()) > 100


def test_static_contacts_kernel_matches_plain(world):
    s, sw, cfg = world.state, world.static_world, world.config
    for k in (4, 8):
        args = (s, sw.heightfield, sw.has_heightfield, k, cfg.present_shape_types, sw.hulls,
                sw.trimesh)
        rk = kb.static_contacts(*args)
        rp = kb.static_contacts_plain(*args)
        for i in (0, 1, 5, 8):
            assert torch.equal(rk[i], rp[i]), (k, i)
        for i in (2, 3, 4, 6, 7):
            assert float((rk[i] - rp[i]).abs().max()) <= 1e-5, (k, i)


def test_solve_iterations_kernel_matches_plain(world):
    s, pc, cfg = world.state, world.pair_cache, world.config
    wm = narrowphase.blocked_manifold_width(cfg, s.capacity)
    pair_cts, _, _ = narrowphase.pair_contacts(s, pc.pair_a, pc.pair_b, pc.pair_valid,
                                               cfg, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(s, world.static_world, cfg)
    setup = solver.prepare_solve(s, static_cts, pair_cts, DT, world.params, cfg,
                                 world.solver_cache, wm=wm, table=pc.inc_table,
                                 sign=pc.inc_sign)
    stk, lk, ak = solver.iterate(setup, s.linvel, s.angvel, 7, step=kc.solve_iteration)
    stp, lp, ap = solver.iterate(setup, s.linvel, s.angvel, 7,
                                 step=kc.solve_iteration_plain)
    assert float((lk - lp).abs().max()) <= 1e-4
    assert float((ak - ap).abs().max()) <= 1e-4
    assert float((stk.p_l - stp.p_l).abs().max()) <= 1e-4 * max(float(stp.p_l.abs().max()), 1.0)


def _kc_passes(setup, linvel, angvel, iters, what):
    """KC against its twin at every pass of one solve (the warm pre-apply,
    then each iteration), each side chained from its own state, both from
    the same rows: linvel, angvel, s_y, s_l, p_y and p_l equal to the bit;
    then the planned whole solve equal to the chain's end."""
    st_k = st_p = setup.state0
    lk = lp = linvel
    ak = ap = angvel
    sched = ([(0.0, True)] if setup.warm else []) + [(b, False) for b in kc.betas(iters)]
    for i, (beta, warm) in enumerate(sched):
        st_k, lk, ak = kc.solve_iteration(setup.rows, st_k, lk, ak, beta, warm)
        st_p, lp, ap = kc.solve_iteration_plain(setup.rows, st_p, lp, ap, beta, warm)
        for x, y, name in ((lk, lp, "linvel"), (ak, ap, "angvel"), (st_k.s_y, st_p.s_y, "s_y"),
                           (st_k.s_l, st_p.s_l, "s_l"), (st_k.p_y, st_p.p_y, "p_y"),
                           (st_k.p_l, st_p.p_l, "p_l")):
            assert torch.equal(x, y), (what, i, name)
    st_f, lf, af = kc.solve(setup.rows, setup.state0, linvel, angvel, iters, setup.warm)
    for x, y, name in ((lf, lk, "linvel"), (af, ak, "angvel"), (st_f.s_l, st_k.s_l, "s_l"),
                       (st_f.p_l, st_k.p_l, "p_l"), (st_f.s_y, st_k.s_y, "s_y"),
                       (st_f.p_y, st_k.p_y, "p_y")):
        assert torch.equal(x, y), (what, "plan", name)
    return len(sched)


def test_solve_every_pass_matches_plain(world):
    """KC at the warm pass and at each of the 7 iterations, from KQ's rows
    of the test world: every output equal to the twin's to the bit."""
    s, pc, cfg = world.state, world.pair_cache, world.config
    wm = narrowphase.blocked_manifold_width(cfg, s.capacity)
    pair_cts, _, _ = narrowphase.pair_contacts(s, pc.pair_a, pc.pair_b, pc.pair_valid,
                                               cfg, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(s, world.static_world, cfg)
    setup = solver.prepare_solve(s, static_cts, pair_cts, DT, world.params, cfg,
                                 world.solver_cache, wm=wm, table=pc.inc_table,
                                 sign=pc.inc_sign)
    assert _kc_passes(setup, s.linvel, s.angvel, 7, "world") == 8


@pytest.mark.parametrize("case", hard_cases.SOLVE_CASES)
def test_solve_hard_cases_kernels_match_plain(world, case):
    """KQ on kernels/hard_cases.py's solve scenes within 1e-6 of each
    output's scale (masks, slots and table entries exact) and its refresh
    exact; KC exact at every pass from KQ's rows."""
    from substrata_tpu_torch.kernels import solve_setup as kq
    from substrata_tpu_torch.physics.state import default_sim_params
    p = default_sim_params(device="cuda")
    body, st, pr, table, sign, cache, wm = hard_cases.solve_inputs(
        hard_cases.solve_scene(case), "cuda")
    args = (body, st, pr, table, sign)
    rk, ysk, ypk, (hk, vk) = kq.solve_setup(*args, p, DT, cache, wm)
    rp, ysp, ypp, (hp, vp) = kq.solve_setup_plain(
        *args, p.baumgarte, p.restitution_threshold, torch.full((), DT, device="cuda"), cache, wm)
    for f in ("s_dir", "s_ang", "s_r", "s_k", "s_target", "p_dir", "p_ang_a", "p_ang_b",
              "p_ra", "p_rb", "p_k", "p_target", "w", "im"):
        a, b = getattr(rk, f), getattr(rp, f)
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max())), (case, f)
    for f in ("s_valid", "p_valid", "p_ab", "tbl"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), (case, f)
    assert torch.equal(hk, hp) and torch.equal(vk, vp), case
    for a, b in ((ysk, ysp), (ypk, ypp)):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max())), case
    setup = solver.SolveSetup(rk, kc.SolveState(ysk, ysk, ypk, ypk), True, table, sign, (hk, vk))
    assert _kc_passes(setup, body.linvel, body.angvel, 7, case) == 8
    lam_s, lam_p = torch.rand_like(ysp), torch.rand_like(ypp)
    rargs = (cache, hp, vp, st, pr, lam_s, rp.s_valid, lam_p, rp.p_valid)
    ck, cp = kq.cache_refresh(*rargs), kq.cache_refresh_plain(*rargs)
    assert torch.equal(ck.view(torch.int32), cp.view(torch.int32)), case


def test_solve_plan_follows_its_inputs(world):
    """The planned solve on a second world of the same shape gives that
    world's answer (no plan or buffer outlives its solve), the first
    solve's outputs stay as they were, and a wrong dtype, device or shape
    still raises."""
    from substrata_tpu_torch.kernels import solve_setup as kq
    from substrata_tpu_torch.physics.state import default_sim_params
    p = default_sim_params(device="cuda")
    outs = []
    for case in ("wm4", "asleep"):
        body, st, pr, table, sign, cache, wm = hard_cases.solve_inputs(
            hard_cases.solve_scene(case), "cuda")
        rk, ys, yp, _ = kq.solve_setup(body, st, pr, table, sign, p, DT, cache, wm)
        s0 = kc.SolveState(ys, ys, yp, yp)
        got = kc.solve(rk, s0, body.linvel, body.angvel, 7, True)
        want = _plain_solve(rk, s0, body.linvel, body.angvel)
        outs.append((got, [x.clone() for x in (got[1], got[2], got[0].p_l)], want))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), case
    (first, kept, _), _ = outs
    for x, y in zip((first[1], first[2], first[0].p_l), kept):
        assert torch.equal(x, y)
    body, st, pr, table, sign, cache, wm = hard_cases.solve_inputs(
        hard_cases.solve_scene("wm4"), "cuda")
    rk, ys, yp, _ = kq.solve_setup(body, st, pr, table, sign, p, DT, cache, wm)
    s0 = kc.SolveState(ys, ys, yp, yp)
    with pytest.raises(TypeError):
        kc.solve(rk, s0, body.linvel.double(), body.angvel, 7, True)
    with pytest.raises(ValueError):
        kc.solve(rk, s0, body.linvel, body.angvel.cpu(), 7, True)
    with pytest.raises(ValueError):
        kc.solve(rk, s0, body.linvel[:-1], body.angvel, 7, True)
    bad = kc.ContactRows(**{**{f: getattr(rk, f) for f in kc._KQ_FIELDS},
                            "s_fric": rk.s_fric, "p_fric": rk.p_fric[:-1]})
    with pytest.raises(ValueError):
        kc.solve(bad, s0, body.linvel, body.angvel, 7, True)


def _plain_solve(rows, st0, linvel, angvel):
    st, lin, ang = kc.solve_iteration_plain(rows, st0, linvel, angvel, 0.0, True)
    for beta in kc.betas(7):
        st, lin, ang = kc.solve_iteration_plain(rows, st, lin, ang, beta)
    return st, lin, ang


def test_integrate_kernels_match_plain(world):
    s = world.state.replace(
        linvel=world.state.linvel + 0.3,
        underwater=torch.zeros_like(world.state.underwater))
    params = world.params.replace(water_z=torch.tensor(0.6, device="cuda"))
    lk, ak, wk = kd.apply_forces(s, DT, params)
    lp, ap, wp = kd.apply_forces_plain(s, DT, params)
    assert torch.equal(wk, wp) and bool(wp.any())          # some bodies in water
    assert float((lk - lp).abs().max()) <= 1e-6
    assert float((ak - ap).abs().max()) <= 1e-6
    pk, qk = kd.integrate_positions(s, lp, ap, DT)
    pp, qp = kd.integrate_positions_plain(s, lp, ap, DT)
    assert float((pk - pp).abs().max()) <= 1e-6
    assert float((qk - qp).abs().max()) <= 1e-6


def test_wrappers_refuse_mismatched_devices(world):
    s, pc = world.state, world.pair_cache
    with pytest.raises(ValueError):
        ka.box_box_rows(s.pos, s.quat, s.shape_params, s.friction, s.restitution,
                        s.is_sensor, pc.pair_a.cpu(), pc.pair_b, pc.pair_valid)


@pytest.fixture(scope="module")
def audio(world):
    """bench.py's 256-source scene on the world's bodies, after 10 blocks."""
    src, pool, lis, room = bench_audio("cuda")
    idx = torch.arange(src.capacity, device="cuda") % world.state.capacity
    src = src.replace(pos=world.state.pos[idx], vel=world.state.linvel[idx])
    for _ in range(10):
        src, _, room = mix.mix_block(src, pool, lis, room=room, block=TICK_FRAMES)
    st = mix.prepare(src, lis, TICK_FRAMES, TICK_FRAMES / mix.ENGINE_RATE, True)
    return src, pool, lis, room, st


def _kf_vs_chain(args, what):
    """KF (``audio_spatialise``, fetch folded in) against
    ``fetch_spatialise_plain`` on the same CUDA tensors: every output to
    the bit (the level and the smoothed level NaN where the twin's is),
    the epilogue's fields through ``epilogue_views``.  Returns both
    outputs."""
    fk = kaudio.audio_spatialise(*args)
    fp = kaudio.fetch_spatialise_plain(*args)
    names = ("wl", "wr", "ws", "lp_out", "new_hist")
    for name, x, y in zip(names, fk, fp):
        if y is not None and y.numel():
            assert float((x - y).abs().max()) <= 1e-5, (what, name)
        assert _same_bits(x, y), (what, name)
    assert _same_or_nan(fk[5], fp[5]), (what, "level")
    assert _same_bits(fk[7], fp[7]), (what, "new_playhead")
    s = fk[5].shape[0]
    ek, ep = kaudio.epilogue_views(fk[6], s), kaudio.epilogue_views(fp[6], s)
    assert torch.equal(ek["finished"], ep["finished"]), what
    assert torch.equal(ek["alive"], ep["alive"]), what
    assert _same_or_nan(ek["smoothed_level"], ep["smoothed_level"]), what
    return fk, fp


def test_audio_kernels_match_plain(audio):
    """KF, which fetches its own frames, against the fetch's twin chained
    into the spatialiser's (``fetch_spatialise_plain``), HRTF on and off;
    KG against its twin."""
    src, pool, lis, room, st = audio
    b = TICK_FRAMES
    for use_hrtf in (True, False):
        args = (mix.fetch_args(pool, src, st.eff_delta, st.active, b), src.lp_state, st.alpha,
                st.use_lp, src.spatial, src.hrir_hist, hrir_bank_tensor("cuda"), st.dir_idx,
                src.prev_gain_l, src.prev_gain_r, st.gl, st.gr, mix.gain_ramp(b, "cuda"),
                st.gain, st.send_gain, use_hrtf,
                (src.finished, src.smoothed_level, src.alive, src.remove_on_finish))
        fk, fp = _kf_vs_chain(args, f"bench, HRTF {use_hrtf}")
        assert float(fp[0].abs().max()) > 0.01
    gargs = (fp[0], fp[1], fp[2], lis.master_volume, room.delay_lines, room.write_idx,
             room.delays, room.feedback, room.wet)
    gk = kaudio.audio_downmix_reverb(*gargs)
    gp = kaudio.audio_downmix_reverb_plain(*gargs)
    assert float((gk[0] - gp[0]).abs().max()) <= 1e-5
    assert float((gk[1] - gp[1]).abs().max()) <= 1e-5 and torch.equal(gk[2], gp[2])
    ok, _, _ = kaudio.audio_downmix_reverb(fp[0], fp[1], None, lis.master_volume)
    op, _, _ = kaudio.audio_downmix_reverb_plain(fp[0], fp[1], None, lis.master_volume)
    assert float((ok - op).abs().max()) <= 1e-5


def test_entry_points_default_to_the_card(world):
    w = PhysicsWorld(SimConfig(capacity=32, max_pairs=256, grid_dim=16))
    assert w.device.type == "cuda" and w.state.pos.device.type == "cuda"
    eng = AudioEngine(max_sources=4, pool_size=1 << 16)
    assert eng.device.type == "cuda" and eng.pool.device.type == "cuda"
    assert eng.sources.playhead.device.type == "cuda"


@pytest.fixture(scope="module")
def fulltick():
    """A 400-box full-tick scene (vehicles, particles, 16 sources) after
    10 full ticks on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = SimConfig(capacity=512, max_pairs=2048, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    w = benchworld.bench_world("cuda", n_bodies=400, cfg=cfg)
    veh, vin, ps, char, scripts = benchworld.bench_fulltick(w, "cuda", n_particles=512,
                                                            n_vehicles=8)
    src, pool, lis, room = bench_audio("cuda", n_sources=16)
    idx = torch.arange(16, device="cuda")
    for t in range(10):
        veh, ps, src, _, room, char = benchworld.full_tick(w, veh, vin, ps, src, pool, lis,
                                                           room, idx, char, t * DT, scripts)
    return w, veh, vin, ps


def _ray_args(w, o, d, mt, ex):
    body, cfg = w.state, w.config
    table = broadphase.build_cell_table(body, cfg)[0]
    sw = w.static_world
    return (o, d, mt, body, table, queries.oversize_slots(body, cfg), sw.heightfield,
            sw.has_heightfield, ex, sw.hulls, sw.trimesh)


def _check_rays(args, **kw):
    rk, rp = kray.ray_trace(*args, **kw), kray.ray_trace_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rk[3], rp[3]) and torch.equal(rk[2], rp[2])
    assert float((rk[0] - rp[0]).abs().max()) <= 1e-6
    assert float((rk[1] - rp[1]).abs().max()) <= 1e-6
    return rp


def test_ray_trace_kernel_matches_plain(fulltick):
    w, veh, vin, ps = fulltick
    cfg = w.config
    kw = dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, collidable_only=True, k=16)
    dirs, mt = motion_rays(ps, DT)
    none = torch.full((ps.capacity,), -1, dtype=torch.int32, device="cuda")
    _check_rays(_ray_args(w, ps.pos, dirs, mt, none), n_steps=4, body_steps=1, dedup=False, **kw)
    _, wheel = chassis_and_wheel_rays(veh, w.state)
    rp = _check_rays(_ray_args(w, *wheel), n_steps=4, body_steps=4, dedup=True, **kw)
    assert bool(rp[3].any())
    # The facade's default march (16 steps, 928 candidates a ray), long
    # random rays, over a bilinear heightfield.
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    o = torch.rand((256, 3), generator=g, device="cuda") * 30.0 - 15.0
    o[:, 2] = o[:, 2].abs() * 0.2
    d = torch.randn((256, 3), generator=g, device="cuda")
    d = d / d.norm(dim=1, keepdim=True)
    mt = torch.rand(256, generator=g, device="cuda") * 10.0 + 1.0
    none = torch.full((256,), -1, dtype=torch.int32, device="cuda")
    hw = PhysicsWorld(cfg, device="cuda")
    hw.state = w.state
    hw.set_heightfield(np.random.default_rng(1).uniform(-0.3, 0.5, (33, 33)), [-20, -20], 1.25)
    for dedup in (True, False):
        rp = _check_rays(_ray_args(hw, o, d, mt, none), n_steps=16, body_steps=16, dedup=dedup,
                         **kw)
    assert int((rp[2] >= 0).sum()) > 5 and int((rp[3] & (rp[2] < 0)).sum()) > 5


@pytest.mark.parametrize("case", hard_cases.RAY_CASES)
def test_ray_trace_kernel_hard_cases(case):
    """KH on kernels/hard_cases.py's ray scenes (24 keys tied at 0, a body
    met twice through a hash collision, rays whose every candidate row is
    empty, a trimesh of sparse cells) at every call shape of RAY_CALLS,
    single-step marches included: hit, body and material exact, t and
    normal within 1e-6; a CPU tensor among CUDA ones raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.ray_scene(case, seed=0)
    for call in hard_cases.RAY_CALLS:
        args, kw = hard_cases.ray_inputs(scene, call, "cuda")
        rp = _check_rays(args, **kw)
        assert torch.equal(kray.ray_trace(*args, **kw)[4], rp[4]), call
    with pytest.raises(ValueError):
        kray.ray_trace(args[0], args[1].cpu(), *args[2:], **kw)


def test_particles_kernel_matches_plain(fulltick):
    w, veh, vin, ps = fulltick
    dirs, mt = motion_rays(ps, DT)
    hits = queries.trace_rays(ps.pos, dirs, mt, w.state, w.static_world, w.config, n_steps=4,
                              body_steps=1, dedup=False)
    water = torch.tensor(0.8, device="cuda")       # some particles under water
    die = ps.replace(die_on_hit=torch.arange(ps.capacity, device="cuda") % 3 == 0)
    for state in (ps, die):
        ik = kpart.particles_update(state, hits.t, hits.normal, hits.hit, DT, water)
        ip = kpart.particles_update_plain(state, hits.t, hits.normal, hits.hit, DT, water)
        for x, y in zip(ik[:4], ip[:4]):
            assert float((x - y).abs().max()) <= 1e-6
        assert torch.equal(ik[4], ip[4]) and torch.equal(ik[5], ip[5])
    assert bool(ip[5].any())


def test_vehicle_kernel_matches_plain(fulltick):
    w, veh, vin, ps = fulltick
    chassis, wheel = chassis_and_wheel_rays(veh, w.state)
    hits = queries.trace_rays(*wheel[:3], w.state, w.static_world, w.config, n_steps=4,
                              exclude=wheel[3])
    nv = veh.vtype.shape[0]
    for inp in (vin, vin.replace(forward=-vin.forward, brake=torch.ones_like(vin.brake),
                                 up=torch.ones_like(vin.up))):
        args = (veh.replace(righting_active=torch.ones_like(veh.righting_active)), inp,
                *chassis, hits.t.reshape(nv, 4), hits.normal.reshape(nv, 4, 3),
                hits.hit.reshape(nv, 4), torch.tensor(0.3, device="cuda"), DT)
        jk, jp = kveh.vehicle_forces(*args), kveh.vehicle_forces_plain(*args)
        for x, y in zip(jk, jp):
            if y.dtype in (torch.bool, torch.int32):
                assert torch.equal(x, y)
            else:
                assert float((x - y).abs().max()) <= 1e-5 * max(1.0, float(y.abs().max()))


def test_full_tick_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    runs = {}
    for dev in ("cuda", "cpu"):
        w = benchworld.bench_world(dev, n_bodies=200, cfg=cfg)
        veh, vin, ps, char, scripts = benchworld.bench_fulltick(w, dev, n_particles=256,
                                                                n_vehicles=4)
        src, pool, lis, room = bench_audio(dev, n_sources=16)
        idx = torch.arange(16, device=dev)
        for t in range(5):
            veh, ps, src, out, room, char = benchworld.full_tick(w, veh, vin, ps, src, pool, lis,
                                                                 room, idx, char, t * DT,
                                                                 scripts)
        runs[dev] = (w.state.pos.cpu(), ps.pos.cpu(), out.cpu(), char.pos.cpu(),
                     scripts.out.cpu())
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# KK, KL, KM, KN
# ---------------------------------------------------------------------------

def _random_rows(gen, code, n):
    """Per-side (pos, quat, params) at random poses within touching range."""
    out = []
    for st in (code // 4, code % 4):
        q = torch.randn((n, 4), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        u = torch.rand((n, 4), generator=gen, device="cuda")
        prm = torch.zeros((n, 4), device="cuda")
        if st == 0:
            prm[:, 0] = 0.2 + 0.4 * u[:, 0]
        elif st == 1:
            prm[:, :3] = 0.2 + 0.5 * u[:, :3]
        else:
            prm[:, 0] = 0.15 + 0.25 * u[:, 0]
            prm[:, 1] = 0.2 + 0.4 * u[:, 1]
        p = torch.rand((n, 3), generator=gen, device="cuda") * 1.2 - 0.6
        out.append((p, q, prm, st))
    return out


def test_closed_form_kernel_matches_plain():
    """KK on 4,096 random pairs of each closed-form code, in both layouts."""
    from substrata_tpu_torch.kernels import closed_forms as kk
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    n = 4096
    for code in kk.CODES:
        (pa, qa, ra, sa), (pb, qb, rb, sb) = _random_rows(gen, code, n)
        pos = torch.cat([pa, pb])
        quat = torch.cat([qa, qb])
        prm = torch.cat([ra, rb])
        fr = torch.rand(2 * n, generator=gen, device="cuda")
        re = torch.rand(2 * n, generator=gen, device="cuda")
        sens = torch.rand(2 * n, generator=gen, device="cuda") < 0.05
        ba = torch.arange(n, dtype=torch.int32, device="cuda")
        bb = ba + n
        bv = torch.rand(n, generator=gen, device="cuda") < 0.9
        for wm, blocked in ((4, True), (2, False), (1, False)):
            args = (code, wm, blocked, pos, quat, prm, fr, re, sens, ba, bb, bv)
            rk, rp = kk.closed_form_rows(*args), kk.closed_form_rows_plain(*args)
            torch.cuda.synchronize()
            for i in (0, 1, 5, 6, 7, 8, 9):
                assert torch.equal(rk[i], rp[i]), (code, wm, i)
            for i in (2, 3, 4):
                assert float((rk[i] - rp[i]).abs()[rp[5]].max()) <= 1e-5, (code, wm, i)
        assert int(rp[9].sum()) > n // 10


def _serving(device, n_bodies=200, eye_pos=(0.0, 0.0, 1.67)):
    cfg = SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    return benchworld.serving_world(device, n_bodies=n_bodies, cfg=cfg, eye_pos=eye_pos)


def test_character_kernel_matches_plain():
    """KL against its twin on a serving world's state after 20 ticks, and
    on a 0.35 m step that takes the stair branch and a ledge that takes the
    stick branch."""
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.physics import character as tchar
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p = _serving("cuda")
    for t in range(20):
        benchworld.serving_tick(w, p, t * DT)
    cases = [(w, p.state, benchworld.walk_input(20 * DT), p.proxy.slot)]
    for he, pos, eye in (([1.0, 1.0, 0.175], [1.35, 0, 0.175], (0.0, 0, 1.67)),
                         ([1.0, 2.0, 0.2], [-0.7, 0, 0.2], (0.40, 0, 2.07))):
        sw = PhysicsWorld(SimConfig(capacity=64, max_pairs=256, grid_dim=16, cell_size=1.4,
                                    cell_capacity=6), device="cuda")
        sw.set_ground_plane(0.0)
        sw.add_object(PhysicsObject(shape=shapes.make_box(he), pos=np.array(pos, np.float32),
                                    motion_type=int(MotionType.STATIC)))
        sw._flush()
        st = tchar.init_character_state(eye, device="cuda").replace(
            gravity_enabled=torch.ones((), dtype=torch.bool, device="cuda"))
        cases.append((sw, st, np.array([3.0, 0, 0], np.float32), -1))
    for world, st, move, ex in cases:
        body, cfg, stw = world.state, world.config, world.static_world
        table = broadphase.build_cell_table(body, cfg)[0]
        os_idx = queries.oversize_slots(body, cfg)
        for _ in range(3):
            scal = torch.as_tensor(tchar.tick_scalars(DT, move, False, False, False, ex),
                                   device="cuda")
            args = ({f: getattr(st, f) for f in tchar.CHARACTER_FIELDS}, body, stw.heightfield,
                    stw.has_heightfield, world.params.water_z, table, os_idx, scal)
            kw = dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim)
            nk, pk = kl.character_packed(*args, **kw)
            npl, pp = kl.character_packed_plain(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(pk[15:], pp[15:]) and torch.equal(pk[4:6], pp[4:6])
            assert float((pk - pp).abs().max()) <= 1e-6 * max(1.0, float(pp.abs().max()))
            for f in ("on_ground", "gravity_enabled", "fly_mode", "sitting"):
                assert bool(nk[f]) == bool(npl[f]), f
            st = tchar.CharacterState(**npl)


@pytest.mark.parametrize("case", hard_cases.CHARACTER_CASES)
def test_character_kernel_hard_cases(case):
    """KL against its twin at every update of kernels/hard_cases.py's
    character scenes (the stair walk landing at its first, eighth and ninth
    depth and at none, the forward column, stick-to-floor at each offset, 4
    m cells, a trimesh step), each update from the twin's state: flags and
    the touched list exact, the rest within 1e-6 of scale; the twin takes
    the scene's branch at its update; a CPU tensor among CUDA ones raises."""
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.physics import character as tchar
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.character_scene(case)
    world = hard_cases.character_world(scene, "cuda")
    body, cfg, stw = world.state, world.config, world.static_world
    table = broadphase.build_cell_table(body, cfg)[0]
    os_idx = queries.oversize_slots(body, cfg)
    kw = dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, trimesh=stw.trimesh)
    st = tchar.init_character_state(scene.eye, device="cuda").replace(
        gravity_enabled=torch.ones((), dtype=torch.bool, device="cuda"))
    for i in range(scene.updates):
        scal = torch.as_tensor(tchar.tick_scalars(DT, np.array(scene.move, np.float32), False,
                                                  False, False, -1), device="cuda")
        args = ({f: getattr(st, f) for f in tchar.CHARACTER_FIELDS}, body, stw.heightfield,
                stw.has_heightfield, world.params.water_z, table, os_idx, scal)
        nk, pk = kl.character_packed(*args, **kw)
        (npl, pp), seen = hard_cases.observe_branches(
            lambda: kl.character_packed_plain(*args, **kw))
        torch.cuda.synchronize()
        assert torch.equal(pk[15:], pp[15:]) and torch.equal(pk[4:6], pp[4:6]), i
        assert float((pk - pp).abs().max()) <= 1e-6 * max(1.0, float(pp.abs().max())), i
        for f in kl.STATE_FIELDS:
            assert float((nk[f].float() - npl[f].float()).abs().max()) <= 1e-6, (i, f)
        if i == scene.at and scene.branch is not None:
            assert seen.get(scene.branch[0], "absent") == scene.branch[1], (i, seen)
        st = tchar.CharacterState(**npl)
    with pytest.raises(ValueError):
        kl.character_packed(*args[:5], table.cpu(), *args[6:], **kw)


def test_serving_io_kernels_match_plain():
    """KM with 128 writes and 64 regions, padded and not; KN on a real
    step's events: both exact."""
    from substrata_tpu_torch.kernels import serving_io as km
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p = _serving("cuda")
    for t in range(15):
        benchworld.serving_tick(w, p, t * DT)
    n = w.state.capacity
    rng = np.random.default_rng(2)
    for padded in (True, False):
        buf = km.empty_tick_in(n)
        buf[km.O_IDX:km.O_POS].view(np.int32)[:] = rng.permutation(n)[:km.TIN_K]
        buf[km.O_POS:km.O_VOK] = rng.normal(size=km.O_VOK - km.O_POS)
        buf[km.O_VOK:km.O_CTR] = rng.integers(0, 2, km.TIN_K)
        buf[km.O_CTR:km.O_RAD] = rng.uniform(-8, 8, 3 * km.TIN_R)
        buf[km.O_RAD:] = rng.uniform(0.1, 1.0, km.TIN_R)
        if padded:
            buf[km.O_RAD + 10:] = -1e9
        tin = torch.as_tensor(buf, device="cuda")
        got = km.apply_tick_in(w.state, tin)
        ref = km.apply_tick_in_plain(w.state, tin)
        for f, x in zip(km.STATE_OUT, ref):
            assert torch.equal(getattr(got, f), x), f
    ev, dg = w.last_events, w.last_diags
    dk, bk = km.digest_tblock(ev, dg.num_contacts, dg.num_awake, w.pair_cache.steps_left,
                              w.state)
    dp, bp = km.digest_tblock_plain(ev, dg.num_contacts, dg.num_awake,
                                    w.pair_cache.steps_left, w.state)
    assert torch.equal(dk, dp) and torch.equal(bk, bp)
    dn, bn = km.digest_tblock(ev, dg.num_contacts, dg.num_awake, w.pair_cache.steps_left,
                              w.state, with_block=False)
    assert torch.equal(dn, dp) and bn is None


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                       b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("case", hard_cases.DIGEST_CASES)
def test_digest_hard_cases(case):
    """KN against its twin on kernels/hard_cases.py's digest scenes, the
    digest and the transform block to the bit, with and without the block
    and into a given buffer; three launches in a row on one plan (the
    ticket the last block resets) give the same digest."""
    from substrata_tpu_torch.kernels import serving_io as km
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = hard_cases.digest_inputs(hard_cases.digest_scene(case), "cuda")
    dp, bp = km.digest_tblock_plain(*args)
    for _ in range(3):
        dk, bk = km.digest_tblock(*args)
        assert torch.equal(dk, dp) and _same_bits(bk, bp)
    out = torch.full_like(dp, 7)
    dn, bn = km.digest_tblock(*args, out=out, with_block=False)
    assert dn is out and bn is None and torch.equal(out, dp)


@pytest.mark.parametrize("case", hard_cases.SPATIALISE_CASES)
def test_spatialise_hard_cases(case):
    """KF against its twins chained on kernels/hard_cases.py's spatialise
    scenes, fed through a fetch (``spatialise_fed``): every output
    (wl, wr, ws, lp_out, new_hist, level, new_playhead) within 1e-5 and
    equal to the bit (the kernel repeats the twins' operations in order),
    and the folded epilogue's three fields to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _kf_vs_chain(hard_cases.fetch_inputs(hard_cases.spatialise_fed(case), "cuda"), case)


@pytest.mark.parametrize("case", hard_cases.FETCH_CASES)
def test_fetch_hard_cases(case):
    """KF with its fetch against the twins chained on kernels/hard_cases.py's
    fetch scenes: every output to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _kf_vs_chain(hard_cases.fetch_inputs(hard_cases.fetch_scene(case), "cuda"), case)


@pytest.mark.parametrize("case", hard_cases.TICK_IN_CASES)
def test_tick_in_hard_cases(case):
    """KM against its twin on kernels/hard_cases.py's tick-input scenes,
    every output word for word."""
    from substrata_tpu_torch.kernels import serving_io as km
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st, tin = hard_cases.tick_in_inputs(hard_cases.tick_in_scene(case), "cuda")
    got = km.apply_tick_in(st, tin)
    want = km.apply_tick_in_plain(st, tin)
    for f, y in zip(km.STATE_OUT, want):
        assert _same_bits(getattr(got, f), y), (case, f)


@pytest.mark.parametrize("case", hard_cases.VEHICLE_CASES)
def test_vehicle_hard_cases(case):
    """KJ against its twin on kernels/hard_cases.py's vehicle scenes: every
    float output within 1e-5 of its scale, gear and contact exact; a second
    call on the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = hard_cases.vehicle_inputs(hard_cases.vehicle_scene(case), "cuda")
    jk = kveh.vehicle_forces(*args)
    jp = kveh.vehicle_forces_plain(*args)
    for x, y in zip(jk, jp):
        assert x.shape == y.shape and x.dtype == y.dtype
        if y.dtype in (torch.bool, torch.int32):
            assert torch.equal(x, y)
        else:
            assert float((x - y).abs().max()) <= 1e-5 * max(1.0, float(y.abs().max()))
    again = kveh.vehicle_forces(*args)
    assert all(_same_bits(x, y) for x, y in zip(again, jk))


@pytest.mark.parametrize("case", hard_cases.INCIDENCE_CASES)
def test_incidence_hard_cases(case):
    """KT's incidence table against its twin on kernels/hard_cases.py's
    incidence scenes, table, sign and counts to the bit; three calls in a
    row on one plan (the counters each select pass sets back to 0) agree,
    and a table held from the first call is not written by the next ones."""
    from substrata_tpu_torch.kernels import layout as kt
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, occ, n, cpb = hard_cases.incidence_inputs(hard_cases.incidence_scene(case), "cuda")
    ip = kt.incidence_plain(a.contiguous(), b.contiguous(), occ, n, cpb)
    first = kt.incidence(a, b, occ, n, cpb)
    held = [t.clone() for t in first]
    for _ in range(2):
        ik = kt.incidence(a, b, occ, n, cpb)
        assert all(_same_bits(x, y) for x, y in zip(ik, ip))
    other = kt.incidence(a, b, occ & (torch.arange(a.shape[0], device="cuda") % 2 == 0), n,
                         cpb)
    assert all(_same_bits(x, y) for x, y in zip(first, held))
    assert all(_same_bits(x, y) for x, y in zip(first, ip))
    assert other[0].data_ptr() != first[0].data_ptr()


@pytest.mark.parametrize("case", hard_cases.CLOSED_FORM_CASES)
def test_closed_form_hard_cases(case):
    """KK against its twin on kernels/hard_cases.py's closed-form scenes,
    one launch over each scene's buckets: points, normals and depths within
    1e-5 on the valid rows, ids, masks, keys and touching exact; the same
    bits again from a copy of the buckets' arrays, and buckets copied apart
    refused; the pair scenes also
    through ``pair_contacts`` on the card against the CPU path."""
    from substrata_tpu_torch.kernels import closed_forms as kk
    from substrata_tpu_torch.physics import narrowphase
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.closed_form_scene(case)
    buckets, wms, blocked, *rows = hard_cases.closed_form_inputs(scene, "cuda")
    got = kk.closed_form_buckets(buckets, wms, blocked, *rows)
    for (code, ba, bb, bv), wm, rk in zip(buckets, wms, got):
        rp = kk.closed_form_rows_plain(code, wm, blocked, *rows, ba, bb, bv)
        for i in (0, 1, 5, 6, 7, 8, 9):
            assert torch.equal(rk[i], rp[i]), (case, code, i)
        for i in (2, 3, 4):
            if bool(rp[5].any()):
                assert float((rk[i] - rp[i]).abs()[rp[5]].max()) <= 1e-5, (case, code, i)
    sizes = [b[1].shape[0] for b in buckets]
    copies = (torch.cat([b[i] for b in buckets]).split(sizes) for i in (1, 2, 3))
    again = kk.closed_form_buckets([(b[0], *x) for b, *x in zip(buckets, *copies)], wms,
                                   blocked, *rows)
    assert all(_same_bits(x, y) for g, a in zip(got, again) for x, y in zip(g, a)), case
    if len(buckets) > 1:
        with pytest.raises(ValueError):
            kk.closed_form_buckets([(c, ba.clone(), bb.clone(), bv.clone())
                                    for c, ba, bb, bv in buckets], wms, blocked, *rows)
    if scene.pairs is not None:
        cargs, kw = hard_cases.closed_form_pair_inputs(scene, "cuda")
        pargs, _ = hard_cases.closed_form_pair_inputs(scene, "cpu")
        ck, tk, ok = narrowphase.pair_contacts(*cargs, **kw)
        cp, tp, op = narrowphase.pair_contacts(*pargs, **kw)
        assert torch.equal(tk.cpu(), tp) and int(ok) == int(op)
        for f in narrowphase.CONTACT_FIELDS:
            x, y = getattr(ck, f).cpu(), getattr(cp, f)
            if x.is_floating_point():
                assert float((x - y).abs()[cp.valid].max()) <= 1e-5, (case, f)
            else:
                assert torch.equal(x, y), (case, f)


@pytest.mark.parametrize("case", hard_cases.AUDIO_SETUP_CASES)
def test_audio_setup_hard_cases(case):
    """KAA's setup against its twin on kernels/hard_cases.py's audio-setup
    scenes, HRTF on and off: every field exact but the pan's cos and sin
    (1e-6 of the gains' scale) and an HRIR bin whose pre-round value lies
    within 1e-5 of a half-integer; the bytes the setup writes the same
    again on a second call."""
    import math
    from substrata_tpu_torch.kernels import audio_setup as kaa
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.audio_setup_scene(case)
    s, nl = scene.sources["delta"].shape
    for use_hrtf in (True, False):
        args = hard_cases.audio_setup_inputs(scene, "cuda", use_hrtf)
        bk = kaa.audio_setup(*args)
        k = kaa.setup_views(bk, s, nl)
        p = kaa.setup_views(kaa.audio_setup_plain(*args), s, nl)
        for name in ("active", "use_lp", "eff_delta", "dop_smooth", "mute", "gain", "alpha",
                     "send_gain"):
            assert torch.equal(k[name], p[name]), (case, name)
        if use_hrtf:
            assert torch.equal(k["gl"], p["gl"]) and torch.equal(k["gr"], p["gr"])
            pos, lp, right, fwd, up = args[4], args[13], args[15], args[16], args[17]
            to = pos - lp[None]
            x, y, z = (fp.dot3(to, v[None]) for v in (right, fwd, up))
            pa = torch.atan2(x, y) * fp.recip(2 * math.pi) * 16
            pe = (torch.atan2(z, torch.clamp(fp.sqrt(fp.fma(x, x, y * y)), min=1e-6))
                  + math.pi / 4) * fp.recip(math.pi / 2) * 2
            edge = ((pa - pa.floor() - 0.5).abs() <= 1e-5) | \
                ((pe - pe.floor() - 0.5).abs() <= 1e-5)
            assert torch.equal(k["dir_idx"][~edge], p["dir_idx"][~edge]), case
        else:
            for name in ("gl", "gr"):
                assert float((k[name] - p[name]).abs().max()) <= 1e-6 * max(
                    1.0, float(p[name].abs().max())), (case, name)
        written = 4 * (nl + 8) * s + 2 * s
        again = kaa.audio_setup(*args)
        assert torch.equal(bk.view(torch.uint8)[:written], again.view(torch.uint8)[:written])


def _push_world(device):
    """199 boxes resting apart and one 0.2 m box in the path of a player
    at eye (0, 0, 1.67), whose capsule proxy pushes it (the world of
    tests/test_torch_serving.py's push comparison)."""
    w = PhysicsWorld(SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4,
                               cell_capacity=6, solver_iters=7, pairs_per_body=10,
                               pair_rebuild_interval=6, contacts_per_body=8), device=device)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    pos = [[1.0, 0.0, 0.099]] + [[-3.0 - (n % 14) * 1.7 + rng.uniform(-0.1, 0.1),
                                  (n // 14 - 7) * 1.7 + rng.uniform(-0.1, 0.1), 0.399]
                                 for n in range(199)]
    for he, x in zip([0.1] + [0.4] * 199, pos):
        w.add_object(PhysicsObject(shape=shapes.make_box([he] * 3), pos=np.array(x, np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    return w, PlayerPhysics(w, eye_pos=(0.0, 0.0, 1.67))


def test_serving_tick_on_card_matches_cpu():
    """40 serving ticks of a 200-box world whose player pushes a small box
    (capsule-box contacts), on the card and on the CPU path: bodies and
    the character within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for dev in ("cuda", "cpu"):
        w, p = _push_world(dev)
        for t in range(40):
            benchworld.serving_tick(w, p, t * DT)
        runs[dev] = (w.state.pos.cpu(), w.state.linvel.cpu(), p.state.pos.cpu())
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# KO and the hull and trimesh branches of KB, KH and KL
# ---------------------------------------------------------------------------

def _hull_library(device):
    """A library of four interned hulls (cube, octahedron, a 60-point
    cloud, a tetrahedron), built as a world interns them."""
    w = PhysicsWorld(SimConfig(capacity=8, max_pairs=32, grid_dim=8), device=device)
    cube = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)])
    octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]) * 0.6
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]) * 0.8
    for v in (cube, octa, np.random.default_rng(9).normal(size=(60, 3)) * 0.4, tet):
        w._intern_hull(shapes.make_convex_hull(v))
    w._flush()
    return w.static_world.hulls


def _random_hull_rows(gen, code, n):
    out = _random_rows(gen, code, n)
    for side, st in enumerate((code // 4, code % 4)):
        if st == 3:
            out[side][2][:, 0] = torch.randint(0, 4, (n,), generator=gen, device="cuda").float()
    return out


def test_convex_kernel_matches_plain():
    """KO on 4,096 random pairs of each hull code, in both layouts: every
    output equal to the twin's to the bit."""
    from substrata_tpu_torch.kernels import convex as ko
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hulls = _hull_library("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    n = 4096
    for code in ko.CODES:
        (pa, qa, ra, _), (pb, qb, rb, _) = _random_hull_rows(gen, code, n)
        pos, quat, prm = torch.cat([pa, pb]), torch.cat([qa, qb]), torch.cat([ra, rb])
        fr = torch.rand(2 * n, generator=gen, device="cuda")
        re = torch.rand(2 * n, generator=gen, device="cuda")
        sens = torch.rand(2 * n, generator=gen, device="cuda") < 0.05
        ba = torch.arange(n, dtype=torch.int32, device="cuda")
        bv = torch.rand(n, generator=gen, device="cuda") < 0.9
        for wm, blocked in ((4, True), (narrowphase._MANIFOLD_WIDTH[code], False)):
            args = (code, wm, blocked, pos, quat, prm, fr, re, sens, ba, ba + n, bv, hulls)
            rk, rp = ko.convex_rows(*args), ko.convex_rows_plain(*args)
            torch.cuda.synchronize()
            for i in range(10):
                assert _same_bits(rk[i], rp[i]), (code, wm, i)
        assert int(rp[9].sum()) > n // 3


@pytest.mark.parametrize("case", hard_cases.CONVEX_CASES)
def test_convex_hard_cases(case):
    """KO against its twin on kernels/hard_cases.py's hull-contact scenes,
    one launch over each scene's buckets, every output to the bit; each
    bucket's rows the same bits as its own call (``convex_rows``), and
    buckets copied apart refused."""
    from substrata_tpu_torch.kernels import convex as ko
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    buckets, wms, blocked, *rows, lib = hard_cases.convex_inputs(
        hard_cases.convex_scene(case), "cuda")
    got = ko.convex_buckets(buckets, wms, blocked, *rows, lib)
    for (code, ba, bb, bv), wm, rk in zip(buckets, wms, got):
        args = (code, wm, blocked, *rows, ba, bb, bv, lib)
        rp = ko.convex_rows_plain(*args)
        for i in range(10):
            assert _same_bits(rk[i], rp[i]), (case, code, i)
        assert all(_same_bits(x, y) for x, y in zip(rk, ko.convex_rows(*args))), (case, code)
    if len(buckets) > 1:
        with pytest.raises(ValueError):
            ko.convex_buckets([(c, ba.clone(), bb.clone(), bv.clone())
                               for c, ba, bb, bv in buckets], wms, blocked, *rows, lib)


@pytest.mark.parametrize("case", hard_cases.POSE_CASES)
def test_pose_hard_cases(case):
    """KZ against its twin on kernels/hard_cases.py's pose scenes (1 to 256
    joints, clip edges, every option, padded avatars), to the bit."""
    from substrata_tpu_torch.kernels import pose as kz
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bank, rig, p = hard_cases.pose_inputs(hard_cases.pose_scene(case), "cuda")
    assert _same_bits(kz.pose(bank, rig, p), kz.pose_plain(bank, rig, p)), case


def _mesh(device):
    cfg = SimConfig(capacity=256, max_pairs=1024, grid_dim=32, cell_size=4.0, solver_iters=7,
                    pair_rebuild_interval=6)
    return benchworld.mesh_world(device, n_objects=1200, n_dynamic=96, cfg=cfg)


def test_mesh_kernels_match_plain():
    """KB, KH and KL with their hull and trimesh branches on a 1,200-object
    mesh world after 40 client frames: KB's rows, KH on the occlusion rays
    and 1,024 seeded rays into the field, KL on the player; masks, ids,
    owners and materials exact, floats within 1e-5 (KB), 1e-6 (KH) and
    1e-6 of scale (KL)."""
    from substrata_tpu_torch.kernels import character as kl
    from substrata_tpu_torch.physics import character as tchar
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p, src = _mesh("cuda")
    for t in range(40):
        benchworld.mesh_tick(w, p, t * DT, src)
    s, sw, cfg = w.state, w.static_world, w.config
    assert sw.n_tris > 10_000
    args = (s, sw.heightfield, sw.has_heightfield, 4, cfg.present_shape_types, sw.hulls,
            sw.trimesh, cfg.max_tri_candidates)
    rk, rp = kb.static_contacts(*args), kb.static_contacts_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 5, 8):
        assert torch.equal(rk[i], rp[i]), i
    for i in (2, 3, 4):
        assert float((rk[i] - rp[i]).abs()[rp[5]].max()) <= 1e-5, i
    ch = p.state
    cam = torch.cat([ch.pos[:2], (ch.pos[2:] + 1.67) - ch.campos_z_delta[None]])
    o, d, mt, _ = benchworld.occlusion_rays(cam, s.pos[src])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ro = torch.rand((1024, 3), generator=gen, device="cuda") * torch.tensor(
        [120.0, 120.0, 6.0], device="cuda") - torch.tensor([60.0, 60.0, -0.5], device="cuda")
    rd = torch.randn((1024, 3), generator=gen, device="cuda")
    rd = rd / rd.norm(dim=1, keepdim=True)
    rt = torch.rand(1024, generator=gen, device="cuda") * 40.0
    none = torch.full((1024,), -1, dtype=torch.int32, device="cuda")
    for rays in ((o, d, mt, torch.full_like(src, -1, dtype=torch.int32)), (ro, rd, rt, none)):
        a = _ray_args(w, *rays)
        rk = _check_rays(a, cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, n_steps=16,
                         body_steps=16, collidable_only=True, k=16, dedup=True)
        kr = kray.ray_trace(*a, cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, n_steps=16,
                            body_steps=16, collidable_only=True, k=16, dedup=True)
        assert torch.equal(kr[4], rk[4])
    assert int((rk[2] >= cfg.capacity).sum()) > 10          # trimesh owners (anchors)
    table = broadphase.build_cell_table(s, cfg)[0]
    scal = torch.as_tensor(tchar.tick_scalars(DT, benchworld.walk_input(40 * DT), False, False,
                                              False, p.proxy.slot), device="cuda")
    kargs = ({f: getattr(ch, f) for f in tchar.CHARACTER_FIELDS}, s, sw.heightfield,
             sw.has_heightfield, w.params.water_z, table, queries.oversize_slots(s, cfg), scal)
    kw = dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, trimesh=sw.trimesh)
    nk, pk = kl.character_packed(*kargs, **kw)
    npl, pp = kl.character_packed_plain(*kargs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk[15:], pp[15:]) and torch.equal(pk[4:6], pp[4:6])
    assert float((pk - pp).abs().max()) <= 1e-6 * max(1.0, float(pp.abs().max()))


def _kb_compare(args, what):
    """KB's kernel against its twin: ids, valid and keys exact; points,
    normals and depths within 1e-5 on the valid rows, friction and
    restitution within 1e-5."""
    rk, rp = kb.static_contacts(*args), kb.static_contacts_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 5, 8):
        assert rk[i].dtype == rp[i].dtype and torch.equal(rk[i], rp[i]), (what, i)
    for i in (2, 3, 4):
        d = (rk[i] - rp[i]).abs()[rp[5]]
        assert d.numel() == 0 or float(d.max()) <= 1e-5, (what, i)
    for i in (6, 7):
        assert float((rk[i] - rp[i]).abs().max()) <= 1e-5, (what, i)
    return rp


@pytest.mark.parametrize("case", hard_cases.STATIC_CASES)
def test_static_contacts_kernel_hard_cases(case):
    """KB on kernels/hard_cases.py's static-contact scenes (equal depths,
    a full cell cut to 16 candidates, empty cells, cell boundaries and one
    ulp either side, samples outside the grid and behind a far plane,
    ineligible bodies, mixed shapes and present flags, hull ring ties) at
    K = 1, 4 and 8; a CPU tensor among CUDA ones raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.static_scene(case)
    for k in hard_cases.STATIC_KS:
        args = hard_cases.static_inputs(scene, k, "cuda")
        rp = _kb_compare(args, (case, k))
        assert int(rp[5].sum()) > 0, (case, k)
    body = args[0]
    with pytest.raises(ValueError):
        kb.static_contacts(body.replace(awake=body.awake.cpu()), *args[1:])


def test_static_contacts_plan_follows_new_world():
    """KB's plan: a static world replaced by a new one of the same shapes
    (the trimesh raised, the ground lowered) gives the new world's rows; a
    wrong dtype, device or shape still raises; the plan cache stays
    bounded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.static_scene("mixed_present")
    args = hard_cases.static_inputs(scene, 4, "cuda")
    first = _kb_compare(args, "first world")
    tm, hf = args[6], args[1]
    raised = tm.replace(verts=tm.verts + torch.tensor([0.0, 0.0, 0.2], device="cuda"))
    lowered = hf.replace(heights=hf.heights - 0.3)
    second = _kb_compare((*args[:1], lowered, *args[2:6], raised, args[7]), "new world")
    assert not torch.equal(first[4], second[4])
    body = args[0]
    for bad, exc in ((body.replace(pos=body.pos.double()), TypeError),
                     (body.replace(quat=body.quat[:-1]), ValueError),
                     (body.replace(alive=body.alive.cpu()), ValueError)):
        with pytest.raises(exc):
            kb.static_contacts(bad, *args[1:])
    with pytest.raises(ValueError):
        kb.static_contacts(body, *args[1:6], raised.replace(tris=raised.tris.cpu()), args[7])
    with pytest.raises(TypeError):
        kb.static_contacts(body, lowered.replace(heights=lowered.heights.double()), *args[2:])
    for j in range(3 * kb._MAX_PLANS):
        kb.static_contacts(body, hf.replace(heights=hf.heights + 0.01 * j), *args[2:])
    assert len(kb._plans) <= kb._MAX_PLANS


def test_terrain_heights_plan_follows_new_field(terrain_field):
    """KW's field plan: a field replaced by new tensors of the same shape,
    or its heights written in place, gives the new heights; outputs made
    ahead are never shared; a wrong dtype, device or shape of the field or
    the points still raises; the plan cache stays bounded."""
    from substrata_tpu_torch.kernels import terrain as kt
    hf = terrain_field
    xy = torch.as_tensor(np.random.default_rng(3).uniform(-530, 530, (2048, 2))
                         .astype(np.float32), device="cuda")
    scale = float(hf.heights.abs().max()) + 3.0
    f1 = (hf.heights.clone(), hf.origin.clone(), hf.cell_w.clone())
    f2 = (hf.heights * 0.5 + 3.0, hf.origin + 1.5, hf.cell_w * 1.25)
    for f in (f1, f2, f1):
        for normals in (False, True):
            got = kt.terrain_heights(*f, xy, normals)
            want = kt.terrain_heights_plain(*f, xy, normals)
            assert float((got - want).abs().max()) <= 1e-6 * scale, normals
    f1[0].mul_(-1.0)
    got, want = kt.terrain_heights(*f1, xy), kt.terrain_heights_plain(*f1, xy)
    assert float((got - want).abs().max()) <= 1e-6 * scale
    # Outputs made ahead never share memory: each call's result stays its
    # own after the calls that follow it.
    kept = [(kt.terrain_heights(*f1, xy + j), xy + j) for j in range(2 * kt._OUT_BATCH + 1)]
    assert len({out.data_ptr() for out, _ in kept}) == len(kept)
    for out, pts in kept:
        assert float((out - kt.terrain_heights_plain(*f1, pts)).abs().max()) <= 1e-6 * scale
    for bad, exc in ((xy.double(), TypeError), (xy[:, :1], ValueError),
                     (xy.t().contiguous().t(), ValueError)):
        with pytest.raises(exc):
            kt.terrain_heights(*f1, bad)
    for f, exc in (((f1[0].double(), *f1[1:]), TypeError), ((f1[0].cpu(), *f1[1:]), ValueError),
                   ((f1[0], f1[1][:1], f1[2]), ValueError)):
        with pytest.raises(exc):
            kt.terrain_heights(*f, xy)
    for j in range(3 * kt._MAX_FIELD_PLANS):
        kt.terrain_heights(f1[0] + j, *f1[1:], xy)
    assert len(kt._field_plans) <= kt._MAX_FIELD_PLANS


def test_mesh_world_on_card_matches_cpu():
    """40 client frames of a 1,200-object mesh world on the card and on the
    CPU path: the hulls within 1e-5 over frames 0-8, before the first
    trimesh kick (chip_smoke.py:small_mesh_phase says why not after), the
    character within 1e-5 and the hit masks equal over all 40; and the
    hulls and the character equal to the bit over all 40."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for dev in ("cuda", "cpu"):
        w, p, src = _mesh(dev)
        frames = []
        for t in range(40):
            hit = benchworld.mesh_tick(w, p, t * DT, src)[1]
            frames.append((w.state.pos[src].cpu(), p.state.pos.cpu(), hit))
        runs[dev] = frames
    for t, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if t < 9:
            assert float((a[0] - b[0]).abs().max()) <= 1e-5, t
        assert float((a[1] - b[1]).abs().max()) <= 1e-5, t
        assert np.array_equal(a[2], b[2]), t
    # Since KD's exp and quat.normalize's root round alike on both devices,
    # the two paths are equal to the bit, the kicked hulls included.
    for t, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), t


def test_cell_table_kernel_matches_plain(world):
    """KP: table, cells and overflow exact in both modes, on the world and
    on the same bodies moved onto the 1.4 m lattice (k * 1.4 and one ulp
    either side); with the world's buckets and with grid_dim 256's
    65,536."""
    from substrata_tpu_torch.kernels import cell_table as kp
    s, cfg = world.state, world.config
    rng = np.random.default_rng(5)
    base = rng.integers(1, 40, (s.capacity, 3)).astype(np.float32) * np.float32(1.4)
    lat = np.where(rng.random(base.shape) < 0.5, np.nextafter(base, np.float32(0)), base)
    for nb in (cfg.grid_dim ** 2, 256 ** 2):
        kw = dict(num_buckets=nb, cap=cfg.cell_capacity,
                  rcp_cell=fp.recip(cfg.cell_size), cell_size=cfg.cell_size)
        for b in (s, s.replace(pos=torch.as_tensor(lat, device="cuda"))):
            args = (b.pos, b.alive, b.collidable, b.awake, b.motion_type, b.bound_radius)
            for flags in (False, True):
                tk = kp.cell_table(*args, with_flags=flags, **kw)
                tp = kp.cell_table_plain(*args, with_flags=flags, **kw)
                for x, y in zip(tk, tp):
                    assert torch.equal(x, y), (nb, flags)


KP_HARD = [(case, 10_239, 128) for case in ("one_cell", "cap_plus_one", "none_alive",
                                             "ragged_pile")] + [("lattice", 65_536, 160)]


@pytest.mark.parametrize("case,n,grid", KP_HARD)
def test_cell_table_kernel_hard_cases(case, n, grid):
    """KP against its twin, exact in both modes, on the stable sort's hard
    inputs (kernels/hard_cases.py) at the bench's 16,384 buckets with a
    ragged body count, and on the capacity tier's 65,536 bodies over grid
    160."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import cell_table as kp
    from substrata_tpu_torch.kernels import hard_cases
    f = hard_cases.cell_bodies(case, n, grid, 6, seed=1)
    args = tuple(torch.as_tensor(f[k], device="cuda") for k in
                 ("pos", "alive", "collidable", "awake", "motion_type", "bound_radius"))
    kw = dict(num_buckets=grid * grid, cap=6, rcp_cell=fp.recip(1.4), cell_size=1.4)
    for flags in (False, True):
        tk = kp.cell_table(*args, with_flags=flags, **kw)
        tp = kp.cell_table_plain(*args, with_flags=flags, **kw)
        for x, y in zip(tk, tp):
            assert x.dtype == y.dtype and torch.equal(x, y), (case, flags)


KT_HARD = [("over_cap_clamped", 16_384, 16_384), ("all_invalid", 16_384, 16_384),
           ("over_cap_clamped", 49_152, 49_152), ("over_cap_clamped", 12_345, 16_384)]


@pytest.mark.parametrize("case,p,max_pairs", KT_HARD)
def test_group_kernel_hard_cases(case, p, max_pairs):
    """KT's grouping against its twin, exact, on the hard pair lists
    (kernels/hard_cases.py): a mixed code over its bucket and a clamped
    slice spanning a neighbour's run; every pair invalid; at the serving
    world's 16,384 pairs, the capacity tier's 49,152 and 12,345 (not a
    multiple of the 512-pair tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import hard_cases
    from substrata_tpu_torch.kernels import layout as kt
    st = np.random.default_rng(0).integers(0, 3, 10_240).astype(np.int32)
    pa, pb, pv = hard_cases.group_pairs(case, st, p, max_pairs, seed=4)
    args = (torch.as_tensor(st, device="cuda"), torch.as_tensor(pa, device="cuda"),
            torch.as_tensor(pb, device="cuda"), torch.as_tensor(pv, device="cuda"),
            [0, 1, 2, 4, 5, 6, 8, 9, 10], max_pairs)
    gk, ovk, slot = kt.group(*args)
    gp, ovp, _ = kt.group_plain(*args)
    for (ck, *tk), (cp, *tp) in zip(gk, gp):
        assert ck == cp and all(torch.equal(x, y) for x, y in zip(tk, tp)), cp
    assert int(ovk) == int(ovp)
    src = torch.cat([g[1] for g in gp])
    want = torch.full((p,), -1, dtype=torch.int32, device="cuda")
    want[src[src >= 0]] = torch.nonzero(src >= 0).flatten().int()
    assert torch.equal(slot, want)


def test_solve_setup_kernel_matches_plain(world):
    """KQ: every setup output within 1e-6 of its scale (masks, slots and
    table entries exact), then the refreshed cache exactly."""
    from substrata_tpu_torch.kernels import solve_setup as kq
    s, pc, cfg, p = world.state, world.pair_cache, world.config, world.params
    wm = narrowphase.blocked_manifold_width(cfg, s.capacity)
    pair_cts, _, _ = narrowphase.pair_contacts(s, pc.pair_a, pc.pair_b, pc.pair_valid,
                                               cfg, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(s, world.static_world, cfg)
    cache = world.solver_cache.data
    args = (s, static_cts, pair_cts, pc.inc_table, pc.inc_sign)
    rk, ysk, ypk, (hk, vk) = kq.solve_setup(*args, p, DT, cache, wm)
    rp, ysp, ypp, (hp, vp) = kq.solve_setup_plain(
        *args, p.baumgarte, p.restitution_threshold, torch.full((), DT, device="cuda"), cache,
        wm)
    for f in ("s_dir", "s_ang", "s_r", "s_k", "s_target", "p_dir", "p_ang_a", "p_ang_b",
              "p_ra", "p_rb", "p_k", "p_target", "w", "im"):
        a, b = getattr(rk, f), getattr(rp, f)
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max())), f
    for f in ("s_valid", "p_valid", "p_ab", "tbl"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), f
    assert torch.equal(hk, hp) and torch.equal(vk, vp)
    for a, b in ((ysk, ysp), (ypk, ypp)):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max()))
    lam_s = torch.rand_like(ysp)
    lam_p = torch.rand_like(ypp)
    rargs = (cache, hp, vp, static_cts, pair_cts, lam_s, rp.s_valid, lam_p, rp.p_valid)
    ck, cp = kq.cache_refresh(*rargs), kq.cache_refresh_plain(*rargs)
    assert torch.equal(ck.view(torch.int32), cp.view(torch.int32))


def test_winter_kernel_matches_plain():
    """KR: bench.py's two scripts and a vector / struct / user-function
    script over 4,096 instances in one launch; rotations of the bench
    scripts exact, everything within 1e-6 of its scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import winter as kr
    from substrata_tpu_torch.scripting import WinterScriptEvaluator
    srcs = list(benchworld.WINTER_SOURCES) + [
        "struct P { real a, real f }\n"
        "def g(float x, P p) float : sin(x * p.f) * p.a\n"
        "def evalRotation(float time, WinterEnv env) vec3 :\n"
        "    let p = P(2.0, 3.0) v = vec3(time, 1.0, toFloat(env.instance_index)) in\n"
        "        normalise(v) * g(time, p) + cross(v, vec3(0.3, time, 0.7)) / 3.0\n"
        "def evalTranslation(float time, WinterEnv env) vec3 :\n"
        "    vec3(time % 3.0, if(time > 0.0, time * 0.3 + 1.0, 0.0 - 1.0), fbm(time * 0.1, 3))"]
    codes = [WinterScriptEvaluator(src, device="cuda").code() for src in srcs]
    n = 4096
    batch = kr.Batch([c for c, _ in codes], [r for _, r in codes],
                     [(k * n, n) for k in range(len(srcs))], "cuda")
    rng = np.random.default_rng(8)
    t = torch.as_tensor(rng.uniform(-100, 100, batch.size).astype(np.float32), device="cuda")
    i = torch.as_tensor(rng.integers(0, 512, batch.size).astype(np.int32), device="cuda")
    m = torch.full((batch.size,), 512, dtype=torch.int32, device="cuda")
    got, want = kr.winter_eval(batch, t, i, m), kr.winter_eval_plain(batch, t, i, m)
    assert torch.equal(got[:n, :3], want[:n, :3])
    assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# KS-KV: the pair finder, the compacted layout's chain, the position solve
# and sleeping.
# ---------------------------------------------------------------------------

def _forced(w):
    from substrata_tpu_torch.physics import integrate
    lin, ang, _ = integrate.apply_forces(w.state, DT, w.params)
    return w.state.replace(linvel=lin, angvel=ang)


def _same(a, b):
    """Equal dtypes and values, a NaN equal to a NaN (a NaN speed's margin)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def _ks_check(body, cfg, has_oversize):
    """KS against its twin, at a rebuild (margins from the speeds) and with
    one margin: every output exact.  Returns the twin's rebuild outputs."""
    from substrata_tpu_torch.kernels import pairs as ks
    got = ks.pairs_rebuild(body, DT, cfg, has_oversize)
    want = ks.pairs_rebuild_plain(body, DT, cfg, has_oversize)
    for a, b in zip(got, want):
        assert _same(a, b)
    for a, b in zip(ks.find_pairs(body, cfg, 0.08, has_oversize),
                    ks.find_pairs_plain(body, cfg, 0.08, has_oversize)):
        assert _same(a, b)
    return want


def test_pair_finder_kernel_matches_plain(world):
    want = _ks_check(_forced(world), world.config, False)
    assert int(want[2].sum()) > 200


def _edge_world(max_pairs, big=()):
    """300 boxes on a 1.1 m lattice, some turned into 1 m spheres (wider
    than a 1.4 m cell: the oversize pass), on the card."""
    cfg = SimConfig(capacity=512, max_pairs=max_pairs, grid_dim=32, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    w = PhysicsWorld(cfg, device="cuda")
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(3)
    for i in range(300):
        ix, iy, iz = i % 10, (i // 10) % 10, i // 100
        pos = np.array([ix * 1.1 + rng.uniform(-0.1, 0.1),
                        iy * 1.1 + rng.uniform(-0.1, 0.1), 0.45 + iz * 0.85], np.float32)
        shape = shapes.make_sphere(1.0) if i in big else shapes.make_box([0.4, 0.4, 0.4])
        w.add_object(PhysicsObject(shape=shape, pos=pos, motion_type=int(MotionType.DYNAMIC)))
    w.think(DT)
    return w


@pytest.mark.parametrize("case", ["oversize", "truncated", "max_pairs_65536"])
def test_pair_finder_edge_cases(case):
    """KS's oversize pass (4 oversize bodies), its truncation to max_pairs
    and counters (256 slots for ~1,000 pairs), and max_pairs 65,536."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    big = (5, 77, 150, 233) if case == "oversize" else ()
    mp = {"oversize": 2048, "truncated": 256, "max_pairs_65536": 65_536}[case]
    w = _edge_world(mp, big)
    body = _forced(w)
    want = _ks_check(body, w.config, bool(big))
    pa, pb, pv, num, ov = want[:5]
    if case == "oversize":
        assert any(int(x) in big or int(y) in big for x, y in zip(pa[pv], pb[pv]))
    if case == "truncated":
        assert int(num) > mp and int(ov) > 0 and bool(pv.all())
    if case == "max_pairs_65536":
        assert 500 < int(pv.sum()) <= int(num) < mp


PAIR_PPB = (None, 1, 16)


@pytest.mark.parametrize("ppb", PAIR_PPB)
@pytest.mark.parametrize("case", hard_cases.PAIR_CASES)
def test_pair_finder_hard_cases(case, ppb):
    """KS against its twin, every output exact at a rebuild and with one
    margin, on kernels/hard_cases.py's pair scenes (equal scores, a
    neighbour listed twice, rows and max_pairs overflowing, 1 and 65
    oversize bodies, static and asleep bodies, none alive, a NaN velocity,
    a world at rest), each at its own pairs_per_body and at 1 and 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.pair_scene(case)
    if ppb is not None:
        scene = dataclasses.replace(scene, cfg=dict(scene.cfg, pairs_per_body=ppb))
    body, cfg, has_os = hard_cases.pair_inputs(scene, "cuda")
    want = _ks_check(body, cfg, has_os)
    if case == "nan_velocity":
        assert int(want[5]) == -1                 # the NaN window converts to 0
    if case == "oversize_65":
        assert int(want[4]) >= 1


PAIR_CELL_CASES = [(case, 10_239, 128, True, None) for case in hard_cases.CELL_CASES] + [
    ("lattice", 65_536, 160, True, None), ("lattice", 65_536, 160, False, 0.6928)]


@pytest.mark.parametrize("case,n,grid,has_os,max_bound", PAIR_CELL_CASES)
def test_pair_finder_cell_cases(case, n, grid, has_os, max_bound):
    """KS against its twin, every output exact, on the cell table's hard
    inputs made into bodies (kernels/hard_cases.py:pair_world): every body
    in one cell, every bucket at cap + 1, none alive, a heap past the
    bucket lists, at 10,239 bodies over 16,384 buckets, and the capacity
    tier's 65,536 bodies over grid 160 (radii up to 1.4 m, half of them
    oversize; and scaled to the bench's boxes without the oversize pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch import convert
    fields = hard_cases.pair_world(hard_cases.cell_bodies(case, n, grid, 6, seed=1), seed=2,
                                   max_bound=max_bound)
    cfg = SimConfig(capacity=n, max_pairs=49_152 if n > 16_384 else 16_384, grid_dim=grid,
                    cell_size=1.4, cell_capacity=6, pairs_per_body=10, pair_rebuild_interval=6)
    _ks_check(convert.body_state_from_numpy(fields, device="cuda"), cfg, has_os)


def test_pair_finder_plan_follows_new_world():
    """KS's plan is per shape, not per world: a second world of the same
    shape gives its own answer, each call's outputs are buffers of their
    own, and a bad argument still raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import pairs as ks
    b1, cfg, _ = hard_cases.pair_inputs(hard_cases.pair_scene("ppb_16"), "cuda")
    b2, _, _ = hard_cases.pair_inputs(hard_cases.pair_scene("ppb_16", seed=5), "cuda")
    out1 = ks.pairs_rebuild(b1, DT, cfg, False)
    keep = [t.clone() for t in out1]
    out2 = ks.pairs_rebuild(b2, DT, cfg, False)
    for got, want in zip(out2, ks.pairs_rebuild_plain(b2, DT, cfg, False)):
        assert torch.equal(got, want)
    for got, want in zip(out1, keep):
        assert torch.equal(got, want)              # not written by the later call
    assert not torch.equal(out1[0], out2[0])
    n = b1.capacity
    for bad, exc in ((b1.replace(pos=b1.pos.double()), TypeError),
                     (b1.replace(linvel=b1.linvel[:-1]), ValueError),
                     (b1.replace(awake=b1.awake.cpu()), ValueError),
                     (b1.replace(shape_params=torch.empty((n, 8), device="cuda")[:, :4]),
                      ValueError)):
        with pytest.raises(exc):
            ks.pairs_rebuild(bad, DT, cfg, False)
    with pytest.raises(ValueError):
        ks.find_pairs(b1, SimConfig(**dict(hard_cases.pair_scene("ppb_16").cfg,
                                           pairs_per_body=17)))


def test_pair_finder_full_tick_and_mesh_rebuilds(fulltick):
    """KS at a rebuild of the full tick's world (vehicles, the character,
    its own oversize flag) and of a 1,200-object mesh world after 40
    frames: every output exact."""
    w = fulltick[0]
    _ks_check(_forced(w), w.config, bool(w._oversize_slots))
    mw, mp, msrc = _mesh("cuda")
    for t in range(40):
        benchworld.mesh_tick(mw, mp, t * DT, msrc)
    _ks_check(_forced(mw), mw.config, bool(mw._oversize_slots))


@pytest.mark.parametrize("case", hard_cases.DOWNMIX_CASES)
def test_downmix_hard_cases(case):
    """KG against its twin on kernels/hard_cases.py's downmix scenes: the
    write index exact, out and the lines within 1e-5; equal to the bit
    where both do the same operations: out without a room, the ring
    positions no frame writes, and, with the wet mix and the feedback at 0
    (so the room's fmas add an exact 0), out and every line, which holds
    each frame's three source-order sums to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = hard_cases.downmix_scene(case)
    gargs = hard_cases.downmix_inputs(scene, "cuda")
    gk = kaudio.audio_downmix_reverb(*gargs)
    gp = kaudio.audio_downmix_reverb_plain(*gargs)
    assert float((gk[0] - gp[0]).abs().max()) <= 1e-5
    if scene.room is None:
        assert gk[1] is None and torch.equal(gk[0], gp[0])
        return
    assert float((gk[1] - gp[1]).abs().max()) <= 1e-5 and torch.equal(gk[2], gp[2])
    d = gk[1].shape[1]
    b = gargs[0].shape[1]
    written = torch.remainder(gargs[5] + torch.arange(b, device="cuda"), d)
    kept = torch.ones(d, dtype=torch.bool, device="cuda")
    kept[written.long()] = False
    assert torch.equal(gk[1][:, kept], gargs[4][:, kept])
    zero = torch.zeros((), device="cuda")
    z = gargs[:7] + (zero, zero)
    zk, zp = kaudio.audio_downmix_reverb(*z), kaudio.audio_downmix_reverb_plain(*z)
    assert torch.equal(zk[0], zp[0]) and torch.equal(zk[1], zp[1]) and torch.equal(zk[2], zp[2])


def test_downmix_plan_follows_its_inputs(audio):
    """KG's plan is per (S, B, D): two blocks of one shape give their own
    answers, outputs are buffers of their own, and a bad argument raises."""
    src, pool, lis, room, st = audio
    s, b = src.capacity, TICK_FRAMES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    blocks = [torch.rand((3, s, b), generator=gen, device="cuda") - 0.5 for _ in range(2)]
    outs = []
    for x in blocks:
        args = (x[0], x[1], x[2], lis.master_volume, room.delay_lines, room.write_idx,
                room.delays, room.feedback, room.wet)
        outs.append((kaudio.audio_downmix_reverb(*args), args))
    for got, args in outs:
        want = kaudio.audio_downmix_reverb_plain(*args)
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert float((got[1] - want[1]).abs().max()) <= 1e-5 and torch.equal(got[2], want[2])
    x = blocks[0]
    for bad, exc in (((x[0].double(), x[1], x[2]), TypeError),
                     ((x[0], x[1][:, :-1], x[2]), ValueError),
                     ((x[0], x[1], x[2].cpu()), ValueError),
                     ((x[0], x[1], x[2].t().contiguous().t()), ValueError)):
        with pytest.raises(exc):
            kaudio.audio_downmix_reverb(*bad, lis.master_volume, room.delay_lines,
                                        room.write_idx, room.delays, room.feedback, room.wet)
    with pytest.raises(ValueError):
        kaudio.audio_downmix_reverb(x[0], x[1], x[2], lis.master_volume,
                                    room.delay_lines[:, :b - 1], room.write_idx, room.delays,
                                    room.feedback, room.wet)


def _kt_check(w):
    """KT's four entry points against their twins on a mixed world's pair
    list, all exact."""
    from substrata_tpu_torch.kernels import layout as kt
    body, cfg, pc = _forced(w), w.config, w.pair_cache
    active = narrowphase._active_codes(cfg)
    assert len(active) > 1
    n, p = body.capacity, pc.pair_a.shape[0]
    gargs = (body.shape_type, pc.pair_a, pc.pair_b, pc.pair_valid, active, cfg.max_pairs)
    gk, ovk, slot = kt.group(*gargs)
    gp, ovp, _ = kt.group_plain(*gargs)
    for (ck, *tk), (cp, *tp) in zip(gk, gp):
        assert ck == cp and all(torch.equal(x, y) for x, y in zip(tk, tp)), cp
    assert int(ovk) == int(ovp)
    srcs, touches, rows = [], [], []
    for code, src, ba, bb, bv in gp:
        r = narrowphase._bucket_rows(code, narrowphase._MANIFOLD_WIDTH[code], False, body, ba,
                                     bb, bv, w.static_world.hulls)
        srcs.append(src)
        touches.append(r[9])
        rows.append(r[:9])
    assert torch.equal(kt.touching(srcs, touches, p, slot), kt.touching_plain(srcs, touches, p))
    contacts = tuple(torch.cat([r[i] for r in rows]) for i in range(9))
    n_valid = int(contacts[5].sum())
    for m in (cfg.max_active_contacts, max(n_valid // 3, 1)):     # room, then overflow
        (ck, ok), (cp, op) = kt.compact(contacts, m), kt.compact_plain(contacts, m)
        assert all(torch.equal(x, y) for x, y in zip(ck, cp)) and int(ok) == int(op)
    cp, _ = kt.compact_plain(contacts, cfg.max_active_contacts)
    occ = cp[5] & (cp[0] >= 0)
    for cpb in (cfg.contacts_per_body, 2):
        ik = kt.incidence(cp[0], cp[1], occ, n, cpb)
        ip = kt.incidence_plain(cp[0], cp[1], occ, n, cpb)
        assert all(torch.equal(x, y) for x, y in zip(ik, ip)), cpb
    return n_valid


def test_layout_kernels_match_plain_serving():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p = _serving("cuda")
    for t in range(30):
        benchworld.serving_tick(w, p, t * DT)
    assert _kt_check(w) > 50


def test_layout_kernels_match_plain_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p, src = _mesh("cuda")
    for t in range(30):
        benchworld.mesh_tick(w, p, t * DT, src)
    _kt_check(w)


def test_incidence_kernel_crowded_bodies():
    """KT's incidence with bodies in more than cpb entries (the kept set is
    the cpb lowest) and one in more than its 64 list slots (the ordered
    scan), at a pair-blocked stride of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import layout as kt
    rng = np.random.default_rng(9)
    n, c, wm = 300, 4096, 4
    a = rng.integers(0, n, c).astype(np.int32)
    b = rng.integers(-1, n, c).astype(np.int32)
    a[rng.choice(c, 100, replace=False)] = 7          # 100 entries: past the list
    b[rng.choice(c, 20, replace=False)] = 9
    rows_a = np.repeat(a, wm)
    rows_b = np.repeat(b, wm)
    ta = torch.as_tensor(rows_a, device="cuda").reshape(c, wm)[:, 0]
    tb = torch.as_tensor(rows_b, device="cuda").reshape(c, wm)[:, 0]
    occ = torch.as_tensor(rng.random(c) < 0.9, device="cuda") & (ta >= 0)
    for cpb in (8, 16):
        ik = kt.incidence(ta, tb, occ, n, cpb)
        ip = kt.incidence_plain(ta.contiguous(), tb.contiguous(), occ, n, cpb)
        assert all(torch.equal(x, y) for x, y in zip(ik, ip)), cpb
        assert float(ip[2][7]) == cpb and float(ip[2][9]) == cpb


def _step_inputs(w):
    """The velocity solve's outputs at the world's state, every dynamic
    body awake: (body, static rows, pair rows, table, sign, wm, linvel,
    angvel, lambda_p, integrated positions)."""
    from substrata_tpu_torch.physics import integrate
    body, cfg, pc = _forced(w), w.config, w.pair_cache
    body = body.replace(awake=body.awake | (body.alive & body.dynamic))
    n = body.capacity
    wm = narrowphase.blocked_manifold_width(cfg, n)
    pair_cts, _, _ = narrowphase.pair_contacts(body, pc.pair_a, pc.pair_b, pc.pair_valid, cfg,
                                               hulls=w.static_world.hulls, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(body, w.static_world, cfg)
    if wm:
        table, sign = pc.inc_table, pc.inc_sign
    else:
        wm = 1
        pair_cts, _ = narrowphase.compact_contacts(pair_cts, cfg.max_active_contacts)
        table, sign, _ = solver.build_incidence(pair_cts.a, pair_cts.b,
                                                pair_cts.valid & (pair_cts.a >= 0), n,
                                                cfg.contacts_per_body)
    lin, ang, lam_p, *_ = solver.solve_contacts(body, static_cts, pair_cts, DT, w.params, cfg,
                                                w.solver_cache, wm=wm, table=table, sign=sign)
    pos, _ = integrate.integrate_positions(body, lin, ang, DT)
    return body, static_cts, pair_cts, table, sign, wm, lin, ang, lam_p, pos


def _kuv_check(w):
    """KU to the bit against its twin; KV's strike wake and sleep pass
    exact, as the world is and with half its bodies asleep and every timer
    near its limit.  Returns how many flags the sleep passes changed."""
    from substrata_tpu_torch.kernels import positions as ku
    from substrata_tpu_torch.kernels import sleep as kv
    body, static_cts, pair_cts, table, sign, wm, lin, ang, lam_p, pos = _step_inputs(w)
    st, pc, prm = w.state, w.pair_cache, w.params
    uargs = (pos, body.inv_mass, body.awake,
             (static_cts.valid, static_cts.normal, static_cts.penetration),
             (pair_cts.a, pair_cts.b, pair_cts.valid, pair_cts.normal, pair_cts.penetration),
             table, sign, prm.contact_slop)
    pk = ku.solve_positions(*uargs, iters=2, beta=0.25, wm=wm)
    pp = ku.solve_positions_plain(*uargs, 2, 0.25, wm)
    moved = float((pp - pos).abs().max())
    assert moved > 1e-5                                     # the solve moved something
    assert _same_bits(pk, pp), float((pk - pp).abs().max())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    drowsy = st.awake & (torch.rand(st.awake.shape, generator=gen, device="cuda") < 0.5)
    changed = 0
    for awake, timer in ((st.awake, body.sleep_timer),
                         (drowsy, torch.full_like(body.sleep_timer, 0.49))):
        sargs = (awake, body.linvel, st.alive, st.motion_type, pc.pair_a, pc.pair_b,
                 pc.pair_valid)
        sk, sp = kv.strike_wake(*sargs), kv.strike_wake_plain(*sargs)
        assert torch.equal(sk, sp)
        vargs = (body.replace(awake=sp, sleep_timer=timer), awake, lin, ang,
                 (static_cts.valid, static_cts.penetration),
                 (pair_cts.a, pair_cts.b, pair_cts.valid, pair_cts.penetration), lam_p, table,
                 sign, wm, DT, prm, pc.steps_left)
        vk, vp = kv.sleep_pass(*vargs), kv.sleep_pass_plain(*vargs)
        for f in ("awake", "sleep_timer", "linvel", "angvel", "newly_awake", "newly_asleep",
                  "steps_left"):
            a, b = getattr(vk, f), getattr(vp, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        changed += int(vp.newly_awake.sum()) + int(vp.newly_asleep.sum())
    return changed


def test_position_and_sleep_kernels_match_plain_bench(world):
    assert _kuv_check(world) > 0


def test_position_and_sleep_kernels_match_plain_serving():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p = _serving("cuda")
    for t in range(30):
        benchworld.serving_tick(w, p, t * DT)
    assert _kuv_check(w) > 0


def test_position_and_sleep_kernels_match_plain_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, p, src = _mesh("cuda")
    for t in range(30):
        benchworld.mesh_tick(w, p, t * DT, src)
    _kuv_check(w)


# --- KW-KZ: the terrain, the spawn scatter and the pose. ------------------

@pytest.fixture(scope="module")
def terrain_field():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch import convert
    h, cw, origin = benchworld.terrain_heightmap(257)
    return convert.terrain_field_from_numpy(h, origin, cw, device="cuda")


def test_terrain_height_and_chunk_kernels_match_plain(terrain_field):
    from substrata_tpu_torch.kernels import terrain as kt
    hf = terrain_field
    f = (hf.heights, hf.origin, hf.cell_w)
    xy = torch.as_tensor(np.random.default_rng(0).uniform(-530, 530, (4096, 2))
                         .astype(np.float32), device="cuda")
    scale = float(hf.heights.abs().max())
    for normals in (False, True):
        got, want = kt.terrain_heights(*f, xy, normals), kt.terrain_heights_plain(*f, xy, normals)
        assert float((got[:, 0] - want[:, 0]).abs().max()) <= 1e-6 * scale
        if normals:
            assert float((got[:, 1:] - want[:, 1:]).abs().max()) <= 1e-6
    lo = torch.tensor([[-512.0, -512.0], [0.0, 16.0], [-64.0, 32.0]], device="cuda")
    lw = torch.tensor([512.0, 16.0, 32.0], device="cuda")
    got, want = kt.terrain_chunks(*f, lo, lw, 16), kt.terrain_chunks_plain(*f, lo, lw, 16)
    n8 = 17 * 17 * 8
    assert torch.equal(got[:, n8:].contiguous().view(torch.int32),
                       want[:, n8:].contiguous().view(torch.int32))
    assert float((got[:, :n8] - want[:, :n8]).abs().max()) <= 1e-6 * 512.0


def test_terrain_scatter_kernel_matches_plain(terrain_field):
    from substrata_tpu_torch.kernels import terrain as kt
    hf = terrain_field
    cells = torch.as_tensor(np.array([[kx * 32.0, ky * 32.0] for kx in range(-4, 5)
                                      for ky in range(-4, 5)], np.float32), device="cuda")
    got = kt.terrain_scatter(hf.heights, hf.origin, hf.cell_w, cells, 32.0, 1234, 64)
    want = kt.terrain_scatter_plain(hf.heights, hf.origin, hf.cell_w, cells, 32.0, 1234, 64)
    assert torch.equal(got, want)


def test_spawn_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import spawn as ky
    from substrata_tpu_torch.physics.particles import zero_particles
    rng = np.random.default_rng(1)
    pending = [dict(pos=rng.uniform(-5, 5, 3), vel=rng.uniform(-5, 5, 3), area=1e-4, mass=1e-6,
                    restitution=0.5, width=0.1, dwidth_dt=0.0, opacity=1.0,
                    dopacity_dt=float(-rng.uniform(0.5, 5)), theta=0.0,
                    sprite_type=int(rng.integers(0, 2)), die_on_hit=bool(rng.random() < 0.5))
               for _ in range(5000)]
    rows = torch.as_tensor(ky.pack_rows(pending), device="cuda")
    for cursor in (0, 3000):
        a = ky.spawn_rows(zero_particles(4096, device="cuda"), rows, cursor)
        b = ky.spawn_rows_plain(zero_particles(4096, device="cuda"), rows, cursor)
        for f in ky.STATE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_pose_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.anim import ClipBank, build_default_humanoid
    from substrata_tpu_torch.anim import pose as apose
    from substrata_tpu_torch.anim.clips import build_default_clips
    from substrata_tpu_torch.kernels import pose as kz
    skel = build_default_humanoid()
    bank = ClipBank(skel, build_default_clips(skel), device="cuda")
    rig = apose.build_rig(skel, device="cuda")
    rng = np.random.default_rng(2)
    for a in (4, 37, 64):
        arr = apose.zero_pose_arrays(a)
        arr["clip_a"][:] = rng.integers(0, 14, a)
        arr["clip_b"][:] = rng.integers(0, 14, a)
        arr["frame_a"][:] = rng.uniform(-5, 300, a)
        arr["frame_b"][:] = rng.uniform(-5, 300, a)
        arr["blend"][:] = rng.uniform(0, 1, a)
        q = rng.normal(size=(a, kz.NUM_SLOTS, 4))
        arr["override_rot"][:] = arr["post_rot"][:] = q / np.linalg.norm(q, axis=-1,
                                                                         keepdims=True)
        arr["override_mask"][:] = rng.random((a, kz.NUM_SLOTS)) < 0.4
        arr["post_mask"][:] = rng.random((a, kz.NUM_SLOTS)) < 0.5
        arr["grab_l"][:] = rng.uniform(0, 1, a)
        arr["grab_r"][::2] = 1.0
        arr["root"][:, :3, 3] = rng.uniform(-50, 50, (a, 3))
        p = apose.pose_params_from_arrays(arr, device="cuda")
        assert torch.equal(kz.pose(bank, rig, p), kz.pose_plain(bank, rig, p)), a


def test_small_terrain_frame_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = SimConfig(capacity=2048, max_pairs=4096, grid_dim=32, cell_size=4.0)
    runs = {}
    for dev in ("cuda", "cpu"):
        sc = benchworld.terrain_world(dev, res=129, n_burst=256, n_stream=4, n_avatars=8,
                                      cfg=cfg)
        for f in range(12):
            benchworld.terrain_tick(sc, f)
        ps = sc.particles.state
        runs[dev] = (ps.alive.cpu(), ps.pos.cpu(), sc.player.get_eye_position(),
                     np.stack([g.joints_world for g in sc.graphics.by_uid.values()]),
                     [c[2][0] for c in sc.terrain.visible_chunks()])
    (ga, gp, ge, gj, gc), (ca, cp, ce, cj, cc) = runs["cuda"], runs["cpu"]
    assert torch.equal(ga, ca)
    assert float((gp - cp)[ca].abs().max()) <= 1e-4
    assert np.abs(ge - ce).max() <= 1e-4
    assert np.abs(gj - cj).max() <= 1e-5 * max(float(np.abs(cj).max()), 1.0)
    assert len(gc) == len(cc) and all(np.array_equal(a, b) for a, b in zip(gc, cc))


def _kaa_fields(buf, s, nl):
    from substrata_tpu_torch.kernels import audio_setup as kaa
    return kaa.setup_views(buf, s, nl)


@pytest.mark.parametrize("use_hrtf", [True, False])
def test_audio_setup_kernels_match_plain(audio, use_hrtf):
    """KAA's setup, and the epilogue KF writes, on bench.py's 256 sources
    after 10 blocks."""
    import math
    from substrata_tpu_torch.kernels import audio_setup as kaa
    src, pool, lis, room, _ = audio
    b = TICK_FRAMES
    args = (src.alive, src.paused, src.finished, src.spatial, src.pos, src.vel, src.delta,
            src.doppler_factor, src.mute_factor, src.mute_target, src.mute_rate, src.volume,
            src.num_occlusions, lis.pos, lis.vel, lis.right, lis.forward, lis.up,
            kaa.dop_alpha(b), b / mix.ENGINE_RATE, use_hrtf)
    s, nl = src.delta.shape
    k = kaa.setup_views(kaa.audio_setup(*args), s, nl)
    p = kaa.setup_views(kaa.audio_setup_plain(*args), s, nl)
    for name in ("active", "use_lp", "eff_delta", "dop_smooth", "mute", "gain", "alpha",
                 "send_gain"):
        assert torch.equal(k[name], p[name]), name
    if use_hrtf:
        assert torch.equal(k["gl"], p["gl"]) and torch.equal(k["gr"], p["gr"])
        to = src.pos - lis.pos[None]
        x, y, z = (fp.dot3(to, v[None]) for v in (lis.right, lis.forward, lis.up))
        pa = torch.atan2(x, y) * fp.recip(2 * math.pi) * 16
        pe = (torch.atan2(z, torch.clamp(fp.sqrt(fp.fma(x, x, y * y)), min=1e-6))
              + math.pi / 4) * fp.recip(math.pi / 2) * 2
        edge = ((pa - pa.floor() - 0.5).abs() <= 1e-5) | ((pe - pe.floor() - 0.5).abs() <= 1e-5)
        assert torch.equal(k["dir_idx"][~edge], p["dir_idx"][~edge])
    else:
        for name in ("gl", "gr"):
            assert float((k[name] - p[name]).abs().max()) <= 1e-6 * max(
                1.0, float(p[name].abs().max())), name
    # The epilogue, folded into KF, against the twins chained.
    _kf_vs_chain((mix.fetch_args(pool, src, p["eff_delta"], p["active"], b), src.lp_state,
                  p["alpha"], p["use_lp"], src.spatial, src.hrir_hist,
                  hrir_bank_tensor("cuda") if use_hrtf else None,
                  p["dir_idx"] if use_hrtf else None, src.prev_gain_l, src.prev_gain_r,
                  p["gl"], p["gr"], mix.gain_ramp(b, "cuda"), p["gain"], p["send_gain"],
                  use_hrtf, (src.finished, src.smoothed_level, src.alive,
                             src.remove_on_finish)), f"setup, HRTF {use_hrtf}")


def test_vehicle_setup_kernels_match_plain(fulltick):
    """KAB's setup and scatter on the full tick's 8 vehicles, and with one
    vehicle's body gone (slot -1)."""
    from substrata_tpu_torch.kernels import vehicle_setup as kab
    w, veh, _, _ = fulltick
    st = w.state
    nv = veh.body_slot.shape[0]
    gone = torch.where(torch.arange(nv, device="cuda") == 3, -1, veh.body_slot).to(torch.int32)
    for slots in (veh.body_slot, gone):
        args = (slots, veh.y_fwd_quat, veh.wheel_attach, veh.wheel_radius, veh.sus_max, st.pos,
                st.quat, st.linvel, st.angvel, st.inv_mass, st.inv_inertia)
        assert torch.equal(kab.vehicle_setup(*args).view(torch.int32),
                           kab.vehicle_setup_plain(*args).view(torch.int32))
        gen = torch.Generator(device="cuda").manual_seed(5)
        dv = torch.randn((nv, 3), generator=gen, device="cuda")
        dw = torch.randn((nv, 3), generator=gen, device="cuda")
        rk = [st.linvel.clone(), st.angvel.clone(), st.awake.clone(), st.sleep_timer.clone()]
        rp = [x.clone() for x in rk]
        kab.vehicle_scatter(slots, dv, dw, *rk)
        kab.vehicle_scatter_plain(slots, dv, dw, *rp)
        for x, y in zip(rk, rp):
            assert torch.equal(x, y)


def test_client_app_defaults_to_the_card(world):
    from substrata_tpu_torch.client_app import ClientApp
    app = ClientApp(config=SimConfig(capacity=64, max_pairs=256, grid_dim=16))
    assert app.device.type == "cuda" and app.physics_world.device.type == "cuda"
    assert app.audio.device.type == "cuda" and app.scripts.device.type == "cuda"
    assert app.avatar_graphics.device.type == "cuda"


def test_small_client_world_on_card_matches_cpu():
    """chip_smoke.py's small client world (phase 19) on the card against
    the CPU path over 20 frames: the player and car 0 within 1e-4 m, the
    audio within 5e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for dev in ("cuda", "cpu"):
        sc = benchworld.client_world(dev, cfg=SimConfig(
            capacity=512, max_pairs=2048, grid_dim=32, cell_size=4.0, solver_iters=7,
            pair_rebuild_interval=6), n_objects=600, n_dynamic=32, n_sources=16,
            n_vehicles=4, n_winter=16, n_platforms=1, n_lua=2)
        sc.drive_from = 10
        out = []
        for f in range(20):
            audio = benchworld.client_tick(sc, f)
            out.append((sc.app.player.get_eye_position(),
                        np.array(sc.app.objects[sc.car_uids[0]].pos), audio))
        runs[dev] = out
    for (ea, ca, aa), (eb, cb, ab) in zip(runs["cuda"], runs["cpu"]):
        assert np.abs(ea - eb).max() <= 1e-4 and np.abs(ca - cb).max() <= 1e-4
        assert np.abs(aa - ab).max() <= 5e-5


def test_bc1_kernel_matches_plain():
    """KAC against its twin, exactly: a 512 x 384 photo-like image's mip
    chain in one launch, and blocks of every kind the CPU tests use."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import bc1
    from substrata_tpu_torch.shared import texture_compress as tc
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:384, 0:512].astype(np.float32)
    img = np.stack([x / 2, y / 1.5, (x + y) / 3.5], axis=-1) + rng.uniform(-8, 8, (384, 512, 3))
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    chain = np.concatenate([tc._to_blocks(m) for m, _, _ in tc.mip_chain(img)])
    corpus = np.concatenate([rng.uniform(0, 255, (4096, 16, 3)),
                             np.round(rng.uniform(0, 255, (4096, 16, 3))),
                             np.repeat(np.round(rng.uniform(0, 255, (64, 1, 3))), 16, axis=1)])
    for blocks in (chain, corpus.astype(np.float32)):
        t = torch.as_tensor(blocks, device="cuda")
        before = bc1.launches
        got = bc1.bc1_encode(t)
        assert bc1.launches == before + 1
        assert torch.equal(got, bc1.bc1_encode_plain(t))
    assert tc.generate_compressed_texture(img) == tc.generate_compressed_texture(img,
                                                                                  device="cpu")


def test_pipelined_ring_on_card():
    """The readback ring on the card: the value pushed depth pushes ago."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.runtime.readback import PipelinedReadback
    ring = PipelinedReadback(3)
    got = [ring.push(torch.full((1000,), float(k), device="cuda")) for k in range(8)]
    assert got[:3] == [None] * 3
    for k in range(3, 8):
        assert (got[k] == k - 3).all()
    assert len(ring) == 3 and ring.waits <= 5


def _slab_world(n=2000):
    """A bench-shaped box world of ``n`` boxes on the card, 10 ticks in."""
    cfg = SimConfig(capacity=2048, max_pairs=8192, grid_dim=64, cell_size=1.4,
                    cell_capacity=6, solver_iters=7, pairs_per_body=10,
                    pair_rebuild_interval=6, contacts_per_body=8)
    w = benchworld.bench_world("cuda", n_bodies=n, cfg=cfg)
    for _ in range(10):
        w.think(DT)
    return w


def _bodies_equal(a, b):
    from substrata_tpu_torch.physics.state import BODY_FIELDS
    for f in BODY_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("halo_cap", [192, 8])
def test_halo_kernel_matches_plain(halo_cap):
    """KAD against its twin, every byte: 4 x-slabs of a 2,000-box world
    (and an overflowing halo), then the 2-D tiles' x and y phases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import halo
    from substrata_tpu_torch.parallel import spatial
    w = _slab_world()
    part, _ = spatial.partition_by_slab(w.state, 4, 768, -26.0, 26.0)
    lo, hi = halo.thresholds(-26.0, 26.0, 4, 3.0)
    before = halo.launches
    got, ov = halo.exchange(part, 4, halo_cap, 0, 1, 4, lo, hi)
    assert halo.launches == before + 1
    want, ov_p = halo.exchange_plain(part, 4, halo_cap, 0, 1, 4, lo, hi)
    _bodies_equal(got, want)
    assert torch.equal(ov, ov_p) and (int(ov.sum()) > 0) == (halo_cap == 8)
    tiles, _ = spatial.partition_by_tile(w.state, 2, 2, 1024, -26.0, 26.0, -26.0, 26.0)
    lo, hi = halo.thresholds(-26.0, 26.0, 2, 3.0)
    got_x, _ = halo.exchange(tiles, 4, halo_cap, 0, 2, 2, lo, hi)
    _bodies_equal(got_x, halo.exchange_plain(tiles, 4, halo_cap, 0, 2, 2, lo, hi)[0])
    got_y, ov_y = halo.exchange(got_x, 4, halo_cap, 1, 1, 2, lo, hi)
    want_y, ov_yp = halo.exchange_plain(got_x, 4, halo_cap, 1, 1, 2, lo, hi)
    _bodies_equal(got_y, want_y)
    assert torch.equal(ov_y, ov_yp)


def test_shard_reduce_kernels_match_plain():
    """KAE's three entry points against their twins, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import shard_reduce as kae
    from substrata_tpu_torch.physics.state import BODY_FIELDS, BodyState
    w = _slab_world()
    st = w.state
    shards = [BodyState(**{f: getattr(st, f)[k * 512:(k + 1) * 512] for f in BODY_FIELDS})
              for k in range(4)]
    ov = torch.tensor([[0, 3], [1, 0], [0, 0], [7, 2]], dtype=torch.int32, device="cuda")
    got, counts = kae.keep_count(shards, 300, ov)
    want, counts_p = kae.keep_count_plain(shards, 300, ov)
    _bodies_equal(got, want)
    assert torch.equal(counts, counts_p) and int(counts[1]) == 13
    nums = [torch.tensor(k * 7 + 1, dtype=torch.int32, device="cuda") for k in range(5)]
    assert int(kae.world_count(nums)) == int(kae.world_count_plain(nums)) == 75
    g = torch.Generator(device="cuda").manual_seed(0)
    blocks = [torch.rand((256, 2), generator=g, device="cuda") * 1.2 - 0.6 for _ in range(4)]
    assert torch.equal(kae.sum_clip(blocks), kae.sum_clip_plain(blocks))


def test_sharded_paths_on_card_match_cpu():
    """The dry run on the card, and a 4-slab step, 4 worlds and the sharded
    mix on the card against the CPU path: worlds within 1e-4 m, the mix
    within 5e-5 (tests/test_torch_audio.py's bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.parallel import dryrun, mesh, spatial
    assert dryrun.dryrun_multichip(4).startswith("dryrun_multichip OK")
    out = {}
    for dev in ("cuda", "cpu"):
        w = dryrun.dryrun_world(dev)
        m = mesh.make_mesh(4, device=dev)
        states = mesh.replicate_states(w.state, 4)
        states = states.replace(linvel=states.linvel + torch.linspace(
            -1, 1, 4, device=dev)[:, None, None] * w.state.alive[None, :, None])
        for _ in range(5):
            states, awake = mesh.multi_world_step(states, w.static_world, None, DT, w.params,
                                                  w.config, m)
        part, _ = spatial.partition_by_slab(w.state, 4, 8, -6.0, 6.0)
        for _ in range(5):
            part, aw, ov = spatial.spatial_world_step(part, w.static_world, None, DT, w.params,
                                                      w.config, m, 4, 2.0, -6.0, 6.0)
        src, _ = dryrun.dryrun_sources(128, dev)
        pool = dryrun.dryrun_sources(128, "cpu")[1].to(dev)     # one rounding of sin
        _, block = mesh.sharded_mix_block(src, pool, mix.default_listener(device=dev), m)
        out[dev] = (states.pos.cpu(), int(awake), part.pos.cpu(), int(aw), int(ov), block.cpu())
    a, b = out["cuda"], out["cpu"]
    assert (a[1], a[3], a[4]) == (b[1], b[3], b[4])
    assert (a[0] - b[0]).abs().max() <= 1e-4 and (a[2] - b[2]).abs().max() <= 1e-4
    assert (a[5] - b[5]).abs().max() <= 5e-5


@pytest.mark.parametrize("case", hard_cases.BOX_BOX_CASES)
def test_box_box_hard_cases(case):
    """KA (four lanes a pair slot) against its twin on kernels/hard_cases.py's
    box-box scenes, every output to the bit, and the same bits written into
    a caller's contact-row views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = hard_cases.box_box_inputs(hard_cases.box_box_scene(case), "cuda")
    rk, rp = ka.box_box_rows(*args), ka.box_box_rows_plain(*args)
    for i, (k, p) in enumerate(zip(rk, rp)):
        assert _same_bits(k, p), (case, i)
    p = args[6].shape[0]
    fields, touch = ka.contact_rows.contact_buffer(4 * p, p, "cuda")
    views = ka.box_box_rows(*args, out=tuple(fields) + (touch,))
    for i, (k, v) in enumerate(zip(rk, views)):
        assert _same_bits(k, v), (case, i)


@pytest.mark.parametrize("case", hard_cases.POSITION_CASES)
def test_position_hard_cases(case):
    """KU (one launch an iteration, a group of lanes a body) against its
    twin on kernels/hard_cases.py's position scenes, to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import positions as ku
    args, kw = hard_cases.position_inputs(hard_cases.position_scene(case), "cuda")
    pk = ku.solve_positions(*args, **kw)
    pp = ku.solve_positions_plain(*args, kw["iters"], kw["beta"], kw["wm"])
    assert _same_bits(pk, pp), (case, float((pk - pp).abs().max()))


def _state_bytes_equal(a, b):
    from substrata_tpu_torch.physics.state import BODY_FIELDS
    for f in BODY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)), f


@pytest.mark.parametrize("case", hard_cases.HALO_CASES)
def test_halo_hard_cases(case):
    """KAD (ballot ranks, field-major ghost copies over several blocks a
    direction) against its twin on kernels/hard_cases.py's halo scenes:
    every byte of each phase's combined state (NaN payloads included) and
    the overflow counts, one launch a phase; the tiles' y phase on the
    kernel's x phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import halo
    state, s, h, phases = hard_cases.halo_inputs(hard_cases.halo_scene(case), "cuda")
    for axis, stride, n_axis, lo, hi in phases:
        before = halo.launches
        got, ov = halo.exchange(state, s, h, axis, stride, n_axis, lo, hi)
        assert halo.launches == before + 1
        want, ov_p = halo.exchange_plain(state, s, h, axis, stride, n_axis, lo, hi)
        _state_bytes_equal(got, want)
        assert torch.equal(ov, ov_p), (case, ov.tolist(), ov_p.tolist())
        state = got


@pytest.mark.parametrize("case", hard_cases.SLEEP_CASES)
def test_sleep_hard_cases(case):
    """KV's sleep pass (a lane per incidence slot, one launch, the ticket's
    scratch reset by the last block) against its twin on kernels/
    hard_cases.py's sleep scenes, every output to the bit, three calls in a
    row on one plan with a fast wake's scene between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import sleep as kv
    args = hard_cases.sleep_inputs(hard_cases.sleep_scene(case), "cuda")
    fast = hard_cases.sleep_inputs(hard_cases.sleep_scene("fast_wake"), "cuda")
    want = kv.sleep_pass_plain(*args)
    for _ in range(3):
        before = kv.launches["sleep_pass"]
        got = kv.sleep_pass(*args)
        assert kv.launches["sleep_pass"] == before + 1
        for f in dataclasses.fields(want):
            assert _same_bits(getattr(got, f.name), getattr(want, f.name)), (case, f.name)
        assert int(kv.sleep_pass(*fast).steps_left) == 0


def _same_or_nan(a, b):
    """Bit for bit where b is a number, NaN where b is NaN (a NaN's
    payload is the arithmetic's: the card's fma gives the canonical one)."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and _same_bits(a[~nan], b[~nan])


@pytest.mark.parametrize("case", hard_cases.COMPACT_CASES)
def test_compact_hard_cases(case):
    """KT's compaction (one cooperative launch, no memset) against its twin
    on kernels/hard_cases.py's compaction scenes: every field to the bit
    and the overflow, three calls in a row on one plan, each output a
    fresh buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from substrata_tpu_torch.kernels import layout
    rows, m = hard_cases.compact_inputs(hard_cases.compact_scene(case), "cuda")
    want, ov_p = layout.compact_plain(rows, m)
    held = None
    for _ in range(3):
        before = layout.launches["layout_compact"]
        got, ov = layout.compact(rows, m)
        assert layout.launches["layout_compact"] == before + 1
        for name, x, y in zip(hard_cases.COMPACT_FIELDS, got, want):
            assert _same_bits(x, y), (case, name)
        assert int(ov) == int(ov_p), case
        if held is not None:
            assert got[0].data_ptr() != held[0].data_ptr()
            assert all(_same_bits(x, y) for x, y in zip(held, want))
        held = got


@pytest.mark.parametrize("case", hard_cases.EPILOGUE_CASES)
def test_epilogue_hard_cases(case):
    """KF with the epilogue folded in against the twins chained on
    kernels/hard_cases.py's epilogue scenes, fed through a fetch whose new
    heads are the cases' (``epilogue_fed``): KF's outputs and the finished
    and alive flags to the bit, the level and the smoothed level to the
    bit where they are numbers (NaN where the twin's is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _kf_vs_chain(hard_cases.fetch_inputs(hard_cases.epilogue_fed(case), "cuda"), case)

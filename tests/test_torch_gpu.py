"""Kernels KA-KZ on the card against their plain PyTorch twins, and the
entry points' default device.

These need a CUDA device and skip without one (the decision is made inside
the fixture, never at import).  The file imports torch, numpy and the port
only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances are chip_smoke.py's: 1e-5 for KA/KB rows, 1e-4 for KC
velocities after warm start + 7 iterations, 1e-6 for KD and KE, 1e-5 for
KF and KG, 1e-6 for KH (hit and body exact) and KI, 1e-5 of each output's
scale for KJ, 1e-5 for KK's rows (masks, keys and touching exact), 1e-6 of
scale for KL (flags and the touched list exact), KM and KN exact, 1e-5
for KO's rows (masks, keys and touching exact), KP exact, 1e-6 of each
output's scale for KQ's setup (masks, slots and table entries exact) and
its refreshed cache exact, KR within 1e-6 of scale (the bench rotations
exact), KS, KT and KV exact (pairs, margins, counters, buckets, compacted
rows, tables, flags, timers), KU within 1e-6 of the positions' scale,
KW within 1e-6 of scale (its twin's fp.fma rounds twice where the kernel's
__fmaf_rn rounds once: they part only at an exact tie; the triangles
exact), KX, KY and KZ exact, and a small terrain frame on the card within
1e-4 m (particles, the character) and 1e-5 of scale (joints) of the CPU
path; KAA exact (HRTF on and off; the pan's cos and sin within 1e-6 of
the gains' scale, an HRIR bin only where its pre-round value lies within
1e-5 of a half-integer), KAB exact; ClientApp on the card by default.
Each kernel repeats its twin's operations in the same order."""

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
    for i in (0, 1, 5, 6, 7, 8, 9):
        assert torch.equal(rk[i], rp[i]), i
    for i in (2, 3, 4):
        assert float((rk[i] - rp[i]).abs()[rp[5]].max()) <= 1e-5
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


def test_audio_kernels_match_plain(audio):
    src, pool, lis, room, st = audio
    b = TICK_FRAMES
    fargs = (pool, src.buf_offset, src.buf_len, src.playhead, st.eff_delta, src.mix_factor,
             src.looping, src.stream_mode, src.stream_write_head, st.active, b,
             mix.window_rows(b))
    sk, hk = kaudio.audio_fetch(*fargs)
    sp, hp = kaudio.audio_fetch_plain(*fargs)
    assert float((sk - sp).abs().max()) <= 1e-6 and float((hk - hp).abs().max()) <= 1e-6
    assert float(sp.abs().max()) > 0.1
    for use_hrtf in (True, False):
        sargs = (sp, src.lp_state, st.alpha, st.use_lp, src.spatial, src.hrir_hist,
                 hrir_bank_tensor("cuda"), st.dir_idx, src.prev_gain_l, src.prev_gain_r,
                 st.gl, st.gr, mix.gain_ramp(b, "cuda"), st.gain, st.send_gain, use_hrtf)
        fk = kaudio.audio_spatialise(*sargs)
        fp = kaudio.audio_spatialise_plain(*sargs)
        for x, y in zip(fk, fp):
            assert float((x - y).abs().max()) <= 1e-5, use_hrtf
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
    """KO on 4,096 random pairs of each hull code, in both layouts: masks,
    keys and touching exact, rows within 1e-5 on valid rows."""
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
            for i in (0, 1, 5, 6, 7, 8, 9):
                assert torch.equal(rk[i], rp[i]), (code, wm, i)
            for i in (2, 3, 4):
                assert float((rk[i] - rp[i]).abs()[rp[5]].max()) <= 1e-5, (code, wm, i)
        assert int(rp[9].sum()) > n // 3


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


def test_mesh_world_on_card_matches_cpu():
    """40 client frames of a 1,200-object mesh world on the card and on the
    CPU path: the hulls within 1e-5 over frames 0-8, before the first
    trimesh kick (chip_smoke.py:small_mesh_phase says why not after), the
    character within 1e-5 and the hit masks equal over all 40."""
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


def test_cell_table_kernel_matches_plain(world):
    """KP: table, cells and overflow exact in both modes, on the world and
    on the same bodies moved onto the 1.4 m lattice (k * 1.4 and one ulp
    either side); with the world's buckets (counters in shared memory) and
    with grid_dim 256's 65,536 (counters in global memory)."""
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


def _ks_check(body, cfg, has_oversize):
    """KS against its twin, at a rebuild (margins from the speeds) and with
    one margin: every output exact.  Returns the twin's rebuild outputs."""
    from substrata_tpu_torch.kernels import pairs as ks
    got = ks.pairs_rebuild(body, DT, cfg, has_oversize)
    want = ks.pairs_rebuild_plain(body, DT, cfg, has_oversize)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(ks.find_pairs(body, cfg, 0.08, has_oversize),
                    ks.find_pairs_plain(body, cfg, 0.08, has_oversize)):
        assert a.dtype == b.dtype and torch.equal(a, b)
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
    """KU within 1e-6 of the largest push its twin gives; KV's strike wake and sleep
    pass exact, as the world is and with half its bodies asleep and every
    timer near its limit.  Returns how many flags the sleep passes
    changed."""
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
    assert float((pk - pp).abs().max()) <= 1e-6 * moved
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
    """KAA's setup and epilogue on bench.py's 256 sources after 10 blocks."""
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
    samples, heads = mix.fetch(pool, src, p["eff_delta"], p["active"], b)
    level = samples.abs().max(dim=1).values * p["gain"]
    eargs = (src.finished, src.looping, src.stream_mode, p["active"], heads, src.buf_len,
             level, src.smoothed_level, src.alive, src.remove_on_finish)
    ek = kaa.epilogue_views(kaa.audio_epilogue(*eargs), s)
    ep = kaa.epilogue_views(kaa.audio_epilogue_plain(*eargs), s)
    for name in ("smoothed_level", "finished", "alive"):
        assert torch.equal(ek[name], ep[name]), name


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

"""Kernels KAD (the halo exchange) and KV's sleep pass: their plain twins
against the reference on ``kernels/hard_cases.py``'s ``HALO_CASES`` and
``SLEEP_CASES``, and both wrappers' plans and packed launches driven on
``meta`` tensors, which reach the CUDA branch without a card, with the
launch recorded instead of made.

Tolerances:
- KAD: every field of the combined state exact (NaN where the reference
  has NaN), as ``tests/test_torch_parallel.py`` holds ``halo_exchange``:
  the reference's ``halo_exchange`` inside a ``shard_map`` over one CPU
  device a slab (1 to 8), the tiles' two ``_axis_exchange`` phases over a
  2 x 2 mesh; each shard's overflow sum equal, and each direction's count
  equal to a numpy count against the twin's thresholds.
- The sleep pass: every output exact (comparisons, selections, one
  addition and NaN-propagating maxima, in the same order on both sides),
  against the reference's ``update_sleeping`` with ``step.py``'s entry
  reductions (:166-187) and its fast-wake rule (:216-224) written out here.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from substrata_tpu.parallel import mesh as jmesh
from substrata_tpu.parallel import spatial as jspatial
from substrata_tpu.physics import integrate as jint
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.kernels import build, hard_cases, halo
from substrata_tpu_torch.kernels import sleep as kv
from substrata_tpu_torch.physics.state import BODY_FIELDS

from torch_port_helpers import FIELDS, jax_body

torch.set_num_threads(2)


# --- KAD's twin against the reference.

def _reference_halo(scene):
    """The reference's combined states (local, from the low neighbour,
    from the high one; the tiles' x phase, then their y phase) and its
    overflow sums a shard, for each phase."""
    body = jax_body(scene.fields)
    h, hw = scene.halo, scene.halo_width
    if len(scene.shape) == 1:
        s = scene.shape[0]
        x_min, x_max = scene.extent

        @partial(shard_map, mesh=jmesh.make_mesh(s, axis="x"), in_specs=(P("x"),),
                 out_specs=(P("x"), P("x")), check_vma=False)
        def slabs(local):
            fl, fr, ov = jspatial.halo_exchange(local, h, hw, x_min, x_max, "x", s)
            return jspatial._tree_concat([local, fl, fr]), ov[None]
        combined, ov = jax.jit(slabs)(body)
        return [combined], [ov]
    px, py = scene.shape
    x_lo, x_hi, y_lo, y_hi = scene.extent
    mesh = JMesh(np.array(jax.devices()[:px * py]).reshape(px, py), ("sx", "sy"))

    @partial(shard_map, mesh=mesh, in_specs=(P(("sx", "sy")),),
             out_specs=(P(("sx", "sy")),) * 4, check_vma=False)
    def tiles(local):
        lo_x, hi_x, ov_x = jspatial._axis_exchange(local, 0, h, hw, x_lo, x_hi, "sx", px)
        with_x = jspatial._tree_concat([local, lo_x, hi_x])
        lo_y, hi_y, ov_y = jspatial._axis_exchange(with_x, 1, h, hw, y_lo, y_hi, "sy", py)
        return with_x, jspatial._tree_concat([with_x, lo_y, hi_y]), ov_x[None], ov_y[None]
    with_x, combined, ov_x, ov_y = jax.jit(tiles)(body)
    return [with_x, combined], [ov_x, ov_y]


def _counts(state, s, axis, stride, n_axis, lo, hi):
    """[S, 2] boundary counts (sent up, sent down) from the thresholds."""
    c = state.pos[:, axis].numpy().reshape(s, -1)
    alive = state.alive.numpy().reshape(s, -1)
    ap = (np.arange(s) // stride) % n_axis
    return np.stack([(alive & (c > hi[ap, None])).sum(1),
                     (alive & (c < lo[ap, None])).sum(1)], axis=1)


@pytest.mark.parametrize("case", hard_cases.HALO_CASES)
def test_halo_cases_twin_matches_reference(case):
    scene = hard_cases.halo_scene(case)
    want, want_ov = _reference_halo(scene)
    state, s, h, phases = hard_cases.halo_inputs(scene, "cpu")
    counts, firsts = [], []
    for (axis, stride, n_axis, lo, hi), jstate_, jov in zip(phases, want, want_ov):
        count = _counts(state, s, axis, stride, n_axis, lo, hi)
        state, ov = halo.exchange(state, s, h, axis, stride, n_axis, lo, hi)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate_, f)), err_msg=f"{case} {f}")
        np.testing.assert_array_equal(ov.numpy(), np.maximum(count - h, 0))
        np.testing.assert_array_equal(ov.sum(1).numpy(), np.asarray(jov))
        counts.append(count)
        firsts.append(state)
    count, rows_out = counts[0], scene.rows_in + 2 * h
    ghosts = firsts[0].alive.numpy().reshape(s, rows_out)[:, scene.rows_in:].sum()
    if case == "none_masked":
        assert count.sum() == 0 and ghosts == 0
    if case in ("exactly_h", "h_minus_1", "h_plus_1"):
        assert (count == h + {"exactly_h": 0, "h_minus_1": -1, "h_plus_1": 1}[case]).all()
        assert ghosts == 2 * (s - 1) * min(count[0, 0], h)
    if case == "all_masked":
        alive = scene.fields["alive"].reshape(s, -1).sum(1)
        assert (count == alive[:, None]).all() and (count > h).all()
    if case == "on_thresholds":
        assert (count > 0).all()
    if case == "dead_nan_edge":
        assert np.isnan(state.pos[:, 0].numpy()).any()
    if case == "tiles":
        assert (counts[1].sum() > 0) and (counts[0].sum() > 0)


# --- The sleep pass's twin against the reference.

def _reference_sleep(scene, args):
    """step.py:166-187's reductions, integrate.update_sleeping and
    step.py:216-224's fast wake, on the scene."""
    body, prev_awake, linvel, angvel, srows, prows, lam_p, table, sign, wm, dt, _, steps = args
    arrays = {f: getattr(body, f).numpy() for f in BODY_FIELDS}
    jb = jax_body(arrays)
    jp = jstate.default_sim_params()
    n = body.capacity
    a = lambda t: jnp.asarray(t.numpy())     # noqa: E731
    s_valid, s_pen = a(srows[0]), a(srows[1])
    c_a, c_b, c_valid, c_pen = (a(t) for t in prows)
    k_s = s_valid.shape[0] // n
    deep_static = jnp.any((s_valid & (s_pen > 0.1)).reshape(n, k_s), axis=1)
    n_e = c_a.shape[0] // wm
    row_valid = c_valid.reshape(n_e, wm)
    e_a = c_a.reshape(n_e, wm)[:, 0]
    e_b = c_b.reshape(n_e, wm)[:, 0]
    e_valid = jnp.any(row_valid, axis=1)
    e_imp = jnp.max(jnp.where(row_valid, a(lam_p.contiguous()), 0.0), axis=1)
    e_pen = jnp.max(jnp.where(row_valid, c_pen.reshape(n_e, wm), -1e9), axis=1)
    awake, timer, lin, ang = jint.update_sleeping(
        jb, a(linvel), a(angvel), e_a, e_b, e_imp, e_valid, a(table), a(sign),
        jnp.float32(dt), jp, contact_pen=e_pen, extra_deep=deep_static)
    newly_awake = awake & ~a(prev_awake)
    woke_speed = jnp.where(newly_awake, jnp.linalg.norm(lin, axis=-1), 0.0)
    fast_wake = jnp.max(woke_speed) > 1.0
    return dict(awake=awake, sleep_timer=timer, linvel=lin, angvel=ang,
                newly_awake=newly_awake, newly_asleep=a(prev_awake) & ~awake,
                steps_left=jnp.where(fast_wake, 0, a(steps)))


@pytest.mark.parametrize("case", hard_cases.SLEEP_CASES)
def test_sleep_cases_twin_matches_reference(case):
    scene = hard_cases.sleep_scene(case)
    args = hard_cases.sleep_inputs(scene, "cpu")
    got = kv.sleep_pass(*args)
    want = _reference_sleep(scene, args)
    for name, w in want.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w),
                                      err_msg=f"{case} {name}")
    table = args[7].numpy()
    assert table.shape[1] == scene.cpb
    if case == "cpb40":
        assert (table[3] >= 0).all()
    if case == "slots_full":
        assert (table >= 0).all()
    if case in ("fast_wake", "fast_and_nan"):
        assert bool(got.newly_awake[0])
    if case in ("nan_fast_wake", "fast_and_nan"):
        assert bool(got.newly_awake[2])
    if case in ("fast_wake",):
        assert int(got.steps_left) == 0
    if case in ("nan_fast_wake", "fast_and_nan", "all_asleep", "n1"):
        assert int(got.steps_left) == scene.steps_left
    if case == "all_asleep":
        assert not got.newly_asleep.any()
    if case not in ("n1", "all_asleep"):
        assert got.newly_awake.any()
    if case not in ("n1", "slots_full"):     # every body of slots_full is touched
        assert (got.sleep_timer > 0).any()


# --- KAD's and KV's CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _meta(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_meta(y) for y in x)
    return x


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(halo, "_plans", {})
    monkeypatch.setattr(kv, "_plans", {})
    return calls


@pytest.mark.parametrize("case", ["ragged_rows", "s1", "tiles"])
def test_halo_plan_packs_and_checks(recorded, case):
    """One plan per (S, rows_in, H, axis, stride, n_axis, thresholds,
    device); the combined fields and the overflow counts are views of one
    allocation, each field 16-byte aligned in it; the packed launch holds
    the buffer, the record and the 23 source pointers; the ghost blocks
    cover the SMs and hold at most 256 places; a bad argument raises
    before a launch."""
    scene = hard_cases.halo_scene(case)
    state, s, h, phases = hard_cases.halo_inputs(scene, "cpu")
    state = _meta(state)
    axis, stride, n_axis, lo, hi = phases[0]
    out, ov = halo.exchange(state, s, h, axis, stride, n_axis, lo, hi)
    rows_out = scene.rows_in + 2 * h
    assert tuple(out.pos.shape) == (s * rows_out, 3) and tuple(ov.shape) == (s, 2)
    base = out.pos.untyped_storage()
    plan = next(iter(halo._plans.values()))
    offsets = []
    for f in BODY_FIELDS:
        t = getattr(out, f)
        assert t.untyped_storage().data_ptr() == base.data_ptr() and t.is_contiguous()
        offsets.append(t.storage_offset() * t.element_size())
        assert offsets[-1] % 16 == 0 and t.shape[0] == s * rows_out
    assert ov.storage_offset() * 4 == plan.overflow_at
    name, packed = recorded[-1]
    nf = len(BODY_FIELDS)
    v = np.frombuffer(packed, dtype=np.int64)
    assert name == "halo_exchange" and v.size == 2 + 15 + nf
    assert list(v[3:15]) == [nf, BODY_FIELDS.index("pos"), halo.ALIVE_F, halo.AWAKE_F, s,
                             scene.rows_in, h, axis, stride, n_axis, plan.parts,
                             plan.copy_blocks]
    # The device table: offsets, bytes a row, each position's thresholds.
    table = plan.table_host
    assert tuple(plan.table.shape) == (2 * nf + n_axis,) and plan.table.dtype == torch.int64
    row = [getattr(out, f).element_size() * (getattr(out, f).numel() // (s * rows_out))
           for f in BODY_FIELDS]
    assert list(table[:nf]) == offsets and list(table[nf:2 * nf]) == row
    words = table[2 * nf:].view(np.uint64)
    np.testing.assert_array_equal((words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                                  .view(np.float32), lo)
    np.testing.assert_array_equal((words >> np.uint64(32)).astype(np.uint32).view(np.float32),
                                  hi)
    # The item map: every (direction, field, place, unit) of C places once,
    # field-major, consecutive units of consecutive places.
    chunk = -(-h // plan.parts)
    m = plan.map_host
    assert v[16] == m.size and m.dtype == np.int32
    units = [b if b % 4 else b // 4 for b in row]
    assert m.size == 2 * chunk * sum(units)
    pl, w, k, e, byte = m & 0xFF, (m >> 8) & 0xF, (m >> 12) & 0x1F, (m >> 17) & 1, (m >> 18) & 1
    want = [(ee, kk, pp, ww) for ee in (0, 1) for kk, u in enumerate(units)
            for pp in range(chunk) for ww in range(u)]
    assert list(zip(e, k, pl, w)) == want
    assert all(byte[k == kk].all() == (row[kk] % 4 != 0) for kk in range(nf))
    assert -(-h // plan.parts) <= 256 and (2 * s * plan.parts >= 132 or plan.parts >= h // 32)
    assert 1 <= plan.copy_blocks <= 132
    # A caller's overflow, the same plan; the tiles' y phase on the x
    # phase's combined state, a plan of its own.
    mine = torch.empty((2, s, 2), dtype=torch.int32, device="meta")
    _, got_ov = halo.exchange(state, s, h, axis, stride, n_axis, lo, hi, mine[1])
    assert got_ov.data_ptr() == mine[1].data_ptr() and len(halo._plans) == 1
    if len(phases) == 2:
        halo.exchange(out, s, h, *phases[1])
        assert len(halo._plans) == 2
    n_calls = len(recorded)
    bads = ((state.replace(pos=state.pos.double()), TypeError),
            (state.replace(quat=state.quat[:, :3]), ValueError),
            (state.replace(alive=state.alive.int()), TypeError))
    for bad, exc in bads:
        with pytest.raises(exc):
            halo.exchange(bad, s, h, axis, stride, n_axis, lo, hi)
    with pytest.raises(ValueError):
        halo.exchange(state, s, h, axis, stride, n_axis, lo, hi, mine[:, :1])
    assert len(recorded) == n_calls


@pytest.mark.parametrize("case", ["cpb1", "cpb8", "cpb16", "cpb40", "wm4"])
def test_sleep_plan_packs_and_checks(recorded, case, monkeypatch):
    """One plan per (N, rows, wm, K, CPB, device, stream), holding a zeroed
    64-bit ticket and the lanes a body (CPB up to 32, a power of two); one
    packed launch a call whose outputs are views of one allocation; a bad
    argument raises before a launch; a launch that fails drops the plan."""
    scene = hard_cases.sleep_scene(case)
    args = _meta(hard_cases.sleep_inputs(scene, "cpu"))
    n, cpb, wm = scene.awake.shape[0], scene.cpb, scene.lam.shape[1]
    before = kv.launches["sleep_pass"]
    out = kv.sleep_pass(*args)
    assert kv.launches["sleep_pass"] == before + 1
    name, packed = recorded[-1]
    v = kv._PACK.unpack(packed)
    assert name == "sleep_pass" and len(packed) == 29 * 8
    g = min(cpb, 32)
    assert v[22:27] == (args[6].stride(1), n, wm, 4, cpb) and v[28] == 1.0 / 60.0
    # CPB's lanes, a power of two, while N x lanes <= 100,000 (64 bodies here).
    assert 1 << v[27] >= g and 1 << v[27] < 2 * g
    plan = next(iter(kv._plans.values()))
    assert plan.ticket.dtype == torch.int64 and plan.ticket.numel() == 1
    assert v[20] == plan.ticket.data_ptr()
    storage = out.awake.untyped_storage().data_ptr()
    for f in ("awake", "sleep_timer", "linvel", "angvel", "newly_awake", "newly_asleep",
              "steps_left"):
        assert getattr(out, f).untyped_storage().data_ptr() == storage, f
    assert v[21] == storage
    assert tuple(out.linvel.shape) == (n, 3) and out.steps_left.dim() == 0
    kv.sleep_pass(*args)
    assert len(kv._plans) == 1 and len(recorded) == 2
    body, prev, lin, ang, srows, prows = args[:6]
    bads = ((body.replace(awake=body.awake.int()),) + args[1:],
            args[:2] + (lin[:, :2],) + args[3:],
            args[:5] + ((prows[0].long(),) + prows[1:],) + args[6:],
            args[:7] + (args[7][:, :-1],) + args[8:],
            args[:6] + (args[6].contiguous().t(),) + args[7:])
    for bad in bads:
        with pytest.raises((TypeError, ValueError)):
            kv.sleep_pass(*bad)
    assert len(recorded) == 2

    def fail(name, packed):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(build, "launch_packed", fail)
    kv._plans.clear()
    with pytest.raises(RuntimeError):
        kv.sleep_pass(*args)
    assert not kv._plans


@pytest.mark.parametrize("n,cpb,lanes", [(64, 8, 8), (64, 40, 32), (10_240, 8, 8),
                                         (32_768, 8, 2), (65_536, 8, 1), (200_000, 16, 1),
                                         (1, 1, 1)])
def test_sleep_lanes_a_body(n, cpb, lanes):
    """CPB's lanes a body (a power of two, at most 32) while N x lanes stays
    within 100,000 threads, then fewer."""
    assert 1 << kv._Plan(n, 4, 2, 4, cpb, torch.device("meta")).g_shift == lanes


def test_sleep_plan_refuses_wide_entries(recorded):
    scene = hard_cases.sleep_scene("wm4")
    args = _meta(hard_cases.sleep_inputs(scene, "cpu"))
    body, prev, lin, ang, srows, prows, lam = args[:7]
    q = lam.shape[0]
    wide = (torch.empty((q * 9,), dtype=torch.int32, device="meta"),) * 2 + (
        torch.empty((q * 9,), dtype=torch.bool, device="meta"),
        torch.empty((q * 9,), dtype=torch.float32, device="meta"))
    lam9 = torch.empty((q, 9), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        kv.sleep_pass(body, prev, lin, ang, srows, wide, lam9, *args[7:9], 9, *args[10:])
    assert not recorded

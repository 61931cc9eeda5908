"""Kernel KB's plain twin (``kernels/static_contacts.py``) against the
reference's jitted ``static_contacts`` on ``kernels/hard_cases.py``'s
static-contact scenes, at K = 1, 4 and 8; and the wrappers' plans (KB's
static world, KW's field) driven on ``meta`` tensors, which reach the CUDA
branch without a card, with the launch recorded instead of made.

Tolerances (tests/test_torch_trimesh.py's): ids, keys and the valid mask
exact; points, normals, depths, friction and restitution within 1e-5 on
the valid rows.  The twin tests only eligible bodies' samples against the
trimesh, as the kernel does: the other rows are invalid in both, and their
values are not compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import narrowphase as jn
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import static_contacts as kb
from substrata_tpu_torch.kernels import terrain as kt
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import jax_body

torch.set_num_threads(2)

ATOL = 1e-5
_jstatic = jax.jit(jn.static_contacts, static_argnames=("config",))


def _reference_world(w):
    """The reference's StaticWorld from the scene's arrays."""
    tm, hl = w["trimesh"], w["hulls"]
    return jstate.StaticWorld(
        heightfield=jstate.Heightfield(heights=jnp.asarray(w["heights"]),
                                       origin=jnp.asarray(w["origin"]),
                                       cell_w=jnp.asarray(w["cell_w"]), is_flat=w["is_flat"]),
        has_heightfield=jnp.asarray(w["has_heightfield"]),
        trimesh=jstate.TriMesh(**{k: jnp.asarray(v) for k, v in tm.items()}),
        hulls=jstate.HullLibrary(**{k: jnp.asarray(v) for k, v in hl.items()}),
        water_z=jnp.asarray(w["water_z"]))


@pytest.mark.parametrize("k", hard_cases.STATIC_KS)
@pytest.mark.parametrize("case", hard_cases.STATIC_CASES)
def test_static_hard_cases_match_reference(case, k):
    scene = hard_cases.static_scene(case)
    args = hard_cases.static_inputs(scene, k, "cpu")
    tc = kb.static_contacts(*args)
    cap = scene.bodies["pos"].shape[0]
    cfg = jstate.SimConfig(capacity=cap, static_contacts_per_body=k,
                           present_shape_types=scene.present,
                           max_tri_candidates=scene.max_tri_candidates)
    jc = _jstatic(jax_body(scene.bodies), _reference_world(scene.world),
                  jnp.zeros((cap, 8, 3)), config=cfg)
    jv = np.asarray(jc.valid)
    for i, f in ((0, "a"), (1, "b"), (5, "valid"), (8, "key")):
        np.testing.assert_array_equal(tc[i].numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    assert jv.sum() > 0
    for i, f in ((2, "point"), (3, "normal"), (4, "penetration"), (6, "friction"),
                 (7, "restitution")):
        np.testing.assert_allclose(tc[i].numpy()[jv], np.asarray(getattr(jc, f))[jv],
                                   atol=ATOL, rtol=0, err_msg=f)


def test_equal_depth_rules_decide_rows():
    """The scene really holds the ties its docstring names: the mirrored
    triangles' exactly equal depths (the first listed gives the point), the
    heightfield's tie with a ground-level triangle (the heightfield row
    stays) and the resting box's four samples at depth 0 (the lower sample
    indices kept at K = 1 and 4)."""
    scene = hard_cases.static_scene("equal_depths")
    args = hard_cases.static_inputs(scene, 8, "cpu")
    body, tm = args[0], args[6]
    pts, rad, _ = kb.shape_sample_points(body, scene.present, args[5])
    pen, cp, _, ok = kb.trimesh_sphere_rows(tm, pts[:, 0], rad, 16)
    assert bool(ok[3, :2].all()) and float(pen[3, 0]) == float(pen[3, 1])
    assert float(cp[3, 0, 0]) != float(cp[3, 1, 0])
    rows = kb.static_contacts(*args)
    np.testing.assert_array_equal(rows[2][3 * 8].numpy(), cp[3, 0].numpy())
    assert float(rows[2][5 * 8, 2]) == -0.125                # the heightfield's point
    for k in (1, 4):
        r = kb.static_contacts(*hard_cases.static_inputs(scene, k, "cpu"))
        assert r[8][7 * k:7 * k + k].tolist() == [1, 3, 5, 7][:k]


# --- The plans, on meta tensors (the CUDA branch without a card). --------

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x.replace(**{f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)
                        if isinstance(getattr(x, f.name), torch.Tensor)})


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(kb, "_plans", {})
    monkeypatch.setattr(kt, "_field_plans", {})
    monkeypatch.setattr(kt, "_last_plan", [None])
    return calls


def _meta_inputs(case="mixed_present", k=4):
    body, hf, has_hf, k, present, hulls, tm, kc = hard_cases.static_inputs(
        hard_cases.static_scene(case), k, "cpu")
    return (_meta(body), _meta(hf), _meta(has_hf), k, present, _meta(hulls), _meta(tm), kc)


def test_static_contacts_plan_packs_and_checks(recorded):
    args = _meta_inputs()
    n = args[0].capacity
    out = kb.static_contacts(*args)
    assert [tuple(o.shape) for o in out] == [(n * 4,), (n * 4,), (n * 4, 3), (n * 4, 3)] + [
        (n * 4,)] * 5
    assert [o.dtype for o in out] == [torch.int32, torch.int32, torch.float32, torch.float32,
                                      torch.float32, torch.bool, torch.float32, torch.float32,
                                      torch.int32]
    name, packed = recorded[-1]
    assert name == "static_contacts" and len(packed) == kb._PACK.size == 42 * 8
    sizes = kb._PACK.unpack(packed)[22:33]
    gx, gy, tcap = args[6].cell_tris.shape
    assert sizes == (n, 7, 7, 0b111110, 4, 4, 32, gx, gy, tcap, min(tcap, 16))
    kb.static_contacts(*args)
    assert len(kb._plans) == 1 and len(recorded) == 2
    # A new static world of the same shapes: a plan of its own.
    kb.static_contacts(args[0], _meta(args[1]), *args[2:])
    assert len(kb._plans) == 2
    body = args[0]
    for bad, exc in ((body.replace(pos=body.pos.double()), TypeError),
                     (body.replace(quat=body.quat[:-1]), ValueError),
                     (body.replace(awake=torch.empty(n, dtype=torch.bool)), ValueError),
                     (body.replace(layer=torch.empty((n, 2), dtype=torch.int32,
                                                     device="meta")[:, 0]), ValueError)):
        with pytest.raises(exc):
            kb.static_contacts(bad, *args[1:])
    hf = args[1]
    with pytest.raises(TypeError):
        kb.static_contacts(body, hf.replace(heights=hf.heights.double()), *args[2:])
    with pytest.raises(ValueError):
        kb.static_contacts(body, *args[1:6], args[6].replace(cell_tris=torch.empty(
            (2, 3), dtype=torch.int32)), args[7])
    assert len(recorded) == 3


def test_static_contacts_plan_cache_stays_bounded(recorded):
    args = _meta_inputs()
    for _ in range(3 * kb._MAX_PLANS):
        kb.static_contacts(args[0], _meta(args[1]), *args[2:])
    assert len(kb._plans) == kb._MAX_PLANS
    assert len(recorded) == 3 * kb._MAX_PLANS


def test_terrain_heights_plan_packs_and_checks(recorded):
    field = tuple(torch.empty(s, device="meta") for s in ((33, 17), (2,), ()))
    xy = torch.empty((100, 2), device="meta")
    assert tuple(kt.terrain_heights(*field, xy).shape) == (100, 1)
    assert tuple(kt.terrain_heights(*field, xy, True).shape) == (100, 4)
    assert len(kt._field_plans) == 1
    name, packed = recorded[-1]
    assert name == "terrain_heights" and len(packed) == 9 * 8
    assert kt._FIELD_PACK.unpack(packed[:40])[3:] == (33, 17)
    assert kt._CALL_PACK.unpack(packed[40:])[1:3] == (100, 1)
    for bad, exc in ((torch.empty((100, 3), device="meta"), ValueError),
                     (torch.empty((100, 2), device="meta", dtype=torch.float64), TypeError),
                     (torch.empty((2, 100), device="meta").t(), ValueError),
                     (torch.empty(100, device="meta"), ValueError)):
        with pytest.raises(exc):
            kt.terrain_heights(*field, bad)
    for f in ((field[0].double(), *field[1:]), (field[0][:1], *field[1:]),
              (field[0], torch.empty(3, device="meta"), field[2]),
              (field[0], field[1], torch.empty(1, device="meta")),
              (torch.empty((33, 17)), *field[1:])):
        with pytest.raises((TypeError, ValueError)):
            kt.terrain_heights(*f, xy)
    for _ in range(3 * kt._MAX_FIELD_PLANS):
        kt.terrain_heights(*(torch.empty_like(t) for t in field), xy)
    assert len(kt._field_plans) == kt._MAX_FIELD_PLANS
    assert len(recorded) == 2 + 3 * kt._MAX_FIELD_PLANS
    # Outputs made ahead: one block per call shape, at most _MAX_OUT_SHAPES.
    plan = kt._last_plan[0]
    for p in range(1, 3 * kt._MAX_OUT_SHAPES):
        for _ in range(kt._OUT_BATCH + 1):
            assert tuple(kt.terrain_heights(*plan.field, xy[:p]).shape) == (p, 1)
    assert len(plan.ahead) == kt._MAX_OUT_SHAPES
    assert all(len(v) <= kt._OUT_BATCH for v in plan.ahead.values())


def test_cpu_tensors_take_the_twins(monkeypatch):
    """CPU tensors never reach a plan or a launch: the twins answer."""
    monkeypatch.setattr(build, "launch_packed", None)
    seen = []
    twin_kb, twin_kw = kb.static_contacts_plain, kt.terrain_heights_plain
    monkeypatch.setattr(kb, "static_contacts_plain",
                        lambda *a: seen.append("kb") or twin_kb(*a))
    monkeypatch.setattr(kt, "terrain_heights_plain",
                        lambda *a: seen.append("kw") or twin_kw(*a))
    n_kb, n_kw = kb.launches, kt.launches["terrain_heights"]
    args = hard_cases.static_inputs(hard_cases.static_scene("ineligible"), 4, "cpu")
    kb.static_contacts(*args)
    h = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (9, 9)).astype(np.float32))
    got = kt.terrain_heights(h, torch.tensor([-4.0, -4.0]), torch.tensor(1.0),
                             torch.zeros((5, 2)), True)
    assert seen == ["kb", "kw"] and tuple(got.shape) == (5, 4)
    assert kb.launches == n_kb and kt.launches["terrain_heights"] == n_kw
    assert tstate.BODY_FIELDS[0] == "pos"

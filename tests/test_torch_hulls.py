"""substrata_tpu_torch's convex hulls against substrata_tpu: the shape
factory, the hull-combo contacts (the plain twin of kernel KO, alone and
through ``pair_contacts``' buckets in both layouts), the golden
hull scenes of test_jolt_fidelity.py and the scenarios of test_hull.py on
the port's PhysicsWorld, and the world's hull library.

Tolerances:
- ``make_convex_hull``: the same scipy qhull call with the same options
  (``"QJ"``) on both sides, so the hull's vertices, planes and contact
  vertices are equal and the float64 mass properties agree to 1e-6 of
  their scale (mass, volume, bound, inverse inertia, rotation, COM).  A
  future scipy whose joggle differs would break the equality on both
  sides alike; this test would then show the reference's shape and the
  port's differing only if the two packages called it differently.
- KO's twin: points, normals and depths within 1e-5 absolute on 4,096
  seeded pairs of each hull code (float32 at unit scale; the two differ
  in summation order and multiply-add contraction, measured <= 7e-7);
  validity masks equal.
- The golden scenes and test_hull.py: the reference's own bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import narrowphase as jn
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld, convert
from substrata_tpu_torch.kernels import convex as ko
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import SimConfig

from test_torch_world import load_golden, make_world, run_engine

torch.set_num_threads(2)

OCTA = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                np.float32)
CUBE = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)],
                np.float32)
SLAB = np.array([[x, y, z] for x in (-0.8, 0.8) for y in (-0.8, 0.8) for z in (-0.2, 0.2)],
                np.float32)


def _cloud(n, seed, surface=False):
    """n seeded points, inside an ellipsoid-ish blob or (``surface``) on
    one, where every point is a hull vertex."""
    p = np.random.default_rng(seed).normal(size=(n, 3))
    if surface:
        p /= np.linalg.norm(p, axis=1, keepdims=True)
    return p * [0.5, 0.3, 0.4]


CLOUDS = {"cube": CUBE, "octahedron": OCTA * 0.5, "slab": SLAB,
          "cloud20": _cloud(20, 1), "cloud60": _cloud(60, 2), "cloud200": _cloud(200, 3, surface=True),
          "offset_box": CUBE * [1.0, 0.6, 0.4] + [3.0, -2.0, 1.0]}


@pytest.mark.parametrize("name", list(CLOUDS))
def test_make_convex_hull_matches_reference(name):
    """Field for field; cloud200 has more than 32 hull vertices and takes
    _reduce_hull_verts."""
    v = CLOUDS[name]
    j, t = jshapes.make_convex_hull(v, mass=0.0), shapes.make_convex_hull(v, mass=0.0)
    assert t.shape_type == j.shape_type
    for f in ("hull_verts", "hull_planes", "hull_contact_verts", "params"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    scale = max(1.0, float(j.mass))
    for f in ("mass", "inv_mass", "volume", "bound_radius"):
        assert abs(getattr(t, f) - getattr(j, f)) <= 1e-6 * max(1.0, abs(getattr(j, f))), f
    np.testing.assert_allclose(t.inv_inertia, j.inv_inertia, rtol=1e-6, atol=1e-9 * scale)
    np.testing.assert_allclose(t.principal_rot, j.principal_rot, atol=1e-6)
    np.testing.assert_allclose(t.com_offset, j.com_offset, atol=1e-6)
    if name == "cloud200":
        assert len(t.hull_verts) == 32
    # The pose helpers.
    q = np.array([0.1, -0.3, 0.2, 0.9], np.float32)
    q /= np.linalg.norm(q)
    for a, b in zip(t.body_pose_from_mesh([1.0, 2.0, 3.0], q),
                    j.body_pose_from_mesh([1.0, 2.0, 3.0], q)):
        np.testing.assert_array_equal(a, b)
    bp, bq = t.body_pose_from_mesh([1.0, 2.0, 3.0], q)
    for a, b in zip(t.mesh_pose_from_body(bp, bq), j.mesh_pose_from_body(bp, bq)):
        np.testing.assert_array_equal(a, b)
    assert t.pose_is_identity() == j.pose_is_identity()
    assert t.size_bytes() == j.size_bytes()


def test_degenerate_and_scaled_hulls_match_reference():
    """A planar cloud takes the degenerate branch; scaled() rebuilds a hull."""
    flat = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float64)
    j, t = jshapes.make_convex_hull(flat), shapes.make_convex_hull(flat)
    np.testing.assert_array_equal(t.hull_verts, j.hull_verts)
    assert t.volume == pytest.approx(j.volume, rel=1e-6)
    js = jshapes.scaled(jshapes.make_convex_hull(CUBE, mass=50.0), [2.0, 1.0, 0.5])
    ts = shapes.scaled(shapes.make_convex_hull(CUBE, mass=50.0), [2.0, 1.0, 0.5])
    np.testing.assert_array_equal(ts.hull_verts, js.hull_verts)
    np.testing.assert_array_equal(ts.hull_planes, js.hull_planes)
    assert ts.mass == js.mass == 50.0


def _library(clouds):
    """The same hull library for both packages (the worlds' interning)."""
    lib = jstate.empty_hull_library()
    for h, c in enumerate(clouds):
        s = jshapes.make_convex_hull(c)
        v = s.hull_verts
        pad = np.repeat(v[:1], 32, 0)
        pad[:len(v)] = v
        pl = np.zeros((32, 4), np.float32)
        pl[:len(s.hull_planes)] = s.hull_planes
        lib = lib.replace(verts=lib.verts.at[h].set(pad), n_verts=lib.n_verts.at[h].set(len(v)),
                          planes=lib.planes.at[h].set(pl),
                          n_faces=lib.n_faces.at[h].set(len(s.hull_planes)))
    arrays = {k: np.asarray(getattr(lib, k)) for k in ("verts", "n_verts", "planes", "n_faces")}
    return lib, convert.hull_library_from_numpy(arrays, device="cpu")


def _side(rng, st, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    prm = np.zeros((n, 4), np.float32)
    if st == 0:
        prm[:, 0] = rng.uniform(0.2, 0.6, n)
    elif st == 1:
        prm[:, :3] = rng.uniform(0.2, 0.7, (n, 3))
    elif st == 2:
        prm[:, 0] = rng.uniform(0.15, 0.4, n)
        prm[:, 1] = rng.uniform(0.2, 0.6, n)
    else:
        prm[:, 0] = rng.integers(0, 4, n)
    return rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32), q.astype(np.float32), prm


@pytest.mark.parametrize("code", list(ko.CODES))
def test_convex_twin_matches_reference(code):
    """KO's twin on 4,096 seeded pairs of one hull code (hulls: a cube, an
    octahedron, a 60-point cloud, a tetrahedron), against the reference's
    ``_make_convex_kernel``: validity exact, points, depths and normals
    within 1e-5 on the valid rows."""
    rng = np.random.default_rng(200 + code)
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) * 0.8
    jlib, tlib = _library([CUBE, OCTA * 0.6, _cloud(60, 9), tet])
    n = 4096
    (pa, qa, ra), (pb, qb, rb) = _side(rng, code // 4, n), _side(rng, code % 4, n)

    def jrow(p, q, r, st):
        return np.concatenate([p, q, np.full((n, 1), st, np.float32), r,
                               np.zeros((n, 3), np.float32)], 1)
    kern = jax.jit(jn._make_convex_kernel(code // 4, code % 4, jlib))
    jp, jpen, jnrm, jv = (np.asarray(x) for x in kern(jnp.asarray(jrow(pa, qa, ra, code // 4)),
                                                       jnp.asarray(jrow(pb, qb, rb, code % 4))))
    t = torch.as_tensor
    tp, tpen, tnrm, tv = ko.convex_contact(code, t(pa), t(qa), t(ra), t(pb), t(qb), t(rb), tlib)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.any(axis=1).sum() > n // 2          # a real test: most pairs touch
    both = jv
    assert np.abs(tpen.numpy() - jpen)[both].max() <= 1e-5
    assert np.abs(tp.numpy() - jp)[both].max() <= 1e-5
    assert np.abs(tnrm.numpy() - jnrm)[both.any(axis=1)].max() <= 1e-5


@pytest.mark.parametrize("blocked_wm", [4, 0])
def test_hull_pair_contacts_match_reference(blocked_wm):
    """A 60-body pile of spheres, boxes, capsules and hulls (all 16 combo
    codes) through ``pair_contacts`` with the hull library, in the
    pair-blocked and the compacted layout: ids, keys, validity, touching
    and overflow equal the reference's; friction, restitution, points,
    normals and depths within 1e-5 on its valid rows."""
    from substrata_tpu.physics import broadphase as jbroad
    from substrata_tpu_torch.physics import narrowphase as tn
    from torch_port_helpers import jax_body, mixed_world_arrays
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) * 0.5
    hulls = [CUBE * 0.6, OCTA * 0.35, _cloud(60, 9) * 0.8, tet]
    jlib, tlib = _library(hulls)
    a = mixed_world_arrays(64, 60, 17)
    rng = np.random.default_rng(17)
    for i in rng.choice(60, 24, replace=False):          # 24 bodies become hulls
        h = int(rng.integers(len(hulls)))
        a["shape_type"][i] = 3
        a["shape_params"][i] = [h, 0, 0, 0]
        a["bound_radius"][i] = float(np.linalg.norm(
            jshapes.make_convex_hull(hulls[h]).hull_verts, axis=1).max())
    cfg = dict(capacity=64, max_pairs=256, grid_dim=16, cell_size=2.0, pairs_per_body=8,
               present_shape_types=(True, True, True, True))
    jcfg = jstate.SimConfig(**cfg)
    jbody = jax_body(a)
    pa, pb, pv, _, _ = jax.jit(jbroad.find_pairs, static_argnames=("config",))(jbody,
                                                                              config=jcfg)
    jc, jt, jov = jax.jit(jn.pair_contacts, static_argnames=("config", "blocked_wm"))(
        jbody, pa, pb, pv, config=jcfg, hulls=jlib, blocked_wm=blocked_wm)
    pa, pb, pv = (torch.as_tensor(np.array(x)) for x in (pa, pb, pv))
    body = convert.body_state_from_numpy(a, device="cpu")
    tc, tt, tov = tn.pair_contacts(body, pa, pb, pv, SimConfig(**cfg), hulls=tlib,
                                   blocked_wm=blocked_wm)
    codes = {int(a["shape_type"][x]) * 4 + int(a["shape_type"][y])
             for x, y, v in zip(pa.tolist(), pb.tolist(), pv.tolist()) if v}
    assert {3, 7, 11, 15} <= codes | {(c % 4) * 4 + c // 4 for c in codes}
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tov) == int(jov) and int(tt.sum()) > 10
    jvalid = np.asarray(jc.valid)
    st = a["shape_type"]
    hull_rows = jvalid & ((st[np.maximum(np.asarray(jc.a), 0)] == 3)
                          | (st[np.maximum(np.asarray(jc.b), 0)] == 3))
    assert hull_rows.sum() > 20                  # the hull codes make real contacts
    for f in ("a", "b", "key", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), f)
    for f in ("friction", "restitution"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), atol=1e-5)
    for f in ("point", "normal", "penetration"):
        np.testing.assert_allclose(getattr(tc, f).numpy()[jvalid],
                                   np.asarray(getattr(jc, f))[jvalid], atol=1e-5, err_msg=f)


def _hull_world(**kw):
    cfg = SimConfig(capacity=32, max_pairs=256, grid_dim=16, cell_size=2.0, solver_iters=8,
                    **kw)
    w = PhysicsWorld(cfg, device="cpu")
    w.set_ground_plane(0.0)
    return w


def _golden_hull_drop():
    """test_jolt_fidelity.py:118, its fixture and bounds."""
    gpos, _ = load_golden("hull_drop")
    w = make_world()
    h = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA * 0.5),
                                   pos=np.array([0, 0, 1.2], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    w.set_linear_and_angular_vel(h, np.zeros(3, np.float32),
                                 np.array([1.0, 0.3, 0.0], np.float32))
    pos = run_engine(w, [h], len(gpos))
    assert abs(pos[-1, 0, 2] - gpos[-1, 0, 2]) < 0.08, (pos[-1, 0, 2], gpos[-1, 0, 2])
    assert float(np.linalg.norm(pos[-1, 0, :2] - gpos[-1, 0, :2])) < 0.8


def _golden_hull_on_hull():
    """test_jolt_fidelity.py:255, its fixture and bounds."""
    gpos, _ = load_golden("hull_on_hull")
    w = make_world()
    lo = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(SLAB),
                                    pos=np.array([0, 0, 0.2], np.float32),
                                    motion_type=int(MotionType.DYNAMIC)))
    d0 = np.array([0.0, 0.0, -1.0])
    d1 = -np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    axis = np.cross(d1, d0)
    axis /= np.linalg.norm(axis)
    half = 0.5 * np.arccos(np.clip(d1 @ d0, -1, 1))
    q = np.array([*(axis * np.sin(half)), np.cos(half)], np.float32)
    hi = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA * 0.5),
                                    pos=np.array([0.1, 0.05, 1.3], np.float32), rot=q,
                                    motion_type=int(MotionType.DYNAMIC)))
    pos = run_engine(w, [lo, hi], len(gpos))
    assert abs(pos[-1, 0, 2] - gpos[-1, 0, 2]) < 0.03, (pos[-1, 0, 2], gpos[-1, 0, 2])
    assert abs(pos[-1, 1, 2] - gpos[-1, 1, 2]) < 0.08, (pos[-1, 1, 2], gpos[-1, 1, 2])
    assert pos[-1, 1, 2] > 0.55, "octahedron fell off / sank into the slab"
    assert np.linalg.norm(pos[-1, 1, :2] - gpos[-1, 1, :2]) < 0.25


@pytest.mark.parametrize("scene", ["hull_drop", "hull_on_hull"])
def test_golden_hull_scenes(scene):
    {"hull_drop": _golden_hull_drop, "hull_on_hull": _golden_hull_on_hull}[scene]()


def _settle(w, n=300):
    for _ in range(n):
        w.think(1 / 60)
    w.sync_transforms()


def _octahedron_rests_on_face():
    w = _hull_world()
    h = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA * 0.5),
                                   pos=np.array([0, 0, 1.0], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    w.set_linear_and_angular_vel(h, h.linvel, np.array([1.5, 0.5, 0.0], np.float32))
    _settle(w)
    assert not np.isnan(h.pos).any()
    assert 0.2 < h.pos[2] < 0.4, h.pos


def _hull_stack_two_high():
    w = _hull_world()
    lo = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA * 0.5),
                                    pos=np.array([0, 0, 0.4], np.float32),
                                    motion_type=int(MotionType.DYNAMIC)))
    hi = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA * 0.5),
                                    pos=np.array([0.0, 0.0, 1.1], np.float32),
                                    motion_type=int(MotionType.DYNAMIC)))
    _settle(w)
    assert not np.isnan(hi.pos).any()
    assert hi.pos[2] > 0.15
    if np.linalg.norm(hi.pos[:2] - lo.pos[:2]) < 0.3:
        assert hi.pos[2] > lo.pos[2] + 0.35


def _sphere_rests_on_hull():
    w = _hull_world()
    w.add_object(PhysicsObject(
        shape=shapes.make_convex_hull(np.array([[sx, sy, sz * 0.25] for sx in (-1, 1)
                                                for sy in (-1, 1) for sz in (-1, 1)],
                                               np.float32)),
        pos=np.array([0, 0, 0.25], np.float32), motion_type=int(MotionType.DYNAMIC)))
    ball = w.add_object(PhysicsObject(shape=shapes.make_sphere(0.2),
                                      pos=np.array([0, 0, 1.5], np.float32),
                                      motion_type=int(MotionType.DYNAMIC)))
    _settle(w)
    assert ball.pos[2] == pytest.approx(0.70, abs=0.06), ball.pos


def _ray_hits_true_hull_surface():
    w = _hull_world()
    w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA),
                               pos=np.array([0, 0, 2.0], np.float32),
                               motion_type=int(MotionType.STATIC)))
    hit, t, n, ob, mat = w.trace_ray([0.5, 0.0, 5.0], [0, 0, -1], 10.0)
    assert bool(hit)
    assert float(5.0 - t) == pytest.approx(2.5, abs=0.02)
    assert float(np.asarray(n)[2]) == pytest.approx(1 / np.sqrt(3), abs=0.05)
    hit2, t2, _, ob2, _ = w.trace_ray([0.9, 0.9, 5.0], [0, 0, -1], 10.0)
    assert (not bool(hit2)) or ob2 is None, (t2, ob2)


def _hull_box_interaction():
    w = _hull_world()
    box = w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]),
                                     pos=np.array([0, 0, 0.4], np.float32),
                                     motion_type=int(MotionType.DYNAMIC)))
    h = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA * 0.4),
                                   pos=np.array([0.05, 0, 1.6], np.float32),
                                   motion_type=int(MotionType.DYNAMIC)))
    _settle(w)
    assert not np.isnan(h.pos).any()
    if np.max(np.abs(h.pos[:2] - box.pos[:2])) < 0.4:
        assert h.pos[2] > box.pos[2] + 0.55, (h.pos, box.pos)
    else:
        assert h.pos[2] > 0.15


def _hull_mass_properties_match_box():
    he = np.array([0.5, 0.3, 0.2])
    corners = np.array([[sx * he[0], sy * he[1], sz * he[2]]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    h = shapes.make_convex_hull(corners + np.array([3.0, -2.0, 1.0]))
    b = shapes.make_box(he)
    assert h.volume == pytest.approx(b.volume, rel=1e-3)
    assert np.allclose(np.sort(1 / h.inv_inertia), np.sort(1 / b.inv_inertia), rtol=0.02)
    assert h.bound_radius == pytest.approx(float(np.linalg.norm(he)), abs=1e-3)
    assert len(h.hull_planes) == 6
    assert (h.hull_verts @ h.hull_planes[:, :3].T - h.hull_planes[None, :, 3]).max() < 1e-3


HULL_SCENARIOS = {"mass_properties_match_box": _hull_mass_properties_match_box,
                  "octahedron_rests_on_face": _octahedron_rests_on_face,
                  "stack_two_high": _hull_stack_two_high,
                  "sphere_rests_on_hull": _sphere_rests_on_hull,
                  "ray_hits_true_hull_surface": _ray_hits_true_hull_surface,
                  "hull_box_interaction": _hull_box_interaction}


@pytest.mark.parametrize("scenario", list(HULL_SCENARIOS))
def test_hull_scenarios_on_the_port(scenario):
    """tests/test_hull.py's six scenarios, its scenes and bounds, on the
    port's PhysicsWorld (the CPU path)."""
    HULL_SCENARIOS[scenario]()


def test_world_interns_hulls_by_content():
    """Objects instancing one model share one library slot; a different
    hull takes the next; the 65th distinct hull raises."""
    w = _hull_world()
    a = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(CUBE), motion_type=2))
    b = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(CUBE), motion_type=2))
    c = w.add_object(PhysicsObject(shape=shapes.make_convex_hull(OCTA), motion_type=2))
    assert a.shape.params[0] == b.shape.params[0] == 0 and c.shape.params[0] == 1
    w._flush()
    hl = w.static_world.hulls
    assert hl.n_verts[:3].tolist() == [8, 6, 0] and hl.n_faces[:2].tolist() == [6, 8]
    assert torch.equal(hl.verts[1, 6:], hl.verts[1, :1].expand(26, 3))   # padded with v[0]
    for i in range(62):
        w._intern_hull(shapes.make_convex_hull(CUBE * (1.0 + 0.01 * (i + 1))))
    with pytest.raises(RuntimeError, match="hull library full"):
        w._intern_hull(shapes.make_convex_hull(OCTA * 2.0))

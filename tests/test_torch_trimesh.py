"""substrata_tpu_torch's static trimesh against substrata_tpu: the host
grid build, the trimesh and hull branches of static contacts (the plain
twin of kernel KB), of the ray trace (KH) and of the character (KL), the
facade's mesh instances and virtual anchors, and a small mesh world of
tools/bench_networked.py's kind through the client's frame.

Tolerances:
- ``build_trimesh``: ``cell_tris``, ``origin`` and ``cell_w`` exactly (the
  same host numpy), including the mesh world's 137,856 triangles and the
  32,638 of them that fall in no cell (a reference caveat, kept).
- KB: masks, keys and ids exact; points, normals and depths within 1e-5 on
  the valid rows (float32 at unit scale; the two differ in summation order
  and multiply-add contraction).  The twin tests only eligible bodies'
  samples against the trimesh, as the kernel does: the other rows are
  invalid in both, and their values are not compared.
- KH: hit, body (a trimesh hit's owner) and material exact; t within
  1e-5; the normal within 1e-5, and within 1e-4 where a sphere or capsule
  body is hit: its normal is the hit point's offset over the radius, and
  on a grazing ray the quadratic's t carries the last-bit difference of
  the two implementations into it (measured 1.04e-5 on a 0.43 m sphere at
  t = 3.1).
- KL: 60 chained updates within 1e-4 m (test_torch_character.py's chain
  bound); on_ground, jumped and the touched list exact.

The small mesh world against the reference's facade is
tests/test_torch_mesh_world.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import narrowphase as jn
from substrata_tpu.physics import queries as jq
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import PhysicsObject, PhysicsWorld, benchworld, convert
from substrata_tpu_torch.physics import character as tchar
from substrata_tpu_torch.physics import narrowphase as tnp
from substrata_tpu_torch.physics import queries as tq
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics import state as tstate
from substrata_tpu_torch.physics.character import EYE_HEIGHT

from test_torch_hulls import CUBE, OCTA, _library
from torch_port_helpers import jax_body, params_np, static_world_np

torch.set_num_threads(2)

ATOL = 1e-5
DT = 1.0 / 60.0
_jstatic = jax.jit(jn.static_contacts, static_argnames=("config",))
_jtrace = jax.jit(jq.trace_rays, static_argnames=(
    "config", "n_steps", "collidable_only", "k_cand", "dedup", "body_steps"))


def _grid_mesh(n, extent, heights):
    """An (n+1)^2-vertex grid over [-extent, extent]^2 with heights
    ``heights`` [(n+1)^2], two triangles per quad."""
    xs = np.linspace(-extent, extent, n + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx.ravel(), gy.ravel(), heights], 1).astype(np.float32)
    i = np.arange(n)
    a = (i[:, None] * (n + 1) + i[None, :]).ravel()
    b, c, d = a + (n + 1), a + 1, a + n + 2
    tris = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)]).astype(np.int32)
    return verts, tris


def _terrain(seed):
    """A seeded bumpy terrain (12 x 12 quads over 24 m) plus a ridge (a
    triangular prism along y at x = 2), owners 1000 + quad row, random
    materials."""
    rng = np.random.default_rng(seed)
    v, t = _grid_mesh(12, 12.0, rng.uniform(0.0, 0.5, 13 * 13))
    ridge = np.array([[1.0, -6, 0.0], [3.0, -6, 0.0], [2.0, -6, 1.2],
                      [1.0, 6, 0.0], [3.0, 6, 0.0], [2.0, 6, 1.2]], np.float32)
    rt = np.array([[0, 3, 5], [0, 5, 2], [1, 2, 5], [1, 5, 4]], np.int32) + len(v)
    verts, tris = np.concatenate([v, ridge]), np.concatenate([t, rt])
    mats = rng.integers(0, 7, len(tris)).astype(np.int32)
    owners = (1000 + np.arange(len(tris)) // 24).astype(np.int32)
    return verts, tris, mats, owners


@pytest.mark.parametrize("case", ["terrain", "big_triangles", "overfull", "single"])
def test_build_trimesh_matches_reference(case):
    rng = np.random.default_rng(7)
    if case == "terrain":
        verts, tris, mats, owners = _terrain(1)
        kw = {}
    elif case == "big_triangles":                 # each spans many cells
        verts = rng.uniform(-20, 20, (60, 3)).astype(np.float32)
        tris = rng.integers(0, 60, (20, 3)).astype(np.int32)
        mats = owners = None
        kw = dict(grid_dim=16)
    elif case == "overfull":                      # cells past their cap drop
        verts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        tris = rng.integers(0, 300, (400, 3)).astype(np.int32)
        mats = owners = None
        kw = dict(grid_dim=4, cell_cap=8)
    else:
        verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        tris = np.array([[0, 1, 2]], np.int32)
        mats = owners = None
        kw = {}
    j = jstate.build_trimesh(verts, tris, mats, tri_owner=owners, **kw)
    t = tstate.build_trimesh(verts, tris, mats, tri_owner=owners, device="cpu", **kw)
    for f in ("verts", "tris", "tri_mats", "tri_owner", "cell_tris", "origin", "cell_w", "n_tris"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert t.count == len(tris)


def test_mesh_world_grid_matches_reference_and_drops():
    """The mesh world's merged static cubes: 137,856 triangles, 2,831 of
    the 4,096 cells full and 32,638 triangles in no cell, as the
    reference's build leaves them."""
    verts, tris = benchworld.mesh_triangles()
    assert len(tris) == 137_856
    cell_tris, origin, cell_w = tstate.trimesh_grid(verts, tris)
    j = jstate.build_trimesh(verts, tris)
    np.testing.assert_array_equal(cell_tris, np.asarray(j.cell_tris))
    np.testing.assert_array_equal(origin, np.asarray(j.origin))
    assert np.float32(cell_w) == np.asarray(j.cell_w)
    assert int((cell_tris >= 0).all(axis=2).sum()) == 2_831
    assert len(tris) - np.unique(cell_tris[cell_tris >= 0]).size == 32_638


def _hull_bodies(seed, capacity=96, n=80):
    """Hull, box, sphere and capsule bodies at random poses around the
    terrain's surface (z in [-0.2, 1.4]), most of them touching it; a few
    asleep, static or dead."""
    rng = np.random.default_rng(seed)
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(capacity)).items()}
    for i in range(n):
        st = int(rng.choice([3, 3, 3, 0, 1, 2]))
        prm = np.zeros(4, np.float32)
        if st == 3:
            h = int(rng.integers(0, 3))
            prm[:] = [h, 0.5, 0.5, 0.5]
        elif st == 0:
            prm[0] = rng.uniform(0.2, 0.5)
        elif st == 1:
            prm[:3] = rng.uniform(0.2, 0.5, 3)
        else:
            prm[:2] = rng.uniform(0.15, 0.35, 2)
        _, inv_mass, inv_inertia, vol, bound = jstate.compute_shape_mass_props(st, prm)
        q = rng.normal(size=4)
        a["pos"][i] = [rng.uniform(-11, 11), rng.uniform(-11, 11), rng.uniform(-0.2, 1.4)]
        a["quat"][i] = q / np.linalg.norm(q)
        a["inv_mass"][i] = inv_mass
        a["inv_inertia"][i] = inv_inertia
        a["motion_type"][i] = int(jstate.MotionType.DYNAMIC)
        a["layer"][i] = int(jstate.Layer.MOVING)
        a["shape_type"][i] = st
        a["shape_params"][i] = prm
        a["alive"][i] = True
        a["awake"][i] = i % 11 != 0
        a["friction"][i] = rng.uniform(0.2, 0.9)
        a["restitution"][i] = rng.uniform(0.0, 0.5)
        a["bound_radius"][i] = bound if st != 3 else 0.9
        a["volume"][i] = vol
    a["alive"][n - 1] = False
    a["motion_type"][n - 2] = int(jstate.MotionType.STATIC)
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def _static_worlds(seed, ground=True):
    verts, tris, mats, owners = _terrain(seed)
    jlib, _ = _library([CUBE, OCTA * 0.6, np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                                     [0, 0, 1]], np.float32) * 0.9])
    sw = jstate.default_static_world(0.05 if ground else -1e10).replace(
        trimesh=jstate.build_trimesh(verts, tris, mats, tri_owner=owners), hulls=jlib)
    return sw, convert.static_world_from_numpy(static_world_np(sw), device="cpu")


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("ground", [True, False], ids=["ground", "no_ground"])
def test_static_contacts_hulls_over_trimesh(ground, k):
    """KB's twin against the reference on a hull world over a seeded
    trimesh terrain plus a ridge, with and without the ground plane (the
    deeper-of rule against the heightfield)."""
    arrays = _hull_bodies(3)
    jsw, tsw = _static_worlds(5, ground)
    kw = dict(capacity=arrays["pos"].shape[0], static_contacts_per_body=k)
    jc = _jstatic(jax_body(arrays), jsw, jnp.zeros((64, 8, 3)), config=jstate.SimConfig(**kw))
    tc = tnp.static_contacts(convert.body_state_from_numpy(arrays, device="cpu"), tsw,
                             tstate.SimConfig(**kw))
    jv = np.asarray(jc.valid)
    for f in ("a", "b", "key", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    assert jv.sum() > 100
    for f in ("point", "normal", "penetration", "friction", "restitution"):
        np.testing.assert_allclose(getattr(tc, f).numpy()[jv], np.asarray(getattr(jc, f))[jv],
                                   atol=ATOL, rtol=0, err_msg=f)
    # The trimesh really decided some rows: normals off the vertical.
    assert (np.abs(np.asarray(jc.normal)[jv][:, 2]) < 0.99).sum() > 10


def test_hull_sample_points_match_reference():
    arrays = _hull_bodies(4)
    jsw, tsw = _static_worlds(5)
    jp, jr, jok = jn.shape_sample_points(jax_body(arrays), jsw.hulls)
    tp, tr, tok = tnp.shape_sample_points(convert.body_state_from_numpy(arrays, device="cpu"),
                                          (True, True, True, True), tsw.hulls)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


# (n_steps, body_steps, dedup): the facade's, the particles' and the wheels'.
RAY_CALLS = {"facade": (16, None, True), "particles": (4, 1, False), "wheels": (4, None, True)}


@pytest.mark.parametrize("call", list(RAY_CALLS))
def test_rays_among_hulls_and_trimesh(call):
    """KH's twin against the reference's trace_rays among hull, box,
    sphere and capsule bodies over the trimesh terrain."""
    arrays = _hull_bodies(6)
    jsw, tsw = _static_worlds(7)
    kw = dict(capacity=arrays["pos"].shape[0], max_pairs=256, grid_dim=16, cell_size=2.0)
    rng = np.random.default_rng(8)
    n = 512
    o = rng.uniform([-11, -11, 0.5], [11, 11, 3.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 0.7
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mt = rng.uniform(0.3, 12.0, n).astype(np.float32)
    n_steps, body_steps, dedup = RAY_CALLS[call]
    ckw = dict(n_steps=n_steps, body_steps=body_steps, dedup=dedup)
    jh = _jtrace(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt), jax_body(arrays), jsw,
                 jstate.SimConfig(**kw), **ckw)
    th = tq.trace_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mt),
                       convert.body_state_from_numpy(arrays, device="cpu"), tsw,
                       tstate.SimConfig(**kw), **ckw)
    for f in ("hit", "body", "material"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                      err_msg=f)
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), atol=ATOL, rtol=0)
    body = np.asarray(jh.body)
    curved = np.isin(body, np.nonzero((arrays["shape_type"] == 0)
                                      | (arrays["shape_type"] == 2))[0])
    dn = np.abs(th.normal.numpy() - np.asarray(jh.normal)).max(axis=1)
    assert dn[~curved].max() <= ATOL and dn[curved].max() <= 1e-4, dn.max()
    hull_hits = np.isin(body, np.nonzero(arrays["shape_type"] == 3)[0])
    assert (body >= 1000).sum() > 20 and hull_hits.sum() > 5       # both branches ran


def _tri_scene(name):
    """A trimesh step (a 0.3 m platform beyond x = 1 with its riser) or a
    20-degree ramp rising along x from x = 1, over the ground plane; both
    of 6 vertices and 4 triangles over the same xy box, so the reference
    compiles one program for both."""
    if name == "tri_step":
        verts = np.array([[1.0, -3, 0.3], [5, -3, 0.3], [5, 3, 0.3], [1.0, 3, 0.3],
                          [1.0, -3, 0.0], [1.0, 3, 0.0]], np.float32)
        tris = np.array([[0, 1, 2], [0, 2, 3], [4, 0, 3], [4, 3, 5]], np.int32)
    else:
        s = np.float32(np.tan(np.deg2rad(20.0)))
        verts = np.array([[1.0, -3, 0.0], [3, -3, 2 * s], [3, 3, 2 * s], [1.0, 3, 0.0],
                          [5, -3, 4 * s], [5, 3, 4 * s]], np.float32)
        tris = np.array([[0, 1, 2], [0, 2, 3], [1, 4, 5], [1, 5, 2]], np.int32)
    return verts, tris


@pytest.mark.parametrize("name", ["tri_step", "tri_ramp"])
def test_character_on_trimesh_chained(name):
    """KL's twin against the reference's character_update over 60 chained
    updates of a player walking at 3 m/s onto a trimesh step and up a
    trimesh ramp (its three trimesh rows carry the contacts)."""
    verts, tris = _tri_scene(name)
    sw = jstate.default_static_world(0.0).replace(
        trimesh=jstate.build_trimesh(verts, tris, tri_owner=np.full(len(tris), 7, np.int32)))
    tsw = convert.static_world_from_numpy(static_world_np(sw), device="cpu")
    cap = 16
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(cap)).items()}
    cfg = dict(capacity=cap, max_pairs=64, grid_dim=16, cell_size=1.4, cell_capacity=6)
    params = jstate.default_sim_params()
    jbody, body = jax_body(a), convert.body_state_from_numpy(a, device="cpu")
    tparams = convert.sim_params_from_numpy(params_np(params), device="cpu")
    eye = (0.0, 0.0, EYE_HEIGHT)
    jc = jchar.init_character_state(eye)
    tc = convert.character_from_numpy({f: np.asarray(getattr(jc, f))
                                       for f in tchar.CHARACTER_FIELDS}, device="cpu")
    move = np.array([3.0, 0.0, 0.0], np.float32)
    on_tri = 0
    for i in range(60):
        jc, jcam, jj, jt = jchar.character_update(jc, jbody, sw, jnp.asarray(move), False,
                                                  False, False, DT, params,
                                                  jstate.SimConfig(**cfg), -1)
        tc, tcam, tj, tt = tchar.character_update(tc, body, tsw, move, False, False, False, DT,
                                                  tparams, tstate.SimConfig(**cfg), -1)
        msg = f"{name}, update {i}"
        for f in ("pos", "vel", "ground_normal", "ground_vel", "campos_z_delta"):
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       atol=1e-4, err_msg=f"{msg}: {f}")
        for f in ("on_ground", "gravity_enabled", "fly_mode", "sitting"):
            assert bool(getattr(tc, f)) == bool(getattr(jc, f)), (msg, f)
        np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), atol=1e-4, err_msg=msg)
        assert bool(tj) == bool(jj), msg
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=msg)
        on_tri += float(jc.pos[2]) > 0.05
    assert on_tri > 10                     # the player got onto the triangles
    assert float(tc.pos[2]) > 0.25


def test_facade_mesh_instances_and_anchors():
    """A sphere and a hull cube (at its body pose: the COM and principal
    frame) dropped on a static mesh instance: the sphere rests on it, the
    cube never passes through it (the reference's trimesh rule kicks a
    box or hull resting on a coplanar trimesh back up, ROADMAP.md queue 3,
    so the cube is not asked to rest); trace_ray resolves the instance's
    triangles to its virtual anchor; removing the instance wakes both,
    which fall to the ground and rest there; removing the anchor frees its
    id."""
    w = PhysicsWorld(tstate.SimConfig(capacity=16, max_pairs=64, grid_dim=16, cell_size=2.0),
                     device="cpu")
    w.set_ground_plane(0.0)
    v, t = _grid_mesh(2, 3.0, np.full(9, 0.6, np.float32))
    anchor = w.add_virtual_anchor(PhysicsObject(shape=shapes.make_box([0.05] * 3),
                                                collidable=False))
    assert anchor.slot >= w.config.capacity
    inst = w.add_static_mesh_instance(v, t, np.full(len(t), 3, np.int32), owner_slot=anchor.slot)
    shape = shapes.make_convex_hull(CUBE * 0.6, mass=50.0)
    pos, rot = shape.body_pose_from_mesh([0.4, 0.2, 1.6], [0.0, 0.0, 0.0, 1.0])
    hull = w.add_object(PhysicsObject(shape=shape, pos=pos, rot=rot, motion_type=2))
    ball = w.add_object(PhysicsObject(shape=shapes.make_sphere(0.3, mass=50.0),
                                      pos=np.array([-1.5, -1.0, 1.6], np.float32),
                                      motion_type=2))
    lowest = np.inf
    for _ in range(90):
        w.think(DT)
        w.sync_transforms()
        lowest = min(lowest, float(hull.pos[2]))
    assert w.static_world.n_tris == len(t)
    assert lowest > 0.85, lowest
    assert ball.pos[2] == pytest.approx(0.9, abs=0.01), ball.pos
    hit, tt, n, ob, mat = w.trace_ray([2.0, 2.0, 5.0], [0, 0, -1], 10.0)
    assert hit and ob is anchor and mat == 3 and tt == pytest.approx(4.4, abs=1e-5)
    assert n[2] == pytest.approx(1.0)
    w.remove_static_mesh_instance(inst)
    for _ in range(150):
        w.think(DT)
    w.sync_transforms()
    assert w.static_world.n_tris == 0
    assert ball.pos[2] == pytest.approx(0.3, abs=0.01), ball.pos
    assert hull.pos[2] == pytest.approx(0.3, abs=0.03), hull.pos
    hit, tt, n, ob, mat = w.trace_ray([2.0, 2.0, 5.0], [0, 0, -1], 10.0)
    assert hit and ob is None and tt == pytest.approx(5.0, abs=1e-5)
    w.remove_object(anchor)
    assert anchor.slot == -1 and len(w.objects) == 2


def test_trimesh_sign_rule_kicks_like_the_reference():
    """The reference's trimesh contact takes the sign of the distance from
    each candidate triangle's plane, wherever its closest point lies
    (narrowphase.py:962-965): a box corner 1 mm below a flat two-triangle
    mesh is 'behind' the far triangle too, whose closest point is up to a
    diagonal away, and the deepest-first rule then reports that distance
    (clamped to 0.5 m) as the penetration; a box resting 1 cm above a
    closed static cube is behind the cube's downward bottom face, and gets
    a deep downward contact from it.  The port keeps the rule; both cases are held
    against the reference (ROADMAP.md queue 3)."""
    cap = 8
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(cap)).items()}
    for i, (pos, he) in enumerate((((0.0, 0.0, 0.899), 0.3), ((5.0, 0.0, 0.66), 0.25))):
        prm = np.array([he, he, he, 0], np.float32)
        _, im, ii, vol, br = jstate.compute_shape_mass_props(1, prm)
        a["pos"][i], a["shape_type"][i], a["shape_params"][i] = pos, 1, prm
        a["inv_mass"][i], a["inv_inertia"][i], a["volume"][i], a["bound_radius"][i] = im, ii, vol, br
        a["motion_type"][i], a["layer"][i] = 2, 1
        a["alive"][i] = a["awake"][i] = True
    v, t = _grid_mesh(1, 2.0, np.full(4, 0.6, np.float32))           # two triangles at 0.6
    cube = benchworld.CUBE_VERTS * 0.5 + np.array([5.0, 0.0, 0.15], np.float32)
    verts = np.concatenate([v, cube])
    tris = np.concatenate([t, benchworld.CUBE_TRIS + len(v)])
    sw = jstate.default_static_world(0.0).replace(trimesh=jstate.build_trimesh(verts, tris))
    tsw = convert.static_world_from_numpy(static_world_np(sw), device="cpu")
    kw = dict(capacity=cap, static_contacts_per_body=4)
    jc = _jstatic(jax_body(a), sw, jnp.zeros((64, 8, 3)), config=jstate.SimConfig(**kw))
    tc = tnp.static_contacts(convert.body_state_from_numpy(a, device="cpu"), tsw,
                             tstate.SimConfig(**kw))
    jv = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.numpy(), jv)
    for f in ("penetration", "normal"):
        np.testing.assert_allclose(getattr(tc, f).numpy()[jv], np.asarray(getattr(jc, f))[jv],
                                   atol=ATOL, rtol=0)
    pen, nz = tc.penetration.numpy().reshape(cap, 4), tc.normal.numpy()[:, 2].reshape(cap, 4)
    assert pen[0].max() > 0.3                    # 1 mm below, 0.42 m "deep"
    assert (pen[1] > 0.3).any() and (nz[1] < -0.99).any()   # pushed down into the cube

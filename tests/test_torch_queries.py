"""substrata_tpu_torch.physics.queries against the reference.

The same bodies and rays go through the reference's ``trace_rays`` and the
port's (kernel KH's plain twin on the CPU).  ``hit`` and ``body`` must be
equal; ``t`` and ``normal`` agree within 1e-5, and within 1e-4 on hits of
the heightfield's bisection march.  Where the two differ at all it is in
the last bits: XLA's CPU compiler contracts ``a * b + c`` into one rounding
(``o + d * t`` at every march point, the dot products), the port rounds
twice, and the ten bisection halvings carry that difference into ``t``.
The march fractions themselves are bit-equal to ``jnp.linspace``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.maths import quat as jquat
from substrata_tpu.physics import queries as jq
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics.world import PhysicsObject as JObject
from substrata_tpu.physics.world import PhysicsWorld as JWorld
from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld, convert
from substrata_tpu_torch.kernels import ray_trace as kray
from substrata_tpu_torch.maths import quat as tquat
from substrata_tpu_torch.physics import broadphase
from substrata_tpu_torch.physics import queries as tq
from substrata_tpu_torch.physics import shapes as tshapes
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import (box_config_kwargs, box_world_arrays, jax_body,
                                static_world_np)

torch.set_num_threads(2)

_jtrace = jax.jit(jq.trace_rays, static_argnames=(
    "config", "n_steps", "collidable_only", "k_cand", "dedup", "body_steps"))

# (n_steps, body_steps, dedup, with_exclude): the particles' rays
# (particles.py:96-98), the wheels' (vehicles/manager.py:631-632) and the
# facade's default.
CALLS = {"particles": (4, 1, False, False), "wheels": (4, None, True, True),
         "facade": (16, None, True, False)}


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _compare(jh, th, bisect=None):
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.body.numpy(), np.asarray(jh.body))
    np.testing.assert_array_equal(th.material.numpy(), np.asarray(jh.material))
    tol = np.where(bisect if bisect is not None else np.zeros_like(hit), 1e-4, 1e-5)
    np.testing.assert_array_less(np.abs(th.t.numpy() - np.asarray(jh.t)), tol + 1e-12)
    dn = np.abs(th.normal.numpy() - np.asarray(jh.normal)).max(axis=1)
    np.testing.assert_array_less(dn, tol + 1e-12)


def _both(jb, jsw, jcfg, tb, tsw, tcfg, o, d, mt, call, exclude=None):
    n_steps, body_steps, dedup, _ = CALLS[call]
    kw = dict(n_steps=n_steps, body_steps=body_steps, dedup=dedup)
    jex = None if exclude is None else jnp.asarray(exclude, jnp.int32)
    tex = None if exclude is None else torch.as_tensor(exclude, dtype=torch.int32)
    jh = _jtrace(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt), jb, jsw, jcfg,
                 exclude=jex, **kw)
    th = tq.trace_rays(_t(o), _t(d), _t(mt), tb, tsw, tcfg, exclude=tex, **kw)
    return jh, th


def test_march_fractions_equal_linspace():
    for n in (2, 3, 4, 7, 16, 33):
        np.testing.assert_array_equal(kray.march_fractions(n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_heightfield_sample_and_normal_match_reference():
    rng = np.random.default_rng(5)
    h = rng.uniform(-1.0, 1.0, (17, 13)).astype(np.float32)
    jhf = jstate.Heightfield(heights=jnp.asarray(h), origin=jnp.asarray([-8.0, -5.0]),
                             cell_w=jnp.float32(0.75))
    thf = tstate.Heightfield(heights=_t(h), origin=torch.tensor([-8.0, -5.0]),
                             cell_w=torch.tensor(0.75))
    xy = rng.uniform(-12.0, 12.0, (500, 2)).astype(np.float32)   # past the borders too
    np.testing.assert_allclose(thf.sample(_t(xy)).numpy(), np.asarray(jhf.sample(xy)),
                               atol=1e-6)
    np.testing.assert_allclose(thf.normal(_t(xy)).numpy(), np.asarray(jhf.normal(xy)),
                               atol=1e-6)


def test_axis_angle_round_trip_matches_reference():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    angle[:4] = 0.0
    jq_ = np.asarray(jquat.from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)))
    tq_ = tquat.from_axis_angle(_t(axis), _t(angle)).numpy()
    np.testing.assert_allclose(tq_, jq_, atol=1e-6)
    ja, jang = jquat.to_axis_angle(jnp.asarray(jq_))
    ta, tang = tquat.to_axis_angle(_t(jq_))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tang.numpy(), np.asarray(jang), atol=1e-5)


# --- The four scenes of tests/test_queries_prune.py, built through both
# facades, with their rays plus a fan of rays through each scene. ---------

def _prune_scene(name, pkg):
    world, obj, shp, cfg_cls = pkg
    w = world(cfg_cls(capacity=128, max_pairs=1024, grid_dim=32, cell_size=1.4),
              **({} if world is JWorld else {"device": "cpu"}))
    dyn = int(MotionType.STATIC)
    obs = []

    def add(shape, pos):
        obs.append(w.add_object(obj(shape=shape, pos=np.array(pos, np.float32),
                                    motion_type=dyn)))
    if name == "pierce_chain":
        for i in range(24):
            add(shp.make_sphere(0.3), [2.0 + i * 1.5, 0.0, 1.0])
        rays = [([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], 100.0)]
    elif name == "duplicates":
        for i in range(6):
            add(shp.make_sphere(0.05), [0.3 + 0.02 * i, 0.45, 1.0])
        add(shp.make_box([0.1, 0.1, 0.1]), [0.8, 0.0, 1.0])
        rays = [([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], 2.0)]
    elif name == "exclusion":
        add(shp.make_sphere(0.3), [2.0, 0.0, 1.0])
        add(shp.make_sphere(0.3), [5.0, 0.0, 1.0])
        rays = [([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], 100.0)]
    else:   # mixed shapes
        add(shp.make_box([0.2, 0.2, 0.2]), [1.0, 0.0, 1.0])
        add(shp.make_capsule(0.2, 0.3), [3.0, 0.0, 1.0])
        rays = [([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], 10.0),
                ([2.0, 0.0, 1.0], [1.0, 0.0, 0.0], 10.0)]
    w._flush()
    return w, obs, rays


def _fan(rays, seed, n=64):
    """The scene's rays plus ``n`` rays from near its first origin in
    directions around its first direction."""
    rng = np.random.default_rng(seed)
    o0, d0, mt0 = rays[0]
    o = np.asarray(o0, np.float32) + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = np.asarray(d0, np.float32) + rng.normal(0.0, 0.25, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mt = rng.uniform(0.5, 1.0, n).astype(np.float32) * mt0
    return (np.concatenate([np.array([r[0] for r in rays], np.float32), o]),
            np.concatenate([np.array([r[1] for r in rays], np.float32), d.astype(np.float32)]),
            np.concatenate([np.array([r[2] for r in rays], np.float32), mt]))


@pytest.mark.parametrize("scene", ["pierce_chain", "duplicates", "exclusion", "mixed"])
def test_prune_scenes_match_reference(scene):
    jw, jobs, rays = _prune_scene(scene, (JWorld, JObject, jshapes, jstate.SimConfig))
    tw, tobs, _ = _prune_scene(scene, (PhysicsWorld, PhysicsObject, tshapes,
                                       tstate.SimConfig))
    o, d, mt = _fan(rays, seed=len(scene))
    exclude = None
    if scene == "exclusion":
        exclude = np.full(len(o), jobs[0].slot, np.int32)
    for call in CALLS:
        jh, th = _both(jw.state, jw.static_world, jw.config, tw.state, tw.static_world,
                       tw.config, o, d, mt, call, exclude)
        _compare(jh, th)
    # The facade's single-ray query returns the reference's answer.
    for ray in rays:
        jr, tr = jw.trace_ray(*ray), tw.trace_ray(*ray)
        assert tr[0] == jr[0] and tr[4] == jr[4]
        assert abs(tr[1] - jr[1]) < 1e-5
        np.testing.assert_allclose(tr[2], jr[2], atol=1e-5)
        assert (tr[3] is None) == (jr[3] is None)
        if jr[3] is not None:
            assert tr[3].slot == jr[3].slot
        assert tw.does_ray_hit_anything(*ray) == jw.does_ray_hit_anything(*ray)


def _box_world(seed, flat):
    arrays = box_world_arrays(256, 200, seed, z0=0.39, dz=0.79, speed=0.5)
    rng = np.random.default_rng(seed + 10)
    # A few spheres and capsules among the boxes, one dead slot, one body
    # off the collidable layers.
    for i in rng.choice(200, 30, replace=False):
        if i % 2:
            arrays["shape_type"][i] = int(jstate.ShapeType.SPHERE)
            arrays["shape_params"][i] = [0.35, 0, 0, 0]
        else:
            arrays["shape_type"][i] = int(jstate.ShapeType.CAPSULE)
            arrays["shape_params"][i] = [0.25, 0.3, 0, 0]
            arrays["bound_radius"][i] = 0.55
    arrays["quat"][:200] = jquat_random(rng, 200)
    arrays["alive"][7] = False
    arrays["layer"][11] = int(jstate.Layer.MOVING_NON_COLLIDABLE)
    kw = box_config_kwargs(256)
    kw["present_shape_types"] = (True, True, True, False)
    if flat:
        sw = jstate.default_static_world(0.0)
    else:
        h = rng.uniform(-0.3, 0.6, (33, 33)).astype(np.float32)
        sw = jstate.default_static_world(0.0).replace(heightfield=jstate.Heightfield(
            heights=jnp.asarray(h), origin=jnp.asarray([-20.0, -20.0], jnp.float32),
            cell_w=jnp.float32(1.25)))
    return (jax_body(arrays), sw, jstate.SimConfig(**kw),
            convert.body_state_from_numpy(arrays, device="cpu"),
            convert.static_world_from_numpy(static_world_np(sw), device="cpu"),
            tstate.SimConfig(**kw))


def jquat_random(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _random_rays(seed, call, n=256):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-14, -14, -0.2], [14, 14, 3.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 0.5            # half of them downwards
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if call == "particles":
        mt = rng.uniform(0.01, 0.7, n)          # shorter than a cell
    elif call == "wheels":
        mt = rng.uniform(0.5, 1.2, n)
    else:
        mt = rng.uniform(1.0, 12.0, n)
    return o, d.astype(np.float32), mt.astype(np.float32)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "heightfield"])
@pytest.mark.parametrize("call", list(CALLS))
def test_random_rays_over_box_world(call, flat):
    jb, jsw, jcfg, tb, tsw, tcfg = _box_world(3, flat)
    o, d, mt = _random_rays(11, call)
    exclude = None
    if CALLS[call][3]:
        exclude = np.random.default_rng(4).integers(-1, 200, len(o)).astype(np.int32)
    jh, th = _both(jb, jsw, jcfg, tb, tsw, tcfg, o, d, mt, call, exclude)
    # Hits of the bisection march: the heightfield won and the world is not flat.
    bisect = None if flat else (np.asarray(jh.body) < 0)
    _compare(jh, th, bisect)
    hit = np.asarray(jh.hit)
    assert hit.sum() > 20 and (np.asarray(jh.body)[hit] >= 0).sum() > 5   # a real test


def test_trimesh_and_hulls_raise():
    """Rays against a static trimesh and hull bodies no longer raise: the
    facade's trace_ray resolves a trimesh hit to the owning virtual anchor
    with its material, a hull hit to its body, both as the reference's
    trace_ray does on the same world."""
    def build(world_cls, obj_cls, shp, **kw):
        w = world_cls(tstate.SimConfig(capacity=32, max_pairs=256, grid_dim=16)
                      if world_cls is PhysicsWorld else jstate.SimConfig(
                          capacity=32, max_pairs=256, grid_dim=16), **kw)
        w.set_ground_plane(0.0)
        anchor = w.add_virtual_anchor(obj_cls(shape=shp.make_box([0.05] * 3)))
        w.add_static_mesh_instance(np.array([[-2, -2, 0.5], [2, -2, 0.5], [2, 2, 0.5]],
                                            np.float32), np.array([[0, 1, 2]], np.int32),
                                   np.array([5], np.int32), owner_slot=anchor.slot)
        hull = w.add_object(obj_cls(shape=shp.make_convex_hull(
            np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32) * 0.5), pos=np.array([-1.0, 1.0, 2.0], np.float32),
            motion_type=0))
        return w, anchor, hull
    tw, tanchor, thull = build(PhysicsWorld, PhysicsObject, tshapes, device="cpu")
    jw, janchor, jhull = build(JWorld, JObject, jshapes)
    for o, want in (([1.5, -1.0, 5.0], "anchor"), ([-1.0, 1.0, 5.0], "hull"),
                    ([-1.5, 1.8, 5.0], None)):
        th, tt, tn, tob, tmat = tw.trace_ray(o, [0, 0, -1], 10.0)
        jh, jt, jn_, job, jmat = jw.trace_ray(o, [0, 0, -1], 10.0)
        assert th and jh and tmat == jmat
        assert tt == pytest.approx(jt, abs=1e-5)
        np.testing.assert_allclose(tn, np.asarray(jn_), atol=1e-5)
        assert tob is {"anchor": tanchor, "hull": thull, None: None}[want]
        assert job is {"anchor": janchor, "hull": jhull, None: None}[want]
    assert tmat == 0 and tw.trace_ray([1.5, -1.0, 5.0], [0, 0, -1], 10.0)[4] == 5


# --- kernels/hard_cases.py's ray scenes: more than k candidates tied at a
# zero key, a body met twice through a bucket-hash collision, rays whose
# every candidate row is empty, single-step marches, a trimesh of sparse
# cells.  Each (scene, call) pair is one compile of the reference. -------

HARD_RAY_PAIRS = [("tied_keys", "particles"), ("tied_keys", "facade"),
                  ("tied_keys", "single_step_no_dedup"), ("hash_collision", "wheels"),
                  ("hash_collision", "single_step"), ("empty_rows", "particles"),
                  ("sparse_trimesh", "facade")]


def _hard_ray_worlds(scene):
    jsw = jstate.default_static_world(0.0 if scene.ground_z is None else scene.ground_z)
    if scene.ground_z is None:
        jsw = jsw.replace(has_heightfield=jnp.asarray(False))
    if scene.trimesh is not None:
        verts, tris, mats, owners = scene.trimesh
        jsw = jsw.replace(trimesh=jstate.build_trimesh(verts, tris, mats, tri_owner=owners))
    return (jax_body(scene.bodies), jsw, jstate.SimConfig(**scene.config),
            convert.body_state_from_numpy(scene.bodies, device="cpu"),
            convert.static_world_from_numpy(static_world_np(jsw), device="cpu"),
            tstate.SimConfig(**scene.config))


@pytest.mark.parametrize("case,call", HARD_RAY_PAIRS)
def test_hard_ray_cases_match_reference(case, call):
    """The twin of KH against the jitted reference on the hard ray scenes:
    hit, body and material exact, t within 1e-5, the normal within 1e-5
    (1e-4 where a sphere is hit: test_torch_trimesh.py says why); and the
    scene is what it claims (ties past k, a repeated slot, empty rows)."""
    from substrata_tpu_torch.kernels import hard_cases
    scene = hard_cases.ray_scene(case, seed=0)
    jb, jsw, jcfg, tb, tsw, tcfg = _hard_ray_worlds(scene)
    n_steps, body_steps, dedup = hard_cases.RAY_CALLS[call]
    kw = dict(n_steps=n_steps, body_steps=body_steps, dedup=dedup)
    o, d, mt = scene.origins, scene.dirs, scene.max_ts
    jh = _jtrace(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt), jb, jsw, jcfg, **kw)
    th = tq.trace_rays(_t(o), _t(d), _t(mt), tb, tsw, tcfg, **kw)
    for f in ("hit", "body", "material"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                      err_msg=f)
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), atol=1e-5, rtol=0)
    body = np.asarray(jh.body)
    curved = np.isin(body, np.nonzero(scene.bodies["shape_type"] == 0)[0])
    dn = np.abs(th.normal.numpy() - np.asarray(jh.normal)).max(axis=1)
    assert dn[~curved].max(initial=0.0) <= 1e-5 and dn.max() <= 1e-4, dn.max()
    table = broadphase.build_cell_table(tb, tcfg)[0]
    _, cand, _, okk = kray.survivors(_t(o), _t(d), _t(mt), tb, table,
                                     tq.oversize_slots(tb, tcfg), tcfg.cell_size, tcfg.grid_dim,
                                     body_steps, torch.full((len(o),), -1, dtype=torch.int32),
                                     True, 16, dedup)
    if case == "tied_keys":
        assert int((okk.sum(1) == 16).sum()) > 100 and bool(np.asarray(jh.hit).all())
    elif case == "hash_collision":
        assert any(len(set(r[r >= 0].tolist())) < int((r >= 0).sum()) for r in cand)
    elif case == "empty_rows":
        assert bool((cand < 0).all())
    else:
        cells = tsw.trimesh.cell_tris
        assert int((cells >= 0).sum(2).max()) < 8 and int((body >= 40).sum()) > 20

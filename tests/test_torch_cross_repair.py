"""The port's cross and dot products against the JITTED reference on
``kernels/hard_cases.py``'s cross corpus (``CROSS_CORPUS``: near-parallel,
cancelling, tangent-basis-edge and random vectors), bit for bit.

XLA's CPU compiler contracts ``a1 b2 - a2 b1`` into ``fma(a1, b2, -(a2
b1))`` (``jnp.cross``), reduces ``jnp.sum(a * b, -1)``, ``jnp.linalg.norm``
and a 3-wide einsum as ``fma(a2, b2, fma(a1, b1, a0 b0))``, and leaves a
vector ``jnp.dot`` uncontracted.  The port rounds each site as its
reference does (``quat.cross_fma``, ``quat.dot3_fma``,
``transform.mat_vec_fma``; ``sbt::cross_fma``, ``dot3_fma``, ``mv_fma`` and
``tl.fma`` in the kernels).  One test per repaired program holds its twin
to the reference where the reference has a function of its own: the
solve's tangent basis (KQ, KC), the buoyancy and drag (KD), a hull's
sample ring (KB) and the ray-triangle test (KH).  Where the site sits
inside a larger jitted program, the port's function for it is held
against a jitted spelling of the reference's lines: KC's projection,
impulse directions and velocity update, KL's contact velocity
(``character.py:_capsule_probe``'s ``contact_one``) and KAB's up axis.
KJ's other sites are not isolated: they sit in ``manager.py``'s
``_vehicle_update_one``, whose steering, lean and wheel spin go through
``jnp.tan``, ``jnp.arctan2``, ``jnp.sin`` and ``jnp.cos``, and in
``_righting_torque_dv``, which goes through ``jnp.arctan2`` and
``quat.from_axis_angle``'s sin and cos; XLA rounds those unlike torch, so
the port's ``righting_torque_dv`` parts from the jitted reference on 1,102
to 1,634 of 3,072 values (1,024 corpus vectors of a kind) whatever its
crosses do.  ``test_torch_vehicles.py`` and
``test_torch_vehicles_incidence.py`` hold KJ within their bounds.  What
stays apart besides: XLA's ``rsqrt`` (the trimesh rows' face normal),
``exp`` and ``pow`` round unlike any correctly rounded form, and torch's
float32 ``sqrt`` on the CPU can be one ulp off (the combined friction).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.maths import quat as jquat
from substrata_tpu.physics import integrate as jint
from substrata_tpu.physics import queries as jq
from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import hard_cases, ray_trace, solve, solve_setup
from substrata_tpu_torch.kernels import character as kl
from substrata_tpu_torch.kernels import vehicle_setup as kab
from substrata_tpu_torch.kernels import static_contacts as kb
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath
from substrata_tpu_torch.physics import integrate as tint

from torch_port_helpers import box_world_arrays, jax_body, params_np

torch.set_num_threads(2)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _unit(x):
    return (x / np.linalg.norm(x.astype(np.float64), axis=-1, keepdims=True)).astype(np.float32)


def _corpus_quats(n=2048):
    """Unit quaternions from every corpus kind's vectors (axis a, angle
    from b's first component), near-identity turns among them."""
    qs = []
    for kind in hard_cases.CROSS_CORPUS:
        a, b = hard_cases.cross_corpus(kind, n=n)
        half = np.where(np.arange(n) % 2 == 0, b[:, 0] * 1e-3, b[:, 0])
        q = np.concatenate([_unit(a) * np.sin(half)[:, None], np.cos(half)[:, None]], 1)
        qs.append(_unit(q))
    return np.concatenate(qs)


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_contracted_forms_bit_equal_to_the_jitted_reference(kind):
    """Each form against the reference's own spelling of it, jitted; the
    plain forms part from the contracted ones on this corpus."""
    a, b = hard_cases.cross_corpus(kind)
    ta, tb = _t(a, b)
    m = np.stack([a, b, np.cross(a, b).astype(np.float32)], 1)
    want = {
        "cross": jax.jit(jnp.cross)(a, b),
        "sum": jax.jit(lambda x, y: jnp.sum(x * y, -1))(a, b),
        "norm": jax.jit(lambda x: jnp.linalg.norm(x, axis=-1))(a),
        "einsum": jax.jit(lambda x, y: jnp.einsum("nij,nj->ni", x, y))(m, b),
        "dot": jax.jit(jax.vmap(jnp.dot))(a, b)}
    got = {"cross": quatm.cross_fma(ta, tb), "sum": quatm.dot3_fma(ta, tb),
           "norm": fp.sqrt(quatm.dot3_fma(ta, ta)),
           "einsum": tmath.mat_vec_fma(torch.as_tensor(m), tb), "dot": quatm.dot3(ta, tb)}
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    plain = quatm.cross(ta, tb).numpy() != got["cross"].numpy()
    assert plain.any(axis=1).mean() > 0.1
    assert (quatm.dot3(ta, tb).numpy() != got["sum"].numpy()).mean() > 0.05


def test_solve_tangent_basis_bit_equal():
    """KQ's and KC's rows: ``solve_setup.tangent_basis`` against the
    reference's ``_tangent_basis`` on every corpus kind's unit vectors (the
    |n_x| = 0.9 switch and the axes included)."""
    n = np.concatenate([_unit(hard_cases.cross_corpus(k)[i]) for k in hard_cases.CROSS_CORPUS
                        for i in (0, 1)])
    jt1, jt2 = jax.jit(jsolver._tangent_basis)(n)
    t1, t2 = solve_setup.tangent_basis(torch.as_tensor(n))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jt1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))


def test_buoyancy_and_drag_bit_equal():
    """KD's twin against the jitted ``apply_forces``: 48 boxes straddling
    the water plane with corpus velocities, undamped (XLA's exp of a
    nonzero damping rounds unlike ``fp.exp``)."""
    jp = jstate.default_sim_params().replace(water_z=jnp.float32(0.5))
    for kind in hard_cases.CROSS_CORPUS:
        a, b = hard_cases.cross_corpus(kind, n=48)
        arr = box_world_arrays(64, 48, 0, speed=1.0)
        rng = np.random.default_rng(1)
        arr["pos"][:48, 2] = rng.uniform(-1.0, 2.0, 48)
        arr["quat"][:48] = _corpus_quats(16)[rng.integers(0, 64, 48)]
        arr["linvel"][:48] = a / np.float32(100.0)
        arr["angvel"][:48] = b / np.float32(100.0)
        arr["linear_damping"][:] = 0.0
        arr["angular_damping"][:] = 0.0
        arr["use_zero_linear_drag"][:48] = rng.random(48) < 0.3
        arr = {k: np.ascontiguousarray(v) for k, v in arr.items()}
        jlin, jang, jwet = jax.jit(jint.apply_forces)(jax_body(arr), jnp.float32(1 / 60), jp)
        tlin, tang, twet = tint.apply_forces(
            convert.body_state_from_numpy(arr, device="cpu"), 1 / 60,
            convert.sim_params_from_numpy(params_np(jp), device="cpu"))
        assert int(twet.sum()) > 5
        np.testing.assert_array_equal(tlin.numpy(), np.asarray(jlin), err_msg=kind)
        np.testing.assert_array_equal(tang.numpy(), np.asarray(jang), err_msg=kind)


def test_hull_sample_ring_bit_equal():
    """KB's hull rows: hulls tilted by corpus turns over a flat ground,
    ``static_contacts`` against the jitted reference, every field equal
    (the ring's frame, its u1 cos + u2 sin and the support scores
    contracted)."""
    quats = _corpus_quats(64)
    rng = np.random.default_rng(2)
    cloud = rng.normal(size=(24, 3)).astype(np.float32) * np.float32(0.4)
    rows = [dict(st=3, prm=[0.0], pos=(float(i % 16) * 2.5, float(i // 16) * 2.5, 0.3),
                 quat=tuple(quats[j])) for i, j in enumerate(rng.integers(0, len(quats), 96))]
    scene = hard_cases.StaticScene(bodies=hard_cases._static_bodies(rows, capacity=96),
                                   world=hard_cases._static_world(
                                       tri=hard_cases._tris_of(
                                           hard_cases._flat_tri(-90, -90, -89, -89, -5.0)),
                                       grid=((-90.0, -90.0), 1.0, 2, 2, 4), hulls=[cloud]),
                                   present=(False, False, False, True))
    import test_torch_static_contacts as tsc
    tc = kb.static_contacts(*hard_cases.static_inputs(scene, 4, "cpu"))
    cfg = jstate.SimConfig(capacity=96, static_contacts_per_body=4,
                           present_shape_types=scene.present)
    jc = tsc._jstatic(jax_body(scene.bodies), tsc._reference_world(scene.world),
                      jnp.zeros((96, 8, 3)), config=cfg)
    assert int(np.asarray(jc.valid).sum()) > 100
    for i, f in enumerate(("a", "b", "point", "normal", "penetration", "valid", "friction",
                           "restitution", "key")):
        if f == "friction":   # sqrt(f_a f_b): torch's CPU sqrt, within one ulp
            np.testing.assert_allclose(tc[i].numpy(), np.asarray(jc.friction), rtol=1.2e-7,
                                       atol=0, err_msg=f)
            continue
        np.testing.assert_array_equal(tc[i].numpy(), np.asarray(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_ray_triangle_bit_equal(kind):
    """KH's triangle test: slivers whose edges are the corpus's pairs,
    hit and missed, against the jitted ``queries._ray_triangle``."""
    a, b = hard_cases.cross_corpus(kind)
    rng = np.random.default_rng(3)
    v0 = rng.normal(size=a.shape).astype(np.float32)
    v1, v2 = v0 + _unit(a), v0 + _unit(b)
    aim = v0 + (v1 - v0) * np.float32(0.3) + (v2 - v0) * rng.uniform(0, 0.9, (len(a), 1))
    o = (aim + rng.normal(size=a.shape) * 3).astype(np.float32)
    d = _unit((aim - o).astype(np.float32))
    jt, jnrm = jax.jit(jax.vmap(jq._ray_triangle))(o, d, v0, v1, v2)
    t, nrm = ray_trace._ray_triangle(*_t(o, d, v0, v1, v2))
    assert (np.asarray(jt) < jq.BIG).sum() > 100
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(nrm.numpy(), np.asarray(jnrm))


def _solve_rows(kind, k=4):
    """[n, k] contact rows from the corpus: relative velocities, unit
    normals with two tangents, positive masses and targets, impulses."""
    a, b = hard_cases.cross_corpus(kind)
    c, d = hard_cases.cross_corpus(kind, seed=7)
    n = len(a) // k
    rng = np.random.default_rng(4)
    nrm = _unit(b)
    t1, t2 = (x.numpy() for x in solve_setup.tangent_basis(torch.as_tensor(nrm)))
    dirs = np.stack([nrm, t1, t2], 1).reshape(n, k, 3, 3)
    kk = rng.uniform(0.05, 20.0, (n, k, 3)).astype(np.float32)
    target = (c[:, 0] / np.float32(10)).reshape(n, k)
    fric = rng.uniform(0.0, 1.0, (n, k)).astype(np.float32)
    y = (d / np.float32(10)).reshape(n, k, 3)
    l0 = (c / np.float32(10)).reshape(n, k, 3)
    v = (a / np.float32(10)).reshape(n, k, 3)
    return v, dirs, kk, target, fric, y, l0


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_solve_projection_bit_equal(kind):
    """KC's projected FISTA update (``solve._project``) against the jitted
    reference's lines for one row class (solver.py:372-395): the three
    velocity dots contracted, l + beta (l - l0) as fma(beta, l - l0, l),
    at each beta the solve's schedule k / (k + 3) takes."""
    v, dirs, kk, target, fric, y, l0 = _solve_rows(kind)

    def reference(beta, v, n, t1, t2, target, kn, kt1, kt2, fric, ys, ls):
        vn = jnp.sum(v * n, -1)
        ln = jnp.maximum(ys[0] + (target - vn) / kn, 0.0)
        vt1 = jnp.sum(v * t1, -1)
        vt2 = jnp.sum(v * t2, -1)
        mf = fric * ln
        lt1 = jnp.clip(ys[1] - vt1 / kt1, -mf, mf)
        lt2 = jnp.clip(ys[2] - vt2 / kt2, -mf, mf)
        new_ls = (ln, lt1, lt2)
        return tuple(l + beta * (l - l0) for l, l0 in zip(new_ls, ls)), new_ls
    for it in range(6):
        beta = it / (it + 3.0)
        (jy, jl) = jax.jit(lambda *xs: reference(beta, *xs))(
            v, dirs[:, :, 0], dirs[:, :, 1], dirs[:, :, 2], target, kk[..., 0], kk[..., 1],
            kk[..., 2], fric, tuple(y[..., i] for i in range(3)),
            tuple(l0[..., i] for i in range(3)))
        ty, tl = solve._project(*_t(v, dirs, kk, target, fric, y, l0), beta)
        for i in range(3):
            np.testing.assert_array_equal(ty[..., i].numpy(), np.asarray(jy[i]), err_msg=f"y{i}")
            np.testing.assert_array_equal(tl[..., i].numpy(), np.asarray(jl[i]), err_msg=f"l{i}")


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_solve_direction_sums_bit_equal(kind):
    """KC's impulse directions (``solve._dir_sum``, d0 m0 + d1 m1 + d2 m2)
    against the jitted reference's spelling (solver.py:338-339), which
    XLA contracts in the order fma(d2, m2, fma(d0, m0, d1 m1))."""
    _, dirs, _, _, _, y, l0 = _solve_rows(kind)
    ds = y - l0
    want = jax.jit(lambda d0, d1, d2, n, t1, t2: d0[..., None] * n + d1[..., None] * t1
                   + d2[..., None] * t2)(ds[..., 0], ds[..., 1], ds[..., 2], dirs[:, :, 0],
                                         dirs[:, :, 1], dirs[:, :, 2])
    got = solve._dir_sum(*_t(ds, dirs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = sum(ds[..., i:i + 1] * dirs[:, :, i] for i in range(3))
    assert (plain != np.asarray(want)).mean() > 0.05


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_solve_velocity_update_bit_equal(kind):
    """KC's velocity update (``solve._velocity_update``, solver.py:359:
    linvel + im (out + dlin_s)).  XLA contracts it where LLVM's vectorised
    loop keeps each product beside its add: in every component when the
    vectors lie component-major, and, jitted alone on [N, 3] rows, in x
    and y only, since the loop's interleaving shuffle parts z's product
    from its add.  The whole solve contracts all three (the hard solve
    scenes: 1,348 values apart from the reference with every component
    contracted, 1,522 with z left plain, 1,691 with none), so the port
    contracts all three."""
    a, b = hard_cases.cross_corpus(kind)
    c, d = hard_cases.cross_corpus(kind, seed=7)
    lin, out, dl = a, b / np.float32(100), c / np.float32(100)
    im = np.abs(d[:, 0]).astype(np.float32)
    got = solve._velocity_update(*_t(lin, im, out + dl)).numpy()
    plain = lin + im[:, None] * (out + dl)
    rows = np.asarray(jax.jit(lambda l, m, o, s: l + m[:, None] * (o + s))(lin, im, out, dl))
    np.testing.assert_array_equal(rows[:, :2], got[:, :2])
    np.testing.assert_array_equal(rows[:, 2], plain[:, 2])
    cols = np.asarray(jax.jit(lambda l, m, o, s: l + m[None, :] * (o + s))(
        lin.T.copy(), im, out.T.copy(), dl.T.copy()))
    np.testing.assert_array_equal(cols.T, got)
    assert (plain != got).mean() > 0.02


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_character_contact_velocity_bit_equal(kind):
    """KL's contact velocity (``character.contact_velocity``) against the
    jitted reference's line (character.py:185, lv + jnp.cross(av, pt - p_b))
    under vmap, as ``contact_one`` runs it."""
    a, b = hard_cases.cross_corpus(kind)
    c, d = hard_cases.cross_corpus(kind, seed=5)
    lv, av = a / np.float32(10), b / np.float32(10)
    want = jax.jit(jax.vmap(lambda lv, av, pt, pb: lv + jnp.cross(av, pt - pb)))(lv, av, c, d)
    got = kl.contact_velocity(*_t(lv, av, c, d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", hard_cases.CROSS_CORPUS)
def test_vehicle_up_axis_bit_equal(kind):
    """KAB's (and KJ's) up axis in the body frame
    (``vehicle_setup.up_axis_os``) against the jitted reference's lines
    (manager.py:620-622) on corpus forward quaternions."""
    yq = _corpus_quats(1024)
    yq = yq[np.random.default_rng(hard_cases.CROSS_CORPUS.index(kind)).permutation(len(yq))[:1024]]
    want = jax.jit(lambda yq: jnp.cross(
        jquat.rotate_vec(jquat.conjugate(yq), jnp.array([1.0, 0.0, 0.0])),
        jquat.rotate_vec(jquat.conjugate(yq), jnp.array([0.0, 1.0, 0.0]))))(yq)
    got = kab.up_axis_os(torch.as_tensor(yq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

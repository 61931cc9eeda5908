"""substrata_tpu_torch narrowphase (the plain twins of kernels KA and KB)
against substrata_tpu.physics.narrowphase.

Tolerances: points, normals and penetrations within 1e-5 absolute (float32
at unit scale; the two differ only in summation order and multiply-add
contraction).  Masks, keys and body ids are equal, except for box pairs
whose decision quantities (axis choice, face choice, signs, point masks)
lie within 1e-5 of a threshold, where either branch is a correct rounding;
those must stay under 1% of the pairs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import narrowphase as jnp_phase
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch import convert
from substrata_tpu_torch.kernels import box_box as ka
from substrata_tpu_torch.physics import narrowphase as tnp_phase
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import jax_body, static_world_np

torch.set_num_threads(2)

ATOL = 1e-5
N_PAIRS = 512
# Jitted, as the reference runs them (eager dispatch is slow on the CPU).
_jbox_box = jax.jit(jax.vmap(jnp_phase._box_box))
_jpair_contacts = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))
_jstatic_contacts = jax.jit(jnp_phase.static_contacts, static_argnames=("config",))


def _quat(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _axis_quat(axis, angle, n):
    q = np.zeros((n, 4), np.float32)
    q[:, :3] = np.asarray(axis, np.float32) * np.sin(angle / 2)
    q[:, 3] = np.cos(angle / 2)
    return q


def box_pairs(seed):
    """(pa, qa, hea, pb, qb, heb) for 512 pairs: 128 each of aligned
    stacks, random rotations at touching range, crossed edges, separated."""
    rng = np.random.default_rng(seed)
    m = N_PAIRS // 4
    he = rng.uniform(0.2, 0.6, size=(2, N_PAIRS, 3)).astype(np.float32)
    pa = rng.uniform(-2, 2, size=(N_PAIRS, 3)).astype(np.float32)
    qa = np.tile(np.array([0, 0, 0, 1], np.float32), (N_PAIRS, 1))
    qb = qa.copy()
    pb = pa.copy()
    # aligned stacks: b above a, gap in [-5 cm, 5 cm], lateral offset
    s = slice(0, m)
    pb[s, 2] += he[0, s, 2] + he[1, s, 2] + rng.uniform(-0.05, 0.05, m)
    pb[s, :2] += rng.uniform(-0.4, 0.4, (m, 2))
    # random rotations at touching range
    s = slice(m, 2 * m)
    qa[s], qb[s] = _quat(rng, m), _quat(rng, m)
    d = rng.normal(size=(m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    reach = np.linalg.norm(he[0, s], axis=1) + np.linalg.norm(he[1, s], axis=1)
    pb[s] += (d * reach[:, None] * rng.uniform(0.45, 0.9, (m, 1))).astype(np.float32)
    # crossed edges: a turned 45 deg about x, b 45 deg about y, stacked
    s = slice(2 * m, 3 * m)
    qa[s] = _axis_quat([1, 0, 0], np.pi / 4 + rng.uniform(-0.05, 0.05), m)
    qb[s] = _axis_quat([0, 1, 0], np.pi / 4 + rng.uniform(-0.05, 0.05), m)
    pb[s, 2] += (np.sqrt(he[0, s, 1] ** 2 + he[0, s, 2] ** 2)
                 + np.sqrt(he[1, s, 0] ** 2 + he[1, s, 2] ** 2)
                 + rng.uniform(-0.06, 0.03, m))
    pb[s, :2] += rng.uniform(-0.05, 0.05, (m, 2))
    # separated
    s = slice(3 * m, 4 * m)
    qa[s], qb[s] = _quat(rng, m), _quat(rng, m)
    pb[s] += (d * (reach[:, None] + rng.uniform(0.1, 1.0, (m, 1)))).astype(np.float32)
    return pa, qa, he[0], pb.astype(np.float32), qb, he[1]


def _jax_box_box(args):
    return [np.asarray(x) for x in _jbox_box(*map(jnp.asarray, args))]


def _np_prune(pens, valid):
    near = np.any(valid & (pens > -0.01), axis=1)
    deepest = np.argmax(np.where(valid, pens, -1e9), axis=1)
    return valid & (near[:, None] | (np.arange(4)[None, :] == deepest[:, None]))


@pytest.mark.parametrize("seed", [0, 1])
def test_box_box_manifold_and_prune(seed):
    args = box_pairs(seed)
    jp, jpen, jn, jv = _jax_box_box(args)
    jv = _np_prune(jpen, jv)
    tp, tpen, tn, tv, gap = ka.box_box(*map(torch.tensor, args), with_gap=True)
    tv = ka.prune_speculative(tpen, tv)
    tp, tpen, tn, tv, gap = (x.numpy() for x in (tp, tpen, tn, tv, gap))
    near = gap < ATOL
    assert near.mean() < 0.01
    far = ~near
    np.testing.assert_array_equal(tv[far], jv[far])
    both = tv & jv & far[:, None]
    assert both.sum() > 400
    np.testing.assert_allclose(tp[both], jp[both], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpen[both], jpen[both], atol=ATOL, rtol=0)
    has = both.any(axis=1)
    np.testing.assert_allclose(tn[has], jn[has], atol=ATOL, rtol=0)


def _pair_body(seed):
    """1024 bodies = the 512 test pairs (2i, 2i+1) with random materials."""
    pa, qa, hea, pb, qb, heb = box_pairs(seed)
    rng = np.random.default_rng(seed + 100)
    n = 2 * N_PAIRS
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(n)).items()}
    a["pos"][0::2], a["pos"][1::2] = pa, pb
    a["quat"][0::2], a["quat"][1::2] = qa, qb
    a["shape_params"][0::2, :3], a["shape_params"][1::2, :3] = hea, heb
    a["shape_type"][:] = int(jstate.ShapeType.BOX)
    a["friction"][:] = rng.uniform(0, 1, n)
    a["restitution"][:] = rng.uniform(0, 1, n)
    a["is_sensor"][:] = rng.uniform(0, 1, n) < 0.05
    a["alive"][:] = a["awake"][:] = True
    a["motion_type"][:] = int(jstate.MotionType.DYNAMIC)
    a["layer"][:] = int(jstate.Layer.MOVING)
    p = N_PAIRS + 64                        # 64 empty slots at the end
    pair_a = np.full(p, -1, np.int32)
    pair_b = np.full(p, -1, np.int32)
    pair_a[:N_PAIRS] = np.arange(0, n, 2)
    pair_b[:N_PAIRS] = np.arange(1, n, 2)
    return a, pair_a, pair_b, pair_a >= 0


def test_pair_contacts_blocked_rows_equal():
    arrays, pa, pb, pv = _pair_body(2)
    kw = dict(capacity=2 * N_PAIRS, max_pairs=pa.shape[0],
              present_shape_types=(False, True, False, False))
    jc, jtouch, jov = _jpair_contacts(
        jax_body(arrays), jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(pv),
        config=jstate.SimConfig(**kw), blocked_wm=4)
    tc, ttouch, tov = tnp_phase.pair_contacts(
        convert.body_state_from_numpy(arrays, device="cpu"), torch.tensor(pa), torch.tensor(pb),
        torch.tensor(pv), tstate.SimConfig(**kw), blocked_wm=4)
    body = convert.body_state_from_numpy(arrays, device="cpu")
    a = torch.clamp(torch.tensor(pa), min=0).long()
    b = torch.clamp(torch.tensor(pb), min=0).long()
    gap = ka.box_box(body.pos[a], body.quat[a], body.shape_params[a, :3],
                     body.pos[b], body.quat[b], body.shape_params[b, :3],
                     with_gap=True)[4].numpy()
    far = np.repeat(gap >= ATOL, 4)
    for f in ("a", "b", "key", "restitution"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tc.friction.numpy(), np.asarray(jc.friction), atol=1e-6)
    jv = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.numpy()[far], jv[far])
    np.testing.assert_array_equal(ttouch.numpy()[gap >= ATOL], np.asarray(jtouch)[gap >= ATOL])
    both = far & jv
    for f in ("point", "normal", "penetration"):
        np.testing.assert_allclose(getattr(tc, f).numpy()[both],
                                   np.asarray(getattr(jc, f))[both], atol=ATOL, rtol=0)
    assert int(tov) == int(jov) == 0


def _ground_bodies(seed, n=320):
    """Boxes, spheres and capsules near the ground: random and exactly
    axis-aligned poses (exact depth ties between corners), some asleep."""
    rng = np.random.default_rng(seed)
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(n)).items()}
    st = rng.choice([0, 1, 2], size=n, p=[0.2, 0.6, 0.2]).astype(np.int32)
    a["shape_type"][:] = st
    a["shape_params"][:, :3] = rng.uniform(0.2, 0.6, (n, 3))
    a["pos"][:, :2] = rng.uniform(-30, 30, (n, 2))
    a["pos"][:, 2] = rng.uniform(-0.2, 1.0, n)
    a["quat"][:] = _quat(rng, n)
    aligned = rng.uniform(size=n) < 0.3
    a["quat"][aligned] = [0, 0, 0, 1]
    a["alive"][:] = True
    a["awake"][:] = rng.uniform(size=n) < 0.9
    a["motion_type"][:] = int(jstate.MotionType.DYNAMIC)
    a["layer"][:] = int(jstate.Layer.MOVING)
    a["friction"][:] = rng.uniform(0, 1, n)
    a["restitution"][:] = rng.uniform(0, 1, n)
    return a


def _heightfield_worlds(flat):
    if flat:
        jw = jstate.default_static_world(ground_z=0.1)
    else:
        rng = np.random.default_rng(9)
        h = (np.cumsum(np.cumsum(rng.normal(size=(33, 33)), 0), 1) * 0.02).astype(np.float32)
        jw = jstate.default_static_world().replace(heightfield=jstate.Heightfield(
            heights=jnp.asarray(h), origin=jnp.array([-40.0, -40.0], jnp.float32),
            cell_w=jnp.float32(2.5), is_flat=False))
    return jw, convert.static_world_from_numpy(static_world_np(jw), device="cpu")


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("flat", [True, False])
def test_static_contacts_equal(flat, k):
    arrays = _ground_bodies(3 if flat else 4)
    jw, tw = _heightfield_worlds(flat)
    kw = dict(capacity=arrays["pos"].shape[0], static_contacts_per_body=k,
              present_shape_types=(True, True, True, False))
    jc = _jstatic_contacts(jax_body(arrays), jw, jnp.zeros((64, 8, 3)),
                           config=jstate.SimConfig(**kw))
    tc = tnp_phase.static_contacts(convert.body_state_from_numpy(arrays, device="cpu"), tw,
                                   tstate.SimConfig(**kw))
    for f in ("a", "b", "key", "valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    assert tc.valid.sum() > 200
    for f in ("point", "normal", "penetration", "friction", "restitution"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   atol=ATOL, rtol=0, err_msg=f)


def test_shape_sample_points_equal():
    arrays = _ground_bodies(5)
    present = (True, True, True, False)
    jpts, jrad, jok = jnp_phase.shape_sample_points(jax_body(arrays), None, present)
    tpts, trad, tok = tnp_phase.shape_sample_points(convert.body_state_from_numpy(arrays, device="cpu"),
                                                    present)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(trad.numpy(), np.asarray(jrad))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))

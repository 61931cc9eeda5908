"""substrata_tpu_torch.maths against substrata_tpu.maths on seeded inputs.

Tolerance: atol 1e-6 on unit-scale inputs (unit quaternions, vectors and
extents in [-1, 1]) — both compute in float32 with the same formulas and
differ only in summation order and multiply-add contraction, a few ulps
(1.2e-7 each at 1.0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.maths import quat as jq
from substrata_tpu.maths import transform as jt
from substrata_tpu_torch.maths import quat as tq
from substrata_tpu_torch.maths import transform as tt

torch.set_num_threads(2)

ATOL = 1e-6
N = 257


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(N, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v = rng.uniform(-1.0, 1.0, size=(N, 3)).astype(np.float32)
    raw = (rng.normal(size=(N, 4)) * rng.uniform(0.1, 5.0, (N, 1))).astype(np.float32)
    d = rng.uniform(0.01, 1.0, size=(N, 3)).astype(np.float32)
    return q, q2, v, raw, d


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=ATOL, rtol=0)


CASES = {
    "mul": (lambda q, q2, v, raw, d: tq.mul(torch.tensor(q), torch.tensor(q2)),
            lambda q, q2, v, raw, d: jq.mul(jnp.asarray(q), jnp.asarray(q2))),
    "conjugate": (lambda q, q2, v, raw, d: tq.conjugate(torch.tensor(q)),
                  lambda q, q2, v, raw, d: jq.conjugate(jnp.asarray(q))),
    "normalize": (lambda q, q2, v, raw, d: tq.normalize(torch.tensor(raw)),
                  lambda q, q2, v, raw, d: jq.normalize(jnp.asarray(raw))),
    "rotate_vec": (lambda q, q2, v, raw, d: tq.rotate_vec(torch.tensor(q), torch.tensor(v)),
                   lambda q, q2, v, raw, d: jq.rotate_vec(jnp.asarray(q), jnp.asarray(v))),
    "inverse_rotate_vec": (
        lambda q, q2, v, raw, d: tq.inverse_rotate_vec(torch.tensor(q), torch.tensor(v)),
        lambda q, q2, v, raw, d: jq.inverse_rotate_vec(jnp.asarray(q), jnp.asarray(v))),
    "to_matrix": (lambda q, q2, v, raw, d: tq.to_matrix(torch.tensor(q)),
                  lambda q, q2, v, raw, d: jq.to_matrix(jnp.asarray(q))),
    "integrate": (lambda q, q2, v, raw, d: tq.integrate(torch.tensor(q), torch.tensor(v), 1 / 60),
                  lambda q, q2, v, raw, d: jq.integrate(jnp.asarray(q), jnp.asarray(v),
                                                        jnp.float32(1 / 60))),
    "world_inv_inertia": (
        lambda q, q2, v, raw, d: tt.world_inv_inertia(torch.tensor(q), torch.tensor(d)),
        lambda q, q2, v, raw, d: jt.world_inv_inertia(jnp.asarray(q), jnp.asarray(d))),
    "trs_matrix": (
        lambda q, q2, v, raw, d: tt.trs_matrix(torch.tensor(v), torch.tensor(q), torch.tensor(d)),
        lambda q, q2, v, raw, d: jt.trs_matrix(jnp.asarray(v), jnp.asarray(q), jnp.asarray(d))),
    "box_inertia": (lambda q, q2, v, raw, d: tt.box_inertia(torch.tensor(d), 1.3),
                    lambda q, q2, v, raw, d: jt.box_inertia(jnp.asarray(d), 1.3)),
    "sphere_inertia": (lambda q, q2, v, raw, d: tt.sphere_inertia(torch.tensor(d[:, 0]), 1.0),
                       lambda q, q2, v, raw, d: jt.sphere_inertia(jnp.asarray(d[:, 0]), 1.0)),
    "capsule_inertia": (
        lambda q, q2, v, raw, d: tt.capsule_inertia(torch.tensor(d[:, 0]), torch.tensor(d[:, 1]), 0.8),
        lambda q, q2, v, raw, d: jt.capsule_inertia(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), 0.8)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name, seed):
    inputs = _inputs(seed)
    t_fn, j_fn = CASES[name]
    _close(t_fn(*inputs), j_fn(*inputs))


def test_identity():
    _close(tq.identity((5,)), jq.identity((5,)))
    _close(tq.identity(), jq.identity())


def test_mat_vec_and_cross_are_written_out_in_order():
    """The kernels repeat these helpers operation for operation, so they
    must round exactly like the explicit expression."""
    q, _, v, _, d = _inputs(2)
    m = tt.world_inv_inertia(torch.tensor(q), torch.tensor(d))
    vt = torch.tensor(v)
    mv = tt.mat_vec(m, vt)
    ref = m[:, :, 0] * vt[:, None, 0] + m[:, :, 1] * vt[:, None, 1] + m[:, :, 2] * vt[:, None, 2]
    assert torch.equal(mv, ref)
    np.testing.assert_allclose(tq.cross(vt, vt.flip(0)).numpy(),
                               np.cross(v, v[::-1]), atol=1e-5)

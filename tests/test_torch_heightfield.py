"""The static heightfield of the port rounds as the jitted reference does.

``state.Heightfield.sample`` / ``sample_with_normal`` (the twins of KB, KH
and KL read them) repeat the reference's contractions: three fmas for the
bilinear height, one for each gradient, the normal's length as the norm's
fma chain, the cell width divided as a tensor; a radius sample's contact
point is fma(-n, r, p).  Heights and normals (at random points, on the
cell corners and one ulp past them) and one ``static_contacts`` pass, of
unrotated and of tilted bodies, are held bit-equal to the jitted reference
on a rough field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.physics import narrowphase as jnp_phase
from substrata_tpu.physics import state as jstate

from substrata_tpu_torch import convert
from substrata_tpu_torch.physics import narrowphase as tnp_phase
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import jax_body, static_world_np

_jsample = jax.jit(lambda hf, xy: hf.sample(xy))
_jsample_normal = jax.jit(lambda hf, xy: hf.sample_with_normal(xy))
_jstatic_contacts = jax.jit(jnp_phase.static_contacts, static_argnames=("config",))


def _rough(seed=9, shape=(33, 29), cell_w=2.5, origin=(-40.0, -37.0)):
    rng = np.random.default_rng(seed)
    h = (np.cumsum(np.cumsum(rng.normal(size=shape), 0), 1) * 0.02
         + rng.uniform(-0.3, 0.3, shape)).astype(np.float32)
    jhf = jstate.Heightfield(heights=jnp.asarray(h), origin=jnp.asarray(origin, jnp.float32),
                             cell_w=jnp.float32(cell_w), is_flat=False)
    thf = tstate.Heightfield(heights=torch.as_tensor(h),
                             origin=torch.tensor(origin, dtype=torch.float32),
                             cell_w=torch.tensor(cell_w, dtype=torch.float32))
    return jhf, thf


def _points(rng, n=4096):
    xy = rng.uniform(-45.0, 45.0, (n, 2)).astype(np.float32)      # past the borders too
    corners = (np.stack(np.meshgrid(np.arange(0, 30, 3), np.arange(0, 27, 3)), -1)
               .reshape(-1, 2) * 2.5 + np.array([-40.0, -37.0])).astype(np.float32)
    return np.concatenate([xy, corners, np.nextafter(corners, np.float32(1e9))])


@pytest.mark.parametrize("seed", [0, 1])
def test_heights_and_normals_bit_equal(seed):
    jhf, thf = _rough(seed=9 + seed)
    xy = _points(np.random.default_rng(seed))
    jh = np.asarray(_jsample(jhf, jnp.asarray(xy)))
    jh2, jn = (np.asarray(a) for a in _jsample_normal(jhf, jnp.asarray(xy)))
    th = thf.sample(torch.as_tensor(xy)).numpy()
    th2, tn = (a.numpy() for a in thf.sample_with_normal(torch.as_tensor(xy)))
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(th2, jh2)
    np.testing.assert_array_equal(tn, jn)


def _bodies(seed, n=256, rotated=False):
    """Spheres, boxes and capsules on the rough field, unrotated (the
    heightfield's rounding alone) or tilted at random (the rotation's
    contractions too)."""
    from torch_port_helpers import box_world_arrays
    rng = np.random.default_rng(seed)
    a = box_world_arrays(n, n, seed, z0=0.4, dz=0.0, speed=0.3)
    a["pos"][:, :2] = rng.uniform(-38.0, 36.0, (n, 2)).astype(np.float32)
    a["pos"][:, 2] = rng.uniform(-0.5, 0.8, n).astype(np.float32)
    a["quat"] = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    if rotated:
        q = rng.normal(size=(n, 4))
        a["quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    a["shape_type"] = (np.arange(n) % 3).astype(np.int32)
    prm = np.zeros((n, 4), np.float32)
    prm[:, 0] = rng.uniform(0.2, 0.5, n)
    prm[:, 1] = rng.uniform(0.2, 0.5, n)
    prm[:, 2] = rng.uniform(0.2, 0.5, n)
    a["shape_params"] = prm
    a["bound_radius"] = np.linalg.norm(prm[:, :3], axis=1).astype(np.float32) + prm[:, 0]
    return a


def _static_contacts_bit_equal(k, arrays):
    jhf, _ = _rough()
    jw = jstate.default_static_world().replace(heightfield=jhf)
    tw = convert.static_world_from_numpy(static_world_np(jw), device="cpu")
    kw = dict(capacity=arrays["pos"].shape[0], static_contacts_per_body=k,
              present_shape_types=(True, True, True, False))
    jc = _jstatic_contacts(jax_body(arrays), jw, jnp.zeros((64, 8, 3)),
                           config=jstate.SimConfig(**kw))
    tc = tnp_phase.static_contacts(convert.body_state_from_numpy(arrays, device="cpu"), tw,
                                   tstate.SimConfig(**kw))
    assert int(tc.valid.sum()) > 100
    for f in ("a", "b", "key", "valid", "point", "normal", "penetration", "friction",
              "restitution"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)


@pytest.mark.parametrize("k", [4, 8])
def test_static_contacts_of_tilted_bodies_bit_equal(k):
    """Tilted spheres, boxes and capsules: their sample points rotate as
    the jitted reference rotates them (maths/quat.py:rotate_vec), so the
    whole pass is bit-equal too."""
    _static_contacts_bit_equal(k, _bodies(11 + k, rotated=True))


@pytest.mark.parametrize("k", [4, 8])
def test_static_contacts_on_a_rough_field_bit_equal(k):
    jhf, _ = _rough()
    jw = jstate.default_static_world().replace(heightfield=jhf)
    tw = convert.static_world_from_numpy(static_world_np(jw), device="cpu")
    arrays = _bodies(3 + k)
    kw = dict(capacity=arrays["pos"].shape[0], static_contacts_per_body=k,
              present_shape_types=(True, True, True, False))
    jc = _jstatic_contacts(jax_body(arrays), jw, jnp.zeros((64, 8, 3)),
                           config=jstate.SimConfig(**kw))
    tc = tnp_phase.static_contacts(convert.body_state_from_numpy(arrays, device="cpu"), tw,
                                   tstate.SimConfig(**kw))
    assert int(tc.valid.sum()) > 100
    for f in ("a", "b", "key", "valid", "point", "normal", "penetration", "friction",
              "restitution"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)

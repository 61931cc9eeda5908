"""Shared inputs for the tests that hold substrata_tpu_torch against
substrata_tpu: seeded numpy states handed to both packages."""

from __future__ import annotations

import numpy as np

from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.physics import state as tstate

FIELDS = tstate.BODY_FIELDS


def box_world_arrays(capacity: int, n_boxes: int, seed: int, layers: int = 3,
                     spacing: float = 1.7, half: float = 0.4, jitter: float = 0.15,
                     speed: float = 0.0, z0: float = 0.6, dz: float = 1.2):
    """Numpy BodyState fields of the bench world's shape, cut down: n_boxes
    dynamic boxes in ``layers`` layers of a square lattice, small random
    xy jitter, optional random velocities.  Slots past n_boxes are dead."""
    rng = np.random.default_rng(seed)
    a = {k: np.asarray(v) for k, v in vars(jstate.zero_body_state(capacity)).items()}
    a = {k: np.array(v) for k, v in a.items()}
    side = int(np.ceil((n_boxes / layers) ** 0.5))
    _, inv_mass, inv_inertia, vol, bound = jstate.compute_shape_mass_props(
        jstate.ShapeType.BOX, np.array([half, half, half, 0], np.float32))
    n = 0
    for iz in range(layers):
        for ix in range(side):
            for iy in range(side):
                if n >= n_boxes:
                    break
                a["pos"][n] = [(ix - side / 2) * spacing + rng.uniform(-jitter, jitter),
                               (iy - side / 2) * spacing + rng.uniform(-jitter, jitter),
                               z0 + iz * dz]
                n += 1
    sl = slice(0, n_boxes)
    a["inv_mass"][sl] = inv_mass
    a["inv_inertia"][sl] = inv_inertia
    a["motion_type"][sl] = int(jstate.MotionType.DYNAMIC)
    a["layer"][sl] = int(jstate.Layer.MOVING)
    a["shape_type"][sl] = int(jstate.ShapeType.BOX)
    a["shape_params"][sl] = [half, half, half, 0]
    a["alive"][sl] = True
    a["awake"][sl] = True
    a["bound_radius"][sl] = bound
    a["volume"][sl] = vol
    if speed:
        a["linvel"][sl] = rng.uniform(-speed, speed, (n_boxes, 3)).astype(np.float32)
        a["angvel"][sl] = rng.uniform(-speed, speed, (n_boxes, 3)).astype(np.float32)
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def mixed_world_arrays(capacity: int, n_bodies: int, seed: int, types=(0, 1, 2),
                       spacing: float = 0.85):
    """Numpy BodyState fields of a pile of spheres, boxes and capsules:
    ``n_bodies`` dynamic bodies of random type (from ``types``), size and
    orientation on a jittered 4 x 4 lattice of layers, close enough that
    neighbours touch.  Slots past n_bodies are dead."""
    rng = np.random.default_rng(seed)
    a = {k: np.array(np.asarray(v)) for k, v in vars(jstate.zero_body_state(capacity)).items()}
    for i in range(n_bodies):
        st = int(types[rng.integers(len(types))])
        prm = np.zeros(4, np.float32)
        if st == 0:
            prm[0] = rng.uniform(0.3, 0.45)
        elif st == 1:
            prm[:3] = rng.uniform(0.25, 0.4, 3)
        else:
            prm[0], prm[1] = rng.uniform(0.2, 0.3), rng.uniform(0.15, 0.3)
        _, inv_mass, inv_inertia, vol, bound = jstate.compute_shape_mass_props(st, prm)
        q = rng.normal(size=4)
        a["pos"][i] = [(i % 4 - 1.5) * spacing + rng.uniform(-0.1, 0.1),
                       (i // 4 % 4 - 1.5) * spacing + rng.uniform(-0.1, 0.1),
                       0.5 + (i // 16) * spacing + rng.uniform(-0.1, 0.1)]
        a["quat"][i] = q / np.linalg.norm(q)
        a["linvel"][i] = rng.uniform(-0.5, 0.5, 3)
        a["inv_mass"][i] = inv_mass
        a["inv_inertia"][i] = inv_inertia
        a["motion_type"][i] = int(jstate.MotionType.DYNAMIC)
        a["layer"][i] = int(jstate.Layer.MOVING)
        a["shape_type"][i] = st
        a["shape_params"][i] = prm
        a["alive"][i] = True
        a["awake"][i] = True
        a["friction"][i] = rng.uniform(0.3, 0.8)
        a["restitution"][i] = rng.uniform(0.0, 0.4)
        a["bound_radius"][i] = bound
        a["volume"][i] = vol
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def jax_body(arrays):
    import jax.numpy as jnp
    return jstate.BodyState(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def body_np(state):
    """Any BodyState (either package) -> {field: numpy array}."""
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def static_world_np(sw):
    """The reference StaticWorld -> the converter's arrays (heightfield,
    water, the trimesh and the hull library)."""
    hf = sw.heightfield
    tm, hl = sw.trimesh, sw.hulls
    return {"heights": np.asarray(hf.heights), "origin": np.asarray(hf.origin),
            "cell_w": np.asarray(hf.cell_w), "is_flat": hf.is_flat,
            "has_heightfield": np.asarray(sw.has_heightfield),
            "water_z": np.asarray(sw.water_z),
            "trimesh": {f: np.asarray(getattr(tm, f)) for f in (
                "verts", "tris", "tri_mats", "tri_owner", "cell_tris", "origin", "cell_w",
                "n_tris")},
            "hulls": {f: np.asarray(getattr(hl, f)) for f in (
                "verts", "n_verts", "planes", "n_faces")}}


def params_np(p):
    return {f: np.asarray(getattr(p, f)) for f in tstate.SIM_PARAM_FIELDS}


def box_config_kwargs(capacity=256):
    """A box-only SimConfig of the bench's kind, cut to ``capacity``."""
    return dict(capacity=capacity, max_pairs=4 * capacity, grid_dim=32,
                cell_size=1.4, cell_capacity=6, solver_iters=7,
                pairs_per_body=10, pair_rebuild_interval=6,
                contacts_per_body=8,
                present_shape_types=(False, True, False, False))

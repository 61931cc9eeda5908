"""Host-side shape factories (numpy only).

Counterpart of ``substrata_tpu/physics/shapes.py`` for the primitive
shapes.  Convex hulls arrive with the other shapes in a later slice (see
ROADMAP.md, "Slice 3"); until then ``make_convex_hull`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from substrata_tpu_torch.physics.state import ShapeType, compute_shape_mass_props


@dataclass
class PhysicsShape:
    """Shape type + params + cached mass properties."""

    shape_type: int
    params: np.ndarray          # [4] f32 (see state.ShapeType)
    mass: float
    inv_mass: float
    inv_inertia: np.ndarray     # [3] diagonal local
    volume: float
    bound_radius: float
    hull_verts: np.ndarray | None = None
    principal_rot: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    com_offset: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))


def make_sphere(radius: float, density: float = 1000.0, mass: float = 0.0) -> PhysicsShape:
    params = np.array([radius, 0, 0, 0], np.float32)
    m, im, ii, vol, br = compute_shape_mass_props(ShapeType.SPHERE, params, density, mass)
    return PhysicsShape(int(ShapeType.SPHERE), params, m, im, ii, vol, br)


def make_box(half_extents, density: float = 1000.0, mass: float = 0.0) -> PhysicsShape:
    he = np.asarray(half_extents, np.float32)
    params = np.array([he[0], he[1], he[2], 0], np.float32)
    m, im, ii, vol, br = compute_shape_mass_props(ShapeType.BOX, params, density, mass)
    return PhysicsShape(int(ShapeType.BOX), params, m, im, ii, vol, br)


def make_capsule(radius: float, half_height: float, density: float = 1000.0,
                 mass: float = 0.0) -> PhysicsShape:
    params = np.array([radius, half_height, 0, 0], np.float32)
    m, im, ii, vol, br = compute_shape_mass_props(ShapeType.CAPSULE, params, density, mass)
    return PhysicsShape(int(ShapeType.CAPSULE), params, m, im, ii, vol, br)


def make_convex_hull(vertices, density: float = 1000.0, mass: float = 0.0,
                     max_verts: int = 32) -> PhysicsShape:
    raise NotImplementedError(
        "convex hulls are not ported yet (ROADMAP.md queue 1, slice 3: "
        "the other shapes)")


def scaled(shape: PhysicsShape, scale) -> PhysicsShape:
    """Bake a scale into the shape.  Non-uniform scale on spheres/capsules
    uses the max component."""
    s = np.asarray(scale, np.float32) * np.ones(3, np.float32)
    if np.allclose(s, 1.0):
        return shape
    st = shape.shape_type
    if st == int(ShapeType.SPHERE):
        return make_sphere(float(shape.params[0] * np.max(np.abs(s))),
                           mass=shape.mass)
    if st == int(ShapeType.BOX):
        return make_box(shape.params[:3] * np.abs(s), mass=shape.mass)
    if st == int(ShapeType.CAPSULE):
        sr = float(np.max(np.abs(s[:2])))
        return make_capsule(float(shape.params[0] * sr), float(shape.params[1] * abs(s[2])),
                            mass=shape.mass)
    return make_convex_hull(shape.hull_verts * s, mass=shape.mass)

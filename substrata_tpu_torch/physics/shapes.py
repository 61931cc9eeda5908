"""Host-side shape factories (numpy and scipy only).

Counterpart of ``substrata_tpu/physics/shapes.py``: spheres, boxes,
capsules and exact convex hulls (scipy qhull with ``"QJ"``, as the
reference calls it): reduced to <= 32 extreme vertices, recentred on the
solid COM and rotated into principal axes, with their face planes (coplanar
triangles merged, at most 32) for the narrowphase SAT and the ray clip.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from substrata_tpu_torch.physics.state import ShapeType, compute_shape_mass_props


# Host (x, y, z, w) quaternion helpers for the per-object pose paths.
def _np_quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], np.float32)


def _np_quat_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float32)


def _np_quat_rotate(q, v):
    u, w = q[:3], q[3]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return np.asarray(v, np.float32) + 2.0 * (w * uv + uuv)


def _np_quat_from_matrix(m):
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    qw = np.sqrt(max(0.0, 1.0 + tr)) * 0.5
    qx = np.sqrt(max(0.0, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) * 0.5
    qy = np.sqrt(max(0.0, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) * 0.5
    qz = np.sqrt(max(0.0, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) * 0.5
    qx = np.copysign(qx, m[2, 1] - m[1, 2])
    qy = np.copysign(qy, m[0, 2] - m[2, 0])
    qz = np.copysign(qz, m[1, 0] - m[0, 1])
    q = np.array([qx, qy, qz, qw], np.float64)
    return (q / max(np.linalg.norm(q), 1e-12)).astype(np.float32)


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
    # Hull only (interned into the world's hull library on add):
    hull_verts: np.ndarray | None = None          # [V, 3] principal frame
    hull_contact_verts: np.ndarray | None = None  # [8, 3]
    hull_planes: np.ndarray | None = None         # [F, 4] unit outward (n, d)
    # Mesh frame -> principal frame, and the mesh-frame COM: a body's pose
    # is the principal frame at the COM.
    principal_rot: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    com_offset: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))

    def pose_is_identity(self) -> bool:
        """True when the body pose is the mesh pose (no COM offset, the
        principal frame is the mesh frame); cached."""
        v = getattr(self, "_pose_ident", None)
        if v is None:
            v = bool(np.all(self.com_offset == 0.0)
                     and np.allclose(self.principal_rot, np.eye(3)))
            object.__setattr__(self, "_pose_ident", v)
        return v

    def _principal_quat(self) -> np.ndarray:
        q = getattr(self, "_q_principal", None)
        if q is None:
            q = _np_quat_from_matrix(self.principal_rot)
            object.__setattr__(self, "_q_principal", q)
        return q

    def body_pose_from_mesh(self, pos, quat):
        """An authored mesh-frame pose -> the body (COM, principal) pose."""
        pos = np.asarray(pos, np.float32)
        quat = np.asarray(quat, np.float32)
        body_q = _np_quat_mul(quat, self._principal_quat())
        body_p = pos + _np_quat_rotate(quat, self.com_offset)
        return body_p.astype(np.float32), body_q.astype(np.float32)

    def mesh_pose_from_body(self, pos, quat):
        """The inverse of ``body_pose_from_mesh``."""
        pos = np.asarray(pos, np.float32)
        quat = np.asarray(quat, np.float32)
        mesh_q = _np_quat_mul(quat, _np_quat_conj(self._principal_quat()))
        mesh_p = pos - _np_quat_rotate(mesh_q, self.com_offset)
        return mesh_p.astype(np.float32), mesh_q.astype(np.float32)

    def size_bytes(self) -> int:
        n = 16 + 12 + 4 * 7
        if self.hull_verts is not None:
            n += self.hull_verts.nbytes + self.hull_contact_verts.nbytes
        return n


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


def _reduce_hull_verts(verts: np.ndarray, max_verts: int) -> np.ndarray:
    """At most ``max_verts`` extreme vertices: the support points of 4 x
    max_verts Fibonacci-sphere directions, first occurrences in order."""
    if len(verts) <= max_verts:
        return verts
    k = max_verts * 4
    i = np.arange(k) + 0.5
    phi = np.arccos(1 - 2 * i / k)
    theta = np.pi * (1 + 5 ** 0.5) * i
    dirs = np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1)
    support = np.argmax(verts @ dirs.T, axis=0)
    uniq = list(dict.fromkeys(support.tolist()))
    return verts[np.array(uniq[:max_verts])]


def _hull_mass_properties(verts: np.ndarray, simplices: np.ndarray):
    """Solid volume, COM and covariance about the COM (∫ x xᵀ dV) of a
    convex hull by tetrahedra from an interior point (|det|: qhull's
    simplices are not consistently oriented)."""
    p = verts.mean(axis=0)
    a = verts[simplices[:, 0]] - p
    b = verts[simplices[:, 1]] - p
    c = verts[simplices[:, 2]] - p
    det = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c)))
    vol = det.sum() / 6.0
    com_l = (det[:, None] * (a + b + c)).sum(axis=0) / 24.0 / max(vol, 1e-12)
    s = a + b + c
    cov = (np.einsum("i,ij,ik->jk", det, a, a)
           + np.einsum("i,ij,ik->jk", det, b, b)
           + np.einsum("i,ij,ik->jk", det, c, c)
           + np.einsum("i,ij,ik->jk", det, s, s)) / 120.0
    cov_com = cov - vol * np.outer(com_l, com_l)
    return float(vol), p + com_l, cov_com


def _hull_face_planes(verts: np.ndarray, max_faces: int = 32) -> np.ndarray:
    """Unit outward face planes (n, d: n·x <= d) of the hull of ``verts``,
    coplanar triangles merged by a 1e-4 quantised key; past ``max_faces``
    a greedy farthest-normal choice keeps ``max_faces`` of them."""
    from scipy.spatial import ConvexHull
    hull = ConvexHull(verts, qhull_options="QJ")
    eqs = hull.equations
    planes = np.column_stack([eqs[:, :3], -eqs[:, 3]])
    key = np.round(planes / 1e-4).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    planes = planes[np.sort(idx)]
    if len(planes) > max_faces:
        keep = [0]
        normals = planes[:, :3]
        d = np.full(len(planes), np.inf)
        for _ in range(max_faces - 1):
            d = np.minimum(d, 1.0 - normals @ normals[keep[-1]])
            nxt = int(np.argmax(d))
            keep.append(nxt)
            d[nxt] = -np.inf
        planes = planes[np.array(sorted(set(keep)))]
    return planes.astype(np.float32)


def make_convex_hull(vertices, density: float = 1000.0, mass: float = 0.0,
                     max_verts: int = 32) -> PhysicsShape:
    """Convex hull of a vertex cloud: exact hull, solid mass properties,
    principal frame at the COM, face planes, and 8 contact vertices (the
    extremes along the 8 corner directions).  A degenerate (planar or tiny)
    cloud keeps its points, with a box-estimate volume."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    try:
        from scipy.spatial import ConvexHull
        hull = ConvexHull(v, qhull_options="QJ")
        hv = v[hull.vertices]
        vol0, com, cov_com = _hull_mass_properties(v, hull.simplices.astype(np.int64))
        vol = max(vol0, 1e-9)
    except Exception:
        hv = v
        com = v.mean(axis=0)
        vol = max(float(np.ptp(v, axis=0).prod()) * 0.5, 1e-6)
        cov_com = np.einsum("ij,ik->jk", v - com, v - com) / max(len(v), 1) * vol

    m = mass if mass > 0 else density * vol
    cov_m = cov_com * (m / vol)
    inertia_t = np.trace(cov_m) * np.eye(3) - cov_m
    inertia_t = 0.5 * (inertia_t + inertia_t.T)
    w, rot = np.linalg.eigh(inertia_t)
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]

    vp = (hv - com) @ rot
    vp = _reduce_hull_verts(vp.astype(np.float32), max_verts)
    try:
        planes = _hull_face_planes(vp.astype(np.float64))
    except Exception:
        planes = np.zeros((0, 4), np.float32)
    obb_he = np.maximum(np.abs(vp).max(axis=0), 1e-4)
    bound = float(np.linalg.norm(vp, axis=1).max())
    inertia = np.maximum(w, 1e-9)
    inv_inertia = (1.0 / inertia).astype(np.float32)
    # params[0] is the hull's library slot, set when a world interns it.
    params = np.array([0, obb_he[0], obb_he[1], obb_he[2]], np.float32)
    corner_dirs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                           np.float32)
    contact_verts = vp[np.argmax(vp @ corner_dirs.T, axis=0)]
    return PhysicsShape(
        int(ShapeType.HULL), params, float(m), 1.0 / m if m > 0 else 0.0,
        inv_inertia, float(vol), bound,
        hull_verts=vp.astype(np.float32),
        hull_contact_verts=contact_verts.astype(np.float32),
        hull_planes=planes,
        principal_rot=rot.astype(np.float32),
        com_offset=np.asarray(com, np.float32),
    )


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
    return make_convex_hull(shape.hull_verts * s, mass=shape.mass,
                            max_verts=len(shape.hull_verts))

"""SoA body state, static world geometry and configuration.

Counterpart of ``substrata_tpu/physics/state.py``: the same fields, dtypes
and shapes, as dataclasses of tensors.  Everything is fixed-capacity: dead
slots are masked out with ``alive`` and recycled by the host-side free
list in ``physics.world.PhysicsWorld``.  The static world holds the
heightfield, the merged static trimesh with its xy grid of triangle ids
(``build_trimesh``, host numpy) and the convex-hull library.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch

from substrata_tpu_torch.maths import quat as quatm


class MotionType(enum.IntEnum):
    STATIC = 0
    KINEMATIC = 1
    DYNAMIC = 2


class ShapeType(enum.IntEnum):
    SPHERE = 0
    BOX = 1
    CAPSULE = 2  # axis = local Z; params (radius, half_cyl_height)
    HULL = 3     # params[0] = hull slot id in the hull library


class Layer(enum.IntEnum):
    NON_MOVING = 0
    MOVING = 1
    NON_MOVING_NON_COLLIDABLE = 2
    MOVING_NON_COLLIDABLE = 3


# Seawater constants of the buoyancy pass.
WATER_DENSITY = 1020.0
WATER_LINEAR_DRAG = 0.1
WATER_ANGULAR_DRAG = 3.0
DEFAULT_GRAVITY = (0.0, 0.0, -9.81)  # z-up world


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class BodyState(_Replace):
    """SoA state for all bodies, capacity-N fixed."""

    pos: torch.Tensor          # [N, 3] f32
    quat: torch.Tensor         # [N, 4] f32 (x, y, z, w)
    linvel: torch.Tensor       # [N, 3]
    angvel: torch.Tensor       # [N, 3]
    inv_mass: torch.Tensor     # [N]
    inv_inertia: torch.Tensor  # [N, 3] diagonal local-space inverse inertia
    friction: torch.Tensor     # [N]
    restitution: torch.Tensor  # [N]
    motion_type: torch.Tensor  # [N] i32
    layer: torch.Tensor        # [N] i32
    is_sensor: torch.Tensor    # [N] bool
    shape_type: torch.Tensor   # [N] i32
    shape_params: torch.Tensor  # [N, 4] f32 (see ShapeType)
    alive: torch.Tensor        # [N] bool
    awake: torch.Tensor        # [N] bool
    sleep_timer: torch.Tensor  # [N] f32
    gravity_factor: torch.Tensor  # [N]
    linear_damping: torch.Tensor  # [N]
    angular_damping: torch.Tensor  # [N]
    use_zero_linear_drag: torch.Tensor  # [N] bool
    underwater: torch.Tensor   # [N] bool
    bound_radius: torch.Tensor  # [N] f32
    volume: torch.Tensor       # [N] f32

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self):
        return self.pos.device

    @property
    def dynamic(self):
        return self.motion_type == int(MotionType.DYNAMIC)

    @property
    def collidable(self):
        return (self.layer == int(Layer.NON_MOVING)) | (self.layer == int(Layer.MOVING))


BODY_FIELDS = tuple(f.name for f in dataclasses.fields(BodyState))


def zero_body_state(capacity: int, *, device) -> BodyState:
    n = capacity
    f = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return BodyState(
        pos=torch.zeros((n, 3), **f),
        quat=quatm.identity((n,), device=device),
        linvel=torch.zeros((n, 3), **f),
        angvel=torch.zeros((n, 3), **f),
        inv_mass=torch.zeros((n,), **f),
        inv_inertia=torch.zeros((n, 3), **f),
        friction=torch.full((n,), 0.5, **f),
        restitution=torch.zeros((n,), **f),
        motion_type=torch.zeros((n,), **i32),
        layer=torch.zeros((n,), **i32),
        is_sensor=torch.zeros((n,), **b),
        shape_type=torch.zeros((n,), **i32),
        shape_params=torch.zeros((n, 4), **f),
        alive=torch.zeros((n,), **b),
        awake=torch.zeros((n,), **b),
        sleep_timer=torch.zeros((n,), **f),
        gravity_factor=torch.ones((n,), **f),
        linear_damping=torch.full((n,), 0.05, **f),
        angular_damping=torch.full((n,), 0.05, **f),
        use_zero_linear_drag=torch.zeros((n,), **b),
        underwater=torch.zeros((n,), **b),
        bound_radius=torch.zeros((n,), **f),
        volume=torch.zeros((n,), **f),
    )


@dataclasses.dataclass
class HullLibrary(_Replace):
    """Padded convex-hull table: vertices in each hull's principal frame
    (COM at the origin), padded with repeats of the first vertex, and unit
    outward face planes (n, d: n·x <= d), padded with zeros."""

    verts: torch.Tensor    # [H, MAX_HULL_VERTS, 3] f32
    n_verts: torch.Tensor  # [H] i32
    planes: torch.Tensor   # [H, MAX_HULL_FACES, 4] f32
    n_faces: torch.Tensor  # [H] i32

    @property
    def capacity(self) -> int:
        return self.verts.shape[0]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[1]

    @property
    def max_faces(self) -> int:
        return self.planes.shape[1]


def empty_hull_library(capacity: int = 64, max_verts: int = 32, max_faces: int = 32, *,
                       device) -> HullLibrary:
    return HullLibrary(
        verts=torch.zeros((capacity, max_verts, 3), dtype=torch.float32, device=device),
        n_verts=torch.zeros((capacity,), dtype=torch.int32, device=device),
        planes=torch.zeros((capacity, max_faces, 4), dtype=torch.float32, device=device),
        n_faces=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class TriMesh(_Replace):
    """Static triangle soup with a uniform xy grid of triangle ids
    (``cell_tris``, -1 padded).  ``count`` is the host's copy of the
    triangle count (the empty mesh keeps a one-triangle placeholder and 0)."""

    verts: torch.Tensor      # [V, 3] f32
    tris: torch.Tensor       # [T, 3] i32
    tri_mats: torch.Tensor   # [T] i32 material index of each triangle
    tri_owner: torch.Tensor  # [T] i32 owning object id (-1 = world geometry)
    cell_tris: torch.Tensor  # [GX, GY, CAP] i32 triangle ids, -1 padded
    origin: torch.Tensor     # [2] grid origin xy
    cell_w: torch.Tensor     # [] cell width
    n_tris: torch.Tensor     # [] i32
    count: int = 0


def empty_trimesh(grid=(4, 4), cap=4, *, device) -> TriMesh:
    i32 = dict(dtype=torch.int32, device=device)
    return TriMesh(
        verts=torch.zeros((3, 3), dtype=torch.float32, device=device),
        tris=torch.zeros((1, 3), **i32),
        tri_mats=torch.zeros((1,), **i32),
        tri_owner=torch.full((1,), -1, **i32),
        cell_tris=torch.full(tuple(grid) + (cap,), -1, **i32),
        origin=torch.tensor([-1e3, -1e3], dtype=torch.float32, device=device),
        cell_w=torch.tensor(1e3, dtype=torch.float32, device=device),
        n_tris=torch.zeros((), **i32),
    )


def trimesh_grid(verts: np.ndarray, tris: np.ndarray, grid_dim: int = 64,
                 cell_cap: int = 32):
    """The reference's host build of the triangle grid (state.py:299-345):
    every triangle goes into each cell its xy bounding box covers, filled in
    triangle order (a stable argsort per covered cell offset); a cell keeps
    its first ``cell_cap`` and drops the rest.  Returns (cell_tris [GX, GY,
    cap] i32, origin [2] f32, cell_w)."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    nt = len(tris)
    tv = verts[tris]
    lo = tv.min(axis=1)[:, :2]
    hi = tv.max(axis=1)[:, :2]
    gmin = verts[:, :2].min(axis=0) - 1e-3
    gmax = verts[:, :2].max(axis=0) + 1e-3
    cell_w = float(max((gmax - gmin).max() / grid_dim, 1e-3))
    gx = max(1, min(grid_dim, int(np.ceil((gmax[0] - gmin[0]) / cell_w))))
    gy = max(1, min(grid_dim, int(np.ceil((gmax[1] - gmin[1]) / cell_w))))
    cell_tris = np.full((gx, gy, cell_cap), -1, np.int32)
    counts = np.zeros((gx, gy), np.int32)
    ilo = np.clip(((lo - gmin) / cell_w).astype(np.int32), 0, [gx - 1, gy - 1])
    ihi = np.clip(((hi - gmin) / cell_w).astype(np.int32), 0, [gx - 1, gy - 1])
    span = ihi - ilo
    tids = np.arange(nt, dtype=np.int32)
    max_di = int(span[:, 0].max()) if nt else 0
    max_dj = int(span[:, 1].max()) if nt else 0
    for di in range(max_di + 1):
        for dj in range(max_dj + 1):
            m = (span[:, 0] >= di) & (span[:, 1] >= dj)
            ti = tids[m]
            ci = ilo[m, 0] + di
            cj = ilo[m, 1] + dj
            flat = ci.astype(np.int64) * gy + cj
            order = np.argsort(flat, kind="stable")
            fs = flat[order]
            run_start = np.concatenate([[0], np.flatnonzero(fs[1:] != fs[:-1]) + 1])
            rank = np.arange(len(fs)) - np.repeat(run_start, np.diff(
                np.concatenate([run_start, [len(fs)]])))
            slot = counts[ci[order], cj[order]] + rank
            ok = slot < cell_cap
            cell_tris[ci[order][ok], cj[order][ok], slot[ok]] = ti[order][ok]
            np.add.at(counts, (ci, cj), 1)
            np.clip(counts, 0, cell_cap, out=counts)
    return cell_tris, gmin.astype(np.float32), cell_w


def build_trimesh(verts: np.ndarray, tris: np.ndarray, tri_mats: np.ndarray | None = None,
                  grid_dim: int = 64, cell_cap: int = 32,
                  tri_owner: np.ndarray | None = None, *, device) -> TriMesh:
    """Host-side build (``trimesh_grid``), uploaded to ``device``."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    nt = len(tris)
    if tri_mats is None:
        tri_mats = np.zeros((nt,), np.int32)
    if tri_owner is None:
        tri_owner = np.full((nt,), -1, np.int32)
    cell_tris, origin, cell_w = trimesh_grid(verts, tris, grid_dim, cell_cap)

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=device)
    return TriMesh(verts=t(verts, np.float32), tris=t(tris, np.int32),
                   tri_mats=t(tri_mats, np.int32), tri_owner=t(tri_owner, np.int32),
                   cell_tris=t(cell_tris, np.int32), origin=t(origin, np.float32),
                   cell_w=torch.tensor(cell_w, dtype=torch.float32, device=device),
                   n_tris=torch.tensor(nt, dtype=torch.int32, device=device), count=nt)


@dataclasses.dataclass
class Heightfield(_Replace):
    """Regular-grid heightfield, z-up.  ``is_flat`` selects the ground-plane
    fast path: samples collapse to heights[0, 0] and normal (0, 0, 1)."""

    heights: torch.Tensor  # [HX, HY] f32
    origin: torch.Tensor   # [2] world xy of heights[0, 0]
    cell_w: torch.Tensor   # [] spacing in x and y
    is_flat: bool = False

    def _patch(self, xy):
        """Bilinear patch at world xy [..., 2]: (fu, fv, h00, h10, h01, h11)
        with the reference's clamp at the borders."""
        hx, hy = self.heights.shape
        u = (xy[..., 0] - self.origin[0]) / self.cell_w
        v = (xy[..., 1] - self.origin[1]) / self.cell_w
        u = torch.clamp(u, 0.0, hx - 1.001)
        v = torch.clamp(v, 0.0, hy - 1.001)
        i0 = torch.floor(u).to(torch.int64)
        j0 = torch.floor(v).to(torch.int64)
        fu = u - i0.to(torch.float32)
        fv = v - j0.to(torch.float32)
        hh = self.heights
        return fu, fv, hh[i0, j0], hh[i0 + 1, j0], hh[i0, j0 + 1], hh[i0 + 1, j0 + 1]

    def sample(self, xy):
        """Bilinear height at world xy [..., 2] (the height of
        ``sample_with_normal``)."""
        if self.is_flat:
            return self.heights[0, 0].expand(xy.shape[:-1])
        fu, fv, h00, h10, h01, h11 = self._patch(xy)
        return (h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv)
                + h01 * (1 - fu) * fv + h11 * fu * fv)

    def normal(self, xy):
        """Unit surface normal at world xy [..., 2]."""
        return self.sample_with_normal(xy)[1]

    def sample_with_normal(self, xy):
        """(height, unit normal) at world xy [..., 2]: the bilinear patch and
        the analytic gradient of it; clamps at the borders."""
        if self.is_flat:
            h = self.heights[0, 0].expand(xy.shape[:-1])
            n = torch.zeros(xy.shape[:-1] + (3,), dtype=torch.float32, device=xy.device)
            n[..., 2] = 1.0
            return h, n
        fu, fv, h00, h10, h01, h11 = self._patch(xy)
        h = (h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv)
             + h01 * (1 - fu) * fv + h11 * fu * fv)
        dzdx = ((h10 - h00) * (1 - fv) + (h11 - h01) * fv) / self.cell_w
        dzdy = ((h01 - h00) * (1 - fu) + (h11 - h10) * fu) / self.cell_w
        norm = torch.sqrt(dzdx * dzdx + dzdy * dzdy + 1.0)
        n = torch.stack([-dzdx / norm, -dzdy / norm, 1.0 / norm], dim=-1)
        return h, n


def flat_heightfield(extent: float = 1000.0, z: float = 0.0, res: int = 8, *,
                     device) -> Heightfield:
    return Heightfield(
        heights=torch.full((res, res), z, dtype=torch.float32, device=device),
        origin=torch.tensor([-extent / 2, -extent / 2], dtype=torch.float32,
                            device=device),
        cell_w=torch.tensor(extent / (res - 1), dtype=torch.float32,
                            device=device),
        is_flat=True,
    )


@dataclasses.dataclass
class StaticWorld(_Replace):
    """Static environment: heightfield terrain, the static trimesh, the
    hull library and the water plane."""

    heightfield: Heightfield
    has_heightfield: torch.Tensor  # [] bool
    trimesh: TriMesh
    hulls: HullLibrary
    water_z: torch.Tensor          # [] f32; -1e10 = no water

    @property
    def n_tris(self) -> int:
        """Triangles in the static trimesh (host count; 0 = none)."""
        return self.trimesh.count


def default_static_world(ground_z: float = 0.0, water_z: float = -1e10, *,
                         device) -> StaticWorld:
    return StaticWorld(
        heightfield=flat_heightfield(z=ground_z, device=device),
        has_heightfield=torch.tensor(True, device=device),
        trimesh=empty_trimesh(device=device),
        hulls=empty_hull_library(device=device),
        water_z=torch.tensor(water_z, dtype=torch.float32, device=device),
    )


@dataclasses.dataclass
class SimParams(_Replace):
    """Tunable solver parameters (0-dim tensors on the world's device)."""

    gravity: torch.Tensor           # [3]
    baumgarte: torch.Tensor         # [] position-correction factor per step
    contact_slop: torch.Tensor      # [] allowed penetration
    restitution_threshold: torch.Tensor  # [] min approach speed for bounce
    sleep_lin_vel: torch.Tensor     # []
    sleep_ang_vel: torch.Tensor     # []
    sleep_time: torch.Tensor        # []
    water_z: torch.Tensor           # [] mirrors StaticWorld.water_z


SIM_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(SimParams))


def default_sim_params(*, device) -> SimParams:
    def s(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return SimParams(
        gravity=s(DEFAULT_GRAVITY),
        baumgarte=s(0.2),
        contact_slop=s(0.005),
        restitution_threshold=s(1.0),
        sleep_lin_vel=s(0.03),
        sleep_ang_vel=s(0.03),
        sleep_time=s(0.5),
        water_z=s(-1e10),
    )


class SimConfig:
    """Static capacity configuration, field for field the reference's
    ``SimConfig`` (same defaults, validation and hashing)."""

    def __init__(
        self,
        capacity: int = 1024,
        max_pairs: int = 4096,
        max_contacts_per_pair: int = 4,
        grid_dim: int = 64,
        cell_capacity: int = 8,
        cell_size: float = 2.0,
        solver_iters: int = 10,
        static_contacts_per_body: int = 4,
        max_tri_candidates: int = 16,
        contacts_per_body: int = 16,
        max_active_contacts: int = 0,
        pairs_per_body: int = 8,
        pair_rebuild_interval: int = 4,
        present_shape_types: tuple = (True, True, True, True),
    ):
        if capacity > 65536:
            # Cell-table entries pack a body slot into 16 bits and the pair
            # compaction packs (a << 16 | b) into 32 bits.
            raise ValueError(
                "SimConfig.capacity is limited to 65536 bodies per device "
                "(reference parity); use parallel.spatial spatial sharding "
                "for larger worlds")
        self.capacity = capacity
        self.max_pairs = max_pairs
        self.max_contacts_per_pair = max_contacts_per_pair
        self.grid_dim = grid_dim
        self.cell_capacity = cell_capacity
        self.cell_size = cell_size
        self.solver_iters = solver_iters
        self.static_contacts_per_body = static_contacts_per_body
        self.max_tri_candidates = max_tri_candidates
        self.contacts_per_body = contacts_per_body
        self.pairs_per_body = pairs_per_body
        # The solver's incidence sort packs (body << (contact_bits+1) |
        # contact << 1 | side) into 32 bits; the auto value clamps to that.
        contact_budget = (1 << (32 - 1 - max(capacity.bit_length(), 1))) - 1
        auto = min(2 * max_pairs + 4 * capacity, contact_budget)
        self.max_active_contacts = max_active_contacts or auto
        if (max(self.max_active_contacts.bit_length(), 1)
                + max(capacity.bit_length(), 1) + 1 > 32):
            raise ValueError(
                f"max_active_contacts={self.max_active_contacts} too large "
                f"for capacity={capacity}: the solver packs body and contact "
                f"ids into one uint32 sort key (<= {contact_budget} contacts "
                f"at this capacity)")
        self.pair_rebuild_interval = pair_rebuild_interval
        self.present_shape_types = tuple(bool(x) for x in present_shape_types)

    def _key(self):
        return tuple(sorted(self.__dict__.items()))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other: Any):
        return isinstance(other, SimConfig) and self._key() == other._key()

    def __repr__(self):
        return f"SimConfig({self.__dict__})"


def compute_shape_mass_props(shape_type: int, params: np.ndarray, density: float = 1000.0,
                             mass_override: float = 0.0):
    """Host-side (mass, inv_mass, inv_inertia_diag[3], volume, bound_radius)."""
    p = np.asarray(params, np.float32)
    if shape_type == ShapeType.SPHERE:
        r = float(p[0])
        vol = 4.0 / 3.0 * np.pi * r ** 3
        bound = r
        mass = mass_override if mass_override > 0 else density * vol
        i = 0.4 * mass * r * r
        inertia = np.array([i, i, i], np.float32)
    elif shape_type == ShapeType.BOX:
        hx, hy, hz = float(p[0]), float(p[1]), float(p[2])
        vol = 8.0 * hx * hy * hz
        bound = float(np.sqrt(hx * hx + hy * hy + hz * hz))
        mass = mass_override if mass_override > 0 else density * vol
        c = mass / 3.0
        inertia = np.array([c * (hy * hy + hz * hz), c * (hx * hx + hz * hz),
                            c * (hx * hx + hy * hy)], np.float32)
    elif shape_type == ShapeType.CAPSULE:
        r, hh = float(p[0]), float(p[1])
        vol = float(np.pi * r * r * 2 * hh + 4.0 / 3.0 * np.pi * r ** 3)
        bound = hh + r
        mass = mass_override if mass_override > 0 else density * vol
        vol_cyl = np.pi * r * r * 2 * hh
        vol_sph = 4.0 / 3.0 * np.pi * r ** 3
        m_cyl = mass * vol_cyl / vol
        m_sph = mass * vol_sph / vol
        iz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        d = hh + 3.0 * r / 8.0
        ixy = m_cyl * ((2 * hh) ** 2 / 12.0 + 0.25 * r * r) + m_sph * (0.4 * r * r + d * d)
        inertia = np.array([ixy, ixy, iz], np.float32)
    else:  # HULL: the caller supplies bound radius / volume in params[1:3]
        vol = float(p[2]) if p[2] > 0 else 1.0
        bound = float(p[1]) if p[1] > 0 else 1.0
        mass = mass_override if mass_override > 0 else density * vol
        r = bound * 0.7
        i = 0.4 * mass * r * r
        inertia = np.array([i, i, i], np.float32)
    inv_mass = 1.0 / mass if mass > 0 else 0.0
    inv_inertia = np.where(inertia > 0, 1.0 / inertia, 0.0)
    return float(mass), float(inv_mass), inv_inertia.astype(np.float32), float(vol), float(bound)

"""Terrain height queries, chunk meshes (kernel KW) and vegetation scatter
points (kernel KX).

KW replaces K17's ``substrata_tpu/physics/terrain.py:_eval_heights`` (:40),
``_eval_heights_normals`` (:45) and ``make_terrain_chunk`` (:54), through
``Heightfield.sample`` / ``sample_with_normal``
(``substrata_tpu/physics/state.py:188, :208``): the bilinear height and the
unit normal of the patch's analytic gradient at points, and a batch of
quadtree leaves' (res+1)^2 vertex grids with normals, uvs and the res^2 * 2
triangles.  KX replaces ``scatter_points_for_cells`` (:215-246): per cell
the int32-wrapped hash of its origin, ``fold_in(PRNGKey(seed), hash)``,
K x 4 uniforms, jittered xy, the terrain height and normal there, scale,
rotation and the slope mask.

``terrain_heights``, ``terrain_chunks`` and ``terrain_scatter`` run their
``*_plain`` twins for CPU tensors and the launches of ``csrc/terrain.cu``
for CUDA ones.  Rounding follows the jitted reference, found by comparing
against it (tests/test_torch_terrain.py): the divisions by the traced cell
width are true divisions; XLA contracts the bilinear sum into three fmas,
h = fma(h11 fu, fv, fma(h01 (1-fu), fv, fma(h00 (1-fu), 1-fv, h10 fu (1-fv)))),
each gradient into one, and the normal's length is the fma chain
sqrt(fma(1, 1, fma(ny, ny, nx nx))); the twins call ``fp.fma`` there and
the kernels ``__fmaf_rn``.  ``jax.random`` is threefry2x32 under the
partitionable counter layout; the twin does its uint32 arithmetic in int64
with masks, the kernel in ``uint32_t``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.ray_trace import march_fractions
from substrata_tpu_torch.maths import fp

launches = {"terrain_heights": 0, "terrain_chunks": 0, "terrain_scatter": 0}

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
SCATTER_FIELDS = 6       # x, y, z, scale, rotation, valid (1.0 / 0.0)
TWO_PI = float(np.float32(2 * np.pi))


# ---------------------------------------------------------------------------
# threefry2x32 (jax.random's default generator), uint32 held in int64.
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counters (x1, x2) under key (k1, k2), 20
    rounds as jax's lowering; int64 tensors or ints holding uint32."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for an int32 seed: (0, seed as uint32)."""
    return 0, int(seed) & _M32


def fold_in(key, data):
    """``jax.random.fold_in``: ``data`` (int32, taken as uint32) hashed as
    the counter pair (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def uniform_bits(key, n: int, device=None):
    """The 32 random bits of ``jax.random.uniform(key, shape)`` for a shape
    of ``n`` elements (row-major): counter pair (0, i), bits = b1 ^ b2.
    ``key`` holds ints or int64 tensors [...] (the result is [..., n])."""
    k1, k2 = (torch.as_tensor(k, dtype=torch.int64, device=device)[..., None] for k in key)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return b1 ^ b2


def bits_to_unit(bits):
    """uint32 bits (int64) -> float32 in [0, 1): (bits >> 9) | 0x3f800000
    as a float, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def cell_hash(cell_origins):
    """``origin.astype(int32) * 73856093 ^ ... * 19349663``: the float
    truncates toward zero and the products wrap as int32 (int64 result)."""
    c = cell_origins.to(torch.int32).to(torch.int64)
    h = ((c[:, 0] * 73856093) & _M32) ^ ((c[:, 1] * 19349663) & _M32)
    return h


# ---------------------------------------------------------------------------
# KW's twin: heights, normals, chunks.
# ---------------------------------------------------------------------------

def _patch(heights, origin, cell_w, xy):
    hx, hy = heights.shape
    u = (xy[..., 0] - origin[0]) / cell_w
    v = (xy[..., 1] - origin[1]) / cell_w
    u = torch.clamp(u, 0.0, float(np.float32(hx - 1.001)))
    v = torch.clamp(v, 0.0, float(np.float32(hy - 1.001)))
    i0 = torch.floor(u).to(torch.int64)
    j0 = torch.floor(v).to(torch.int64)
    fu = u - i0.to(torch.float32)
    fv = v - j0.to(torch.float32)
    hh = heights
    return fu, fv, hh[i0, j0], hh[i0 + 1, j0], hh[i0, j0 + 1], hh[i0 + 1, j0 + 1]


def sample_plain(heights, origin, cell_w, xy, with_normals: bool):
    """Height [...] (and unit normal [..., 3]) at world xy [..., 2]."""
    fu, fv, h00, h10, h01, h11 = _patch(heights, origin, cell_w, xy)
    a, b = 1.0 - fu, 1.0 - fv
    h = fp.fma(h11 * fu, fv, fp.fma(h01 * a, fv, fp.fma(h00 * a, b, (h10 * fu) * b)))
    if not with_normals:
        return h, None
    nx = -(fp.fma(h11 - h01, fv, (h10 - h00) * b) / cell_w)
    ny = -(fp.fma(h11 - h10, fu, (h01 - h00) * a) / cell_w)
    norm = fp.sqrt(fp.fma(1.0, 1.0, fp.fma(ny, ny, nx * nx)))
    return h, torch.stack([nx / norm, ny / norm, 1.0 / norm], dim=-1)


def terrain_heights_plain(heights, origin, cell_w, xy, with_normals: bool = False):
    """[P, 1] heights, or [P, 4] (h, nx, ny, nz) with the normals."""
    h, n = sample_plain(heights, origin, cell_w, xy, with_normals)
    return h[:, None] if n is None else torch.cat([h[:, None], n], dim=1)


def chunk_tris(res: int) -> np.ndarray:
    """make_terrain_chunk's [res * res * 2, 3] int32 triangle indices."""
    n = res + 1
    qi, qj = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    v00 = (qi * n + qj).reshape(-1)
    v10, v01, v11 = v00 + n, v00 + 1, v00 + n + 1
    return np.concatenate([np.stack([v00, v10, v11], 1),
                           np.stack([v00, v11, v01], 1)]).astype(np.int32)


def chunk_floats(res: int) -> int:
    """Floats of one packed chunk: (res+1)^2 x (verts 3, normals 3, uvs 2),
    then the res^2 * 2 x 3 triangle indices as int32 bits."""
    return (res + 1) ** 2 * 8 + res * res * 6


def terrain_chunks_plain(heights, origin, cell_w, leaf_origin, leaf_width, res: int):
    """[L, chunk_floats(res)] packed chunks of the leaves at ``leaf_origin``
    [L, 2] with widths ``leaf_width`` [L]."""
    n = res + 1
    dev = heights.device
    lin = march_fractions(n, dev)
    xs = fp.fma(lin[None, :], leaf_width[:, None], leaf_origin[:, 0:1])      # [L, n]
    ys = fp.fma(lin[None, :], leaf_width[:, None], leaf_origin[:, 1:2])
    gx = xs[:, :, None].expand(-1, n, n)
    gy = ys[:, None, :].expand(-1, n, n)
    xy = torch.stack([gx, gy], dim=-1).reshape(-1, n * n, 2)
    h, nrm = sample_plain(heights, origin, cell_w, xy, True)
    uv = (xy - leaf_origin[:, None, :]) / leaf_width[:, None, None]
    verts = torch.cat([xy, h[..., None], nrm, uv], dim=-1).reshape(len(leaf_width), -1)
    tris = torch.as_tensor(chunk_tris(res), device=dev).view(torch.float32).reshape(1, -1)
    return torch.cat([verts, tris.expand(len(leaf_width), -1)], dim=1)


def unpack_chunks(packed: np.ndarray, res: int):
    """Host numpy [L, chunk_floats] -> [(verts, normals, uvs, tris)] each a
    fresh array, as make_terrain_chunk returns them."""
    n2 = (res + 1) ** 2
    out = []
    for row in packed:
        v = row[:n2 * 8].reshape(n2, 8)
        out.append((v[:, 0:3].copy(), v[:, 3:6].copy(), v[:, 6:8].copy(),
                    row[n2 * 8:].view(np.int32).reshape(-1, 3).copy()))
    return out


# ---------------------------------------------------------------------------
# KX's twin: the scatter points.
# ---------------------------------------------------------------------------

def terrain_scatter_plain(heights, origin, cell_w, cells, scatter_w: float, seed: int,
                          k: int, max_slope_cos: float = 0.8):
    """[C, K, 6] (x, y, z, scale, rotation, valid) for the cells at origins
    ``cells`` [C, 2]."""
    c = cells.shape[0]
    key = prng_key(seed)
    k1, k2 = fold_in(key, cell_hash(cells))
    u = bits_to_unit(uniform_bits((k1, k2), k * 4, cells.device)).reshape(c, k, 4)
    sw = float(np.float32(scatter_w))
    xy = fp.fma(u[..., :2], sw, cells[:, None, :])
    h, nrm = sample_plain(heights, origin, cell_w, xy.reshape(c * k, 2), True)
    scale = fp.fma(u[..., 2], 0.8, 0.6)
    rot = u[..., 3] * TWO_PI
    valid = (nrm[:, 2] > float(np.float32(max_slope_cos))).reshape(c, k)
    return torch.stack([xy[..., 0], xy[..., 1], h.reshape(c, k), scale, rot,
                        valid.to(torch.float32)], dim=-1)


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------

def _check_field(heights, origin, cell_w, dev):
    build.check(heights, "heights", torch.float32, tuple(heights.shape), dev)
    build.check(origin, "origin", torch.float32, (2,), dev)
    build.check(cell_w, "cell_w", torch.float32, (), dev)
    if heights.dim() != 2 or min(heights.shape) < 2:
        raise ValueError(f"heights: expected [HX >= 2, HY >= 2], got {tuple(heights.shape)}")


# The heights launcher's argument buffer (csrc/terrain.cu:terrain_heights):
# the field's part, fixed by its plan (heights, origin, cell_w, HX, HY), then
# the call's (xy, P, with_normals, out).
_FIELD_PACK = struct.Struct("=5q")
_CALL_PACK = struct.Struct("=4q")
_F32 = torch.float32
_MAX_FIELD_PLANS = 4
# Outputs are made _OUT_BATCH at a time per call shape (at most
# _MAX_OUT_SHAPES shapes a field): one torch.empty costs a heights call
# about as much host time as its launch.
_OUT_BATCH = 8
_MAX_OUT_SHAPES = 4
_field_plans: dict = {}
_last_plan = [None]   # the last call's plan: a field queried again skips the lookup


class _FieldPlan:
    """A heightfield as the heights call takes it: its three tensors,
    checked once and held (so that their ids stay theirs and their pointers
    valid), their pointers and the grid's size packed for the launcher, and
    the outputs made ahead.

    Each output is a fresh region of a block of ``_OUT_BATCH`` made by one
    ``torch.empty``: no two calls share memory, and a block lives while any
    of its outputs does."""

    def __init__(self, heights, origin, cell_w, dev):
        _check_field(heights, origin, cell_w, dev)
        self.field = (heights, origin, cell_w)
        self.device = dev
        self.packed = _FIELD_PACK.pack(heights.data_ptr(), origin.data_ptr(), cell_w.data_ptr(),
                                       *heights.shape)
        self.ahead = {}

    def output(self, p: int, k: int):
        """A new [p, k] float32 output on the field's device."""
        ahead = self.ahead.get((p, k))
        if not ahead:
            if ahead is None and len(self.ahead) >= _MAX_OUT_SHAPES:
                self.ahead.pop(next(iter(self.ahead)))
            ahead = self.ahead[(p, k)] = list(torch.empty(
                (_OUT_BATCH, p, k), dtype=_F32, device=self.device).unbind(0))
        return ahead.pop()


def _field_plan(heights, origin, cell_w, dev):
    key = (id(heights), id(origin), id(cell_w))
    plan = _field_plans.get(key)
    if plan is None:
        if len(_field_plans) >= _MAX_FIELD_PLANS:
            _field_plans.pop(next(iter(_field_plans)))
        plan = _field_plans[key] = _FieldPlan(heights, origin, cell_w, dev)
    return plan


def terrain_heights(heights, origin, cell_w, xy, with_normals: bool = False):
    """KW (a): heights [P, 1], or [P, 4] (h, normal) with ``with_normals``,
    at the points ``xy`` [P, 2].  The field's checks and pointers come from
    its plan; a call tests ``xy``, takes an output and makes one packed
    launch."""
    if xy.is_cpu:
        return terrain_heights_plain(heights, origin, cell_w, xy, with_normals)
    plan = _last_plan[0]
    if plan is None or not (plan.field[0] is heights and plan.field[1] is origin
                            and plan.field[2] is cell_w):
        plan = _last_plan[0] = _field_plan(heights, origin, cell_w, xy.device)
    if not (xy.dtype is _F32 and xy.dim() == 2 and xy.shape[1] == 2 and xy.is_contiguous()
            and xy.device == plan.device):
        build.check(xy, "xy", _F32, (xy.shape[0] if xy.dim() else 0, 2), plan.device)
    p = xy.shape[0]
    out = plan.output(p, 4 if with_normals else 1)
    build.launch_packed("terrain_heights", plan.packed + _CALL_PACK.pack(
        xy.data_ptr(), p, 1 if with_normals else 0, out.data_ptr()))
    launches["terrain_heights"] += 1
    return out


def terrain_chunks(heights, origin, cell_w, leaf_origin, leaf_width, res: int):
    """KW (b): the packed chunks of L leaves in one launch (see
    ``terrain_chunks_plain``)."""
    if leaf_origin.device.type == "cpu":
        return terrain_chunks_plain(heights, origin, cell_w, leaf_origin, leaf_width, res)
    dev = leaf_origin.device
    n_leaf = leaf_origin.shape[0]
    _check_field(heights, origin, cell_w, dev)
    build.check(leaf_origin, "leaf_origin", torch.float32, (n_leaf, 2), dev)
    build.check(leaf_width, "leaf_width", torch.float32, (n_leaf,), dev)
    out = torch.empty((n_leaf, chunk_floats(res)), dtype=torch.float32, device=dev)
    build.launch("terrain_chunks", heights, origin, cell_w, leaf_origin, leaf_width,
                 heights.shape[0], heights.shape[1], n_leaf, res,
                 float(np.float32(1.0) / np.float32(res)), out)
    launches["terrain_chunks"] += 1
    return out


def terrain_scatter(heights, origin, cell_w, cells, scatter_w: float, seed: int, k: int,
                    max_slope_cos: float = 0.8):
    """KX: [C, K, 6] scatter points of the cells at ``cells`` [C, 2]."""
    if cells.device.type == "cpu":
        return terrain_scatter_plain(heights, origin, cell_w, cells, scatter_w, seed, k,
                                     max_slope_cos)
    dev = cells.device
    c = cells.shape[0]
    _check_field(heights, origin, cell_w, dev)
    build.check(cells, "cells", torch.float32, (c, 2), dev)
    out = torch.empty((c, k, SCATTER_FIELDS), dtype=torch.float32, device=dev)
    k1, k2 = prng_key(seed)
    build.launch("terrain_scatter", heights, origin, cell_w, cells, heights.shape[0],
                 heights.shape[1], c, k, k1, k2, float(np.float32(scatter_w)),
                 float(np.float32(max_slope_cos)), out)
    launches["terrain_scatter"] += 1
    return out


def scatter_flops(c: int, k: int) -> int:
    """Operations of KX for C cells of K points: the cell's fold_in, 4
    threefry hashes (20 rounds, ~6 integer ops each) a point, the sample."""
    return c * 130 + c * k * (4 * 130 + 60)


def heights_flops(p: int, with_normals: bool) -> int:
    return p * (45 if with_normals else 25)


"""Voxel mesh building: greedy meshing of compressed voxel groups.

A copy of ``substrata_tpu/shared/voxel.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Parity with shared/VoxelMeshBuilding.{h,cpp}: WorldObjects of type
VoxelGroup carry a compressed voxel payload (material-grouped RLE of voxel
coordinates); the client builds a merged-quad mesh from it for both
graphics and physics.  The greedy mesher is vectorised with numpy (the
reference is scalar C++); compression format is ours (zlib'd int32 coords
per material).
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np


def compress_voxel_group(coords: np.ndarray, materials: np.ndarray) -> bytes:
    """coords [N, 3] int32, materials [N] int32 -> compressed payload
    (WorldObject.compressed_voxels equivalent)."""
    coords = np.asarray(coords, np.int32)
    materials = np.asarray(materials, np.int32)
    out = io.BytesIO()
    mats = np.unique(materials)
    out.write(struct.pack("<I", len(mats)))
    for m in mats:
        sel = coords[materials == m]
        out.write(struct.pack("<iI", int(m), len(sel)))
        out.write(sel.tobytes())
    return zlib.compress(out.getvalue())


def decompress_voxel_group(data: bytes):
    raw = zlib.decompress(data)
    (nmats,) = struct.unpack_from("<I", raw, 0)
    off = 4
    coords_list, mats_list = [], []
    for _ in range(nmats):
        m, cnt = struct.unpack_from("<iI", raw, off)
        off += 8
        c = np.frombuffer(raw, np.int32, count=cnt * 3, offset=off).reshape(cnt, 3)
        off += cnt * 12
        coords_list.append(c)
        mats_list.append(np.full(cnt, m, np.int32))
    if not coords_list:
        return np.zeros((0, 3), np.int32), np.zeros(0, np.int32)
    return np.concatenate(coords_list), np.concatenate(mats_list)


def make_greedy_mesh(coords: np.ndarray, materials: np.ndarray,
                     voxel_size: float = 1.0, use_native: bool = True):
    """Greedy-merged quad mesh from voxels.

    Returns (verts [V, 3] f32, tris [T, 3] i32, tri_mats [T] i32).
    Faces between voxels of the same material are culled; coplanar
    same-material faces merge into maximal rectangles (classic greedy
    meshing, the approach VoxelMeshBuilding takes for merged meshes).
    The numpy mesher only: the reference's native C++ route gives the
    same mesh, so ``use_native`` is accepted and ignored.
    """
    coords = np.asarray(coords, np.int64)
    materials = np.asarray(materials, np.int64)
    if len(coords) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros(0, np.int32))
    mn = coords.min(axis=0)
    mx = coords.max(axis=0)
    dims = (mx - mn + 1).astype(np.int64)
    grid = np.zeros(dims, np.int64)  # 0 = empty, else material+1
    rel = coords - mn
    grid[rel[:, 0], rel[:, 1], rel[:, 2]] = materials + 1

    verts: list = []
    tris: list = []
    tri_mats: list = []
    vert_index: dict = {}

    def vid(p):
        key = (p[0], p[1], p[2])
        i = vert_index.get(key)
        if i is None:
            i = len(verts)
            vert_index[key] = i
            verts.append(key)
        return i

    # For each axis and direction, greedy-mesh the boundary masks slice by
    # slice (mask = material where a face is exposed).
    for axis in range(3):
        u = (axis + 1) % 3
        v = (axis + 2) % 3
        for sign in (+1, -1):
            for slice_i in range(dims[axis]):
                cur = np.take(grid, slice_i, axis=axis)
                nbr_i = slice_i + sign
                if 0 <= nbr_i < dims[axis]:
                    nbr = np.take(grid, nbr_i, axis=axis)
                else:
                    nbr = np.zeros_like(cur)
                mask = np.where((cur != 0) & (nbr == 0), cur, 0)  # [du, dv]
                if not mask.any():
                    continue
                mask = mask.copy()
                du, dv = mask.shape
                for i0 in range(du):
                    j0 = 0
                    while j0 < dv:
                        m = mask[i0, j0]
                        if m == 0:
                            j0 += 1
                            continue
                        # Grow width along v.
                        w = 1
                        while j0 + w < dv and mask[i0, j0 + w] == m:
                            w += 1
                        # Grow height along u.
                        h = 1
                        while i0 + h < du and np.all(mask[i0 + h, j0:j0 + w] == m):
                            h += 1
                        mask[i0:i0 + h, j0:j0 + w] = 0
                        # Emit the quad.
                        base = np.zeros(3, np.int64)
                        base[axis] = slice_i + (1 if sign > 0 else 0)
                        base[u] = i0
                        base[v] = j0
                        eu = np.zeros(3, np.int64); eu[u] = h
                        ev = np.zeros(3, np.int64); ev[v] = w
                        p0 = base
                        p1 = base + eu
                        p2 = base + eu + ev
                        p3 = base + ev
                        ids = [vid(tuple(p)) for p in (p0, p1, p2, p3)]
                        # Winding so the normal faces outward.
                        flip = (sign > 0) == (axis != 1)
                        if flip:
                            quads = [(ids[0], ids[1], ids[2]), (ids[0], ids[2], ids[3])]
                        else:
                            quads = [(ids[0], ids[2], ids[1]), (ids[0], ids[3], ids[2])]
                        tris.extend(quads)
                        tri_mats.extend([m - 1, m - 1])
                        j0 += w

    verts_arr = (np.array(verts, np.float32) + mn.astype(np.float32)) * voxel_size
    return verts_arr, np.array(tris, np.int32), np.array(tri_mats, np.int32)


def make_mesh_for_voxel_group(compressed: bytes, voxel_size: float = 1.0):
    """VoxelMeshBuilding::makeModelForVoxelGroup parity: payload -> mesh."""
    coords, mats = decompress_voxel_group(compressed)
    return make_greedy_mesh(coords, mats, voxel_size)

"""BatchedMesh (.bmesh) codec — the reference's native mesh format.

A copy of ``substrata_tpu/shared/bmesh.py``: importing any module of the
reference package loads jax, so the port keeps its own.  Its zstd streams
go through the port's standard-library codec (``shared/zstd.py``) instead
of the ``zstandard`` package.

Format (reverse-engineered from the sample meshes shipped in the
reference's resources/ directory; glare-core BatchedMesh, used by
shared/LODGeneration.cpp and the upload pipeline — server converts every
uploaded model to .bmesh):

  header (60 B, little-endian):
    u32 magic = 12456751
    u32 format_version        (1 and 3 observed)
    u32 header_size_B = 60
    u32 flags                 bit0 = zstd-compressed streams,
                              bit1 = animation data present (v3),
                              bit2 = v3 stream layout
    u32 num_vert_attributes
    u32 num_batches
    u32 index_component_type  (ComponentType below)
    u32 index_data_size_B     (uncompressed)
    u32 vertex_data_size_B    (uncompressed)
    f32[3] aabb_min, f32[3] aabb_max
  if version >= 3: f32 pos_dequant_scale, f32 uv_dequant_scale
  num_vert_attributes x (u32 attr_type, u32 component_type)
  num_batches x (u32 indices_start, u32 num_indices, u32 material_index)
  u64 compressed_size + zstd frame: index data
  u64 compressed_size + zstd frame: vertex data

  Index data: per-index DELTA-encoded (cumulative sum modulo 2^bits
  reconstructs the index list).  Vertex data: PLANAR — each attribute's
  array stored contiguously in declaration order (zstd-friendly).

Attribute types: 0 position, 1 normal, 2 colour, 3 uv0, 4 uv1,
5 joint indices, 6 joint weights.  Component types: 0 f32, 1 f16, 2 u8,
3 u16, 4 u32, 5 packed-normal (10:10:10:2 in 4 B), 6 oct16 packed normal.

Only the geometry needed by the physics/LOD pipeline is decoded:
positions (float or u16-dequantised — PhysicsWorld.cpp:1000-1083 builds
hulls from uint16-dequantised verts), triangle indices + per-triangle
materials, and joints/weights for skinned-mesh collision baking
(PhysicsWorld.cpp:735-811).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from substrata_tpu_torch.shared import zstd

MAGIC = 12456751

# Component types
CT_F32, CT_F16, CT_U8, CT_U16, CT_U32, CT_PACKED_NORMAL, CT_OCT16 = range(7)
# Attribute types
AT_POSITION, AT_NORMAL, AT_COLOUR, AT_UV0, AT_UV1, AT_JOINTS, AT_WEIGHTS = \
    range(7)

_CT_BYTES = {CT_F32: 4, CT_F16: 2, CT_U8: 1, CT_U16: 2, CT_U32: 4,
             CT_PACKED_NORMAL: 4, CT_OCT16: 4}
# Component COUNT per attribute (packed normals count as one unit).
_AT_COMPONENTS = {AT_POSITION: 3, AT_NORMAL: 3, AT_COLOUR: 3, AT_UV0: 2,
                  AT_UV1: 2, AT_JOINTS: 4, AT_WEIGHTS: 4}


def _attr_size_bytes(attr_type: int, comp_type: int) -> int:
    if comp_type in (CT_PACKED_NORMAL, CT_OCT16):
        return 4
    return _AT_COMPONENTS[attr_type] * _CT_BYTES[comp_type]


@dataclass
class BMesh:
    verts: np.ndarray                 # [V, 3] f32 positions
    tris: np.ndarray                  # [T, 3] i32
    tri_mats: np.ndarray              # [T] i32
    aabb_min: np.ndarray = None
    aabb_max: np.ndarray = None
    joints: np.ndarray | None = None   # [V, 4] i32 or None
    weights: np.ndarray | None = None  # [V, 4] f32 or None
    uvs: np.ndarray | None = None      # [V, 2] f32 or None
    batches: list = field(default_factory=list)  # (start, count, mat)

    def merged_mesh(self):
        return self.verts, self.tris, self.tri_mats


def load_bmesh(data: bytes) -> BMesh:
    (magic, version, hsz, flags, natt, nbatch, itype, isz, vsz
     ) = struct.unpack_from("<9I", data, 0)
    if magic != MAGIC:
        raise ValueError(f"not a bmesh (magic {magic})")
    if version > 3:
        raise ValueError(f"unsupported bmesh version {version}")
    if version >= 3 and (flags & 2):
        # Animation-container variant (skeletal animation section changes
        # the stream framing).  Avatars animate via the GLB path; static/
        # dynamic world meshes never carry this flag.
        raise ValueError("bmesh v3 animation containers not supported")
    aabb_min = np.array(struct.unpack_from("<3f", data, 36), np.float32)
    aabb_max = np.array(struct.unpack_from("<3f", data, 48), np.float32)
    off = hsz
    pos_scale = uv_scale = 1.0
    if version >= 3:
        pos_scale, uv_scale = struct.unpack_from("<2f", data, off)
        off += 8
    atts = []
    for _ in range(natt):
        atts.append(struct.unpack_from("<2I", data, off))
        off += 8
    batches = []
    for _ in range(nbatch):
        batches.append(struct.unpack_from("<3I", data, off))
        off += 12

    if flags & 1:
        (csz,) = struct.unpack_from("<Q", data, off)
        off += 8
        idx_bytes = zstd.decompress(data[off:off + csz], max_output_size=isz)
        off += csz
        (csz,) = struct.unpack_from("<Q", data, off)
        off += 8
        vert_bytes = zstd.decompress(data[off:off + csz], max_output_size=vsz)
        off += csz
    else:
        idx_bytes = data[off:off + isz]
        off += isz
        vert_bytes = data[off:off + vsz]
        off += vsz

    # --- Indices: delta decode ---
    idt = {CT_U8: np.uint8, CT_U16: np.uint16, CT_U32: np.uint32}[itype]
    deltas = np.frombuffer(idx_bytes, idt).astype(np.int64)
    mod = 1 << (8 * np.dtype(idt).itemsize)
    indices = np.cumsum(deltas) % mod

    # --- Vertex attributes: planar layout ---
    stride_total = sum(_attr_size_bytes(a, c) for a, c in atts)
    nverts = vsz // stride_total if stride_total else 0
    verts = None
    joints = weights = uvs = None
    p = 0
    for attr_type, comp in atts:
        size = _attr_size_bytes(attr_type, comp) * nverts
        blob = vert_bytes[p:p + size]
        p += size
        if attr_type == AT_POSITION:
            if comp == CT_F32:
                verts = np.frombuffer(blob, np.float32).reshape(nverts, 3)
            elif comp == CT_U16:
                # uint16-dequantised positions (PhysicsWorld.cpp:1000-1083):
                # p = aabb_min + u16 * scale * (aabb_max - aabb_min)
                q = np.frombuffer(blob, np.uint16).reshape(nverts, 3)
                verts = (aabb_min + q.astype(np.float32) * pos_scale
                         * (aabb_max - aabb_min)).astype(np.float32)
            else:
                raise ValueError(f"unsupported position component {comp}")
        elif attr_type == AT_JOINTS:
            w = {CT_U8: np.uint8, CT_U16: np.uint16,
                 CT_U32: np.uint32}.get(comp)
            if w is not None:
                joints = np.frombuffer(blob, w).reshape(
                    nverts, 4).astype(np.int32)
        elif attr_type == AT_WEIGHTS:
            if comp == CT_F32:
                weights = np.frombuffer(blob, np.float32).reshape(nverts, 4)
            elif comp == CT_U16:
                weights = (np.frombuffer(blob, np.uint16)
                           .reshape(nverts, 4).astype(np.float32) / 65535.0)
            elif comp == CT_U8:
                weights = (np.frombuffer(blob, np.uint8)
                           .reshape(nverts, 4).astype(np.float32) / 255.0)
        elif attr_type == AT_UV0 and comp == CT_F32:
            uvs = np.frombuffer(blob, np.float32).reshape(nverts, 2)
    if verts is None:
        raise ValueError("bmesh has no position attribute")

    # --- Triangles from batches ---
    tris = indices.reshape(-1, 3).astype(np.int32)
    tri_mats = np.zeros(len(tris), np.int32)
    for start, count, mat in batches:
        tri_mats[start // 3:(start + count) // 3] = mat
    return BMesh(verts=verts, tris=tris, tri_mats=tri_mats,
                 aabb_min=aabb_min, aabb_max=aabb_max,
                 joints=joints, weights=weights, uvs=uvs,
                 batches=[tuple(b) for b in batches])


def write_bmesh(verts: np.ndarray, tris: np.ndarray,
                tri_mats: np.ndarray | None = None,
                uvs: np.ndarray | None = None) -> bytes:
    """Write a version-1 .bmesh (float positions, zstd streams, delta
    indices) — the format the server's upload pipeline produces when
    converting models (docs/changelog.txt: 'conversion of meshes to
    bmesh').  The streams are zstd frames of the port's own writer
    (``shared/zstd.py``), which any zstd reader takes."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    n = len(verts)
    if tri_mats is None:
        tri_mats = np.zeros(len(tris), np.int32)
    # Batches: contiguous runs of equal material.
    order = np.argsort(tri_mats, kind="stable")
    tris = tris[order]
    tri_mats = np.asarray(tri_mats, np.int32)[order]
    batches = []
    start = 0
    for m in np.unique(tri_mats):
        count = int((tri_mats == m).sum()) * 3
        batches.append((start, count, int(m)))
        start += count
    # Index stream: delta-encoded in the narrowest sufficient type.
    flat = tris.reshape(-1)
    if n <= 0xFF:
        idt, itype = np.uint8, CT_U8
    elif n <= 0xFFFF:
        idt, itype = np.uint16, CT_U16
    else:
        idt, itype = np.uint32, CT_U32
    mod = 1 << (8 * np.dtype(idt).itemsize)
    deltas = np.diff(flat, prepend=0) % mod
    idx_bytes = deltas.astype(idt).tobytes()

    atts = [(AT_POSITION, CT_F32)]
    blobs = [verts.tobytes()]
    if uvs is not None:
        atts.append((AT_UV0, CT_F32))
        blobs.append(np.asarray(uvs, np.float32).tobytes())
    vert_bytes = b"".join(blobs)

    aabb_min = verts.min(axis=0) if n else np.zeros(3, np.float32)
    aabb_max = verts.max(axis=0) if n else np.zeros(3, np.float32)
    out = [struct.pack("<9I", MAGIC, 1, 60, 1, len(atts), len(batches),
                       itype, len(idx_bytes), len(vert_bytes)),
           struct.pack("<3f", *aabb_min), struct.pack("<3f", *aabb_max)]
    for a in atts:
        out.append(struct.pack("<2I", *a))
    for b in batches:
        out.append(struct.pack("<3I", *b))
    for blob in (idx_bytes, vert_bytes):
        c = zstd.compress(blob)
        out.append(struct.pack("<Q", len(c)))
        out.append(c)
    return b"".join(out)


def physics_shape_for_bmesh(mesh: BMesh, dynamic: bool, mass: float = 0.0):
    """PhysicsWorld.cpp:871-1083 factory semantics for BatchedMesh content:
    dynamic objects get a convex hull of the (possibly skinned-rest-pose)
    vertices, static objects a trimesh source.  Skinned meshes contribute
    their rest-pose vertex positions (the reference bakes the bind pose
    into the collision hull, PhysicsWorld.cpp:735-811)."""
    from substrata_tpu_torch.physics import shapes
    if dynamic:
        return shapes.make_convex_hull(mesh.verts, mass=mass), None
    return None, (mesh.verts, mesh.tris, mesh.tri_mats)

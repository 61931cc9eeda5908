"""Extra model-format decoders: OBJ, STL, MagicaVoxel VOX, and the format
dispatcher (reference: gui_client/ModelLoading.cpp:487-948 dispatches vox /
subvox / obj / gltf / glb / vrm / stl / igmesh / bmesh / sog).

A copy of ``substrata_tpu/shared/model_formats.py``: importing any module of the
reference package loads jax, so the port keeps its own.  Compressed
igmesh streams go through the port's standard-library zstd codec
(``shared/zstd.py``) instead of the ``zstandard`` package.

Formats handled here are implemented from their public specifications:

- Wavefront OBJ: text `v`/`f` statements, polygon fan triangulation,
  `usemtl` material switching (ModelLoading.cpp:614).
- STL: binary (80-byte header + 50-byte facet records) and ASCII
  (`solid`/`facet`/`vertex`), with vertex dedup (ModelLoading.cpp:803).
- MagicaVoxel VOX: RIFF-style MAIN/SIZE/XYZI chunks decoded into voxel
  coords + palette-derived materials, meshed with the same greedy mesher
  voxel objects use (ModelLoading.cpp:487 VoxLoading path).

- Indigo igmesh (subset): the Indigo SDK's binary mesh
  (ModelLoading.cpp:862 Indigo::Mesh::readFromFile).  The layout was
  derived from the reference's own sample assets
  (resources/models/{cone,wedge}.igmesh, written by
  gui_client/MeshBuilding.cpp:755 `Indigo::Mesh::writeToFile(...,
  use_compression=false)`): little-endian, magic 5456751, version, a
  compression flag (version >= 4), num_uv_mappings, used-material names,
  then length-prefixed arrays of vert positions / normals / colours /
  uv pairs / triangles (3 vert + 3 uv indices + mat) / quads (4 + 4 +
  mat).  We decode the positions-and-faces subset — enough for
  collision + LOD generation parity; quads fan into two tris.
  Compressed streams (flag == 1): the post-flag payload is a zstd frame
  holding the same array layout; the Indigo SDK source is not in the
  reference tree, so this layout is verified by round-trip against our
  own writer (write_igmesh) and guarded by the same strict
  lands-exactly-on-EOF check — a real-world file with a different
  compressed chunking fails loudly instead of mis-parsing.
  Material names: both sample assets carry empty names, where the
  4-byte-padded and unpadded string layouts are byte-identical; the
  parser tries padded first and falls back to unpadded (the strict EOF
  check arbitrates).

NOT handled (raise with a clear reason):

- sog / subvox: Gaussian-splat and in-house packed-voxel renderer formats —
  renderer territory (SURVEY.md §7).

All decoders return ``(verts f32[N,3], tris i32[T,3], tri_mats i32[T])`` in
object space, matching GLTFModel.merged_mesh()/BMesh.merged_mesh().
"""

from __future__ import annotations

import struct

import numpy as np

from substrata_tpu_torch.shared import zstd
from substrata_tpu_torch.shared.voxel import make_greedy_mesh


class UnsupportedModelFormat(ValueError):
    pass


# ---------------------------------------------------------------------------
# Wavefront OBJ
# ---------------------------------------------------------------------------

def load_obj(data: bytes):
    verts: list = []
    tris: list = []
    tri_mats: list = []
    mat_ids: dict[str, int] = {}
    cur_mat = 0
    for raw in data.decode("utf-8", errors="replace").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v" and len(parts) >= 4:
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "usemtl" and len(parts) >= 2:
            cur_mat = mat_ids.setdefault(parts[1], len(mat_ids))
        elif tag == "f" and len(parts) >= 4:
            # Each corner is v, v/vt, v//vn or v/vt/vn; indices 1-based,
            # negative = relative to current vertex count.
            idx = []
            for c in parts[1:]:
                vi = int(c.split("/")[0])
                idx.append(vi - 1 if vi > 0 else len(verts) + vi)
            for k in range(1, len(idx) - 1):   # fan triangulation
                tris.append((idx[0], idx[k], idx[k + 1]))
                tri_mats.append(cur_mat)
    if not verts or not tris:
        raise UnsupportedModelFormat("OBJ has no geometry")
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int32)
    if t.min() < 0 or t.max() >= len(v):
        raise UnsupportedModelFormat("OBJ face index out of range")
    return v, t, np.asarray(tri_mats, np.int32)


# ---------------------------------------------------------------------------
# STL (binary + ASCII)
# ---------------------------------------------------------------------------

def load_stl(data: bytes):
    tri_pts = None
    if len(data) >= 84:
        (n,) = struct.unpack_from("<I", data, 80)
        if len(data) == 84 + 50 * n and n > 0:
            rec = np.frombuffer(data, np.uint8, count=50 * n, offset=84)
            rec = rec.reshape(n, 50)[:, :48].copy()
            f = rec.view(np.float32).reshape(n, 12)
            tri_pts = f[:, 3:12].reshape(n, 3, 3)   # skip the facet normal
    if tri_pts is None:
        if not data.lstrip()[:5].lower() == b"solid":
            raise UnsupportedModelFormat("not a valid STL")
        pts = []
        for line in data.decode("ascii", errors="replace").splitlines():
            parts = line.split()
            if parts and parts[0] == "vertex":
                pts.append((float(parts[1]), float(parts[2]),
                            float(parts[3])))
        if not pts or len(pts) % 3:
            raise UnsupportedModelFormat("ASCII STL has no triangles")
        tri_pts = np.asarray(pts, np.float32).reshape(-1, 3, 3)
    # Dedup shared corners so hull building / trimesh appends stay compact.
    flat = tri_pts.reshape(-1, 3)
    verts, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
    tris = inv.reshape(-1, 3).astype(np.int32)
    ok = ((tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
          & (tris[:, 0] != tris[:, 2]))
    tris = tris[ok]
    if len(tris) == 0:
        raise UnsupportedModelFormat("STL degenerate")
    return (verts.astype(np.float32), tris,
            np.zeros(len(tris), np.int32))


# ---------------------------------------------------------------------------
# MagicaVoxel VOX
# ---------------------------------------------------------------------------

def load_vox(data: bytes, voxel_size: float = 1.0):
    if data[:4] != b"VOX ":
        raise UnsupportedModelFormat("not a VOX file")
    pos = 8  # magic + version
    coords_all = []
    colors_all = []

    def parse_chunk(p):
        cid = data[p:p + 4]
        (nbytes, nchild) = struct.unpack_from("<II", data, p + 4)
        body = data[p + 12:p + 12 + nbytes]
        return cid, body, p + 12 + nbytes, p + 12 + nbytes + nchild

    cid, body, child_start, _ = parse_chunk(pos)
    if cid != b"MAIN":
        raise UnsupportedModelFormat("VOX missing MAIN chunk")
    p = child_start
    palette = None
    while p + 12 <= len(data):
        cid, body, _, nxt = parse_chunk(p)
        if cid == b"XYZI":
            (n,) = struct.unpack_from("<I", body, 0)
            arr = np.frombuffer(body, np.uint8, count=4 * n, offset=4)
            arr = arr.reshape(n, 4)
            coords_all.append(arr[:, :3].astype(np.int32))
            colors_all.append(arr[:, 3].astype(np.int32))
        elif cid == b"RGBA":
            palette = np.frombuffer(body, np.uint8, count=1024).reshape(256, 4)
        p = nxt
    if not coords_all:
        raise UnsupportedModelFormat("VOX has no voxels")
    coords = np.concatenate(coords_all)
    colors = np.concatenate(colors_all)
    # Palette indices -> compact material ids in first-seen order (the
    # reference maps VOX palette colours onto WorldMaterials the same way).
    uniq, mats = np.unique(colors, return_inverse=True)
    del palette  # colour values feed materials, not physics
    return make_greedy_mesh(coords, mats.astype(np.int32),
                            voxel_size=voxel_size)


# ---------------------------------------------------------------------------
# Indigo igmesh (uncompressed subset)
# ---------------------------------------------------------------------------

_IGMESH_MAGIC = 5456751


def load_igmesh(data: bytes):
    """Decode an Indigo .igmesh (uncompressed or zstd-compressed) into
    (verts, tris, tri_mats).

    Subset reader: positions, triangles and quads only (normals / colours /
    uvs are parsed past, not returned) — what collision and LOD generation
    need.  Every array is strictly bounds-checked and the parse must land
    exactly on EOF, so truncated or layout-mismatched files fail loudly
    instead of yielding garbage geometry.
    """
    n = len(data)
    if n < 8:
        raise UnsupportedModelFormat("igmesh: truncated header")
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _IGMESH_MAGIC:
        raise UnsupportedModelFormat("igmesh: bad magic")
    if not 1 <= version <= 4:
        raise UnsupportedModelFormat(f"igmesh: unknown version {version}")
    body_at = 8
    if version >= 4:
        if n < 12:
            raise UnsupportedModelFormat("igmesh: truncated header")
        (flag,) = struct.unpack_from("<I", data, 8)
        body_at = 12
        if flag == 1:
            # Compressed stream: the post-flag payload is one zstd frame
            # over the uncompressed body (see module docstring — verified
            # by round-trip against write_igmesh; a different real-world
            # chunking fails the strict EOF check below).
            try:
                body = zstd.decompress(data[body_at:], max_output_size=1 << 30)
            except zstd.ZstdError as e:
                raise UnsupportedModelFormat(
                    f"igmesh: zstd decompress failed: {e}") from e
            return _parse_igmesh_body(body)
        if flag != 0:
            raise UnsupportedModelFormat(
                f"igmesh: unknown compression flag {flag}")
    return _parse_igmesh_body(data[body_at:])


def _parse_igmesh_body(body: bytes):
    """Parse the igmesh body (everything after magic/version/compression
    flag).  Material names: try the 4-byte-padded layout first, fall back
    to unpadded — both sample assets have empty names (layouts identical),
    and the strict lands-on-EOF check arbitrates for non-empty ones."""
    try:
        return _parse_igmesh_arrays(body, pad_names=True)
    except UnsupportedModelFormat as first_err:
        try:
            return _parse_igmesh_arrays(body, pad_names=False)
        except UnsupportedModelFormat:
            raise first_err from None


def _parse_igmesh_arrays(data: bytes, pad_names: bool):
    n = len(data)
    pos = 0

    def u32():
        nonlocal pos
        if pos + 4 > n:
            raise UnsupportedModelFormat("igmesh: truncated header")
        (v,) = struct.unpack_from("<I", data, pos)
        pos += 4
        return v

    def skip(nbytes, what):
        nonlocal pos
        if pos + nbytes > n:
            raise UnsupportedModelFormat(f"igmesh: truncated {what}")
        pos += nbytes

    num_uv_mappings = u32()
    del num_uv_mappings   # parsed for layout only; uvs are skipped below
    n_mats = u32()
    if n_mats > 4096:
        raise UnsupportedModelFormat("igmesh: implausible material count")
    for _ in range(n_mats):
        slen = u32()
        skip((slen + 3) & ~3 if pad_names else slen, "material name")
    n_expo = u32()   # legacy uv-set expositions; 0 in every v3/v4 file
    if n_expo:
        raise UnsupportedModelFormat(
            f"igmesh: {n_expo} uv-set expositions not supported")

    def f32_array(width, what):
        cnt = u32()
        nbytes = cnt * width * 4
        if pos + nbytes > n:
            raise UnsupportedModelFormat(f"igmesh: truncated {what}")
        arr = np.frombuffer(data, dtype="<f4", count=cnt * width,
                            offset=pos).reshape(cnt, width)
        skip(nbytes, what)
        return arr

    verts = f32_array(3, "vert positions").astype(np.float32)
    f32_array(3, "vert normals")
    f32_array(3, "vert colours")
    f32_array(2, "uv pairs")

    def u32_array(width, what):
        cnt = u32()
        nbytes = cnt * width * 4
        if pos + nbytes > n:
            raise UnsupportedModelFormat(f"igmesh: truncated {what}")
        arr = np.frombuffer(data, dtype="<u4", count=cnt * width,
                            offset=pos).reshape(cnt, width)
        skip(nbytes, what)
        return arr

    raw_tris = u32_array(7, "triangles")    # v0 v1 v2, uv0 uv1 uv2, mat
    raw_quads = u32_array(9, "quads")       # v0..v3, uv0..uv3, mat
    if pos != n:
        raise UnsupportedModelFormat(
            f"igmesh: {n - pos} trailing bytes after quads")

    tris = [raw_tris[:, 0:3].astype(np.int64)]
    mats = [raw_tris[:, 6].astype(np.int64)]
    if len(raw_quads):
        q = raw_quads[:, 0:4].astype(np.int64)
        tris.append(np.stack([q[:, 0], q[:, 1], q[:, 2]], axis=1))
        tris.append(np.stack([q[:, 0], q[:, 2], q[:, 3]], axis=1))
        qm = raw_quads[:, 8].astype(np.int64)
        mats.extend([qm, qm])
    tris_arr = np.concatenate(tris, axis=0)
    mats_arr = np.concatenate(mats, axis=0)
    if len(tris_arr) and tris_arr.max(initial=0) >= len(verts):
        raise UnsupportedModelFormat("igmesh: face index out of range")
    return (verts, tris_arr.astype(np.int32), mats_arr.astype(np.int32))


def write_igmesh(verts, tris, tri_mats=None, material_names=(""),
                 compressed: bool = False, pad_names: bool = True) -> bytes:
    """Encode (verts, tris, tri_mats) as a version-4 .igmesh — the
    Indigo::Mesh::writeToFile equivalent (MeshBuilding.cpp:755 writes the
    reference's sample assets through it).  UV indices are written as the
    vert indices with zero uv mappings, matching the sample assets'
    uv-free layout.  ``compressed`` wraps the body in one zstd frame
    (load_igmesh's compressed read path round-trips it)."""
    verts = np.asarray(verts, "<f4").reshape(-1, 3)
    tris = np.asarray(tris, "<u4").reshape(-1, 3)
    if tri_mats is None:
        tri_mats = np.zeros(len(tris), "<u4")
    tri_mats = np.asarray(tri_mats, "<u4").reshape(-1)
    if isinstance(material_names, str):
        material_names = (material_names,)
    out = [struct.pack("<I", 0)]                 # num_uv_mappings
    out.append(struct.pack("<I", len(material_names)))
    for name in material_names:
        raw = name.encode("utf-8")
        out.append(struct.pack("<I", len(raw)))
        out.append(raw + (b"\0" * ((-len(raw)) % 4) if pad_names else b""))
    out.append(struct.pack("<I", 0))             # uv-set expositions
    out.append(struct.pack("<I", len(verts)) + verts.tobytes())
    out.append(struct.pack("<I", 0))             # normals
    out.append(struct.pack("<I", 0))             # colours
    out.append(struct.pack("<I", 0))             # uv pairs
    tri_rows = np.concatenate(
        [tris, tris, tri_mats[:, None]], axis=1).astype("<u4")
    out.append(struct.pack("<I", len(tri_rows)) + tri_rows.tobytes())
    out.append(struct.pack("<I", 0))             # quads
    body = b"".join(out)
    if compressed:
        body = zstd.compress(body)
    return struct.pack("<III", _IGMESH_MAGIC, 4, 1 if compressed else 0) + body


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def decode_model(url: str, data: bytes):
    """Decode model bytes by URL extension into (verts, tris, tri_mats)
    (ModelLoading.cpp format dispatch parity)."""
    low = url.lower()
    if low.endswith(".bmesh"):
        from substrata_tpu_torch.shared.bmesh import load_bmesh
        return load_bmesh(data).merged_mesh()
    if low.endswith((".gltf", ".glb", ".vrm")):   # vrm is a glb container
        from substrata_tpu_torch.shared.gltf import load_gltf
        return load_gltf(data).merged_mesh()
    if low.endswith(".obj"):
        return load_obj(data)
    if low.endswith(".stl"):
        return load_stl(data)
    if low.endswith(".vox"):
        return load_vox(data)
    if low.endswith(".igmesh"):
        return load_igmesh(data)
    if low.endswith((".sog", ".subvox")):
        raise UnsupportedModelFormat(
            f"{url}: format not supported (sog/subvox are renderer formats)")
    raise UnsupportedModelFormat(f"{url}: unknown model format")

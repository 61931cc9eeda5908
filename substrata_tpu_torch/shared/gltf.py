"""glTF 2.0 geometry loading.

A copy of ``substrata_tpu/shared/gltf.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Parity with the reference's model import path (FormatDecoderGLTF +
gui_client/ModelLoading.cpp): parse .gltf (JSON + external/data-URI
buffers) and .glb (binary container), extract positions/normals/uvs/indices
and per-primitive materials, producing the mesh + physics-shape inputs
(static trimesh or dynamic convex hull, PhysicsWorld.cpp:871-1083 path).

Scope: geometry + material colours/textures + node transforms (flattened).
Skinning/animation import is renderer territory; vertex data is enough for
physics + LOD generation.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT4": 16}


@dataclass
class GLTFPrimitive:
    positions: np.ndarray          # [V, 3] f32 (node transform applied)
    normals: np.ndarray | None
    uvs: np.ndarray | None
    indices: np.ndarray            # [T, 3] i32
    material_index: int = 0


@dataclass
class GLTFMaterial:
    name: str = ""
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    base_color_texture: str = ""
    metallic: float = 0.0
    roughness: float = 0.5
    emissive: tuple = (0.0, 0.0, 0.0)


@dataclass
class GLTFModel:
    primitives: list = field(default_factory=list)
    materials: list = field(default_factory=list)

    def merged_mesh(self):
        """(verts [V,3], tris [T,3], tri_mats [T]) across all primitives."""
        verts, tris, mats = [], [], []
        base = 0
        for p in self.primitives:
            verts.append(p.positions)
            tris.append(p.indices + base)
            mats.append(np.full(len(p.indices), p.material_index, np.int32))
            base += len(p.positions)
        if not verts:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                    np.zeros(0, np.int32))
        return (np.concatenate(verts), np.concatenate(tris),
                np.concatenate(mats))


def _read_buffer(uri: str, base_dir: str, glb_bin: bytes | None) -> bytes:
    if uri is None:
        if glb_bin is None:
            raise ValueError("buffer with no URI outside a GLB container")
        return glb_bin
    if uri.startswith("data:"):
        _, b64 = uri.split(",", 1)
        return base64.b64decode(b64)
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _accessor_data(gltf, buffers, idx) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = buf[offset:offset + stride * count]
        out = np.zeros((count, ncomp), dtype)
        for i in range(ncomp):
            start = i * np.dtype(dtype).itemsize
            out[:, i] = np.frombuffer(
                raw, dtype, count=count,
                offset=start) if stride == np.dtype(dtype).itemsize else \
                np.lib.stride_tricks.as_strided(
                    np.frombuffer(raw[start:], dtype),
                    shape=(count,), strides=(stride,)).copy()
        data = out
    else:
        data = np.frombuffer(buf, dtype, count=count * ncomp,
                             offset=offset).reshape(count, ncomp)
    # Normalised integer attributes.
    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        data = data.astype(np.float32) / info.max
    return data


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = r
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m[:3, :3] = rot * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


def load_gltf_raw(path_or_bytes, base_dir: str | None = None):
    """Parse .gltf/.glb/.vrm down to (gltf_json, buffers) without
    flattening — skeleton/animation import (anim/gltf_import.py) needs the
    raw node/skin/animation tables."""
    glb_bin = None
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
        base_dir = base_dir or "."
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
        base_dir = base_dir or os.path.dirname(os.path.abspath(path_or_bytes))

    if data[:4] == b"glTF":
        # GLB container: header + JSON chunk + optional BIN chunk.
        magic, version, length = struct.unpack("<III", data[:12])
        off = 12
        gltf = None
        while off + 8 <= len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            off += 8
            chunk = data[off:off + clen]
            off += clen + (-clen % 4 if False else 0)
            if ctype == 0x4E4F534A:  # 'JSON'
                gltf = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # 'BIN'
                glb_bin = chunk
    else:
        gltf = json.loads(data.decode("utf-8"))
    if gltf is None:
        raise ValueError("no JSON chunk in GLB")
    if not isinstance(gltf, dict):
        raise ValueError("glTF top-level JSON must be an object")

    buffers = [_read_buffer(b.get("uri"), base_dir, glb_bin)
               for b in gltf.get("buffers", [])]
    return gltf, buffers


def load_gltf(path_or_bytes, base_dir: str | None = None) -> GLTFModel:
    """Load .gltf (JSON) or .glb (binary).  Node hierarchy is flattened into
    world-space primitives."""
    gltf, buffers = load_gltf_raw(path_or_bytes, base_dir)

    materials = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        tex_name = ""
        if "baseColorTexture" in pbr:
            tex_i = pbr["baseColorTexture"]["index"]
            img_i = gltf["textures"][tex_i].get("source")
            if img_i is not None:
                tex_name = gltf["images"][img_i].get("uri", "")
        materials.append(GLTFMaterial(
            name=m.get("name", ""),
            base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
            base_color_texture=tex_name,
            metallic=pbr.get("metallicFactor", 0.0),
            roughness=pbr.get("roughnessFactor", 0.5),
            emissive=tuple(m.get("emissiveFactor", [0, 0, 0]))))
    if not materials:
        materials.append(GLTFMaterial())

    model = GLTFModel(materials=materials)

    def emit_mesh(mesh_idx: int, xform: np.ndarray):
        mesh = gltf["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            pos = _accessor_data(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            posh = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
            pos_w = (posh @ xform.T)[:, :3]
            nrm = None
            if "NORMAL" in attrs:
                nr = _accessor_data(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                nrm = nr @ np.linalg.inv(xform[:3, :3]).T.astype(np.float32)
                lens = np.linalg.norm(nrm, axis=1, keepdims=True)
                nrm = nrm / np.maximum(lens, 1e-9)
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _accessor_data(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
            if "indices" in prim:
                idx = _accessor_data(gltf, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)
            tris = idx.astype(np.int32).reshape(-1, 3)
            model.primitives.append(GLTFPrimitive(
                positions=pos_w, normals=nrm, uvs=uv, indices=tris,
                material_index=prim.get("material", 0)))

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    nodes = gltf.get("nodes", [])

    def walk(node_idx: int, parent: np.ndarray):
        node = nodes[node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], m)
        for c in node.get("children", []):
            walk(c, m)

    roots = scene.get("nodes", list(range(len(nodes))))
    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    if not model.primitives and gltf.get("meshes"):
        # Meshes with no scene graph: emit directly.
        for i in range(len(gltf["meshes"])):
            emit_mesh(i, np.eye(4, dtype=np.float32))
    return model


def physics_shape_for_gltf(model: GLTFModel, dynamic: bool, mass: float = 0.0):
    """ModelLoading parity: dynamic objects get a convex hull of the
    vertices, static objects a trimesh source (PhysicsWorld shape factory
    split, PhysicsWorld.cpp:735-1083)."""
    from substrata_tpu_torch.physics import shapes
    verts, tris, tri_mats = model.merged_mesh()
    if dynamic:
        return shapes.make_convex_hull(verts, mass=mass), None
    return None, (verts, tris, tri_mats)

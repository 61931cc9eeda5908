"""LOD generation: mesh simplification + texture downscaling + LOD-level
selection.

Parity with shared/LODGeneration.{h,cpp} (server MeshLODGenThread + client
use): generate `_lod1` / `_lod2` simplified meshes and downscaled textures
for every model resource, and pick a model's LOD level from camera distance
and projected size (WorldObject::getLODLevel semantics used by
checkForLODChanges, GUIClient.cpp:4373).

A copy of ``substrata_tpu/shared/lod.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import numpy as np


def simplify_mesh(verts: np.ndarray, tris: np.ndarray, target_fraction: float = 0.25,
                  tri_mats: np.ndarray | None = None):
    """Vertex-clustering simplification: snap vertices to a grid whose
    resolution is chosen to hit roughly target_fraction of the triangles,
    then drop degenerate/duplicate triangles.  (The reference uses
    glare-core MeshSimplification / meshoptimizer; vertex clustering is the
    TPU-friendly batch formulation — fully vectorised.)

    Returns (verts', tris', tri_mats').
    """
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    if tri_mats is None:
        tri_mats = np.zeros(len(tris), np.int32)
    if len(tris) == 0:
        return verts, tris.astype(np.int32), tri_mats
    extent = verts.max(axis=0) - verts.min(axis=0)
    diag = float(np.linalg.norm(extent)) or 1.0
    # Grid resolution ~ sqrt relationship between cells and triangle count.
    res = max(2, int(np.cbrt(len(tris) * target_fraction) * 2.0))
    cell = diag / res
    keys = np.floor((verts - verts.min(axis=0)) / cell).astype(np.int64)
    flat = keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791
    uniq, inverse = np.unique(flat, return_inverse=True)
    # Representative vertex per cluster = mean of members.
    sums = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inverse, verts)
    np.add.at(counts, inverse, 1)
    new_verts = (sums / counts[:, None]).astype(np.float32)
    new_tris = inverse[tris]
    # Drop degenerate triangles (two or more corners in one cluster).
    ok = ((new_tris[:, 0] != new_tris[:, 1])
          & (new_tris[:, 1] != new_tris[:, 2])
          & (new_tris[:, 0] != new_tris[:, 2]))
    new_tris = new_tris[ok]
    new_mats = tri_mats[ok]
    # Dedup identical triangles (ignoring winding-preserving rotation).
    if len(new_tris):
        sorted_key = np.sort(new_tris, axis=1)
        packed = (sorted_key[:, 0] << 42) | (sorted_key[:, 1] << 21) | sorted_key[:, 2]
        _, first = np.unique(packed, return_index=True)
        first = np.sort(first)
        new_tris = new_tris[first]
        new_mats = new_mats[first]
    return new_verts, new_tris.astype(np.int32), new_mats


def generate_lod_meshes(verts, tris, tri_mats=None):
    """LODGeneration parity: level 0 = original; level 1 ~ 25%; level 2 ~ 6%."""
    lod1 = simplify_mesh(verts, tris, 0.25, tri_mats)
    lod2 = simplify_mesh(verts, tris, 0.0625, tri_mats)
    return {0: (np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                np.zeros(len(tris), np.int32) if tri_mats is None else tri_mats),
            1: lod1, 2: lod2}


def lod_model_url(base_url: str, level: int) -> str:
    """model URL -> '<name>_lod1.<ext>' (LODGeneration URL scheme)."""
    if level <= 0:
        return base_url
    dot = base_url.rfind(".")
    if dot < 0:
        return f"{base_url}_lod{level}"
    return f"{base_url[:dot]}_lod{level}{base_url[dot:]}"


def downscale_texture(img: np.ndarray, levels: int = 1) -> np.ndarray:
    """Box-filter power-of-two reduction (texture LOD / KTX mip generation
    stand-in)."""
    out = np.asarray(img, np.float32)
    for _ in range(levels):
        h = out.shape[0] & ~1
        w = out.shape[1] & ~1
        out = out[:h, :w]
        out = (out[0::2, 0::2] + out[1::2, 0::2]
               + out[0::2, 1::2] + out[1::2, 1::2]) * 0.25
    return out


def compute_lod_level(aabb_ws_longest_len: float, cam_to_ob_dist: float) -> int:
    """WorldObject::getLODLevel semantics: larger objects hold detail to
    longer range; returns 0, 1 or 2."""
    if aabb_ws_longest_len <= 0:
        return 2
    # Reference uses distance thresholds proportional to object size.
    ratio = cam_to_ob_dist / max(aabb_ws_longest_len, 1e-3)
    if ratio < 20.0:
        return 0
    if ratio < 120.0:
        return 1
    return 2


def compute_texture_lod_level(tex_w: int, tex_h: int, min_dim_at_lod0: int = 1024):
    levels = 0
    d = max(tex_w, tex_h)
    while d > min_dim_at_lod0 and levels < 8:
        d //= 2
        levels += 1
    return levels

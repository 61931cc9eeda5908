"""Server asset pipeline: background LOD + chunk generation.

Parity with server/MeshLODGenThread.{h,cpp} (generate _lod1/_lod2 meshes and
downscaled textures for uploaded model resources) and server/ChunkGenThread
(combined far-LOD chunk meshes for world regions).  Work items queue from
the upload path; a worker thread drains them and stores results back into
the resource manager.

A copy of ``substrata_tpu/server_side/asset_pipeline.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import io
import queue
import struct
import threading
from dataclasses import dataclass

import numpy as np

from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.shared import png
from substrata_tpu_torch.shared.lod import generate_lod_meshes, lod_model_url
from substrata_tpu_torch.shared.resources import ResourceManager


# Simple binary mesh container for pipeline outputs (bmesh-like).
def pack_mesh(verts: np.ndarray, tris: np.ndarray, tri_mats: np.ndarray) -> bytes:
    s = io.BytesIO()
    s.write(b"STME0001")
    s.write(struct.pack("<II", len(verts), len(tris)))
    s.write(np.asarray(verts, np.float32).tobytes())
    s.write(np.asarray(tris, np.int32).tobytes())
    s.write(np.asarray(tri_mats, np.int32).tobytes())
    return s.getvalue()


def unpack_mesh(data: bytes):
    assert data[:8] == b"STME0001"
    nv, nt = struct.unpack_from("<II", data, 8)
    off = 16
    verts = np.frombuffer(data, np.float32, nv * 3, off).reshape(nv, 3)
    off += nv * 12
    tris = np.frombuffer(data, np.int32, nt * 3, off).reshape(nt, 3)
    off += nt * 12
    tri_mats = np.frombuffer(data, np.int32, nt, off)
    return verts.copy(), tris.copy(), tri_mats.copy()


@dataclass
class LODGenItem:
    model_url: str
    kind: str = "mesh"          # "mesh" | "texture"


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tga")


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Resource bytes -> RGB(A) uint8 array (ImageDecoding::decodeImage
    counterpart).  PNG decodes with the standard library (``shared/png.py``:
    the card's machine has no Pillow); other formats go to Pillow where it
    is installed."""
    if data[:8] == png.SIGNATURE:
        return png.decode_png(data)
    try:
        from PIL import Image
    except ImportError:
        kind = {b"\xff\xd8": "JPEG", b"BM": "BMP", b"GI": "GIF", b"RI": "WebP"}.get(
            data[:2], "this image format")
        raise RuntimeError(f"decoding {kind} needs Pillow, which is not installed; "
                           "only PNG decodes without it") from None
    img = Image.open(io.BytesIO(data))
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGB")
    return np.asarray(img)


class MeshLODGenThread(threading.Thread):
    """Background worker: for each queued model resource, generate lod1/lod2
    meshes; for each texture resource, generate per-LOD-level BC1/KTX2
    compressed textures (MeshLODGenThread parity — it drives both
    computeLODModel and generateBasisTexture in the reference).  Textures
    encode on ``device`` (kernel KAC on the card unless the caller asks for
    the CPU)."""

    def __init__(self, resource_manager: ResourceManager, device="cuda"):
        super().__init__(daemon=True)
        self.device = resolve_device(device)
        self.resources = resource_manager
        self.work = queue.Queue()
        self.generated: list[str] = []
        self.errors: list[str] = []
        self._running = True

    def enqueue(self, model_url: str):
        self.work.put(LODGenItem(model_url))

    def enqueue_texture(self, tex_url: str):
        self.work.put(LODGenItem(tex_url, kind="texture"))

    def stop(self):
        self._running = False
        self.work.put(None)
        self.join(timeout=5.0)

    def process_one(self, item: LODGenItem):
        if item.kind == "texture":
            return self.process_one_texture(item)
        data = self.resources.load_resource(item.model_url)
        verts, tris, tri_mats = unpack_mesh(data)
        lods = generate_lod_meshes(verts, tris, tri_mats)
        for level in (1, 2):
            url = lod_model_url(item.model_url, level)
            if not self.resources.is_file_present(url):
                v, t, m = lods[level]
                self.resources.store_resource(url, pack_mesh(v, t, m))
                self.generated.append(url)

    def process_one_texture(self, item: LODGenItem):
        """generateBasisTexture parity: base + _lod1 + _lod2 compressed
        mipmapped textures, stored as .ktx2 resources."""
        from substrata_tpu_torch.shared.texture_compress import (
            generate_compressed_texture, lod_texture_url)
        img = decode_image_bytes(self.resources.load_resource(item.model_url))
        for level in (0, 1, 2):
            url = lod_texture_url(item.model_url, level)
            if not self.resources.is_file_present(url):
                # Base level passes lod_level=0 (== base_lod_level) so the
                # reference's 4096 long-edge clamp + round-up-to-multiple-of-4
                # sizing applies (LODGeneration.cpp:271-320) — lod_level=None
                # would skip sizing and let an untrusted 16k upload reach the
                # BC1 kernel unclamped.
                ktx = generate_compressed_texture(img, lod_level=level, device=self.device)
                self.resources.store_resource(url, ktx)
                self.generated.append(url)

    def run(self):
        while self._running:
            item = self.work.get()
            if item is None:
                break
            try:
                self.process_one(item)
            except Exception as e:
                self.errors.append(f"{item.model_url}: {e}")


class ChunkGenThread(threading.Thread):
    """Combined far-LOD chunk meshes: merge all static object meshes whose
    origin falls in a world grid cell into one heavily simplified mesh per
    chunk (ChunkGenThread parity)."""

    CHUNK_W = 128.0

    def __init__(self, resource_manager: ResourceManager):
        super().__init__(daemon=True)
        self.resources = resource_manager
        self.work = queue.Queue()
        self.generated: list[str] = []
        self.errors: list[str] = []
        self._running = True

    def enqueue(self, world_name: str, chunk_xy: tuple,
                meshes: list):
        """meshes: list of (model_url, ob_to_world 4x4)"""
        self.work.put((world_name, chunk_xy, meshes))

    def stop(self):
        self._running = False
        self.work.put(None)
        self.join(timeout=5.0)

    def process_one(self, world_name, chunk_xy, meshes):
        all_verts, all_tris, all_mats = [], [], []
        base = 0
        for url, m in meshes:
            v, t, tm = unpack_mesh(self.resources.load_resource(url))
            vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], axis=1)
            vw = (vh @ np.asarray(m, np.float32).T)[:, :3]
            all_verts.append(vw)
            all_tris.append(t + base)
            all_mats.append(tm)
            base += len(v)
        if not all_verts:
            return
        verts = np.concatenate(all_verts)
        tris = np.concatenate(all_tris)
        mats = np.concatenate(all_mats)
        from substrata_tpu_torch.shared.lod import simplify_mesh
        sv, st, sm = simplify_mesh(verts, tris, 0.05, mats)
        url = f"chunk_{world_name}_{chunk_xy[0]}_{chunk_xy[1]}.stme"
        self.resources.store_resource(url, pack_mesh(sv, st, sm))
        self.generated.append(url)

    def run(self):
        while self._running:
            item = self.work.get()
            if item is None:
                break
            try:
                self.process_one(*item)
            except Exception as e:
                self.errors.append(str(e))


def _ob_to_world(ob) -> np.ndarray:
    """WorldObject TRS matrix on the host (obToWorldMatrix parity)."""
    q = ob.quat
    x, y, z, w = (float(v) for v in q)
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(ob.scale, np.float64)[None, :]
    m[:3, 3] = np.asarray(ob.pos, np.float64)
    return m


def generate_world_lod_chunks(worlds_state, resources: ResourceManager,
                              world_name: str = "",
                              chunk_w: float = 128.0) -> list:
    """Full ChunkGenThread flow (server/ChunkGenThread.cpp): bucket every
    static mesh object by its chunk cell (floor(centroid / 128), chunk_w=128
    per ChunkGenThread.cpp:47), combine + simplify each bucket into ONE far-
    LOD mesh resource, and write LODChunk records into
    ``worlds_state.lod_chunks`` keyed (world, cx, cy) so workers answer
    QUERY_LOD_CHUNKS and broadcast LOD_CHUNK_UPDATED.

    Returns the list of (re)generated LODChunk records."""
    from substrata_tpu_torch.shared.records import LODChunk

    w = worlds_state.get_world(world_name)
    with worlds_state.lock:
        obs = [(ob.model_url, _ob_to_world(ob), np.asarray(ob.pos))
               for ob in w.objects.values()
               if ob.model_url and resources.is_file_present(ob.model_url)]
    buckets: dict[tuple, list] = {}
    for url, m, pos in obs:
        key = (int(np.floor(pos[0] / chunk_w)),
               int(np.floor(pos[1] / chunk_w)))
        buckets.setdefault(key, []).append((url, m))

    gen = ChunkGenThread(resources)      # reuse the combine+simplify core
    out = []
    for (cx, cy), meshes in sorted(buckets.items()):
        gen.process_one(world_name, (cx, cy), meshes)
        if gen.errors:
            raise RuntimeError("; ".join(gen.errors))
        url = gen.generated[-1]
        chunk = LODChunk(x=cx, y=cy, mesh_url=url, needs_rebuild=False)
        with worlds_state.lock:
            worlds_state.lod_chunks[(world_name, cx, cy)] = chunk
        out.append(chunk)
    return out

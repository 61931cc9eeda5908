"""GPU block-compressed texture generation for the LOD pipeline.

Parity with the reference's basis-universal texture path
(shared/LODGeneration.cpp:265-404 generateBasisTexture +
writeBasisUniversalFile; server MeshLODGenThread drives it;
shared/WorldMaterial.cpp:44-90 derives `<root>_lodN.basis` URLs): every
texture resource gets per-LOD-level GPU-compressed, mipmapped versions the
client can upload directly.

The encode target is BC1 (DXT1, 8 bytes per 4x4 block) in a standard KTX2
container (VK_FORMAT_BC1_*), where the reference emits ETC1S inside .basis.
The host builds the mip chain (a box filter, numpy) and packs every level's
blocks into one [sum_nb, 16, 3] float32 batch; one pinned upload and one
launch of kernel KAC (``kernels/bc1.py``) encode the whole chain, and one
read brings the words back, so a texture costs one dispatch.  The bytes
equal the reference's KTX2 file for the same image.

The reference's per-LOD sizing rules are kept exactly
(LODGeneration.cpp:270-276: base level 4096 max, lod0 1024, lod1 256,
lod2 64; dimensions rounded up to a multiple of 4 for WebGL).

A copy of ``substrata_tpu/shared/texture_compress.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.kernels.bc1 import bc1_encode


# ---------------------------------------------------------------------------
# BC1 block compression (kernel KAC, batched over blocks)
# ---------------------------------------------------------------------------

def encode_blocks(blocks: np.ndarray, device) -> np.ndarray:
    """[nb, 16, 3] float32 host blocks -> [nb, 2] uint32 words: one pinned
    upload, one KAC launch (the twin for the CPU), one read."""
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(blocks, np.float32))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return bc1_encode(t).cpu().numpy().view(np.uint32)


def _to_blocks(img: np.ndarray) -> np.ndarray:
    """[H,W,3] -> [nb,16,3] f32, edge-clamp padded to multiples of 4."""
    h, w = img.shape[:2]
    ph, pw = (-h) % 4, (-w) % 4
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    h, w = img.shape[:2]
    blocks = img.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4)
    return blocks.reshape(-1, 16, 3).astype(np.float32)


def bc1_compress(img: np.ndarray, device="cuda") -> bytes:
    """Encode one RGB(A) uint8 image level to BC1 block bytes."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return encode_blocks(_to_blocks(img), device).astype("<u4").tobytes()


def decode_bc1(data: bytes, w: int, h: int) -> np.ndarray:
    """Reference BC1 decoder (numpy, host) for tests/quality measurement."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    words = np.frombuffer(data, "<u4").reshape(bw * bh, 2)
    c0w, c1w = words[:, 0] & 0xFFFF, words[:, 0] >> 16
    bits = words[:, 1]

    def expand(word):
        r = ((word >> 11) & 31) * 255.0 / 31.0
        g = ((word >> 5) & 63) * 255.0 / 63.0
        b = (word & 31) * 255.0 / 31.0
        return np.stack([r, g, b], axis=-1)

    p0, p1 = expand(c0w), expand(c1w)
    pal = np.stack([p0, p1, (2 * p0 + p1) / 3.0, (p0 + 2 * p1) / 3.0],
                   axis=1)  # [nb,4,3] (c0>c1 mode; encoder guarantees it)
    idx = (bits[:, None] >> (np.arange(16, dtype=np.uint32) * 2)) & 3
    px = pal[np.arange(len(pal))[:, None], idx]          # [nb,16,3]
    out = px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    return out.reshape(bh * 4, bw * 4, 3)[:h, :w].astype(np.uint8)


# ---------------------------------------------------------------------------
# Mip chain
# ---------------------------------------------------------------------------

def mip_chain(img: np.ndarray):
    """Full power-of-two box-filter chain down to 1x1 (dims halve, min 1).
    Returns [(level_img_uint8, w, h), ...] starting at level 0."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    img = img[:, :, :3].astype(np.float32)
    out = [(img.astype(np.uint8), img.shape[1], img.shape[0])]
    cur = img
    w, h = img.shape[1], img.shape[0]
    while w > 1 or h > 1:
        # Pad odd dims by edge-clamp so the box filter stays 2x2.
        hh, ww = cur.shape[:2]
        cur2 = np.pad(cur, ((0, hh % 2), (0, ww % 2), (0, 0)), mode="edge")
        cur = (cur2[0::2, 0::2] + cur2[1::2, 0::2]
               + cur2[0::2, 1::2] + cur2[1::2, 1::2]) * 0.25
        w, h = max(1, w // 2), max(1, h // 2)
        cur = cur[:h, :w]
        out.append((np.clip(np.round(cur), 0, 255).astype(np.uint8), w, h))
    return out


# ---------------------------------------------------------------------------
# KTX2 container
# ---------------------------------------------------------------------------

KTX2_IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"
VK_FORMAT_BC1_RGB_UNORM = 131
VK_FORMAT_BC1_RGB_SRGB = 132
SUPERCOMPRESSION_NONE = 0
SUPERCOMPRESSION_ZLIB = 3


def _bc1_dfd(srgb: bool) -> bytes:
    # One basic Khronos data-format descriptor block for BC1.
    block = struct.pack(
        "<IHH" + "B" * 16,
        0,                      # vendor 0 / descriptor type 0
        2, 40,                  # version, block size (24 + 1 sample * 16)
        128,                    # colorModel KHR_DF_MODEL_BC1A
        1,                      # colorPrimaries BT709
        2 if srgb else 1,       # transferFunction SRGB / LINEAR
        0,                      # flags (alpha straight)
        3, 3, 0, 0,             # texel block dims - 1 (4x4x1x1)
        8, 0, 0, 0, 0, 0, 0, 0,  # bytesPlane
    )
    sample = struct.pack("<HBBBBBBII",
                         0, 63,          # bitOffset, bitLength-1 (64 bits)
                         0,              # channelType 0 = colour
                         0, 0, 0, 0,     # samplePosition
                         0, 0xFFFFFFFF)  # sampleLower/Upper
    body = block + sample
    return struct.pack("<I", 4 + len(body)) + body


def write_ktx2(mip_blocks: list, width: int, height: int,
               srgb: bool = False, supercompress: bool = False) -> bytes:
    """Assemble a KTX2 file from per-level BC1 block bytes (level 0 first).

    Follows the KTX 2.0 spec: 80-byte header, level index, DFD, key/value
    data, then level images stored smallest level FIRST; optional ZLIB
    supercompression (scheme 3) applied per level.
    """
    nlev = len(mip_blocks)
    dfd = _bc1_dfd(srgb)
    kv_entry = b"KTXwriter\x00substrata_tpu ktx2 writer v1\x00"
    kvd = struct.pack("<I", len(kv_entry)) + kv_entry
    kvd += b"\x00" * ((-len(kvd)) % 4)

    header_len = 80
    index_len = nlev * 24
    dfd_off = header_len + index_len
    kvd_off = dfd_off + len(dfd)
    data_start = kvd_off + len(kvd)

    # Level payloads, stored smallest mip first.
    stored = []
    offsets = [0] * nlev
    lengths = [0] * nlev
    raw_lengths = [int(len(b)) for b in mip_blocks]
    pos = data_start
    for lev in range(nlev - 1, -1, -1):
        payload = mip_blocks[lev]
        if supercompress:
            payload = zlib.compress(payload, 6)
        else:
            pad = (-pos) % 8     # mip padding: align to the 8-byte block
            stored.append(b"\x00" * pad)
            pos += pad
        offsets[lev] = pos
        lengths[lev] = len(payload)
        stored.append(payload)
        pos += len(payload)

    header = KTX2_IDENTIFIER + struct.pack(
        "<IIIIIIIII",
        VK_FORMAT_BC1_RGB_SRGB if srgb else VK_FORMAT_BC1_RGB_UNORM,
        1,                       # typeSize
        width, height,
        0, 0, 1,                 # depth, layerCount, faceCount
        nlev,
        SUPERCOMPRESSION_ZLIB if supercompress else SUPERCOMPRESSION_NONE,
    ) + struct.pack("<IIII", dfd_off, len(dfd), kvd_off, len(kvd)) \
      + struct.pack("<QQ", 0, 0)   # no supercompression global data
    index = b"".join(struct.pack("<QQQ", offsets[i], lengths[i],
                                 raw_lengths[i]) for i in range(nlev))
    return header + index + dfd + kvd + b"".join(stored)


def read_ktx2(data: bytes):
    """Parse a KTX2 file back to (meta dict, [level block bytes]) — the
    loader counterpart used by tests and the client texture path."""
    if data[:12] != KTX2_IDENTIFIER:
        raise ValueError("not a KTX2 file")
    (vkfmt, type_size, w, h, depth, layers, faces, nlev, scheme) = \
        struct.unpack_from("<IIIIIIIII", data, 12)
    dfd_off, dfd_len, kvd_off, kvd_len = struct.unpack_from("<IIII", data, 48)
    levels = []
    for i in range(nlev):
        off, ln, raw = struct.unpack_from("<QQQ", data, 80 + i * 24)
        payload = data[off:off + ln]
        if scheme == SUPERCOMPRESSION_ZLIB:
            payload = zlib.decompress(payload)
            if len(payload) != raw:
                raise ValueError("ktx2: level size mismatch after inflate")
        elif scheme != SUPERCOMPRESSION_NONE:
            raise ValueError(f"ktx2: unsupported supercompression {scheme}")
        levels.append(payload)
    meta = dict(vk_format=vkfmt, width=w, height=h, levels=nlev,
                scheme=scheme, faces=faces, type_size=type_size)
    return meta, levels


# ---------------------------------------------------------------------------
# The LOD-pipeline entry point (generateBasisTexture parity)
# ---------------------------------------------------------------------------

_MAX_WH = {None: 4096, 0: 1024, 1: 256, 2: 64}   # LODGeneration.cpp:270-276


def _resize_for_level(img: np.ndarray, lod_level, base_lod_level: int):
    """The reference's sizing: clamp the long edge per level, keep aspect,
    round dims UP to a multiple of 4 (LODGeneration.cpp:318-320)."""
    key = None if lod_level == base_lod_level else lod_level
    max_wh = _MAX_WH[key if key in _MAX_WH else 2]
    h, w = img.shape[:2]
    if w >= h:
        nw = min(w, max_wh)
        nh = max(1, int(round(nw * h / w)))
    else:
        nh = min(h, max_wh)
        nw = max(1, int(round(nh * w / h)))
    nw, nh = (nw + 3) & ~3, (nh + 3) & ~3
    if (nw, nh) == (w, h):
        return img
    # Box-filter halvings to the nearest power-of-two scale, then a
    # bilinear-ish final resample via linear index mapping.
    cur = img.astype(np.float32)
    while cur.shape[1] >= nw * 2 and cur.shape[0] >= nh * 2:
        hh, ww = cur.shape[0] & ~1, cur.shape[1] & ~1
        c = cur[:hh, :ww]
        cur = (c[0::2, 0::2] + c[1::2, 0::2]
               + c[0::2, 1::2] + c[1::2, 1::2]) * 0.25
    yi = np.clip((np.arange(nh) + 0.5) * cur.shape[0] / nh - 0.5,
                 0, cur.shape[0] - 1)
    xi = np.clip((np.arange(nw) + 0.5) * cur.shape[1] / nw - 0.5,
                 0, cur.shape[1] - 1)
    y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, cur.shape[0] - 1)
    x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, cur.shape[1] - 1)
    fy = (yi - y0)[:, None, None]; fx = (xi - x0)[None, :, None]
    out = (cur[y0][:, x0] * (1 - fy) * (1 - fx)
           + cur[y1][:, x0] * fy * (1 - fx)
           + cur[y0][:, x1] * (1 - fy) * fx
           + cur[y1][:, x1] * fy * fx)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def generate_compressed_texture(img: np.ndarray, lod_level=None,
                                base_lod_level: int = 0, srgb: bool = True,
                                supercompress: bool = False, device="cuda") -> bytes:
    """Resize per the reference's LOD rules, build the full mip chain,
    BC1-encode every level in ONE batched device call, and wrap in KTX2.

    This is the generateBasisTexture equivalent: the server asset pipeline
    calls it for each texture resource and LOD level."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    img = img[:, :, :3]
    if lod_level is not None:
        img = _resize_for_level(img, lod_level, base_lod_level)
    mips = mip_chain(img)
    # One dispatch: pack every level's blocks into a single batch.
    blocks = [_to_blocks(m) for m, _, _ in mips]
    counts = [len(b) for b in blocks]
    words = encode_blocks(np.concatenate(blocks, axis=0), device)
    level_bytes = []
    at = 0
    for c in counts:
        level_bytes.append(words[at:at + c].astype("<u4").tobytes())
        at += c
    return write_ktx2(level_bytes, mips[0][1], mips[0][2], srgb=srgb,
                      supercompress=supercompress)


def lod_texture_url(base_url: str, level: int) -> str:
    """Texture URL scheme (WorldMaterial.cpp:44-90 with use_basis=true,
    '.ktx2' standing in for '.basis'): base -> '<root>.ktx2', LOD N ->
    '<root>_lodN.ktx2'."""
    dot = base_url.rfind(".")
    root = base_url[:dot] if dot >= 0 else base_url
    if level <= 0:
        return f"{root}.ktx2"
    return f"{root}_lod{level}.ktx2"


# ---------------------------------------------------------------------------
# Unified texture read path (client side)
# ---------------------------------------------------------------------------

def decode_texture(url: str, data: bytes, level: int = 0) -> "np.ndarray":
    """Decode texture resource bytes to RGBA8 [h, w, 4] by URL extension —
    the client-side read dispatcher (TextureLoading parity): `.basis`
    (reference-server-emitted ETC1S, shared/LODGeneration.cpp:265-404) via
    basis_transcode, `.ktx2` (our own BC1 pipeline output) via
    read_ktx2+decode_bc1, everything else via PIL."""
    low = url.lower()
    if low.endswith(".basis"):
        raise NotImplementedError(
            "decoding .basis textures is not ported yet (ROADMAP.md queue 1, item 9: "
            "shared/basis_transcode.py)")
    if low.endswith(".ktx2"):
        meta, levels = read_ktx2(data)
        if not 0 <= level < len(levels):
            raise ValueError(f"ktx2: level {level} of {len(levels)}")
        w = max(1, meta["width"] >> level)
        h = max(1, meta["height"] >> level)
        rgb = decode_bc1(levels[level], w, h)
        return np.concatenate(
            [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=2)
    import io
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("RGBA")
    out = np.asarray(img)
    if level > 0:
        for _ in range(level):
            hh, ww = out.shape[0] & ~1, out.shape[1] & ~1
            c = out[:hh, :ww].astype(np.float32)
            out = ((c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                    + c[1::2, 1::2]) * 0.25).astype(np.uint8)
    return out

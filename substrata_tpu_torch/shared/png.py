"""PNG decoding and writing with the standard library's zlib.

The reference decodes uploads with Pillow (``substrata_tpu/server_side/
asset_pipeline.py:decode_image_bytes``); the card's machine has no Pillow,
so the port reads PNG itself: 8-bit gray, gray + alpha, RGB, RGBA and
palette images (palette at 1, 2, 4 or 8 bits), not interlaced, every one of
the five row filters.  ``decode_png`` returns what Pillow's
``Image.open(...)`` followed by the reference's ``convert("RGB")`` of any
mode but RGB and RGBA gives: [H, W, 3] uint8, or [H, W, 4] for RGBA.

Rows filtered None, Sub or Up unfilter as numpy vector operations; Average
and Paeth depend on the pixel to the left, so they run a byte loop in
Python (seconds for a large image filtered that way).  ``write_png``
writes 8-bit RGB or RGBA with one filter type for every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}       # colour type -> samples a pixel


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    while off + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        if len(body) != n:
            raise ValueError("png: truncated chunk")
        if zlib.crc32(kind + body) != struct.unpack_from(">I", data, off + 8 + n)[0]:
            raise ValueError(f"png: bad CRC in {kind!r}")
        yield kind, body
        off += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("png: no IEND")


def _paeth_row(raw: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            # Sub: a running sum mod 256 along each byte position of a pixel.
            pad = (-stride) % bpp
            px = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(px, axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prior                                  # uint8 wraps mod 256
        elif ftype == 3:
            cur = np.frombuffer(_average_row(bytearray(line.tobytes()), prior.tobytes(), bpp),
                                np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_paeth_row(bytearray(line.tobytes()), prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"png: bad filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 (gray, gray + alpha, palette, RGB) or
    [H, W, 4] (RGBA)."""
    ihdr, plte, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("png: no IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"png: bad colour type {ctype}")
    if interlace:
        raise ValueError("png: interlaced images are not supported")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"png: bit depth {depth} of colour type {ctype} is not supported")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("png: image data size mismatch")
    px = _unfilter(raw, h, stride, max(1, ch * depth // 8))
    if ctype == 3:
        if plte is None:
            raise ValueError("png: palette image without PLTE")
        if depth < 8:
            idx = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
            px = (idx * (1 << np.arange(depth - 1, -1, -1))).sum(axis=2)
        return plte[px.reshape(h, w)]
    img = px.reshape(h, w, ch)
    if ctype in (0, 4):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return img.copy()


def write_png(img: np.ndarray, filter_type: int = 1, level: int = 6) -> bytes:
    """[H, W, 3 or 4] uint8 -> PNG bytes; every row filtered with
    ``filter_type`` 0 (None), 1 (Sub) or 2 (Up)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = img.shape
    ctype = {3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch)
    if filter_type == 0:
        body = rows
    elif filter_type == 1:
        body = rows.copy()
        body[:, ch:] = rows[:, ch:] - rows[:, :-ch]
    elif filter_type == 2:
        body = rows.copy()
        body[1:] = rows[1:] - rows[:-1]
    else:
        raise ValueError(f"write_png: filter {filter_type} is not written")
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), body], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))

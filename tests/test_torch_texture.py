"""substrata_tpu_torch.shared.texture_compress and kernel KAC's twin against
the reference.

KAC's twin (``kernels/bc1.py:bc1_encode_plain``) gives the JITTED
reference's words (``_bc1_kernel``) exactly, with no block allowed to
differ: seeded random blocks (float and integer), gradients, flat blocks,
two-colour blocks and blocks whose pixels sit on the midpoints between
palette entries, at nb = 1, 64 and 4,096, and every block of a 300 x 512
image's mip chain in one call.  The twin repeats XLA's folded quantiser
constants, its fma chains and its first-index argmin (the module's
docstring), so no reduction order is left to chance.  Then the host half
(mip chain, sizing, KTX2 container) and ``generate_compressed_texture``
byte for byte at every LOD level, zlib on and off, the reference's
tests/test_texture_compress.py scenarios on the port, and the PNG reader
against Pillow."""

import io
import struct

import numpy as np
import pytest
import torch

from substrata_tpu.shared import texture_compress as jtc
from substrata_tpu_torch.kernels.bc1 import bc1_encode, bc1_encode_plain
from substrata_tpu_torch.shared import png
from substrata_tpu_torch.shared import texture_compress as tc
from substrata_tpu_torch.shared.texture_compress import (
    VK_FORMAT_BC1_RGB_SRGB, VK_FORMAT_BC1_RGB_UNORM, decode_bc1, lod_texture_url, mip_chain,
    read_ktx2, write_ktx2)

torch.set_num_threads(2)


def block_corpus(rng, nb):
    """The kinds of blocks KAC meets, nb of each, [kinds * nb, 16, 3]."""
    t = np.linspace(0.0, 1.0, 16)[None, :, None]
    a = rng.uniform(0, 255, (nb, 1, 3))
    b = rng.uniform(0, 255, (nb, 1, 3))
    two = rng.integers(0, 2, (nb, 16, 1))
    ties = np.array([0.0, 42.5, 85.0, 127.5, 170.0, 212.5, 255.0])
    kinds = [
        rng.uniform(0, 255, (nb, 16, 3)),                       # random floats
        np.round(rng.uniform(0, 255, (nb, 16, 3))),             # random pixels
        np.round(a + (b - a) * t),                              # gradients
        np.repeat(np.round(a), 16, axis=1),                     # flat (w0 == w1)
        np.round(np.where(two, a, b)),                          # two colours
        ties[rng.integers(0, len(ties), (nb, 16, 3))],          # palette midpoints
        np.clip(np.round(a + rng.normal(0, 4, (nb, 16, 3))), 0, 255),   # photo-like
    ]
    return np.concatenate(kinds).astype(np.float32)


def ref_words(blocks):
    return np.asarray(jtc._bc1_kernel()(blocks)).astype(np.uint32)


def port_words(blocks):
    return bc1_encode(torch.from_numpy(blocks)).numpy().view(np.uint32)


@pytest.mark.parametrize("nb", [1, 64, 4096])
def test_kac_twin_exact_against_jitted_reference(nb):
    rng = np.random.default_rng(nb)
    blocks = block_corpus(rng, nb)
    for kind in np.split(blocks, 7):     # each kind at its own nb, as one call
        np.testing.assert_array_equal(port_words(kind), ref_words(kind))


def test_kac_twin_exact_on_a_mip_chain():
    """All blocks of a 300 x 512 image's chain in one call (12,857 blocks)."""
    img = photo(300, 512, seed=3)
    blocks = np.concatenate([tc._to_blocks(m) for m, _, _ in mip_chain(img)])
    assert len(blocks) == 12_857
    np.testing.assert_array_equal(port_words(blocks), ref_words(blocks))


def test_kac_wrapper_takes_the_twin_on_the_cpu():
    from substrata_tpu_torch.kernels import bc1
    blocks = block_corpus(np.random.default_rng(9), 8)
    before = bc1.launches
    out = bc1_encode(torch.from_numpy(blocks))
    assert bc1.launches == before
    assert out.dtype == torch.int32 and out.shape == (len(blocks), 2)
    assert torch.equal(out, bc1_encode_plain(torch.from_numpy(blocks)))


def photo(h, w, seed=0):
    """Smooth gradients plus noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 255, y / h * 255, (x + y) / (w + h) * 255], axis=-1)
    img += rng.uniform(-8, 8, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(300, 512), (64, 16), (10, 7), (1, 1)])
def test_mip_chain_and_blocks_equal(shape):
    img = photo(*shape, seed=shape[0])
    ours, ref = mip_chain(img), jtc.mip_chain(img)
    assert len(ours) == len(ref)
    for (a, aw, ah), (b, bw, bh) in zip(ours, ref):
        assert (aw, ah) == (bw, bh)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tc._to_blocks(a), jtc._to_blocks(b))


@pytest.mark.parametrize("lod_level", [0, 1, 2, 3])
def test_resize_for_level_equal(lod_level):
    img = photo(300, 1100, seed=lod_level)
    np.testing.assert_array_equal(tc._resize_for_level(img, lod_level, 0),
                                  jtc._resize_for_level(img, lod_level, 0))


@pytest.mark.parametrize("supercompress", [False, True])
def test_ktx2_writer_and_reader_equal(supercompress):
    rng = np.random.default_rng(4)
    levels = [rng.integers(0, 256, n * 8, np.uint8).tobytes() for n in (64, 16, 4, 1, 1)]
    ours = write_ktx2(levels, 32, 32, srgb=True, supercompress=supercompress)
    ref = jtc.write_ktx2(levels, 32, 32, srgb=True, supercompress=supercompress)
    assert ours == ref
    assert read_ktx2(ours) == jtc.read_ktx2(ref)


@pytest.mark.parametrize("supercompress", [False, True])
@pytest.mark.parametrize("lod_level", [None, 0, 1, 2])
def test_generate_compressed_texture_bytes_equal(lod_level, supercompress):
    img = photo(300, 512, seed=7)
    ours = tc.generate_compressed_texture(img, lod_level=lod_level,
                                          supercompress=supercompress, device="cpu")
    ref = jtc.generate_compressed_texture(img, lod_level=lod_level,
                                          supercompress=supercompress)
    assert ours == ref


def test_decode_texture_ktx2_equal_and_basis_names_its_item():
    data = tc.generate_compressed_texture(photo(64, 48), device="cpu")
    for level in (0, 2):
        np.testing.assert_array_equal(tc.decode_texture("a.ktx2", data, level),
                                      jtc.decode_texture("a.ktx2", data, level))
    with pytest.raises(NotImplementedError, match="basis_transcode"):
        tc.decode_texture("a.basis", b"", 0)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tc.generate_compressed_texture(photo(8, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        tc.bc1_compress(photo(8, 8))


# --- tests/test_texture_compress.py's scenarios on the port ------------------

def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def compress(img):
    return tc.bc1_compress(img, device="cpu")


def test_bc1_flat_block_exact():
    img = np.full((4, 4, 3), 87, np.uint8)
    out = decode_bc1(compress(img), 4, 4)
    assert np.abs(out.astype(int) - 87).max() <= 4


def test_bc1_two_colour_block():
    img = np.zeros((4, 4, 3), np.uint8)
    img[:, 2:] = 255
    out = decode_bc1(compress(img), 4, 4)
    assert np.abs(out[:, :2].astype(int)).max() <= 8
    assert np.abs(out[:, 2:].astype(int) - 255).max() <= 8


def test_bc1_gradient_quality():
    x = np.linspace(0, 255, 64)
    img = np.stack(np.broadcast_arrays(x[None, :], x[:, None], 128.0 * np.ones((64, 64))),
                   axis=-1).astype(np.uint8)
    assert psnr(img, decode_bc1(compress(img), 64, 64)) > 32.0


def test_bc1_photo_like_quality():
    rng = np.random.default_rng(0)
    low = rng.uniform(0, 255, (9, 9, 3))
    img = np.kron(low, np.ones((8, 8, 1)))[:64, :64]
    img = (img + rng.normal(0, 6, img.shape)).clip(0, 255).astype(np.uint8)
    assert psnr(img, decode_bc1(compress(img), 64, 64)) > 28.0


def test_bc1_nonmultiple_of_4_dims():
    img = np.random.default_rng(1).integers(0, 256, (10, 7, 3), np.uint8)
    data = compress(img)
    assert len(data) == ((10 + 3) // 4) * ((7 + 3) // 4) * 8
    assert decode_bc1(data, 7, 10).shape == (10, 7, 3)


def test_mip_chain_dims():
    mips = mip_chain(np.zeros((64, 16, 3), np.uint8))
    assert [(w, h) for _, w, h in mips] == [
        (16, 64), (8, 32), (4, 16), (2, 8), (1, 4), (1, 2), (1, 1)]


@pytest.mark.parametrize("supercompress", [False, True])
def test_ktx2_roundtrip(supercompress):
    img = np.random.default_rng(2).integers(0, 256, (32, 32, 3), np.uint8)
    mips = mip_chain(img)
    blocks = [compress(m) for m, _, _ in mips]
    data = write_ktx2(blocks, 32, 32, srgb=False, supercompress=supercompress)
    meta, levels = read_ktx2(data)
    assert meta["vk_format"] == VK_FORMAT_BC1_RGB_UNORM
    assert meta["width"] == 32 and meta["height"] == 32
    assert meta["levels"] == len(mips) == 6
    assert levels == blocks
    if not supercompress:
        offs = [struct.unpack_from("<QQQ", data, 80 + i * 24)[0]
                for i in range(meta["levels"])]
        assert all(o % 8 == 0 for o in offs)
        assert offs == sorted(offs, reverse=True)


def test_generate_compressed_texture_lod_sizing():
    img = np.zeros((256, 512, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, 512)[None, :]
    meta, levels = read_ktx2(tc.generate_compressed_texture(img, lod_level=2, device="cpu"))
    assert meta["width"] == 64 and meta["height"] == 32
    assert meta["vk_format"] == VK_FORMAT_BC1_RGB_SRGB
    assert meta["levels"] == 7
    out = decode_bc1(levels[0], 64, 32)
    assert psnr(np.linspace(0, 255, 64)[None, :, None] * np.array([1.0, 0, 0])
                * np.ones((32, 64, 3)), out) > 25.0
    meta1, _ = read_ktx2(tc.generate_compressed_texture(img, lod_level=1, device="cpu"))
    assert meta1["width"] == 256 and meta1["height"] == 128
    metab, _ = read_ktx2(tc.generate_compressed_texture(img, device="cpu"))
    assert metab["width"] == 512 and metab["height"] == 256


def test_lod_texture_url_scheme():
    assert lod_texture_url("tex_abc.png", 0) == "tex_abc.ktx2"
    assert lod_texture_url("tex_abc.png", 1) == "tex_abc_lod1.ktx2"
    assert lod_texture_url("noext", 2) == "noext_lod2.ktx2"


# --- The PNG reader against Pillow -------------------------------------------

def pillow_png(img, mode, **kw):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


def pillow_decode(data):
    """The reference's decode_image_bytes."""
    from PIL import Image
    im = Image.open(io.BytesIO(data))
    if im.mode not in ("RGB", "RGBA"):
        im = im.convert("RGB")
    return np.asarray(im)


@pytest.mark.parametrize("mode,kw", [
    ("RGB", {}), ("RGBA", {}), ("L", {}), ("LA", {}), ("P", {}), ("RGB", {"optimize": True}),
    ("P", {"bits": 4}), ("P", {"bits": 1}), ("RGB", {"compress_level": 0})])
def test_png_decode_equals_pillow(mode, kw):
    img = photo(37, 53, seed=11)
    if mode == "RGBA":
        img = np.concatenate([img, img[:, :, :1]], axis=2)
    if mode == "P" and "bits" in kw:
        from PIL import Image
        pal = Image.fromarray(img).quantize(colors=1 << kw.pop("bits"))
        buf = io.BytesIO()
        pal.save(buf, format="PNG", **kw)
        data = buf.getvalue()
    else:
        data = pillow_png(img, mode, **kw)
    np.testing.assert_array_equal(png.decode_png(data), pillow_decode(data))


@pytest.mark.parametrize("filter_type", [0, 1, 2])
def test_png_writer_round_trips_through_pillow(filter_type):
    img = photo(29, 31, seed=filter_type)
    data = png.write_png(img, filter_type=filter_type)
    np.testing.assert_array_equal(pillow_decode(data), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_png_every_filter_type():
    """Rows filtered 0-4 by hand (Average and Paeth included)."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (5, 6, 3), np.uint8)
    rows = img.reshape(5, 18).astype(np.int64)
    raw = []
    for y in range(5):
        f, cur = y % 5, rows[y]
        prior = rows[y - 1] if y else np.zeros(18, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        if f == 3:
            pred = (left + prior) // 2
        elif f == 4:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        else:
            pred = [0, left, prior][f]
        raw.append(np.concatenate([[f], (cur - pred) % 256]).astype(np.uint8))
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 5, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(raw).tobytes()))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(pillow_decode(data), img)

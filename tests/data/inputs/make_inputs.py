"""Write the image files of every kind the port's readers take beyond
baseline JPEG and 8-bit PNG, with what Pillow makes of them, for the card's
host, which has no Pillow.

    python tests/data/inputs/make_inputs.py     # needs Pillow; rewrites the folder

Writes, beside this script, files of at least 256x256 (``cli.train``'s
crop) of smooth numpy-made pixels: progressive JPEGs at 4:2:0 and 4:4:4, a
CMYK JPEG (Pillow's, Adobe transform 0), and PNGs Pillow writes (palette,
gray+alpha, 16-bit gray, 1-bit) or cannot write, written here by hand
(interlaced RGB, 16-bit RGB, 2- and 4-bit gray, an interlaced 4-bit
palette with indices past its PLTE, 16-bit gray+alpha); a 768x512
progressive q90 JPEG of ``chip_smoke.py::textured_rgb`` (seed 5); and
WebPs Pillow writes: lossy, lossy with alpha (``VP8X``, ``ALPH``,
``VP8 ``), a lossless 4-colour palette (pixels bundled four a byte) and a
lossless noisy one at the kind files' size, and a 768x512 q90 lossy file
of ``webp_textured`` with its lossless twin; and two lossy WebPs of
encoder settings Pillow's ``save`` cannot ask for, written through
``libwebp_encode`` (the simple loop filter at sharpness 3, the normal one
at sharpness 6).  And the files of slice 18 (``TAIL_FILES``,
``tail_files``): BMPs at 256x260 (a core-header 8-bit palette, 4- and
1-bit palettes, RLE8 and RLE4 with a delta escape, 16-bit ``BI_RGB``,
5-6-5 bitfields) and a 128x128 one of alpha bitfields; TIFFs at 96x80
that Pillow writes (uncompressed, LZW, Deflate with alpha, PackBits gray,
palette, 16-bit gray, CMYK, bilevel, BigTIFF) or that ``write_tiff``
writes (tiled planar big-endian LZW with differencing, 16-bit
differencing under old-style Deflate, premultiplied alpha, a 4-bit
palette under PackBits, a tiled 16-bit WhiteIsZero BigTIFF, a rotated
WhiteIsZero one) and a 768x512 LZW one with differencing
(``textured_lzw.tif``); Pillow's GIFs (interlaced, animated, a gray ramp
table, a first frame at an offset with transparency); animated WebPs
(lossy, lossless with alpha, a first frame offset on a wider canvas); and
JPEGs at 262x270 that Pillow writes (``keep_rgb``) or ``encode_jpeg``
writes (RGB by component ids, YCCK, 4:4:0, 4:1:1, chroma factors other
than 1x1).  Then ``inputs.json``: for
each file the sha256 of Pillow's ``Image.open(path).convert("RGB")``
bytes, their shape, Pillow's mode and version, and libwebp's version for a
WebP.  ``tests/test_torch_image_kinds.py`` holds the pixels to the hashes
where Pillow is installed, and ``chip_smoke.py`` phases 22, 23 and 24
hold the port's decoders to them on the card.

``write_png``, ``write_bmp`` (with ``rle_codes``), ``write_tiff`` (with
``lzw_tiff`` and ``packbits``), ``write_gif`` (with ``lzw_gif``) and
``encode_jpeg`` write the kinds from samples; the tests import them.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import hashlib
import io
import json
import lzma
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
SIZE = (262, 270)  # (H, W) of the kind files: past the 256 crop, not a multiple of 8
TEXTURED = (512, 768)


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """(h, stride) unfiltered bytes as filtered rows, each behind its
    filter byte: the first ten with filters (first + y) % 5, the rest with
    Paeth (the smallest files)."""
    x = rows.astype(np.int64)
    above = np.vstack([np.zeros((1, x.shape[1]), np.int64), x[:-1]])
    left = np.hstack([np.zeros((x.shape[0], bpp), np.int64), x[:, :-bpp]])
    corner = np.hstack([np.zeros((x.shape[0], bpp), np.int64), above[:, :-bpp]])
    p = left + above - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - above), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, above, corner))
    preds = np.stack([np.zeros_like(x), left, above, (left + above) >> 1, paeth])
    y = np.arange(x.shape[0])
    kinds = np.where(y < 10, (first + y) % 5, 4)
    out = (x - preds[kinds, np.arange(x.shape[0])]) & 0xFF
    return np.hstack([kinds[:, None], out]).astype(np.uint8).tobytes()


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, channels) samples as (h, stride) bytes: 16-bit big endian,
    sub-byte samples from each byte's high bit."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def write_png(samples: np.ndarray, depth: int, colour: int, interlace: int = 0,
              palette: bytes = b"", seed: int = 0) -> bytes:
    """A PNG of (h, w, channels) integer samples at ``depth`` bits,
    colour type ``colour``, Adam7-interlaced or not, with ``palette`` as
    its PLTE; the first rows' filters cycle through the five from
    ``seed``."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[colour] * depth // 8)
    raw = b"".join(_filtered(_packed(p, depth), bpp, seed + i)
                   for i, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),))
                   if (p := samples[y0::dy, x0::dx]).size)
    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
            + (chunk(b"PLTE", palette) if palette else b"")
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def smooth(h: int, w: int, seed: int, channels: int = 3, levels: int = 256,
           noise: float = 0.0, period: float = 1.0) -> np.ndarray:
    """(h, w, channels) integer samples in [0, levels): waves ``period``
    times longer than ~25 pixels, and ``noise`` times uniform noise,
    numpy-made from ``seed``."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / period
    waves = [0.5 + 0.35 * np.sin(xx / (23.0 + 7 * c) + seed + c) * np.cos(yy / (31.0 - 5 * c))
             for c in range(channels)]
    img = np.stack(waves, -1) + noise * rng.rand(h, w, channels)
    return np.clip(np.floor(img * levels), 0, levels - 1).astype(np.int64)


def wide(samples: np.ndarray) -> np.ndarray:
    """8-bit samples as 16-bit ones whose high byte they are and whose low
    byte is another function of them (37 v mod 256), so that a reader that
    took the low byte would give other pixels."""
    return samples * 256 + samples * 37 % 256


def kind_files() -> dict:
    """name -> bytes of each PNG and JPEG kind file."""
    from PIL import Image

    h, w = SIZE
    rgb = smooth(h, w, seed=1, noise=0.02).astype(np.uint8)

    def pillow(im, **kwargs) -> bytes:
        buf = io.BytesIO()
        im.save(buf, **kwargs)
        return buf.getvalue()

    palette = bytes(smooth(1, 11, seed=7).astype(np.uint8).ravel())  # 11 entries
    return {
        "progressive_420.jpg": pillow(Image.fromarray(rgb), format="JPEG", quality=80,
                                      progressive=True, subsampling=2),
        "progressive_444.jpg": pillow(Image.fromarray(smooth(h, w, seed=2, noise=0.02).astype(np.uint8)),
                                      format="JPEG", quality=80, progressive=True, subsampling=0),
        "cmyk.jpg": pillow(Image.fromarray(smooth(h, w, seed=3, noise=0.02).astype(np.uint8))
                           .convert("CMYK"),
                           format="JPEG", quality=80),
        "interlaced_rgb.png": write_png(smooth(h, w, seed=4, period=4), 8, 2, interlace=1),
        "palette.png": pillow(Image.fromarray(smooth(h, w, seed=5, period=4).astype(np.uint8))
                              .convert("P", palette=Image.Palette.ADAPTIVE, colors=64),
                              format="PNG"),
        "gray_alpha.png": pillow(Image.fromarray(smooth(h, w, seed=6, channels=2, period=4)
                                                 .astype(np.uint8),
                                                 "LA"), format="PNG"),
        "rgb16.png": write_png(wide(smooth(h, w, seed=7, period=4)), 16, 2),
        "gray16.png": pillow(Image.fromarray(smooth(h, w, seed=8, channels=1, levels=600, period=4)[..., 0]
                                             .astype(np.uint16)), format="PNG"),
        "gray1.png": pillow(Image.fromarray(smooth(h, w, seed=9, channels=1)[..., 0]
                                            .astype(np.uint8)).convert("1"), format="PNG"),
        "gray2.png": write_png(smooth(h, w, seed=10, channels=1, levels=4), 2, 0),
        "gray4.png": write_png(smooth(h, w, seed=11, channels=1, levels=16), 4, 0),
        "palette4_interlaced.png": write_png(smooth(h, w, seed=12, channels=1, levels=16, period=2), 4,
                                             3,
                                             interlace=1, palette=palette),
        "gray_alpha16.png": write_png(wide(smooth(h, w, seed=13, channels=2, period=4)), 16, 4),
    }


def webp_textured() -> np.ndarray:
    """(512, 768, 3) uint8: smooth waves, fine stripes and impulse noise on
    one pixel in twenty, textured enough that a q90 WebP of it carries many
    coefficients, and sparse enough that its lossless twin stays near
    300 kB."""
    h, w = TEXTURED
    rng = np.random.RandomState(15)
    img = smooth(h, w, seed=15, period=2) + np.round(12 * np.sin(np.arange(w) / 1.7))[None, :, None]
    img += np.where(rng.rand(h, w, 1) < 0.05, rng.randint(-40, 41, (h, w, 3)), 0)
    return np.clip(img, 0, 255).astype(np.uint8)


# indices of WebPConfig's fields (libwebp's encode.h; ints but quality)
_WEBP_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type")


def _libwebp() -> ctypes.CDLL:
    """The libwebp that Pillow's wheel bundles (with its libsharpyuv), else
    the system's."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    found = glob.glob(os.path.join(libs, "libwebp-*"))
    name = found[0] if found else ctypes.util.find_library("webp")
    if not name:
        raise RuntimeError("no libwebp to encode with")
    return ctypes.CDLL(name)


def libwebp_encode(rgb: np.ndarray, quality: float, **fields: int) -> bytes:
    """A lossy WebP of (h, w, 3) uint8 ``rgb`` by libwebp's advanced API,
    with ``fields`` of its WebPConfig set (``filter_type`` 0 for the simple
    loop filter, ``filter_sharpness``, ``segments``, ...): settings that
    Pillow's ``save`` does not pass on."""
    lib = _libwebp()
    abi = 0x0200  # libwebp checks the major version alone
    config = (ctypes.c_int32 * 64)()  # WebPConfig, with room to spare
    if not lib.WebPConfigInitInternal(config, 0, ctypes.c_float(quality), abi):
        raise RuntimeError("WebPConfigInit failed")
    for name, value in fields.items():
        config[_WEBP_CONFIG.index(name)] = value
    if not lib.WebPValidateConfig(config):
        raise ValueError(f"libwebp refuses {fields}")
    picture = (ctypes.c_uint8 * 1024)()  # WebPPicture, with room to spare
    writer = (ctypes.c_uint8 * 64)()  # WebPMemoryWriter
    if not lib.WebPPictureInitInternal(picture, abi):
        raise RuntimeError("WebPPictureInit failed")
    h, w, _ = rgb.shape
    ints = ctypes.cast(picture, ctypes.POINTER(ctypes.c_int32))
    ints[2], ints[3] = w, h  # width, height (after use_argb and colorspace)
    pixels = np.ascontiguousarray(rgb, np.uint8)
    lib.WebPMemoryWriterInit(writer)
    try:
        if not lib.WebPPictureImportRGB(picture, pixels.ctypes.data_as(ctypes.c_void_p), 3 * w):
            raise RuntimeError("WebPPictureImportRGB failed")
        pointers = ctypes.cast(picture, ctypes.POINTER(ctypes.c_void_p))
        pointers[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value  # writer
        pointers[13] = ctypes.addressof(writer)  # custom_ptr
        if not lib.WebPEncode(config, picture):
            raise RuntimeError(f"WebPEncode failed ({ints[34]})")
        mem = ctypes.cast(writer, ctypes.POINTER(ctypes.c_void_p))
        return ctypes.string_at(mem[0], mem[1])
    finally:
        lib.WebPMemoryWriterClear(writer)
        lib.WebPPictureFree(picture)


def webp_files() -> dict:
    """name -> bytes of each WebP file."""
    from PIL import Image

    h, w = SIZE

    def pillow(im, **kwargs) -> bytes:
        buf = io.BytesIO()
        im.save(buf, format="WEBP", **kwargs)
        return buf.getvalue()

    four = np.array([[20, 40, 200], [230, 210, 30], [90, 160, 90], [250, 250, 250]], np.uint8)
    noisy = smooth(h, w, seed=17, period=2) + np.random.RandomState(17).randint(-2, 3, (h, w, 3))
    rgb = {seed: smooth(h, w, seed=seed, noise=0.3).astype(np.uint8) for seed in (19, 20)}
    textured = webp_textured()
    return {
        "webp_lossy.webp": pillow(Image.fromarray(smooth(h, w, seed=14, noise=0.03)
                                                  .astype(np.uint8)), quality=75),
        "webp_lossy_alpha.webp": pillow(Image.fromarray(smooth(h, w, seed=16, channels=4,
                                                               noise=0.01).astype(np.uint8),
                                                        "RGBA"), quality=60, alpha_quality=80),
        "webp_palette.webp": pillow(Image.fromarray(four[smooth(h, w, seed=18, channels=1,
                                                                levels=4)[..., 0]]),
                                    lossless=True),
        "webp_noise.webp": pillow(Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8)),
                                  lossless=True),
        "textured_lossy.webp": pillow(Image.fromarray(textured), quality=90),
        "textured_lossless.webp": pillow(Image.fromarray(textured), lossless=True),
        "webp_simple_filter.webp": libwebp_encode(rgb[19], 50, filter_type=0, filter_sharpness=3),
        "webp_sharpness.webp": libwebp_encode(rgb[20], 50, filter_sharpness=6),
    }


# ---- slice 18: BMP, TIFF, GIF, animated WebP and JPEG kinds Pillow
# cannot (or can) write

def write_bmp(samples: np.ndarray, bits: int, compression: int = 0, palette: bytes = b"",
              masks=None, header: int = 40, top_down: bool = False, rle: bytes = b"") -> bytes:
    """A BMP of (h, w) indices (``bits`` 1, 4 or 8, with ``palette`` in
    the header's entry size: 3 bytes for the 12-byte core header, else 4)
    or (h, w) integer pixels (16 and 32 bits, packed already); ``rle`` the
    RLE8/RLE4 codes in place of rows; ``masks`` the bitfields, written
    after a 40-byte header or inside a longer one."""
    h, w = samples.shape[:2]
    if rle:
        pixels = rle
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits <= 8:
            bitsarr = (samples[..., None].astype(np.int64) >> np.arange(bits - 1, -1, -1)) & 1
            rows = np.packbits(bitsarr.reshape(h, -1).astype(np.uint8), axis=1)
        else:
            rows = samples.astype("<u4").view(np.uint8).reshape(h, w, 4)[..., :bits // 8]
            rows = rows.reshape(h, -1)
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        pixels = (padded if top_down else padded[::-1]).tobytes()
    colors = len(palette) // (3 if header == 12 else 4)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                           len(pixels), 2835, 2835, colors, 0)
        fields = struct.pack("<IIII", *(list(masks or ()) + [0] * 4)[:4])
        info += fields[:header - 40] + bytes(max(0, header - 56))
        if header == 40 and masks:
            info += struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(palette)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + palette + pixels


def rle_codes(idx: np.ndarray, rle4: bool, delta_row: int = -1) -> bytes:
    """RLE8 (or RLE4) codes of (h, w) indices, bottom row first: runs of
    3 or more equal pixels (4 or more alternating ones for RLE4) as
    encoded runs, the others as absolute runs (an even count for RLE4)
    padded to 16 bits, lone pixels as runs of one, an end of line after
    each row and an end of bitmap last.  In row ``delta_row`` (file order)
    a delta escape skips 3 of the last 8 pixels: written ``00 02 09 09 03
    00``, as Pillow's decoder reads a delta (it skips the two bytes after
    the escape and takes the next two as the move), so the skipped pixels
    are index 0."""
    out = bytearray()
    w = idx.shape[1]

    def encode(row, x, end):
        while x < end:
            a, b = row[x], row[x + 1] if x + 1 < end else 0
            n = 1
            while x + n < end and n < 255 and row[x + n] == (b if rle4 and n % 2 else a):
                n += 1
            if n >= (4 if rle4 else 3):
                out.extend((n, (a << 4 | b) if rle4 else a))
                x += n
                continue
            j = x
            while j < end and j - x < 250 and not all(
                    j + i < end and row[j + i] == row[j + i % 2] for i in range(4 if rle4 else 3)):
                j += 1
            n = (j - x) & ~1 if rle4 else j - x
            if n < 3:
                for v in row[x:x + max(n, 1)]:
                    out.extend((1, v << 4 if rle4 else v))
                x += max(n, 1)
                continue
            vals = row[x:x + n]
            body = bytes(vals[i] << 4 | vals[i + 1] for i in range(0, n, 2)) if rle4 else bytes(vals)
            out.extend((0, n))
            out.extend(body + bytes(len(body) % 2))
            x += n

    for r, row in enumerate(idx[::-1].tolist()):
        if r == delta_row:
            encode(row, 0, w - 8)
            out.extend((0, 2, 9, 9, 3, 0))
            encode(row, w - 5, w)
        else:
            encode(row, 0, w)
        out.extend((0, 0))
    return bytes(out + bytes((0, 1)))


def bmp_files() -> dict:
    """name -> bytes of each BMP kind (256x260: past cli.train's crop)."""
    h, w = 260, 256
    rng = np.random.RandomState(21)
    pal = smooth(1, 256, seed=22).astype(np.uint8)[0]  # 256 colours

    def entries(n, size=4):
        return b"".join(bytes((b, g, r)) + bytes(size - 3) for r, g, b in pal[:n].tolist())

    idx8 = smooth(h, w, seed=23, channels=1, levels=200, period=3)[..., 0]
    idx4 = smooth(h, w, seed=24, channels=1, levels=16, period=2)[..., 0]
    idx4 = np.where(rng.rand(h, w) < 0.02, rng.randint(0, 16, (h, w)), idx4)
    idx1 = (smooth(h, w, seed=25, channels=1, levels=2)[..., 0])
    run8 = smooth(h, w, seed=26, channels=1, levels=12, period=4)[..., 0]
    run8 = np.where(rng.rand(h, w) < 0.01, rng.randint(0, 256, (h, w)), run8)
    rgb = smooth(h, w, seed=27, levels=32)
    v555 = (rgb[..., 0] << 10) | (rgb[..., 1] << 5) | rgb[..., 2]
    g6 = smooth(h, w, seed=28, channels=1, levels=64)[..., 0]
    v565 = (rgb[..., 2] << 11) | (g6 << 5) | rgb[..., 0]
    argb = smooth(128, 128, seed=29, channels=4, noise=0.05).astype(np.int64)  # below the crop
    v8888 = (argb[..., 3] << 24) | (argb[..., 0] << 16) | (argb[..., 1] << 8) | argb[..., 2]
    return {
        "bmp_palette8_core.bmp": write_bmp(idx8, 8, palette=entries(200, 3), header=12),
        "bmp_palette4.bmp": write_bmp(idx4, 4, palette=entries(16), top_down=True),
        "bmp_palette1.bmp": write_bmp(idx1, 1, palette=entries(2)),
        "bmp_rle8.bmp": write_bmp(run8, 8, 1, entries(256), rle=rle_codes(run8, False, 100)),
        "bmp_rle4.bmp": write_bmp(idx4, 4, 2, entries(16), rle=rle_codes(idx4, True, 7)),
        "bmp_rgb555.bmp": write_bmp(v555, 16),
        "bmp_bitfields565.bmp": write_bmp(v565, 16, 3, masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_bitfields_alpha.bmp": write_bmp(v8888, 32, 3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                             header=124),
    }


def lzw_tiff(data: bytes) -> bytes:
    """TIFF's LZW of ``data`` (codes MSB first, 9 to 12 bits, the code
    width growing one code early: the reader's table, one entry behind
    this one's, reaches 2**n - 1 as this one reaches 2**n; a clear code
    first and where the table reaches 4094 entries, an end code last)."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table = {bytes((i,)): i for i in range(256)}
    put(256)
    nxt, prefix = 258, b""
    for byte in data:
        s = prefix + bytes((byte,))
        if s in table:
            prefix = s
            continue
        put(table[prefix])
        table[s] = nxt
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
        if nxt == 4094:
            put(256)
            table = {bytes((i,)): i for i in range(256)}
            nxt, width = 258, 9
        prefix = bytes((byte,))
    if prefix:
        put(table[prefix])
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits of ``data``: runs of 3 to 128 equal bytes, literals of up
    to 128 others."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes((257 - (j - i), data[i]))
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes((j - i - 1,)) + data[i:j]
        i = j
    return bytes(out)


def zstd_compress(data: bytes) -> bytes:
    """A zstd frame of ``data`` by the system's libzstd (``ZSTD_compress``,
    level 19)."""
    lib = ctypes.CDLL(ctypes.util.find_library("zstd"))
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                  ctypes.c_size_t, ctypes.c_int]
    out = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
    n = lib.ZSTD_compress(out, len(out), data, len(data), 19)
    return out.raw[:n]


def split_jpeg(data: bytes):
    """(the abbreviated table stream, the abbreviated image stream) of a
    JPEG: SOI, its DQT and DHT segments and EOI; SOI, the rest but APPn
    segments."""
    tables, image, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while data[pos + 1] != 0xDA:
        length = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos:pos + 2 + length]
        if data[pos + 1] in (0xDB, 0xC4):
            tables.append(seg)
        elif not 0xE0 <= data[pos + 1] <= 0xEF:
            image.append(seg)
        pos += 2 + length
    return b"".join(tables) + b"\xff\xd9", b"".join(image) + data[pos:]


def ycbcr_units(part: np.ndarray, h: int, v: int) -> np.ndarray:
    """(rows, cols, 3) Y, Cb, Cr samples as the bytes of YCbCr data units
    sampled ``h`` x ``v``: each unit's h*v luma samples, row by row, then
    its Cb and Cr, the rounded means of its block; edges repeated out to
    whole units."""
    rows, cols, _ = part.shape
    full = np.pad(part, ((0, -rows % v), (0, -cols % h), (0, 0)), mode="edge")
    blocks = full.reshape(full.shape[0] // v, v, full.shape[1] // h, h, 3).transpose(0, 2, 1, 3, 4)
    luma = blocks[..., 0].reshape(*blocks.shape[:2], h * v)
    chroma = (blocks[..., 1:].sum((2, 3)) + h * v // 2) // (h * v)
    return np.concatenate([luma, chroma], -1).astype(np.uint8)


def write_tiff(samples: np.ndarray, bits: int, photometric: int, compression: int = 1,
               predictor: int = 1, planar: int = 1, tile=None, rows_per_strip: int = 0,
               order: str = "<", big: bool = False, extra=(), colormap=None, fill_order: int = 1,
               orientation: int = 0, sample_format: int = 0, subsampling=None,
               jpeg_quality: int = 80, fields=()) -> bytes:
    """A TIFF of (h, w, samples) integer samples: strips of
    ``rows_per_strip`` rows (all rows: 0) or ``tile`` = (width, length)
    tiles, chunky or planar, compressed by 1 (none), 5 (LZW), 8 or 32946
    (Deflate), 32773 (PackBits), 50000 (Zstandard), 34925 (LZMA) or 7
    (JPEG: each chunk an abbreviated baseline stream of ``encode_jpeg``
    at ``jpeg_quality``, the tables in ``JPEGTables``), with horizontal
    differencing (``predictor`` 2) at 8, 16 or 32 bits or libtiff's
    floating-point predictor (3) at 32; ``order`` '<' (II) or '>' (MM);
    classic TIFF or BigTIFF; fill order 2 (bits reversed in each byte), an
    orientation and a sample format where given.  YCbCr samples
    (photometric 6) are written in data units of ``subsampling`` = (h, v)
    luma samples (and the JPEG's first component so sampled), with the
    ``YCbCrSubsampling`` field.  ``fields``: more (tag, type, values)
    entries (a RATIONAL's values as numerators and denominators)."""
    h, w, spp = samples.shape
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    tw, th = tile or (w, rows_per_strip or h)
    chunks, tables = [], None
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw if tile else w):
                cw = tw if tile else w
                part = np.zeros((th if tile else min(th, h - y), cw, plane.shape[2]), np.int64)
                sub = plane[y:y + part.shape[0], x:x + cw]
                part[:sub.shape[0], :sub.shape[1]] = sub
                if compression == 7:
                    sampling = [tuple(subsampling or (1, 1))] + [(1, 1)] * (spp - 1)
                    tables, raw = split_jpeg(encode_jpeg([part[..., k] for k in range(spp)],
                                                         sampling, jpeg_quality, jfif=False))
                    chunks.append(raw)
                    continue
                if predictor == 2:
                    part = np.concatenate([part[:, :1], np.diff(part, axis=1)], 1) % (1 << bits)
                flat = part.reshape(part.shape[0], -1)
                if photometric == 6 and tuple(subsampling or (1, 1)) != (1, 1):
                    raw = ycbcr_units(part, *subsampling).tobytes()
                elif predictor == 3:  # fpAcc's inverse: byte planes, then differences
                    be = flat.astype(">u4").view(np.uint8).reshape(flat.shape[0], -1, 4)
                    rows = be.transpose(0, 2, 1).reshape(flat.shape[0], -1).astype(np.int64)
                    step = part.shape[2]
                    rows[:, step:] = (rows[:, step:] - rows[:, :-step]) % 256
                    raw = rows.astype(np.uint8).tobytes()
                elif bits in (16, 32):
                    raw = flat.astype(f"{order}u{bits // 8}").tobytes()
                elif bits == 8:
                    raw = flat.astype(np.uint8).tobytes()
                else:
                    bitarr = (flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1
                    raw = np.packbits(bitarr.reshape(flat.shape[0], -1).astype(np.uint8),
                                      axis=1).tobytes()
                if compression == 5:
                    raw = lzw_tiff(raw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw, 9)
                elif compression == 32773:
                    raw = packbits(raw)
                elif compression == 50000:
                    raw = zstd_compress(raw)
                elif compression == 34925:
                    raw = lzma.compress(raw, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
                if fill_order == 2:  # the stored bytes' bits reversed
                    raw = np.packbits(np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(-1, 8)[:, ::-1]
                                      ).tobytes()
                chunks.append(raw)
    kind = {1: "B", 2: "s", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}
    offset_type = 16 if big else 4
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
               (262, 3, [photometric])]
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    entries.append((324 if tile else 273, offset_type, [0] * len(chunks)))
    if orientation:
        entries.append((274, 3, [orientation]))
    entries += [(277, 3, [spp])]
    if not tile:
        entries.append((278, 3, [th]))
    entries.append((325 if tile else 279, offset_type, [len(c) for c in chunks]))
    if tile:
        entries += [(322, 3, [tw]), (323, 3, [th])]
    if planar != 1:
        entries.append((284, 3, [planar]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(colormap)))
    if extra:
        entries.append((338, 3, list(extra)))
    if sample_format:
        entries.append((339, 3, [sample_format] * spp))
    if subsampling:
        entries.append((530, 3, list(subsampling)))
    if tables:
        entries.append((347, 7, list(tables)))
    entries += list(fields)
    entries.sort(key=lambda e: e[0])
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 4, 7: 1, 16: 8}
    head = 16 if big else 8
    count_fmt, entry_size, inline = ("Q", 20, 8) if big else ("H", 12, 4)
    ifd_size = (8 if big else 2) + entry_size * len(entries) + (8 if big else 4)
    # out-of-line values after the IFD, then the image data
    pos = head + ifd_size
    blobs, placed = [], {}
    for tag, typ, vals in entries:
        size = sizes[typ] * len(vals)
        if size > inline:
            placed[tag] = pos
            pos += size + size % 2
    data_at = pos
    starts = []
    for c in chunks:
        starts.append(pos)
        pos += len(c)
    out = bytearray((b"II" if order == "<" else b"MM")
                    + struct.pack(order + "H", 43 if big else 42))
    out += struct.pack(order + "HHQ", 8, 0, 16) if big else struct.pack(order + "I", 8)
    out += struct.pack(order + count_fmt, len(entries))
    for tag, typ, vals in entries:
        if tag in (273, 324):
            vals = starts
        fmt = order + kind[typ] * len(vals)
        body = struct.pack(fmt, *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        out += struct.pack(order + "HH" + ("Q" if big else "I"), tag, typ, count)
        out += body.ljust(inline, b"\0") if len(body) <= inline else \
            struct.pack(order + ("Q" if big else "I"), placed[tag])
    out += bytes(8 if big else 4)
    for tag, typ, vals in entries:
        if tag in placed:
            fmt = order + kind[typ] * len(vals)
            if tag in (273, 324):
                vals = starts
            body = struct.pack(fmt, *vals)
            out += body + bytes(len(body) % 2)
    assert len(out) == data_at
    return bytes(out) + b"".join(chunks)


def tiff_files() -> dict:
    """name -> bytes of each TIFF kind (96x80, and one 768x512)."""
    from PIL import Image

    h, w = 80, 96

    def pillow(im, **kwargs) -> bytes:
        buf = io.BytesIO()
        im.save(buf, format="TIFF", **kwargs)
        return buf.getvalue()

    rgb = smooth(h, w, seed=31, noise=0.05).astype(np.uint8)
    rgba = smooth(h, w, seed=32, channels=4, noise=0.05).astype(np.uint8)
    gray = smooth(h, w, seed=33, channels=1, noise=0.05)[..., 0].astype(np.uint8)
    cmap = wide(smooth(1, 16, seed=34)[0].T.reshape(-1))  # 16 reds, greens, blues
    idx4 = smooth(h, w, seed=35, channels=1, levels=16)
    premul = rgba.astype(np.int64)
    premul[..., :3] = premul[..., :3] * premul[..., 3:] // 255
    big = textured_tiff_rgb()
    return {
        "tiff_rgb.tif": pillow(Image.fromarray(rgb)),
        "tiff_lzw.tif": pillow(Image.fromarray(rgb), compression="tiff_lzw"),
        "tiff_deflate_rgba.tif": pillow(Image.fromarray(rgba, "RGBA"), compression="tiff_adobe_deflate"),
        "tiff_packbits_gray.tif": pillow(Image.fromarray(gray), compression="packbits"),
        "tiff_palette.tif": pillow(Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                                                 colors=40), compression="tiff_lzw"),
        "tiff_gray16.tif": pillow(Image.fromarray(wide(smooth(h, w, seed=36, channels=1))[..., 0]
                                                  .astype(np.uint16))),
        "tiff_cmyk.tif": pillow(Image.fromarray(rgb).convert("CMYK"), compression="tiff_lzw"),
        "tiff_bilevel.tif": pillow(Image.fromarray(gray).convert("1"), compression="packbits"),
        "tiff_bigtiff.tif": pillow(Image.fromarray(rgb), big_tiff=True),
        "tiff_tiled_planar_be.tif": write_tiff(rgb, 8, 2, compression=5, predictor=2, planar=2,
                                               tile=(32, 48), order=">"),
        "tiff_predictor16.tif": write_tiff(wide(smooth(h, w, seed=37)), 16, 2, compression=32946,
                                           predictor=2, rows_per_strip=7),
        "tiff_premultiplied_mm.tif": write_tiff(premul, 8, 2, compression=5, extra=(1,),
                                                rows_per_strip=16, order=">"),
        "tiff_palette4_packbits.tif": write_tiff(idx4, 4, 3, compression=32773, rows_per_strip=9,
                                                 colormap=cmap),
        "tiff_miniswhite_tiled16.tif": write_tiff(wide(smooth(h, w, seed=38, channels=1)), 16, 0,
                                                  tile=(16, 16), big=True),
        "tiff_miniswhite8_rotated.tif": write_tiff(gray[..., None], 8, 0, compression=32773,
                                                   rows_per_strip=5, orientation=6),
        "textured_lzw.tif": write_tiff(big, 8, 2, compression=5, predictor=2, rows_per_strip=16),
    }


def textured_tiff_rgb() -> np.ndarray:
    """(512, 768, 3) uint8: smooth waves and fine stripes, which LZW with
    horizontal differencing packs into ~200 kB."""
    h, w = TEXTURED
    return np.clip(smooth(h, w, seed=39, period=3)
                   + np.round(6 * np.sin(np.arange(w) / 2.3))[None, :, None], 0, 255).astype(np.uint8)


def lzw_gif(indices, bits: int, first_clear: bool = True, clear_at_full: bool = True) -> bytes:
    """GIF's LZW of ``indices`` with minimum code size ``bits``: codes LSB
    first, widened as the reader's table (one entry behind) reaches
    2**size - 1; no leading clear code unless ``first_clear``; at 4096
    entries a clear code, or (``clear_at_full`` False) none and no more
    entries, as a deferred clear."""
    clear = 1 << bits
    out, acc, nacc, size = bytearray(), 0, 0, bits + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {(i,): i for i in range(clear)}, clear + 2

    table, nxt = reset()
    if first_clear:
        put(clear)
    prefix = ()
    for v in indices:
        s = prefix + (v,)
        if s in table:
            prefix = s
            continue
        put(table[prefix])
        if nxt < 4096:
            table[s] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
        elif clear_at_full:
            put(clear)
            table, nxt = reset()
            size = bits + 1
        prefix = (v,)
    put(table[prefix])
    if nxt < 4096 and nxt == 1 << size and size < 12:
        size += 1
    put(clear + 1)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(idx: np.ndarray, bits: int, table: bytes, local: bool = False, interlace: bool = False,
         transparency=None, screen=None, offset=(0, 0), junk: bool = False, **lzw) -> bytes:
    """A GIF89a of one frame of ``idx`` (h, w) at ``offset`` on ``screen``
    (w, h), its colour ``table`` global or local, LZW at minimum code size
    ``bits``, with a graphic control extension of ``transparency``, a
    comment and (``junk``) stray bytes before the image."""
    h, w = idx.shape
    sw, sh = screen or (w, h)
    entries = len(table) // 3
    size_bits = max(1, (entries - 1).bit_length()) - 1
    flags = 0x80 | size_bits
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0 if local else flags, 0, 0))
    if not local:
        out += table
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes((1, 0, 0, transparency, 0))
    out += b"\x21\xfe\x05hello\x00"
    if junk:
        out += b"\x07\x42"
    out += b"," + struct.pack("<HHHH", *offset, w, h)
    out.append((flags if local else 0) | (0x40 if interlace else 0))
    if local:
        out += table
    rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]]) if interlace else idx
    stream = lzw_gif(rows.ravel().tolist(), bits, **lzw)
    out.append(bits)
    for i in range(0, len(stream), 255):
        out += bytes((len(stream[i:i + 255]),)) + stream[i:i + 255]
    return bytes(out + b"\x00;")


def gif_files() -> dict:
    """name -> bytes of each GIF kind (Pillow's GIFs, some patched)."""
    from PIL import Image

    h, w = 80, 96

    def pillow(im, **kwargs) -> bytes:
        buf = io.BytesIO()
        im.save(buf, format="GIF", **kwargs)
        return buf.getvalue()

    rgb = smooth(h, w, seed=41, noise=0.1).astype(np.uint8)
    p = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=200)
    small = Image.fromarray(smooth(50, 60, seed=42, noise=0.1).astype(np.uint8)).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=30)
    offset = bytearray(pillow(small, transparency=3))  # screen 96x80, the frame at (20, 17)
    offset[6:10] = struct.pack("<HH", w, h)
    at = offset.index(b",", 13 + 3 * (2 << (offset[10] & 7)))
    offset[at + 1:at + 5] = struct.pack("<HH", 20, 17)
    ramp = bytearray(pillow(p))  # a global palette of gray ramp entries: Pillow opens it as L
    ramp[13:13 + 768] = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    ramp = bytes(ramp)
    frames = [Image.fromarray(smooth(h, w, seed=s, noise=0.1).astype(np.uint8)) for s in (43, 44)]
    anim = io.BytesIO()
    frames[0].save(anim, format="GIF", save_all=True, append_images=frames[1:], interlace=False)
    return {
        "gif_interlaced.gif": pillow(p),
        "gif_gray.gif": ramp,
        "gif_offset_transparent.gif": bytes(offset),
        "gif_animated.gif": anim.getvalue(),
    }


def animated_webp_files() -> dict:
    """name -> bytes of the animated WebPs (262x270 canvases): Pillow's
    lossy and lossless ``save_all`` files, and a lossy one whose first
    frame is patched to sit at (24, 10) inside a wider canvas."""
    from PIL import Image

    h, w = SIZE

    def anim(frames, **kwargs) -> bytes:
        buf = io.BytesIO()
        frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=80,
                       **kwargs)
        return buf.getvalue()

    rgb = [Image.fromarray(smooth(h, w, seed=s, noise=0.05).astype(np.uint8)) for s in (51, 52)]
    rgba = [Image.fromarray(smooth(h, w, seed=s, channels=4, period=4).astype(np.uint8), "RGBA")
            for s in (53, 54)]
    offset = bytearray(anim(rgb, quality=70))
    at = offset.index(b"ANMF")
    offset[at + 8:at + 14] = (12).to_bytes(3, "little") + (5).to_bytes(3, "little")
    vp8x = offset.index(b"VP8X")
    offset[vp8x + 12:vp8x + 18] = (w + 40 - 1).to_bytes(3, "little") + (h + 10 - 1).to_bytes(3, "little")
    return {
        "webp_animated_lossy.webp": anim(rgb, quality=70),
        "webp_animated_alpha.webp": anim(rgba, lossless=True),
        "webp_animated_offset.webp": bytes(offset),
    }


def _write_scan(blocks, tables) -> bytes:
    """Huffman-coded blocks, (n, 64) zigzag with each one's (DC, AC)
    table pair: DC differences per component, AC runs, ZRL and EOB codes;
    1-padded, 0xFF bytes stuffed."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    codes = {k: jpeg._huffman_codes(*v) for k, v in jpeg.STD_HUFFMAN.items()}
    bits = []

    def put(code, n):
        bits.extend((code >> (n - 1 - i)) & 1 for i in range(n))

    def value(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = {}
    for (comp, tab), blk in zip(tables, blocks):
        diff = int(blk[0]) - pred.get(comp, 0)
        pred[comp] = int(blk[0])
        s, v = value(diff)
        put(*codes[(0, tab)][s])
        put(v, s) if s else None
        run = 0
        last = max([i for i in range(1, 64) if blk[i]], default=0)
        for i in range(1, last + 1):
            if not blk[i]:
                run += 1
                continue
            while run > 15:
                put(*codes[(1, tab)][0xF0])
                run -= 16
            s, v = value(int(blk[i]))
            put(*codes[(1, tab)][(run << 4) | s])
            put(v, s)
            run = 0
        if last < 63:
            put(*codes[(1, tab)][0])
    bits += [1] * (-len(bits) % 8)
    data = np.packbits(np.array(bits, np.uint8)).tobytes()
    return data.replace(b"\xff", b"\xff\x00")


def jpeg_coefficients(planes, sampling, quality: int = 80):
    """Per component the quantized blocks, (blocks down, blocks across, 64)
    zigzag over its MCU-padded plane, of full-size (H, W) sample
    ``planes`` at ``sampling`` ((h, v) per component): each plane
    box-averaged to its component's size, quantized with ``io/jpeg.py``'s
    tables (the luma table for the first component); and the tables."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = planes[0].shape
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qt = jpeg.quant_tables(quality)
    comps = []
    for k, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // hs, vmax // vs
        full = np.pad(np.asarray(plane, np.int64), ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)),
                      mode="edge")
        small = full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx, fx).sum((1, 3))
        small = (small + fx * fy // 2) // (fx * fy)
        q = qt[0 if k == 0 else 1]
        coefs = jpeg.quantize(jpeg.fdct(jpeg._blocks(small) - 128), q)
        comps.append(coefs.reshape(*coefs.shape[:2], 64)[..., jpeg.ZIGZAG])
    return comps, qt


def _frame_head(jfif: bool, adobe, qt=()) -> list:
    """SOI, the JFIF and Adobe markers asked for, and the DQT segments."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    out = [b"\xff\xd8"]
    if jfif:
        out.append(jpeg._marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        out.append(jpeg._marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes((adobe,))))
    for i, table in enumerate(qt):
        out.append(jpeg._marker(0xDB, bytes([i]) + bytes(table[jpeg.ZIGZAG].astype(np.uint8))))
    return out


def encode_jpeg(planes, sampling, quality: int = 80, ids=None, adobe=None, jfif: bool = True) -> bytes:
    """A baseline JPEG of full-size (H, W) sample ``planes`` (already in
    the colour space to code: YCbCr, RGB, YCCK, ...) at any sampling
    factors (``sampling``: (h, v) per component), ``jpeg_coefficients``
    coded in one interleaved scan with the Annex K Huffman tables; with a
    JFIF marker or not, an Adobe marker of transform ``adobe`` or none,
    and component ``ids``."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = planes[0].shape
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps, qt = jpeg_coefficients(planes, sampling, quality)
    blocks, tables = [], []
    for my in range(mcuy):
        for mx in range(mcux):
            for k, (hs, vs) in enumerate(sampling):
                for v in range(vs):
                    for u in range(hs):
                        blocks.append(comps[k][my * vs + v, mx * hs + u])
                        tables.append((k, 0 if k == 0 else 1))
    ids = ids or list(range(1, len(planes) + 1))
    out = _frame_head(jfif, adobe, qt)
    out.append(jpeg._marker(0xC0, struct.pack(">BHHB", 8, h, w, len(planes)) + b"".join(
        bytes((c, hs << 4 | vs, 0 if k == 0 else 1)) for k, (c, (hs, vs)) in enumerate(zip(ids, sampling)))))
    for tab_id in (0, 1):
        for cls in (0, 1):
            counts, symbols = jpeg.STD_HUFFMAN[(cls, tab_id)]
            out.append(jpeg._marker(0xC4, bytes([cls << 4 | tab_id]) + bytes(counts) + symbols))
    out.append(jpeg._marker(0xDA, bytes([len(planes)]) + b"".join(
        bytes((c, 0x00 if k == 0 else 0x11)) for k, c in enumerate(ids)) + bytes((0, 63, 0))))
    out.append(_write_scan(blocks, tables))
    out.append(b"\xff\xd9")
    return b"".join(out)


class QMEncoder:
    """jcarith.c's arithmetic encoder: ``encode`` codes one decision in a
    statistics bin (a byte: the MPS in bit 7, the state below it; the
    states of ``io/jpeg.py``'s ``QE_TABLE``) and ``finish`` ends a scan or
    a restart interval (section D.1.8); the coded bytes, 0xFF bytes
    stuffed, collect in ``out``."""

    def __init__(self):
        from imagecompression_adversarial_tpu_torch.io import jpeg

        self.table = jpeg.QE_TABLE
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_stacked(self, byte: int):
        """Pending zero bytes, then ``byte`` (stuffed where 0xFF)."""
        self.out += b"\x00" * self.zc
        self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _carry(self):
        if self.buffer >= 0:
            self._emit_stacked(self.buffer + 1)
        self.zc += self.sc  # a carry turns the stacked 0xFF bytes into 0x00
        self.sc = 0

    def _no_carry(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._emit_stacked(self.buffer)
        if self.sc:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, stats: bytearray, i: int, val: int):
        sv = stats[i]
        qe, nl, nm, switch = self.table[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (nl | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:  # renormalization and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._no_carry()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._no_carry()
        if self.c & 0x7FFF800:
            self.out += b"\x00" * self.zc
            self.zc = 0
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    byte = (self.c >> shift) & 0xFF
                    self.out.append(byte)
                    if byte == 0xFF:
                        self.out.append(0)
        self.reset()


def _arith_value(enc: QMEncoder, stats: bytearray, st: int, v: int, x1: int, ac: bool):
    """Figures F.8 and F.9: the magnitude category of ``v`` - 1 (> 0 here:
    the caller has coded that v is nonzero) from bin ``st``, then its
    bits; ``x1`` is the first bin of the categories past the first
    (``ac``: past the first two, the first of which shares ``st``)."""
    v -= 1
    m = 0
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v >> 1
        if ac and v2:
            enc.encode(stats, st, 1)
            m <<= 1
            v2 >>= 1
            st = x1
        elif not ac:
            st = x1
        while v2:
            enc.encode(stats, st, 1)
            m <<= 1
            st += 1
            v2 >>= 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1


def _arith_dc(enc, stats, ctx: list, j: int, diff: int, lu):
    """Figure F.4 (a DC difference) with section F.1.4.4.1.2's conditioning
    of the next difference in ``ctx[j]``."""
    st = ctx[j]
    if diff == 0:
        enc.encode(stats, st, 0)
        ctx[j] = 0
        return
    enc.encode(stats, st, 1)
    sign = diff < 0
    enc.encode(stats, st + 1, int(sign))
    mag = abs(diff)
    m = max(mag - 1, 0).bit_length()  # the category's power of two, as a bit count
    cat = (1 << (m - 1)) if m else 0
    lo, hi = lu
    if cat < (1 << lo) >> 1:
        ctx[j] = 0
    elif cat > (1 << hi) >> 1:
        ctx[j] = 12 + 4 * sign
    else:
        ctx[j] = 4 + 4 * sign
    _arith_value(enc, stats, st + 2 + sign, mag, 20, ac=False)


def _arith_ac(enc, stats, fixed, zz, ss: int, se: int, al: int, k_limit: int):
    """Figure F.5 over band ``ss``..``se`` of zigzag block ``zz``, each
    value shifted right by ``al`` (towards zero)."""
    vals = [(abs(int(v)) >> al) * (1 if v >= 0 else -1) for v in zz]
    ke = se
    while ke >= ss and not vals[ke]:
        ke -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(stats, st, 0)
        while not vals[k]:
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        enc.encode(stats, st + 1, 1)
        enc.encode(fixed, 0, int(vals[k] < 0))
        _arith_value(enc, stats, st + 2, abs(vals[k]), 189 if k <= k_limit else 217, ac=True)
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


def _arith_ac_refine(enc, stats, fixed, zz, ss: int, se: int, ah: int, al: int):
    """Figure G.10: bit ``al`` of each coefficient of band ``ss``..``se``
    already nonzero above ``ah``, and the ones newly nonzero at ``al``."""
    mag = [abs(int(v)) for v in zz]
    ke = se
    while ke >= ss and not mag[ke] >> al:
        ke -= 1
    kex = ke
    while kex > 0 and not mag[kex] >> ah:
        kex -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc.encode(stats, st, 0)
        while True:
            v = mag[k] >> al
            if v:
                if v >> 1:
                    enc.encode(stats, st + 2, v & 1)
                else:
                    enc.encode(stats, st + 1, 1)
                    enc.encode(fixed, 0, int(zz[k] < 0))
                break
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


# libjpeg's jpeg_simple_progression for three components (YCbCr) and one:
# (components, Ss, Se, Ah, Al)
PROGRESSION_3 = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                 ((0,), 1, 63, 1, 0))
PROGRESSION_1 = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                 ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))
# and a four-component one: DC of all, then each component's AC in two
# bands, refined once
PROGRESSION_4 = ((((0, 1, 2, 3), 0, 0, 0, 1),)
                 + tuple(((k,), 1, 9, 0, 1) for k in range(4))
                 + tuple(((k,), 10, 63, 0, 0) for k in range(4))
                 + (((0, 1, 2, 3), 0, 0, 1, 0),)
                 + tuple(((k,), 1, 9, 1, 0) for k in range(4)))


def encode_arith_jpeg(planes, sampling, quality: int = 80, script=None, restart: int = 0,
                      conditioning=None, ids=None, adobe=None, jfif: bool = True) -> bytes:
    """An arithmetic-coded JPEG (``jcarith.c``) of ``jpeg_coefficients``:
    sequential (SOF9) in one interleaved scan, or progressive (SOF10) by
    ``script``, ``PROGRESSION_3`` or ``PROGRESSION_1`` and the like, each
    scan (components, Ss, Se, Ah, Al); the first component on conditioning
    tables 0, the others on 1; a restart interval of ``restart`` units (0:
    none); ``conditioning``, where given, a DAC segment's values: {(class,
    table): value}, a DC value ``U << 4 | L``, an AC value ``Kx``."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = planes[0].shape
    n = len(planes)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps, qt = jpeg_coefficients(planes, sampling, quality)
    ids = ids or list(range(1, n + 1))
    dac = {(0, t): 0x10 for t in (0, 1)} | {(1, t): 5 for t in (0, 1)} | dict(conditioning or {})
    out = _frame_head(jfif, adobe, qt)
    if conditioning:
        out.append(jpeg._marker(0xCC, b"".join(bytes((c << 4 | t, v))
                                               for (c, t), v in sorted(conditioning.items()))))
    progressive = script is not None
    out.append(jpeg._marker(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, h, w, n) + b"".join(
        bytes((c, hs << 4 | vs, 0 if k == 0 else 1)) for k, (c, (hs, vs)) in enumerate(zip(ids, sampling)))))
    if restart:
        out.append(jpeg._marker(0xDD, struct.pack(">H", restart)))
    for members, ss, se, ah, al in script or ((tuple(range(n)), 0, 63, 0, 0),):
        tab = [0 if k == 0 else 1 for k in members]
        out.append(jpeg._marker(0xDA, bytes([len(members)]) + b"".join(
            bytes((ids[k], t * 0x11)) for k, t in zip(members, tab)) + bytes((ss, se, ah << 4 | al))))
        if len(members) > 1:
            units = [[(j, comps[k][my * sampling[k][1] + v, mx * sampling[k][0] + u])
                      for j, k in enumerate(members)
                      for v in range(sampling[k][1]) for u in range(sampling[k][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        else:
            k = members[0]
            gh = -(-(-(-h * sampling[k][1] // vmax)) // 8)
            gw = -(-(-(-w * sampling[k][0] // hmax)) // 8)
            units = [[(0, comps[k][by, bx])] for by in range(gh) for bx in range(gw)]
        enc = QMEncoder()
        dc_on = not progressive or (ss == 0 and ah == 0)
        ac_on = not progressive or se > 0
        fixed = bytearray([jpeg.FIXED_BIN])
        for u, unit in enumerate(units):
            if u % (restart or len(units)) == 0:
                if u:
                    enc.finish()
                    enc.out += bytes((0xFF, 0xD0 + (u // restart - 1) % 8))
                dc_stats = {t: bytearray(64) for t in set(tab)}
                ac_stats = {t: bytearray(256) for t in set(tab)}
                pred, ctx = [0] * len(members), [0] * len(members)
            for j, zz in unit:
                t = tab[j]
                if dc_on:
                    dc = int(zz[0]) >> al
                    _arith_dc(enc, dc_stats[t], ctx, j, dc - pred[j], (dac[(0, t)] & 15, dac[(0, t)] >> 4))
                    pred[j] = dc
                elif progressive and ss == 0:
                    enc.encode(fixed, 0, (int(zz[0]) >> al) & 1)
                if ac_on and progressive and ah:
                    _arith_ac_refine(enc, ac_stats[t], fixed, zz, ss, se, ah, al)
                elif ac_on:
                    _arith_ac(enc, ac_stats[t], fixed, zz, max(ss, 1), se, al, dac[(1, t)])
        enc.finish()
        out.append(bytes(enc.out))
    out.append(b"\xff\xd9")
    return b"".join(out)


# a lossless difference table: categories 0 to 16, codes of 2 to 14 bits
LOSSLESS_HUFFMAN = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0), bytes(range(17)))


def lossless_predict(s: np.ndarray, predictor: int, initial: int, first_rows) -> np.ndarray:
    """Each sample's prediction (ITU-T T.81 H.1.2.1) in a (h, w) plane of
    point-transformed samples: ``initial`` at the start of each row of
    ``first_rows`` (a restart interval's first), the sample to the left
    along it; the one above in the first column; else predictor 1-7 of
    Ra (left), Rb (above), Rc (above left)."""
    s = s.astype(np.int64)
    ra = np.pad(s, ((0, 0), (1, 0)))[:, :-1]
    rb = np.pad(s, ((1, 0), (0, 0)))[:-1]
    rc = np.pad(s, ((1, 0), (1, 0)))[:-1, :-1]
    px = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
          6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    px[:, 0] = rb[:, 0]
    for y in first_rows:
        px[y] = ra[y]
        px[y, 0] = initial
    return px


def encode_lossless_jpeg(planes, predictor: int, pt: int = 0, restart_rows: int = 0,
                         interleaved: bool = True, ids=None, adobe=None,
                         jfif: bool = False) -> bytes:
    """A lossless JPEG (SOF3, Huffman, 8-bit samples) of (H, W) sample
    ``planes`` at 1x1 sampling: predictor ``predictor`` (1-7), point
    transform ``pt``, a restart interval of ``restart_rows`` rows (0:
    none), its components in one scan or in one scan each."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = planes[0].shape
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    first_rows = range(0, h, restart_rows) if restart_rows else (0,)
    diffs = []
    for plane in planes:
        s = np.asarray(plane, np.int64) >> pt
        d = (s - lossless_predict(s, predictor, 1 << (8 - pt - 1), first_rows)) % 65536
        diffs.append(np.where(d >= 32768, d - 65536, d))
    codes = jpeg._huffman_codes(*LOSSLESS_HUFFMAN)
    out = _frame_head(jfif, adobe)
    out.append(jpeg._marker(0xC3, struct.pack(">BHHB", 8, h, w, n)
                            + b"".join(bytes((c, 0x11, 0)) for c in ids)))
    out.append(jpeg._marker(0xC4, b"\x00" + bytes(LOSSLESS_HUFFMAN[0]) + LOSSLESS_HUFFMAN[1]))
    if restart_rows:
        out.append(jpeg._marker(0xDD, struct.pack(">H", restart_rows * w)))
    for members in ([list(range(n))] if interleaved else [[k] for k in range(n)]):
        out.append(jpeg._marker(0xDA, bytes([len(members)]) + b"".join(
            bytes((ids[k], 0)) for k in members) + bytes((predictor, 0, pt))))
        rows = restart_rows or h
        for y0 in range(0, h, rows):
            bits = []
            for v in np.stack([diffs[k][y0:y0 + rows] for k in members], -1).ravel().tolist():
                s = 16 if v == -32768 else abs(v).bit_length()
                code, length = codes[s]
                bits.extend((code >> (length - 1 - i)) & 1 for i in range(length))
                if 0 < s < 16:
                    bits.extend(((v if v > 0 else v - 1) >> (s - 1 - i)) & 1 for i in range(s))
            bits += [1] * (-len(bits) % 8)
            out.append(np.packbits(np.array(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00"))
            if y0 + rows < h:
                out.append(bytes((0xFF, 0xD0 + (y0 // rows) % 8)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_pnm(samples: np.ndarray, magic: bytes, maxval: int = 255, comments: bool = False) -> bytes:
    """A Netpbm file of (h, w) or (h, w, 3) integer samples: ``P1``/``P4``
    bits (1 black), ``P2``/``P5`` gray, ``P3``/``P6`` RGB at ``maxval``;
    plain (``P1``-``P3``: decimal tokens, lines of at most 70 bytes) or raw
    (``P4``: 8 pixels a byte, rows padded; ``P5``, ``P6``: a byte a sample
    below maxval 256, two big-endian above); with ``comments``, ``#``
    lines in the header (one between two of its tokens) and, in a plain
    file, in the body."""
    h, w = samples.shape[:2]
    note = b"# written by make_inputs.py\n" if comments else b""
    head = magic + b"\n" + note + b"%d" % w + (b" #x\n" if comments else b" ") + b"%d\n" % h
    if magic not in (b"P1", b"P4"):
        head += b"%d\n" % maxval
    flat = np.asarray(samples, np.int64).reshape(h, -1)
    if magic == b"P4":
        return head + np.packbits(flat.astype(np.uint8), axis=1).tobytes()
    if magic in (b"P5", b"P6"):
        return head + flat.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    lines = []
    for y, row in enumerate(flat.tolist()):
        line = b""
        for v in row:
            token = b"%d" % v
            if len(line) + len(token) + 1 > 70:
                lines.append(line)
                line = b""
            line += (b" " if line and magic != b"P1" else b"") + token
        lines.append(line + (b" # row %d" % y if comments and y % 7 == 3 else b""))
    return head + b"\n".join(lines) + b"\n"


def write_pfm(samples: np.ndarray, scale: float = -1.0) -> bytes:
    """A gray PFM (``Pf``) of (h, w) float samples, rows bottom to top,
    little-endian where ``scale`` is negative."""
    h, w = samples.shape
    order = "<" if scale < 0 else ">"
    return (b"Pf\n%d %d\n%s\n" % (w, h, repr(scale).encode())
            + np.ascontiguousarray(samples[::-1], order + "f4").tobytes())


# the files of slice 20 (Netpbm, lossless and arithmetic-coded JPEGs), which
# chip_smoke.py phase 26 decodes
SLICE20_FILES = ("pnm_", "jpegx_", "textured_arith")


def slice20_files() -> dict:
    """name -> bytes of each Netpbm, lossless JPEG and arithmetic-coded JPEG
    file (96x80 and 64x48; the arithmetic ones 262x270), and the 768x512
    progressive arithmetic-coded JPEG of ``chip_smoke.py::textured_rgb``
    (seed 5) that phase 26 times and attacks: q60, 62 kB, inside the one
    65,536-byte block in which Pillow reads an arithmetic-coded file whole
    (``io/jpeg.py::PILLOW_BLOCK``)."""
    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = 80, 96
    rgb = smooth(h, w, seed=71, noise=0.05)
    gray = smooth(h, w, seed=72, channels=1, noise=0.05)[..., 0]
    small_rgb = smooth(48, 64, seed=73, noise=0.05)
    small_gray = smooth(48, 64, seed=74, channels=1, noise=0.05)[..., 0]
    bits = bilevel(48, 64, seed=75) // 255
    big = smooth(*SIZE, seed=76, noise=0.1).astype(np.uint8)
    ycc = jpeg.rgb_to_ycbcr(big)
    planes = [ycc[..., i] for i in range(3)]
    sys.path.insert(0, ROOT)
    from chip_smoke import textured_rgb

    tex = jpeg.rgb_to_ycbcr(textured_rgb(*TEXTURED, seed=5))
    sampling = [(2, 2), (1, 1), (1, 1)]
    return {
        "pnm_p1_plain.pbm": write_pnm(bits, b"P1", comments=True),
        "pnm_p4_raw.pbm": write_pnm(bilevel(h, 90, seed=76) // 255, b"P4"),
        "pnm_p2_plain.pgm": write_pnm(small_gray * 200 // 255, b"P2", 200, comments=True),
        "pnm_p2_plain_16bit.pgm": write_pnm(small_gray * 1000 // 255, b"P2", 1000),
        "pnm_p5_raw.pgm": write_pnm(gray, b"P5", comments=True),
        "pnm_p5_16bit.pgm": write_pnm(wide(gray), b"P5", 65535),
        "pnm_p5_12bit.pgm": write_pnm(gray * 16 + gray // 16, b"P5", 4095),
        "pnm_p3_plain.ppm": write_pnm(small_rgb, b"P3", comments=True),
        "pnm_p6_raw.ppm": write_pnm(rgb, b"P6"),
        "pnm_p6_16bit.ppm": write_pnm(wide(rgb), b"P6", 65535, comments=True),
        "pnm_p6_maxval1000.ppm": write_pnm(rgb * 1000 // 255 + (rgb > 250) * 24, b"P6", 1000),
        "pnm_p6_maxval100.ppm": write_pnm(rgb * 100 // 255, b"P6", 100),
        "pnm_pf_gray.pfm": write_pfm(gray.astype(np.float32) * 1.25 - 20.5),
        "jpegx_lossless_p1_rgb.jpg": encode_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 1),
        "jpegx_lossless_p2_gray_pt1.jpg": encode_lossless_jpeg([gray], 2, pt=1),
        "jpegx_lossless_p3_scans.jpg": encode_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 3,
                                                            interleaved=False),
        "jpegx_lossless_p4_gray_rst.jpg": encode_lossless_jpeg([gray], 4, restart_rows=7),
        "jpegx_lossless_p5_adobe_rgb.jpg": encode_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 5,
                                                                adobe=0),
        "jpegx_lossless_p6_pt2_ids.jpg": encode_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 6,
                                                              pt=2, ids=[82, 71, 66]),
        "jpegx_lossless_p7_rst_scans.jpg": encode_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 7,
                                                                restart_rows=3, interleaved=False),
        "jpegx_arith_420.jpg": encode_arith_jpeg(planes, sampling, 80),
        "jpegx_arith_444_dac.jpg": encode_arith_jpeg(planes, [(1, 1)] * 3, 80, conditioning={
            (0, 0): 0x52, (0, 1): 0x30, (1, 0): 12, (1, 1): 2}),
        "jpegx_arith_gray_rst.jpg": encode_arith_jpeg(planes[:1], [(1, 1)], 85, restart=7),
        "jpegx_arith_progressive_420_rst.jpg": encode_arith_jpeg(planes, sampling, 80,
                                                                 script=PROGRESSION_3, restart=5),
        "jpegx_arith_progressive_gray.jpg": encode_arith_jpeg(planes[:1], [(1, 1)], 90,
                                                              script=PROGRESSION_1),
        "jpegx_arith_progressive_422_cmyk.jpg": encode_arith_jpeg(
            [*planes, smooth(*SIZE, seed=77, channels=1)[..., 0]], [(2, 1), (1, 1), (1, 1), (2, 1)],
            75, script=PROGRESSION_4, adobe=0, jfif=False),
        "textured_arith.jpg": encode_arith_jpeg([tex[..., i] for i in range(3)], sampling, 60,
                                                script=PROGRESSION_3),
    }


def jpeg_files() -> dict:
    """name -> bytes of each JPEG kind of slice 18 (262x270)."""
    from PIL import Image

    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = SIZE
    rgb = smooth(h, w, seed=61, noise=0.05).astype(np.uint8)
    ycc = jpeg.rgb_to_ycbcr(rgb)
    planes = [ycc[..., i] for i in range(3)]
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=80, keep_rgb=True)
    cmyk = smooth(h, w, seed=62, channels=4, noise=0.05)
    ycck = jpeg.rgb_to_ycbcr((255 - cmyk[..., :3]).astype(np.uint8))
    return {
        "jpeg_keep_rgb.jpg": buf.getvalue(),
        "jpeg_rgb_ids.jpg": encode_jpeg([rgb[..., i] for i in range(3)], [(1, 1)] * 3,
                                        ids=[82, 71, 66], jfif=False),
        "jpeg_ycck.jpg": encode_jpeg([ycck[..., 0], ycck[..., 1], ycck[..., 2], cmyk[..., 3]],
                                     [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2, jfif=False),
        "jpeg_440.jpg": encode_jpeg(planes, [(1, 2), (1, 1), (1, 1)]),
        "jpeg_411.jpg": encode_jpeg(planes, [(4, 1), (1, 1), (1, 1)]),
        "jpeg_odd_chroma.jpg": encode_jpeg(planes, [(2, 2), (1, 2), (2, 1)]),
    }


# the files of slice 18, which chip_smoke.py phase 24 decodes
TAIL_FILES = ("bmp_", "tiff_", "gif_", "webp_animated_", "jpeg_", "textured_lzw")


def tail_files() -> dict:
    """name -> bytes of each file of slice 18."""
    return {**bmp_files(), **tiff_files(), **gif_files(), **animated_webp_files(), **jpeg_files()}


# the files of the TIFF codecs, colour spaces and sample layouts that came
# after slice 18 (JPEG-in-TIFF, YCbCr, CIELab, Zstandard, LZMA, CCITT, 12-,
# 32-bit, float, signed and bit-reversed gray), which chip_smoke.py phase
# 25 decodes
CODEC_FILES = ("tiffx_", "textured_jpeg")


def bilevel(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w) uint8 0/255 rows of runs of many lengths (short ones, the
    64-pixel make-up codes' edges, the long shared ones past 1728), some
    rows the row above shifted a little, as 2-D fax coding meets them."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w), np.uint8)
    for y in range(h):
        if y and rng.rand() < 0.4:
            img[y] = np.roll(img[y - 1], rng.randint(-3, 4))
            continue
        x, c = 0, rng.randint(2)
        while x < w:
            n = int(rng.choice([1, 2, 3, 5, 9, 30, 63, 64, 65, 127, 640, 1727, 1728, 1792, 2561]))
            img[y, x:x + n] = 255 * c
            x, c = x + n, c ^ 1
    return img


def codec_files() -> dict:
    """name -> bytes of each TIFF of the codecs, colour spaces and sample
    layouts after slice 18 (96x80 and 64x48, one fax file 2700 wide, and
    the 768x512 YCbCr 2x2 JPEG TIFF of ``chip_smoke.py::textured_rgb``
    (seed 5) that phase 25 times and attacks)."""
    from PIL import Image

    from imagecompression_adversarial_tpu_torch.io import jpeg

    h, w = 80, 96

    def pillow(im, **kwargs) -> bytes:
        buf = io.BytesIO()
        im.save(buf, format="TIFF", **kwargs)
        return buf.getvalue()

    rgb = smooth(h, w, seed=41, noise=0.05).astype(np.uint8)
    gray = smooth(h, w, seed=42, channels=1, noise=0.05)[..., 0].astype(np.uint8)
    ycc = jpeg.rgb_to_ycbcr(rgb)
    bw = Image.fromarray(bilevel(24, 2700, seed=43)).convert("1")
    floats = (smooth(h, w, seed=44, channels=1, levels=4096).astype(np.float32) / 9.0 - 60.0)
    ints = smooth(h, w, seed=45, channels=1, levels=1 << 16).astype(np.int64) - 30000
    small = smooth(48, 64, seed=48, channels=1, levels=512)[..., 0] - 128  # past 0..255 both ways
    sys.path.insert(0, ROOT)
    from chip_smoke import textured_rgb

    big = textured_rgb(*TEXTURED, seed=5)
    return {
        "tiffx_jpeg_rgb.tif": pillow(Image.fromarray(rgb), compression="jpeg", strip_size=w * 3 * 24),
        "tiffx_jpeg_gray.tif": pillow(Image.fromarray(gray), compression="jpeg", strip_size=w * 16),
        "tiffx_jpeg_ycbcr.tif": pillow(Image.fromarray(rgb).convert("YCbCr"), compression="jpeg",
                                       strip_size=w * 3 * 32),
        "tiffx_jpeg_tiled_ycbcr22.tif": write_tiff(ycc, 8, 6, compression=7, subsampling=(2, 2),
                                                   tile=(32, 48)),
        "tiffx_zstd.tif": pillow(Image.fromarray(rgb), compression="zstd"),
        "tiffx_lzma_gray.tif": pillow(Image.fromarray(gray), compression="lzma"),
        "tiffx_ycbcr22_lzw.tif": write_tiff(ycc, 8, 6, compression=5, subsampling=(2, 2),
                                            rows_per_strip=10),
        "tiffx_ycbcr41_zstd_rotated.tif": write_tiff(ycc, 8, 6, compression=50000,
                                                     subsampling=(4, 1), rows_per_strip=16,
                                                     orientation=6),
        "tiffx_ycbcr_lzma_refbw.tif": write_tiff(ycc, 8, 6, compression=34925, subsampling=(1, 1),
                                                 fields=[(532, 5, [16, 1, 235, 1, 128, 1, 240, 1,
                                                                   128, 1, 240, 1])]),
        "tiffx_ccitt_rle.tif": pillow(bw, compression="tiff_ccitt"),
        "tiffx_group3_2d.tif": pillow(bw, compression="group3", tiffinfo={292: 5}),
        "tiffx_group4_miniswhite.tif": pillow(bw, compression="group4", tiffinfo={262: 0}),
        "tiffx_int32.tif": pillow(Image.fromarray(small.astype(np.int32) * 3 - 100, "I")),
        "tiffx_float.tif": pillow(Image.fromarray(small.astype(np.float32) * 0.75 + 0.5, "F")),
        "tiffx_float_predictor3_zstd_mm.tif": write_tiff(
            floats.view(np.uint32).astype(np.int64), 32, 1, compression=50000, predictor=3,
            sample_format=3, order=">", rows_per_strip=20),
        "tiffx_int16_signed_lzma.tif": write_tiff(ints % (1 << 16), 16, 1, compression=34925,
                                                  predictor=2, sample_format=2),
        "tiffx_gray12.tif": write_tiff(smooth(h, w, seed=46, channels=1, levels=4096), 12, 1,
                                       compression=5, rows_per_strip=9),
        "tiffx_gray16_reversed.tif": write_tiff(smooth(h, w, seed=47, channels=1, levels=512), 16,
                                                1, fill_order=2),
        "tiffx_lab_lzw.tif": pillow(Image.fromarray(rgb[:48, :64]).convert("LAB"),
                                    compression="tiff_lzw"),
        "tiffx_lab_random_zstd.tif": write_tiff(np.random.RandomState(49).randint(0, 256, (48, 64, 3)),
                                                8, 8, compression=50000, rows_per_strip=12),
        "textured_jpeg.tif": write_tiff(jpeg.rgb_to_ycbcr(big), 8, 6, compression=7,
                                        subsampling=(2, 2), rows_per_strip=16, jpeg_quality=90),
    }


# ------------------------------------------------------------------ JPEG 2000

def _libopenjp2() -> ctypes.CDLL:
    """The OpenJPEG that Pillow's wheel bundles, else the system's."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    found = glob.glob(os.path.join(libs, "libopenjp2-*"))
    name = found[0] if found else ctypes.util.find_library("openjp2")
    if not name:
        raise RuntimeError("no libopenjp2 to encode with")
    lib = ctypes.CDLL(name)
    vp = ctypes.c_void_p
    lib.opj_version.restype = ctypes.c_char_p
    lib.opj_create_compress.restype = vp
    lib.opj_image_create.restype = vp
    lib.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn, n in (("opj_setup_encoder", 3), ("opj_start_compress", 3), ("opj_encode", 2),
                  ("opj_end_compress", 2), ("opj_set_error_handler", 3)):
        getattr(lib, fn).argtypes = [vp] * n
    for fn in ("opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy"):
        getattr(lib, fn).argtypes = [vp]
    return lib


# int32 indices of opj_cparameters_t's fields (openjpeg.h 2.5: 18,720 bytes
# on LP64; opj_set_default_encoder_parameters fills 6, 64, 64 at
# numresolution, cblockw_init, cblockh_init, -1 at roi_compno and 1, 1, -1,
# -1 at subsampling_dx .. cod_format, which pins them)
_OPJ_INT = {"tile_size_on": 0, "cp_tx0": 1, "cp_ty0": 2, "cp_tdx": 3, "cp_tdy": 4,
            "cp_disto_alloc": 5, "csty": 12, "prog_order": 13, "numpocs": 1198,
            "tcp_numlayers": 1199, "numresolution": 1400, "cblockw_init": 1401,
            "cblockh_init": 1402, "mode": 1403, "irreversible": 1404, "roi_compno": 1405,
            "roi_shift": 1406, "res_spec": 1407, "image_offset_x0": 4547, "image_offset_y0": 4548}
_OPJ_CHAR = {"tp_on": 18696, "tp_flag": 18697, "tcp_mct": 18698}  # byte offsets
_OPJ_RATES, _OPJ_PRCW, _OPJ_PRCH, _OPJ_POC, _OPJ_POC_INTS = 1200, 1408, 1441, 14, 37
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def openjpeg_encode(planes, prec: int = 8, signed: bool = False, sub=None, color_space: int = 1,
                    jp2: bool = True, rates=(0.0,), precincts=(), pocs=(), size=None,
                    **fields) -> bytes:
    """A JPEG 2000 file (a JP2 file, or a raw codestream where ``jp2`` is
    false) of the 2-D integer ``planes`` by the bundled OpenJPEG's encoder,
    with settings Pillow's ``save`` does not pass on: ``sub`` (dx, dy) a
    component, ``color_space`` (OpenJPEG's: 1 sRGB, 2 gray, 3 sYCC),
    ``rates`` a layer, ``precincts`` (width, height) a resolution from
    the highest, ``pocs`` (res0, comp0, layer1, res1,
    comp1, progression) and ``fields`` of opj_cparameters_t (``mode`` the
    code-block style, ``csty`` 2 for SOP and 4 for EPH, ``roi_compno``,
    ``roi_shift``, ``tp_on``, ...)."""
    import tempfile

    lib = _libopenjp2()
    sub = sub or [(1, 1)] * len(planes)
    x0, y0 = fields.pop("image_offset_x0", 0), fields.pop("image_offset_y0", 0)
    h0, w0 = planes[0].shape
    width, height = size or (w0 * sub[0][0], h0 * sub[0][1])
    cmpt = (ctypes.c_uint32 * (9 * len(planes)))()
    for i, p in enumerate(planes):
        cmpt[9 * i:9 * i + 9] = [sub[i][0], sub[i][1], p.shape[1], p.shape[0], x0, y0, prec, prec,
                                 int(signed)]
    image = lib.opj_image_create(len(planes), cmpt, color_space)
    head = ctypes.cast(image, ctypes.POINTER(ctypes.c_uint32))
    head[0], head[1], head[2], head[3] = x0, y0, x0 + width, y0 + height
    comps = ctypes.cast(image + 24, ctypes.POINTER(ctypes.c_void_p))[0]
    for i, p in enumerate(planes):
        comp = comps + 64 * i  # opj_image_comp_t: 11 uint32, then its data pointer
        data = ctypes.cast(comp + 48, ctypes.POINTER(ctypes.c_void_p))[0]
        flat = np.ascontiguousarray(p, np.int32)
        ctypes.memmove(data, flat.ctypes.data, flat.nbytes)
    params = (ctypes.c_int32 * 4680)()
    lib.opj_set_default_encoder_parameters(params)
    raw = ctypes.cast(params, ctypes.POINTER(ctypes.c_uint8))
    fields.setdefault("tcp_mct", 1 if len(planes) >= 3 else 0)
    for name, value in fields.items():
        if name in _OPJ_INT:
            params[_OPJ_INT[name]] = value
        else:
            raw[_OPJ_CHAR[name]] = value if isinstance(value, int) else ord(value)
    params[_OPJ_INT["tcp_numlayers"]] = len(rates)
    params[_OPJ_INT["cp_disto_alloc"]] = 1
    floats = ctypes.cast(ctypes.addressof(params) + 4 * _OPJ_RATES, ctypes.POINTER(ctypes.c_float))
    for i, rate in enumerate(rates):
        floats[i] = rate
    if precincts:
        params[_OPJ_INT["res_spec"]] = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            params[_OPJ_PRCW + i], params[_OPJ_PRCH + i] = pw, ph
        params[_OPJ_INT["csty"]] |= 1
    for i, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):  # opj_poc_t's first ten uint32
        poc = _OPJ_POC + _OPJ_POC_INTS * i
        params[poc:poc + 10] = [r0, c0, l1, r1, c1, 0, 0, 0, prg, prg]
        params[poc + 12] = 1  # its tile, from 1
    params[_OPJ_INT["numpocs"]] = len(pocs)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    errors = []
    handler = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)(
        lambda msg, _: errors.append(msg.decode().strip()))
    lib.opj_set_error_handler(codec, handler, None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.jp2")
        ok = lib.opj_setup_encoder(codec, params, image)
        if ok:
            stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
            ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                  and lib.opj_end_compress(codec, stream))
            lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        if not ok:
            raise RuntimeError(f"OpenJPEG refuses the settings: {errors}")
        with open(path, "rb") as f:
            return f.read()


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_header_edit(data: bytes, colr: int = None, extra: bytes = b"") -> bytes:
    """A JP2 file with its colr box's enumerated colour space set to
    ``colr`` and the boxes ``extra`` appended to its jp2h box."""
    at = data.index(b"jp2h") - 4
    size = struct.unpack(">I", data[at:at + 4])[0]
    header = bytearray(data[at + 8:at + size])
    if colr is not None:
        c = header.index(b"colr")
        header[c + 7:c + 11] = struct.pack(">I", colr)
    return data[:at] + _box(b"jp2h", bytes(header) + extra) + data[at + size:]


def pclr_boxes(entries: np.ndarray) -> bytes:
    """A pclr box of (n, channels) 8-bit entries and the cmap box that maps
    the one component through it."""
    n, npc = entries.shape
    pclr = struct.pack(">HB", n, npc) + bytes([7] * npc) + entries.astype(np.uint8).tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))
    return _box(b"pclr", pclr) + _box(b"cmap", cmap)


def _segments(cs: bytes, pos: int, stop: int):
    """(marker, payload, start) of each marker segment from ``pos`` up to
    the marker ``stop``, and where that marker is."""
    out = []
    while True:
        marker = struct.unpack(">H", cs[pos:pos + 2])[0]
        if marker == stop:
            return out, pos
        length = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
        out.append((marker, cs[pos + 4:pos + 2 + length], pos))
        pos += 2 + length


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, 2 + len(payload)) + payload


def packed_headers(cs: bytes, where: str) -> bytes:
    """A raw codestream written with SOP and EPH markers (COD's Scod 6), its
    packet headers moved into PPT segments (``where`` "ppt") or one PPM
    segment of the main header ("ppm"); the EPH markers go, the SOP
    markers stay."""
    main, sot = _segments(cs, 2, 0xFF90)
    parts = []
    pos = sot
    while struct.unpack(">H", cs[pos:pos + 2])[0] == 0xFF90:
        _, isot, psot, tpsot, tnsot = struct.unpack(">HHIBB", cs[pos + 2:pos + 12])
        header, sod = _segments(cs, pos + 12, 0xFF93)
        body = cs[sod + 2:pos + psot]
        headers, bodies, at = [], [], 0
        while at < len(body):
            assert body[at:at + 2] == b"\xff\x91", "a packet without its SOP marker"
            eph = body.index(b"\xff\x92", at + 6)
            nxt = body.find(b"\xff\x91", eph + 2)
            nxt = len(body) if nxt < 0 else nxt
            headers.append(body[at + 6:eph])
            bodies.append(body[at:at + 6] + body[eph + 2:nxt])
            at = nxt
        parts.append((isot, tpsot, tnsot, header, b"".join(headers), b"".join(bodies)))
        pos += psot
    out = bytearray(b"\xff\x4f")
    for marker, payload, _ in main:
        if marker == 0xFF52:
            payload = bytes([payload[0] & ~4]) + payload[1:]
        out += _segment(marker, payload)
        if marker == 0xFF5C and where == "ppm":
            stream = b"".join(struct.pack(">I", len(p[4])) + p[4] for p in parts)
            for z, k in enumerate(range(0, len(stream), 65000)):
                out += _segment(0xFF60, bytes([z]) + stream[k:k + 65000])
    zppt = {}  # a tile's next Zppt: its PPT segments count on over its tile-parts
    for isot, tpsot, tnsot, header, headers, bodies in parts:
        th = b"".join(_segment(m, p) for m, p, _ in header)
        if where == "ppt":
            for k in range(0, len(headers), 65000):
                z = zppt.get(isot, 0)
                zppt[isot] = z + 1
                th += _segment(0xFF61, bytes([z]) + headers[k:k + 65000])
        psot = 12 + len(th) + 2 + len(bodies)
        out += struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tpsot, tnsot) + th + b"\xff\x93"
        out += bodies
    return bytes(out + b"\xff\xd9")


def htj2k_flat(size: int = 16, value: int = 77) -> bytes:
    """A raw HTJ2K (Part 15) codestream: a gray ``size`` x ``size`` 5/3
    codestream of OpenJPEG's with Rsiz's Part 15 bit, a CAP segment and the
    HT code-block style set, whose one packet is empty, so that every
    coefficient is 0 (Pillow reads it as mid-gray)."""
    cs = openjpeg_encode([np.full((size, size), value)], jp2=False, numresolution=1,
                         color_space=2)
    main, _ = _segments(cs, 2, 0xFF90)
    out = bytearray(b"\xff\x4f")
    for marker, payload, _ in main:
        if marker == 0xFF51:
            payload = struct.pack(">H", struct.unpack(">H", payload[:2])[0] | 0x4000) + payload[2:]
            out += _segment(marker, payload) + _segment(0xFF50, struct.pack(">IH", 0x00020000, 0))
            continue
        if marker == 0xFF52:
            payload = payload[:8] + bytes([payload[8] | 0x40]) + payload[9:]
        out += _segment(marker, payload)
    return bytes(out + struct.pack(">HHHIBB", 0xFF90, 10, 0, 15, 0, 1) + b"\xff\x93\x00\xff\xd9")


def _pillow_j2k(img: np.ndarray, mode: str, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint16 if mode == "I;16" else np.uint8), mode).save(
        buf, format="JPEG2000", **kw)
    return buf.getvalue()


def jpeg2000_files() -> dict:
    """name -> bytes of each JPEG 2000 file, at most 64x64 but the 768x512
    pair: Pillow's (the default lossless 5/3, 9/7 in rate layers, each
    progression, precincts, tiles at tile and image offsets, code-block
    sizes, MCT off, a raw codestream; L, LA, RGBA and I;16) and
    ``openjpeg_encode``'s (each code-block style and all of them, SOP and
    EPH, POC, ROI, PPT and PPM, 4:2:0 sYCC and a raw 4:2:0 codestream,
    signed and 12-bit samples, a palette, CMYK, tile-parts, a code-block
    byte flipped); then ``textured_j2k.jp2``, 9/7 at ratio 20 of
    ``chip_smoke.py::textured_rgb`` (seed 5), which phase 27 times and
    attacks, and ``textured_j2k53.jp2``, the lossless 5/3 of a smoother
    768x512 image, which it times."""
    rgb = smooth(48, 64, seed=81, noise=0.3)
    sq = smooth(64, 64, seed=82, noise=0.4)
    gray = smooth(60, 52, seed=83, channels=1, noise=0.3)[..., 0]
    odd = smooth(47, 61, seed=84, noise=0.3)
    planes = [sq[..., i] for i in range(3)]
    files = {
        "j2k_lossless_rgb.jp2": _pillow_j2k(rgb, "RGB"),
        "j2k_97_layers.jp2": _pillow_j2k(sq, "RGB", irreversible=True, quality_mode="rates",
                                         quality_layers=[40, 16, 6]),
        "j2k_tiles_offsets.jp2": _pillow_j2k(odd, "RGB", tile_size=(24, 20), tile_offset=(3, 5),
                                             offset=(7, 9), codeblock_size=(8, 16),
                                             precinct_size=(16, 16), num_resolutions=3),
        "j2k_tiles_97.jp2": _pillow_j2k(odd, "RGB", tile_size=(32, 16), offset=(1, 2),
                                        irreversible=True, quality_layers=[12, 4],
                                        codeblock_size=(16, 4), num_resolutions=3),
        "j2k_nomct.jp2": _pillow_j2k(sq, "RGB", mct=0, irreversible=True, quality_layers=[10]),
        "j2k_raw.j2k": _pillow_j2k(rgb, "RGB", no_jp2=True, irreversible=True,
                                   quality_layers=[30, 8]),
        "j2k_gray.jp2": _pillow_j2k(gray, "L", irreversible=True, quality_layers=[8]),
        "j2k_gray_alpha.jp2": _pillow_j2k(smooth(40, 44, seed=85, channels=2, noise=0.3), "LA"),
        "j2k_rgba.jp2": _pillow_j2k(smooth(44, 40, seed=86, channels=4, noise=0.3), "RGBA",
                                    irreversible=True, quality_layers=[6]),
        "j2k_gray16.jp2": _pillow_j2k(wide(gray), "I;16"),
    }
    for i, prog in enumerate(PROGRESSIONS):
        files[f"j2k_prog_{prog.lower()}.jp2"] = _pillow_j2k(
            sq, "RGB", progression=prog, irreversible=bool(i % 2), quality_layers=[30, 10, 3],
            precinct_size=(32, 32), codeblock_size=(8, 8), num_resolutions=4)
    small = dict(numresolution=4, cblockw_init=16, cblockh_init=16)
    layers = (24.0, 8.0, 3.0)
    for bit, style in ((1, "lazy"), (2, "reset"), (4, "termall"), (8, "vsc"), (16, "pterm"),
                       (32, "segsym"), (63, "all")):
        lossless = bit in (1, 63)
        files[f"j2kx_style_{style}.j2k"] = openjpeg_encode(
            planes, jp2=False, mode=bit, irreversible=0 if lossless else 1,
            rates=(0.0,) if lossless else layers, prog_order=2 if bit == 63 else 0, **small)
    sop_eph = openjpeg_encode(planes, jp2=False, csty=6, irreversible=1, rates=layers,
                              precincts=[(32, 32), (16, 16)], **small)
    sycc = smooth(64, 64, seed=87, noise=0.3)
    half = [sycc[::2, ::2, 1], sycc[::2, ::2, 2]]
    palette = np.array([(200, 30, 40), (20, 220, 60), (200, 30, 40), (30, 40, 230),
                        (250, 250, 10), (0, 0, 0), (20, 220, 60), (120, 60, 200)])
    files.update({
        "j2kx_sop_eph.j2k": sop_eph,
        "j2kx_ppt.j2k": packed_headers(sop_eph, "ppt"),
        "j2kx_ppm.j2k": packed_headers(sop_eph, "ppm"),
        "j2kx_poc.j2k": openjpeg_encode(planes, jp2=False, irreversible=1, rates=layers,
                                        pocs=[(0, 0, 1, 2, 3, 1), (0, 0, 3, 4, 2, 4),
                                              (2, 2, 3, 4, 3, 0)], **small),
        "j2kx_roi.j2k": openjpeg_encode(planes, jp2=False, irreversible=1, rates=layers,
                                        roi_compno=0, roi_shift=6, **small),
        "j2kx_sycc420.jp2": openjpeg_encode([sycc[..., 0], *half], sub=[(1, 1), (2, 2), (2, 2)],
                                            color_space=3, tcp_mct=0, irreversible=1,
                                            rates=(5.0,), **small),
        "j2kx_raw420.j2k": openjpeg_encode([sycc[..., 0], *half], sub=[(1, 1), (2, 2), (2, 2)],
                                           jp2=False, tcp_mct=0, **small),
        "j2kx_signed8.jp2": openjpeg_encode([gray - 128], signed=True, color_space=2,
                                            numresolution=3),
        "j2kx_gray12.jp2": openjpeg_encode([gray * 16 + gray // 16], prec=12, color_space=2,
                                           irreversible=1, rates=(6.0,), numresolution=3),
        "j2kx_rgb12_signed.jp2": openjpeg_encode([p * 16 - 2048 for p in planes], prec=12,
                                                 signed=True, **small),
        "j2kx_palette.jp2": jp2_header_edit(
            openjpeg_encode([gray % 9], color_space=1, numresolution=3), extra=pclr_boxes(palette)),
        "j2kx_cmyk.jp2": jp2_header_edit(
            openjpeg_encode([*planes, smooth(64, 64, seed=88, channels=1)[..., 0]], tcp_mct=0,
                            irreversible=1, rates=(8.0,), **small), colr=12),
        "j2kx_tileparts.j2k": openjpeg_encode(planes, jp2=False, irreversible=1, rates=layers,
                                              tile_size_on=1, cp_tdx=32, cp_tdy=32, tp_on=1,
                                              tp_flag="R", numresolution=3),
    })
    corrupt = bytearray(files["j2k_97_layers.jp2"])
    corrupt[len(corrupt) * 2 // 3] ^= 0x5A  # inside a code-block's bytes
    files["j2kx_corrupt.jp2"] = bytes(corrupt)
    sys.path.insert(0, ROOT)
    from chip_smoke import textured_rgb

    files["textured_j2k.jp2"] = _pillow_j2k(textured_rgb(*TEXTURED, seed=5), "RGB",
                                            irreversible=True, quality_mode="rates",
                                            quality_layers=[20])
    files["textured_j2k53.jp2"] = _pillow_j2k(smooth(*TEXTURED, seed=89, noise=0.02), "RGB")
    return files



def textured_file() -> bytes:
    """The 768x512 progressive q90 JPEG of ``chip_smoke.py::textured_rgb``."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from chip_smoke import textured_rgb

    buf = io.BytesIO()
    Image.fromarray(textured_rgb(*TEXTURED, seed=5)).save(buf, format="JPEG", quality=90,
                                                          progressive=True)
    return buf.getvalue()


def pillow_record(path: str) -> dict:
    """sha256, shape and mode of what Pillow makes of a file."""
    import PIL
    from PIL import Image, features

    with Image.open(path) as im:
        rgb = np.ascontiguousarray(np.asarray(im.convert("RGB")), np.uint8)
        record = {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(), "shape": list(rgb.shape),
                  "mode": im.mode, "pillow": PIL.__version__}
    if path.endswith(".webp"):
        record["libwebp"] = features.version("webp")
    return record


def main() -> None:
    sys.path.insert(0, ROOT)
    files = {**kind_files(), "textured_progressive.jpg": textured_file(), **webp_files(),
             **tail_files(), **codec_files(), **slice20_files(), **jpeg2000_files()}
    records = {}
    for name, data in files.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        records[name] = pillow_record(path)
        print(f"{name}: {len(data)} bytes, {records[name]['mode']}")
    with open(os.path.join(HERE, "inputs.json"), "w") as f:
        json.dump(records, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{sum(len(d) for d in files.values())} bytes in all")


if __name__ == "__main__":
    main()

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
at sharpness 6).  Then ``inputs.json``: for
each file the sha256 of Pillow's ``Image.open(path).convert("RGB")``
bytes, their shape, Pillow's mode and version, and libwebp's version for a
WebP.  ``tests/test_torch_image_kinds.py`` holds the pixels to the hashes
where Pillow is installed, and ``chip_smoke.py`` phases 22 and 23 hold the
port's decoders to them on the card.

``write_png`` writes any PNG kind from samples, the first rows of each
Adam7 pass with each of the five filters in turn; the tests import it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import hashlib
import io
import json
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
    files = {**kind_files(), "textured_progressive.jpg": textured_file(), **webp_files()}
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

"""Image IO with pad-to-multiple semantics (port of
``imagecompression_adversarial_tpu/io/image.py``).

Arrays are (1, H_pad, W_pad, 3) float32 numpy in [0, 1], as in the JAX
package; ``to_tensor`` makes the port's NCHW channels_last tensor.  No PIL:
the format is told by the file's first bytes, and

* PNG is read by the host C++ decoder (``io/png.py``, ``csrc/png.cc``):
  every colour type (gray, RGB, palette, gray+alpha, RGBA), bit depths 1
  to 16, interlaced or not;
* JPEG by the host C++ decoder (``io/jpeg.py``, ``csrc/jpeg.cc``):
  baseline, sequential of several scans and progressive Huffman files of
  8-bit samples, Huffman or arithmetic-coded, and lossless ones; gray,
  YCbCr, RGB-coded, CMYK and YCCK, at every sampling libjpeg accepts;
* WebP by the host C++ decoder (``io/webp.py``, ``csrc/webp.cc``): lossy
  (VP8) and lossless (VP8L) files, with or without alpha, and the first
  frame of an animated one;
* TIFF by the host C++ decoder (``io/tiff.py``, ``csrc/tiff.cc``): the
  first image, strips or tiles, chunky or planar, uncompressed, PackBits,
  LZW, Deflate, Zstandard, LZMA, CCITT (RLE, Group 3, Group 4) or JPEG
  (its strips or tiles by the JPEG decoder); gray of 1 to 32 bits
  (signed, unsigned, floating-point), RGB(A), palette, CMYK, YCbCr and
  CIELab;
* GIF by the host C++ decoder (``io/gif.py``, ``csrc/gif.cc``): the
  first frame;
* BMP with numpy (``io/bmp.py``): palettes, RLE8 and RLE4, 16-, 24- and
  32-bit, bitfields;
* Netpbm with numpy (``io/netpbm.py``): P1-P6, plain and raw, at any
  maxval, and gray PFM;
* JPEG 2000 by the host C++ decoder (``io/jpeg2000.py``,
  ``csrc/jpeg2000.cc``): JP2 files and raw codestreams of Part 1, every
  progression, code-block style, quantisation and tiling, 1 to 4
  components of 1 to 31 bits, subsampled, sYCC, CMYK and palette.

The JAX package reads in two ways, and so does the port.  ``read_pixels``
gives what ``Image.open(path).convert("RGB")`` gives, for every kind above;
the training stream, the classifier's folders and ``jpeg_baseline`` read
through it, as JAX's convert.  ``read_image``, which the CLIs read
through, gives what JAX's ``np.asarray(Image.open(path))`` gives (gray
tiled into RGB, alpha dropped), and so decodes only the files Pillow
opens as ``L``, ``RGB`` or ``RGBA``, where the two agree.  On a file
Pillow opens as ``P``, ``PA``, ``1``, ``LA``, ``I;16``, ``I;16B``,
``CMYK``, ``I``, ``F`` or ``LAB`` it raises ``UnsupportedImageError``
naming the format, the kind and the mode ("a palette BMP", "a 16-bit gray
TIFF", ...), where JAX's CLIs would take palette indices, booleans, two
channels, raw 16- or 32-bit values, floats, inverted CMY or L*a*b* as
pixels.  What Pillow
reads and no reader here decodes (a lossless JPEG of subsampled
components, an old-style JPEG TIFF, ...) raises ``UnsupportedImageError``,
naming it; a kind Pillow refuses too (a 12-bit or hierarchical JPEG, a
PAM file, ...) its subclass ``RefusedByPillowError``; a broken file
raises ``ValueError``.  Formats Pillow opens that no reader here knows
(QOI, TGA, PCX, SGI, ICO, AVIF, ...) raise ``ValueError``.
The writer emits 8-bit RGB PNGs.
"""

from __future__ import annotations

import glob as _glob
from typing import List, Tuple

import numpy as np
import torch

from . import bmp, gif, jpeg, jpeg2000, netpbm, png, tiff, webp
from .errors import UnsupportedImageError

# the Pillow modes ``read_image`` refuses: the kind of image each is, and
# what JAX's ``np.asarray(Image.open(path))`` gives for it
_REFUSED_MODES = {"P": ("palette", "palette indices"),
                  "PA": ("palette+alpha", "palette indices and alpha"),
                  "1": ("1-bit", "booleans"),
                  "LA": ("gray+alpha", "two channels"),
                  "I;16": ("16-bit gray", "raw 16-bit values"),
                  "I;16B": ("16-bit gray", "raw 16-bit values"),
                  "CMYK": ("CMYK", "the CMYK samples"),
                  "I": ("32-bit integer gray", "raw int32 values, past 255"),
                  "F": ("floating-point gray", "raw float values, past 255"),
                  "LAB": ("CIELab", "the L*, a* and b* samples")}


def pad_to_multiple(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Zero-pad an HWC image up to the next multiple along H and W."""
    h, w, c = img.shape
    hp = int(multiple * np.ceil(h / multiple))
    wp = int(multiple * np.ceil(w / multiple))
    out = np.zeros((hp, wp, c), dtype=img.dtype)
    out[:h, :w] = img
    return out


_TIFF_MAGIC = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def _decode(path: str) -> Tuple[np.ndarray, str, str]:
    """An image file's (H, W, 3) uint8 pixels as Pillow's
    ``convert("RGB")`` gives them, the mode Pillow opens it as, and the
    name of its format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == png.SIGNATURE:
        parsed = png.parse(data)
        return png.decode_png_native(parsed), parsed.mode, "PNG"
    if data[:2] == b"\xff\xd8":
        frame = jpeg.parse(data)
        img = jpeg.decode_frame_native(frame)
        return (np.repeat(img, 3, axis=2) if frame.mode == "L" else img), frame.mode, "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        parsed = webp.parse(data)
        return webp.decode_webp_native(parsed), parsed.mode, "WebP"
    if data[:2] == b"BM":
        return (*bmp.decode(data), "BMP")
    if data[:4] in _TIFF_MAGIC:
        parsed = tiff.parse(data)
        return tiff.decode_tiff_native(parsed), parsed.mode, "TIFF"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        parsed = gif.parse(data)
        return gif.decode_gif_native(parsed), parsed.mode, "GIF"
    if netpbm.is_netpbm(data):
        return (*netpbm.decode(data), "Netpbm")
    if data[:12] == jpeg2000.JP2_SIGNATURE or data[:4] == jpeg2000.J2K_SIGNATURE:
        return (*jpeg2000.decode_native(data), "JPEG 2000")
    raise ValueError(f"not a PNG, JPEG, WebP, TIFF, GIF, BMP, Netpbm or JPEG 2000 file (it "
                     f"starts with {data[:8]!r})")


def read_pixels(path: str) -> np.ndarray:
    """An image file's (H, W, 3) uint8 RGB pixels (PNG, JPEG, WebP, TIFF,
    GIF, BMP, Netpbm or JPEG 2000), as ``Image.open(path).convert("RGB")``
    gives them."""
    return _decode(path)[0]


def read_image(path: str, padding: int = 64) -> Tuple[np.ndarray, int, int]:
    """Load a PNG, JPEG, WebP, TIFF, GIF, BMP, Netpbm or JPEG 2000 file that
    Pillow opens as ``L``,
    ``RGB`` or ``RGBA`` as (1, H_pad, W_pad, 3) float32 in [0, 1]; returns
    ``(im, H, W)``.  Gray is repeated into RGB; RGBA loses its alpha.
    Raises ``UnsupportedImageError`` naming the format, the kind and the
    mode on the other modes."""
    pixels, mode, fmt = _decode(path)
    if mode in _REFUSED_MODES:
        kind, what = _REFUSED_MODES[mode]
        raise UnsupportedImageError(
            f"{path}: a {kind} {fmt} (Pillow's mode {mode}) is read by read_pixels, not "
            f"read_image: JAX's read_image would take its {what} as pixels (L, RGB and RGBA "
            "only)")
    img = pixels.astype(np.float32) / 255.0
    h, w, _ = img.shape
    return pad_to_multiple(img, padding)[None, ...], h, w


def write_image(x: np.ndarray, path: str, H: int | None = None, W: int | None = None) -> None:
    """Save a (1, H, W, 3) float array as an 8-bit RGB PNG cropped to (H, W)."""
    arr = np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    if H is None and W is None:
        H, W = arr.shape[0], arr.shape[1]
    out = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(png.encode(np.ascontiguousarray(out[:H, :W, :])))


def list_images(pattern: str) -> List[str]:
    """Expand a source glob (the ``-s`` flag)."""
    return sorted(_glob.glob(pattern))


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """(1, h, w, 3) float32 in [0, 1] made with numpy from ``seed``: smooth
    gradients plus a little noise, a stand-in for a photo where no image
    files are at hand."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 40.0 + seed),
            0.5 + 0.4 * np.cos(yy / 60.0),
            0.5 + 0.2 * np.sin((xx + yy) / 30.0),
        ],
        -1,
    ) + 0.05 * rng.rand(h, w, 3)
    return np.clip(img, 0.0, 1.0).astype(np.float32)[None]


def to_tensor(im: np.ndarray, device) -> torch.Tensor:
    """(n, H, W, 3) numpy -> (n, 3, H, W) float32 channels_last tensor."""
    t = torch.from_numpy(np.ascontiguousarray(im, np.float32)).to(device)
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """(n, C, H, W) tensor -> (n, H, W, C) numpy."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()

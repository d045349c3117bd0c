"""WebP inputs (slice 17) on the CPU, against Pillow 12.1.0 (libwebp 1.6.0)
and the JAX package:

* lossy files (q 0 to 100, methods 0, 4 and 6, sizes 1x1 to 270x262, with
  alpha, with ICC, EXIF and XMP chunks; through libwebp's own API the
  simple loop filter, sharpness 2 and 7, one segment) and lossless ones
  (gray, 2 to 200 colours, noise, gradients, the top-left predictor, alpha
  kept exactly, methods 0 and 6, quality 0 and 100): ``read_pixels``
  gives Pillow's ``convert("RGB")`` bit for bit, ``read_image`` JAX's
  ``read_image``, and ``parse`` Pillow's mode;
* VP8 frames written here with a boolean encoder, with what libwebp never
  writes (segment values relative to the frame's, loop-filter deltas, 2,
  4 and 8 token partitions, deltas on every quantizer): Pillow's pixels;
* the mode where the VP8X alpha flag, the VP8L alpha bit and an ALPH chunk
  disagree: Pillow's; an animated file gives Pillow's first frame, a still
  one flagged as animated raises;
* cut, resized and flipped files raise ``ValueError`` or give Pillow's
  pixels, and never crash; 16 threads decode side by side;
* a decoder that cannot be built raises, and nothing falls back.

With the committed files of ``tests/data/inputs`` these reach every line
of ``csrc/webp.cc``.  Files are at most 270x262 (one 61x300), made with
numpy from seeds (~10 s in all, the decoder's build included).
"""

import concurrent.futures as cf
import importlib.util
import io
import os
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu_torch.io import webp
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels
from imagecompression_adversarial_tpu_torch.kernels import _build

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs",
                                               os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)


def _smooth(h, w, seed, channels=3, noise=0.3):
    return make_inputs.smooth(h, w, seed, channels=channels, noise=noise).astype(np.uint8)


def _save(img: Image.Image, **kwargs) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="WEBP", **kwargs)
    return buf.getvalue()


def _pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB")), im.mode


def _holds(tmp_path, data: bytes) -> None:
    """``read_pixels`` gives Pillow's RGB, ``read_image`` JAX's array and
    ``parse`` Pillow's mode."""
    path = str(tmp_path / "x.webp")
    with open(path, "wb") as f:
        f.write(data)
    want, mode = _pillow(data)
    assert webp.parse(data).mode == mode
    np.testing.assert_array_equal(read_pixels(path), want)
    got, jax = read_image(path), j_read_image(path)
    assert got[1:] == jax[1:] == want.shape[:2]
    np.testing.assert_array_equal(got[0], jax[0])


def _lossy(case: str) -> bytes:
    kind, _, arg = case.partition("-")
    if kind == "q":
        return _save(Image.fromarray(_smooth(67, 93, 1)), quality=int(arg))
    if kind == "method":
        return _save(Image.fromarray(_smooth(67, 93, 2)), quality=70, method=int(arg))
    if kind == "size":
        h, w = map(int, arg.split("x"))
        return _save(Image.fromarray(_smooth(h, w, 3)), quality=75)
    if kind == "alpha":
        return _save(Image.fromarray(_smooth(67, 93, 4, channels=4), "RGBA"), quality=60,
                     alpha_quality=int(arg))
    if kind == "chunks":
        return _save(Image.fromarray(_smooth(67, 93, 5)), quality=80, icc_profile=b"\x07" * 131,
                     exif=b"Exif\x00\x00" + b"\x01" * 37, xmp=b"<x:xmpmeta/>")
    fields = {"simple": {"filter_type": 0}, "segments": {"segments": 1},
              "sharpness": {"filter_sharpness": int(arg or 0)}}[kind]
    return make_inputs.libwebp_encode(_smooth(59, 83, 6), 40, **fields)


LOSSY = ["q-0", "q-10", "q-50", "q-90", "q-100", "method-0", "method-4", "method-6", "size-1x1",
         "size-9x17", "size-262x270", "alpha-50", "alpha-100", "chunks", "simple", "sharpness-2",
         "sharpness-7", "segments"]


@pytest.mark.parametrize("case", LOSSY)
def test_lossy_webp_gives_pillows_pixels_and_jaxs_array(tmp_path, case):
    _holds(tmp_path, _lossy(case))


def _lossless(case: str) -> bytes:
    kind, _, arg = case.partition("-")
    h, w = 61, 87
    rng = np.random.RandomState(len(case))
    if kind == "colours":
        palette = rng.randint(0, 256, (int(arg), 3)).astype(np.uint8)
        return _save(Image.fromarray(palette[rng.randint(0, int(arg), (h, w))]), lossless=True)
    if kind == "gray":
        return _save(Image.fromarray(_smooth(h, w, 7, channels=1)[..., 0], "L"), lossless=True)
    if kind == "noise":
        return _save(Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)),
                     lossless=True)
    if kind == "alpha":  # alpha 0 over varied colours: kept only with exact
        rgba = _smooth(h, w, 8, channels=4)
        rgba[..., 3] = np.where(rgba[..., 3] < 128, 0, rgba[..., 3])
        return _save(Image.fromarray(rgba, "RGBA"), lossless=True, exact=True)
    if kind == "diagonal":  # more colours than a palette holds, each pixel its top-left's
        d = np.arange(h + 300)
        stripes = np.stack([128 + 60 * np.sin(d / (9.0 + 4 * c)) for c in range(3)], -1)
        stripes = (stripes + rng.randint(-4, 5, (h + 300, 3))).astype(np.uint8)
        return _save(Image.fromarray(stripes[np.arange(300)[None] - np.arange(h)[:, None] + h]),
                     lossless=True)
    gradient = _smooth(h, w, 9, noise=0.0)
    if kind == "gradient":
        return _save(Image.fromarray(gradient), lossless=True)
    option = {"method": "method", "q": "quality"}[kind]
    return _save(Image.fromarray(gradient), lossless=True, **{option: int(arg)})


LOSSLESS = ["gray", "colours-2", "colours-4", "colours-16", "colours-200", "noise", "gradient",
            "diagonal", "alpha", "method-0", "method-6", "q-0", "q-100"]


@pytest.mark.parametrize("case", LOSSLESS)
def test_lossless_webp_gives_pillows_pixels_and_jaxs_array(tmp_path, case):
    _holds(tmp_path, _lossless(case))


def _set(data: bytes, at: int, fmt: str, value: int) -> bytes:
    out = bytearray(data)
    struct.pack_into(fmt, out, at, value)
    return bytes(out)


def _flag(data: bytes, bit: int, on: bool) -> bytes:
    """The file with VP8X flag ``bit`` set or cleared."""
    assert data[12:16] == b"VP8X"
    out = bytearray(data)
    out[20] = out[20] | bit if on else out[20] & ~bit
    return bytes(out)


def test_the_mode_is_pillows_where_the_alpha_signs_disagree(tmp_path):
    """Lossless: the VP8L header's alpha bit, whatever the VP8X flag says;
    lossy: the VP8X flag, or an ALPH chunk."""
    rgba = Image.fromarray(_smooth(13, 11, 10, channels=4), "RGBA")
    rgb = Image.fromarray(_smooth(13, 11, 11))
    exif = {"exif": b"Exif\x00\x00abc"}  # makes Pillow write a VP8X chunk
    cases = {
        "lossless, bit set, flag cleared": _flag(_save(rgba, lossless=True, **exif), 0x10, False),
        "lossless, bit clear, flag set": _flag(_save(rgb, lossless=True, **exif), 0x10, True),
        "lossy, ALPH, flag cleared": _flag(_save(rgba, quality=50), 0x10, False),
        "lossy, no ALPH, flag set": _flag(_save(rgb, quality=50, **exif), 0x10, True),
    }
    modes = {}
    for name, data in cases.items():
        _holds(tmp_path, data)
        modes[name] = webp.parse(data).mode
    assert modes == {"lossless, bit set, flag cleared": "RGBA",
                     "lossless, bit clear, flag set": "RGB",
                     "lossy, ALPH, flag cleared": "RGBA", "lossy, no ALPH, flag set": "RGBA"}


def test_an_animated_webp_raises_naming_itself(tmp_path):
    """Since slice 18 an animated WebP gives Pillow's first frame
    (``read_pixels``) and JAX's ``read_image``; a still file whose VP8X
    animation flag is set, which Pillow refuses, raises ``ValueError``."""
    frames = [Image.fromarray(_smooth(16, 16, s)) for s in (12, 13)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=50)
    animated = buf.getvalue()
    with Image.open(io.BytesIO(animated)) as im:
        assert im.n_frames == 2
    path = tmp_path / "a.webp"
    path.write_bytes(animated)
    _holds(tmp_path, animated)
    flagged = _flag(_save(frames[0], exif=b"Exif\x00\x00abc"), 0x02, True)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(flagged)).load()
    path.write_bytes(flagged)
    for read in (read_pixels, read_image):
        with pytest.raises(ValueError, match="animation whose image lies outside an ANMF"):
            read(str(path))


class _BoolWriter:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put((value >> i) & 1, 128)

    def signed(self, value: int, n: int):
        self.literal(abs(value), n)
        self.literal(int(value < 0), 1)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _tables():
    """RFC 6386's coefficient update and default probabilities and the
    4x4 mode probabilities, from the decoder's source."""
    with open(_build.WEBP_SOURCE) as f:
        src = f.read()
    out = []
    for name, shape in (("kCoeffsUpdateProba", (4, 8, 3, 11)), ("kCoeffsProba0", (4, 8, 3, 11)),
                        ("kBModesProba", (10, 10, 9))):
        body = re.search(name + r"\[[^=]*\] = \{(.*?)\};", src, re.S).group(1)
        out.append(np.array(re.findall(r"\d+", body), np.int64).reshape(shape))
    return out


BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)


def _dc_block(bw, probas, ctx: int, value: int) -> bool:
    """The tokens of a block whose one coefficient is its DC, ``value``
    (|value| <= 4), of probabilities ``probas`` (one type); returns whether
    it is nonzero."""
    p = probas[BANDS[0]][ctx]
    if not value:
        bw.put(0, p[0])
        return False
    bw.put(1, p[0])
    bw.put(1, p[1])
    if abs(value) == 1:
        bw.put(0, p[2])
    else:
        bw.put(1, p[2])
        bw.put(0, p[3])
        bw.put(abs(value) > 2, p[4])
        if abs(value) > 2:
            bw.put(abs(value) - 3, p[5])
    bw.literal(value < 0, 1)
    bw.put(0, probas[BANDS[1]][1 if abs(value) == 1 else 2][0])  # the end of the block
    return True


def _vp8_frame(w=72, h=56, segments=None, lf_deltas=False, partitions=1, simple=False,
               sharpness=0) -> bytes:
    """A still lossy WebP whose VP8 key frame is written here: one
    macroblock in six in 4x4 mode (every subblock DC-predicted), the rest
    in the four 16x16 modes, every block's one coefficient its DC, one
    macroblock in five skipped; with ``segments`` (``"absolute"`` or
    ``"relative"``: four segments' quantizers and filter levels, and a
    segment map), loop-filter deltas, ``partitions`` token partitions, the
    simple filter and a sharpness as asked, and deltas on all five
    quantizers."""
    update, default, bmodes = _tables()
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    bw = _BoolWriter()
    bw.literal(0, 2)  # colour space, clamping type
    bw.literal(segments is not None, 1)
    if segments:
        bw.literal(3, 2)  # a segment map; segment values
        bw.literal(segments == "absolute", 1)
        for value, base in ((5, 40), (-3, 40), (0, 40), (9, 40), (-8, 20), (0, 20), (12, 20),
                            (22, 20)):  # quantizer indices, then filter levels
            bw.literal(1, 1)
            bw.signed(value + (base if segments == "absolute" else 0), 7 if base == 40 else 6)
        for prob in (120, 80, 170):
            bw.literal(1, 1)
            bw.literal(prob, 8)
    bw.literal(simple, 1)
    bw.literal(20, 6)  # the loop filter's level
    bw.literal(sharpness, 3)
    bw.literal(lf_deltas, 1)
    if lf_deltas:
        bw.literal(1, 1)
        for delta in (3, 0, -2, 0, -5, 0, 0, 1):  # reference frames, then modes
            bw.literal(delta != 0, 1)
            if delta:
                bw.signed(delta, 6)
    bw.literal(partitions.bit_length() - 1, 2)
    bw.literal(40, 7)  # the base quantizer index
    for delta in (2, -3, 1, 4, -2):  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
        bw.literal(1, 1)
        bw.signed(delta, 4)
    bw.literal(0, 1)  # refresh entropy probabilities
    for prob in update.ravel():
        bw.put(0, int(prob))
    bw.literal(1, 1)  # macroblocks may skip
    bw.literal(200, 8)
    writers = [_BoolWriter() for _ in range(partitions)]
    top_modes, top_dc = [0] * (4 * mb_w), [False] * mb_w
    top_nz = {"y": [False] * (4 * mb_w), "u": [False] * (2 * mb_w), "v": [False] * (2 * mb_w)}
    for my in range(mb_h):
        left_modes, left_dc = [0] * 4, False
        left_nz = {"y": [False] * 4, "u": [False] * 2, "v": [False] * 2}
        tokens = writers[my % partitions]
        for mx in range(mb_w):
            n = mx + mb_w * my
            segment, skip, i4x4 = (mx + 2 * my) % 4, n % 5 == 3, n % 6 == 1
            if segments:
                bw.put(segment >= 2, 120)
                bw.put(segment & 1, 170 if segment >= 2 else 80)
            bw.put(skip, 200)
            bw.put(not i4x4, 145)
            if i4x4:  # each subblock B_DC_PRED, coded in its modes' context
                for y in range(4):
                    for x in range(4):
                        bw.put(0, int(bmodes[top_modes[4 * mx + x], left_modes[y], 0]))
                        top_modes[4 * mx + x] = left_modes[y] = 0
            else:
                ymode = (mx + my) % 4  # DC, TM, V, H
                bw.put(ymode in (1, 3), 156)
                bw.put(ymode in (1, 2), 128 if ymode in (1, 3) else 163)
                top_modes[4 * mx:4 * mx + 4] = left_modes[:] = [ymode] * 4
            uvmode = (mx + 2 * my) % 4  # DC, V, H, TM
            bw.put(uvmode > 0, 142)
            if uvmode:
                bw.put(uvmode > 1, 114)
                if uvmode > 1:
                    bw.put(uvmode == 3, 183)
            if skip:
                for k, cols in (("y", 4), ("u", 2), ("v", 2)):
                    top_nz[k][cols * mx:cols * mx + cols] = [False] * cols
                    left_nz[k][:] = [False] * cols
                if not i4x4:
                    top_dc[mx] = left_dc = False
                continue
            if not i4x4:  # the 16 DCs, then blocks with nothing past them
                nz = _dc_block(tokens, default[1], top_dc[mx] + left_dc, (3 * mx + 5 * my) % 9 - 4)
                top_dc[mx] = left_dc = nz
            for y in range(4):
                for x in range(4):
                    ctx = top_nz["y"][4 * mx + x] + left_nz["y"][y]
                    if i4x4:
                        nz = _dc_block(tokens, default[3], ctx, (mx + 3 * y + 5 * x + my) % 5 - 2)
                    else:
                        tokens.put(0, int(default[0][BANDS[1]][ctx][0]))
                        nz = False
                    top_nz["y"][4 * mx + x] = left_nz["y"][y] = nz
            for k, value in (("u", (mx + 2 * my) % 7 - 3), ("v", (2 * mx + my) % 5 - 2)):
                for y in range(2):
                    for x in range(2):
                        ctx = top_nz[k][2 * mx + x] + left_nz[k][y]
                        nz = _dc_block(tokens, default[2], ctx, value)
                        top_nz[k][2 * mx + x] = left_nz[k][y] = nz
    first = bw.flush()
    parts = [t.flush() for t in writers]
    frame = (struct.pack("<I", len(first) << 5 | 0x10)[:3] + b"\x9d\x01\x2a"
             + struct.pack("<HH", w, h) + first
             + b"".join(struct.pack("<I", len(t))[:3] for t in parts[:-1]) + b"".join(parts))
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\x00" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


VP8_VARIANTS = {"plain": {}, "segments-absolute": {"segments": "absolute"},
                "segments-relative": {"segments": "relative"}, "lf-deltas": {"lf_deltas": True},
                "partitions-2": {"partitions": 2}, "partitions-4": {"partitions": 4},
                "partitions-8": {"partitions": 8},
                "simple-sharpness": {"simple": True, "sharpness": 5, "lf_deltas": True},
                "all": {"segments": "relative", "lf_deltas": True, "partitions": 8,
                        "sharpness": 2}}


@pytest.mark.parametrize("variant", VP8_VARIANTS)
def test_vp8_variants_libwebp_never_writes_give_pillows_pixels(tmp_path, variant):
    """Relative segment values, filter deltas and several token partitions
    (libwebp writes none of them), in frames written here."""
    data = _vp8_frame(**VP8_VARIANTS[variant])
    want, mode = _pillow(data)
    assert want.shape == (56, 72, 3) and mode == "RGB" and len(np.unique(want)) > 20
    _holds(tmp_path, data)
    if variant == "segments-relative":
        np.testing.assert_array_equal(want, _pillow(_vp8_frame(segments="absolute"))[0])


def _resized(data: bytes, n: int) -> bytes:
    """The first ``n`` bytes of a file of one image chunk, with the RIFF
    and chunk sizes set to what is left."""
    at = 12 if data[12:16] != b"VP8X" else data.index(b"VP8", 30)
    cut = data[:n]
    return _set(_set(cut, 4, "<I", n - 8), at + 4, "<I", n - at - 8)


def _pillow_or_none(data: bytes):
    try:
        return _pillow(data)[0]
    except (OSError, ValueError, SyntaxError):
        return None


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy-alpha"])
def test_broken_files_raise_value_errors_and_never_crash(kind):
    """Cut anywhere: ``ValueError``.  Cut with the sizes set to the cut, or
    a byte flipped: ``ValueError``, or Pillow's pixels where Pillow decodes
    the file too.  The VP8X, VP8 and VP8L magic bytes flipped:
    ``ValueError``."""
    img = _smooth(37, 45, 14, channels=4 if kind == "lossy-alpha" else 3)
    data = _save(Image.fromarray(img, "RGBA" if kind == "lossy-alpha" else "RGB"),
                 **({"lossless": True} if kind == "lossless" else {"quality": 70}))
    rng = np.random.RandomState(len(kind))
    for n in (1, 11, 19, 27, 31, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError) as e:
            webp.decode_native(data[:n])
        assert not isinstance(e.value, UnsupportedImageError)
    image_at = 12 if kind != "lossy-alpha" else data.index(b"VP8 ")
    variants = [_resized(data, n) for n in
                sorted(rng.randint(image_at + 12, len(data), 12))]
    for _ in range(40):
        flipped = bytearray(data)
        flipped[rng.randint(image_at + 8, len(data))] ^= 1 << rng.randint(8)
        variants.append(bytes(flipped))
    magic = image_at + (8 if kind == "lossless" else 11)  # VP8L signature, VP8 start code
    variants += [bytes(data[:i]) + bytes([data[i] ^ 0x40]) + data[i + 1:] for i in (0, 8, magic)]
    raised = 0
    for data in variants:
        want = _pillow_or_none(data)
        try:
            got = webp.decode_native(data)
        except UnsupportedImageError:
            raise
        except ValueError:
            raised += 1
            continue
        assert want is not None, "the decoder took a file Pillow refuses"
        np.testing.assert_array_equal(got, want)
    assert raised >= 3


def test_threads_decode_side_by_side():
    """The training stream decodes in threads (``ctypes`` drops the GIL):
    24 files in 16 threads give what one thread gives."""
    files = [_lossy(c) for c in LOSSY[:12]] + [_lossless(c) for c in LOSSLESS[:12]]
    want = [webp.decode_native(d) for d in files]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(webp.decode_native, files * 4, timeout=60))
    finally:
        sys.setswitchinterval(switch)
    for i, pixels in enumerate(got):
        np.testing.assert_array_equal(pixels, want[i % len(files)])


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    path = tmp_path / "x.webp"
    path.write_bytes(_save(Image.fromarray(_smooth(8, 8, 15)), quality=50))
    monkeypatch.setattr(_build, "webp_library_path", lambda: tmp_path / "libicat_webp-x.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    webp._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found.*the WebP decoder"):
            read_pixels(str(path))
    finally:
        webp._native.cache_clear()
    assert not os.path.exists(tmp_path / "libicat_webp-x.so")

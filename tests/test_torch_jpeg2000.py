"""JPEG 2000 inputs (JP2 files and raw codestreams), read since slice 21
by ``io/jpeg2000.py`` and the host C++ decoder ``csrc/jpeg2000.cc``, on
the CPU against Pillow 12.1.0 (over OpenJPEG 2.5.4) and the JAX package:

* every committed JPEG 2000 file of ``tests/data/inputs``
  (``make_inputs.jpeg2000_files``: Pillow's lossless 5/3, 9/7 in layers,
  each progression, precincts, tiles at offsets, code-block sizes, MCT
  off, a raw codestream, L, LA, RGBA and I;16; OpenJPEG's every
  code-block style, SOP/EPH, POC, ROI, PPT, PPM, 4:2:0 sYCC, signed and
  12-bit samples, a palette, CMYK, tile-parts and a flipped code-block
  byte): ``read_pixels`` equals Pillow's ``convert("RGB")`` byte for byte
  and the mode is Pillow's;
* ``read_image`` equals JAX's ``read_image`` (atol 0) on the ``L``,
  ``RGB`` and ``RGBA`` files and names the format, kind and mode on the
  others;
* 48 random encodings by the bundled OpenJPEG (sizes, offsets, tiles,
  subsampling, depths, signedness, levels, code-block sizes and styles,
  progressions, layers, precincts, ROI, tile-parts) equal Pillow, and the
  component layouts (1-4 components, each colr space, subsampled or not,
  JP2 or raw) give Pillow's pixels or raise where Pillow raises;
* cut and flipped files raise ``ValueError`` where Pillow raises and give
  its pixels where it reads them; an HTJ2K codestream, which Pillow reads,
  raises ``UnsupportedImageError`` naming it;
* the sYCC conversion's tables give Pillow's ``YCbCr`` to ``RGB`` for all
  2**24 inputs;
* a classifier folder of JPEG 2000 files gives JAX's batches, the
  training stream lists no ``.jp2`` (JAX's five extensions), and a 3-step
  ``cli.attack_rd`` on a 64x64 ``.jp2`` equals the JAX CLI's;
* a decoder that cannot be built raises, and nothing falls back.
"""

import hashlib
import importlib
import importlib.util
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu_torch.cli import classifier_train
from imagecompression_adversarial_tpu_torch.config import parse_config
from imagecompression_adversarial_tpu_torch.io import jpeg2000
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels
from imagecompression_adversarial_tpu_torch.kernels import _build
from imagecompression_adversarial_tpu_torch.train import data
from test_torch_cli_attacks import FLAGS, J_EXTRA, _cli, _same_report
from torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)
with open(os.path.join(INPUTS, "inputs.json")) as _f:
    J2K = {n: r for n, r in json.load(_f).items() if n.endswith((".jp2", ".j2k"))}
KINDS = {"P": "palette", "PA": "palette+alpha", "LA": "gray+alpha", "I;16": "16-bit gray",
         "CMYK": "CMYK"}


def _pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB")), im.mode


def _same_as_pillow(data: bytes) -> None:
    """``data`` decodes to Pillow's pixels and mode, or raises
    ``ValueError`` (not ``UnsupportedImageError``) where Pillow raises."""
    try:
        want, mode = _pillow(data)
    except Exception:  # noqa: BLE001 (Pillow raises many kinds)
        with pytest.raises(ValueError) as e:
            jpeg2000.decode_native(data)
        assert not isinstance(e.value, UnsupportedImageError), e.value
        return
    got, got_mode = jpeg2000.decode_native(data)
    assert got_mode == mode
    np.testing.assert_array_equal(got, want)


# ---- the committed files

def test_there_is_a_file_of_each_kind():
    assert len(J2K) == 38
    assert {r["mode"] for r in J2K.values()} == {"L", "LA", "RGB", "RGBA", "I;16", "P", "CMYK"}


@pytest.mark.parametrize("name", sorted(J2K))
def test_committed_files_equal_pillow(name):
    path = os.path.join(INPUTS, name)
    with open(path, "rb") as f:
        raw = f.read()
    want, mode = _pillow(raw)
    assert mode == J2K[name]["mode"] == jpeg2000.parse(raw).mode
    assert hashlib.sha256(want.tobytes()).hexdigest() == J2K[name]["sha256"]
    np.testing.assert_array_equal(read_pixels(path), want)


@pytest.mark.parametrize("name", sorted(J2K))
def test_read_image_equals_jax_or_names_the_kind(name):
    path = os.path.join(INPUTS, name)
    mode = J2K[name]["mode"]
    if mode in ("L", "RGB", "RGBA"):
        got, want = read_image(path), j_read_image(path)
        assert got[1:] == want[1:] == tuple(J2K[name]["shape"][:2])
        np.testing.assert_array_equal(got[0], want[0])
        return
    with pytest.raises(UnsupportedImageError, match=f"a {re.escape(KINDS[mode])} JPEG 2000 "
                                                    f"\\(Pillow's mode {re.escape(mode)}\\)"):
        read_image(path)


# ---- random encodings and component layouts

def _lengths_ok(x0: int, x1: int, levels: int) -> bool:
    """Every level of [x0, x1) holds at least two samples: OpenJPEG's 9/7
    encoder asserts it."""
    return all(-(-x1 // (1 << k)) - -(-x0 // (1 << k)) >= 2 for k in range(levels))


def _random_case(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    nc = int(rng.choice([1, 2, 3, 3, 4]))
    w, h = int(rng.integers(2, 60)), int(rng.integers(2, 60))
    prec = int(rng.choice([8, 8, 1, 5, 10, 12, 16]))
    signed = bool(rng.random() < 0.2)
    sub = [(1, 1)] * nc
    if nc >= 3 and rng.random() < 0.3:
        s = [(2, 2), (2, 1), (1, 2)][int(rng.integers(3))]
        sub[1] = sub[2] = s
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if signed else (0, 1 << prec)
    planes = [np.clip(lo + make_inputs.smooth(-(-h // dy), -(-w // dx), seed=seed + k, channels=1,
                                              noise=float(rng.random()))[..., 0] * (hi - lo) // 256,
                      lo, hi - 1) for k, (dx, dy) in enumerate(sub)]
    levels = int(rng.integers(1, 5))
    kw = dict(numresolution=levels, cblockw_init=int(2 ** rng.integers(2, 7)),
              cblockh_init=int(2 ** rng.integers(2, 7)), mode=int(rng.integers(0, 64)),
              prog_order=int(rng.integers(0, 5)), csty=int(rng.choice([0, 2, 4, 6])))
    kw["cblockh_init"] = min(kw["cblockh_init"], 4096 // kw["cblockw_init"])
    x0 = y0 = tx0 = ty0 = 0
    tiles = None
    if rng.random() < 0.4:
        tiles = (int(rng.integers(8, 40)), int(rng.integers(8, 40)))
        tx0, ty0 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        x0, y0 = tx0 + int(rng.integers(0, 4)), ty0 + int(rng.integers(0, 4))
        kw.update(tile_size_on=1, cp_tdx=tiles[0], cp_tdy=tiles[1], cp_tx0=tx0, cp_ty0=ty0)
    elif rng.random() < 0.3:
        x0, y0 = int(rng.integers(0, 9)), int(rng.integers(0, 9))
    kw.update(image_offset_x0=x0, image_offset_y0=y0)
    # the 9/7 only where OpenJPEG's encoder takes it: two samples a level
    # of every tile-component
    irreversible = rng.random() < 0.5
    xs, ys = [x0, x0 + w], [y0, y0 + h]
    if tiles:
        xs = sorted({x0, x0 + w, *range(tx0 + tiles[0], x0 + w, tiles[0])} - set(range(x0)))
        ys = sorted({y0, y0 + h, *range(ty0 + tiles[1], y0 + h, tiles[1])} - set(range(y0)))
    for dx, dy in sub:
        for d, edges in ((dx, xs), (dy, ys)):
            for e0, e1 in zip(edges, edges[1:]):
                irreversible &= _lengths_ok(-(-e0 // d), -(-e1 // d), levels)
    kw["irreversible"] = int(irreversible)
    rates = ((0.0,) if not irreversible and rng.random() < 0.5 else
             tuple(sorted(rng.uniform(2, 40, int(rng.integers(1, 4))), reverse=True)))
    precincts = ([(int(2 ** rng.integers(3, 7)), int(2 ** rng.integers(3, 7)))
                  for _ in range(int(rng.integers(1, 3)))] if rng.random() < 0.4 else [])
    if rng.random() < 0.2:
        kw.update(roi_compno=0, roi_shift=int(rng.integers(1, 10)))
    if rng.random() < 0.2:
        kw.update(tp_on=1, tp_flag=str(rng.choice(list("RLC"))))
    args = dict(prec=prec, signed=signed, sub=sub, jp2=bool(rng.random() < 0.6),
                color_space=int(rng.choice([1, 2, 3])) if nc > 1 else 2, precincts=precincts,
                size=(w, h), **kw)
    try:
        return make_inputs.openjpeg_encode(planes, rates=rates, **args)
    except RuntimeError:  # OpenJPEG's output buffer too small for a tiny image's headers
        return make_inputs.openjpeg_encode(planes, rates=(0.0,), **{**args, "numresolution": 1})


@pytest.mark.parametrize("first", range(0, 48, 8))
def test_random_encodings_equal_pillow(first):
    for seed in range(first, first + 8):
        _same_as_pillow(_random_case(seed))


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_component_layouts_take_pillows_colour_space(nc):
    """Each colr space (none, sRGB, gray, sYCC, CMYK, e-sYCC, one OpenJPEG
    does not know) over full-size and subsampled components, JP2 and raw."""
    for enumcs in (None, 16, 17, 18, 12, 24, 99):
        for jp2 in (True, False):
            if not jp2 and enumcs is not None:
                continue
            for pattern in ([(1, 1)] * nc, [(1, 1), (2, 2), (2, 2), (2, 2)][:nc],
                            [(1, 1), (1, 1), (2, 1), (1, 1)][:nc], [(2, 2)] * nc):
                if nc == 1 and pattern != [(1, 1)] and pattern != [(2, 2)]:
                    continue
                planes = [make_inputs.smooth(-(-24 // dy), -(-20 // dx), seed=k, channels=1,
                                             noise=0.5)[..., 0] for k, (dx, dy) in enumerate(pattern)]
                cs = make_inputs.openjpeg_encode(planes, sub=pattern, jp2=jp2, size=(20, 24),
                                                 tcp_mct=0, numresolution=2)
                if enumcs is not None:
                    cs = make_inputs.jp2_header_edit(cs, colr=enumcs)
                _same_as_pillow(cs)


# ---- damaged and refused files

@pytest.mark.parametrize("name", ["j2k_97_layers.jp2", "j2kx_sop_eph.j2k", "j2kx_ppm.j2k",
                                  "j2k_tiles_offsets.jp2", "j2kx_gray12.jp2"])
def test_damaged_files_raise_where_pillow_raises(name):
    with open(os.path.join(INPUTS, name), "rb") as f:
        raw = f.read()
    rng = np.random.default_rng(len(name))
    for _ in range(24):
        out = bytearray(raw)
        if rng.random() < 0.3:
            out = out[:int(rng.integers(12, len(raw)))]
        else:
            for at in rng.integers(12, len(raw), int(rng.integers(1, 4))):
                out[at] ^= int(rng.integers(1, 256))
        _same_as_pillow(bytes(out))
    _same_as_pillow(raw[:-2])  # no EOC
    eph = bytearray(raw)
    if b"\xff\x92" in raw:  # an EPH marker gone: OpenJPEG 2.5.4 refuses the packet
        eph[raw.index(b"\xff\x92", 200)] = 0
        _same_as_pillow(bytes(eph))


def test_htj2k_raises_naming_it():
    cs = make_inputs.htj2k_flat()
    want, mode = _pillow(cs)  # Pillow's OpenJPEG decodes HT code-blocks
    assert mode == "L" and (want == 128).all()
    with pytest.raises(UnsupportedImageError, match="HTJ2K"):
        jpeg2000.decode_native(cs)


def test_ycbcr_tables_equal_pillow_over_all_inputs():
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in range(256):
        ycc = np.stack([np.full((256, 256), y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.frombytes("YCbCr", (256, 256), ycc.tobytes()).convert("RGB"))
        r, b = jpeg2000._YCC[0][cr], jpeg2000._YCC[1][cb]
        g = (jpeg2000._YCC[2][cb] + jpeg2000._YCC[3][cr]) >> 6
        got = np.clip(np.stack([y + r, y + g, y + b], -1), 0, 255)
        np.testing.assert_array_equal(got, want)


# ---- the readers' users

def test_classifier_folder_of_jpeg2000_equals_jax(tmp_path):
    j_cls = importlib.import_module("imagecompression_adversarial_tpu.cli.classifier_train")
    names = sorted(n for n in J2K if not n.startswith("textured"))
    for i, name in enumerate(names):
        os.makedirs(tmp_path / ("cat", "dog")[i % 2], exist_ok=True)
        shutil.copy(os.path.join(INPUTS, name), tmp_path / ("cat", "dog")[i % 2])
    ours = classifier_train._image_folder_labeled(str(tmp_path), 6)
    theirs = j_cls._image_folder_labeled(str(tmp_path), 6)
    for _ in range(4):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
    # the training stream lists JAX's five extensions, and no JPEG 2000
    assert data.list_image_files(str(tmp_path)) == j_data.list_image_files(str(tmp_path)) == []


def test_attack_rd_cli_on_a_jp2_matches_jax(tmp_path, capsys):
    j_cli, cli = _cli("attack_rd")
    src = tmp_path / "kodim01.jp2"
    Image.fromarray(make_inputs.smooth(64, 64, seed=90, noise=0.3).astype(np.uint8)).save(
        src, format="JPEG2000", irreversible=True, quality_layers=[12])
    argv = FLAGS + ["-s", str(src), "-steps", "3"]
    ref = j_cli.run(j_parse_config(argv + J_EXTRA))
    capsys.readouterr()
    _same_report(cli.run(parse_config(argv)), ref)
    assert "kodim01.jp2: bpp_ori" in capsys.readouterr().out


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "jpeg2000_library_path", lambda: tmp_path / "libicat_j2k-x.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    jpeg2000._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found.*the JPEG 2000 decoder"):
            read_pixels(os.path.join(INPUTS, "j2k_gray.jp2"))
    finally:
        jpeg2000._native.cache_clear()

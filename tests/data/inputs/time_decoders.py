"""Time the port's host decoders (``decode_native`` of ``io/jpeg.py``,
``io/png.py``, ``io/webp.py``, ``io/tiff.py``, ``io/gif.py`` and
``io/jpeg2000.py``, C++; and
``io/bmp.py::decode``, numpy) on this machine, this tree against another
checkout of the port (the parent commit unpacked with ``git archive``,
say) and, with ``--pillow``, against Pillow, in turns.

    python tests/data/inputs/time_decoders.py [--against DIR] [--pillow] [--rounds 3] [--runs 5]

Writes sixteen files to a temporary directory: the textured 768x512 q90
baseline JPEG of ``chip_smoke.py`` phase 21a (this tree's encoder, which
writes Pillow's bytes), ``textured_progressive.jpg``,
``textured_lossy.webp``, ``textured_lossless.webp``, ``textured_lzw.tif``,
``textured_jpeg.tif`` (768x512 YCbCr 2x2 JPEG), ``tiffx_ycbcr22_lzw.tif``,
``tiffx_group4_miniswhite.tif``, ``bmp_rle8.bmp``,
``webp_animated_lossy.webp``, ``textured_j2k.jp2`` (9/7) and
``textured_j2k53.jp2`` (5/3) from this folder, a 448x256 RGB PNG of
Paeth-filtered rows (``make_inputs.write_png``), and of
``chip_smoke.py::textured_rgb`` (seed 5) at 768x512 an uncompressed TIFF
(phase 24b's, ``chip_smoke.py::tiff_rgb``), a Zstandard TIFF with
horizontal differencing (phase 25a's, ``make_inputs.write_tiff``) and an
interlaced GIF of its pixels in 216 colours (``make_inputs.write_gif``).
Each round then runs one process a tree (and one for Pillow), in turns,
the order reversed in odd rounds; a process builds its tree's libraries
(their build seconds are printed, 0 where ``_build/`` had them),
decodes each file it can once, and prints the best of ``--runs`` timed
decodes in ms (a file it refuses is left out); Pillow's times
``Image.open(path).convert("RGB")``.  Prints one JSON line a process,
then the median over rounds of each one's best times.  Needs numpy and
g++, not a GPU; Pillow only for ``--pillow``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# run in a process of its own with a tree's root first on sys.path:
# argv = [files..., runs]; prints {"best_ms": {file name: ms}, "build_s":
# {module: s}}
_CHILD = r"""
import importlib, json, os, sys, time
files, runs = sys.argv[1:-1], int(sys.argv[-1])
best, build = {}, {}
kinds = {".png": "png", ".jpg": "jpeg", ".webp": "webp", ".tif": "tiff", ".gif": "gif",
         ".bmp": "bmp", ".jp2": "jpeg2000"}
importlib.import_module("imagecompression_adversarial_tpu_torch.kernels._build")  # torch
for path in files:
    kind = kinds[os.path.splitext(path)[1]]
    try:
        mod = importlib.import_module(f"imagecompression_adversarial_tpu_torch.io.{kind}")
    except ImportError:
        continue
    decode = getattr(mod, "decode_native", None) or mod.decode  # bmp: numpy alone
    if kind not in build and hasattr(mod, "_native"):
        t = time.perf_counter()
        mod._native()
        build[kind] = time.perf_counter() - t
    with open(path, "rb") as f:
        data = f.read()
    try:
        decode(data)
    except ValueError:  # a kind this tree does not read
        continue
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        decode(data)
        times.append(time.perf_counter() - t)
    best[os.path.basename(path)] = min(times) * 1e3
print(json.dumps({"best_ms": best, "build_s": build}))
"""

# the same for Pillow's decode of each file
_PILLOW = r"""
import io, json, os, sys, time
import numpy as np
from PIL import Image
files, runs = sys.argv[1:-1], int(sys.argv[-1])
best = {}
for path in files:
    with open(path, "rb") as f:
        data = f.read()
    times = []
    for _ in range(runs + 1):
        t = time.perf_counter()
        with Image.open(io.BytesIO(data)) as im:
            np.asarray(im.convert("RGB"))
        times.append(time.perf_counter() - t)
    best[os.path.basename(path)] = min(times[1:]) * 1e3
print(json.dumps({"best_ms": best, "build_s": {}}))
"""


def inputs(folder: str) -> list:
    """The sixteen files, written into ``folder``."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import numpy as np
    from chip_smoke import textured_rgb, tiff_rgb
    from imagecompression_adversarial_tpu_torch.io import jpeg
    from make_inputs import write_gif, write_png, write_tiff

    rgb = textured_rgb(512, 768, seed=5)
    levels = np.arange(6) * 51
    palette = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    index = (rgb.astype(np.int64) * 6 // 256) @ np.array([36, 6, 1])
    files = {"baseline.jpg": jpeg.encode(rgb, 90),
             "paeth.png": write_png(textured_rgb(256, 448, seed=7), 8, 2),
             "raw.tif": tiff_rgb(rgb),
             "zstd.tif": write_tiff(rgb.astype(np.int64), 8, 2, compression=50000, predictor=2,
                                    rows_per_strip=16),
             "textured.gif": write_gif(index, 8, np.resize(palette.astype(np.uint8), 768).tobytes(),
                                       interlace=True)}
    for name in ("textured_progressive.jpg", "textured_lossy.webp", "textured_lossless.webp",
                 "textured_lzw.tif", "textured_jpeg.tif", "tiffx_ycbcr22_lzw.tif",
                 "tiffx_group4_miniswhite.tif", "bmp_rle8.bmp", "webp_animated_lossy.webp",
                 "textured_j2k.jp2", "textured_j2k53.jp2"):
        with open(os.path.join(HERE, name), "rb") as f:
            files[name] = f.read()
    paths = []
    for name, data in files.items():
        paths.append(os.path.join(folder, name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of another checkout of the port")
    ap.add_argument("--pillow", action="store_true", help="also time Pillow's decodes")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    procs = {"this": (_CHILD, ROOT)}
    if args.against:
        procs["other"] = (_CHILD, os.path.abspath(args.against))
    if args.pillow:
        procs["pillow"] = (_PILLOW, ROOT)
    results = {name: [] for name in procs}
    with tempfile.TemporaryDirectory(prefix="time_decoders_") as tmp:
        paths = inputs(tmp)
        for r in range(args.rounds):
            for name in (list(procs) if r % 2 == 0 else list(procs)[::-1]):
                script, root = procs[name]
                env = dict(os.environ, PYTHONPATH=root)
                out = subprocess.run([sys.executable, "-c", script, *paths, str(args.runs)],
                                     env=env, cwd=tmp, capture_output=True, text=True,
                                     check=True).stdout.strip().splitlines()[-1]
                results[name].append(json.loads(out))
                print(json.dumps({"round": r, "process": name, "root": root,
                                  **results[name][-1]}), flush=True)
    print(json.dumps({"median_best_ms": {
        name: {f: statistics.median(run["best_ms"][f] for run in runs)
               for f in runs[0]["best_ms"]}
        for name, runs in results.items()}}))


if __name__ == "__main__":
    main()

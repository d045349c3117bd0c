"""Time the port's host C++ decoders (``decode_native`` of ``io/jpeg.py``
and ``io/png.py``) on this machine, this tree against another checkout of
the port (the parent commit unpacked with ``git archive``, say), in turns.

    python tests/data/inputs/time_decoders.py [--against DIR] [--rounds 3] [--runs 5]

Writes three files to a temporary directory: the textured 768x512 q90
baseline JPEG of ``chip_smoke.py`` phase 21a (this tree's encoder, which
writes Pillow's bytes), ``textured_progressive.jpg`` from this folder, and
a 448x256 RGB PNG of Paeth-filtered rows (``make_inputs.write_png``).
Each round then runs one process a tree, in the order this, other in odd
rounds and other, this in even ones; a process builds its tree's
libraries, decodes each file it can once, and prints the best of
``--runs`` timed decodes in ms (a file it refuses is left out).  Prints
one JSON line a process, then the median over rounds of each tree's best
times.  Needs numpy and g++, not Pillow or a GPU.
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
# argv = [files..., runs]; prints {file name: best ms}
_CHILD = r"""
import importlib, json, os, sys, time
files, runs = sys.argv[1:-1], int(sys.argv[-1])
best = {}
for path in files:
    kind = "png" if path.endswith(".png") else "jpeg"
    try:
        mod = importlib.import_module(f"imagecompression_adversarial_tpu_torch.io.{kind}")
    except ImportError:
        continue
    with open(path, "rb") as f:
        data = f.read()
    try:
        mod.decode_native(data)
    except ValueError:  # a kind this tree does not read
        continue
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        mod.decode_native(data)
        times.append(time.perf_counter() - t)
    best[os.path.basename(path)] = min(times) * 1e3
print(json.dumps(best))
"""


def inputs(folder: str) -> list:
    """The three files, written into ``folder``."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    from chip_smoke import textured_rgb
    from imagecompression_adversarial_tpu_torch.io import jpeg
    from make_inputs import write_png

    files = {"baseline.jpg": jpeg.encode(textured_rgb(512, 768, seed=5), 90),
             "paeth.png": write_png(textured_rgb(256, 448, seed=7), 8, 2)}
    with open(os.path.join(HERE, "textured_progressive.jpg"), "rb") as f:
        files["textured_progressive.jpg"] = f.read()
    paths = []
    for name, data in files.items():
        paths.append(os.path.join(folder, name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of another checkout of the port")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    trees = {"this": ROOT}
    if args.against:
        trees["other"] = os.path.abspath(args.against)
    results = {name: [] for name in trees}
    with tempfile.TemporaryDirectory(prefix="time_decoders_") as tmp:
        paths = inputs(tmp)
        for r in range(args.rounds):
            for name in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
                env = dict(os.environ, PYTHONPATH=trees[name])
                out = subprocess.run([sys.executable, "-c", _CHILD, *paths, str(args.runs)],
                                     env=env, cwd=tmp, capture_output=True, text=True,
                                     check=True).stdout.strip().splitlines()[-1]
                results[name].append(json.loads(out))
                print(json.dumps({"round": r, "tree": name, "root": trees[name],
                                  "best_ms": results[name][-1]}), flush=True)
    print(json.dumps({"median_best_ms": {
        name: {f: statistics.median(run[f] for run in runs) for f in runs[0]}
        for name, runs in results.items()}}))


if __name__ == "__main__":
    main()

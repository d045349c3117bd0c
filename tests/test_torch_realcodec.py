"""The port's real coder as a whole (``entropy/codec.py``, ``cli/codec.py``)
vs the JAX package's ``RealCodec``, at 64x64 on the CPU.

Families: factorized and context with seeded weights (JAX ``init_params``
handed to the port with ``params_from_jax``), hyper q1 and cheng2020-gmm q3
on the committed demo checkpoints.  Both sides code the same image.  What
each side hands the rANS coder is captured in coding order (the z stream,
then y) and compared:

* at most 1e-3 of the symbols and indexes differ.  The float32 transforms
  differ in the last bits, so a symbol may round the other way where its
  value sits within 1e-4 of a half-integer, and an index may pick the next
  row where its scale sits within 1e-5 (relative) of a scale-table
  boundary; the first difference in coding order must be one of these (in
  the autoregressive families later ones can follow from it).  The count
  is printed.
* the CDF rows the two sides code with are compared too: the factorized
  model's tables come from float32 likelihoods, and cheng2020-gmm builds a
  row a symbol from float32 head outputs, so a row entry may move by a
  count where a quantized frequency sits at a rounding boundary.
* where nothing differs, the bytes are identical and the port's decoded
  x_hat is within atol 1e-4 of JAX's (float32 synthesis in another order);
  otherwise real_bpp and ideal_bits are within 1% of JAX's and the PSNR of
  the two decodes within 0.05 dB.

Run as a script from the repository's root, the module prints the JAX
package's ``real_bpp`` and PSNR at 768x512 for hyper q1 and cheng2020-gmm
q3 (the constants ``chip_smoke.py`` holds the card to)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_realcodec.py
"""

import os
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.cli import codec as j_cli
from imagecompression_adversarial_tpu.config import Config as JConfig
from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu.entropy import autoregressive as j_ar
from imagecompression_adversarial_tpu.entropy import rans as j_rans
from imagecompression_adversarial_tpu.entropy.codec import RealCodec as JRealCodec
from imagecompression_adversarial_tpu.io.convert import convert_state_dict
from imagecompression_adversarial_tpu.metrics import psnr as j_psnr
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu.runtime import load_model as j_load_model
from imagecompression_adversarial_tpu_torch.cli import codec as cli
from imagecompression_adversarial_tpu_torch.config import Config, parse_config
from imagecompression_adversarial_tpu_torch.entropy.codec import RealCodec
from imagecompression_adversarial_tpu_torch.entropy.tables import SCALE_TABLE
from imagecompression_adversarial_tpu_torch.io.image import (
    read_image,
    synthetic_image,
    to_numpy,
    to_tensor,
    write_image,
)
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.runtime import load_model
from torch_coder_diff import compare_streams, table_differences

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPTS = {
    "hyper": os.path.join(REPO, "ckpts", "demo", "hyper-q1-mse-synthetic.msgpack"),
    "cheng2020-gmm": os.path.join(REPO, "ckpts", "demo", "cheng2020-gmm-q3-mse-synthetic.msgpack"),
    **{f: os.path.join(REPO, "ckpts", "demo", f"{f}-q3-mse-synthetic.msgpack")
       for f in ("nlaic", "tic", "fic")},
}
QUALITY = {"hyper": 1, "cheng2020-gmm": 3, "factorized": 1, "context": 1, "nlaic": 3, "tic": 3,
           "fic": 3}


def jax_reference(model: str, h: int, w: int) -> dict:
    """JAX ``RealCodec`` (CPU, ``highest`` precision) on
    ``synthetic_image(h, w, seed=0)`` with the demo checkpoint of
    ``model``: real_bpp, ideal_bpp and the PSNR of the decode."""
    module, params = j_load_model(JConfig(model=model, quality=QUALITY[model],
                                          checkpoint=CKPTS[model], device="cpu"))
    codec = JRealCodec(module, params)
    x = synthetic_image(h, w, seed=0)
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["shape"])
    return {
        "real_bpp": codec.real_bpp(out, h * w),
        "ideal_bpp": out["ideal_bits"] / (h * w),
        "psnr": float(j_psnr(jnp.asarray(x_hat), jnp.asarray(x))),
    }



FAMILIES = ("factorized", "context", "hyper", "cheng2020-gmm")
SHARE_DIFFERING = 1e-3
XHAT_ATOL = 1e-4
RATE_RTOL = 0.01
PSNR_DB = 0.05
_J_ENCODE = j_rans.encode_with_indexes
_RESULTS = {}


def _psnr(a, b):
    return float(10.0 * np.log10(1.0 / np.mean((a.astype(np.float64) - b) ** 2)))


def _models(fam):
    """(port model, JAX module, numpy params) on the same weights."""
    if fam in CKPTS:
        model = load_model(Config(device="cpu", model=fam, quality=QUALITY[fam],
                                  checkpoint=CKPTS[fam]))
        with open(CKPTS[fam], "rb") as f:
            jp = flax.serialization.msgpack_restore(f.read())
    else:
        model = init_model(fam, QUALITY[fam], seed=3).requires_grad_(False)
        jp = convert_state_dict(model.state_dict(), fam)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return model, j_init_model(fam, QUALITY[fam]), jp


def _coded(fam):
    """Both sides' compress and decompress of one 64x64 image, and what each
    handed the rANS coder (JAX's captured in coding order)."""
    if fam in _RESULTS:
        return _RESULTS[fam]
    model, jm, jp = _models(fam)
    x = synthetic_image(64, 64, seed=1)
    seen = []

    def capture(symbols, indexes, cdfs, cdf_sizes, offsets):
        seen.append(dict(symbols=np.asarray(symbols).ravel(), indexes=np.asarray(indexes).ravel(),
                         cdfs=cdfs, cdf_sizes=cdf_sizes, offsets=offsets))
        return _J_ENCODE(symbols, indexes, cdfs, cdf_sizes, offsets)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rans, "encode_with_indexes", capture)
        mp.setattr(j_ar, "encode_with_indexes", capture)
        jcodec = JRealCodec(jm, jp)
        jout = jcodec.compress(x)
    jx_hat = np.asarray(jcodec.decompress(jout["strings"], jout["shape"]))

    codec = RealCodec(model)
    trace = {}
    out = codec.compress(to_tensor(x, "cpu"), trace)
    y_hat = codec.decode_latent(out["strings"], out["shape"])
    x_hat = to_numpy(codec.synthesize(y_hat))
    _RESULTS[fam] = dict(x=x, model=model, codec=codec, out=out, trace=trace, y_hat=y_hat,
                         x_hat=x_hat, jcodec=jcodec, jout=jout, jx_hat=jx_hat, seen=seen)
    return _RESULTS[fam]


@pytest.mark.parametrize("fam", FAMILIES)
def test_realcodec_matches_jax(fam):
    r = _coded(fam)
    names = ["y"] if fam == "factorized" else ["z", "y"]  # JAX codes z first
    assert len(r["seen"]) == len(names)
    counts = compare_streams([(n, r["trace"][n], s) for n, s in zip(names, r["seen"])], SCALE_TABLE)
    tables = {"eb": table_differences(r["codec"].eb_tables, r["jcodec"].eb_tables)}
    if fam == "cheng2020-gmm":
        tables["gmm rows"] = table_differences(r["trace"]["y"], r["seen"][-1])
    n_table = sum(n for t in tables.values() for n, _ in t.values())
    n_pixels = 64 * 64
    real, real_j = (c.real_bpp(o, n_pixels) for c, o in ((r["codec"], r["out"]),
                                                         (r["jcodec"], r["jout"])))
    print(f"{fam}: {counts['symbols']} symbols and {counts['indexes']} indexes of "
          f"{counts['total']} differ (first {counts['first']}); table entries differing "
          f"{tables}; real_bpp {real:.5f} (JAX {real_j:.5f}), ideal bits "
          f"{r['out']['ideal_bits']:.2f} (JAX {r['jout']['ideal_bits']:.2f})")
    assert counts["symbols"] + counts["indexes"] <= SHARE_DIFFERING * counts["total"]
    assert tuple(r["out"]["shape"]) == tuple(r["jout"]["shape"])
    if counts["symbols"] == counts["indexes"] == n_table == 0:
        assert r["out"]["strings"] == r["jout"]["strings"]
        np.testing.assert_allclose(r["x_hat"], r["jx_hat"], atol=XHAT_ATOL, rtol=0)
    else:
        assert abs(real / real_j - 1.0) <= RATE_RTOL
        assert abs(r["out"]["ideal_bits"] / r["jout"]["ideal_bits"] - 1.0) <= RATE_RTOL
        assert abs(_psnr(r["x_hat"], r["x"]) - _psnr(r["jx_hat"], r["x"])) <= PSNR_DB


@pytest.mark.parametrize("fam", FAMILIES)
def test_port_decode_reproduces_encoder_latent(fam):
    r = _coded(fam)
    assert torch.equal(r["y_hat"], r["trace"]["y_hat"])
    x_hat = to_numpy(r["codec"].decompress(r["out"]["strings"], r["out"]["shape"]))
    np.testing.assert_array_equal(x_hat, r["x_hat"])
    assert x_hat.shape == r["x"].shape and 0.0 <= x_hat.min() and x_hat.max() <= 1.0
    if fam != "context":  # context's coder writes mean-shifted symbols
        with torch.no_grad():
            ref = r["model"](to_tensor(r["x"], "cpu"), "dequantize")["x_hat"]
        np.testing.assert_allclose(x_hat, to_numpy(torch.clamp(ref, 0, 1)), atol=1e-5, rtol=0)


def test_table_bpp_is_the_coded_streams_ideal_rate():
    r = _coded("hyper")
    n = 64 * 64
    table = r["codec"].table_bpp(to_tensor(r["x"], "cpu"), n)
    assert table == pytest.approx(r["out"]["ideal_bits"] / n, rel=1e-12)
    assert table == pytest.approx(r["jcodec"].table_bpp(r["x"], n), rel=RATE_RTOL)
    real = r["codec"].real_bpp(r["out"], n)
    assert real >= table * 0.98 and real - table < 0.08  # coder overhead only
    for fam in ("factorized", "context", "cheng2020-gmm"):
        assert _coded(fam)["codec"].table_bpp(_coded(fam)["x"], n) is None


def test_realcodec_rejects_the_debug_codec():
    with pytest.raises(NotImplementedError, match="entropy_structure='none'"):
        RealCodec(init_model("debug", 1))


def _png(path, seed, h=64, w=64):
    write_image(synthetic_image(h, w, seed=seed), str(path))
    return str(path)


def test_cli_run_prints_the_rate_audit_as_jax(tmp_path, capsys):
    src = _png(tmp_path / "in.png", seed=2)
    flags = ["-m", "hyper", "-q", "1", "-ckpt", CKPTS["hyper"], "-s", src]
    res = cli.run(parse_config(flags + ["-device", "cpu", "-t", str(tmp_path / "out.png")]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{src}: real_bpp ") and " est_bpp " in line and " psnr " in line
    jres = j_cli.run(j_parse_config(flags + ["-device", "cpu"]))
    for key in ("real_bpp", "est_bpp", "ideal_bpp"):
        assert res[key] == pytest.approx(jres[key], rel=RATE_RTOL)
    assert abs(res["psnr"] - jres["psnr"]) <= PSNR_DB
    im, h, w = read_image(str(tmp_path / "out.png"))
    assert (h, w) == (64, 64) and os.path.getsize(tmp_path / "out.png.bin") > 8


def test_cli_encode_decode_round_trip(tmp_path):
    """--encode and --decode over a glob of two images (64x64 and 64x128)
    write the PNG the in-process round trip writes, byte for byte; the
    container is the JAX CLI's format."""
    srcs = [_png(tmp_path / "a.png", seed=3), _png(tmp_path / "b.png", seed=4, w=128)]
    flags = ["-m", "context", "-q", "1", "--new", "-device", "cpu"]
    cli.main(flags + ["--encode", "-s", str(tmp_path / "*.png"), "-t", str(tmp_path / "enc")])
    cli.main(flags + ["--decode", "-s", str(tmp_path / "enc" / "*.bin"), "-t", str(tmp_path / "dec")])
    for src in srcs:
        stem = os.path.splitext(os.path.basename(src))[0]
        cli.run(parse_config(flags + ["-s", src, "-t", str(tmp_path / f"{stem}_inproc.png")]))
        with open(tmp_path / f"{stem}_inproc.png", "rb") as f:
            inproc = f.read()
        with open(tmp_path / "dec" / f"{stem}_rec.png", "rb") as f:
            assert f.read() == inproc
        strings, shape, h, w = cli.read_container(str(tmp_path / "enc" / f"{stem}.bin"))
        assert (h, w) == ((64, 64) if stem == "a" else (64, 128)) and len(strings) == 2
        j_cli.write_container(str(tmp_path / "j.bin"), {"strings": strings, "shape": shape}, h, w)
        with open(tmp_path / "j.bin", "rb") as f, open(tmp_path / "enc" / f"{stem}.bin", "rb") as g:
            assert f.read() == g.read()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    # the families of chip_smoke.py phase 9 (hyper, cheng2020-gmm) and 14
    # (nlaic, tic, fic), or those named on the command line
    for name in sys.argv[1:] or ("hyper", "cheng2020-gmm", "nlaic", "tic", "fic"):
        print(name, QUALITY[name], "768x512", jax_reference(name, 512, 768), flush=True)

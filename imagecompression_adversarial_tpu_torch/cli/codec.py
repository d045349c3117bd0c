"""CLI: real bitstreams through the rANS coder, on the GPU (port of
``imagecompression_adversarial_tpu/cli/codec.py``).

One image, encoded and decoded in one process::

    python -m imagecompression_adversarial_tpu_torch.cli.codec -m hyper -q 1 \
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s in.png -t out.png

prints ``real_bpp`` (bytes written), ``est_bpp`` (the model's likelihoods),
``ideal_bpp`` (the coded symbols under their CDF rows) and the PSNR;
``-t`` writes the reconstruction and, beside it, ``out.png.bin``.

Batches, encoder and decoder apart::

    python -m ...cli.codec -m hyper -q 1 -ckpt ... --encode -s 'kodak/*.png' -t out/
    python -m ...cli.codec -m hyper -q 1 -ckpt ... --decode -s 'out/*.bin' -t rec/

A ``.bin`` holds the latent's shape, the image's H and W (``<HHHH``) and
the length-prefixed rANS strings; it decodes with the same model on the
same kind of device.
"""

from __future__ import annotations

import os
import struct

from ..config import apply_precision, parse_config
from ..entropy.codec import RealCodec, coder_settings
from ..io.image import list_images, read_image, to_numpy, to_tensor, write_image
from ..metrics import bpp_from_likelihoods, psnr
from ..runtime import load_model


def write_container(path: str, out: dict, h: int, w: int) -> None:
    """Latent shape, image H and W, then each string with its length."""
    with open(path, "wb") as f:
        f.write(struct.pack("<HHHH", *out["shape"], h, w))
        for s in out["strings"]:
            f.write(struct.pack("<I", len(s)))
            f.write(s)


def read_container(path: str):
    """(strings, latent shape, H, W) of a ``.bin``."""
    with open(path, "rb") as f:
        raw = f.read()
    sh, sw, h, w = struct.unpack("<HHHH", raw[:8])
    strings, off = [], 8
    while off < len(raw):
        (n,) = struct.unpack("<I", raw[off:off + 4])
        strings.append(raw[off + 4:off + 4 + n])
        off += 4 + n
    return strings, (sh, sw), h, w


def encode_glob(cfg, codec: RealCodec) -> None:
    os.makedirs(cfg.target or ".", exist_ok=True)
    for path in list_images(cfg.source):
        im, h, w = read_image(path)
        out = codec.compress(to_tensor(im, codec.device))
        dst = os.path.join(cfg.target or ".", os.path.splitext(os.path.basename(path))[0] + ".bin")
        write_container(dst, out, h, w)
        print(f"{path} -> {dst}: real_bpp {codec.real_bpp(out, h * w):.4f}", flush=True)


def decode_glob(cfg, codec: RealCodec) -> None:
    os.makedirs(cfg.target or ".", exist_ok=True)
    for path in list_images(cfg.source):
        strings, shape, h, w = read_container(path)
        x_hat = codec.decompress(strings, shape)
        name = os.path.splitext(os.path.basename(path))[0] + "_rec.png"
        dst = os.path.join(cfg.target or ".", name)
        write_image(to_numpy(x_hat), dst, h, w)
        print(f"{path} -> {dst}: {h}x{w}", flush=True)


def run(cfg) -> dict:
    """Encode and decode ``cfg.source`` (one PNG) and print the rate audit:
    real - ideal is the coder's overhead, est - ideal the estimate's."""
    apply_precision(cfg)
    model = load_model(cfg)
    codec = RealCodec(model)
    im, h, w = read_image(cfg.source)
    num_pixels = h * w
    x = to_tensor(im, codec.device)

    out = codec.compress(x)
    real_bpp = codec.real_bpp(out, num_pixels)
    ideal_bpp = out["ideal_bits"] / num_pixels
    x_hat = codec.decompress(out["strings"], out["shape"])
    with coder_settings():
        est_bpp = float(bpp_from_likelihoods(model(x, "dequantize")["likelihoods"], num_pixels))
    p = float(psnr(x_hat, x))

    if cfg.target:
        write_image(to_numpy(x_hat), cfg.target, h, w)
        write_container(cfg.target + ".bin", out, h, w)
    print(f"{cfg.source}: real_bpp {real_bpp:.4f} est_bpp {est_bpp:.4f} "
          f"ideal_bpp {ideal_bpp:.4f} psnr {p:.2f}", flush=True)
    return {"real_bpp": real_bpp, "est_bpp": est_bpp, "ideal_bpp": ideal_bpp, "psnr": p}


def main(argv=None):
    cfg = parse_config(argv)
    if not (cfg.encode or cfg.decode):
        run(cfg)
        return
    apply_precision(cfg)
    codec = RealCodec(load_model(cfg))
    if cfg.encode:
        encode_glob(cfg, codec)
    if cfg.decode:
        decode_glob(cfg, codec)


if __name__ == "__main__":
    main()

"""CLI: the targeted / ROI attack.

    python -m imagecompression_adversarial_tpu_torch.cli.attack_cv -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s src.png -t target.png \\
        [--mask_loc x0 x1 y0 y1 -la_tar 1 -la_bkg_in 1 -la_bkg_out 1]

Port of ``imagecompression_adversarial_tpu/cli/attack_cv.py``: steers the
reconstruction of ``-s`` toward ``-t`` (inside the box, with ``--mask_loc``;
untargeted where ``-t`` names no file) and writes
``./attack/targeted/<name>_fake_in.png`` and ``_fake_out.png``.  The
classifier variant (``--cls_ckpt c.msgpack --cls_label 3``, a checkpoint of
``cli.classifier_train``) steers the reconstruction toward the classifier's
label 3 and prints the labels of the clean and adversarial reconstructions.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..attacks.targeted import TargetedAttackConfig, make_targeted_attack_fn
from ..config import Config, apply_precision, build_parser
from ..io.image import read_image, to_numpy, to_tensor, write_image
from ..io.weights import classifier_from_jax, read_msgpack
from ..models.classifier import MLPClassifier, make_logits_fn
from ..runtime import load_model
from ._corpus import to_host


def load_classifier_logits_fn(ckpt: str, device):
    """The logits function of a classifier msgpack (``cli.classifier_train``
    of either package), on ``device``."""
    module = MLPClassifier()
    module.load_state_dict(classifier_from_jax(read_msgpack(ckpt)), strict=True)
    module.requires_grad_(False)
    return make_logits_fn(module.to(device).eval())


def run(cfg, cls_ckpt: Optional[str] = None, cls_label: Optional[int] = None) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = TargetedAttackConfig(
        steps=cfg.steps,
        lr=cfg.lr_attack,
        noise_threshold=cfg.noise,
        att_metric=cfg.att_metric if cfg.att_metric in ("L1", "L2", "masked") else "L2",
        clamp=cfg.clamp,
        lamb_tar=cfg.lamb_tar,
        lamb_bkg_in=cfg.lamb_bkg_in,
        lamb_bkg_out=cfg.lamb_bkg_out,
        mask_loc=tuple(cfg.mask_loc) if cfg.mask_loc else None,
    )
    logits_fn = load_classifier_logits_fn(cls_ckpt, device) if cls_ckpt else None
    attack = make_targeted_attack_fn(model, att_cfg, classifier_logits_fn=logits_fn,
                                     target_label=cls_label)
    im_s, h, w = read_image(cfg.source)
    target = None
    if cfg.target and os.path.exists(cfg.target):
        t_img, _, _ = read_image(cfg.target)
        if t_img.shape != im_s.shape:
            raise SystemExit(f"target shape {t_img.shape} != source shape {im_s.shape}")
        target = to_tensor(t_img, device)
    res = attack(to_tensor(im_s, device), target)
    out = to_host({k: res[k] for k in ("bpp_ori", "bpp", "vi", "loss_i_final", "loss_o_final")})
    print(f"bpp_ori {out['bpp_ori']:.4f} bpp_adv {out['bpp']:.4f} vi {out['vi']:.4f} "
          f"loss_i {out['loss_i_final']:.6f} loss_o {out['loss_o_final']:.6f}", flush=True)
    result = {k: out[k] for k in ("bpp_ori", "bpp", "vi")}
    if logits_fn is not None:
        with torch.no_grad():
            result["label_clean"] = int(torch.argmax(logits_fn(res["output_s"])))
            result["label_adv"] = int(torch.argmax(logits_fn(res["output_"])))
        print(f"classifier: clean-recon label {result['label_clean']} -> adv-recon label "
              f"{result['label_adv']} (target {cls_label})")
    out_dir = "./attack/targeted/"
    os.makedirs(out_dir, exist_ok=True)
    stem = out_dir + os.path.splitext(os.path.basename(cfg.source))[0]
    write_image(to_numpy(res["im_"]), f"{stem}_fake_in.png", h, w)
    write_image(to_numpy(res["output_"]), f"{stem}_fake_out.png", h, w)
    print(f"artifacts -> {stem}_fake_in.png / _fake_out.png")
    return result


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--cls_ckpt", type=str, default=None,
                        help="classifier msgpack: CE-targeted attack")
    parser.add_argument("--cls_label", type=int, default=0, help="target label for --cls_ckpt")
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    return run(cfg, cls_ckpt=ns.cls_ckpt, cls_label=ns.cls_label)


if __name__ == "__main__":
    main()

"""CLI: the patch attack: the RD attack, then the worst 64x64 patch.

    python -m imagecompression_adversarial_tpu_torch.cli.attack_patch -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png'

Port of ``imagecompression_adversarial_tpu/cli/attack_patch.py``: finds
the window of highest local VI and writes the adversarial and original
input and output patches under ``./attack/patches/``.
"""

from __future__ import annotations

import os

from ..attacks import RDAttackConfig, make_attack_fn
from ..attacks.patch import extract_worst_patch
from ..config import apply_precision, parse_config
from ..io.image import to_numpy, to_tensor, write_image
from ..runtime import load_model
from ._corpus import corpus


def run(cfg) -> list:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = RDAttackConfig(steps=cfg.steps, lr=cfg.lr_attack, noise_threshold=cfg.noise,
                             epsilon=cfg.epsilon, clamp=cfg.clamp)
    attack = make_attack_fn(model, att_cfg)
    out_dir = "./attack/patches/"
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for name, im, _, _ in corpus(cfg.source):
        x = to_tensor(im, device)
        res = attack(x)
        patches = extract_worst_patch(res["im_"], res["output_"], x, res["output_s"])
        y0, x0 = (int(v) for v in patches["location"])
        v = float(patches["vi_value"])
        stem = out_dir + os.path.splitext(name)[0]
        for key, suffix in (("patch_adv", "advin"), ("patch_outadv", "advout"),
                            ("patch_s", "oriin"), ("patch_outs", "oriout")):
            write_image(to_numpy(patches[key]), f"{stem}_{suffix}.png")
        print(f"{name}: patch@({y0},{x0}) local_vi_ratio {v:.2f} image_vi {float(res['vi']):.4f}",
              flush=True)
        results.append((name, v))
    return results


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()

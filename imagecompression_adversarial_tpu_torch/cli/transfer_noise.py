"""CLI: adversarial-noise transferability matrices on the GPU (port of
``imagecompression_adversarial_tpu/cli/transfer_noise.py``).

    # the cross-image matrix of one model over the -s (or -s2) images
    python -m imagecompression_adversarial_tpu_torch.cli.transfer_noise -m hyper -q 1 \\
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png'
    # the cross-model matrix over trained checkpoints (arch:quality:ckpt,...)
    python -m ...cli.transfer_noise --cross-model -s 'kodim*.png' \\
        -cross "hyper:1:ckpts/demo/hyper-q1-mse-synthetic.msgpack,\\
cheng2020-gmm:3:ckpts/demo/cheng2020-gmm-q3-mse-synthetic.msgpack"

Prints the vi matrix and saves it as ``<model>_<q>_<metric>_transfer.npy``
(cross-model: ``transfer_cross_model.npy``) with a heatmap ``.pdf`` where
matplotlib is installed.  The cross-model legs are lazy: one model is on
the card at a time, and each leg prints its peak memory.  A fic source
attacks as the best of 2 restarts, one after the other, from a
``torch.Generator`` seeded 0 (its zero start is a critical point).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analysis import cross_image_matrix, cross_model_matrix, make_transfer_eval_fn, plot_matrix
from ..attacks import RDAttackConfig, best_of_restarts, make_attack_fn
from ..config import Config, apply_precision, build_parser
from ..io.image import list_images, read_image, to_tensor
from ..runtime import load_model
from ..utils import plot_or_skip


def _attack_fn(model, att_kwargs, arch: str):
    if arch != "fic":
        return make_attack_fn(model, RDAttackConfig(**att_kwargs))
    inner = make_attack_fn(model, RDAttackConfig(**att_kwargs, random_restarts=2))
    return lambda x: best_of_restarts(inner, x, torch.Generator(x.device).manual_seed(0), 2,
                                      impl="host")


def run(cfg, source2=None, cross_model=False, cross_specs=None) -> np.ndarray:
    apply_precision(cfg)
    att_kwargs = dict(steps=cfg.steps, lr=cfg.lr_attack, noise_threshold=cfg.noise,
                      epsilon=cfg.epsilon, clamp=cfg.clamp)

    if cross_model:
        if cross_specs:
            specs = []
            for entry in cross_specs.split(","):
                arch, q, ck = entry.split(":", 2)
                specs.append((arch, int(q), ck or None))
        else:
            specs = [(a, min(cfg.quality, 6), cfg.checkpoint)
                     for a in ("factorized", "hyper", "context", "cheng2020")]

        def load(arch, q, ck):
            return load_model(dataclasses.replace(cfg, model=arch, quality=q, checkpoint=ck))

        def attack_thunk(arch, q, ck):
            def thunk():
                model = load(arch, q, ck)
                return _attack_fn(model, att_kwargs, arch), model
            return thunk

        def eval_thunk(arch, q, ck):
            def thunk():
                model = load(arch, q, ck)
                return make_transfer_eval_fn(model), model
            return thunk

        labels = [f"{arch}-q{q}" for arch, q, _ in specs]
        images = [read_image(f)[0] for f in list_images(cfg.source)]
        matrix = cross_model_matrix([attack_thunk(*s) for s in specs],
                                    [eval_thunk(*s) for s in specs], images)
        print("cross-model transfer matrix (rows: attacked, cols: evaluated):")
        print("models:", " ".join(labels))
        print(np.round(matrix, 2))
        np.save("transfer_cross_model.npy", matrix)
        plot_or_skip(plot_matrix, "transfer_cross_model.pdf", matrix, "transfer_cross_model.pdf")
        return matrix

    model = load_model(cfg)
    device = next(model.parameters()).device
    images = [to_tensor(read_image(f)[0], device) for f in list_images(source2 or cfg.source)]
    matrix = cross_image_matrix(make_attack_fn(model, RDAttackConfig(**att_kwargs)),
                                make_transfer_eval_fn(model), images)
    print("cross-image transfer VI matrix:")
    print(np.round(matrix, 2))
    tag = f"{cfg.model}_{cfg.quality}_{cfg.metric}_"
    np.save(tag + "transfer.npy", matrix)
    plot_or_skip(plot_matrix, tag + "transfer.pdf", matrix, tag + "transfer.pdf")
    return matrix


def main(argv=None):
    parser = build_parser()
    parser.add_argument("-s2", "--source2", type=str, default=None)
    parser.add_argument("--cross-model", dest="cross_model", action="store_true")
    parser.add_argument("-cross", dest="cross_specs", type=str, default=None,
                        help="comma-separated arch:quality:ckpt entries for a "
                             "trained-checkpoint cross-model matrix")
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    return run(cfg, source2=ns.source2, cross_model=ns.cross_model, cross_specs=ns.cross_specs)


if __name__ == "__main__":
    main()

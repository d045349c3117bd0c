"""CLI: latent-distribution analysis on the GPU (port of
``imagecompression_adversarial_tpu/cli/visual_distribution.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.visual_distribution -m hyper -q 1 \\
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s in.png [-t adv.png]

With ``-t`` (an adversarial copy, e.g. ``cli.attack_rd --debug``'s
``_advin.png``), ranks the channels by rate inflation and prints the top
ten; without it, picks the channel of highest rate.  The histogram of that
channel's quantized latent, the Gaussian pmf predicted for it and the
ranking go to ``<model>_<q>_distribution.npz``, and the plot to
``..._distribution.png`` where matplotlib is installed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..analysis import (
    channel_rates, latent_histogram, predicted_distribution, rate_inflation_ranking,
)
from ..config import apply_precision, parse_config
from ..io.image import read_image, to_tensor
from ..runtime import load_model
from ..utils import plot_or_skip, pyplot


def plot_distribution(hist, edges, pmf, channel: int, save: str) -> None:
    plt = pyplot()
    centers = (edges[:-1] + edges[1:]) / 2
    plt.figure(figsize=(6, 4))
    plt.bar(centers, hist, width=1.0, alpha=0.6, label="empirical y_hat")
    if pmf is not None:
        plt.plot(np.arange(-30, 31), pmf, "r-", label="predicted Gaussian pmf")
    plt.legend()
    plt.title(f"channel {channel}")
    plt.savefig(save, bbox_inches="tight")
    plt.close()


@torch.no_grad()
def run(cfg) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    res = model(to_tensor(read_image(cfg.source)[0], device), quant_mode="dequantize")
    out = {"channels_by_rate": None}
    numbers = {}
    if cfg.target and os.path.exists(cfg.target):
        res2 = model(to_tensor(read_image(cfg.target)[0], device), quant_mode="dequantize")
        ranking = rate_inflation_ranking(res["likelihoods"]["y"], res2["likelihoods"]["y"])
        top = ranking["ranking"][:10]
        print("top rate-inflated channels:", top.tolist())
        print("inflation (bits):", np.round(ranking["inflation"][top], 1).tolist())
        out["channels_by_rate"] = top.tolist()
        numbers.update(ranking)
        channel = int(top[0])
    else:
        rates = channel_rates(res["likelihoods"]["y"]).cpu().numpy()
        numbers["rate_natural"] = rates
        channel = int(np.argmax(rates))
        print(f"highest-rate channel: {channel}")

    hist, edges = latent_histogram(res["y_hat"], channel)
    pmf = None
    if "scales_hat" in res:
        scales = res["scales_hat"][:, channel]
        means = res.get("means_hat")
        means = means[:, channel] if means is not None else torch.zeros_like(scales)
        pmf = predicted_distribution(torch.mean(means)[None], torch.mean(scales)[None])
        pmf = pmf[:, 0].cpu().numpy()
        numbers["pmf"] = pmf
    save = f"{cfg.model}_{cfg.quality}_distribution.png"
    np.savez(os.path.splitext(save)[0] + ".npz", channel=channel, hist=hist, edges=edges,
             **numbers)
    if plot_or_skip(plot_distribution, save, hist, edges, pmf, channel, save):
        print(f"plot -> {save}")
        out["plot"] = save
    out.update(channel=channel, hist=hist, pmf=pmf)
    return out


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()

"""LPIPS perceptual distance (port of
``imagecompression_adversarial_tpu/metrics/lpips.py``) and the key map of
``imagecompression_adversarial_tpu/io/convert_lpips.py``.

The math is the JAX package's: unit-normalized feature differences
(``x * rsqrt(sum x^2 + 1e-10)`` over channels), non-negative per-channel
weights ``|lin_l|``, a mean over batch and space, a sum over the five
AlexNet taps.  Inputs are NCHW in [0, 1], shifted to [-1, 1].

Parameter names: ``features.conv0..conv4`` (OIHW), ``features.in_shift`` /
``features.in_scale`` (the lpips package's scaling layer, applied before
conv0's zero padding), ``lin0..lin4`` (C,).

Defaults differ from the JAX package: ``make_lpips_fn(seed)`` draws its
random features from a ``torch.Generator``, JAX's from ``jax.random``, so
the two seeded defaults are two different metrics.  The same metric on
both sides needs the same parameters: ``lpips_params_from_jax`` carries a
JAX LPIPS tree across, ``lpips_params_from_torch`` maps the lpips package's
state dict.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

WIDTHS = (64, 192, 384, 256, 256)
# (kernel, stride, padding) of conv0..conv4, and whether a 3x3/2 max pool
# follows the tap
_CONVS = ((11, 4, 2, True), (5, 1, 2, True), (3, 1, 1, False), (3, 1, 1, False), (3, 1, 1, False))
# lpips package conv prefixes (torchvision's alexnet().features numbering), in tap order
_TORCH_CONV_KEYS = ("net.slice1.0", "net.slice2.3", "net.slice3.6", "net.slice4.8", "net.slice5.10")


class AlexFeatureNet(nn.Module):
    """AlexNet-shaped trunk: the post-ReLU activations of its five conv
    stages (the taps of LPIPS(alex))."""

    def __init__(self, widths: Sequence[int] = WIDTHS):
        super().__init__()
        self.in_shift = nn.Parameter(torch.zeros(3))
        self.in_scale = nn.Parameter(torch.ones(3))
        c_in = 3
        for i, (c, (k, s, p, _)) in enumerate(zip(widths, _CONVS)):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, c, k, s, p))
            c_in = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - self.in_shift.reshape(1, 3, 1, 1)) / self.in_scale.reshape(1, 3, 1, 1)
        feats = []
        for i, (_, _, _, pool) in enumerate(_CONVS):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """``d(a, b) = sum_l mean_nhw(|w_l| . (unit(F_l(a)) - unit(F_l(b)))^2)``."""

    def __init__(self, widths: Sequence[int] = WIDTHS):
        super().__init__()
        self.features = AlexFeatureNet(widths)
        for i, c in enumerate(widths):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.features(a * 2.0 - 1.0)
        fb = self.features(b * 2.0 - 1.0)
        total = a.new_zeros(())
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa * torch.rsqrt(torch.sum(xa * xa, 1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt(torch.sum(xb * xb, 1, keepdim=True) + 1e-10)
            w = torch.abs(getattr(self, f"lin{i}")).reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((na - nb) ** 2 * w, 1))
        return total


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv init: truncated normal (2 std) with variance
    1/fan_in after truncation."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lpips_fn_from_module(module: LPIPS) -> Callable:
    """The differentiable ``(a, b) -> scalar`` distance of a frozen LPIPS
    module, moved to the inputs' device on call."""
    module.requires_grad_(False).eval()

    def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return module.to(a.device)(a, b)

    return distance


def random_lpips(seed: int = 0) -> LPIPS:
    """LPIPS with random features (conv kernels drawn as flax draws them,
    biases 0, heads 1) from a ``torch.Generator`` seeded with ``seed``: a
    stand-in where no trained weights are at hand, not JAX's default."""
    module = LPIPS()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for i in range(len(WIDTHS)):
            conv = getattr(module.features, f"conv{i}")
            _lecun_normal_(conv.weight, gen)
            conv.bias.zero_()
    return module


def make_lpips_fn(seed: int = 0) -> Callable:
    """The distance of ``random_lpips(seed)``."""
    return lpips_fn_from_module(random_lpips(seed))


def lpips_fn_from_params(state: Mapping[str, torch.Tensor]) -> Callable:
    """The distance with the given state dict (strict load)."""
    module = LPIPS()
    module.load_state_dict(state, strict=True)
    return lpips_fn_from_module(module)


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float()
    return torch.from_numpy(np.array(a, np.float32))


def lpips_params_from_jax(tree: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """A JAX ``LPIPS`` parameter tree (numpy leaves: ``features/conv{i}/
    kernel`` HWIO, ``bias``, ``in_shift``, ``in_scale``, ``lin{i}``) as the
    port's state dict."""
    feats = tree["features"]
    out = {
        "features.in_shift": _tensor(feats["in_shift"]),
        "features.in_scale": _tensor(feats["in_scale"]),
    }
    for i in range(len(WIDTHS)):
        conv = feats[f"conv{i}"]
        out[f"features.conv{i}.weight"] = _tensor(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy())
        out[f"features.conv{i}.bias"] = _tensor(conv["bias"])
        out[f"lin{i}"] = _tensor(tree[f"lin{i}"])
    return out


def lpips_params_from_torch(state: Mapping, base: Optional[Mapping[str, torch.Tensor]] = None
                            ) -> Dict[str, torch.Tensor]:
    """The lpips package's AlexNet state dict as the port's state dict
    (the mapping of ``io/convert_lpips.py``, without its OIHW->HWIO
    transpose: both sides are torch).

    The distributed weight files hold only the ``lin{i}.model.1.weight``
    heads; for those pass ``base``, a port state dict whose ``features.*``
    supply the trunk.  A head-only state dict without ``base`` raises."""
    has_net = f"{_TORCH_CONV_KEYS[0]}.weight" in state
    if not has_net and base is None:
        raise ValueError(
            "state_dict has no net.slice* conv weights (a lin-only checkpoint like "
            "lpips/weights/v0.1/alex.pth); pass base with a trunk to merge the heads into"
        )
    if has_net:
        out = {}
        for i, key in enumerate(_TORCH_CONV_KEYS):
            out[f"features.conv{i}.weight"] = _tensor(state[f"{key}.weight"])
            out[f"features.conv{i}.bias"] = _tensor(state[f"{key}.bias"])
        if "scaling_layer.shift" in state:
            out["features.in_shift"] = _tensor(state["scaling_layer.shift"]).reshape(-1)
            out["features.in_scale"] = _tensor(state["scaling_layer.scale"]).reshape(-1)
        else:
            out["features.in_shift"] = torch.zeros(3)
            out["features.in_scale"] = torch.ones(3)
    else:
        out = {k: v for k, v in base.items() if k.startswith("features.")}
    for i in range(len(WIDTHS)):
        out[f"lin{i}"] = _tensor(state[f"lin{i}.model.1.weight"]).reshape(-1)
    return out


def alex_feature_fn_from_params(state: Mapping[str, torch.Tensor], layer: int = -1,
                                device="cuda") -> Callable:
    """``(N, H, W, 3)`` numpy images in [0, 1] -> ``(N, C)`` numpy: the
    spatial mean of one ``AlexFeatureNet`` tap (default the last), an
    FID/KID feature extractor (``metrics/fid.py``).  ``state`` is a full
    LPIPS state dict (its ``features.*`` are used) or a bare trunk's."""
    trunk = {k[len("features."):]: v for k, v in state.items() if k.startswith("features.")}
    net = AlexFeatureNet()
    net.load_state_dict(trunk or dict(state), strict=True)
    net = net.requires_grad_(False).eval().to(device)

    @torch.no_grad()
    def features(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).permute(0, 3, 1, 2)
        return torch.mean(net(t * 2.0 - 1.0)[layer], dim=(2, 3)).cpu().numpy()

    return features

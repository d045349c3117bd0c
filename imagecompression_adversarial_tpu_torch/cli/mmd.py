"""CLI: distribution-level sample quality, KID (MMD^2), FID and the
Inception Score, on the GPU (port of
``imagecompression_adversarial_tpu/cli/mmd.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.mmd 'a/*.png' 'b/*.png' \\
        --do-fid --do-mmd [--model random|alex] [--alex-ckpt lpips_alex.pth]

``--model random`` extracts features with the seeded random conv net
(``metrics/fid.py``; its kernels come from a ``torch.Generator``, so its
numbers are not the JAX CLI's), ``alex`` with the LPIPS AlexNet trunk:
random (``metrics/lpips.py::random_lpips(0)``) or the lpips package's state
dict given by ``--alex-ckpt``.  Inputs are image globs or ``.npy`` files (a
2-D array holds feature codes); the Inception Score uses a fixed random
100-class head.  ``--output`` writes the results as JSON.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..metrics.fid import frechet_distance, inception_score, kid, make_conv_feature_fn
from ..runtime import resolve_device


def _feature_fn(args, device):
    if args.model == "alex":
        from ..metrics.lpips import (
            alex_feature_fn_from_params, lpips_params_from_torch, random_lpips,
        )

        if args.alex_ckpt:
            import torch

            state = torch.load(args.alex_ckpt, map_location="cpu", weights_only=True)
            params = lpips_params_from_torch(state)
        else:
            params = random_lpips(0).state_dict()
        return alex_feature_fn_from_params(params, device=device)
    return make_conv_feature_fn(dim=args.dims, seed=0, device=device)


def _load_stack(spec: str):
    """An image glob or a .npy: ('feats', (N, D) codes) for a 2-D array,
    else ('images', a list of (1, H, W, 3) float32 images in [0, 1])."""
    if spec.endswith(".npy"):
        arr = np.load(spec, mmap_mode="r")
        if arr.ndim == 2:
            return "feats", np.asarray(arr, np.float32)
        if arr.ndim == 3:
            arr = arr[None] if arr.shape[-1] == 3 else arr[..., None]
        x = np.asarray(arr, np.float32)
        if x.shape[-1] == 1:  # gray: repeated into RGB as io.image.read_image does
            x = np.tile(x, (1, 1, 1, 3))
        if x.max() > 1.5:  # 8-bit images
            x = x / 255.0
        return "images", [x[i:i + 1] for i in range(x.shape[0])]
    from ..io.image import list_images, read_image

    files = list_images(spec)
    if not files:
        raise SystemExit(f"no images match {spec!r}")
    return "images", [read_image(f)[0] for f in files]


def _codes(spec: str, feature_fn) -> np.ndarray:
    kind, data = _load_stack(spec)
    if kind == "feats":
        return data
    return np.concatenate([feature_fn(im) for im in data], axis=0)


def _proxy_probs(feats: np.ndarray, n_classes: int = 100) -> np.ndarray:
    """Class probabilities for the IS without a pretrained classifier: the
    features through a fixed random head and a softmax."""
    rng = np.random.RandomState(0)
    w = rng.randn(feats.shape[1], n_classes).astype(np.float32)
    logits = feats @ w / np.sqrt(feats.shape[1])
    logits -= logits.max(1, keepdims=True)
    e = np.exp(logits)
    return e / e.sum(1, keepdims=True)


def run(args) -> dict:
    device = resolve_device(args.device)
    feature_fn = _feature_fn(args, device)
    feats_s = _codes(args.samples, feature_fn)
    if args.save_codes:
        np.save(args.save_codes, feats_s)
        print(f"codes: {feats_s.shape} -> {args.save_codes}")

    results = {"n_samples": int(feats_s.shape[0]), "model": args.model}
    if args.do_inception:
        mean, std = inception_score(_proxy_probs(feats_s),
                                    n_splits=min(args.splits, feats_s.shape[0]))
        results["is"] = [mean, std]
        print(f"IS: {mean:.4f} +- {std:.4f} (proxy head, {args.model} feats)")
    if args.reference is not None:
        feats_r = _codes(args.reference, feature_fn)
        results["n_reference"] = int(feats_r.shape[0])
        if args.do_fid:
            results["fid"] = frechet_distance(feats_s, feats_r)
            print(f"FID: {results['fid']:.6f}")
        if args.do_mmd:
            mean, std = kid(feats_s, feats_r, n_subsets=args.mmd_subsets,
                            subset_size=args.mmd_subset_size, degree=args.mmd_degree,
                            gamma=args.mmd_gamma, coef0=args.mmd_coef0)
            results["kid"] = [mean, std]
            print(f"KID (MMD^2): {mean:.6f} +- {std:.6f}")
    if args.output:
        d = os.path.dirname(args.output)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(results, f, indent=1)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mmd", description=__doc__.splitlines()[0])
    p.add_argument("samples", help="image glob or .npy (images or 2-D codes)")
    p.add_argument("reference", nargs="?", default=None,
                   help="second set for FID/KID (glob or .npy)")
    p.add_argument("--output", "-o", help="write results JSON here")
    p.add_argument("--model", choices=("random", "alex"), default="random")
    p.add_argument("--alex-ckpt", default=None,
                   help="torch LPIPS(alex) state_dict (.pth) for --model alex")
    p.add_argument("--dims", type=int, default=64, help="random-conv feature width")
    p.add_argument("--save-codes", default=None,
                   help="save sample feature codes (.npy) and continue")
    p.add_argument("--do-fid", action="store_true", default=False)
    p.add_argument("--do-mmd", action="store_true", default=False)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--do-inception", action="store_true", default=True)
    g.add_argument("--no-inception", action="store_false", dest="do_inception")
    p.add_argument("--mmd-degree", type=int, default=3)
    p.add_argument("--mmd-gamma", type=float, default=None)
    p.add_argument("--mmd-coef0", type=float, default=1.0)
    p.add_argument("--mmd-subsets", type=int, default=100)
    p.add_argument("--mmd-subset-size", type=int, default=1000)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("-device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if (args.do_fid or args.do_mmd) and args.reference is None:
        p.error("need REFERENCE if you're doing FID/KID")
    return run(args)


if __name__ == "__main__":
    main()

"""Where the time of an RD attack goes on the card.

    python -m imagecompression_adversarial_tpu_torch.cli.profile_attack \
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack

Runs the main path's attack (hyper q1, 768x512, ``-two_phase select``,
50 steps) on a numpy-made image once to warm up, then times whole attacks
on three GDN routes in turns (each route's runs placed symmetrically): both
kernels; the forward kernel with the plain backward (the route before the
backward kernel); the plain GDN.  Then it profiles one attack with both
kernels with ``torch.profiler`` and prints device time by kernel.  The device's idle share is printed twice: measured
in the profiled window (which the profiler's own host cost inflates), and
estimated from the profiled run's busy time over the wall time of the
unprofiled kernel runs.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..attacks import RDAttackConfig, make_attack_fn
from ..config import Config, apply_precision
from ..io.image import synthetic_image, to_tensor
from ..kernels import gdn
from ..models.layers import GDN
from ..runtime import load_model

QUALITY = 1
HEIGHT, WIDTH = 512, 768
STEPS = 50
TOP = 25
ROUTES = ("kernels", "plain backward", "plain")


def _set_gdn(model, use_kernel: bool) -> None:
    for m in model.modules():
        if isinstance(m, GDN):
            m.use_kernel = use_kernel


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-ckpt", dest="checkpoint", required=True)
    args = p.parse_args(argv)

    cfg = Config(device="cuda", model="hyper", quality=QUALITY, checkpoint=args.checkpoint)
    apply_precision(cfg)
    model = load_model(cfg)
    x = to_tensor(synthetic_image(HEIGHT, WIDTH, seed=0), "cuda")
    attack = make_attack_fn(model, RDAttackConfig(steps=STEPS, two_phase_impl="select"))

    def timed(route: str) -> float:
        _set_gdn(model, route != "plain")
        backward = gdn.gdn_backward
        if route == "plain backward":  # GDNFunction.backward looks it up per call
            gdn.gdn_backward = gdn.gdn_backward_reference
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            attack(x)["vi"].item()
            return time.perf_counter() - t0
        finally:
            gdn.gdn_backward = backward

    for route in ROUTES:  # warm-up: cuDNN plans, the kernel build
        timed(route)
    rates = {route: [] for route in ROUTES}
    for route in ROUTES + ROUTES[::-1]:
        rates[route].append(STEPS / timed(route))
    for route, rs in rates.items():
        print(f"attack {WIDTH}x{HEIGHT} x{STEPS} steps, GDN {route}: steps/s "
              f"{rs[0]:.2f} {rs[1]:.2f}", flush=True)

    _set_gdn(model, True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attack(x)["vi"].item()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    events.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events)
    unprofiled_us = 1e6 * STEPS / min(rates["kernels"])
    print(f"profiled attack: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
          f"idle share of this window {1.0 - busy / wall_us:.3f}", flush=True)
    print(f"estimated idle share unprofiled: {1.0 - busy / unprofiled_us:.3f} (this busy time over "
          f"the slower unprofiled kernel run, wall {unprofiled_us / 1e3:.2f} ms)", flush=True)
    print(f"{'device ms':>10} {'share':>6} {'calls':>7}  name")
    for e in events[:TOP]:
        print(f"{_device_us(e) / 1e3:10.3f} {_device_us(e) / busy:6.3f} {e.count:7d}  {e.key[:110]}")


if __name__ == "__main__":
    main()

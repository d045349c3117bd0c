"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``imagecompression_adversarial_tpu_torch`` only (no JAX):

1. requires CUDA and prints the card's name and power limit;
2. builds the GDN kernel with nvcc (``kernels/_build.py``) and prints what
   ``ptxas -v`` reports of it: registers, shared memory, spills (any spill
   fails the phase);
3. holds the kernel against its plain PyTorch version for GDN and IGDN at
   the shapes of the hyper q=1 attack at 768x512 (and C=192), forward (the
   kernel) and dx (the shared plain backward, a check of the autograd
   wiring), and times the kernel, the plain version and ``torch.addmm`` beside
   the card's bound, and prints the launch the kernel picks (rows per tile,
   blocks an SM, grid); the 6,144- and 24,576-row calls are also timed over
   500 launches and with L2 flushed before each launch;
4. runs the attack CLI's ``run`` path (hyper q=1, the committed demo
   weights, a 768x512 image made with numpy, 1001 steps,
   ``-two_phase select``) and counts the kernel's launches in it;
5. runs a 20-step attack at 256x256 (hyper q=1, demo weights) with the
   kernel and with the plain version and compares the final noise and vi;
6. writes a 256x256 PNG with the port's writer into a temporary directory,
   runs the CLI on it (``-s``, 5 steps, ``--debug``, cwd there), reads its
   three debug PNGs back with the port's reader and removes the directory;
7. runs the CLI's ``run`` path on the paper's full model, cheng2020-gmm q=3
   (N=128, the committed demo weights), at 768x512 for 1001 steps with
   ``-two_phase select``, and counts the kernel's launches in it;
8. for factorized, context and debug at q=1 (seeded weights) and for
   cheng2020-attn and cheng2020 on the cheng2020-gmm demo's trained
   transforms, runs a 20-step attack at 256x256 as phase 5 does, at phase
   5's tolerances (cheng2020: ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL); prints
   the launch the kernel picks for context's widest call (C=192).

Phases 5 and 8 set cuDNN deterministic, so that the kernel and plain runs
differ in the GDN alone.

Every phase prints one line with the elapsed seconds; any failure raises
and the script exits nonzero.  It prints a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  It writes nothing but the
kernel build (``imagecompression_adversarial_tpu_torch/_build/``) and phase
6's temporary directory.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "ckpts", "demo", "hyper-q1-mse-synthetic.msgpack")
CKPT_GMM = os.path.join(ROOT, "ckpts", "demo", "cheng2020-gmm-q3-mse-synthetic.msgpack")

# H100 SXM peaks (NVIDIA data sheet): HBM rate, the dense TF32 tensor-core
# rate (the kernel's product runs there) and, as a second column, the fp32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain version, elementwise |k - p| <= ATOL + RTOL * |p|.  The
# plain version is an fp32 product (TF32 off).  The kernel's is 3xTF32: x^2
# and gamma are each split into a TF32 hi part and a TF32 lo part (rounded
# to nearest), and hi*hi + hi*lo + lo*hi accumulate in fp32; only lo*lo,
# about 2^-22 relative, is dropped, and every term is non-negative, so norm
# stays within about 1e-6 relative of the fp32 product and out within half
# that plus rsqrtf/sqrtf's 2 ulp
GDN_RTOL, GDN_ATOL = 1e-5, 1e-6
# 20-step attack, kernel vs plain GDN: Adam divides each gradient by its
# running RMS plus 1e-8, so a pixel whose gradient is near 1e-8 moves by up
# to lr (1e-2) per step on an fp32 rounding difference; the noise elements
# stay within NOISE_ATOL and vi within VI_ATOL dB
NOISE_ATOL = 1e-4
VI_ATOL = 1e-3
# cheng2020 (the anchor) on the demo's trained transforms: its ~65 convs in
# sequence amplify rounding, so that the plain GDN summing in float64 lands
# 2.045e-3 (noise) and 2.65e-3 dB (vi) from the float32 plain GDN after 20
# steps, and no float32 GDN can meet the bounds above.  The kernel reads
# 2.045e-3 and 2.67e-3 dB from the float32 plain GDN (NVIDIA H100 80GB
# HBM3, 700 W; the gap is 2.0e-3 to 2.5e-3 at 5 to 15 steps too)
ANCHOR_NOISE_ATOL = 5e-3
ANCHOR_VI_ATOL = 5e-3

# (C, rows) of the GDN/IGDN calls of the hyper attack at 768x512 (q1-5,
# C=128; cheng2020* q1-3 makes the same calls) plus the widest call of q6-8
# (C=192)
GDN_SHAPES = ((128, 98304), (128, 24576), (128, 6144), (192, 6144))
TIMED_LAUNCHES = 50
# calls small enough for x and out to stay in the 50 MB L2 between
# back-to-back launches: also timed over 500 launches and with a 64 MB write
# before each launch, which evicts them as the attack's other kernels do
L2_RESIDENT_ROWS = (24576, 6144)
LONG_LAUNCHES = 500
FLUSH_BYTES = 64 << 20
# a device-side wait (~0.1 ms) queued before each flushed launch, so the
# host has enqueued the launch before the device reaches its start event
# and the interval holds the kernel alone, not the wrapper's host time
SLEEP_CYCLES = 200_000


def log(msg: str) -> None:
    print(f"[chip_smoke t={time.time() - T0:7.1f}s] {msg}", flush=True)


def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_ms_flushed(fn, flush, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time of ``fn`` with ``flush`` run before each launch,
    outside the timed interval."""
    import torch

    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    for start, end in events:
        torch.cuda._sleep(SLEEP_CYCLES)
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / n


def phase_kernel_vs_plain(gdn):
    """Phase 3: forward and dx of kernel and plain version; timings.

    The forward is the kernel's test.  ``GDNFunction.backward`` is the same
    plain torch for both routes and reads only the saved inputs, so the dx
    check tests the autograd wiring around the kernel, not the kernel; its
    error is reported apart and kept out of ``max_abs_err``.
    """
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    records = []
    for c, rows in GDN_SHAPES:
        x = 2.0 * torch.randn(rows, c, device="cuda", generator=gen)
        gamma = 0.1 * torch.eye(c, device="cuda") + 0.01 * torch.rand(
            c, c, device="cuda", generator=gen
        )
        beta = 0.5 + torch.rand(c, device="cuda", generator=gen)
        g = torch.randn(rows, c, device="cuda", generator=gen)
        for inverse in (False, True):
            torch.cuda.synchronize()
            layout = gdn.kernel_layout(rows, c, inverse)
            outs = []
            for use_kernel in (True, False):
                xg = x.clone().requires_grad_(True)
                out = gdn.GDNFunction.apply(xg, gamma, beta, inverse, use_kernel)
                (dx,) = torch.autograd.grad(out, xg, g)
                outs.append((out.detach(), dx))
            torch.cuda.synchronize()
            errs = {}
            for k, p, what in ((outs[0][0], outs[1][0], "forward"), (outs[0][1], outs[1][1], "dx")):
                if not torch.isfinite(k).all():
                    raise RuntimeError(f"gdn C={c} rows={rows} inverse={inverse}: non-finite {what}")
                bad = (k - p).abs() > GDN_ATOL + GDN_RTOL * p.abs()
                if bad.any():
                    raise RuntimeError(
                        f"gdn C={c} rows={rows} inverse={inverse}: {what} differs at "
                        f"{int(bad.sum())} elements, max |diff| {(k - p).abs().max().item():.3e}"
                    )
                errs[what] = (k - p).abs().max().item()
            def kernel():
                gdn.gdn_forward(x, gamma, beta, inverse)

            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: gdn.gdn_forward_reference(x, gamma, beta, inverse))
            library_ms = time_ms(lambda: torch.addmm(beta, x * x, gamma.T))
            nbytes = 4 * (2 * rows * c + c * c + c)
            flops = rows * c * (2 * c + 4)
            byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            op_ms = 1e3 * flops / TF32_FLOP_PER_S
            rec = {
                "C": c, "rows": rows, "inverse": inverse, "max_abs_err": errs["forward"],
                "dx_max_abs_err": errs["dx"],
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "fp32_bound_ms": max(byte_ms, 1e3 * flops / FP32_FLOP_PER_S),
                "layout": layout,
            }
            more = ""
            if rows in L2_RESIDENT_ROWS:
                rec["ms_500"] = time_ms(kernel, LONG_LAUNCHES)
                rec["ms_l2_flushed"] = time_ms_flushed(kernel, flush_buf.zero_)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(LONG_LAUNCHES):
                    kernel()
                rec["host_ms"] = 1e3 * (time.perf_counter() - t0) / LONG_LAUNCHES
                torch.cuda.synchronize()
                more = (f" (x{LONG_LAUNCHES} {rec['ms_500']:.4f}, L2 flushed "
                        f"{rec['ms_l2_flushed']:.4f}, host enqueue {rec['host_ms']:.4f})")
            records.append(rec)
            log(
                f"phase 3 {'IGDN' if inverse else 'GDN '} C={c} rows={rows}: max_abs_err "
                f"{errs['forward']:.3e} (dx {errs['dx']:.3e})  kernel {ms:.4f} ms{more}  plain "
                f"{plain_ms:.4f} ms  addmm {library_ms:.4f} ms  bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}; fp32-pipe bound {rec['fp32_bound_ms']:.4f} ms)  "
                f"launch: {layout['tile']}-row tiles, {layout['blocks_per_sm']} blocks/SM, "
                f"grid {layout['grid']}, {layout['smem_bytes']} B shared"
            )
    return records


def phase_main_path(gdn):
    """Phase 4: the attack CLI's run path at full width and size."""
    from imagecompression_adversarial_tpu_torch.cli.attack_rd import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    steps = 1001
    cfg = parse_config([
        "-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT,
        "-steps", str(steps), "-two_phase", "select", "-device", "cuda",
    ])
    im = synthetic_image(512, 768, seed=0)
    gdn.reset_launch_counts()
    avg = run(cfg, images=[("synthetic-768x512", im, 512, 768)])
    launches = gdn.launch_counts["gdn_fwd"]
    for key in ("vi", "bpp_ori", "bpp"):
        if not math.isfinite(avg[key]):
            raise RuntimeError(f"main path: {key} is not finite ({avg[key]})")
    if launches == 0:
        raise RuntimeError("main path ran without launching the GDN kernel")
    log(
        f"phase 4 main path: {steps / avg['t']:.2f} steps/s (incl. clean forward and eval), "
        f"vi {avg['vi']:.4f}, bpp_ori {avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}, "
        f"gdn_fwd launches {launches} ({launches / steps:.3f} per step)"
    )
    return launches


def load_codec(model: str, quality: int, checkpoint=None, demo_transforms: bool = False):
    """The codec on the card; ``demo_transforms`` fills every parameter that
    the cheng2020-gmm demo checkpoint shares with ``model`` from it (all of
    g_a and g_s for cheng2020 and cheng2020-attn) and keeps the seeded rest."""
    import torch

    from imagecompression_adversarial_tpu_torch.config import Config
    from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint
    from imagecompression_adversarial_tpu_torch.runtime import load_model

    codec = load_model(Config(device="cuda", model=model, quality=quality, checkpoint=checkpoint))
    if demo_transforms:
        own = codec.state_dict()
        demo = load_checkpoint(CKPT_GMM, "cheng2020-gmm")
        shared = {k: v for k, v in demo.items() if k in own and v.shape == own[k].shape}
        if not any(k.startswith("g_s.") for k in shared):
            raise RuntimeError(f"{model}: the demo checkpoint shares no synthesis with it")
        codec.load_state_dict({**own, **shared}, strict=True)
        codec = codec.to(memory_format=torch.channels_last)
    return codec


def attack_kernel_vs_plain(gdn, label: str, codec, debug_model: bool = False,
                           noise_atol: float = NOISE_ATOL, vi_atol: float = VI_ATOL) -> int:
    """20-step attack at 256x256 with the kernel and with the plain GDN,
    cuDNN set deterministic; every element of the final noise must agree
    within ``noise_atol`` and vi within ``vi_atol`` dB.  Returns the kernel
    run's launches."""
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    x = to_tensor(synthetic_image(256, 256, seed=1), "cuda")
    attack = make_attack_fn(codec, RDAttackConfig(steps=20, two_phase_impl="select",
                                                  debug_model=debug_model))
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    results = []
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        for use_kernel in (True, False):
            for m in codec.modules():
                if isinstance(m, GDN):
                    m.use_kernel = use_kernel
            gdn.reset_launch_counts()
            res = attack(x, torch.Generator("cuda").manual_seed(0))
            torch.cuda.synchronize()
            results.append((res["im_"] - x, res["vi"].item(), gdn.launch_counts["gdn_fwd"]))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    (nk, vik, lk), (npl, vip, lp) = results
    diff = (nk - npl).abs().max().item()
    log(f"{label} attack 256x256 x20 steps: max |noise diff| {diff:.3e} (tol {noise_atol}), "
        f"vi kernel {vik:.6f} plain {vip:.6f} (tol {vi_atol}), gdn_fwd launches {lk} / {lp}")
    has_gdn = any(isinstance(m, GDN) for m in codec.modules())
    if (lk == 0) == has_gdn or lp != 0:
        raise RuntimeError(f"{label}: launch counts: kernel run {lk}, plain run {lp}")
    if not (math.isfinite(vik) and math.isfinite(vip)):
        raise RuntimeError(f"{label}: non-finite vi ({vik}, {vip})")
    if diff > noise_atol or abs(vik - vip) > vi_atol:
        raise RuntimeError(f"{label}: kernel vs plain attack differ beyond the tolerances")
    return lk


def phase_attack_kernel_vs_plain(gdn):
    """Phase 5: the hyper q1 attack (demo weights), kernel vs plain GDN."""
    attack_kernel_vs_plain(gdn, "phase 5 hyper q1", load_codec("hyper", 1, CKPT))


def phase_cli_png():
    """Phase 6: the CLI's file path, a PNG in through ``-s`` and the
    ``--debug`` PNGs out, with the port's own PNG codec."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import main as cli_main
    from imagecompression_adversarial_tpu_torch.io.image import (
        read_image, synthetic_image, write_image,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_png_")
    cwd = os.getcwd()
    try:
        src = os.path.join(tmp, "synthetic01.png")
        write_image(synthetic_image(256, 256, seed=2), src)
        os.chdir(tmp)
        cli_main(["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-s", src,
                  "-steps", "5", "--debug", "-device", "cuda"])
        for kind in ("advin", "advout", "noise"):
            im, h, w = read_image(os.path.join(tmp, "attack", "results",
                                               f"hyper_1_mse_synthetic01_{kind}.png"))
            if (h, w) != (256, 256) or im.shape != (1, 256, 256, 3) or not np.isfinite(im).all():
                raise RuntimeError(f"phase 6: {kind} PNG read back as {im.shape}, ({h}, {w})")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
    log("phase 6 CLI on a PNG: -s in, 3 --debug PNGs out and read back at 256x256")


def phase_slice2_path(gdn):
    """Phase 7: the CLI's run path on cheng2020-gmm q3 at full width and
    size, the phase-space loss on (auto)."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    steps = 1001
    cfg = parse_config([
        "-m", "cheng2020-gmm", "-q", "3", "-metric", "mse", "-ckpt", CKPT_GMM,
        "-steps", str(steps), "-two_phase", "select", "-device", "cuda",
    ])
    im = synthetic_image(512, 768, seed=0)
    torch.cuda.reset_peak_memory_stats()
    gdn.reset_launch_counts()
    avg = run(cfg, images=[("synthetic-768x512", im, 512, 768)])
    launches = gdn.launch_counts["gdn_fwd"]
    for key in ("vi", "bpp_ori", "bpp"):
        if not math.isfinite(avg[key]):
            raise RuntimeError(f"phase 7: {key} is not finite ({avg[key]})")
    if launches == 0:
        raise RuntimeError("phase 7 ran without launching the GDN kernel")
    log(
        f"phase 7 cheng2020-gmm q3 768x512: {steps / avg['t']:.2f} steps/s (incl. clean forward "
        f"and eval, {avg['t']:.2f} s), vi {avg['vi']:.4f}, bpp_ori {avg['bpp_ori']:.4f}, "
        f"bpp {avg['bpp']:.4f}, gdn_fwd launches {launches} ({launches / steps:.3f} per step), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    return launches


def phase_families_kernel_vs_plain(gdn):
    """Phase 8: every other new family, kernel vs plain GDN.  factorized,
    context and debug run at q1 with seeded weights.  cheng2020-attn and
    cheng2020 run with the demo checkpoint's trained transforms (N=128, as
    at q1-3): with seeded transforms their attack is chaotic."""
    import torch

    torch.cuda.synchronize()
    layout = gdn.kernel_layout(128 * 128, 192, False)
    log(f"phase 8 context's widest GDN call (C=192, 16,384 rows): {layout['tile']}-row tiles, "
        f"{layout['blocks_per_sm']} blocks/SM, grid {layout['grid']}, "
        f"{layout['smem_bytes']} B shared")
    launches = {}
    for model in ("factorized", "context", "debug"):
        launches[f"{model} q1"] = attack_kernel_vs_plain(
            gdn, f"phase 8 {model} q1", load_codec(model, 1), debug_model=(model == "debug"))
    for model, noise_atol, vi_atol in (("cheng2020-attn", NOISE_ATOL, VI_ATOL),
                                       ("cheng2020", ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL)):
        launches[f"{model} q3 demo transforms"] = attack_kernel_vs_plain(
            gdn, f"phase 8 {model} q3 demo transforms",
            load_codec(model, 3, demo_transforms=True), noise_atol=noise_atol, vi_atol=vi_atol)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from imagecompression_adversarial_tpu_torch.kernels import _build, gdn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t = time.time()
    cached = _build.library_path().is_file()
    _build.load_library()
    log(f"phase 2 build: {time.time() - t:.2f} s ({'cached' if cached else 'nvcc'}) "
        f"-> {_build.library_path().name}")
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    for line in ptxas:
        log(f"phase 2 ptxas: {line}")
    if not any("registers" in ln for ln in ptxas):
        raise RuntimeError("phase 2: the build log has no ptxas register report")
    spills = [ln for ln in ptxas
              if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))]
    if spills:
        raise RuntimeError(f"phase 2: ptxas reports register spills: {spills}")

    records = phase_kernel_vs_plain(gdn)
    launches = phase_main_path(gdn)
    phase_attack_kernel_vs_plain(gdn)
    phase_cli_png()
    launches_gmm = phase_slice2_path(gdn)
    launches_families = phase_families_kernel_vs_plain(gdn)

    head = records[0]  # the largest call of the main path: C=128, rows 98,304, GDN
    print(json.dumps({"kernels": [{
        "name": "gdn_fwd",
        "route": "cuda",
        "source": "imagecompression_adversarial_tpu_torch/csrc/gdn.cu",
        "replaces": "scripts/pallas_gdn.py:100",
        "launches": launches,
        "launches_by_phase": {
            "4 hyper q1 768x512": launches,
            "7 cheng2020-gmm q3 768x512": launches_gmm,
            **{f"8 {m} 256x256": n for m, n in launches_families.items()},
        },
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "fp32_bound_ms": head["fp32_bound_ms"],
        "shape": {"rows": head["rows"], "C": head["C"], "inverse": head["inverse"]},
        "per_shape": records,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

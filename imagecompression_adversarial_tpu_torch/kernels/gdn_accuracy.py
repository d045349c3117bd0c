"""How the GDN kernels form their channel products, and what each way
costs in accuracy and time on the card.

Usage (needs an NVIDIA GPU and nvcc)::

    python -m imagecompression_adversarial_tpu_torch.kernels.gdn_accuracy \
        [--what forward|product2|both|loops] [--out FILE]

``csrc/gdn.cu`` is built in variants that differ only in one loop; the
rest is the committed source.  Everything runs on the weights of the JAX
trainer's committed orbax step 2000 (hyper q4) and 8 synthetic 256x256
crops (``chip_smoke.py`` phase 20c's inputs).

``forward``: the forward kernel's product 1, the norm's k step of 8
channels (``norm_sums``; the backward kernel has its own, ``bwd_norm_sums``,
in the same order): the committed one (fp32 FMA) and v4's tensor-core step
(3xTF32, the previous version) with the products of ``TF32_PRODUCTS``.  For
each:

* forward: every GDN/IGDN call of one noise-quantized forward, the signed
  mean of the output's relative error against a float64 product, per call
  (a bias shows there; rounding to nearest has none), and the largest
  |relative error|;
* gradient: dgamma and dbeta of every GDN for the RD loss, the largest
  distance over the tensors, relative to each tensor's largest element,
  from the plain float32 GDN's (phase 20c's measure) and from a float64
  run of the plain GDN (codec and batch in float64, the float32 draws of
  the noise);
* time: CUDA events, the median of 20 launches at 131,072 rows and C=128
  (that forward's largest call) and at 98,304 rows and C=192.

The plain float32 GDN (cuBLAS, TF32 off) is measured beside them.

``product2``: the backward's dnorm @ gamma (``bwd_grad_sums``), whose order in
cuBLAS's SGEMM the backward kernel must take to give the plain backward's
dx bit for bit: the committed step (one fp32 FMA chain over o ascending)
and ``PRODUCT2_PRODUCTS``.  For each, on every GDN call of the RD loss's
backward with its real output gradient: the share of dx elements equal to
the plain backward's, the largest gap and the share past 1e-6, the largest
dnorm gap (``backward_error``); and the dx-only time at 98,304 rows, C=128.

``loops``: the backward kernel's instructions, from ``cuobjdump -sass`` of the
committed build: for each kernel (1 to 6 warps a group) the instructions
of each loop by opcode (FFMA, LDS, the rest) and of the whole function;
beside them the dx-only time at 98,304 rows, C=128 and C=192, the SM clock
after it, and the time the busiest SM sub-partition needs at that clock to
dispatch the products' FFMAs alone (one warp instruction a clock) and the product
loops whole.

Prints one JSON object, and writes it to ``--out`` where given.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from . import _build, gdn

ROOT = _build.PACKAGE_DIR.parent
STEP = ROOT / "ckpts" / "adv" / "hyper-0.013-mse-0.0001-300" / "2000"

# The tensor-core helpers of v4, put before the kernel for the
# TF32 variants.
TF32_HELPERS = """\
// cvt.rna.tf32.f32 for finite v: the magnitude rounded to 10 mantissa bits,
// ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a * b on a 16x8x8 TF32 tile, fragments in the PTX ISA's m16n8k8 layout
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

"""
# v4's k step: x^2's fragment (rows g and g + 8, channels k0 + t and
# k0 + t + 4) and gamma's for each output tile split into TF32 hi and lo
# parts, then PRODUCTS' products into acc[j], the lane's four sums of the
# tile (D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]).
TF32_STEP = """\
    const float* gr = gs + (8 * first + g) * l.ld;
    const float a[4] = {xr[k0 + t], xr[8 * l.ld + k0 + t], xr[k0 + t + 4],
                        xr[8 * l.ld + k0 + t + 4]};
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(a[q] * a[q], a_hi[q], a_lo[q]);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float* b = gr + 8 * j * l.ld + k0 + t;
      uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
      split_tf32(b[0], b0_hi, b0_lo);
      split_tf32(b[4], b1_hi, b1_lo);
{products}
    }"""
TF32_PRODUCTS = {
    # every product accumulated in acc by the tensor core (v4)
    "3xTF32, one accumulator": """\
      mma_tf32(acc[j], a_lo, b0_hi, b1_hi);
      mma_tf32(acc[j], a_hi, b0_lo, b1_lo);
      mma_tf32(acc[j], a_hi, b0_hi, b1_hi);""",
    # the same with the lo*lo term kept
    "4xTF32, one accumulator": """\
      mma_tf32(acc[j], a_lo, b0_lo, b1_lo);
      mma_tf32(acc[j], a_lo, b0_hi, b1_hi);
      mma_tf32(acc[j], a_hi, b0_lo, b1_lo);
      mma_tf32(acc[j], a_hi, b0_hi, b1_hi);""",
    # the k step's products summed from zero by the tensor core and added
    # to acc by an fp32 add (rounded to nearest)
    "3xTF32, k step apart": """\
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(part, a_lo, b0_hi, b1_hi);
      mma_tf32(part, a_hi, b0_lo, b1_lo);
      mma_tf32(part, a_hi, b0_hi, b1_hi);
      for (int q = 0; q < 4; ++q) acc[j][q] += part[q];""",
    "4xTF32, k step apart": """\
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(part, a_lo, b0_lo, b1_lo);
      mma_tf32(part, a_lo, b0_hi, b1_hi);
      mma_tf32(part, a_hi, b0_lo, b1_lo);
      mma_tf32(part, a_hi, b0_hi, b1_hi);
      for (int q = 0; q < 4; ++q) acc[j][q] += part[q];""",
}
#: The variant csrc/gdn.cu holds (v5): fp32 FMA in cuBLAS's order.
COMMITTED = "fp32 FMA"
# The body of the loop over k steps of 8 channels of the forward's product 1
# (the norm, ``norm_sums``), and the first line of that function, in the
# committed source.
STEP_BODY = re.compile(
    r"(  for \(int k0 = 0; k0 < l\.Cp; k0 \+= 8\) \{\n)(.*?)(\n  \}\n\}\n)", re.S)
KERNEL_START = "template <int kJ>\n__device__ __forceinline__ void norm_sums("
PLAIN = "plain float32 (cuBLAS)"

# Product 2 of the backward, dnorm @ gamma (``bwd_grad_sums``): the body of
# its loop over steps of 8 reduction channels o (the j-th step of 8 of each
# 32), in the committed source, and the variants the probe builds in its
# place.  The committed one is one fp32 FMA chain over o = 0 .. C-1 from
# zero; the others are orders an SGEMM might take instead.
PRODUCT2_BODY = re.compile(
    r"(  for \(int o1 = 0; o1 < kCp; o1 \+= 32\) \{\n#pragma unroll\n"
    r"    for \(int j = 0; j < 4; \+\+j\) \{\n)(.*?)(\n    \}\n  \}\n\}\n)", re.S)
PRODUCT2_STEP = """\
      const int o0 = o1 + 8 * j;  // bwd_row(o0 + kk) = o0 + (kk ^ j)
      float d[kR][8];  // dnorm of the lane's rows, channels o0 .. o0 + 7
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) load8(dr + 4 * rr * kLd + o0, d[rr]);
{products}"""
PRODUCT2_PRODUCTS = {
    # each product rounded, then added
    "fp32 multiply, then add": """\
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float c[4];
        load4(gc + (o0 + (kk ^ j)) * kLd, c);
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            m[rr][q] = __fadd_rn(m[rr][q], __fmul_rn(d[rr][kk], c[q]));
      }""",
    # each step of 8 summed from zero by FMA, then added to the sum
    "fp32 FMA, each step of 8 apart": """\
      float part[kR][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float c[4];
        load4(gc + (o0 + (kk ^ j)) * kLd, c);
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[rr][q] = fmaf(d[rr][kk], c[q], part[rr][q]);
      }
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) m[rr][q] = __fadd_rn(m[rr][q], part[rr][q]);""",
    # the chain over each step of 8 from its last channel
    "fp32 FMA, each step of 8 backwards": """\
#pragma unroll
      for (int kk = 7; kk >= 0; --kk) {
        float c[4];
        load4(gc + (o0 + (kk ^ j)) * kLd, c);
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) m[rr][q] = fmaf(d[rr][kk], c[q], m[rr][q]);
      }""",
}
#: The product-2 variant csrc/gdn.cu holds.
COMMITTED_PRODUCT2 = "fp32 FMA chain, o ascending"


def _one_body(pattern: re.Pattern, source: str, what: str) -> str:
    found = pattern.findall(source)
    if len(found) != 1:
        raise ValueError(f"csrc/gdn.cu: {len(found)} {what} loops found, expected one")
    return found[0][1]


def step_body(source: str) -> str:
    """The committed kernels' k step of product 1."""
    if source.count(KERNEL_START) != 1:
        raise ValueError("csrc/gdn.cu: norm_sums not found once")
    return _one_body(STEP_BODY, source, "k-step")


def product2_body(source: str) -> str:
    """The committed backward kernel's step of product 2."""
    return _one_body(PRODUCT2_BODY, source, "product-2")


def variants(source: str) -> dict:
    """name -> the kernels' source with that k step of product 1: the
    committed one and the TF32 ones (with the tensor-core helpers)."""
    step_body(source)
    out = {COMMITTED: source}
    helpers = source.replace(KERNEL_START, TF32_HELPERS + KERNEL_START)
    for name, products in TF32_PRODUCTS.items():
        body = TF32_STEP.replace("{products}", products)
        out[name] = STEP_BODY.sub(lambda m: m.group(1) + body + m.group(3), helpers)
    return out


def product2_variants(source: str) -> dict:
    """name -> the kernels' source with that step of product 2: the
    committed one and ``PRODUCT2_PRODUCTS``."""
    product2_body(source)
    out = {COMMITTED_PRODUCT2: source}
    for name, products in PRODUCT2_PRODUCTS.items():
        body = PRODUCT2_STEP.replace("{products}", products)
        out[name] = PRODUCT2_BODY.sub(lambda m: m.group(1) + body + m.group(3), source)
    return out


def build_variants(workdir: Path, sources: dict) -> dict:
    """Every variant's library, nvcc run for all at once: name -> CDLL."""
    nvcc = _build.find_nvcc()
    workdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = workdir / f"gdn_{i}.cu"
        src.write_text(text)
        out = workdir / f"libgdn_{i}.so"
        procs[name] = (out, subprocess.Popen(_build.nvcc_command(nvcc, [src], out),
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        libs[name] = _build.declare_gdn(ctypes.CDLL(str(out)))
    return libs


@contextlib.contextmanager
def kernel_library(lib):
    """``gdn_forward`` and ``gdn_backward`` launching ``lib``'s kernels."""
    load = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = load


@contextlib.contextmanager
def float32_noise():
    """The training forward's uniform noise drawn in float32 and cast to
    the latent's dtype, so that a float64 run gets a float32 run's draws."""
    from ..ops import quant

    draw = quant.uniform_noise
    quant.uniform_noise = lambda y, generator: draw(y.float(), generator).to(y.dtype)
    try:
        yield
    finally:
        quant.uniform_noise = draw


def resumed_codec():
    """hyper q4 on the card with step 2000's params."""
    from ..config import Config
    from ..runtime import load_model
    from ..train import create_train_state, orbax

    codec = load_model(Config(device="cuda", model="hyper", quality=4))
    tree, _ = orbax.read_item(str(STEP))
    payload = orbax.train_state_dict(tree, create_train_state(codec, 1e-4), "hyper")
    codec.load_state_dict(payload["params"])
    return codec.requires_grad_(True)


def gdn_layers(codec):
    from ..models.layers import GDN

    return [m for m in codec.modules() if isinstance(m, GDN)]


def gdn_grads(codec, x):
    """dgamma and dbeta of every GDN for the noise-quantized RD loss."""
    from ..train import lambda_for, rate_distortion_loss

    result = codec(x, quant_mode="noise",
                   generator=torch.Generator(device=x.device).manual_seed(0))
    loss = rate_distortion_loss(result, x, lambda_for("mse", 4), "mse")["loss"]
    params = [p for m in gdn_layers(codec) for p in (m.gamma, m.beta)]
    return [g.detach() for g in torch.autograd.grad(loss, params)]


def gdn_calls(codec, x):
    """(x rows view, gamma, beta, inverse) of every GDN call of one forward."""
    calls = []

    def hook(m, args):
        gamma, beta = m.resolved()
        nhwc = args[0].detach().contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        calls.append((nhwc.reshape(-1, nhwc.shape[-1]).contiguous(), gamma.detach().contiguous(),
                      beta.detach().contiguous(), m.inverse))

    handles = [m.register_forward_pre_hook(hook) for m in gdn_layers(codec)]
    try:
        with torch.no_grad():
            codec(x, quant_mode="noise", generator=torch.Generator(device=x.device).manual_seed(0))
    finally:
        for h in handles:
            h.remove()
    return calls


def forward_error(fwd, calls):
    """Per call, the signed mean of ``fwd``'s relative error against the
    float64 product; and the largest |relative error| over all calls."""
    means, worst = [], 0.0
    for x, gamma, beta, inverse in calls:
        exact = gdn.gdn_forward_reference(x.double(), gamma.double(), beta.double(), inverse)
        rel = (fwd(x, gamma, beta, inverse).double() - exact) / exact.abs().clamp_min(1e-30)
        rel = rel[exact != 0]
        means.append(float(rel.mean()))
        worst = max(worst, float(rel.abs().max()))
    return {"mean_rel": means, "max_rel": worst}


def grad_distance(grads, ref):
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for a, b in zip(grads, ref))


def gdn_backward_calls(codec, x):
    """(x rows, gamma, beta, output gradient rows, inverse) of every GDN call
    of the noise-quantized RD loss, the gradients those of its backward."""
    from ..train import lambda_for, rate_distortion_loss

    calls = []

    def hook(m, args, out):
        gamma, beta = m.resolved()
        c = out.shape[1]

        def rows(t):
            return t.detach().permute(0, 2, 3, 1).reshape(-1, c).contiguous()

        call = [rows(args[0]), gamma.detach().contiguous(), beta.detach().contiguous(), None,
                m.inverse]
        calls.append(call)
        out.register_hook(lambda grad: call.__setitem__(3, rows(grad)))

    handles = [m.register_forward_hook(hook) for m in gdn_layers(codec)]
    try:
        result = codec(x, quant_mode="noise",
                       generator=torch.Generator(device=x.device).manual_seed(0))
        loss = rate_distortion_loss(result, x, lambda_for("mse", 4), "mse")["loss"]
        torch.autograd.grad(loss, [m.gamma for m in gdn_layers(codec)])
    finally:
        for h in handles:
            h.remove()
    return [tuple(c) for c in calls]


def backward_error(calls):
    """``gdn_backward``'s dx and dnorm on ``calls`` against the plain
    backward's (cuBLAS): the share of dx elements bit-equal, the largest
    |dx diff| and the share past 1e-6, and the largest |dnorm diff|.  dnorm
    and dx share the norm's product and the elementwise steps, so a dx that
    differs where dnorm does not differs in product 2, dnorm @ gamma."""
    equal = far = total = 0
    dx_max = dnorm_max = 0.0
    for x, gamma, beta, g, inverse in calls:
        dx, dnorm = gdn.gdn_backward(x, gamma, beta, g, inverse, True, True)
        ref_dx, ref_dnorm = gdn.gdn_backward_reference(x, gamma, beta, g, inverse, True, True)
        diff = (dx - ref_dx).abs()
        equal += int((dx == ref_dx).sum())
        far += int((diff > 1e-6).sum())
        total += dx.numel()
        dx_max = max(dx_max, float(diff.max()))
        dnorm_max = max(dnorm_max, float((dnorm - ref_dnorm).abs().max()))
    return {"dx_equal_share": equal / total, "dx_max_abs": dx_max,
            "dx_share_past_1e-6": far / total, "dnorm_max_abs": dnorm_max}


def time_ms(fn, rows, c, gen):
    """Median of 20 timed calls of ``fn(x, gamma, beta, g)`` at (rows, C),
    GDN, with phase 3's input recipe; CUDA events."""
    x = torch.randn(rows, c, device="cuda", generator=gen)
    gamma = 0.1 * torch.eye(c, device="cuda") + 0.01 * torch.rand(c, c, device="cuda",
                                                                   generator=gen)
    beta = 0.5 + torch.rand(c, device="cuda", generator=gen)
    g = torch.randn(rows, c, device="cuda", generator=gen)
    times = []
    for _ in range(21):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x, gamma, beta, g)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def fwd_ms(fwd, rows, c, gen):
    return time_ms(lambda x, gamma, beta, g: fwd(x, gamma, beta, False), rows, c, gen)


def bwd_ms(bwd, rows, c, gen):
    """dx alone, as the attack asks."""
    return time_ms(lambda x, gamma, beta, g: bwd(x, gamma, beta, g, False, True, False),
                   rows, c, gen)


def forward_probe(codec, batch, gen, workdir: Path) -> dict:
    """The product-1 k-step variants (``variants``): forward error, the
    training gradients' distance from the plain and the float64 GDN, times."""
    calls = gdn_calls(codec, batch)
    wide = resumed_codec().double()
    for m in gdn_layers(wide):
        m.use_kernel = False
    with float32_noise():
        exact = gdn_grads(wide, batch.double())
    del wide

    for m in gdn_layers(codec):
        m.use_kernel = False
    plain = gdn_grads(codec, batch)
    out = {"calls": [(c[0].shape[1], c[0].shape[0], c[3]) for c in calls], "variants": {}}
    out["variants"][PLAIN] = {
        "forward": forward_error(gdn.gdn_forward_reference, calls),
        "grad_from_plain": 0.0, "grad_from_f64": grad_distance(plain, exact),
        "ms_131072x128": fwd_ms(gdn.gdn_forward_reference, 131072, 128, gen),
        "ms_98304x192": fwd_ms(gdn.gdn_forward_reference, 98304, 192, gen)}
    for m in gdn_layers(codec):
        m.use_kernel = True
    libs = build_variants(workdir, variants(_build.SOURCES[0].read_text()))
    for name, lib in libs.items():
        with kernel_library(lib):
            gdn.reset_launch_counts()
            grads = gdn_grads(codec, batch)
            if gdn.launch_counts["gdn_fwd"] == 0:
                raise RuntimeError(f"{name}: the kernel was not launched")
            out["variants"][name] = {
                "forward": forward_error(gdn.gdn_forward, calls),
                "grad_from_plain": grad_distance(grads, plain),
                "grad_from_f64": grad_distance(grads, exact),
                "ms_131072x128": fwd_ms(gdn.gdn_forward, 131072, 128, gen),
                "ms_98304x192": fwd_ms(gdn.gdn_forward, 98304, 192, gen)}
        print(name, json.dumps(out["variants"][name]), flush=True)
    return out


def product2_probe(codec, batch, gen, workdir: Path) -> dict:
    """The product-2 variants (``product2_variants``) on every GDN call's
    backward of the RD loss: dx and dnorm against the plain backward's
    (``backward_error``), and the dx-only time at the attack's largest call
    (98,304 rows, C=128)."""
    calls = gdn_backward_calls(codec, batch)
    out = {"calls": [(c[0].shape[1], c[0].shape[0], c[4]) for c in calls], "variants": {},
           "plain_ms_98304x128": bwd_ms(gdn.gdn_backward_reference, 98304, 128, gen)}
    libs = build_variants(workdir, product2_variants(_build.SOURCES[0].read_text()))
    for name, lib in libs.items():
        with kernel_library(lib):
            gdn.reset_launch_counts()
            rec = backward_error(calls)
            if gdn.launch_counts["gdn_bwd"] != len(calls):
                raise RuntimeError(f"{name}: {gdn.launch_counts['gdn_bwd']} launches, "
                                   f"{len(calls)} calls")
            rec["ms_98304x128"] = bwd_ms(gdn.gdn_backward, 98304, 128, gen)
        out["variants"][name] = rec
        print(name, json.dumps(rec), flush=True)
    return out


def sass_functions(sass: str) -> dict:
    """cuobjdump's SASS by function: name -> [(address, opcode, operands)]
    (the opcode without its modifiers)."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = chunk.split("\n", 1)
        out[name.strip()] = [
            (int(a, 16), op.split(".")[0], args) for a, op, args in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    return out


def instruction_mix(ops) -> dict:
    """{"n", "FFMA", "LDS", "other"} of the opcodes ``ops``."""
    ops = list(ops)
    mix = {"n": len(ops), "FFMA": ops.count("FFMA"), "LDS": ops.count("LDS")}
    mix["other"] = mix["n"] - mix["FFMA"] - mix["LDS"]
    return mix


def loop_mixes(instrs) -> list:
    """The instruction mix of each loop of one function (from a branch's
    target to a branch back to it), in the order of their branches."""
    loops = []
    for addr, op, args in instrs:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            loops.append({"from": start, "to": addr, **instruction_mix(
                o for a, o, _ in instrs if start <= a <= addr)})
    return loops


def loops_probe(gen) -> dict:
    """The backward kernels' loops and whole functions from ``cuobjdump
    -sass`` of the committed build; dx-only times at 98,304 rows and the
    dispatch times of the busiest SM sub-partition at the SM clock read after
    them."""
    lib = _build.build()
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    functions = sass_functions(subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                              capture_output=True, text=True, check=True).stdout)
    out = {"kernels": {}}
    for nc in range(1, 7):
        (instrs,) = [i for n, i in functions.items() if f"gdn_bwd_kernelILi{nc}EE" in n]
        out["kernels"][nc] = {"function": instruction_mix(op for _, op, _ in instrs),
                              "loops": loop_mixes(instrs)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in (128, 192):
        ms = bwd_ms(gdn.gdn_backward, 98304, c, gen)
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        lay = gdn.kernel_layout(98304, c, False, backward=True)
        # tiles on the busiest group, and the product loops of one tile: both
        # products of a tile are C / 32 passes of their loop (a 32-channel
        # step each), a warp's FFMAs 2 x 16 x C x 4 x C / 32 / 32 lanes a tile
        slots = lay["grid"] * lay["warps"] // lay["group_warps"]
        tiles = -(-(98304 // lay["tile"]) // slots)
        # the innermost loops that hold FFMAs: the two products'
        loops = out["kernels"][c // 32]["loops"]
        products = [lp for lp in loops if lp["FFMA"] and not any(
            o is not lp and lp["from"] <= o["from"] and o["to"] <= lp["to"] for o in loops)]
        loop_instrs = sum(lp["n"] for lp in products) * c // 32
        ffma = 2 * lay["tile"] * c * c // 32 // lay["group_warps"]
        # a sub-partition (4 an SM) dispatches one warp instruction a clock
        per_smsp = lay["warps"] * lay["blocks_per_sm"] / 4
        out[f"dx_98304x{c}"] = {
            "ms": ms, "sm_clock_mhz": mhz, "layout": lay, "tiles_busiest_group": tiles,
            "ffma_dispatch_ms": tiles * ffma * per_smsp / (mhz * 1e3),
            "product_loops_dispatch_ms": tiles * loop_instrs * per_smsp / (mhz * 1e3),
        }
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--what", choices=("forward", "product2", "both", "loops"),
                        default="both",
                        help="product 1's k-step variants, product 2's, both, or what the "
                             "backward kernel's loop instructions")
    parser.add_argument("--out", help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gdn_accuracy: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    from ..io.image import to_tensor
    from ..train.data import synthetic_batches

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    codec = resumed_codec()
    batch = to_tensor(next(synthetic_batches(8, 256, seed=0)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi, "torch": torch.__version__, "step": str(STEP.relative_to(ROOT))}
    with tempfile.TemporaryDirectory() as tmp:
        if args.what in ("forward", "both"):
            result.update(forward_probe(codec, batch, gen, Path(tmp) / "forward"))
        if args.what in ("product2", "both"):
            result["product2"] = product2_probe(codec, batch, gen, Path(tmp) / "product2")
        if args.what == "loops":
            result["loops"] = loops_probe(gen)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's GDN/IGDN (``kernels/gdn.py``, ``models/layers.GDN``) vs JAX.

On the CPU the wrapper runs the kernel's plain version; it is compared with
the JAX package's GDN layer (the einsum the repository ships) and with the
Pallas kernel ``scripts/pallas_gdn.gdn_fused`` in interpret mode.  Tolerance
atol 1e-5: float32 on both sides, with the channel sum taken in another
order.  The kernel itself runs only on the card: ``test_torch_gdn_cuda.py``;
the 3xTF32 arithmetic of its v4, which the accuracy probe still builds, is
emulated here in float32.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.models.layers import GDN as JaxGDN
from imagecompression_adversarial_tpu_torch.kernels import _build, gdn, gdn_accuracy
from imagecompression_adversarial_tpu_torch.models.layers import GDN

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import pallas_gdn  # noqa: E402

ATOL = 1e-5


def _params(c, seed):
    rng = np.random.RandomState(seed)
    beta_r = rng.uniform(0.5, 1.5, c).astype(np.float32)
    gamma_r = rng.uniform(0.0, 0.1, (c, c)).astype(np.float32)
    gamma_r[0, 1] = -0.01  # below the reparam bound: exercises lower_bound
    return beta_r, gamma_r


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_layer_matches_jax_forward_and_dx(inverse):
    c = 16
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, c).astype(np.float32)  # NHWC
    w = rng.randn(2, 8, 8, c).astype(np.float32)
    beta_r, gamma_r = _params(c, 4)

    jmod = JaxGDN(inverse=inverse)
    jparams = {"params": {"beta": jnp.asarray(beta_r), "gamma": jnp.asarray(gamma_r)}}
    jout = np.asarray(jmod.apply(jparams, x))
    jdx = np.asarray(jax.grad(lambda v: jnp.sum(w * jmod.apply(jparams, v)))(jnp.asarray(x)))

    gdn.reset_launch_counts()
    layer = GDN(c, inverse=inverse)
    layer.load_state_dict({"beta": torch.tensor(beta_r), "gamma": torch.tensor(gamma_r)})
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    out = layer(xt)
    (out * torch.tensor(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), jout, atol=ATOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), jdx, atol=ATOL)
    assert gdn.launch_counts["gdn_fwd"] == 0  # the CPU path launches nothing


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_function_matches_pallas_interpret(inverse):
    c = 16
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    w = rng.randn(2, 8, 8, c).astype(np.float32)
    gamma = np.abs(rng.randn(c, c)).astype(np.float32) * 0.1
    beta = rng.uniform(0.5, 1.5, c).astype(np.float32)

    def jloss(v, g, b):
        return jnp.sum(w * pallas_gdn.gdn_fused(v, g, b, inverse, True))

    jout = np.asarray(pallas_gdn.gdn_fused(jnp.asarray(x), gamma, beta, inverse, True))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))

    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x.reshape(-1, c), gamma, beta))
    out = gdn.GDNFunction.apply(xt, gt, bt, inverse)
    (out * torch.tensor(w.reshape(-1, c))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy().reshape(x.shape), jout, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy().reshape(x.shape), np.asarray(jgrads[0]), atol=ATOL)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jgrads[1]), atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgrads[2]), atol=1e-4)


@pytest.mark.parametrize("variant", [gdn_accuracy.COMMITTED, *gdn_accuracy.TF32_PRODUCTS])
def test_accuracy_probe_variant_swaps_the_k_step(variant):
    """``kernels/gdn_accuracy.py`` builds the kernel with another k step: the
    committed source is its COMMITTED variant, and a TF32 variant differs
    from it only in the k step's body and the tensor-core helpers."""
    source = _build.SOURCES[0].read_text()
    text = gdn_accuracy.variants(source)[variant]
    body = gdn_accuracy.step_body(text)
    assert (text == source) == (variant == gdn_accuracy.COMMITTED)
    if variant != gdn_accuracy.COMMITTED:
        assert gdn_accuracy.TF32_PRODUCTS[variant] in body and "fmaf" not in body
        restored = text.replace(gdn_accuracy.TF32_HELPERS, "").replace(
            body, gdn_accuracy.step_body(source))
        assert restored == source


def _tf32(t):
    """``cvt.rna.tf32.f32`` on float32: round the magnitude to the nearest
    value with 10 mantissa bits, ties away from zero."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [128, 192])
def test_3xtf32_split_keeps_fp32_accuracy(c, inverse):
    """v4's product (the kernel's previous version, now the 3xTF32 variants
    of ``kernels/gdn_accuracy.py``), emulated: x^2 and gamma split into
    TF32 hi and lo parts, summed as lo*hi + hi*lo + hi*hi in float32.  It stays within
    the card tests' tolerance (rtol 1e-5, atol 1e-6) of a float64 reference
    on their input recipe; one TF32 product (hi*hi) does not."""
    gen = torch.Generator().manual_seed(0)
    x = 2.0 * torch.randn(4096, c, generator=gen)
    gamma = 0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=gen)
    beta = 0.5 + torch.rand(c, generator=gen)
    one = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-11)])
    assert _tf32(one).tolist() == [1.0 + 2.0**-10, 1.0, -(1.0 + 2 * 2.0**-10)]

    x_sq = x * x
    a_hi, g_hi = _tf32(x_sq), _tf32(gamma)
    a_lo, g_lo = _tf32(x_sq - a_hi), _tf32(gamma - g_hi)
    assert ((a_hi - x_sq).abs() <= 2.0**-11 * x_sq).all()
    norm3 = a_lo @ g_hi.t() + a_hi @ g_lo.t() + a_hi @ g_hi.t() + beta
    norm1 = a_hi @ g_hi.t() + beta

    x64 = x.double()
    norm64 = (x64 * x64) @ gamma.double().t() + beta.double()

    def out(v, norm):
        return v * (norm.sqrt() if inverse else norm.rsqrt())

    torch.testing.assert_close(norm3.double(), norm64, rtol=1e-5, atol=0)
    torch.testing.assert_close(out(x, norm3).double(), out(x64, norm64), rtol=1e-5, atol=1e-6)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(out(x, norm1).double(), out(x64, norm64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "case, exc",
    [
        ("meta_device", ValueError),
        ("float64", TypeError),
        ("too_wide", ValueError),
        ("rank3", ValueError),
        ("non_contiguous", ValueError),
        ("gamma_shape", ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    c = 8
    x, gamma, beta = torch.rand(32, c), torch.rand(c, c), torch.rand(c)
    if case == "meta_device":
        x, gamma, beta = (t.to("meta") for t in (x, gamma, beta))
    elif case == "float64":
        x = x.double()
    elif case == "too_wide":
        c = gdn.MAX_CHANNELS + 8
        x, gamma, beta = torch.rand(32, c), torch.rand(c, c), torch.rand(c)
    elif case == "rank3":
        x = x.reshape(4, 8, c)
    elif case == "non_contiguous":
        x = torch.rand(c, 32).t()
    elif case == "gamma_shape":
        gamma = torch.rand(c, c + 1)
    with pytest.raises(exc):
        gdn.gdn_forward(x, gamma, beta, False)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_nvcc_command_and_build_key(monkeypatch):
    out = _build.BUILD_DIR / "lib.so"
    cmd = _build.nvcc_command("nvcc", _build.SOURCES, out)
    assert cmd == [
        "nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
        str(_build.CSRC_DIR / "gdn.cu"),
    ]
    path = _build.library_path()
    assert path.parent == _build.PACKAGE_DIR / "_build"
    assert path == _build.library_path()  # stable for the same sources and flags
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path  # a flag change builds anew

"""The GDN/IGDN backward of the port (``kernels/gdn.py``) on the CPU.

On the CPU ``gdn_backward`` runs the backward kernel's plain version,
``gdn_backward_reference``.  It is compared with JAX's ``_gdn_fused_bwd``,
reached through ``jax.vjp`` of the Pallas ``scripts/pallas_gdn.gdn_fused``
in interpret mode, for GDN and IGDN, C 16 and 192 and each combination of
required gradients: atol 1e-5 for dx and 1e-4 for dgamma and dbeta (float32
on both sides, sums in another order; dgamma and dbeta sum over rows).
``GDNFunction``'s CPU backward is held bit for bit to the in-place chain it
ran before the backward kernel (``_previous_chain``).  The kernel itself
runs only on the card: ``test_torch_gdn_cuda.py``.
"""

import ctypes
import functools
import importlib.util
import itertools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu_torch.kernels import _build, gdn, gdn_accuracy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import pallas_gdn  # noqa: E402

ATOL_DX = 1e-5
ATOL_PARAMS = 1e-4
ROWS = 64
# needs_input_grad of (x, gamma, beta): every combination that asks for one
NEEDS = [n for n in itertools.product((True, False), repeat=3) if any(n)]


def _ids(needs):
    return "".join("xgb"[i] if n else "-" for i, n in enumerate(needs))


def _inputs(c, rows=ROWS, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, c).astype(np.float32)
    w = rng.randn(rows, c).astype(np.float32)  # the output's gradient
    gamma = np.abs(rng.randn(c, c)).astype(np.float32) * 0.1
    beta = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, gamma, beta, w


@functools.lru_cache(maxsize=None)
def _jax_grads(c, inverse):
    """JAX's (dx, dgamma, dbeta): ``_gdn_fused_bwd`` through the custom VJP
    of ``gdn_fused`` (interpret mode)."""
    x, gamma, beta, w = _inputs(c)
    _, vjp = jax.vjp(lambda v, gm, b: pallas_gdn.gdn_fused(v, gm, b, inverse, True),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return tuple(np.asarray(a) for a in vjp(jnp.asarray(w)))


def _grads(x, gamma, beta, w, inverse, needs, use_kernel=True):
    """GDNFunction's gradients of sum(w * out) for the inputs ``needs``
    marks, None for the others."""
    ts = [torch.tensor(a, requires_grad=n) for a, n in zip((x, gamma, beta), needs)]
    out = gdn.GDNFunction.apply(*ts, inverse, use_kernel)
    got = iter(torch.autograd.grad(out, [t for t in ts if t.requires_grad], torch.tensor(w)))
    return [next(got) if n else None for n in needs]


@pytest.mark.parametrize("needs", NEEDS, ids=_ids)
@pytest.mark.parametrize("c", [16, 192])
@pytest.mark.parametrize("inverse", [False, True])
def test_backward_matches_jax(inverse, c, needs):
    x, gamma, beta, w = _inputs(c)
    gdn.reset_launch_counts()
    grads = _grads(x, gamma, beta, w, inverse, needs)
    assert not gdn.launch_counts  # the CPU path launches nothing
    for got, want, atol in zip(grads, _jax_grads(c, inverse), (ATOL_DX, ATOL_PARAMS, ATOL_PARAMS)):
        if got is not None:
            np.testing.assert_allclose(got.numpy(), want, atol=atol)


def _previous_chain(x, gamma, beta, g, inverse, needs):
    """``GDNFunction.backward`` as it was before the backward kernel, with
    ``needs`` for ``ctx.needs_input_grad``; kept frozen here."""
    x_sq = x * x
    s = x_sq @ gamma.t()
    s += beta
    if not needs[1]:
        del x_sq
    s = s.sqrt_() if inverse else s.rsqrt_()
    dnorm = g * (0.5 if inverse else -0.5)
    dnorm *= x
    if inverse:
        dnorm /= s
    else:
        s3 = s * s
        s3 *= s
        dnorm *= s3
        del s3
    dx = None
    if needs[0]:
        m = dnorm @ gamma
        m *= x
        m *= 2.0
        dx = g * s
        dx += m
        del m
    del s
    dgamma = dnorm.t() @ x_sq if needs[1] else None
    dbeta = dnorm.sum(0) if needs[2] else None
    return dx, dgamma, dbeta


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("needs", NEEDS, ids=_ids)
@pytest.mark.parametrize("inverse", [False, True])
def test_cpu_backward_bit_equal_to_previous_chain(inverse, needs, use_kernel):
    """Both routes of the refactored backward (the wrapper's CPU path and
    the plain one) give the previous chain's bits."""
    x, gamma, beta, w = _inputs(24, rows=300, seed=7)
    grads = _grads(x, gamma, beta, w, inverse, needs, use_kernel)
    want = _previous_chain(*(torch.tensor(a) for a in (x, gamma, beta, w)), inverse, needs)
    for got, ref in zip(grads, want):
        assert (got is None) == (ref is None)
        if got is not None:
            assert torch.equal(got, ref)


@pytest.mark.parametrize("need_dx, need_dnorm", [(True, False), (False, True), (True, True)])
def test_gdn_backward_returns_what_is_asked(need_dx, need_dnorm):
    x, gamma, beta, w = (torch.tensor(a) for a in _inputs(16))
    gdn.reset_launch_counts()
    dx, dnorm = gdn.gdn_backward(x, gamma, beta, w, False, need_dx, need_dnorm)
    ref_dx, ref_dnorm = gdn.gdn_backward_reference(x, gamma, beta, w, False, True, True)
    assert not gdn.launch_counts
    assert (dx is None) != need_dx and (dnorm is None) != need_dnorm
    if need_dx:
        assert torch.equal(dx, ref_dx)
    if need_dnorm:
        assert torch.equal(dnorm, ref_dnorm)
        dgamma, dbeta = gdn.param_grads(x, dnorm, True, True)
        assert torch.equal(dgamma, dnorm.t() @ (x * x)) and torch.equal(dbeta, dnorm.sum(0))


def test_second_derivative_raises():
    """The backward is once differentiable: a double backward through GDN
    raises instead of differentiating the kernel's output as a constant."""
    x, gamma, beta, w = (torch.tensor(a) for a in _inputs(16))
    x.requires_grad_(True)
    out = gdn.GDNFunction.apply(x, gamma, beta, False)
    (dx,) = torch.autograd.grad(out, x, w, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dx.sum(), x)


@pytest.mark.parametrize(
    "case, exc",
    [
        ("meta_device", ValueError),
        ("float64_x", TypeError),
        ("float64_g", TypeError),
        ("too_wide", ValueError),
        ("rank3", ValueError),
        ("non_contiguous_x", ValueError),
        ("non_contiguous_g", ValueError),
        ("g_shape", ValueError),
        ("gamma_shape", ValueError),
        ("nothing_asked", ValueError),
    ],
)
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    c = 8
    x, gamma, beta, g = torch.rand(32, c), torch.rand(c, c), torch.rand(c), torch.rand(32, c)
    need_dx = True
    if case == "meta_device":
        x, gamma, beta, g = (t.to("meta") for t in (x, gamma, beta, g))
    elif case == "float64_x":
        x = x.double()
    elif case == "float64_g":
        g = g.double()
    elif case == "too_wide":
        c = gdn.MAX_CHANNELS + 8
        x, gamma, beta, g = torch.rand(32, c), torch.rand(c, c), torch.rand(c), torch.rand(32, c)
    elif case == "rank3":
        x, g = x.reshape(4, 8, c), g.reshape(4, 8, c)
    elif case == "non_contiguous_x":
        x = torch.rand(c, 32).t()
    elif case == "non_contiguous_g":
        g = torch.rand(c, 32).t()
    elif case == "g_shape":
        g = torch.rand(31, c)
    elif case == "gamma_shape":
        gamma = torch.rand(c, c + 1)
    elif case == "nothing_asked":
        need_dx = False
    with pytest.raises(exc):
        gdn.gdn_backward(x, gamma, beta, g, False, need_dx, False)


@pytest.mark.parametrize("variant", [gdn_accuracy.COMMITTED_PRODUCT2,
                                     *gdn_accuracy.PRODUCT2_PRODUCTS])
def test_accuracy_probe_variant_swaps_product2(variant):
    """``kernels/gdn_accuracy.py`` builds the backward with another step of
    product 2 (dnorm @ gamma): the committed source is its committed
    variant, and another differs from it only in that step's body."""
    source = _build.SOURCES[0].read_text()
    text = gdn_accuracy.product2_variants(source)[variant]
    body = gdn_accuracy.product2_body(text)
    assert (text == source) == (variant == gdn_accuracy.COMMITTED_PRODUCT2)
    assert gdn_accuracy.step_body(text) == gdn_accuracy.step_body(source)  # product 1 as it is
    if variant != gdn_accuracy.COMMITTED_PRODUCT2:
        assert gdn_accuracy.PRODUCT2_PRODUCTS[variant] in body
        assert text.replace(body, gdn_accuracy.product2_body(source)) == source


def test_backward_entry_points_take_pointers_as_void_p():
    """ctypes would pass a pointer declared as an int in 32 bits: every
    pointer of ``icat_gdn_bwd`` (x, gamma, beta, g, dx, dnorm, stream) is a
    ``c_void_p``."""
    names = ("icat_gdn_fwd", "icat_gdn_layout", "icat_gdn_bwd", "icat_gdn_bwd_layout")
    lib = _build.declare_gdn(types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names}))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    assert lib.icat_gdn_bwd.argtypes == [ptr] * 6 + [i32] * 3 + [ptr]
    assert lib.icat_gdn_bwd.restype is i32
    assert lib.icat_gdn_bwd_layout.argtypes == lib.icat_gdn_layout.argtypes


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_card_tests_hold_the_main_paths_shapes_exactly():
    """``tests/test_torch_gdn_cuda.py`` asserts the backward kernel equal to
    the plain backward at its EXACT_SHAPES: ``chip_smoke.py``'s GDN_SHAPES
    (the main paths' GDN calls) under 1,000,000 rows, in its order."""
    root = os.path.join(os.path.dirname(__file__), "..")
    smoke = _module(os.path.join(root, "chip_smoke.py"), "_chip_smoke_shapes")
    cuda_tests = _module(os.path.join(root, "tests", "test_torch_gdn_cuda.py"),
                         "_gdn_cuda_shapes")
    assert cuda_tests.EXACT_SHAPES == tuple(
        (c, rows) for c, rows in smoke.GDN_SHAPES if rows < 1_000_000)


SASS = """
\t\tFunction : _ZN4main14gdn_bwd_kernelILi4EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;          /* 0x00000a0000017a02 */
        /*0010*/                   LDS.128 R4, [R2] ;               /* 0x0000000002047984 */
        /*0020*/                   FFMA R8, R4, R5, R8 ;            /* 0x0000000504087223 */
        /*0030*/                   FFMA R9, R4, R6, R9 ;            /* 0x0000000604097223 */
        /*0040*/               @P0 BRA 0x10 ;                       /* 0x0000000000000947 */
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING R3, 0x80 ;  /* 0x000200030000751d */
        /*0060*/              @!P1 BRA 0x0 ;                        /* 0x0000000000000947 */
        /*0070*/                   EXIT ;                           /* 0x000000000000794d */
"""


def test_loops_probe_reads_the_kernels_loops():
    """``gdn_accuracy --what loops`` counts each loop's instructions (a
    branch back to a lower address) by opcode in cuobjdump's SASS, inner and
    outer loops alike; predicated branches and opcode modifiers included."""
    (name, instrs), = gdn_accuracy.sass_functions(SASS).items()
    assert "gdn_bwd_kernelILi4EE" in name and len(instrs) == 8
    assert gdn_accuracy.instruction_mix(op for _, op, _ in instrs) == {
        "n": 8, "FFMA": 2, "LDS": 1, "other": 5}
    inner, outer = gdn_accuracy.loop_mixes(instrs)
    assert inner == {"from": 0x10, "to": 0x40, "n": 4, "FFMA": 2, "LDS": 1, "other": 1}
    assert (outer["from"], outer["to"], outer["n"], outer["FFMA"]) == (0, 0x60, 7, 2)

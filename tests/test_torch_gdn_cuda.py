"""The GDN/IGDN CUDA kernels (forward and backward) vs their plain PyTorch
versions, on the card.

Run where there is an NVIDIA GPU and nvcc (no JAX needed):
``python -m pytest tests/test_torch_gdn_cuda.py -m cuda -q``.  Elsewhere
every test skips.  Tolerance rtol 1e-5, atol 1e-6: the plain version is an
fp32 product (TF32 off); the kernels' are fp32 FMA chains in the same
order, and rsqrtf/sqrtf are within 2 ulp.  The backward's dx and dnorm
are the plain backward's bit for bit (``torch.equal``) at the (C, rows) of
``chip_smoke.py``'s GDN_SHAPES under 1,000,000 rows, where cuBLAS takes the
order the kernel takes; at other shapes cuBLAS may take another, and the
bound is the forward's.
"""

import pytest
import torch

from imagecompression_adversarial_tpu_torch.kernels import gdn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


# (C, rows) of chip_smoke.py's GDN_SHAPES under 1,000,000 rows (the main
# paths' GDN calls; test_torch_gdn_backward.py holds the two lists equal)
EXACT_SHAPES = (
    (128, 98304), (128, 24576), (128, 6144), (192, 6144), (128, 393216), (128, 131072),
    (128, 32768), (128, 8192), (192, 98304), (192, 24576), (128, 196608), (128, 49152),
    (128, 12288), (128, 3072), (128, 65536), (128, 16384), (128, 4096), (128, 2048),
    (128, 786432), (192, 49152), (192, 12288), (192, 3072), (128, 71680), (128, 17920),
    (128, 4480), (128, 66560), (128, 16640), (128, 4160), (128, 53248), (128, 13312),
    (128, 3328), (128, 73728), (128, 18432), (128, 4608), (128, 1152),
)


def _inputs(c, rows, device):
    gen = torch.Generator(device=device).manual_seed(0)
    x = 2.0 * torch.randn(rows, c, device=device, generator=gen)
    gamma = 0.1 * torch.eye(c, device=device) + 0.01 * torch.rand(c, c, device=device, generator=gen)
    beta = 0.5 + torch.rand(c, device=device, generator=gen)
    return x, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
# widest first, then narrower, then widest again: the launch setup is cached
# per width and must not shrink the shared-memory limit of another
# (row counts that are not a multiple of any tile height: 33, 100, 70, 50,
# 4099, 1000 and 24,613 rows)
@pytest.mark.parametrize("c, rows", [
    (192, 6144), (128, 6144), (128, 33), (3, 100), (130, 70), (191, 50), (16, 4099),
    (144, 1000), (128, 24613), (192, 64),
])
def test_kernel_matches_plain(cuda, c, rows, inverse):
    x, gamma, beta = _inputs(c, rows, cuda)
    before = gdn.launch_counts["gdn_fwd"]
    out = gdn.gdn_forward(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert gdn.launch_counts["gdn_fwd"] == before + 1
    ref = gdn.gdn_forward_reference(x, gamma, beta, inverse)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernel_rejects_too_wide(cuda):
    x, gamma, beta = _inputs(gdn.MAX_CHANNELS + 1, 8, cuda)
    with pytest.raises(ValueError):
        gdn.gdn_forward(x, gamma, beta, False)


@pytest.mark.cuda
def test_kernel_handles_empty_input(cuda):
    x, gamma, beta = _inputs(128, 0, cuda)
    assert gdn.gdn_forward(x, gamma, beta, True).shape == (0, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [128, 192])
def test_kernel_takes_unaligned_rows(cuda, c, inverse):
    # a contiguous x whose storage starts one float in: data_ptr is not
    # 16-byte aligned, so the kernel must not take its float4 path
    rows = 1000
    base, gamma, beta = _inputs(c, rows + 1, cuda)
    x = base.reshape(-1)[1:rows * c + 1].view(rows, c)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out = gdn.gdn_forward(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    ref = gdn.gdn_forward_reference(x, gamma, beta, inverse)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("c, rows", [(128, 98304), (128, 6144), (192, 6144), (3, 100), (128, 0),
                                     (192, 98304), (160, 1000), (128, 8)])
def test_kernel_layout_covers_the_rows(cuda, c, rows, backward):
    lay = gdn.kernel_layout(rows, c, False, backward)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-rows // lay["tile"])
    assert lay["tile"] in ((16,) if backward else (16, 32, 64)) and lay["blocks_per_sm"] >= 1
    assert lay["grid"] == min(tiles, sms * lay["blocks_per_sm"])
    assert 0 < lay["smem_bytes"] * lay["blocks_per_sm"] <= (
        torch.cuda.get_device_properties(0).shared_memory_per_multiprocessor)
    if backward:
        # groups of ceil(C / 32) warps, each a ring of 2 stages of 16-row
        # tiles; a lane 4 rows by 4 channels
        assert lay["group_warps"] == -(-c // 32) and lay["warps"] % lay["group_warps"] == 0
        assert lay["warps"] // lay["group_warps"] >= 2 and lay["stages"] == 2
        assert lay["lane_rows"] == 4 and lay["lane_channels"] == 4
        assert lay["tile"] == 4 * lay["lane_rows"]
        if rows >= 98304:
            # more warps an SM than the previous backward's one 8-warp block
            # at C=192; 16 at C=128
            assert lay["warps"] * lay["blocks_per_sm"] >= (16 if c == 128 else 12)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dx", "dnorm", "both"])
@pytest.mark.parametrize("inverse", [False, True])
# widest first, as above; rows not a multiple of any tile height, 0 rows,
# C 1 and 3 (padded to 16), and an x whose data_ptr is one float past a
# 16-byte boundary (offset 1: the kernel must take 4-byte copies)
@pytest.mark.parametrize("c, rows, offset", [
    (192, 6144, 0), (128, 6144, 0), (128, 33, 0), (1, 100, 0), (3, 100, 0), (130, 70, 0),
    (191, 50, 0), (16, 4099, 0), (144, 1000, 0), (128, 24613, 0), (192, 64, 0), (128, 0, 0),
    (128, 1000, 1), (192, 1000, 1),
    *((c, rows, 0) for c, rows in EXACT_SHAPES if (c, rows) not in ((128, 6144), (192, 6144))),
])
def test_backward_kernel_matches_plain(cuda, c, rows, offset, inverse, mode):
    base, gamma, beta = _inputs(c, rows + 1, cuda)
    x = base.reshape(-1)[offset:rows * c + offset].view(rows, c)
    g = torch.randn(rows + 1, c, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    g = g.reshape(-1)[offset:rows * c + offset].view(rows, c)
    need_dx, need_dnorm = mode in ("dx", "both"), mode in ("dnorm", "both")
    before = gdn.launch_counts["gdn_bwd"]
    dx, dnorm = gdn.gdn_backward(x, gamma, beta, g, inverse, need_dx, need_dnorm)
    torch.cuda.synchronize()
    assert gdn.launch_counts["gdn_bwd"] == before + (rows > 0)
    ref_dx, ref_dnorm = gdn.gdn_backward_reference(x, gamma, beta, g, inverse, True, True)
    assert (dx is None) != need_dx and (dnorm is None) != need_dnorm
    for got, ref in ((dx, ref_dx), (dnorm, ref_dnorm)):
        if got is None:
            continue
        if (c, rows) in EXACT_SHAPES:
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [32, 64, 96, 128, 160, 192])
def test_backward_kernel_covers_every_group_width(cuda, c, inverse):
    """Each backward kernel (C padded to 32 .. 192: 1 to 6 warps a group)
    at three rounds of 16-row tiles over every group of the grid and 5 rows
    more, so that the groups go round their two stages unevenly and the
    last tile is partial; dx, dnorm and both against the plain backward."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lay = gdn.kernel_layout(16 * sms, c, inverse, backward=True)
    rows = 3 * lay["tile"] * sms * lay["blocks_per_sm"] * lay["warps"] // lay["group_warps"] + 5
    lay = gdn.kernel_layout(rows, c, inverse, backward=True)
    assert lay["group_warps"] == c // 32 and lay["grid"] == sms * lay["blocks_per_sm"]
    x, gamma, beta = _inputs(c, rows, cuda)
    g = torch.randn(rows, c, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    ref_dx, ref_dnorm = gdn.gdn_backward_reference(x, gamma, beta, g, inverse, True, True)
    for need_dx, need_dnorm in ((True, False), (False, True), (True, True)):
        dx, dnorm = gdn.gdn_backward(x, gamma, beta, g, inverse, need_dx, need_dnorm)
        torch.cuda.synchronize()
        for got, ref in ((dx, ref_dx), (dnorm, ref_dnorm)):
            if got is not None:
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False])
def test_function_backward_launches_the_kernel_once(cuda, use_kernel):
    """GDNFunction's backward on the card: one backward launch (and one
    forward launch) with the kernel, none with use_kernel=False; dgamma and
    dbeta from the kernel's dnorm match the plain backward's."""
    x, gamma, beta = _inputs(128, 2048, cuda)
    g = torch.randn_like(x)
    grads = []
    for kernel in (use_kernel, False):
        ts = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
        gdn.reset_launch_counts()
        out = gdn.GDNFunction.apply(*ts, False, kernel)
        grads.append(torch.autograd.grad(out, ts, g))
        torch.cuda.synchronize()
        n = 1 if kernel else 0
        assert gdn.launch_counts["gdn_fwd"] == n and gdn.launch_counts["gdn_bwd"] == n
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)

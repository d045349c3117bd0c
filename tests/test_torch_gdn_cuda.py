"""The GDN/IGDN CUDA kernel vs its plain PyTorch version, on the card.

Run where there is an NVIDIA GPU and nvcc (no JAX needed):
``python -m pytest tests/test_torch_gdn_cuda.py -m cuda -q``.  Elsewhere
every test skips.  Tolerance rtol 1e-5, atol 1e-6: both are fp32 (TF32 off),
the channel sum runs in another order, and rsqrtf/sqrtf are within 2 ulp.
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
@pytest.mark.parametrize("c, rows", [(192, 6144), (128, 6144), (128, 33), (3, 100), (130, 70), (191, 50), (192, 64)])
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

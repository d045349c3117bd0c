"""The port's Conv / Deconv / phase form / depth_to_space vs JAX
(``models/layers.py`` of both packages), on the CPU.

Weights are made with numpy in the JAX layout (HWIO) and handed to the port
in PyTorch's (OIHW; IOHW for the transposed conv).  Tolerance atol 1e-5:
float32 convolutions whose sums run in another order.
"""

import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.models.layers import Conv as JConv
from imagecompression_adversarial_tpu.models.layers import Deconv as JDeconv
from imagecompression_adversarial_tpu.models.layers import depth_to_space as jd2s
from imagecompression_adversarial_tpu.models.layers import space_to_depth as js2d
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.models.layers import (
    Conv,
    Deconv,
    depth_to_space,
    space_to_depth,
)

ATOL = 1e-5


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _weights(k, cin, cout, seed):
    rng = np.random.RandomState(seed)
    kernel = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return kernel, bias


@pytest.mark.parametrize("k, s", [(5, 2), (3, 1)])
def test_conv_matches_jax(k, s):
    x = np.random.RandomState(0).rand(1, 16, 12, 6).astype(np.float32)
    kernel, bias = _weights(k, 6, 8, 1)
    ref = JConv(8, kernel_size=k, stride=s).apply({"params": {"kernel": kernel, "bias": bias}}, x)
    conv = Conv(6, 8, k, s)
    conv.load_state_dict({"weight": torch.tensor(kernel.transpose(3, 2, 0, 1)), "bias": torch.tensor(bias)})
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("phase_output", [False, True])
def test_deconv_and_phase_form_match_jax(phase_output):
    x = np.random.RandomState(2).rand(1, 6, 5, 6).astype(np.float32)
    kernel, bias = _weights(5, 6, 3, 3)
    ref = np.asarray(
        JDeconv(3).apply({"params": {"kernel": kernel, "bias": bias}}, x, phase_output=phase_output)
    )
    deconv = Deconv(6, 3)
    deconv.load_state_dict({"weight": torch.tensor(kernel.transpose(2, 3, 0, 1)), "bias": torch.tensor(bias)})
    out = deconv(_nchw(x), phase_output=phase_output)
    # the JAX phase form is already NCHW (n, 4*out, h, w)
    got = out.detach().numpy() if phase_output else _nhwc(out)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_depth_to_space_and_inverse_match_jax():
    y = np.random.RandomState(4).rand(2, 3, 5, 12).astype(np.float32)  # NHWC, 4*3 channels
    got = depth_to_space(torch.tensor(y).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jd2s(y)))
    back = space_to_depth(got)
    np.testing.assert_array_equal(_nhwc(back), y)
    np.testing.assert_array_equal(_nhwc(back), np.asarray(js2d(np.asarray(jd2s(y)))))


def test_g_s_phase_is_g_s_up_to_depth_to_space():
    model = init_model("hyper", 1, seed=0).requires_grad_(False)
    y = torch.randn(1, model.M, 3, 4, generator=torch.Generator().manual_seed(1))
    y = y.contiguous(memory_format=torch.channels_last)
    full = model.g_s(y)
    phase = model.g_s_phase(y)
    assert phase.shape == (1, 12, full.shape[2] // 2, full.shape[3] // 2)
    np.testing.assert_allclose(depth_to_space(phase).numpy(), full.numpy(), atol=ATOL)

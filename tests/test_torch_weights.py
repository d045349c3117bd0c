"""The port's weights bridge (``io/weights.py``) vs flax, and the hyper
codec's forward on the committed demo weights vs JAX ``module.apply``.

The forward comparison runs at 64x64 in ``dequantize`` mode: x_hat, both
likelihoods and bpp agree to atol 1e-4 (float32 convolutions through the
whole codec, plus rounding of latents that may sit within float32 error of
a half-integer).
"""

import os

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.io.weights import (
    load_checkpoint,
    params_from_jax,
    read_msgpack,
)
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.runtime import load_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "ckpts", "demo", "hyper-q1-mse-synthetic.msgpack")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_msgpack_reader_matches_flax_on_demo_checkpoint():
    ours = dict(_leaves(read_msgpack(CKPT)))
    with open(CKPT, "rb") as f:
        ref = dict(_leaves(flax.serialization.msgpack_restore(f.read())))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert v.dtype == np.float16  # the demo files are stored float16
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], v.astype(np.float32))


def test_msgpack_reader_decodes_every_container(tmp_path):
    tree = {
        "a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "i": np.array([-3, 7], np.int64)},
        "half": np.linspace(-1, 1, 5).astype(np.float16),
        "scalar": np.float32(2.5),
        "long_name_" * 40: np.zeros((0,), np.float32),
    }
    path = tmp_path / "t.msgpack"
    path.write_bytes(flax.serialization.to_bytes(tree))
    got = read_msgpack(str(path))
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(got["a"]["i"], tree["a"]["i"])
    np.testing.assert_array_equal(got["half"], tree["half"].astype(np.float32))
    assert got["scalar"] == 2.5 and got["long_name_" * 40].shape == (0,)
    # plain msgpack values of every width
    plain = {"ints": [0, 127, -1, -32, -33, 255, 65535, 2 ** 32, -(2 ** 40)],
             "f": [1.5, None, True, False], "s": "x" * 300, "b": b"\x00" * 70000,
             "big": {str(i): i for i in range(20)}}
    path.write_bytes(msgpack.packb(plain, use_bin_type=True))
    assert read_msgpack(str(path)) == plain


def test_params_from_jax_fills_the_port_state_dict():
    state = params_from_jax(read_msgpack(CKPT))
    model_state = init_model("hyper", 1).state_dict()
    assert state.keys() == model_state.keys()
    for k, v in model_state.items():
        assert state[k].shape == v.shape, k


def test_torch_checkpoint_loads_through_compressai_names(tmp_path):
    state = params_from_jax(read_msgpack(CKPT))
    ckpt = {"state_dict": {"net." + k: v for k, v in state.items()}}
    ckpt["state_dict"]["net.g_a.1.gamma"] = state["g_a.1.gamma"].reshape(128, 128, 1, 1)
    ckpt["state_dict"]["net.entropy_bottleneck._quantized_cdf"] = torch.zeros(3)
    ckpt["state_dict"]["net.gaussian_conditional.scale_table"] = torch.zeros(3)
    path = tmp_path / "model.pth.tar"
    torch.save(ckpt, path)
    loaded = load_checkpoint(str(path))
    assert loaded.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(loaded[k], state[k], rtol=0, atol=0)


def test_dequantize_forward_matches_jax_on_demo_weights():
    jm = j_init_model("hyper", 1)
    with open(CKPT, "rb") as f:
        jp = flax.serialization.msgpack_restore(f.read())
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    jr = jm.apply({"params": jp}, x, quant_mode="dequantize")

    model = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        tr = model(xt, quant_mode="dequantize")
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(tr["x_hat"]), np.asarray(jr["x_hat"]), atol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(nhwc(tr["likelihoods"][k]), np.asarray(jr["likelihoods"][k]), atol=1e-4)
    np.testing.assert_allclose(
        float(bpp_from_likelihoods(tr["likelihoods"], 64 * 64)),
        float(j_bpp(jr["likelihoods"], 64 * 64)), atol=1e-4,
    )


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(Config(model="hyper", quality=1))

"""Shared fixtures of the port-vs-JAX tests of the attack and defense
engines and of training: the hyper q1 demo weights on both sides, NHWC <->
NCHW, the CPU convolution backends (oneDNN off and on) the comparisons run
under, and the same training-forward noise on both sides."""

from __future__ import annotations

import functools
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.ops import quant as port_quant
from imagecompression_adversarial_tpu_torch.runtime import load_model

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "ckpts" / "demo" / "hyper-q1-mse-synthetic.msgpack")
CKPT_GMM = str(REPO / "ckpts" / "demo" / "cheng2020-gmm-q3-mse-synthetic.msgpack")

# im_ atol vs JAX by whether torch's CPU convolutions use oneDNN (the bounds
# of tests/test_torch_attack_rd.py: Adam turns gradient error on pixels
# whose gradient is near its eps into noise error, and oneDNN's float32 conv
# gradients sit ~3x further from a float64 reference than JAX's)
IM_ATOL = {False: 1e-5, True: 1e-4}
VI_ATOL = 1e-3
BPP_RTOL = 1e-4


def nchw(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def _demo_models(arch: str, quality: int, ckpt: str):
    with open(ckpt, "rb") as f:
        jp = flax.serialization.msgpack_restore(f.read())
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    model = load_model(Config(device="cpu", model=arch, quality=quality, checkpoint=ckpt))
    return j_init_model(arch, quality), jp, model


@functools.lru_cache(maxsize=None)
def hyper_models():
    """(JAX module, numpy params, port model) of hyper q1 on the demo weights."""
    return _demo_models("hyper", 1, CKPT)


@functools.lru_cache(maxsize=None)
def cheng_models():
    """(JAX module, numpy params, port model) of cheng2020-gmm q3 on the
    demo weights."""
    return _demo_models("cheng2020-gmm", 3, CKPT_GMM)


def jax_apply(jm, jp):
    return lambda im, quant_mode: jm.apply({"params": jp}, im, quant_mode=quant_mode)


def image(seed: int, h: int = 64, w: int = 64) -> np.ndarray:
    return np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32)


def onednn(enabled: bool):
    return torch.backends.mkldnn.flags(enabled=enabled)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one intra-op thread: float32 convolutions on
    the CPU split their sums by the thread count, so the results (and their
    distance from JAX) would depend on the host's cores; and parallel test
    workers, each with a thread a core, would oversubscribe the CPU, where
    small ops slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise_tables(seed=0):
    """Uniform(-0.5, 0.5) noise for the y and z of hyper q1-5 at 64x64,
    batch 2 and then batch 1, NHWC for JAX and NCHW for the port."""
    rng = np.random.RandomState(seed)
    shapes = [(2, 4, 4, 192), (2, 1, 1, 128), (1, 4, 4, 192), (1, 1, 1, 128)]
    nhwc_tab = {s: rng.uniform(-0.5, 0.5, s).astype(np.float32) for s in shapes}
    nchw_tab = {(s[0], s[3], s[1], s[2]): torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                for s, a in nhwc_tab.items()}
    return nhwc_tab, nchw_tab


@pytest.fixture
def same_noise(monkeypatch):
    """The same numpy noise in both sides' training forward: replaces the
    draw of JAX's ``quantize(mode='noise')`` (``jax.random.uniform``, for
    the y and z shapes only) and the port's ``ops.quant.uniform_noise``
    for the test.  Every step and every call then gets the same noise."""
    j_tab, t_tab = _noise_tables()
    orig = jax.random.uniform

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if tuple(shape) in j_tab:
            return jnp.asarray(j_tab[tuple(shape)], dtype)
        return orig(key, shape, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(port_quant, "uniform_noise",
                        lambda y, generator: t_tab[tuple(y.shape)].to(y))
    return j_tab, t_tab


def jax_params_from_port(model, jm, arch: str, input_shape=(1, 64, 64, 3)):
    """The port model's parameters as the JAX module's flax tree (numpy):
    the tree's paths and shapes from ``jax.eval_shape`` of its init, each
    leaf the port tensor ``params_from_jax`` maps it to, put back in the
    flax layout.  The inverse of ``params_from_jax`` for families without
    a converter of their own."""
    from imagecompression_adversarial_tpu.models import init_params as j_init_params
    from imagecompression_adversarial_tpu_torch.io import weights

    shapes = jax.eval_shape(lambda k: j_init_params(jm, k, input_shape), jax.random.PRNGKey(0))
    state = model.state_dict()
    deconv = weights._DECONV_PATHS.get(arch, weights._FLAX_ONLY.get(arch))

    def leaf(path, sd):
        names = [k.key for k in path]
        tree = np.zeros(sd.shape, np.float32)
        for name in reversed(names):
            tree = {name: tree}
        (key,) = weights.params_from_jax(tree, arch)
        value = state[key].detach().cpu().numpy()
        if len(sd.shape) == 2 and names[-1] == "kernel":  # Dense: (in, out)
            value = value.T
        elif len(sd.shape) == 4:
            perm = (2, 3, 0, 1) if "/".join(names[:-1]) in deconv else (2, 3, 1, 0)
            value = value.transpose(perm)
        return np.ascontiguousarray(value, np.float32).reshape(sd.shape)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def perturb_(model, scale: float, seed: int = 0):
    """Add ``scale`` x standard normal noise to every parameter (in place),
    so zero-initialized weights (couplings, position biases) are exercised."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return model


@pytest.fixture
def shape_noise(monkeypatch):
    """The same numpy uniform(-0.5, 0.5) noise in both sides' ``noise``
    quantization, for every latent shape: one draw per NHWC shape from a
    seed, handed to ``jax.random.uniform`` (NHWC) and to the port's
    ``uniform_noise`` (NCHW, transposed)."""
    tables = {}

    def table(nhwc_shape):
        if nhwc_shape not in tables:
            rng = np.random.RandomState(len(tables))
            tables[nhwc_shape] = rng.uniform(-0.5, 0.5, nhwc_shape).astype(np.float32)
        return tables[nhwc_shape]

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(table(tuple(shape)), dtype)

    def t_uniform(y, generator):
        b, c, h, w = y.shape
        return torch.from_numpy(table((b, h, w, c)).transpose(0, 3, 1, 2).copy()).to(y)

    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(port_quant, "uniform_noise", t_uniform)
    return tables

"""The port's RD attack (``attacks/``), metrics, CLI and import boundary vs
JAX, on the CPU.

The attack comparison runs 6 Adam steps at 64x64 on the committed hyper q1
demo weights.  Tolerances: ``im_`` atol 1e-5, ``vi`` abs 1e-3.  Adam
divides each gradient by its RMS plus eps = 1e-8, so a pixel whose gradient
is near 1e-8 moves by up to lr (1e-2) on a gradient error of that size; the
1e-5 comparison therefore runs the CPU convolutions without oneDNN, whose
float32 gradients here sit 3x further from a float64 reference than JAX's
(1.1e-10 vs 3.5e-11 at the first step).  The CPU entry point's default
backend, oneDNN on, is compared too, at ``im_`` atol 1e-4: on x86 hosts its
worst pixel differed from JAX by 1.47e-5 to 3.3e-5, and oneDNN picks its
kernels by the CPU's instruction set, so the bound keeps a 3x margin.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.attacks import multistep_lr_schedule as j_schedule
from imagecompression_adversarial_tpu.metrics import ms_ssim as j_ms_ssim
from imagecompression_adversarial_tpu.metrics import vi as j_vi
from imagecompression_adversarial_tpu.metrics import vi_msim as j_vi_msim
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.attacks import (
    AdamOnNoise,
    RDAttackConfig,
    make_attack_fn,
    multistep_lr_schedule,
)
from imagecompression_adversarial_tpu_torch.cli import attack_rd
from imagecompression_adversarial_tpu_torch.config import Config, parse_config
from imagecompression_adversarial_tpu_torch.metrics import ms_ssim, vi, vi_msim
from imagecompression_adversarial_tpu_torch.runtime import load_model

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "ckpts" / "demo" / "hyper-q1-mse-synthetic.msgpack")
PORT = REPO / "imagecompression_adversarial_tpu_torch"


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def jax_model():
    jm = j_init_model("hyper", 1)
    with open(CKPT, "rb") as f:
        jp = flax.serialization.msgpack_restore(f.read())
    return jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


_JAX_ATTACKS = {}
# im_ atol vs JAX, by whether torch's CPU convolutions use oneDNN (docstring)
_IM_ATOL = {False: 1e-5, True: 1e-4}


def _jax_attack(jax_model, x, kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_ATTACKS:
        jm, jp = jax_model
        _JAX_ATTACKS[key] = j_make_attack_fn(jm, JConfig(**kw))(jp, x)
    return _JAX_ATTACKS[key]


_ATTACK_CASES = [
    ("select", "L2", None),  # the main path: phase-space loss, no sync
    ("cond", "L2", None),
    ("cond", "ms-ssim", None),  # full-resolution loss, MS-SSIM both phases
    ("select", "L2", 32),  # -p: reflect-padded clean forward, full-res loss
]


def _check_attack(jax_model, impl, metric, pad, onednn):
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    kw = dict(steps=6, two_phase_impl=impl, att_metric=metric, pad=pad)
    jres = _jax_attack(jax_model, x, kw)
    model = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
    with torch.backends.mkldnn.flags(enabled=onednn):
        res = make_attack_fn(model, RDAttackConfig(**kw))(_nchw(x))
    im_ = res["im_"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(im_, np.asarray(jres["im_"]), atol=_IM_ATOL[onednn], rtol=0)
    assert abs(res["vi"].item() - float(jres["vi"])) <= 1e-3
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-4)
    assert np.abs(im_ - x).max() <= 16.0 / 255.0 + 1e-6


@pytest.mark.parametrize("impl, metric, pad", _ATTACK_CASES)
def test_attack_matches_jax(jax_model, impl, metric, pad):
    _check_attack(jax_model, impl, metric, pad, onednn=False)


@pytest.mark.parametrize("impl, metric, pad", _ATTACK_CASES)
def test_attack_matches_jax_onednn(jax_model, impl, metric, pad):
    """The CPU entry point's default convolution backend."""
    _check_attack(jax_model, impl, metric, pad, onednn=True)


def test_lr_schedule_matches_jax_and_torch():
    steps, base = 50, 0.01
    np.testing.assert_array_equal(multistep_lr_schedule(steps, base), j_schedule(steps, base))
    param = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([param], lr=base)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [1, 2, 3], gamma=0.33)
    lrs = []
    for i in range(steps):
        lrs.append(opt.param_groups[0]["lr"])
        if i % (steps // 3) == 0:
            sched.step()
    np.testing.assert_allclose(multistep_lr_schedule(steps, base), np.float32(lrs), rtol=1e-6)


def test_adam_on_noise_matches_optax():
    rng = np.random.RandomState(2)
    grads = rng.randn(5, 16).astype(np.float32) * np.float32(1e-3)
    lrs = multistep_lr_schedule(5, 0.01)
    opt = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)
    jn = jnp.zeros(16)
    state = opt.init(jn)
    noise = torch.zeros(16)
    adam = AdamOnNoise(noise)
    for g, lr in zip(grads, lrs):
        upd, state = opt.update(jnp.asarray(g), state)
        jn = jn - lr * upd
        adam.step(noise, torch.tensor(g), float(lr))
    np.testing.assert_allclose(noise.numpy(), np.asarray(jn), atol=1e-7, rtol=1e-6)


def test_eval_metrics_match_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(2, 96, 80, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        ms_ssim(_nchw(a), _nchw(b)).item(), float(j_ms_ssim(a, b)), atol=1e-5
    )
    m_in, m_out = np.float32(1e-4), np.float32(3e-3)
    np.testing.assert_allclose(vi(torch.tensor(m_in), torch.tensor(m_out)).item(),
                               float(j_vi(m_in, m_out)), rtol=1e-6)
    np.testing.assert_allclose(vi_msim(torch.tensor(0.99), torch.tensor(0.9)).item(),
                               float(j_vi_msim(0.99, 0.9)), rtol=1e-5)


def test_cli_run_prints_report_lines(tmp_path, capsys):
    from PIL import Image

    img = (np.random.RandomState(4).rand(50, 70, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "kodim01.png")
    cfg = parse_config(["-m", "hyper", "-q", "1", "-device", "cpu", "--new", "-steps", "2",
                        "-two_phase", "select", "-s", str(tmp_path / "*.png")])
    avg = attack_rd.run(cfg)
    out = capsys.readouterr().out
    assert "kodim01.png: bpp_ori " in out and "\nAVG: bpp_ori " in out
    assert all(np.isfinite(avg[k]) for k in ("bpp_ori", "bpp", "vi", "vi_msim"))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


# the port needs none of these; PNGs go through its own codec (io/image.py),
# orbax trees through its own reader (train/orbax.py) and libzstd
_FORBIDDEN = ("jax", "flax", "optax", "msgpack", "orbax", "PIL", "tensorstore", "zstandard",
              "imagecompression_adversarial_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in _FORBIDDEN, f"{path.relative_to(REPO)} imports {name}"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

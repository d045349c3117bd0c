"""The ranks' side of ``tests/test_torch_parallel*.py``: each function runs
in every rank of a ``run_spmd`` world on the CPU (gloo), imports only
torch, numpy and the port, and returns numpy arrays.

``run_world(inputs_path, scenarios)`` runs the named scenarios in order in
one world (one spawn a world size) and returns ``{scenario: result}`` from
each rank.  The inputs (the JAX parameter trees as numpy, the images, the
training noise tables) come from the test process in one pickle, so that
both sides see the same arrays; the noise tables replace
``ops.quant.uniform_noise`` in the ranks as ``torch_parity.same_noise``
does in the test process, keyed by the global shape the ranks draw for.
``StreamedWorlds`` runs worlds of several sizes beside a test module and
hands it each scenario's results as the ranks finish it.
"""

from __future__ import annotations

import concurrent.futures
import copy
import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
from imagecompression_adversarial_tpu_torch.attacks.rd import make_adv_example_fn
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.models.layers import GDN
from imagecompression_adversarial_tpu_torch.models.nlaic import NonLocalBlock
from imagecompression_adversarial_tpu_torch.models.registry import init_model
from imagecompression_adversarial_tpu_torch.ops import quant, shard
from imagecompression_adversarial_tpu_torch.parallel import (
    batch_row_sharding,
    batch_sharding,
    local_part,
    make_mesh,
    make_sharded_attack_fn,
    make_spatial_attack_fn,
    make_spatial_forward,
    mesh_shape,
    replicate,
    row_sharding,
    shard_batch,
    spatial_shard,
    tiled_forward,
)
from imagecompression_adversarial_tpu_torch.runtime import load_model
from imagecompression_adversarial_tpu_torch.train import (
    create_train_state,
    lambda_for,
    rate_distortion_loss,
    train_step,
)
from imagecompression_adversarial_tpu_torch.train.step import mesh_shard, reduce_gradients_

LR = 1e-4
ADV_STEPS = 2
ADV_THRESHOLD = 1e-4
# the row-sharded attacks of hyper q1 and of cheng2020-gmm q3 (the demo
# weights); the MS-SSIM attack decides its phase with the host ``if``, and
# at its budget the output phase, whose loss gathers the whole image, runs
# on every step (at 1e-4, on 1 of 5)
SP_ATTACK = dict(steps=5, noise_threshold=1e-4)
MSSSIM_ATTACK = dict(steps=5, noise_threshold=1e-3, att_metric="ms-ssim")
CHENG_ATTACK = dict(steps=3, two_phase_impl="select")
# the adapter families on sp = 2 (tests/test_torch_parallel_adapters.py), at
# q3: tic, fic and nlaic on their demo trees, hific and invcompress on
# seeded weights moved by ADAPTER_PERTURB x normal noise (so that the
# zero-initialized couplings act), as tests/test_torch_adapters.py does
ADAPTERS = ("hific", "invcompress", "tic", "fic", "nlaic")
DEMO = Path(__file__).resolve().parent.parent / "ckpts" / "demo"
ADAPTER_SEED = 5
ADAPTER_PERTURB = 0.01
ADAPTER_ATTACK = dict(steps=3, two_phase_impl="select")
# the inner attack's branch case: at this budget, 10 steps on the batch
# ``adv_x`` take the output phase in 3 steps on image 0 alone, 5 on image 1
# alone and 4 on the two together
BRANCH_STEPS = 10
BRANCH_THRESHOLD = 2e-4
# slice 10 c-e on hyper q1 (tests/test_torch_parallel_defenses.py): the
# row-sharded attack through each in-loop defense and with -p, 3 `select`
# steps (the codec on every step) on ``sp_x``; ``pad_uneven`` pads its 256
# rows to 320, which sp = 2 splits into blocks of 192 and 128 rows and sp =
# 4 into 128, 128, 64 and 0, and the ensemble's rotated variants have its
# 128 columns as rows, 64, 64, 0 and 0 at sp = 4; the inner attack on dp x
# sp = 2 x 2 at DPSP_ADV_THRESHOLD takes both phases in BRANCH_STEPS steps
DEFENSE_ATTACK = dict(steps=3, two_phase_impl="select")
DEFENSE_CASES = {
    "ensemble_batch": dict(DEFENSE_ATTACK, defend_in_loop="ensemble", ensemble_impl="batch"),
    "ensemble_scan": dict(DEFENSE_ATTACK, defend_in_loop="ensemble", ensemble_impl="scan"),
    "bitdepth": dict(DEFENSE_ATTACK, defend_in_loop="bitdepth"),
    "resize": dict(DEFENSE_ATTACK, defend_in_loop="resize"),
    "pad": dict(DEFENSE_ATTACK, pad=64),
    "pad_uneven": dict(DEFENSE_ATTACK, pad=32),
}
DPSP_ADV_THRESHOLD = 2e-4


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def _model(inputs: dict, arch: str, trainable: bool = False):
    model = init_model(arch, 1)
    model.load_state_dict(params_from_jax(inputs["params"][arch], arch), strict=True)
    return model.requires_grad_(trainable).to(memory_format=torch.channels_last).eval()


def _use_noise(tables: Dict[tuple, np.ndarray]) -> None:
    """``ops.quant.uniform_noise`` returns the NCHW table of the shape it
    is asked for (the global shape, under a shard)."""
    tabs = {k: torch.from_numpy(v) for k, v in tables.items()}
    quant.uniform_noise = lambda y, generator: tabs[tuple(y.shape)].to(y)


# -- dp = 2 -----------------------------------------------------------------


def mesh_and_batch(inputs):
    mesh = make_mesh(2, ("dp",), device_type="cpu")
    mesh2 = make_mesh(2, ("dp", "sp"), device_type="cpu")
    return {"shape1": mesh_shape(mesh), "shape2": mesh_shape(mesh2),
            "slice": shard_batch(mesh, inputs["batch16"]).numpy()}


def tiles_identity(inputs):
    mesh = make_mesh(device_type="cpu")
    return {"out": tiled_forward(lambda t: t, inputs["tile_x"], 256, 64, mesh=mesh)}


def tiles_codec(inputs):
    mesh = make_mesh(device_type="cpu")
    model = _model(inputs, "factorized")

    @torch.no_grad()
    def fwd(t):
        return model(t.contiguous(memory_format=torch.channels_last),
                     quant_mode="dequantize")["x_hat"].clamp(0.0, 1.0)

    return {"out": tiled_forward(fwd, inputs["tile_codec_x"], 256, 64, mesh=mesh)}


def corpus_attack(inputs):
    mesh = make_mesh(device_type="cpu")
    model = replicate(mesh, _model(inputs, "hyper"))
    attack = make_sharded_attack_fn(model, RDAttackConfig(steps=3), mesh)
    out = attack(nchw(inputs["corpus"]))
    return {k: out[k] for k in ("vi", "mse_in", "bpp_ori", "bpp", "im_")}


def _train(inputs, mesh, arch: str, batches: List[np.ndarray], noise: str, adv: bool = False,
           recompress: bool = False):
    """Step 1's reduced gradients (not with ``adv`` or ``recompress``: they
    are the RD case's), then one step a batch (with ``adv``, on the
    adversarial example of the batch), under the noise tables ``noise``:
    the logs of each step and the final parameters, from this rank."""
    _use_noise(inputs["noise"][noise])
    model = replicate(mesh, _model(inputs, arch, trainable=True))
    lmbda = lambda_for("mse", 1)

    def local(b):
        return local_part(mesh, nchw(b), batch_row_sharding(mesh)).contiguous(
            memory_format=torch.channels_last)

    where = mesh_shard(mesh, local(batches[0]))

    grads = None
    if not (adv or recompress):
        names, params = zip(*[(n, p) for n, p in model.named_parameters()
                              if n != "entropy_bottleneck.quantiles"])
        with shard.within(where):
            result = model(local(batches[0]), quant_mode="noise", generator=torch.Generator())
            loss = rate_distortion_loss(result, local(batches[0]), lmbda, "mse")["loss"]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
        reduce_gradients_(grads, where)
        grads = {n: g.numpy() for n, g in zip(names, grads)}

    state = create_train_state(model, LR)
    adv_fn = make_adv_example_fn(model, RDAttackConfig(steps=ADV_STEPS, noise_threshold=ADV_THRESHOLD),
                                 mesh) if adv else None
    logs = []
    for b in batches:
        x = local(b)
        if adv:
            x = adv_fn(x, ADV_THRESHOLD)
        out = train_step(state, x, torch.Generator(), LR, lmbda, "mse", recompress=recompress,
                         mesh=mesh)
        logs.append({k: float(v) for k, v in out.items()})
    return {"grads": grads, "logs": logs,
            "params": {k: v.detach().numpy() for k, v in model.state_dict().items()}}


def train_rd(inputs):
    return _train(inputs, make_mesh(device_type="cpu"), "hyper", inputs["train_batches"], "hyper")


def train_context(inputs):
    return _train(inputs, make_mesh(device_type="cpu"), "context", inputs["train_batches"],
                  "context")


def train_adv(inputs):
    return _train(inputs, make_mesh(device_type="cpu"), "hyper", inputs["train_batches"], "hyper",
                  adv=True)


def adv_branches(inputs):
    """The inner attack on one image a rank, with the batch's global MSEs
    (the mesh) and with each rank's own: the steps each took in the output
    phase (``g_a`` calls, less the clean forward's) and the global run's
    adversarial example."""
    mesh = make_mesh(device_type="cpu")
    model = _model(inputs, "hyper")
    x = local_part(mesh, nchw(inputs["adv_x"]), batch_sharding(mesh))
    out = {}
    for name, m in (("own", None), ("global", mesh)):
        calls = []
        hook = model.g_a.register_forward_hook(lambda *_: calls.append(1))
        im = make_adv_example_fn(model, RDAttackConfig(steps=BRANCH_STEPS), m)(x, BRANCH_THRESHOLD)
        hook.remove()
        out[name] = len(calls) - 1
        out[f"{name}_im"] = nhwc(im)
    return out


# -- sp = 4, and dp x sp = 2 x 2 ----------------------------------------------


def sp_forward(inputs):
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    model = replicate(mesh, _model(inputs, "hyper"))
    out = make_spatial_forward(model, mesh)(nchw(inputs["sp_x"]))
    return {"x_hat": nhwc(out["x_hat"]),
            "loglik": {k: float(torch.log(v).double().sum()) for k, v in out["likelihoods"].items()}}


def _sp_attack(inputs, arch: str = "hyper", image: str = "sp_x",
               dtype: torch.dtype = torch.float32, **cfg):
    """The row-sharded attack of ``arch`` on the image ``image``, over every
    rank of the world, with ``RDAttackConfig(**cfg)``, in ``dtype``."""
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    model = replicate(mesh, in_dtype(_model(inputs, arch), dtype))
    res = make_spatial_attack_fn(model, RDAttackConfig(**cfg), mesh)(
        nchw(inputs[image]).to(dtype))
    x_rows = local_part(mesh, nchw(inputs[image]), row_sharding(mesh))
    return {**{k: float(res[k]) for k in ("vi", "mse_in", "bpp_ori", "bpp", "vi_msim")},
            "im_": nhwc(res["im_"]), "rows": tuple(res["im_"].shape),
            "x_rows": tuple(x_rows.shape)}


def sp_attack(inputs):
    return _sp_attack(inputs, **SP_ATTACK, two_phase_impl="cond")


def sp_attack_select(inputs):
    return _sp_attack(inputs, **SP_ATTACK, two_phase_impl="select")


def sp_attack_msssim(inputs):
    return _sp_attack(inputs, **MSSSIM_ATTACK)


def sp2_split_attack(inputs):
    return _sp_attack(inputs, **SP_ATTACK, split_eval=True)


def sp2_cheng_forward(inputs):
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    model = replicate(mesh, _model(inputs, "cheng2020-gmm"))
    out = make_spatial_forward(model, mesh)(nchw(inputs["cheng_x"]))
    return {"x_hat": nhwc(out["x_hat"]),
            "loglik": {k: float(torch.log(v).double().sum()) for k, v in out["likelihoods"].items()}}


def sp2_cheng_attack(inputs):
    return _sp_attack(inputs, "cheng2020-gmm", "cheng_x", **CHENG_ATTACK)


def adapter_model(arch: str):
    """The port's ``arch`` q3 codec on the CPU, frozen, channels_last: the
    demo tree where there is one, else the seeded weights moved by
    ADAPTER_PERTURB x normal noise (``torch_parity.perturb_``'s draw)."""
    ckpt = DEMO / f"{arch}-q3-mse-synthetic.msgpack"
    if ckpt.is_file():
        return load_model(Config(device="cpu", model=arch, quality=3, checkpoint=str(ckpt)))
    model = init_model(arch, 3, seed=ADAPTER_SEED)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(ADAPTER_PERTURB * torch.randn(p.shape, generator=gen))
    return model.requires_grad_(False).to(memory_format=torch.channels_last).eval()


def in_dtype(model, dtype: torch.dtype):
    """``model`` in ``dtype``; in float64 its GDNs take the plain version
    (the kernel is float32)."""
    if dtype == torch.float64:
        for m in model.modules():
            if isinstance(m, GDN):
                m.use_kernel = False
    return model.to(dtype)


def adapter_noise(inputs, arch: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The attack's initial noise (NCHW): ``fic_noise`` for fic, whose
    zero start is a critical point, zeros for the rest."""
    x = nchw(inputs["adapter_x"])
    return (nchw(inputs["fic_noise"]) if arch == "fic" else torch.zeros_like(x)).to(dtype)


def _forward_rows(out) -> dict:
    """A forward's x_hat and likelihoods (this rank's rows, NHWC) and the
    log-likelihood sums of those rows."""
    return {"x_hat": nhwc(out["x_hat"]),
            "lik": {k: nhwc(v) for k, v in out["likelihoods"].items()},
            "loglik": {k: float(torch.log(v).double().sum()) for k, v in out["likelihoods"].items()}}


def _adapter_attack(inputs, model, arch: str, mesh, **cfg):
    """The sp=2 attack of ``model`` (``arch``, replicated over ``mesh``) on
    ``adapter_x`` from ``adapter_noise``, in the model's dtype."""
    dtype = next(model.parameters()).dtype
    attack = make_spatial_attack_fn(model, RDAttackConfig(**cfg), mesh)
    noise = adapter_noise(inputs, arch, dtype)
    draw = spatial_shard.init_noise
    spatial_shard.init_noise = lambda *_: noise
    try:
        res = attack(nchw(inputs["adapter_x"]).to(dtype))
    finally:
        spatial_shard.init_noise = draw
    return {**{k: float(res[k]) for k in ("vi", "mse_in", "bpp_ori", "bpp", "vi_msim")},
            "im_": nhwc(res["im_"]), "rows": tuple(res["im_"].shape)}


def sp2_adapter(inputs, arch: str):
    """The sp=2 ``dequantize`` forward of ``arch`` and its ADAPTER_ATTACK,
    in float32 and in float64."""
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    model = replicate(mesh, adapter_model(arch))
    fwd = _forward_rows(make_spatial_forward(model, mesh)(nchw(inputs["adapter_x"])))
    return {"forward": fwd,
            "attack": _adapter_attack(inputs, model, arch, mesh, **ADAPTER_ATTACK),
            "attack_f64": _adapter_attack(inputs, in_dtype(copy.deepcopy(model), torch.float64),
                                          arch, mesh, **ADAPTER_ATTACK)}


def sp2_nlaic_split(inputs):
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    return _adapter_attack(inputs, replicate(mesh, adapter_model("nlaic")), "nlaic", mesh,
                           **ADAPTER_ATTACK, split_eval=True)


def _rank_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``t``'s rows (``dim``) on the world's one axis."""
    n, i = dist.get_world_size(), dist.get_rank()
    h = t.shape[dim] // n
    return t.narrow(dim, i * h, h)


def roll_rows_case(inputs):
    """``shard.roll_rows`` of ``roll_x`` (NCHW, rows dim 2; and its NHWC
    view, rows dim 1) by each shift of ``roll_shifts``: this rank's rows of
    the output and of the gradient of ``sum(out * roll_w)``."""
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    rows = shard.mesh_axis(mesh, "sp")
    out = {}
    for layout, dim in (("nchw", 2), ("nhwc", 1)):
        x, w = (torch.from_numpy(inputs[k]) for k in ("roll_x", "roll_w"))
        if layout == "nhwc":
            x, w = x.permute(0, 2, 3, 1), w.permute(0, 2, 3, 1)
        for shift in inputs["roll_shifts"]:
            xl = _rank_rows(x, dim).clone().requires_grad_(True)
            with shard.sharded(rows=rows):
                y = shard.roll_rows(xl, shift, dim=dim)
            (y * _rank_rows(w, dim)).sum().backward()
            out[(layout, shift)] = {"y": y.detach().numpy(), "dx": xl.grad.numpy()}
    return out


def shared_rows_case(inputs):
    """``shard.shared_rows`` of this rank's rows of ``roll_x``, each rank's
    loss its own weighting ``sum(full * roll_w * (rank + 1))`` of the whole
    tensor: the whole tensor and this rank's gradient.  Then the sp=2
    non-local block on ``nl_x`` (weights ``nl_state``): this rank's
    output rows, its input gradient under the loss ``sum(out * nl_w)``,
    and its parameter gradients summed over the ranks."""
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    rows = shard.mesh_axis(mesh, "sp")
    x = torch.from_numpy(inputs["roll_x"])
    xl = _rank_rows(x, 2).clone().requires_grad_(True)
    with shard.sharded(rows=rows):
        full = shard.shared_rows(xl)
    (full * torch.from_numpy(inputs["roll_w"]) * (rows.index + 1)).sum().backward()
    out = {"full": full.detach().numpy(), "dx": xl.grad.numpy()}

    blk = NonLocalBlock(inputs["nl_x"].shape[1])
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["nl_state"].items()})
    xl = _rank_rows(torch.from_numpy(inputs["nl_x"]), 2).clone().requires_grad_(True)
    with shard.sharded(rows=rows):
        y = blk(xl)
    (y * _rank_rows(torch.from_numpy(inputs["nl_w"]), 2)).sum().backward()
    grads = {k: shard.all_reduce_(p.grad.clone(), rows).numpy() for k, p in blk.named_parameters()}
    out.update(nl_y=y.detach().numpy(), nl_dx=xl.grad.numpy(), nl_grads=grads)
    return out


def sp_unaligned(inputs):
    mesh = make_mesh(axis_names=("sp",), device_type="cpu")
    fwd = make_spatial_forward(_model(inputs, "hyper"), mesh)
    try:
        fwd(torch.zeros(1, 3, 192, 128))
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def train_dpsp(inputs):
    mesh = make_mesh(4, ("dp", "sp"), device_type="cpu", shape=(2, 2))
    return _train(inputs, mesh, "hyper", inputs["dpsp_batches"], "dpsp")


def _raised(fn) -> dict:
    try:
        fn()
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def adv_sp_rejects_debug(inputs):
    """``make_adv_example_fn`` of the ``debug`` fixture on a dp x sp mesh:
    the error it raises (no halo rule)."""
    mesh = make_mesh(4, ("dp", "sp"), device_type="cpu", shape=(2, 2))
    return _raised(lambda: make_adv_example_fn(init_model("debug", 1),
                                               RDAttackConfig(steps=ADV_STEPS), mesh))


# -- slice 10 c-e: in-loop defenses, -p and recompression on a mesh, the
# --adv inner attack on dp x sp (tests/test_torch_parallel_defenses.py) ----


def sp_defense(inputs, name: str):
    """``DEFENSE_CASES[name]``'s row-sharded attack over every rank."""
    return _sp_attack(inputs, **DEFENSE_CASES[name])


def sp_defense_f64(inputs, name: str):
    """``DEFENSE_CASES[name]``'s row-sharded attack in float64."""
    return _sp_attack(inputs, dtype=torch.float64, **DEFENSE_CASES[name])


def adv_dpsp(inputs):
    """The inner attack on a dp x sp = 2 x 2 mesh, on this rank's block of
    ``dpsp_batches[0]``: this rank's rows of the adversarial example and
    the steps it took in the output phase (``g_a`` calls less the clean
    forward's)."""
    mesh = make_mesh(4, ("dp", "sp"), device_type="cpu", shape=(2, 2))
    model = replicate(mesh, _model(inputs, "hyper"))
    x = local_part(mesh, nchw(inputs["dpsp_batches"][0]), batch_row_sharding(mesh))
    calls = []
    hook = model.g_a.register_forward_hook(lambda *_: calls.append(1))
    im = make_adv_example_fn(model, RDAttackConfig(steps=BRANCH_STEPS), mesh)(x, DPSP_ADV_THRESHOLD)
    hook.remove()
    return {"im": nhwc(im), "output_steps": len(calls) - 1}


def train_recompress(inputs):
    """Recompression training on dp = 2 (this world's size) or dp x sp =
    2 x 2 (a world of 4), on ``dpsp_batches``."""
    if dist.get_world_size() == 2:
        mesh = make_mesh(device_type="cpu")
    else:
        mesh = make_mesh(4, ("dp", "sp"), device_type="cpu", shape=(2, 2))
    return _train(inputs, mesh, "hyper", inputs["dpsp_batches"], "dpsp", recompress=True)


SCENARIOS = {f.__name__: f for f in (
    mesh_and_batch, tiles_identity, tiles_codec, corpus_attack, train_rd, train_context,
    train_adv, adv_branches, sp_forward, sp_attack, sp_attack_select, sp_attack_msssim,
    sp_unaligned, train_dpsp, adv_sp_rejects_debug, sp2_split_attack, sp2_cheng_forward,
    sp2_cheng_attack, sp2_nlaic_split, roll_rows_case, shared_rows_case, adv_dpsp,
    train_recompress)}
SCENARIOS.update({f"sp2_{arch}": (lambda inputs, arch=arch: sp2_adapter(inputs, arch))
                  for arch in ADAPTERS})
SCENARIOS.update({f"sp_{name}": (lambda inputs, name=name: sp_defense(inputs, name))
                  for name in DEFENSE_CASES})
SCENARIOS.update({f"sp_{name}_f64": (lambda inputs, name=name: sp_defense_f64(inputs, name))
                  for name in ("resize", "pad_uneven", "ensemble_batch")})


class StreamedWorlds:
    """Worlds of several sizes, run in background threads of the test
    process while its tests compute the JAX side; the ranks write each
    scenario's results as it finishes (``run_world``'s ``stream_dir``), and
    a test waits for those it reads."""

    def __init__(self, inputs: dict, tmp: Path, scenarios: Dict[int, List[str]],
                 timeout: float):
        from imagecompression_adversarial_tpu_torch.parallel import run_spmd

        self.inputs = inputs
        path = str(tmp / "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inputs, f)
        self._dirs = {n: tmp / f"world{n}" for n in scenarios}
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(scenarios))
        self._worlds = {}
        for n, names in scenarios.items():
            self._dirs[n].mkdir()
            self._worlds[n] = self._pool.submit(run_spmd, run_world, n, "gloo", "cpu",
                                                (path, names, str(self._dirs[n])), timeout)

    def ranks(self, scenario: str, size: int = 2) -> list:
        """Each rank's result of ``scenario`` in the world of ``size``
        ranks, once every rank has written it; a world that failed
        raises its ranks' tracebacks here."""
        paths = [self._dirs[size] / f"{scenario}.{r}.pkl" for r in range(size)]
        world = self._worlds[size]
        while not all(p.is_file() for p in paths):
            if world.done():
                world.result()  # raises where a rank failed
                if not all(p.is_file() for p in paths):
                    raise RuntimeError(f"the world of {size} ranks did not run {scenario}")
            time.sleep(0.1)
        out = []
        for p in paths:
            with open(p, "rb") as f:
                out.append(pickle.load(f))
        return out

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


def run_world(inputs_path: str, scenarios: List[str],
              stream_dir: Optional[str] = None) -> Dict[str, dict]:
    """With ``stream_dir``, each rank also writes each scenario's result
    there as it finishes (``<scenario>.<rank>.pkl``), so that the test
    process can check it while the world goes on."""
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out = {}
    with torch.backends.mkldnn.flags(enabled=False):
        for name in scenarios:
            out[name] = SCENARIOS[name](inputs)
            if stream_dir is not None:
                path = os.path.join(stream_dir, f"{name}.{dist.get_rank()}.pkl")
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(out[name], f)
                os.replace(path + ".tmp", path)
            dist.barrier()
    return out


def failing_rank():
    """Rank 1 raises while rank 0 waits in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def stalled_rank():
    """Every rank sleeps past the caller's timeout."""
    time.sleep(600)

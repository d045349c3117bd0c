"""The canonical RD distortion attack (port of
``imagecompression_adversarial_tpu/attacks/rd.py``, non-split), its
adaptive in-loop defenses, random restarts and image batches.

Each step clips the noise to the L-inf ball through the gated bounds, then
the input to [0, 1] (not for the debug fixture); while the input MSE is
over budget the loss is that MSE, otherwise it is
``1 - MSE(out, out_clean)`` through the quantization-free path, where
``out`` may pass through a defense (``RDAttackConfig.defend_in_loop``).
Adam on the noise with the MultiStepLR schedule; the final evaluation uses
real rounding, or the defense ``defend_fn_builder`` gives.  The loop runs
eagerly: one forward and one backward a step.

A batch of B images (or of B restarts of one image) runs as one attack on
a ``(B, 3, H, W)`` noise: the loss is the sum of the per-element losses,
so each element keeps its own gradient and Adam trajectory, and the
two-phase switch is taken per element with ``torch.where`` (as the
reference's ``vmap`` lowers its ``cond``).  Clean forward, rate and
evaluation run per element.

``RDAttackConfig.split_eval`` gives the large-image attack (the
reference's two-program ``_make_split_attack_fn``): the same loop, with
the phase-space loss's autograd graph checkpointed by stage
(``staged_phase_fn``).  In eager PyTorch the loop's graph is gone when
its step ends and the evaluation already runs one piece at a time under
``no_grad``, so the checkpoint is all the reference's second program
stands for here.

``make_adv_example_fn`` is the inner attack of adversarial training, with
the reference's other batch semantics: the batch is one attack, with one
batch-wide input MSE, one phase for all images, and the budget an
argument.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..defenses.self_ensemble import bitdepth_reduction, random_resize, self_ensemble
from ..metrics import bpp_from_likelihoods, ms_ssim
from ..models.layers import GDN
from ..ops import shard
from ..ops.bounds import bound_clip
from .common import AdamOnNoise, RDAttackConfig, init_noise, multistep_lr_schedule
from .evaluate import evaluate

_DEFEND_IN_LOOP = (None, "ensemble", "bitdepth", "resize", "clip")
_PER_ELEMENT = (1, 2, 3)


def _adversarial_input(x, noise_c, cfg: RDAttackConfig):
    """``x + noise_c``, clipped to [0, 1] through the gated bounds unless
    the codec is the debug fixture."""
    return x + noise_c if cfg.debug_model else bound_clip(x + noise_c, 0.0, 1.0)


def _output(model, im_in, cfg: RDAttackConfig, clip_fn):
    """The quantization-free reconstruction, through the in-loop defense.
    The ensemble and the latent clip take one image at a time.  Under a
    row shard the ensemble and the resize work on the whole image and
    return this rank's rows (``defenses/self_ensemble.py``)."""
    mode = cfg.defend_in_loop
    if mode == "ensemble":
        return torch.cat([self_ensemble(model, im, "none", cfg.ensemble_impl)["x_hat"]
                          for im in im_in.split(1)])
    if mode == "clip":
        return torch.cat([clip_fn(im) for im in im_in.split(1)])
    if mode == "bitdepth":
        im_in = bitdepth_reduction(im_in)
    elif mode == "resize":
        im_in = random_resize(im_in)[0]
    return model(im_in, quant_mode="none")["x_hat"]


def _ms_ssim_rows(a, b):
    """Per-element MS-SSIM of the whole images; under a row shard each
    rank gathers them (``shard.all_rows``) and its gradient comes back to
    its own rows."""
    return ms_ssim(shard.all_rows(a), shard.all_rows(b), size_average=False)


def _attack_loss(model, x, output_s, noise, cfg: RDAttackConfig, phase: bool, clip_fn=None,
                 phase_fn=None):
    """Two-phase RD attack loss of a batch: ``(loss, (loss_i, loss_o))``
    with ``loss`` the sum over the batch and ``loss_i``/``loss_o`` per
    element.

    With ``phase`` the output is the phase-space synthesis (``phase_fn``,
    by default ``g_s_phase(g_a(.))``) and ``output_s`` its clean
    counterpart: MSE is invariant under the permutation back to full
    resolution, so the loss, its gradient and the trajectory are the
    full-resolution ones.  ``cond`` on a single image decides the phase
    with a host ``if`` and skips the forward while over budget; otherwise
    both phases run and ``torch.where`` picks per element.  Under a row
    shard (``ops/shard.py``) the means are the whole image's, so every
    shard takes the same branch, and the MS-SSIM metric runs on the whole
    images.
    """
    eps = cfg.epsilon / 255.0
    im_in = _adversarial_input(x, bound_clip(noise, -eps, eps), cfg)
    loss_i = shard.mean((x - im_in) ** 2, dim=_PER_ELEMENT)
    zero = torch.zeros_like(loss_i)

    def input_loss():
        if cfg.att_metric == "ms-ssim":
            return 1.0 - _ms_ssim_rows(x, im_in)
        return loss_i

    host_cond = cfg.two_phase_impl == "cond" and x.shape[0] == 1
    if host_cond and bool(loss_i > cfg.noise_threshold):
        return input_loss().sum(), (loss_i, zero)

    if phase:
        x_ = phase_fn(im_in) if phase_fn is not None else model.g_s_phase(model.g_a(im_in))
    else:
        x_ = _output(model, im_in, cfg, clip_fn)
    output_ = bound_clip(x_, 0.0, 1.0) if cfg.clamp else x_
    if cfg.att_metric == "ms-ssim":
        loss_o = _ms_ssim_rows(output_, output_s)
    else:
        loss_o = 1.0 - shard.mean((output_s - output_) ** 2, dim=_PER_ELEMENT)
    if host_cond:
        return loss_o.sum(), (loss_i, loss_o)
    over = loss_i > cfg.noise_threshold
    return torch.where(over, input_loss(), loss_o).sum(), (loss_i, torch.where(over, zero, loss_o))


def _resolve(model, cfg: RDAttackConfig) -> RDAttackConfig:
    """Check the loss settings and settle ``phase_space_loss=None`` (auto):
    on iff the attack is the plain L2 one (no defense in the loop) on a
    codec other than the debug fixture and the codec has an exact phase
    synthesis."""
    if cfg.two_phase_impl not in ("cond", "select"):
        raise ValueError(f"two_phase_impl={cfg.two_phase_impl!r} not in ('cond', 'select')")
    if cfg.two_phase_impl == "select" and cfg.att_metric == "ms-ssim":
        raise ValueError("two_phase_impl='select' supports the L2 att_metric only")
    if cfg.defend_in_loop not in _DEFEND_IN_LOOP:
        raise ValueError(f"defend_in_loop={cfg.defend_in_loop!r} not in {_DEFEND_IN_LOOP}")
    supported = bool(getattr(model, "supports_phase_synthesis", False))
    if cfg.phase_space_loss is None:
        eligible = (cfg.att_metric != "ms-ssim" and not cfg.defend_in_loop and not cfg.pad
                    and not cfg.debug_model)
        return dataclasses.replace(cfg, phase_space_loss=eligible and supported)
    if cfg.phase_space_loss and not supported:
        raise ValueError(
            f"phase_space_loss=True but {type(model).__name__} has no exact "
            "phase-space synthesis"
        )
    if cfg.phase_space_loss and (cfg.att_metric == "ms-ssim" or cfg.defend_in_loop or cfg.pad):
        raise ValueError("phase_space_loss supports the plain L2 attack only "
                         "(no ms-ssim metric, in-loop defense, or -p padding)")
    return cfg


def make_attack_fn(
    model,
    cfg: RDAttackConfig,
    defend_fn_builder: Optional[Callable] = None,
    latent_transform: Optional[Callable] = None,
) -> Callable[..., Dict[str, Any]]:
    """Build ``attack(x, generator=None) -> results`` for a ``(1, 3, H, W)``
    image on the model's device.  Results hold tensors: ``im_``,
    ``output_``, ``bpp``, ``bpp_ori``, MSEs, MS-SSIMs, ``vi``, ``vi_msim``,
    ``output_s``, ``loss_i_final`` and ``loss_o_final``.

    ``defend_fn_builder(model)`` gives the evaluation's defense;
    ``latent_transform`` (y -> y') is the latent clamp that
    ``defend_in_loop='clip'`` attacks through.  ``attack.batch(xs,
    noises)`` attacks a ``(B, 3, H, W)`` batch from the given initial
    noises and returns the results stacked on a new leading axis;
    ``attack.run(x, noise)`` attacks one image from the given initial
    noise.  A ``cfg.split_eval`` attack checkpoints its loss by stage
    (``staged_phase_fn``) and has no ``batch``: it takes one image at a
    time.
    """
    if cfg.split_eval:
        _check_split(cfg)
    cfg = _resolve(model, cfg)
    if cfg.defend_in_loop == "clip" and latent_transform is None:
        raise ValueError("defend_in_loop='clip' needs a latent_transform")
    if cfg.split_eval and not cfg.phase_space_loss:
        raise ValueError("split_eval requires phase_space_loss=True")
    lrs = multistep_lr_schedule(cfg.steps, cfg.lr, cfg.lr_milgamma).tolist()
    phase_fn = staged_phase_fn(model) if cfg.split_eval else None
    clip_fn = None
    if latent_transform is not None:

        def clip_fn(im):
            return model.from_latent(latent_transform(model.g_a(im)), "none")["x_hat"]

    defend_fn = defend_fn_builder(model) if defend_fn_builder else None

    @torch.no_grad()
    def clean(x):
        """Clean reconstruction, rate and loss reference of one image."""
        if cfg.pad:
            # the whole image reflect-padded; under a row shard each rank
            # runs the codec on its rows of the padded image, and takes its
            # rows of the cropped reconstruction
            p = cfg.pad
            padded = F.pad(shard.gather_rows(x), (p, p, p, p), mode=cfg.padding_mode)
            result_s = model(shard.own_rows(padded), "dequantize")
            output_s = shard.own_rows(
                shard.gather_rows(result_s["x_hat"])[:, :, p:-p, p:-p].clamp(0.0, 1.0))
        else:
            result_s = model(x, quant_mode="dequantize")
            output_s = result_s["x_hat"].clamp(0.0, 1.0) if cfg.clamp else result_s["x_hat"]
        bpp_ori = bpp_from_likelihoods(result_s["likelihoods"], x.shape[2] * x.shape[3])
        if cfg.phase_space_loss:
            ref = model.g_s_phase(result_s[model.phase_reference_latent])
            loss_ref = ref.clamp(0.0, 1.0) if cfg.clamp else ref
        else:
            loss_ref = output_s
        return output_s, bpp_ori, loss_ref

    def run(xs: torch.Tensor, noise: torch.Tensor) -> List[Dict[str, Any]]:
        xs = xs.contiguous(memory_format=torch.channels_last)
        cleans = [clean(x) for x in xs.split(1)]
        loss_ref = torch.cat([c[2] for c in cleans])
        noise = noise.to(xs.device).contiguous(memory_format=torch.channels_last)
        opt = AdamOnNoise(noise)
        for lr in lrs:
            noise.requires_grad_(True)
            loss, _ = _attack_loss(model, xs, loss_ref, noise, cfg, cfg.phase_space_loss, clip_fn,
                                   phase_fn)
            (grad,) = torch.autograd.grad(loss, noise)
            noise = noise.detach()
            opt.step(noise, grad, lr)

        with torch.no_grad():
            _, (loss_i_final, loss_o_final) = _attack_loss(
                model, xs, loss_ref, noise, cfg, cfg.phase_space_loss, clip_fn
            )
            eps = cfg.epsilon / 255.0
            im_in = _adversarial_input(xs, noise.clamp(-eps, eps), cfg)
        results = []
        for b, (output_s, bpp_ori, _) in enumerate(cleans):
            ev = evaluate(model, im_in[b:b + 1], xs[b:b + 1], output_s, clamp=cfg.clamp,
                          defend_fn=defend_fn)
            ev.update({
                "output_s": output_s,
                "bpp_ori": bpp_ori,
                "loss_i_final": loss_i_final[b],
                "loss_o_final": loss_o_final[b],
            })
            results.append(ev)
        return results

    def attack(x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return run(x, init_noise(tuple(x.shape), cfg, generator, x.device))[0]

    def batch(xs: torch.Tensor, noises: torch.Tensor) -> Dict[str, torch.Tensor]:
        results = run(xs, noises)
        return {k: torch.stack([r[k] for r in results]) for k in results[0]}

    attack.run = lambda x, noise: run(x, noise)[0]
    if not cfg.split_eval:
        attack.batch = batch
    attack.cfg = cfg
    return attack


def _check_split(cfg: RDAttackConfig) -> None:
    """What the split attack rejects (the reference's conditions, in its
    words): anything but the plain L2 loss, and the debug fixture."""
    if cfg.defend_in_loop or cfg.pad or cfg.att_metric == "ms-ssim":
        raise ValueError("split_eval supports the plain L2 attack only "
                         "(no ms-ssim metric, in-loop defense, or -p padding)")
    if cfg.debug_model:
        raise ValueError("split_eval does not support debug_model")


def _stages(layers: nn.Sequential) -> List[List[nn.Module]]:
    """The children of ``layers`` in stages: a conv and the GDN after it
    make one stage, any other child (a cheng2020 block) is one."""
    stages: List[List[nn.Module]] = []
    for m in layers:
        if isinstance(m, GDN) and stages and len(stages[-1]) == 1 and \
                not isinstance(stages[-1][0], GDN):
            stages[-1].append(m)
        else:
            stages.append([m])
    return stages


def staged_phase_fn(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """``g_s_phase(g_a(im))`` with its autograd graph checkpointed by stage
    (``torch.utils.checkpoint``, non-reentrant): the backward keeps each
    stage's input and recomputes the stage's inside when it reaches it.

    Without it the graph holds two full tensors a stage (the conv's input
    and the GDN's); with it one, plus one stage's inside at a time.  One
    checkpoint around the whole loss would save nothing here, since its
    recompute would store every activation again.  The last analysis
    stage and the first synthesis stage run as one, so the latent y is
    recomputed (the reference's ``remat_policy='full'``).  The recompute
    enters the row shard its forward ran under and reuses the same
    modules, so the GDN calls go through the same kernel.  The stages
    draw no random numbers, so the RNG state is not kept."""
    analysis, synthesis = _stages(model.g_a), _stages(model.g_s)
    last = synthesis[-1][-1]
    segments = analysis[:-1] + [analysis[-1] + synthesis[0]] + synthesis[1:]

    def run(where, layers, t):
        with shard.within(where):
            for m in layers:
                t = m(t, phase_output=True) if m is last else m(t)
        return t

    def phase_fn(im: torch.Tensor) -> torch.Tensor:
        where = shard.current()
        for layers in segments:
            im = checkpoint(run, where, layers, im, use_reentrant=False, preserve_rng_state=False)
        return im

    return phase_fn


def make_batch_attack_fn(model, cfg: RDAttackConfig):
    """``batched(xs, generators=None)``: attack each image of a ``(B, 3, H,
    W)`` batch independently, in one batched loop; element ``b`` draws its
    initial noise (where the config draws one) from ``generators[b]``.
    Results are stacked on a leading axis of size B.  A ``split_eval``
    config raises: the split attack takes one image at a time."""
    if cfg.split_eval:
        raise ValueError("split_eval attacks one image at a time; use attack_batch=1")
    single = make_attack_fn(model, cfg)

    def batched(xs: torch.Tensor, generators: Optional[List[torch.Generator]] = None):
        gens = generators if generators is not None else [None] * xs.shape[0]
        shape = (1, *xs.shape[1:])
        noises = torch.cat([init_noise(shape, single.cfg, g, xs.device) for g in gens])
        return single.batch(xs, noises)

    return batched


def best_of_restarts(attack_fn, x: torch.Tensor, generator: torch.Generator, restarts: int,
                     impl: str = "vmap") -> Dict[str, Any]:
    """Run ``restarts`` attacks of ``x`` and keep the highest-vi result
    (the first of equals).  Restart ``r`` starts from the ``r``-th noise
    drawn from ``generator``.  ``impl='host'`` runs them one after the
    other; ``'vmap'`` runs them as one batched attack over the restarts'
    noises (the same noises, so the same results up to float rounding).
    A split attack always runs them one after the other: a batch would
    hold every restart's loop at once and forfeit the memory the split
    saves."""
    if impl not in ("vmap", "host"):
        raise ValueError(f"impl={impl!r} not in ('vmap', 'host')")
    if impl == "host" or attack_fn.cfg.split_eval:
        results = [attack_fn(x, generator) for _ in range(restarts)]
        best = max(range(restarts), key=lambda i: float(results[i]["vi"]))
        return results[best]
    noises = torch.cat([init_noise(tuple(x.shape), attack_fn.cfg, generator, x.device)
                        for _ in range(restarts)])
    res = attack_fn.batch(x.expand(restarts, -1, -1, -1), noises)
    best = int(torch.argmax(res["vi"]))
    return {k: v[best] for k, v in res.items()}


@contextlib.contextmanager
def frozen(model):
    """Run with every parameter of ``model`` not requiring grad (restored
    after): an attack on a model being trained then computes no parameter
    gradients (GDN's ``dgamma``/``dbeta`` among them) and leaves no
    ``.grad``."""
    params = list(model.parameters())
    flags = [p.requires_grad for p in params]
    model.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def make_adv_example_fn(model, cfg: RDAttackConfig,
                        mesh=None) -> Callable[[torch.Tensor, float], torch.Tensor]:
    """``adv_example(x, noise_threshold) -> im_adv`` for adversarial
    training (port of the JAX ``make_adv_example_fn``): the RD attack's loop
    on the batch ``x`` as one attack, with no evaluation.

    The input loss is the MSE over the whole batch, and one host ``if``
    picks the phase for every image: the input loss while it is over
    ``noise_threshold``, else ``1 - MSE`` of the quantization-free output
    (phase-space where the codec has an exact phase synthesis, unless
    ``cfg.phase_space_loss`` is False) against the clean one, over the
    whole batch.  Zero initial noise, Adam with the MultiStepLR schedule.
    It runs under ``frozen(model)``, and its result does not depend on
    whether the parameters require grad.

    With a ``mesh`` (``parallel/mesh.py``), ``x`` is this rank's block of
    a batch split over the mesh's ``dp`` axis and, where the mesh has an
    ``sp`` axis, of its rows split over ``sp`` (``H`` a multiple of ``sp x
    64``; the codec must be row-shardable).  The clean forward and the loop
    run under that shard (``ops/shard.py``), and both MSEs are the global
    batch's, summed over both axes, so the host ``if`` picks the same
    phase on every rank, as JAX's GSPMD program does on the whole batch.
    """
    if cfg.debug_model or cfg.random_restarts > 1:
        raise ValueError("make_adv_example_fn starts from zero noise: no debug_model, no restarts")
    supported = bool(getattr(model, "supports_phase_synthesis", False))
    use_phase = supported if cfg.phase_space_loss is None else cfg.phase_space_loss
    if use_phase and not supported:
        raise ValueError(
            f"phase_space_loss=True but {type(model).__name__} has no exact phase-space synthesis"
        )
    lrs = multistep_lr_schedule(cfg.steps, cfg.lr, cfg.lr_milgamma).tolist()
    eps = cfg.epsilon / 255.0
    dp = rows = None
    if mesh is not None:
        dp = shard.mesh_axis(mesh, "dp")
        if "sp" in (mesh.mesh_dim_names or ()):
            from ..parallel.spatial_shard import check_row_shardable

            rows = shard.mesh_axis(mesh, "sp")
            check_row_shardable(model)

    def batch_mean(t):
        if dp is None:
            return torch.mean(t)
        total, count = shard.all_sum(t.sum(), dp), t.numel() * dp.size
        if rows is not None:
            total, count = shard.all_sum(total, rows), count * rows.size
        return total / count

    def output(im):
        return model.g_s_phase(model.g_a(im)) if use_phase else model(im, quant_mode="none")["x_hat"]

    def loss_fn(x, output_s, noise, noise_threshold):
        im_in = bound_clip(x + bound_clip(noise, -eps, eps), 0.0, 1.0)
        loss_i = batch_mean((x - im_in) ** 2)
        if bool(loss_i > noise_threshold):
            return loss_i
        out = output(im_in)
        out = bound_clip(out, 0.0, 1.0) if cfg.clamp else out
        return 1.0 - batch_mean((output_s - out) ** 2)

    def adv_example(x: torch.Tensor, noise_threshold: float) -> torch.Tensor:
        if rows is not None and x.shape[2] % shard.ROW_MULTIPLE:
            raise ValueError(f"H={x.shape[2] * rows.size} must divide by "
                             f"sp*{shard.ROW_MULTIPLE}={rows.size * shard.ROW_MULTIPLE}")
        x = x.contiguous(memory_format=torch.channels_last)
        where = shard.sharded(dp, rows) if dp is not None else contextlib.nullcontext()
        with frozen(model), where:
            with torch.no_grad():
                result_s = model(x, quant_mode="dequantize")
                ref = (model.g_s_phase(result_s[model.phase_reference_latent]) if use_phase
                       else result_s["x_hat"])
                output_s = ref.clamp(0.0, 1.0) if cfg.clamp else ref
            noise = torch.zeros_like(x)
            opt = AdamOnNoise(noise)
            for lr in lrs:
                noise.requires_grad_(True)
                (grad,) = torch.autograd.grad(loss_fn(x, output_s, noise, noise_threshold), noise)
                noise = noise.detach()
                opt.step(noise, grad, lr)
        return bound_clip(x + bound_clip(noise, -eps, eps), 0.0, 1.0)

    return adv_example

"""The port's targeted / ROI attack (``attacks/targeted.py``) and patch
helpers (``attacks/patch.py``) vs the JAX package, on the CPU (hyper q1
demo weights, 64x64, 6 steps).

Exact: ``roi_masks`` (box rows ``y0:y1``, columns ``x0:x1``), the worst
patch's location and crops.  ``local_vi_map`` at atol 1e-5.  The attacks:
``im_`` atol 1e-5 with oneDNN off and 1e-4 with it on, ``vi`` abs 1e-3,
bpp rtol 1e-4.  Here the classifier branch is checked to steer a linear
stand-in's logits toward the label; its parity with the JAX package, through
the ported ``models/classifier.py`` and ``attack_cv --cls_ckpt``, is in
``tests/test_torch_classifier.py``.

``local_vi_map`` returns ratios mse_out / mse_in, which reach the hundreds
where the attack works: float32 resolves such values to ~1e-5 relative, so
the map is held at atol 1e-5 where its values are O(1), and at rtol 1e-5
on a map with a high-VI window (whose location is compared exactly).
"""

import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import TargetedAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import extract_worst_patch as j_extract
from imagecompression_adversarial_tpu.attacks import local_vi_map as j_local_vi_map
from imagecompression_adversarial_tpu.attacks import make_targeted_attack_fn as j_make
from imagecompression_adversarial_tpu.attacks import roi_masks as j_roi_masks
from imagecompression_adversarial_tpu_torch.attacks import (
    TargetedAttackConfig,
    extract_worst_patch,
    local_vi_map,
    make_targeted_attack_fn,
    roi_masks,
)
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BPP_RTOL, IM_ATOL, VI_ATOL, hyper_models, image, nchw, nhwc, one_torch_thread, onednn,
)

_JAX = {}
_W = np.random.RandomState(40).randn(3, 5).astype(np.float32)


def test_roi_masks_match_jax():
    box = (3, 11, 2, 7)  # x0, x1, y0, y1
    jt, jb = j_roi_masks((1, 9, 13, 3), box)
    t, b = roi_masks((1, 3, 9, 13), box)
    np.testing.assert_array_equal(nhwc(t), np.asarray(jt))
    np.testing.assert_array_equal(nhwc(b), np.asarray(jb))
    assert t[0, 0, 2:7, 3:11].eq(1).all() and t.sum() == 3 * 5 * 8


_CASES = {
    "roi L2": dict(mask_loc=(8, 40, 16, 48), lamb_bkg_out=0.5),
    "image L1": dict(att_metric="L1"),
    "untargeted": dict(),
}


def _logits(out):
    return out.mean(dim=(2, 3)) @ torch.tensor(_W)


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("case", list(_CASES))
def test_targeted_attack_matches_jax(case, enabled):
    jm, jp, model = hyper_models()
    x = image(41)
    target = None if case == "untargeted" else image(42)
    kw = dict(steps=6, **_CASES[case])
    if case not in _JAX:
        _JAX[case] = j_make(jm, JConfig(**kw))(jp, x, target)
    jres = _JAX[case]
    with onednn(enabled):
        res = make_targeted_attack_fn(model, TargetedAttackConfig(**kw))(
            nchw(x), None if target is None else nchw(target))
    im_ = nhwc(res["im_"])
    np.testing.assert_allclose(im_, np.asarray(jres["im_"]), atol=IM_ATOL[enabled], rtol=0)
    assert abs(res["vi"].item() - float(jres["vi"])) <= VI_ATOL
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=BPP_RTOL)
    for k in ("loss_i_final", "loss_o_final"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-4, atol=1e-7)
    assert np.abs(im_ - x).max() > 1e-3


def test_classifier_branch_steers_logits_toward_the_label():
    _, _, model = hyper_models()
    x = nchw(image(45))
    res = make_targeted_attack_fn(model, TargetedAttackConfig(steps=6, noise_threshold=1.0),
                                  classifier_logits_fn=_logits, target_label=3)(x)
    ce = [torch.nn.functional.cross_entropy(_logits(o), torch.tensor([3])).item()
          for o in (res["output_s"], res["output_"])]
    assert ce[1] < ce[0]


def test_targeted_switch_is_at_or_over_budget():
    """``loss_i >= noise_threshold`` selects the input loss (the RD attack
    switches on ``>``): with the budget at 0, the attack only ever reduces
    its input loss from zero noise and so never moves."""
    _, _, model = hyper_models()
    x = nchw(image(43))
    res = make_targeted_attack_fn(model, TargetedAttackConfig(steps=3, noise_threshold=0.0))(x)
    assert res["loss_i_final"].item() == 0.0
    torch.testing.assert_close(res["im_"], x, atol=0, rtol=0)


def _patch_inputs(window=0.2):
    rng = np.random.RandomState(44)
    im_s = rng.rand(1, 96, 80, 3).astype(np.float32)
    out_s = rng.rand(1, 96, 80, 3).astype(np.float32)
    im_adv = im_s + 0.01 * rng.randn(*im_s.shape).astype(np.float32)
    out_adv = out_s + 0.01 * rng.randn(*im_s.shape).astype(np.float32)
    out_adv[:, 50:66, 30:46] += window  # one window of high local VI
    return im_adv, out_adv, im_s, out_s


@pytest.mark.parametrize("window, atol, rtol", [(0.01, 1e-5, 0.0), (0.2, 0.0, 1e-5)])
def test_local_vi_map_matches_jax(window, atol, rtol):
    arrs = _patch_inputs(window)
    ref = np.asarray(j_local_vi_map(*arrs, patch=16, stride=2))
    got = local_vi_map(*(nchw(a) for a in arrs), patch=16, stride=2).numpy()
    assert got.shape == ref.shape == (41, 33)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)
    assert (got[:10] == 0).all() and (got[:, -10:] == 0).all()
    assert got.max() > (1.5 if window < 0.1 else 100.0)


def test_worst_patch_matches_jax():
    arrs = _patch_inputs()
    ref = j_extract(*arrs, patch=16, stride=2)
    got = extract_worst_patch(*(nchw(a) for a in arrs), patch=16, stride=2)
    np.testing.assert_array_equal(got["location"].numpy(), np.asarray(ref["location"]))
    assert tuple(got["location"].tolist()) == (50, 30)
    for k in ("patch_adv", "patch_outadv", "patch_s", "patch_outs"):
        np.testing.assert_array_equal(nhwc(got[k]), np.asarray(ref[k]))
    np.testing.assert_allclose(got["vi_value"].item(), float(ref["vi_value"]), rtol=1e-5)

"""The port's evaluation (``enerf_tpu_torch/eval``) vs ``enerf_tpu/eval`` on
the CPU: the metrics on seeded images, LPIPS-VGG on a seeded weights file
in the vgg16 layout, the numpy stand-ins for ``cv2.resize(INTER_NEAREST)``
and ``cv2.boundingRect``, and the validation slice as a whole — the
port's ``Trainer.val`` with its ``Evaluator`` over the default cascade
(planes (64, 8), both levels rendered, grid rays) at 64×96 against the
JAX eval forward (fused flags off) fed to the JAX ``Evaluator``, on the
same weights.

Tolerances: the metrics are the same numpy and scipy code on the same
float64 inputs (1e-12); LPIPS rtol 1e-4 (f32 convolutions in two
frameworks, as ``tests/test_perceptual.py``); the forward's outputs at the
tolerances of ``tests/test_torch_enerf.py`` (rtol 1e-3, atol 3e-4 on rgb
and weights, 3e-3 on depths and std); PSNR within 1e-3 dB and SSIM within
1e-5 per level, LPIPS rtol 1e-4, on those outputs."""

import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.eval import evaluator as j_evaluator
from enerf_tpu.eval import lpips_jax
from enerf_tpu.eval import metrics as j_metrics
from enerf_tpu.models.enerf import ENeRF as JENeRF
import enerf_tpu_torch.train.trainer as trainer_mod
from enerf_tpu_torch import build_model, render
from enerf_tpu_torch import config as pconfig
from enerf_tpu_torch.eval import evaluator, lpips, metrics
from enerf_tpu_torch.factory import make_evaluator
from enerf_tpu_torch.train.trainer import Trainer
from enerf_tpu_torch.utils.convert import load_flax_variables
from tests.test_torch_modules import seeded_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)


def _images(seed, shape=(32, 48, 3)):
    rng = np.random.RandomState(seed)
    gt = rng.rand(*shape).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    mask = rng.rand(*shape[:2]) > 0.3
    return gt, pred, mask


@pytest.mark.parametrize("metric", ["psnr", "psnr_masked", "ssim",
                                    "ssim_gray", "depth"])
def test_metrics_match_jax(metric):
    gt, pred, mask = _images(1)
    calls = {
        "psnr": lambda m: m.psnr(gt, pred),
        "psnr_masked": lambda m: m.psnr_masked(gt, pred, mask),
        "ssim": lambda m: m.ssim(gt, pred),
        "ssim_gray": lambda m: m.ssim(gt[..., 0], pred[..., 0]),
        "depth": lambda m: m.depth_metrics(pred[..., 0] * 20,
                                           gt[..., 0] * 20 * mask),
    }
    out, ref = calls[metric](metrics), calls[metric](j_metrics)
    if metric == "depth":
        assert set(out) == set(ref)
        out, ref = [out[k] for k in sorted(out)], [ref[k] for k in sorted(ref)]
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_lpips_matches_jax(tmp_path):
    path = str(tmp_path / "lpips_vgg.npz")
    lpips.write_seeded_weights(path, seed=3)
    rng = np.random.RandomState(4)
    pred = rng.rand(2, 32, 48, 3).astype(np.float32) * 2 - 1
    gt = rng.rand(2, 32, 48, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(lpips_jax.lpips(jnp.asarray(pred), jnp.asarray(gt),
                                     lpips_jax.load_lpips_params(path)))
    net = lpips.load_lpips(path, device="cpu")
    with torch.no_grad():
        out = net(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=0)
    assert lpips.load_lpips(str(tmp_path / "absent.npz")) is None


@pytest.mark.parametrize("src,dst", [((64, 80), (16, 20)), ((64, 80), (48, 60)),
                                     ((37, 53), (11, 29)), ((16, 20), (64, 80)),
                                     ((30, 45), (30, 45)), ((7, 9), (3, 13))])
def test_resize_nearest_matches_cv2(src, dst):
    img = np.random.RandomState(sum(src + dst)).rand(*src).astype(np.float32)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(evaluator.resize_nearest(img, dst), ref)


@pytest.mark.parametrize("case", ["box", "scattered", "edge", "empty", "one"])
def test_bounding_rect_matches_cv2(case):
    rng = np.random.RandomState(5)
    m = np.zeros((40, 56), np.uint8)
    if case == "box":
        m[7:31, 11:40] = 1
    elif case == "scattered":
        m[rng.rand(40, 56) > 0.97] = 1
    elif case == "edge":
        m[30:, 50:] = 1
        m[0, 3] = 1
    elif case == "one":
        m[12, 17] = 1
    assert evaluator.bounding_rect(m) == tuple(cv2.boundingRect(m))


@pytest.mark.parametrize("module", ["evaluator", "evaluator_human",
                                    "evaluator_composite"])
def test_evaluators_match_jax(module, capsys):
    """Each port evaluator vs the JAX one of the same module on the same
    seeded outputs of a batch of 2 at 32x48, both levels rendered: the same
    ``summarize()`` dict and the same printed per-scene lines. The base
    evaluator with ``eval_depth`` on two MVSNeRF scenes (its depth metrics,
    the mvs depth's nearest resize), the human one with a mask that leaves
    its window (its bounding-rectangle crop and warning); no LPIPS."""
    import importlib

    jmod = importlib.import_module(f"enerf_tpu.eval.{module}")
    rng = np.random.RandomState(8)
    Hs, Ws, B = 32, 48, 2
    kw = dict(eval_depth=module == "evaluator",
              mask_window_hw=(16, 16) if module == "evaluator_human" else None)
    jcfg = Config(eval_lpips=False, enerf=ENeRFConfig(
        test_input_views=2, train_input_views=(2,), **kw,
        cas_config=CascadeConfig(render_if=(True, True))))
    cfg = pconfig.Config(eval_lpips=False,
                         evaluator_module=f"enerf_tpu.eval.{module}",
                         enerf=pconfig.ENeRFConfig(
                             test_input_views=2, train_input_views=(2,), **kw))
    batch = make_synthetic_batch(jcfg, H=Hs, W=Ws, batch_size=B)
    batch["meta"] = {"scene": ["scan1", "scan114"]}
    batch["tar_dpt"] = (500 + 300 * rng.rand(B, Hs * Ws)).astype(np.float32)
    mask = np.zeros((B, Hs, Ws), np.float32)
    mask[0, 5:27, 9:30] = 1
    mask[1, 2:11, 40:47] = 1
    batch["mask_at_box"] = mask.reshape(B, -1)
    out = {}
    for i, (h, w) in enumerate(((Hs // 4, Ws // 4), (Hs, Ws))):
        gt = batch[f"rgb_{i}"]
        out[f"rgb_level{i}"] = np.clip(gt + 0.05 * rng.randn(*gt.shape), 0,
                                       1).astype(np.float32)
        out[f"depth_level{i}"] = (500 + 300 * rng.rand(B, h * w)).astype(
            np.float32)
        out[f"depth_mvs_level{i}"] = (500 + 300 * rng.rand(
            B, h // 2, w // 2)).astype(np.float32)
    capsys.readouterr()
    jev = jmod.Evaluator(jcfg)
    jev.evaluate(out, batch)
    jres = jev.summarize()
    jprinted = capsys.readouterr().out
    ev = make_evaluator(cfg, device="cpu")
    assert type(ev).__module__ == f"enerf_tpu_torch.eval.{module}"
    ev.evaluate(out, batch)
    res = ev.summarize()
    printed = capsys.readouterr().out
    assert res.keys() == jres.keys()
    for k in res:
        np.testing.assert_allclose(res[k], jres[k], rtol=0, atol=1e-12)
    assert printed == jprinted
    assert ("scan1_level1" in printed
            and ("WARNING" in printed) == (module == "evaluator_human")
            and ("acc_2" in printed) == (module == "evaluator"))


def test_save_result_raises(tmp_path):
    """``save_result`` is ported (``tests/test_torch_visualize.py`` holds
    the PNGs to JAX's): the evaluator makes ``result_dir`` at init, and
    raises there when it cannot, not after a frame's work."""
    cfg = pconfig.replace(pconfig.Config(), save_result=True,
                          workspace=str(tmp_path))
    make_evaluator(cfg, device="cpu")
    assert os.path.isdir(cfg.result_dir)
    (tmp_path / "file").write_text("")
    cfg = pconfig.replace(cfg, workspace=str(tmp_path / "file"))
    with pytest.raises(OSError):
        make_evaluator(cfg, device="cpu")


class _Recorder:
    def __init__(self):
        self.step = 0
        self.updates = []

    def update(self, stats):
        self.updates.append(dict(stats))

    def record(self, prefix):
        pass


# the outputs of both levels (tests/test_torch_enerf.py's tolerances)
ATOL = {f"{k}_level{i}": a for i in (0, 1) for k, a in (
    ("rgb", 3e-4), ("weights", 3e-4), ("depth", 3e-3), ("depth_mvs", 3e-3),
    ("std", 3e-3))}


def test_val_slice_matches_jax(tmp_path, monkeypatch, capsys):
    """The validation of the default cascade, end to end: the port's
    ``Trainer.val`` over one batch with ``make_evaluator(cfg)`` (LPIPS
    from a seeded ``data/lpips_vgg.npz`` in the working directory, as both
    packages find it) vs the JAX eval forward and ``Evaluator``."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    lpips.write_seeded_weights(str(tmp_path / lpips.DEFAULT_WEIGHTS), seed=6)
    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True,
        cas_config=CascadeConfig(num=2, volume_planes=(64, 8),
                                 num_samples=(8, 2), render_if=(True, True))))
    cfg = pconfig.Config(enerf=pconfig.ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True))
    cas = cfg.enerf.cas_config
    assert (cas.volume_planes, cas.num_samples, cas.render_if,
            cas.nerf_model_feat_ch) == ((64, 8), (8, 2), (True, True), (32, 8))
    batch = make_synthetic_batch(jcfg, H=64, W=96, n_src=3, seed=2)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JENeRF(cfg=jcfg.enerf, train_mode=False)
    variables = seeded_variables(jmodel, np.random.RandomState(7), jb)
    ref = {k: np.asarray(v) for k, v in jax.jit(jmodel.apply)(variables,
                                                              jb).items()}
    jev = j_evaluator.Evaluator(jcfg)
    jev.evaluate(ref, batch)
    j_scenes = (dict(jev.scene_psnrs), dict(jev.scene_ssims),
                dict(jev.scene_lpips))
    jres = jev.summarize()

    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    ev = make_evaluator(cfg, device="cpu")
    assert type(ev) is evaluator.Evaluator
    scenes = []
    summarize = ev.summarize
    monkeypatch.setattr(ev, "summarize", lambda: (scenes.append((
        dict(ev.scene_psnrs), dict(ev.scene_ssims), dict(ev.scene_lpips))),
        summarize())[1])
    outputs = []      # what Trainer.val renders, kept for the comparison
    monkeypatch.setattr(trainer_mod, "render", lambda m, b: outputs.append(
        render(m, b)) or outputs[-1])
    rec = _Recorder()
    result = Trainer(cfg, train_step=None, recorder=rec).val(
        0, types.SimpleNamespace(model=model), [batch], evaluator=ev)
    assert model.training      # val renders in eval mode, then restores it

    out = {k: v.numpy() for k, v in outputs[0].items()}
    assert set(out) == set(ref) == set(ATOL)
    for k, atol in ATOL.items():
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-3, atol=atol,
                                   err_msg=k)
    assert set(jres) == {"psnr", "ssim", "lpips"} <= set(result)
    assert rec.updates == [result]
    (psnrs, ssims, lps), = scenes
    assert set(psnrs) == set(j_scenes[0]) == {"scene_level0", "scene_level1"}
    for key in psnrs:
        np.testing.assert_allclose(psnrs[key], j_scenes[0][key], atol=1e-3)
        np.testing.assert_allclose(ssims[key], j_scenes[1][key], atol=1e-5)
        np.testing.assert_allclose(lps[key], j_scenes[2][key], rtol=1e-4)
    np.testing.assert_allclose(result["psnr"], jres["psnr"], atol=1e-3)
    np.testing.assert_allclose(result["ssim"], jres["ssim"], atol=1e-5)
    np.testing.assert_allclose(result["lpips"], jres["lpips"], rtol=1e-4)
    for i in (0, 1):    # Trainer.val's own per-level stats
        mse = np.mean((ref[f"rgb_level{i}"] - batch[f"rgb_{i}"]) ** 2)
        np.testing.assert_allclose(result[f"psnr_{i}"], -10 * np.log10(mse),
                                   atol=1e-3)
    printed = capsys.readouterr().out
    assert "scene_level0" in printed and "scene_level1" in printed

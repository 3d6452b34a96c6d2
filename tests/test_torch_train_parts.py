"""The pieces of the port's training around the step, on the CPU:

- VGG16 perceptual loss: block features and the loss vs
  ``enerf_tpu/train/vgg.py`` with seeded random weights in the npz layout
  both read, at 32×32; and the full ``compute_loss`` with it vs
  ``enerf_tpu/train/loss.py``. Tolerance rtol 1e-4 / atol 1e-4 on the
  features (ten 3×3 convs, summed in another order by XLA's and PyTorch's
  CPU convolutions), rtol 1e-5 on the losses (means over those features).
- The three learning-rate schedules vs ``make_lr_schedule``, rtol 1e-6
  (the JAX schedules compute in f32), and the optimizer's learning rate
  after k scheduler steps.
- Checkpoints: save, resume into a fresh state, and a next step that is
  bit-identical to an uninterrupted run; the retention of 5 numbered files;
  weights-only loads from a directory, from one ``.pth`` file and as a
  warm start from another experiment.
- The trainer's epoch loop and validation, and the recorder's log.
"""

import json
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enerf_tpu_torch as et
from enerf_tpu.config import CascadeConfig as JCascadeConfig
from enerf_tpu.config import ENeRFConfig as JENeRFConfig
from enerf_tpu.config import SchedulerConfig as JSchedulerConfig
from enerf_tpu.train.loss import compute_loss as j_compute_loss
from enerf_tpu.train.schedule import make_lr_schedule as j_make_lr_schedule
from enerf_tpu.train.vgg import load_vgg16_params as j_load_vgg16_params
from enerf_tpu.train.vgg import vgg16_block_features as j_block_features
from enerf_tpu.train.vgg import vgg_perceptual_loss as j_perceptual_loss
from enerf_tpu_torch import config as pc
from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
from enerf_tpu_torch.train import (
    Recorder,
    Trainer,
    create_train_state,
    load_model,
    load_network,
    load_pretrain,
    make_train_step,
    save_model,
)
from enerf_tpu_torch.train.loss import compute_loss
from enerf_tpu_torch.train.schedule import make_lr_schedule
from enerf_tpu_torch.train.vgg import (
    VGG16Blocks,
    load_vgg16_params,
    vgg_perceptual_loss,
)
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

H = W = 32


def tiny_cfg(workspace=".", **cas):
    return pc.Config(
        enerf=pc.ENeRFConfig(test_input_views=2, train_input_views=(2,),
                             grid_rays=True,
                             cas_config=pc.CascadeConfig(
                                 num=2, volume_planes=(16, 8), **cas)),
        train=pc.TrainConfig(lr=1e-3), ep_iter=10, workspace=str(workspace))


def train_batch(cfg, seed=0):
    b = make_synthetic_batch(cfg, H=H, W=W, split="train", seed=seed)
    b.pop("tar_img")
    return b


# ---------------------------------------------------------------- VGG


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """Seeded random VGG16 feature weights, torchvision layout (He-scaled so
    the activations stay O(1) through the four blocks)."""
    rng = np.random.RandomState(0)
    arrays = {}
    for k, v in VGG16Blocks().state_dict().items():
        if k.endswith("weight"):
            fan_in = v[0].numel()
            arrays[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        else:
            arrays[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
    path = tmp_path_factory.mktemp("vgg") / "vgg16_features.npz"
    np.savez(path, **arrays)
    return str(path)


def test_vgg_features_and_loss_match_jax(vgg_npz):
    rng = np.random.RandomState(1)
    pred = rng.rand(2, H, W, 3).astype(np.float32)
    tar = rng.rand(2, H, W, 3).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in j_load_vgg16_params(vgg_npz).items()}
    vgg = load_vgg16_params(vgg_npz, device="cpu")
    assert not any(p.requires_grad for p in vgg.parameters())
    with torch.no_grad():
        feats = vgg(torch.from_numpy(pred))
    ref = j_block_features(jnp.asarray(pred), jparams)
    assert len(feats) == len(ref) == 4
    for f, r in zip(feats, ref):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)
    loss = vgg_perceptual_loss(torch.from_numpy(pred), torch.from_numpy(tar),
                               vgg)
    np.testing.assert_allclose(
        float(loss), float(j_perceptual_loss(jnp.asarray(pred),
                                             jnp.asarray(tar), jparams)),
        rtol=1e-5)


def test_vgg_absent_file_is_none(tmp_path):
    assert load_vgg16_params(str(tmp_path / "missing.npz"), device="cpu") is None


def test_compute_loss_with_vgg_matches_jax(vgg_npz):
    cfg = tiny_cfg()
    jcfg = JENeRFConfig(test_input_views=2, train_input_views=(2,),
                        cas_config=JCascadeConfig(num=2, volume_planes=(16, 8)))
    rng = np.random.RandomState(2)
    out = {f"rgb_level{i}": rng.rand(1, n, 3).astype(np.float32)
           for i, n in ((0, (H // 4) * (W // 4)), (1, H * W))}
    batch = {f"rgb_{i}": rng.rand(*out[f"rgb_level{i}"].shape).astype(
        np.float32) for i in range(2)}
    jparams = {k: jnp.asarray(v) for k, v in j_load_vgg16_params(vgg_npz).items()}
    _, jstats = j_compute_loss({k: jnp.asarray(v) for k, v in out.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jcfg, (H, W), jparams)
    vgg = load_vgg16_params(vgg_npz, device="cpu")
    loss, stats = compute_loss({k: torch.from_numpy(v) for k, v in out.items()},
                               {k: torch.from_numpy(v) for k, v in batch.items()},
                               cfg.enerf, (H, W), vgg)
    assert set(stats) == set(jstats)
    assert "perceptual_loss_1" in stats
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------- schedules

SCHEDS = {
    "exponential": dict(type="exponential", gamma=0.5, decay_epochs=50),
    "multi_step": dict(type="multi_step", gamma=0.5, milestones=(3, 8, 20)),
    "warmup_multi_step": dict(type="warmup_multi_step", gamma=0.1,
                              milestones=(8, 20), warmup_factor=1.0 / 3,
                              warmup_iters=5),
}
STEPS = (0, 1, 9, 10, 11, 29, 30, 49, 50, 79, 80, 199, 200, 499, 500, 1000,
         5000)


@pytest.mark.parametrize("kind", list(SCHEDS))
def test_lr_schedule_matches_jax(kind):
    ep_iter = 10
    fn = make_lr_schedule(5e-4, pc.SchedulerConfig(**SCHEDS[kind]), ep_iter)
    ref = j_make_lr_schedule(5e-4, JSchedulerConfig(**SCHEDS[kind]), ep_iter)
    for s in STEPS:
        np.testing.assert_allclose(fn(s), float(ref(s)), rtol=1e-6,
                                   err_msg=f"{kind} step {s}")
    # the optimizer sees the schedule's rate at every step
    cfg = replace(tiny_cfg(), ep_iter=ep_iter, train=pc.TrainConfig(
        lr=5e-4, scheduler=pc.SchedulerConfig(**SCHEDS[kind])))
    state = create_train_state(cfg, torch.nn.Linear(2, 2))
    for s in range(0, 120):
        assert state.step == s
        np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"],
                                   fn(s), rtol=1e-12)
        state.optimizer.step()
        state.scheduler.step()


# -------------------------------------------------------- checkpoints


def _fresh(cfg, seed):
    return create_train_state(cfg, et.build_model(cfg, device="cpu", seed=seed,
                                                  train=True))


def test_checkpoint_resume_is_bit_identical(tmp_path):
    torch.manual_seed(0)
    cfg = tiny_cfg(tmp_path)
    batches = [train_batch(cfg, seed) for seed in (1, 2)]
    step = make_train_step(cfg, (H, W))

    straight = _fresh(cfg, seed=0)
    for b in batches:
        straight, _ = step(straight, b)

    first = _fresh(cfg, seed=0)
    first, _ = step(first, batches[0])
    rec = Recorder(cfg, resume=False)
    rec.step = 7
    model_dir = cfg.trained_model_dir
    save_model(model_dir, first, epoch=0, recorder=rec)
    save_model(model_dir, first, epoch=0, recorder=rec, last=True)
    assert sorted(os.listdir(model_dir)) == ["0.pth", "latest.pth"]

    resumed = _fresh(cfg, seed=5)                 # other weights to start
    rec2 = Recorder(cfg)
    assert load_model(model_dir, resumed, rec2) == 1
    assert rec2.step == 7 and resumed.step == 1
    resumed, _ = step(resumed, batches[1])

    sd_a, sd_b = straight.model.state_dict(), resumed.model.state_dict()
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    for pa, pb in zip(straight.optimizer.state.values(),
                      resumed.optimizer.state.values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert resumed.optimizer.param_groups[0]["lr"] == \
        straight.optimizer.param_groups[0]["lr"]


def test_checkpoint_retention_and_weight_loads(tmp_path):
    cfg = replace(tiny_cfg(tmp_path), pretrain="other_exp")
    state = _fresh(cfg, seed=0)
    other_dir = os.path.join(str(tmp_path), "trained_model", cfg.task,
                             "other_exp")
    for epoch in range(8):
        save_model(other_dir, state, epoch)
    assert sorted(os.listdir(other_dir)) == [f"{e}.pth" for e in range(3, 8)]
    assert load_model(other_dir, _fresh(cfg, 1), resume=False) == 0
    assert load_model(str(tmp_path / "none"), _fresh(cfg, 1)) == 0

    ref = state.model.state_dict()

    def same(model):
        return all(torch.equal(v, model.state_dict()[k]) for k, v in ref.items())

    m = et.build_model(cfg, device="cpu", seed=3)
    assert not same(m)
    assert load_network(m, other_dir) == 8 and same(m)
    m = et.build_model(cfg, device="cpu", seed=3)
    assert load_network(m, other_dir, epoch=4) == 5 and same(m)
    # a reference-style file: {'net': state dict, 'epoch': ...}
    path = str(tmp_path / "reference.pth")
    torch.save({"net": ref, "epoch": 41}, path)
    m = et.build_model(cfg, device="cpu", seed=3)
    assert load_network(m, path) == 42 and same(m)
    m = et.build_model(cfg, device="cpu", seed=3)
    assert load_pretrain(cfg, m) and same(m)
    assert not load_pretrain(replace(cfg, pretrain=""), m)


# ------------------------------------------------------------ trainer


def test_trainer_epoch_and_val(tmp_path, capsys):
    cfg = replace(tiny_cfg(tmp_path), ep_iter=2, record_interval=1)
    state = _fresh(cfg, seed=0)
    trainer = Trainer(cfg, make_train_step(cfg, (H, W)),
                      Recorder(cfg, resume=False))
    p0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = trainer.train_epoch(0, state, [train_batch(cfg, s) for s in range(3)])
    assert state.step == 2 and trainer.recorder.step == 2
    assert any(not torch.equal(p0[k], v)
               for k, v in state.model.state_dict().items())
    log = capsys.readouterr().out
    assert log.count("eta: ") == 2 and "epoch: 0  step: 2" in log
    assert "lr: 0.001000" in log

    test_batch = make_synthetic_batch(cfg, H=H, W=W, split="test")
    result = trainer.val(0, state, [test_batch])
    assert state.model.training
    assert set(result) == {"color_mse_0", "psnr_0", "color_mse_1", "psnr_1"}
    assert all(np.isfinite(v) for v in result.values())
    with open(os.path.join(cfg.record_dir, "scalars.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [1, 2, 2]
    assert "train/loss" in lines[0] and "val/psnr_1" in lines[-1]


def test_train_mode_routes_around_the_eval_kernels(monkeypatch):
    """In training mode the model calls the differentiable plain cost
    volume and render stage; in eval mode the kernel wrappers; depth
    regression goes through its autograd Function in both."""
    import enerf_tpu_torch.models.enerf as enerf_mod
    import enerf_tpu_torch.ops.depth as depth_mod

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(enerf_mod if name != "depth" else depth_mod,
                            {"cv": "build_cost_volume", "render": "render_rays",
                             "depth": "kernel_depth_regression"}[name],
                            wrapped)

    spy("cv", enerf_mod.build_cost_volume)
    spy("render", enerf_mod.render_rays)
    spy("depth", depth_mod.kernel_depth_regression)
    cfg = tiny_cfg()
    model = et.build_model(cfg, device="cpu", train=True)
    assert model.training
    out = model(et.to_device(train_batch(cfg), "cpu"))
    assert calls == ["depth", "depth"]
    out["rgb_level1"].sum().backward()
    assert model.feature_net.conv0[0].conv.weight.grad is not None
    calls.clear()
    et.render(model.eval(), make_synthetic_batch(cfg, H=H, W=W))
    assert calls == ["cv", "depth", "render", "cv", "depth", "render"]

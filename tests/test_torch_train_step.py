"""The port's train step vs the JAX package's on the CPU: one step of the
two-level cascade at 32×32 (``tests/test_train_step.py``'s ``tiny_cfg``
with ``grid_rays``), once with ``train_img (True, True)`` (both levels
render the full image through the grid paths) and once with
``(False, False)`` and ``num_rays`` (random rays, gathered bounds and
volume features). Seeded weights in the JAX model's variable layout, with
random BN running statistics, are carried across; both sides get the same
numpy batch.

The JAX side is its own step (``enerf_tpu/train/step.py``) written out in
one jit: ``model.apply`` in train mode with ``mutable=["batch_stats"]``,
``compute_loss`` (``vgg_params=None``), ``jax.grad``, and the optimizer of
``make_optimizer`` through ``apply_gradients``; ``train_render_chunk=0``.

Tolerances:
- loss: rtol 1e-5 (f32, the same function; the two frameworks sum in
  another order);
- gradients: cosine ≥ 0.999 for every parameter (the worst is printed); a
  parameter whose JAX gradient is below 1e-7 everywhere has one below
  1e-6 in the port, or none;
- parameters after one Adam step: within 2·lr of each other everywhere,
  and beyond 0.1·lr on under 0.5 % of entries — Adam's first step moves a
  parameter by ≈ lr·sign(g), so a gradient near 0 may take the other sign
  (the bound of ``tests/test_train_step.py``);
- BN running statistics after the step's one train-mode forward: rtol
  1e-4, atol 1e-5. Flax updates the running variance with the biased
  batch variance, torch with the unbiased one; the test scales flax's
  batch term by n/(n−1), n the elements per channel of that BN's input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig, TrainConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.models.enerf import ENeRF as JENeRF
from enerf_tpu.train.loss import compute_loss as j_compute_loss
from enerf_tpu.train.state import create_train_state as j_create_train_state
from enerf_tpu_torch import build_model
from enerf_tpu_torch import config as pc
from enerf_tpu_torch.train import create_train_state, make_train_step
from enerf_tpu_torch.utils.convert import (
    flax_leaves_by_param,
    flax_state_dict,
    load_flax_variables,
)
from tests.test_torch_modules import randomize_batch_stats, to_numpy_tree

H = W = 32
LR = 1e-3
CASES = {"grid": dict(train_img=(True, True)),
         "random_rays": dict(train_img=(False, False), num_rays=(32, 128))}


def configs(case):
    cas = dict(num=2, volume_planes=(16, 8), **CASES[case])
    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=2, train_input_views=(2,), grid_rays=True,
        train_render_chunk=0, cas_config=CascadeConfig(**cas)),
        train=TrainConfig(lr=LR), ep_iter=10)
    pcfg = pc.Config(enerf=pc.ENeRFConfig(
        test_input_views=2, train_input_views=(2,), grid_rays=True,
        cas_config=pc.CascadeConfig(**cas)),
        train=pc.TrainConfig(lr=LR), ep_iter=10)
    return jcfg, pcfg


def jax_step(jcfg):
    """One JAX train step as ``make_train_step`` takes it, also returning
    the gradients and the mutated BN statistics."""
    model = JENeRF(cfg=jcfg.enerf, train_mode=True)

    def run(variables, batch):
        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, mutable=["batch_stats"])
            loss, stats = j_compute_loss(out, batch, jcfg.enerf, (H, W), None)
            return loss, (stats, mut["batch_stats"])

        grads, (stats, bs) = jax.grad(loss_fn, has_aux=True)(
            variables["params"])
        state = j_create_train_state(jcfg, variables).apply_gradients(
            grads=grads)
        return stats, grads, state.params, bs

    return model, jax.jit(run)


def seeded_variables(jmodel, batch, rng):
    """Seeded weights in the shape of the JAX model's variables (its init
    traced, not compiled): kernels N(0, 1/fan_in), biases and BN shifts
    0.1·N(0, 1), BN scales 1 + 0.1·N(0, 1), random BN running statistics."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.randn(*leaf.shape) * np.sqrt(1.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                       # bias; BN mean / var are set below
            v = 0.1 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    variables = to_numpy_tree(jax.tree_util.tree_map_with_path(fill, shapes))
    return randomize_batch_stats(variables, rng)


@pytest.fixture(scope="module", params=list(CASES))
def step_pair(request):
    """Both steps on the same inputs; the JAX step compiled once per case."""
    case = request.param
    jcfg, pcfg = configs(case)
    batch = make_synthetic_batch(jcfg, H=H, W=W, split="train", seed=1)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, run = jax_step(jcfg)
    variables = seeded_variables(jmodel, jb, np.random.RandomState(0))
    stats, grads, params, bs = jax.tree_util.tree_map(np.asarray,
                                                      run(variables, jb))

    model = load_flax_variables(build_model(pcfg, device="cpu", train=True),
                                variables)
    n_per_channel = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: n_per_channel.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    state = create_train_state(pcfg, model)
    state, pstats = make_train_step(pcfg, (H, W))(state, batch)
    # p.grad after the step holds this step's (clipped) gradients
    grads_port = {k: p.grad for k, p in model.named_parameters()}
    return dict(case=case, variables=variables, jstats=stats, jgrads=grads,
                jparams=params, jbs=bs, pstats=pstats, pgrads=grads_port,
                model=model, n=n_per_channel)


def test_loss_matches(step_pair):
    js, ps = step_pair["jstats"], step_pair["pstats"]
    assert set(js) == set(ps)
    for k in js:
        np.testing.assert_allclose(float(ps[k]), float(js[k]), rtol=1e-5,
                                   err_msg=k)


def test_gradients_match(step_pair):
    model = step_pair["model"]
    ref = flax_leaves_by_param(model, step_pair["jgrads"])
    assert set(ref) == {k for k, _ in model.named_parameters()}
    worst = (2.0, None)
    for k, g_ref in ref.items():
        g_ref = np.clip(g_ref, -40.0, 40.0)         # the step's clip
        g = step_pair["pgrads"][k]
        if np.abs(g_ref).max() < 1e-7:
            # no gradient in JAX (or one that is 0 but for rounding, as the
            # bias of the color logits, which a softmax over views cancels)
            assert g is None or float(g.abs().max()) < 1e-6, k
            continue
        assert g is not None, k
        g = g.numpy().ravel()
        cos = float(np.dot(g, g_ref.ravel())
                    / (np.linalg.norm(g) * np.linalg.norm(g_ref)))
        worst = min(worst, (cos, k))
    print(f"{step_pair['case']}: worst gradient cosine {worst[0]:.6f} "
          f"({worst[1]})")
    assert worst[0] >= 0.999, worst


def test_adam_update_matches(step_pair):
    model = step_pair["model"]
    ref = flax_leaves_by_param(model, step_pair["jparams"])
    before = flax_leaves_by_param(model, step_pair["variables"]["params"])
    port = {k: p.detach().numpy() for k, p in model.named_parameters()}
    diff = np.concatenate([np.abs(port[k] - ref[k]).ravel() for k in port])
    moved = np.concatenate([np.abs(port[k] - before[k]).ravel()
                            for k in port])
    assert moved.max() > 0.5 * LR                  # the step did move them
    assert diff.max() <= 2 * LR + 1e-6, diff.max()
    assert np.mean(diff > 0.1 * LR) < 0.005, np.mean(diff > 0.1 * LR)


def test_bn_running_stats_match(step_pair):
    model = step_pair["model"]
    old = flax_state_dict({"batch_stats": step_pair["variables"]["batch_stats"]})
    new = flax_state_dict({"batch_stats": step_pair["jbs"]})
    buffers = dict(model.named_buffers())
    stat_keys = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * len(step_pair["n"])
    for k in stat_keys:
        expect = new[k]
        if k.endswith("running_var"):
            n = step_pair["n"][k.rsplit(".", 1)[0]]
            expect = 0.9 * old[k] + (new[k] - 0.9 * old[k]) * n / (n - 1)
        np.testing.assert_allclose(buffers[k].numpy(), expect, rtol=1e-4,
                                   atol=1e-5, err_msg=k)

"""The port's data parallelism on the CPU: gloo ranks spawned by
``enerf_tpu_torch.parallel.spawn_ranks`` (one torch thread a rank; the
ranks run ``tests/torch_ranks.py``, which imports no JAX, and each reports
that nothing of JAX was loaded).

- The synced BN (``models/layers.py``) over 2 ranks against one process's
  ``nn.BatchNorm2d`` / ``nn.BatchNorm3d`` on the whole batch, whose
  channels sit at offsets near 100: outputs rtol 1e-5 / atol 1e-5; input
  and parameter gradients (the ranks' summed) at cosine ≥ 0.99999;
  running statistics rtol 1e-5.
- The DDP train step (``train/step.py:wrap_ddp``), 2 ranks of batch 1 on
  ``tests/test_torch_train_step.py``'s 32x32 ``grid`` case, against the
  port's one-process step on the batch of 2: loss rtol 1e-5; gradients at
  cosine ≥ 0.9999; BN running statistics rtol 1e-4 / atol 1e-5;
  parameters after Adam within that file's bound (2·lr everywhere, beyond
  0.1·lr on under 0.5 % of entries); and against the JAX package's
  ``make_train_step`` on a 2-device mesh (``make_mesh``, ``shard_batch``,
  ``replicate_state``): loss rtol 1e-5, parameters within the same bound.
- The ray-split render (``make_sharded_render_step``), 2 ranks at
  ``tests/test_sharded_render.py``'s config, against the JAX package's
  ``make_sharded_render_step`` on a 2-device mesh, to the port's
  end-to-end tolerances (rtol 1e-3; atol 3e-4 on rgb and weights, 3e-3 on
  depths and std).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.models.enerf import ENeRF as JENeRF
from enerf_tpu.parallel.mesh import make_mesh, shard_batch
from enerf_tpu.train.state import create_train_state as j_create_train_state
from enerf_tpu.train.step import make_sharded_render_step as j_sharded_render
from enerf_tpu.train.step import make_train_step as j_make_train_step
from enerf_tpu.train.step import replicate_state
from enerf_tpu_torch import build_model
from enerf_tpu_torch import config as pc
from enerf_tpu_torch.parallel import spawn_ranks
from enerf_tpu_torch.train import create_train_state, make_train_step
from enerf_tpu_torch.utils.convert import flax_leaves_by_param, load_flax_variables
from tests import torch_ranks
from tests.test_torch_composite import FAST_COMPILE
from tests.test_torch_train_step import H, LR, W, configs, seeded_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

WORLD = 2
E2E_ATOL = {"rgb": 3e-4, "weights": 3e-4, "depth": 3e-3, "depth_mvs": 3e-3,
            "std": 3e-3}


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def weights_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def assert_adam_bound(port, ref, before):
    """``tests/test_torch_train_step.py``'s bound on one Adam step."""
    diff = np.concatenate([np.abs(port[k] - ref[k]).ravel() for k in port])
    moved = np.concatenate([np.abs(port[k] - before[k]).ravel() for k in port])
    assert moved.max() > 0.5 * LR
    assert diff.max() <= 2 * LR + 1e-6, diff.max()
    assert np.mean(diff > 0.1 * LR) < 0.005, np.mean(diff > 0.1 * LR)


@pytest.fixture(scope="module")
def bn_cases():
    """BN2d and BN3d inputs, one spawn of 2 ranks for both."""
    rng = np.random.RandomState(0)
    cases = {}
    for kind, shape in (("2d", (4, 8, 6, 5)), ("3d", (2, 4, 3, 6, 5))):
        x = torch_ranks.seeded_batch(shape, rng.randint(1 << 30))
        dy = rng.randn(*shape).astype(np.float32)
        w = (1.0 + 0.1 * rng.randn(shape[1])).astype(np.float32)
        b = (0.1 * rng.randn(shape[1])).astype(np.float32)
        cases[kind] = (x, dy, w, b)
    ranks = spawn_ranks(torch_ranks.synced_bn, WORLD, (list(cases.values()),))
    return {kind: (cases[kind], [r[i] for r in ranks])
            for i, kind in enumerate(cases)}


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_synced_bn_matches_one_process(bn_cases, kind):
    (x, dy, w, b), ranks = bn_cases[kind]
    bn = (torch.nn.BatchNorm2d if kind == "2d" else torch.nn.BatchNorm3d)(
        x.shape[1], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(dy))
    assert all(r["loaded"] == [] for r in ranks)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               y.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert cosine(np.concatenate([r["dx"] for r in ranks]),
                  xt.grad.numpy()) >= 0.99999
    for name, p in bn.named_parameters():
        assert cosine(sum(r["grads"][name] for r in ranks),
                      p.grad.numpy()) >= 0.99999, name
    for name in ("running_mean", "running_var"):
        for r in ranks:
            np.testing.assert_allclose(r["buffers"][name],
                                       getattr(bn, name).numpy(), rtol=1e-5,
                                       err_msg=name)


@pytest.fixture(scope="module")
def ddp_pair():
    """The grid case's batch of 2: seeded weights in the JAX layout, the
    DDP step over 2 ranks and the port's one-process step from them."""
    jcfg, pcfg = configs("grid")
    batch = make_synthetic_batch(jcfg, H=H, W=W, split="train", seed=1,
                                 batch_size=WORLD)
    batch.pop("tar_img")
    jmodel = JENeRF(cfg=jcfg.enerf, train_mode=True)
    variables = seeded_variables(
        jmodel, {k: jnp.asarray(v) for k, v in batch.items()},
        np.random.RandomState(0))
    model = load_flax_variables(build_model(pcfg, device="cpu", train=True),
                                variables)
    weights = weights_of(model)
    ranks = spawn_ranks(torch_ranks.ddp_step, WORLD,
                        (pcfg, weights, batch, (H, W)))
    state, stats = make_train_step(pcfg, (H, W))(
        create_train_state(pcfg, model), batch)
    return dict(jcfg=jcfg, batch=batch, variables=variables, model=model,
                before=weights, ranks=ranks,
                stats={k: float(v) for k, v in stats.items()})


def test_ddp_step_matches_one_process(ddp_pair):
    ranks, model = ddp_pair["ranks"], ddp_pair["model"]
    assert all(r["loaded"] == [] for r in ranks)
    for r in ranks:
        assert set(r["stats"][0]) == set(ddp_pair["stats"])
        for k, v in ddp_pair["stats"].items():
            np.testing.assert_allclose(r["stats"][0][k], v, rtol=1e-5,
                                       err_msg=k)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(ranks[0]["grads"]) == {k for k, g in grads.items()
                                      if g is not None}
    worst = min((cosine(g, grads[k].numpy()), k)
                for k, g in ranks[0]["grads"].items()
                if float(grads[k].abs().max()) >= 1e-7)
    assert worst[0] >= 0.9999, worst
    buffers = dict(model.named_buffers())
    for r in ranks:
        for k, v in r["buffers"].items():
            np.testing.assert_allclose(v, buffers[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert_adam_bound(ranks[0]["params"],
                      {k: p.detach().numpy() for k, p in
                       model.named_parameters()},
                      {k: ddp_pair["before"][k] for k in ranks[0]["params"]})


def test_ddp_step_matches_jax_mesh(ddp_pair):
    """The JAX package's own sharded step over 2 of the virtual CPU
    devices, on the same global batch and weights."""
    jcfg, batch = ddp_pair["jcfg"], ddp_pair["batch"]
    variables = ddp_pair["variables"]
    mesh = make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    state = replicate_state(j_create_train_state(jcfg, variables), mesh)
    sharded = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    step = j_make_train_step(jcfg, mesh, (H, W),
                             batch_stats_template=variables["batch_stats"])
    state, stats = step.lower(state, sharded).compile(
        compiler_options=FAST_COMPILE)(state, sharded)
    port = ddp_pair["ranks"][0]
    np.testing.assert_allclose(port["stats"][0]["loss"], float(stats["loss"]),
                               rtol=1e-5)
    model = ddp_pair["model"]
    ref = flax_leaves_by_param(model, jax.tree_util.tree_map(np.asarray,
                                                             state.params))
    before = flax_leaves_by_param(model, variables["params"])
    assert_adam_bound(port["params"], ref, before)


def test_ray_split_render_matches_jax():
    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=2, train_input_views=(2,),
        cas_config=CascadeConfig(num=2, volume_planes=(16, 8),
                                 render_if=(False, True))))
    names = {f.name for f in dataclasses.fields(pc.ENeRFConfig)} - {"cas_config"}
    pcfg = pc.Config(enerf=pc.ENeRFConfig(
        **{k: getattr(jcfg.enerf, k) for k in names},
        cas_config=pc.CascadeConfig(**dataclasses.asdict(
            jcfg.enerf.cas_config))))
    batch = make_synthetic_batch(jcfg, H=32, W=32, batch_size=1)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = seeded_variables(JENeRF(cfg=jcfg.enerf, train_mode=False), jb,
                                 np.random.RandomState(3))
    mesh = make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    ref = j_sharded_render(jcfg, mesh)(variables["params"],
                                       variables["batch_stats"], jb)
    weights = weights_of(load_flax_variables(build_model(pcfg, device="cpu"),
                                             variables))
    ranks = spawn_ranks(torch_ranks.sharded_render, WORLD,
                        (pcfg, weights, batch))
    for r in ranks:
        assert r["loaded"] == []
        assert set(r["out"]) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(r["out"][k], np.asarray(v), rtol=1e-3,
                                       atol=E2E_ATOL[k.rsplit("_", 1)[0]],
                                       err_msg=k)

"""Port modules vs their JAX counterparts on the CPU: FeatureNet,
MinCostRegNet, CostRegNet and NeRFHead, with the JAX package's freshly
initialized weights (BN running statistics randomized, so a layout error in
the BN leaves cannot hide behind mean 0 / var 1) carried across by
``enerf_tpu_torch.utils.convert.load_flax_variables``.

Tolerance: each module alone, f32 on both sides — rtol 1e-4, atol 1e-4,
the class of ``tests/test_convert.py`` (conv reassociation between XLA's
and PyTorch's CPU convolutions; the eval-BN fold on the JAX side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.models.cost_reg import CostRegNet as JCostRegNet
from enerf_tpu.models.cost_reg import MinCostRegNet as JMinCostRegNet
from enerf_tpu.models.feature_net import FeatureNet as JFeatureNet
from enerf_tpu.models.nerf_head import NeRFHead as JNeRFHead
from enerf_tpu_torch.models.cost_reg import CostRegNet, MinCostRegNet
from enerf_tpu_torch.models.feature_net import FeatureNet
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.utils.convert import load_flax_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def to_numpy_tree(tree):
    """A flax variables tree as a nested dict of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def randomize_batch_stats(variables, rng):
    """Nontrivial BN running statistics (mean ~ 0.3 N(0, 1), var in
    [1, 2)) in a numpy variables tree, in place; returns it."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                node[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
            elif k == "var":
                node[k] = (1.0 + rng.rand(*v.shape)).astype(np.float32)
    walk(variables.get("batch_stats", {}))
    return variables


def jax_variables(module, rng, *args):
    """Init ``module`` on ``args``; numpy tree with random BN stats."""
    variables = jax.jit(module.init)(
        jax.random.PRNGKey(int(rng.randint(1 << 30))),
        *[jnp.asarray(a) for a in args])
    return randomize_batch_stats(to_numpy_tree(variables), rng)


def seeded_variables(module, rng, *args):
    """``module``'s variables tree (its init's shapes, traced with
    ``jax.eval_shape``: nothing is compiled) filled from ``rng``: kernels
    N(0, 2 / fan_in), biases 0.05 N(0, 1), BN scales 1 + 0.1 N(0, 1), BN
    running statistics as ``randomize_batch_stats``. A numpy tree."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v)
                continue
            x = rng.randn(*v.shape)
            if k == "kernel":
                x = x * np.sqrt(2.0 / max(np.prod(v.shape[:-1]), 1))
            elif k == "scale":
                x = 1.0 + 0.1 * x
            else:
                x = 0.05 * x
            out[k] = x.astype(np.float32)
        return out

    return randomize_batch_stats(fill(shapes), rng)


def test_feature_net():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    jm = JFeatureNet(train=False)
    variables = jax_variables(jm, rng, x)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    port = load_flax_variables(FeatureNet().eval(), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("net", ["min", "full"])
def test_cost_reg(net):
    rng = np.random.RandomState(1)
    if net == "min":
        jm, port, shape = JMinCostRegNet(train=False), MinCostRegNet(32), (1, 8, 8, 12, 32)
    else:
        jm, port, shape = JCostRegNet(train=False), CostRegNet(16), (1, 8, 16, 16, 16)
    x = rng.randn(*shape).astype(np.float32)
    variables = jax_variables(jm, rng, x)
    feat_ref, depth_ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    load_flax_variables(port.eval(), variables)
    with torch.no_grad():
        feat, depth = port(torch.from_numpy(x))
    assert feat.is_contiguous() and tuple(feat.shape) == shape[:4] + (8,)
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_ref), **TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_ref), **TOL)


@pytest.mark.parametrize("feat_ch,masked,vox", [
    pytest.param(11, False, True, id="11-False"),
    pytest.param(11, True, True, id="11-True"),
    pytest.param(35, True, True, id="35-True"),
    # the composite's head: no vox feature, no view-direction aggregation
    pytest.param(11, True, False, id="11-True-no_vox")])
def test_nerf_head(feat_ch, masked, vox):
    rng = np.random.RandomState(2)
    B, P, S = 2, 50, 3
    vox_feat = rng.randn(B, P, 8).astype(np.float32)
    img = rng.randn(B, P, S, feat_ch + 4).astype(np.float32)
    vm = np.array([[1, 1, 0], [1, 1, 1]], np.float32) if masked else None
    jm = JNeRFHead(feat_ch=feat_ch, viewdir_agg=vox, use_vox_feat=vox)
    variables = jax_variables(jm, rng, vox_feat, img)
    ref = jm.apply(variables, jnp.asarray(vox_feat), jnp.asarray(img),
                   None if vm is None else jnp.asarray(vm))
    port = load_flax_variables(
        NeRFHead(feat_ch, viewdir_agg=vox, use_vox_feat=vox).eval(), variables)
    if not vox:   # lr0 and color.0 lose the 8 vox inputs
        assert port.lr0[0].in_features == 16
        assert port.color[0].in_features == 64 + 16 + feat_ch + 4
    with torch.no_grad():
        out = port(torch.from_numpy(vox_feat) if vox else None,
                   torch.from_numpy(img),
                   None if vm is None else torch.from_numpy(vm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)

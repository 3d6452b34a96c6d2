"""The port's full eval forward vs ``enerf_tpu.models.enerf.ENeRF`` on the
CPU: the DTU eval configuration (two-level cascade, ``volume_planes
(48, 8)``, ``render_if (False, True)``, grid rays) at 64×96, with the JAX
model's weights (BN running statistics randomized) carried across, for 3
real source views and for 2 real + 1 padded view. The JAX side runs its
jnp paths (fused flags off).

Tolerance: rtol 1e-3 with atol 3e-4 on rgb and weights, 3e-3 on depths
and std — the class of ``tests/test_e2e_parity.py``: level 0 runs in
disparity, so f32 reassociation in its depth moves the level-1 planes, and
the difference grows through ~20 composed modules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.models.enerf import ENeRF as JENeRF
from enerf_tpu_torch import build_model, render
from enerf_tpu_torch.config import dtu_eval_config
from enerf_tpu_torch.utils.convert import load_flax_variables
from tests.test_torch_modules import randomize_batch_stats, to_numpy_tree

ATOL = {"rgb_level1": 3e-4, "weights_level1": 3e-4, "depth_level1": 3e-3,
        "depth_mvs_level1": 3e-3, "std_level1": 3e-3}


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model and its jitted init / apply, compiled once for both
    cases (the batches have the same shapes: views pad to 3)."""
    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True,
        cas_config=CascadeConfig(num=2, volume_planes=(48, 8),
                                 render_if=(False, True))))
    jmodel = JENeRF(cfg=jcfg.enerf, train_mode=False)
    return jcfg, jax.jit(jmodel.init), jax.jit(jmodel.apply)


@pytest.mark.parametrize("n_src", [3, 2])
def test_eval_forward_matches_jax(jax_model, n_src):
    jcfg, init, apply = jax_model
    batch = make_synthetic_batch(jcfg, H=64, W=96, n_src=n_src)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = randomize_batch_stats(
        to_numpy_tree(init(jax.random.PRNGKey(n_src), jb)),
        np.random.RandomState(n_src))
    ref = apply(variables, jb)

    model = load_flax_variables(build_model(dtu_eval_config(), device="cpu"),
                                variables)
    out = render(model, batch)
    assert set(out) == set(ref) == set(ATOL)
    for k, atol in ATOL.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-3, atol=atol, err_msg=k)

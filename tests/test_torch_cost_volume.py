"""The port's cost volume on the CPU (the cost-volume kernel's plain
version) vs ``enerf_tpu.ops.warp.build_cost_volume`` (its jnp path, which
``tests/test_pallas.py`` holds equal to the Pallas kernel).

The inputs are ``test_pallas.py``'s fixture: projections near identity
with jitter, so most coordinates land in the source map and some fall
outside it (zeros padding), with and without a padded view.

Tolerance rtol 2e-4 / atol 2e-5, the class ``test_pallas.py`` uses for the
fused kernel against the same jnp path: the variance Σf²/n − (Σf/n)²
cancels, so 1e-7-relative differences in the bilinear blend (grid_sample's
normalized coordinates vs direct pixel lerp) show at ~1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.ops.warp import _warp_coords as j_warp_coords
from enerf_tpu.ops.warp import build_cost_volume as j_build_cost_volume
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.warp import build_cost_volume

TOL = dict(rtol=2e-4, atol=2e-5)


def _fixture(C, seed=7):
    rng = np.random.RandomState(seed)
    B, S, H_s, W_s = 2, 3, 24, 32
    D, H_t, W_t = 4, 8, 16
    feats = rng.randn(B, S, H_s, W_s, C).astype(np.float32)
    pm = np.zeros((B, S, 3, 4), np.float32)
    pm[..., :3, :3] = np.eye(3) + 0.02 * rng.randn(B, S, 3, 3)
    pm[..., :2, 3] = 2.0 * rng.randn(B, S, 2)
    pm[..., 2, 3] = 0.1 * rng.rand(B, S)
    dv = (2.0 + 3.0 * rng.rand(B, D, H_t, W_t)).astype(np.float32)
    return feats, pm, dv


def test_warp_coords():
    _, pm, dv = _fixture(16)
    xs, ys = kcv.warp_coords(torch.from_numpy(pm), torch.from_numpy(dv))
    W_s, H_s = 32, 24
    for b in range(pm.shape[0]):
        for s in range(pm.shape[1]):
            rx, ry = j_warp_coords(jnp.asarray(pm[b, s]), jnp.asarray(dv[b]),
                                   W_s, H_s)
            np.testing.assert_allclose(xs[b, s].numpy(), np.asarray(rx),
                                       rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(ys[b, s].numpy(), np.asarray(ry),
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("C", [16, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_cost_volume_matches_jax(C, masked):
    feats, pm, dv = _fixture(C)
    vm = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], np.float32) if masked else None
    ref = jax.jit(j_build_cost_volume)(
        jnp.asarray(feats), jnp.asarray(pm), jnp.asarray(dv),
        None if vm is None else jnp.asarray(vm))
    out = build_cost_volume(torch.from_numpy(feats), torch.from_numpy(pm),
                            torch.from_numpy(dv),
                            None if vm is None else torch.from_numpy(vm))
    assert out.shape == ref.shape == (2, 4, 8, 16, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # some coordinates fall outside the source map (zeros padding ran)
    xs, ys = kcv.warp_coords(torch.from_numpy(pm), torch.from_numpy(dv))
    assert bool(((xs < 0) | (xs > 31) | (ys < 0) | (ys > 23)).any())


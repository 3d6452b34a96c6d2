"""Depth regression (K4) and the two repairs of the first port slice, on
the CPU.

- The port's ``depth_regression`` (its autograd Function, whose forward is
  the plain version on a CPU tensor) vs the JAX package's Pallas kernel
  ``depth_regression_pallas`` in interpret mode (as ``tests/test_pallas.py``
  runs it), and its gradients vs those of ``depth_regression_fused``, for
  ``depth_inv`` True and False. Tolerance: rtol 1e-5 / atol 1e-6 on
  depth, and on std and the gradients rtol 1e-4 / atol 1e-6 (the class of
  ``tests/test_pallas.py``: f32, reductions summed in another order).
- The composite depth map passes no gradient to ``z_vals``, as in JAX.
- The cost-volume and render kernel wrappers refuse inputs that need a
  gradient (their kernels have no backward), before any device check; the
  depth-regression wrapper refuses a tensor that is on neither the CPU nor
  a CUDA device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from enerf_tpu.ops.composite import raw2outputs as j_raw2outputs
from enerf_tpu.ops.pallas.reductions import (
    depth_regression_fused,
    depth_regression_pallas,
)
from enerf_tpu_torch.ops.composite import raw2outputs
from enerf_tpu_torch.ops.depth import depth_regression
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import depth_regression as kdr
from enerf_tpu_torch.ops.kernels import render as krender

D_TOL = dict(rtol=1e-5, atol=1e-6)
S_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed, B=2, D=16, H=12, W=20):
    """Logits and per-pixel plane values as the cascade has them: planes
    spread over [2, 6] with a per-pixel jitter."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, D, H, W).astype(np.float32)
    values = (np.linspace(2.0, 6.0, D, dtype=np.float32)[None, :, None, None]
              + 0.1 * rng.rand(B, D, H, W).astype(np.float32))
    return logits, values


@pytest.mark.parametrize("depth_inv", [False, True])
def test_forward_matches_pallas(interpret, depth_inv):
    logits, values = _inputs(1)
    d_ref, s_ref = depth_regression_pallas(jnp.asarray(logits),
                                           jnp.asarray(values), depth_inv,
                                           tile_p=128)
    d, s = depth_regression(torch.from_numpy(logits),
                            torch.from_numpy(values), depth_inv)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), **D_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **S_TOL)


@pytest.mark.parametrize("depth_inv", [False, True])
def test_gradients_match_fused(interpret, depth_inv):
    logits, values = _inputs(2, B=1, D=8, H=8, W=16)

    def loss(l, v):
        d, s = depth_regression_fused(l, v, depth_inv)
        return jnp.sum(d * 1.3 + s * 0.7)

    gl_ref, gv_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(logits),
                                                    jnp.asarray(values))
    lt = torch.from_numpy(logits).requires_grad_()
    vt = torch.from_numpy(values).requires_grad_()
    d, s = depth_regression(lt, vt, depth_inv)
    assert d.grad_fn is not None and "DepthRegression" in type(d.grad_fn).__name__
    gl, gv = torch.autograd.grad(torch.sum(d * 1.3 + s * 0.7), (lt, vt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(gl_ref), **S_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_ref), **S_TOL)
    # one input alone: the other gets no gradient
    (gl_only,) = torch.autograd.grad(
        depth_regression(lt, vt.detach(), depth_inv)[0].sum(), (lt,))
    assert gl_only.shape == lt.shape


def test_composite_depth_passes_no_gradient_to_z_vals():
    rng = np.random.RandomState(3)
    raw = rng.randn(1, 5, 4, 4).astype(np.float32)
    z = np.sort(rng.rand(1, 5, 4).astype(np.float32) + 2.0, axis=-1)
    g_ref = jax.grad(lambda zv: jnp.sum(
        j_raw2outputs(jnp.asarray(raw), zv)["depth"]))(jnp.asarray(z))
    assert not np.any(np.asarray(g_ref))
    zt = torch.from_numpy(z).requires_grad_()
    rt = torch.from_numpy(raw).requires_grad_()
    out = raw2outputs(rt, zt)
    g, g_raw = torch.autograd.grad(out["depth"].sum(), (zt, rt),
                                   allow_unused=True, materialize_grads=True)
    assert not torch.any(g) and torch.any(g_raw)
    np.testing.assert_allclose(
        out["depth"].detach().numpy(),
        np.asarray(j_raw2outputs(jnp.asarray(raw), jnp.asarray(z))["depth"]),
        rtol=1e-5, atol=1e-6)


def _meta(*shape, grad=False):
    return torch.empty(*shape, device="meta", dtype=torch.float32,
                       requires_grad=grad)


@pytest.mark.parametrize("kernel,needs_grad", [
    ("cost_volume", "input"), ("render", "input"), ("render", "head")])
def test_kernel_wrappers_refuse_gradients(kernel, needs_grad):
    """A tensor (or a head parameter) that needs a gradient raises
    ``ValueError`` naming the plain version, before the device check;
    under ``no_grad`` the same call reaches the device check."""
    from enerf_tpu_torch.models.nerf_head import NeRFHead

    def call(grad):
        g = grad and needs_grad == "input"
        if kernel == "cost_volume":
            return kcv.fused_cost_volume(_meta(1, 3, 8, 8, 16, grad=g),
                                         _meta(1, 3, 3, 4), _meta(1, 4, 8, 8))
        head = NeRFHead(11).to("meta").requires_grad_(
            grad and needs_grad == "head")
        return krender.render_rays(
            _meta(1, 4, 2, 3, grad=g), _meta(1, 4, 2, 3), _meta(1, 4, 2),
            _meta(1, 3, 2, 2, 11), _meta(1, 8, 2, 2, 8), _meta(1, 3, 4, 4),
            _meta(1, 3, 3, 3), _meta(1, 4, 4), None, head, render_scale=1.0)

    before = (kcv.launches, krender.launches)
    plain = {"cost_volume": "cost_volume_plain",
             "render": "render_rays_plain"}[kernel]
    with pytest.raises(ValueError, match=f"no backward.*{plain}"):
        call(grad=True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call(grad=True)
    assert (kcv.launches, krender.launches) == before


def test_depth_wrapper_raises_off_cpu():
    before = kdr.launches
    with pytest.raises(ValueError, match="CUDA"):
        depth_regression(_meta(1, 8, 4, 4), _meta(1, 8, 4, 4), True)
    with pytest.raises(ValueError, match="CUDA"):
        depth_regression(_meta(1, 8, 4, 4, grad=True), _meta(1, 8, 4, 4), True)
    assert kdr.launches == before

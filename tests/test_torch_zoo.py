"""The port's zoo against the JAX package's on the CPU: the ops the stock
forward does not use (``raw2outputs_ngp``, ``raw2outputs_layer``, the
plane and shell samplers, ``eval_sh_bases``, ``homo_warp``) on seeded
inputs, and the four networks (``ResUnet``, ``CNNRender``,
``MinCostRegNetTri``, ``MVSNeRFHead``) in eval mode at small sizes on one
set of seeded weights, carried into the port by
``utils/convert.py:load_flax_variables``.

Tolerances: rtol 1e-5 / atol 1e-6 for the ops; rtol 1e-4 / atol 1e-5 for
the networks in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_modules import seeded_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

OP_TOL = dict(rtol=1e-5, atol=1e-6)
NET_TOL = dict(rtol=1e-4, atol=1e-5)


def _raw(rng, *shape):
    """rgb in [0, 1] and sigma >= 0, as the heads give them."""
    raw = rng.rand(*shape, 4).astype(np.float32)
    raw[..., 3] = np.abs(rng.randn(*shape)) * 2
    return raw


def _check(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("op", ["raw2outputs_ngp", "raw2outputs_layer",
                                "sample_points_on_plane",
                                "sample_points_along_sphere", "eval_sh_bases",
                                "homo_warp"])
def test_ops_match_jax(op):
    from enerf_tpu.ops import composite as jc, rays as jr, sh as js, warp as jw
    from enerf_tpu_torch.ops import composite as pc, rays as pr, sh as ps
    from enerf_tpu_torch.ops import warp as pw

    rng = np.random.RandomState(0)
    if op == "raw2outputs_ngp":
        raw = _raw(rng, 2, 30, 40)
        z = np.sort(rng.rand(2, 30, 40), -1).astype(np.float32) * 5 + 1
        d = rng.randn(2, 30, 3).astype(np.float32)
        for n, white in ((32, True), (40, False)):
            want = jax.jit(jc.raw2outputs_ngp, static_argnums=(3, 4))(
                *_j(raw, z, d), white, n)
            got = pc.raw2outputs_ngp(*_t(raw, z, d), white_bkgd=white,
                                     n_samples=n)
            assert set(got) == set(want)
            for k in want:
                _check(got[k], want[k], OP_TOL, f"{k} n={n}")
    elif op == "raw2outputs_layer":
        l0, l1 = _raw(rng, 2, 50, 2), _raw(rng, 2, 50, 2)
        z0 = rng.rand(2, 50, 2).astype(np.float32)
        z1 = z0.copy()
        z1[..., 0] = rng.rand(2, 50)         # the second samples tie in z
        for white in (False, True):
            want = jax.jit(jc.raw2outputs_layer, static_argnums=2)(
                _j(l0, l1), _j(z0, z1), white)
            zs = [z.requires_grad_() for z in _t(z0, z1)]
            got = pc.raw2outputs_layer(_t(l0, l1), zs, white_bkgd=white)
            assert set(got) == set(want)
            for k in want:
                _check(got[k], want[k], OP_TOL, k)
            # the depth map holds z constant (stop_gradient in JAX)
            assert not got["depth"].requires_grad
    elif op in ("sample_points_on_plane", "sample_points_along_sphere"):
        rays = np.concatenate([rng.randn(3, 20, 3) * 0.5, rng.randn(3, 20, 3),
                               rng.rand(3, 20, 2)], -1).astype(np.float32)
        # z directions on both sides of each clamp
        rays[0, :6, 5] = [0.0, 1e-11, -1e-11, 5e-6, -5e-6, -2e-10]
        for n in (1, 32):
            want = jax.jit(getattr(jr, op), static_argnums=1)(
                jnp.asarray(rays), n)
            got = getattr(pr, op)(torch.from_numpy(rays), n_samples=n)
            for g, w, what in zip(got, want, ("points", "z_vals")):
                _check(g, w, OP_TOL, f"{what} n={n}")
    elif op == "eval_sh_bases":
        d = rng.randn(2, 50, 3)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        for n in (1, 4, 9, 16, 25):
            _check(ps.eval_sh_bases(n, torch.from_numpy(d)),
                   js.eval_sh_bases(n, jnp.asarray(d)), OP_TOL, f"dim {n}")
        with pytest.raises(ValueError):
            ps.eval_sh_bases(10, torch.from_numpy(d))
    else:
        feat = rng.randn(20, 24, 5).astype(np.float32)
        P = np.array([[1.1, 0.05, -2.0, 3.0], [0.02, 0.9, 1.0, -2.0],
                      [0.001, 0.002, 1.0, 0.1]], np.float32)
        dv = (rng.rand(4, 10, 12) * 3 + 1).astype(np.float32)
        dv[0, 0, :3] = [1e-3, 1e4, 0.5]     # warps far outside the source
        _check(pw.homo_warp(*_t(feat, P, dv)),
               jax.jit(jw.homo_warp)(*_j(feat, P, dv)), OP_TOL, "homo_warp")


@pytest.mark.parametrize("net", ["res_unet", "cnn_render", "cost_reg_tri",
                                 "mvsnerf_head"])
def test_zoo_networks_match_jax(net):
    from enerf_tpu.models import cost_reg as jcr, feature_net as jfn
    from enerf_tpu.models import nerf_head as jnh, res_unet as jru
    from enerf_tpu_torch.models import cost_reg as pcr, feature_net as pfn
    from enerf_tpu_torch.models import nerf_head as pnh, res_unet as pru
    from enerf_tpu_torch.utils.convert import load_flax_variables

    rng = np.random.RandomState(1)
    if net == "res_unet":
        jm, pm = jru.ResUnet(train=False), pru.ResUnet()
        args = [rng.rand(2, 32, 40, 3).astype(np.float32)]
    elif net == "cnn_render":
        jm, pm = jfn.CNNRender(train=False), pfn.CNNRender()
        args = [rng.rand(2, 24, 34, 3).astype(np.float32)]
    elif net == "cost_reg_tri":
        jm, pm = jcr.MinCostRegNetTri(train=False), pcr.MinCostRegNetTri(8)
        args = [rng.randn(1, 8, 16, 20, 8).astype(np.float32)]
    else:
        jm, pm = jnh.MVSNeRFHead(feat_ch=11), pnh.MVSNeRFHead(11, 3)
        args = [rng.randn(2, 30, 8).astype(np.float32),
                rng.randn(2, 30, 3, 15).astype(np.float32)]
    variables = seeded_variables(jm, rng, *_j(*args))
    want = jax.jit(jm.apply)(variables, *_j(*args))
    load_flax_variables(pm.eval(), variables)
    with torch.no_grad():
        got = pm(*_t(*args))
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g, w, NET_TOL, f"{net} output {i}")
    if net == "cnn_render":
        assert got[0].min() >= 0 and got[0].max() <= 1

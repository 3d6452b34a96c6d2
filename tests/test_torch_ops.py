"""Port ops vs their JAX counterparts on the CPU, on the same numpy inputs
made from a seed: camera math, depth planes and regression, align-corners
resize, depth-guided rays, IBR feature sampling, vox sampling and alpha
compositing.

Tolerance: one op each, f32 on both sides, so rtol 1e-5 / atol 1e-5 unless
a case says otherwise (sampling goes through ``F.grid_sample``'s
normalized coordinates, whose round trip costs ~1e-6 px)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig as JCascadeConfig
from enerf_tpu.config import Config as JConfig
from enerf_tpu.config import ENeRFConfig as JENeRFConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.ops import camera as jcam
from enerf_tpu.ops import composite as jcomp
from enerf_tpu.ops import depth as jdepth
from enerf_tpu.ops import ibr as jibr
from enerf_tpu.ops import rays as jrays
from enerf_tpu.ops import sampling as jsamp
from enerf_tpu_torch.ops import camera, composite, depth, ibr, rays, sampling

TOL = dict(rtol=1e-5, atol=1e-5)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def batch():
    cfg = JConfig(enerf=JENeRFConfig(
        test_input_views=3, train_input_views=(2, 3),
        cas_config=JCascadeConfig(volume_planes=(48, 8))))
    return make_synthetic_batch(cfg, H=32, W=48, n_src=2)


@pytest.mark.parametrize("src_scale,tar_scale", [(0.25, 0.125), (0.5, 0.5)])
def test_camera(batch, src_scale, tar_scale):
    args = [batch[k] for k in ("src_exts", "src_ixts", "tar_ext", "tar_ixt")]
    ref = jcam.get_proj_mats(*[jnp.asarray(a) for a in args],
                             src_scale=src_scale, tar_scale=tar_scale)
    close(camera.get_proj_mats(*[T(a) for a in args], src_scale=src_scale,
                               tar_scale=tar_scale), ref, rtol=1e-5, atol=1e-4)
    close(camera.cam_centers(T(batch["src_exts"])),
          jcam.cam_centers(jnp.asarray(batch["src_exts"])))
    close(camera.scale_intrinsics(T(batch["src_ixts"]), src_scale),
          jcam.scale_intrinsics(jnp.asarray(batch["src_ixts"]), src_scale))


@pytest.mark.parametrize("depth_inv", [True, False])
def test_init_depth_values(depth_inv):
    nf = np.array([[2.5, 5.5], [1.0, 3.0]], np.float32)
    dv, nfo = depth.init_depth_values(T(nf), 16, 4, 6, depth_inv)
    rdv, rnfo = jdepth.init_depth_values(jnp.asarray(nf), 16, 4, 6, depth_inv)
    close(dv, rdv)
    close(nfo, rnfo)


@pytest.mark.parametrize("inv_prev,inv_cur,up", [(True, False, 4.0),
                                                 (False, False, 1.0),
                                                 (True, True, 2.0)])
def test_cascade_depth_values(inv_prev, inv_cur, up):
    rng = np.random.RandomState(3)
    B, h, w = 2, 4, 6
    if inv_prev:  # disparity space: near_far rows (near_disp, far_disp)
        d = (0.2 + 0.15 * rng.rand(B, h, w)).astype(np.float32)
        nf = np.stack([np.full((B, h, w), 0.4), np.full((B, h, w), 0.18)], 1)
    else:
        d = (3.0 + rng.rand(B, h, w)).astype(np.float32)
        nf = np.stack([np.full((B, h, w), 2.5), np.full((B, h, w), 5.5)], 1)
    std = (0.05 * rng.rand(B, h, w)).astype(np.float32)
    nf = nf.astype(np.float32)
    out = depth.cascade_depth_values(T(d), T(std), T(nf), 8, inv_prev,
                                     inv_cur, up)
    ref = jdepth.cascade_depth_values(jnp.asarray(d), jnp.asarray(std),
                                      jnp.asarray(nf), 8, inv_prev, inv_cur, up)
    for o, r in zip(out, ref):
        close(o, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("depth_inv", [True, False])
def test_depth_regression(depth_inv):
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 16, 5, 7).astype(np.float32)
    values = (2.0 + 4.0 * rng.rand(2, 16, 5, 7)).astype(np.float32)
    out = depth.depth_regression(T(logits), T(values), depth_inv)
    ref = jdepth.depth_regression(jnp.asarray(logits), jnp.asarray(values),
                                  depth_inv)
    for o, r in zip(out, ref):
        close(o, r)


@pytest.mark.parametrize("out_hw", [(16, 24), (5, 7), (8, 12)])
def test_resize_bilinear(out_hw):
    img = np.random.RandomState(5).randn(2, 3, 8, 12, 4).astype(np.float32)
    close(sampling.resize_bilinear(T(img), out_hw),
          jsamp.resize_bilinear(jnp.asarray(img), out_hw))
    assert sampling.scale_size(513, 0.125) == jsamp.scale_size(513, 0.125)


def _ray_inputs(batch, depth_inv):
    rng = np.random.RandomState(6)
    B, h, w = 1, 16, 24
    if depth_inv:
        d = (0.2 + 0.1 * rng.rand(B, h, w)).astype(np.float32)
        nf = np.stack([np.full((B, h, w), 0.4), np.full((B, h, w), 0.18)], 1)
    else:
        d = (3.0 + rng.rand(B, h, w)).astype(np.float32)
        nf = np.stack([np.full((B, h, w), 2.5), np.full((B, h, w), 5.5)], 1)
    std = (0.1 * rng.rand(B, h, w)).astype(np.float32)
    return batch["rays_1"], d, std, nf.astype(np.float32)


@pytest.mark.parametrize("depth_inv", [True, False])
@pytest.mark.parametrize("grid", [True, False])
def test_build_rays(batch, depth_inv, grid):
    r8, d, std, nf = _ray_inputs(batch, depth_inv)
    out = rays.build_rays(T(r8), T(d), T(std), T(nf), depth_inv, 2.0, grid)
    ref = jrays.build_rays(jnp.asarray(r8), jnp.asarray(d), jnp.asarray(std),
                           jnp.asarray(nf), depth_inv, 2.0, grid)
    close(out, ref)


@pytest.mark.parametrize("depth_inv,n", [(True, 2), (False, 2), (False, 1)])
def test_sample_along_depth(batch, depth_inv, n):
    r8, d, std, nf = _ray_inputs(batch, depth_inv)
    r12 = jrays.build_rays(jnp.asarray(r8), jnp.asarray(d), jnp.asarray(std),
                           jnp.asarray(nf), depth_inv, 2.0, True)
    out = rays.sample_along_depth(T(np.asarray(r12)), n, depth_inv)
    ref = jrays.sample_along_depth(r12, n, depth_inv)
    for o, r in zip(out, ref):
        close(o, r, rtol=1e-5, atol=1e-4)


def test_get_img_feat(batch):
    """Border padding in pixel coordinates: part of the samples project
    outside the source images."""
    rng = np.random.RandomState(7)
    B, S, H, W, C = 1, 3, 32, 48, 11
    r8 = batch["rays_1"][:, ::7]
    t = 2.5 + 3.0 * rng.rand(B, r8.shape[1], 2, 1)
    xyz = (r8[:, :, None, :3] + r8[:, :, None, 3:6] * t).astype(np.float32)
    xyz[:, ::5] *= 1.8   # push some samples off the images
    feats = rng.randn(B, S, H, W, C).astype(np.float32)
    args = [xyz, feats, batch["src_exts"], batch["src_ixts"], batch["tar_ext"]]
    out = ibr.get_img_feat(*[T(a) for a in args], render_scale=1.0)
    ref = jibr.get_img_feat(*[jnp.asarray(a) for a in args], render_scale=1.0)
    close(out, ref, rtol=1e-4, atol=1e-4)


def test_vox_feat():
    """Grid sampling (resize + tent) and per-sample trilinear sampling
    both match the JAX grid path, with depths outside [0, 1] for the zeros
    padding in depth."""
    rng = np.random.RandomState(8)
    B, D, Hv, Wv, C, H, W, n = 1, 8, 6, 9, 8, 12, 18, 2
    vol = rng.randn(B, D, Hv, Wv, C).astype(np.float32)
    d = rng.uniform(-0.2, 1.2, (B, H * W * n)).astype(np.float32)
    ref = jibr.get_vox_feat_grid(jnp.asarray(vol), jnp.asarray(d), (H, W))
    close(ibr.get_vox_feat_grid(T(vol), T(d), (H, W)), ref)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uv = np.stack([xs / (W - 1), ys / (H - 1)], -1).reshape(1, H * W, 1, 2)
    uvd = np.concatenate([np.repeat(uv, n, 2),
                          d.reshape(B, H * W, n, 1)], -1).reshape(B, -1, 3)
    close(ibr.get_vox_feat(T(uvd), T(vol)), ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("render_scale", [1.0, 0.5])
def test_unpreprocess(batch, render_scale):
    close(ibr.unpreprocess(T(batch["src_inps"]), render_scale),
          jibr.unpreprocess(jnp.asarray(batch["src_inps"]), render_scale))


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs(white_bkgd):
    rng = np.random.RandomState(9)
    raw = rng.randn(2, 30, 2, 4).astype(np.float32)
    raw[..., 3] = np.abs(raw[..., 3]) * 3.0
    z = (3.0 + rng.rand(2, 30, 2)).astype(np.float32)
    out = composite.raw2outputs(T(raw), T(z), white_bkgd)
    ref = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), white_bkgd)
    assert set(out) == set(ref)
    for k in out:
        close(out[k], ref[k])

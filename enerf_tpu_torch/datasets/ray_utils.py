"""Host-side (numpy) ray construction; counterpart of
``enerf_tpu/datasets/ray_utils.py`` (reference lib/datasets/enerf_utils.py).

Ray layout: o(3) | dir(3) | x | y — 8 channels, float32. Directions via
K^-T then R^T (world-space, unnormalized): XYZ @ (K^-1)^T @ R_c2w^T.
numpy only: the image resizes are the integer-factor area / nearest rules.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _resize_area(img, scale):
    """Average-pool for integer downscales (cv2.INTER_AREA at 1/k)."""
    inv = int(round(1 / scale))
    H, W = img.shape[:2]
    img = img[: H - H % inv, : W - W % inv]
    sh = (img.shape[0] // inv, inv, img.shape[1] // inv, inv) + img.shape[2:]
    return img.reshape(sh).mean(axis=(1, 3))


def _resize_nearest(img, scale):
    H, W = img.shape[:2]
    H2, W2 = int(H * scale), int(W * scale)
    iy = np.minimum((np.arange(H2) / scale).astype(np.int64), H - 1)
    ix = np.minimum((np.arange(W2) / scale).astype(np.int64), W - 1)
    return img[iy][:, ix]


def sample_patch(num_patch: int, patch_size: int, H: int, W: int,
                 msk_sample: np.ndarray, rng: np.random.RandomState):
    """Patch-center sampling for the perceptual loss."""
    half = patch_size // 2
    if msk_sample.sum() > 0:
        n_fg = num_patch
        nz = msk_sample.nonzero()
        perm = rng.permutation(int(msk_sample.sum()))[:n_fg].astype(np.int32)
        X_, Y_ = nz[1][perm], nz[0][perm]
        X_ = np.clip(X_, half, W - half)
        Y_ = np.clip(Y_, half, H - half)
    else:
        n_fg = 0
    n_rand = num_patch - n_fg
    X = rng.randint(low=half, high=W - half, size=n_rand)
    Y = rng.randint(low=half, high=H - half, size=n_rand)
    if n_fg > 0:
        X = np.concatenate([X, X_]).astype(np.int32)
        Y = np.concatenate([Y, Y_]).astype(np.int32)
    gx, gy = np.meshgrid(np.arange(patch_size) - half,
                         np.arange(patch_size) - half)
    xs = np.concatenate([gx.reshape(-1) + x for x in X])
    ys = np.concatenate([gy.reshape(-1) + y for y in Y])
    return xs, ys


def build_rays_host(tar_img: np.ndarray, tar_ext: np.ndarray,
                    tar_ixt: np.ndarray, tar_msk: np.ndarray,
                    render_scale: float, *,
                    train_sample: bool = False,
                    num_rays: int = 0,
                    sample_on_mask: bool = False,
                    num_patches: int = 0,
                    patch_size: int = -1,
                    rng: Optional[np.random.RandomState] = None,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build 8-ch rays for one cascade level.

    Test / full-image mode (``train_sample=False``): a dense H×W grid in
    raster order. Train mode: ``num_rays`` random pixels (optionally
    75%-foreground via the mask, plus patch blocks).
    Returns (rays (N, 8) f32, rgb (N, 3) f32, msk (N,)).
    """
    if render_scale != 1.0:
        tar_img = _resize_area(tar_img, render_scale)
        tar_msk = _resize_nearest(tar_msk, render_scale)
        tar_ixt = tar_ixt.copy()
        tar_ixt[:2] *= render_scale
    H, W = tar_img.shape[:2]
    c2w = np.linalg.inv(tar_ext)

    if train_sample:
        rng = rng or np.random
        if sample_on_mask:
            msk_sample = tar_msk
            n_fg = int(min(num_rays * 0.75, tar_msk.sum() * 0.95))
            nz = msk_sample.nonzero()
            perm = rng.permutation(int(tar_msk.sum()))[:n_fg].astype(np.int32)
            X_, Y_ = nz[1][perm], nz[0][perm]
        else:
            n_fg = 0
            msk_sample = np.zeros_like(tar_msk)
        n_rand = num_rays - n_fg
        X = rng.randint(low=0, high=W, size=n_rand)
        Y = rng.randint(low=0, high=H, size=n_rand)
        if n_fg > 0:
            X = np.concatenate([X, X_]).astype(np.int32)
            Y = np.concatenate([Y, Y_]).astype(np.int32)
        if num_patches > 0:
            X_, Y_ = sample_patch(num_patches, patch_size, H, W, msk_sample,
                                  rng)
            X = np.concatenate([X, X_]).astype(np.int32)
            Y = np.concatenate([Y, Y_]).astype(np.int32)
        n = len(X)
        rays_o = np.tile(c2w[:3, 3][None], (n, 1))
        XYZ = np.concatenate([X[:, None], Y[:, None],
                              np.ones_like(X[:, None])],
                             axis=-1).astype(np.float64)
        XYZ = XYZ @ (np.linalg.inv(tar_ixt).T @ c2w[:3, :3].T)
        rays = np.concatenate([rays_o, XYZ, X[:, None], Y[:, None]], axis=-1)
        rgb = tar_img[Y, X]
        msk = tar_msk[Y, X]
    else:
        X, Y = np.meshgrid(np.arange(W), np.arange(H))
        XYZ = np.concatenate([X[..., None], Y[..., None],
                              np.ones_like(X[..., None])],
                             axis=-1).astype(np.float64)
        XYZ = XYZ @ (np.linalg.inv(tar_ixt).T @ c2w[:3, :3].T)
        rays_o = np.tile(c2w[:3, 3][None, None], (H, W, 1))
        rays = np.concatenate([rays_o, XYZ, X[..., None], Y[..., None]],
                              axis=-1)
        rgb = tar_img
        msk = tar_msk
    return (rays.astype(np.float32).reshape(-1, 8),
            rgb.reshape(-1, 3).astype(np.float32),
            msk.reshape(-1))

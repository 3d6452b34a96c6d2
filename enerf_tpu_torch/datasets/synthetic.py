"""Procedural synthetic scene; counterpart of
``enerf_tpu/datasets/synthetic.py``.

A DTU-shaped batch (posed source views of a textured sphere rendered
analytically, cameras on an arc looking at the origin, near_far bracketing
the radius) so the full pipeline runs without real data. numpy only: the
same seed gives the same arrays as the JAX package's generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from enerf_tpu_torch.config import Config
from enerf_tpu_torch.datasets.ray_utils import build_rays_host


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    ext = np.eye(4, dtype=np.float64)
    ext[:3, :3] = R
    ext[:3, 3] = -R @ eye
    return ext


def _shade(pts: np.ndarray) -> np.ndarray:
    """Smooth, view-consistent procedural texture of 3D points."""
    r = np.sin(3.1 * pts[..., 0]) * 0.5 + 0.5
    g = np.sin(2.3 * pts[..., 1] + 1.0) * 0.5 + 0.5
    b = np.sin(4.7 * pts[..., 2] + 2.0) * 0.5 + 0.5
    return np.stack([r, g, b], axis=-1)


def _render_view(ext: np.ndarray, ixt: np.ndarray, H: int, W: int,
                 sphere_r: float = 1.0) -> np.ndarray:
    """Analytic render of a textured sphere at the origin over a gradient
    background."""
    c2w = np.linalg.inv(ext)
    X, Y = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([X, Y, np.ones_like(X)], axis=-1).astype(np.float64)
    dirs = pix @ np.linalg.inv(ixt).T @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3]

    b = np.einsum("hwc,c->hw", dirs, -o)
    disc = b * b - (o @ o - sphere_r ** 2)
    hit = disc > 0
    t = b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    pts = o[None, None] + dirs * t[..., None]
    fg = _shade(pts)
    bg = _shade(dirs * 3.0) * 0.3 + 0.2
    img = np.where(hit[..., None], fg, bg)
    return img.astype(np.float32)


def make_cameras(n_views: int, H: int, W: int, radius: float = 4.0,
                 focal: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    focal = focal or 1.2 * max(H, W)
    ixt = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                   dtype=np.float64)
    exts, ixts = [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / max(n_views, 1) * 0.15  # clustered arc like DTU
        eye = np.array([radius * np.sin(ang),
                        -radius * np.cos(ang),
                        1.0 + 0.3 * np.sin(2 * ang)])
        exts.append(_look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0])))
        ixts.append(ixt.copy())
    return np.stack(exts), np.stack(ixts)


def make_synthetic_batch(cfg: Config, H: int = 64, W: int = 80,
                         n_src: Optional[int] = None, batch_size: int = 1,
                         split: str = "test",
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """A full fixed-shape ENeRF batch with padded views: padded source
    views carry ``view_mask = 0``, zero images and identity extrinsics."""
    rng = np.random.RandomState(seed)
    cas = cfg.enerf.cas_config
    S_max = cfg.enerf.max_views
    n_src = n_src or (cfg.enerf.test_input_views if split == "test"
                      else max(cfg.enerf.train_input_views))
    radius = 4.0
    near_far = np.array([radius - 1.5, radius + 1.5], np.float32)

    exts, ixts = make_cameras(n_src + 1, H, W, radius)
    tar_ext, tar_ixt = exts[0], ixts[0]
    src_exts, src_ixts = exts[1:], ixts[1:]

    tar_img = _render_view(tar_ext, tar_ixt, H, W)
    src_imgs = np.stack([_render_view(e, k, H, W)
                         for e, k in zip(src_exts, src_ixts)])

    pad = S_max - n_src
    view_mask = np.concatenate([np.ones(n_src), np.zeros(pad)]).astype(np.float32)
    if pad > 0:
        src_imgs = np.concatenate([src_imgs, np.zeros((pad, H, W, 3), np.float32)])
        src_exts = np.concatenate([src_exts, np.tile(np.eye(4)[None], (pad, 1, 1))])
        src_ixts = np.concatenate([src_ixts, np.tile(tar_ixt[None], (pad, 1, 1))])

    one = {
        "src_inps": (src_imgs * 2.0 - 1.0).astype(np.float32),
        "src_exts": src_exts.astype(np.float32),
        "src_ixts": src_ixts.astype(np.float32),
        "tar_ext": tar_ext.astype(np.float32),
        "tar_ixt": tar_ixt.astype(np.float32),
        "near_far": near_far,
        "view_mask": view_mask,
        "tar_img": tar_img,
    }
    msk = np.ones(tar_img.shape[:2], np.uint8)
    for i in range(cas.num):
        train_sample = split == "train" and not cas.train_img[i]
        rays, rgb, m = build_rays_host(
            tar_img, tar_ext.astype(np.float32), tar_ixt.astype(np.float32),
            msk, cas.render_scale[i], train_sample=train_sample,
            num_rays=cas.num_rays[i], rng=rng)
        one[f"rays_{i}"] = rays
        one[f"rgb_{i}"] = rgb
        one[f"msk_{i}"] = m.astype(np.float32)

    return {k: np.stack([v] * batch_size) for k, v in one.items()}

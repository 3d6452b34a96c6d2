"""Camera paths for free-viewpoint video; counterpart of
``enerf_tpu/utils/rend.py`` (reference lib/utils/rend_utils.py:
create_center_radius :66-87, gen_nerf_path / render_path_spiral :130-162,
viewmatrix / poses_avg), with ``utils/cv.py:rodrigues`` in place of
``cv2.Rodrigues``."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from enerf_tpu_torch.utils.cv import rodrigues


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return viewmatrix(vec2, up, center)


def create_center_radius(center, radius: float = 5.0, up: str = "y",
                         ranges: Sequence[float] = (0, 360, 36),
                         angle_x: float = 0.0) -> np.ndarray:
    """Circular orbit of w2c extrinsics (N, 3, 4) around ``center``
    (reference rend_utils.py:66-87)."""
    center = np.array(center, np.float64).reshape(1, 3)
    thetas = np.deg2rad(np.linspace(*ranges))
    st, ct = np.sin(thetas), np.cos(thetas)
    zero = np.zeros_like(st)
    Rotx = rodrigues(np.deg2rad(angle_x) * np.array([1.0, 0, 0]))
    if up == "z":
        cams = np.stack([radius * ct, radius * st, zero], axis=1) + center
        R = np.stack([-st, ct, zero,
                      zero, zero, zero - 1,
                      -ct, -st, zero], axis=-1)
    elif up == "y":
        cams = np.stack([radius * ct, zero, radius * st], axis=1) + center
        R = np.stack([+st, zero, -ct,
                      zero, zero - 1, zero,
                      -ct, zero, -st], axis=-1)
    else:
        raise ValueError(f"up must be 'y' or 'z', got {up}")
    R = R.reshape(-1, 3, 3)
    R = np.einsum("ab,fbc->fac", Rotx, R)
    T = -R @ cams.reshape(-1, 3, 1)
    return np.dstack([R, T])


def render_path_spiral(c2w: np.ndarray, up: np.ndarray, rads, focal: float,
                       zrate: float = 0.5, N_rots: int = 2,
                       N: int = 120) -> List[np.ndarray]:
    """LLFF-style spiral of c2w (3, 4) poses
    (reference rend_utils.py:154-162)."""
    poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * N_rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        poses.append(viewmatrix(z, up, c))
    return poses


def gen_nerf_path(c2ws: np.ndarray, depth_ranges, rads_scale: float = 0.5,
                  N_views: int = 60) -> List[np.ndarray]:
    """Spiral render path from training poses
    (reference rend_utils.py:130-143)."""
    c2w = poses_avg(c2ws)
    up = normalize(c2ws[:, :3, 1].sum(0))
    close_depth, inf_depth = depth_ranges
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = c2ws[:, :3, 3] - c2w[:3, 3][None]
    rads = np.percentile(np.abs(tt), 70, 0) * rads_scale
    return render_path_spiral(c2w, up, rads, focal, zrate=0.5, N=N_views)

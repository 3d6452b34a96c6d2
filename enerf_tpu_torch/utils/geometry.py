"""Geometry helpers: 3D bbox -> 2D bound mask, ray / AABB intersection;
counterpart of ``enerf_tpu/utils/geometry.py`` (reference
lib/utils/data_utils.py:28-39, base_utils.py:88-105, net_utils.py:13-28),
with ``utils/cv.py:fill_poly`` in place of ``cv2.fillPoly``."""

from __future__ import annotations

import numpy as np

from enerf_tpu_torch.utils.cv import fill_poly

# the six faces of a ``get_bound_corners`` box, as the reference draws them
_FACES = ([0, 1, 3, 2, 0], [4, 5, 7, 6, 5], [0, 1, 5, 4, 0],
          [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1])


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    """(2, 3) min / max -> (8, 3) corners, min-z-first ordering
    (reference base_utils.py:88-101)."""
    mi, ma = bounds[0], bounds[1]
    return np.array([
        [mi[0], mi[1], mi[2]], [mi[0], mi[1], ma[2]],
        [mi[0], ma[1], mi[2]], [mi[0], ma[1], ma[2]],
        [ma[0], mi[1], mi[2]], [ma[0], mi[1], ma[2]],
        [ma[0], ma[1], mi[2]], [ma[0], ma[1], ma[2]],
    ])


def project(xyz: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """World points -> pixel coordinates (reference base_utils.py:63-72)."""
    xyz = xyz @ RT[:3, :3].T + RT[:3, 3:].T
    xyz = xyz @ K.T
    return xyz[..., :2] / xyz[..., 2:]


def get_bound_2d_mask(cam_points: np.ndarray, K: np.ndarray, H: int,
                      W: int) -> np.ndarray:
    """The six faces of a camera-space bbox filled into an (H, W) u8 mask
    (reference data_utils.py:28-39). ``cam_points``: (8, 3+) corners
    already in camera coordinates, in ``get_bound_corners``' order."""
    pts = cam_points[:, :3] @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        c2d = np.round(pts[..., :2] / pts[..., 2:]).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in _FACES:
        fill_poly(mask, c2d[face], 1)
    return mask


def get_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """Ray / AABB entry-exit distances for the rays that hit the box
    (reference data_utils.py:606-621). Returns (near, far, mask_at_box)."""
    norm_d = np.linalg.norm(ray_d, axis=-1, keepdims=True)
    viewdir = ray_d / norm_d
    viewdir = np.where((viewdir >= 0) & (viewdir < 1e-5), 1e-5, viewdir)
    viewdir = np.where((viewdir < 0) & (viewdir > -1e-5), -1e-5, viewdir)
    tmin = (bounds[:1] - ray_o[:1]) / viewdir
    tmax = (bounds[1:2] - ray_o[:1]) / viewdir
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    near = np.max(t1, axis=-1)
    far = np.min(t2, axis=-1)
    mask_at_box = near < far
    near = near[mask_at_box] / norm_d[mask_at_box, 0]
    far = far[mask_at_box] / norm_d[mask_at_box, 0]
    return near, far, mask_at_box


def rays_aabb_mask(rays: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Slab-test ray / AABB intersection -> mask_at_box
    (reference net_utils.py:13-28 gen_rays_bbox). ``rays``: (..., >=6)
    o|dir layout; ``bounds``: (2, 3)."""
    rays_o, rays_d = rays[..., :3], rays[..., 3:6]
    viewdir = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    viewdir = np.where((viewdir >= 0) & (viewdir < 1e-5), 1e-5, viewdir)
    viewdir = np.where((viewdir < 0) & (viewdir > -1e-5), -1e-5, viewdir)
    tmin = (bounds[0] - rays_o) / viewdir
    tmax = (bounds[1] - rays_o) / viewdir
    near = np.minimum(tmin, tmax).max(axis=-1)
    far = np.maximum(tmin, tmax).min(axis=-1)
    return near < far

"""Geometry helpers: 3D bbox -> 2D bound mask, ray / AABB intersection, a
projection matrix's decomposition; counterpart of
``enerf_tpu/utils/geometry.py`` (reference lib/utils/data_utils.py:28-39,
583-621, base_utils.py:88-105, net_utils.py:13-28), with
``utils/cv.py:fill_poly`` in place of ``cv2.fillPoly`` and
``decompose_projection`` in place of ``cv2.decomposeProjectionMatrix``."""

from __future__ import annotations

from typing import Tuple

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


def _givens(a: float, b: float) -> Tuple[float, float]:
    z = 1.0 / np.sqrt(a * a + b * b + np.finfo(np.float64).eps)
    return a * z, b * z


def rq_decomp3x3(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """M (3, 3) = R @ Q with R upper triangular and Q a rotation, by
    OpenCV's ``RQDecomp3x3``: Givens rotations about x, y, then z, then a
    180-degree turn that makes R's first two diagonal entries positive
    (the third keeps the sign of det M). Float64."""
    M = np.asarray(M, np.float64)
    c, s = _givens(M[2, 2], M[2, 1])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    R = M @ Qx
    R[2, 1] = 0.0
    c, s = _givens(R[2, 2], -R[2, 0])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    R = R @ Qy
    R[2, 0] = 0.0
    c, s = _givens(R[1, 1], R[1, 0])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = R @ Qz
    R[1, 0] = 0.0
    Q = Qz.T @ Qy.T @ Qx.T
    if R[0, 0] < 0:
        # about z if R[1, 1] < 0 too, else about y
        flip = np.diag([-1.0, -1.0, 1.0] if R[1, 1] < 0 else [-1.0, 1.0, -1.0])
    elif R[1, 1] < 0:
        flip = np.diag([1.0, -1.0, -1.0])                      # about x
    else:
        return R, Q
    return R @ flip, flip @ Q


def decompose_projection(P: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(K, R, t) of a (3, 4) projection matrix as
    ``cv2.decomposeProjectionMatrix`` gives them: K (3, 3) and R (3, 3)
    from ``rq_decomp3x3`` of P's left 3x3, t (4, 1) the homogeneous camera
    centre (P's null vector, any sign), computed in float64; K and R are
    returned in float64, t in P's type (as OpenCV 5.0 returns them)."""
    P = np.asarray(P)
    P64 = P.astype(np.float64)
    K, R = rq_decomp3x3(P64[:, :3])
    t = np.linalg.svd(np.vstack([P64, np.zeros((1, 4))]))[2][3]
    dt = P.dtype if P.dtype in (np.float32, np.float64) else np.float64
    return K, R, t.reshape(4, 1).astype(dt)


def load_K_Rt_from_P(filename=None, P=None):
    """Decompose a 3x4 projection matrix into intrinsics (4, 4) and the c2w
    pose (4, 4) float32 (reference data_utils.py:583-604). ``P`` or a text
    file of its 3 rows (a first line of 4 is skipped)."""
    if P is None:
        with open(filename) as f:
            lines = f.read().splitlines()
        if len(lines) == 4:
            lines = lines[1:]
        P = np.asarray([l.split(" ")[:4] for l in lines],
                       np.float32).squeeze()
    K, R, t = decompose_projection(P)
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    return intrinsics, pose


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

"""Epipolar sanity check of a batch's cameras; counterpart of
``enerf_tpu/utils/val_data.py`` (reference
lib/utils/enerf/val_data_utils.py:7-48): target keypoints' near-far
segments projected into every source view, to see by eye that the camera
conventions agree.

Without matplotlib or OpenCV: the figure is a u8 canvas (the target with
its keypoints, then each source view with its segments, side by side),
drawn by a line rasterizer of this module and written with
``utils/image_io.py``'s PNG writer. Keypoints come from
``good_features_to_track``, this module's Shi-Tomasi picker in
``cv2.goodFeaturesToTrack``'s order.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from enerf_tpu_torch.utils.image_io import imwrite
from enerf_tpu_torch.utils.img import colorize_depth, horizon_concate

# matplotlib's default colour cycle ("tab10"), the reference figure's
# colours
PALETTE = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                    [214, 39, 40], [148, 103, 189], [140, 86, 75],
                    [227, 119, 194], [127, 127, 127], [188, 189, 34],
                    [23, 190, 207]], np.uint8)


def rgb_to_gray(rgb_u8: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(..., COLOR_RGB2GRAY)`` of a u8 image: OpenCV 5's
    15-bit fixed-point weights (0.299, 0.587, 0.114 rounded to sum to
    2^15), rounded."""
    r, g, b = (rgb_u8[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


def min_eigen_map(gray: np.ndarray) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, 3, 3)`` in float64: the smaller
    eigenvalue of the 3x3 box sum of the Sobel gradients' products (scaled
    by 1 / (12 * 255) each), borders reflected without their edge pixel."""
    g = np.pad(gray.astype(np.float64), 1, mode="reflect")
    dx = (g[:-2, 2:] - g[:-2, :-2] + 2 * (g[1:-1, 2:] - g[1:-1, :-2])
          + g[2:, 2:] - g[2:, :-2])
    dy = (g[2:, :-2] - g[:-2, :-2] + 2 * (g[2:, 1:-1] - g[:-2, 1:-1])
          + g[2:, 2:] - g[:-2, 2:])
    H, W = gray.shape

    def box(a):
        a = np.pad(a, 1, mode="reflect")
        return sum(a[i:i + H, j:j + W] for i in range(3) for j in range(3))

    s2 = (1.0 / (4 * 3 * 255.0)) ** 2
    a, b, c = (0.5 * s2 * box(dx * dx), s2 * box(dx * dy),
               0.5 * s2 * box(dy * dy))
    return (a + c) - np.sqrt((a - c) ** 2 + b * b)


def good_features_to_track(gray: np.ndarray, max_corners: int,
                           quality_level: float = 0.01,
                           min_distance: float = 5.0) -> np.ndarray:
    """Shi-Tomasi corners of a u8 image, (N, 2) float32 x, y, in
    ``cv2.goodFeaturesToTrack``'s order: values above ``quality_level`` of
    the largest that are their 3x3 neighbourhood's maximum (the image's
    outer ring left out), strongest first, each kept if no kept corner
    lies closer than ``min_distance``, at most ``max_corners`` (0: all).

    OpenCV computes the eigenvalues in float32 with SIMD sums whose
    rounding depends on the pixel's column; this picker computes them in
    float64. Corners whose values tie exactly (symmetric synthetic shapes)
    therefore come in the raster order OpenCV's comparator gives equal
    values (later pixel first), which may differ from OpenCV's."""
    eig = min_eigen_map(gray)
    H, W = eig.shape
    eig = np.where(eig > eig.max() * quality_level, eig, 0.0)
    p = np.pad(eig, 1, mode="constant", constant_values=-np.inf)
    peak = np.max([p[i:i + H, j:j + W] for i in range(3) for j in range(3)],
                  axis=0)
    cand = np.zeros((H, W), bool)
    cand[1:-1, 1:-1] = ((eig[1:-1, 1:-1] != 0)
                        & (eig[1:-1, 1:-1] == peak[1:-1, 1:-1]))
    ys, xs = np.nonzero(cand)
    order = np.lexsort((-(ys * W + xs), -eig[ys, xs]))
    kept: List[tuple] = []
    md2 = float(min_distance) ** 2
    for k in order:
        x, y = int(xs[k]), int(ys[k])
        if all((x - kx) ** 2 + (y - ky) ** 2 >= md2 for kx, ky in kept):
            kept.append((x, y))
            if max_corners > 0 and len(kept) == max_corners:
                break
    return np.array(kept, np.float32).reshape(-1, 2)


def _keypoints(rgb: np.ndarray, num_points: int,
               rng: np.random.RandomState) -> np.ndarray:
    gray = rgb_to_gray((rgb * 255).astype(np.uint8))
    pts = good_features_to_track(gray, num_points * 4, 0.01, 5)
    if len(pts) < num_points:
        H, W = gray.shape
        return np.stack([rng.randint(0, W, num_points),
                         rng.randint(0, H, num_points)], -1).astype(np.float64)
    sel = rng.permutation(len(pts))[:num_points]
    return pts[sel].astype(np.float64)


def _to_src(points_depth: np.ndarray, tar_ext, tar_ixt, src_ext, src_ixt):
    """Target pixel + depth -> source pixel (the reference's
    ``transform``)."""
    uv, d = points_depth[:, :2], points_depth[:, 2:]
    cam = np.concatenate([uv, np.ones_like(d)], -1) @ np.linalg.inv(tar_ixt).T
    cam = cam * d
    world = (cam - tar_ext[:3, 3]) @ np.linalg.inv(tar_ext[:3, :3]).T
    src_cam = world @ src_ext[:3, :3].T + src_ext[:3, 3]
    pix = src_cam @ src_ixt.T
    return pix[:, :2] / pix[:, 2:]


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Draw the segment p0 -> p1 (float pixel x, y) one pixel wide into
    ``img`` (H, W, 3) in place: a DDA walk of max(|dx|, |dy|) + 1 rounded
    steps, the steps outside the image left out. A segment with an end
    that is not finite is not drawn."""
    (x0, y0), (x1, y1) = p0, p1
    if not np.isfinite([x0, y0, x1, y1]).all():
        return
    H, W = img.shape[:2]
    # a segment's far end can be wildly off-image: clip the walk's length
    # to the part that can cross the image
    n = int(min(max(abs(x1 - x0), abs(y1 - y0)), 4 * (H + W))) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.rint(x0 + (x1 - x0) * t).astype(np.int64)
    ys = np.rint(y0 + (y1 - y0) * t).astype(np.int64)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def draw_dot(img: np.ndarray, x: float, y: float, color,
             radius: int = 1) -> None:
    """A (2 radius + 1)^2 square at the rounded pixel (x, y), clipped."""
    cx, cy = int(np.rint(x)), int(np.rint(y))
    img[max(cy - radius, 0):max(cy + radius + 1, 0),
        max(cx - radius, 0):max(cx + radius + 1, 0)] = color


def _u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def vis_prob(std, depth, prob, depth_values, u: int, v: int,
             save_path: Optional[str] = None) -> np.ndarray:
    """The depth pdf at pixel (u, v) beside the depth and std maps
    (reference lib/networks/enerf/utils.py:669-687, an interactive figure
    upstream): a u8 canvas (H, 3 W, 3) of the colorized depth and std of
    item 0 with (u, v) marked, and the plot of prob over depth_values at
    (u, v) with the depth +- std interval at prob 0.1. Written as a PNG to
    ``save_path`` when it is given."""
    std, depth = np.asarray(std), np.asarray(depth)
    prob, depth_values = np.asarray(prob), np.asarray(depth_values)
    H, W = depth.shape[1:3]
    panels = []
    for m in (depth[0], std[0]):
        img = _u8(colorize_depth(m))
        draw_dot(img, v, u, PALETTE[0])
        panels.append(img)
    plot = np.full((H, W, 3), 255, np.uint8)
    xs = depth_values[0, :, u, v].astype(np.float64)
    ys = prob[0, :, u, v].astype(np.float64)
    d, s = float(depth[0, u, v]), float(std[0, u, v])
    x_lo, x_hi = min(xs.min(), d - s), max(xs.max(), d + s)
    y_lo, y_hi = min(ys.min(), 0.0), max(ys.max(), 0.1)
    m = 4                                             # margin in pixels

    def to_px(x, y):
        px = m + (x - x_lo) / max(x_hi - x_lo, 1e-12) * (W - 1 - 2 * m)
        py = H - 1 - m - (y - y_lo) / max(y_hi - y_lo, 1e-12) * (H - 1 - 2 * m)
        return px, py

    pts = [to_px(x, y) for x, y in zip(xs, ys)]
    for a, b in zip(pts[:-1], pts[1:]):
        draw_line(plot, a, b, PALETTE[0])
    for p in pts:
        draw_dot(plot, *p, PALETTE[0])
    draw_line(plot, to_px(d - s, 0.1), to_px(d + s, 0.1), PALETTE[1])
    canvas = horizon_concate(horizon_concate(panels[0], panels[1]), plot)
    if save_path:
        imwrite(save_path, canvas)
    return canvas


def validate(batch: Dict, num_points: int = 10, seed: int = 0,
             save_path: Optional[str] = None) -> List[np.ndarray]:
    """For each batch item, a u8 canvas of the target with ``num_points``
    keypoints, then every source view with each keypoint's near-far
    epipolar segment, one colour a keypoint. Each canvas is written as a
    PNG to ``save_path.format(b=b)`` when ``save_path`` is given. Returns
    the canvases."""
    rng = np.random.RandomState(seed)
    canvases = []
    for b in range(len(batch["tar_img"])):
        rgb = np.asarray(batch["tar_img"][b])
        src_inps = np.asarray(batch["src_inps"][b]) * 0.5 + 0.5
        near, far = np.asarray(batch["near_far"][b]).reshape(-1)[:2]
        pts = _keypoints(rgb, num_points, rng)
        pn = np.concatenate([pts, np.full_like(pts[:, :1], near)], -1)
        pf = np.concatenate([pts, np.full_like(pts[:, :1], far)], -1)
        colors = PALETTE[np.arange(len(pts)) % len(PALETTE)]

        canvas = _u8(rgb)
        for (x, y) in pts:
            draw_dot(canvas, x, y, PALETTE[0])
        tar_ext = np.asarray(batch["tar_ext"][b])
        tar_ixt = np.asarray(batch["tar_ixt"][b])
        for s in range(len(src_inps)):
            a = _to_src(pn, tar_ext, tar_ixt, np.asarray(batch["src_exts"][b][s]),
                        np.asarray(batch["src_ixts"][b][s]))
            c = _to_src(pf, tar_ext, tar_ixt, np.asarray(batch["src_exts"][b][s]),
                        np.asarray(batch["src_ixts"][b][s]))
            view = _u8(src_inps[s])
            for i in range(len(a)):
                draw_line(view, a[i], c[i], colors[i])
            canvas = horizon_concate(canvas, view)
        if save_path:
            imwrite(save_path.format(b=b), canvas)
        canvases.append(canvas)
    return canvases

"""The OpenCV calls of the JAX package's datasets, in numpy: the port's own
versions of ``cv2.undistort``, ``cv2.dilate``, ``cv2.fillPoly``,
``cv2.Rodrigues`` and ``cv2.boundingRect``, each computing what OpenCV
computes for the arguments the datasets pass (held against OpenCV in
``tests/test_torch_jpeg.py``). ``resize_by`` is ``cv2.resize(img, None,
fx=r, fy=r)`` through ``datasets/llff.py:resize_area`` (``INTER_AREA``)
and ``datasets/dtu.py:resize_nearest_scale`` (``INTER_NEAREST``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from enerf_tpu_torch.datasets.dtu import resize_nearest_scale
from enerf_tpu_torch.datasets.llff import resize_area

# OpenCV's remap tables: maps in 1/32 pixel (INTER_BITS 5), integer
# bilinear weights scaled by 2^15 (INTER_REMAP_COEF_BITS)
INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
REMAP_COEF_BITS = 15
# cv::undistort computes its map in stripes of this many pixels
_STRIPE_PIXELS = 1 << 12


def _inv3(m: np.ndarray) -> np.ndarray:
    """``cv::invert(DECOMP_LU)`` of a 3x3 double matrix: the cofactor
    formula OpenCV uses for n <= 3."""
    m = np.asarray(m, np.float64)
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if det == 0.0:
        raise ValueError("undistort: singular camera matrix")
    d = 1.0 / det
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
         (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
         (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
         (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d]])


def _dist5(D) -> Tuple[float, float, float, float, float]:
    d = np.asarray(D, np.float64).reshape(-1)
    if d.size not in (4, 5, 8, 12, 14) or np.any(d[5:] != 0):
        raise ValueError(f"undistort: {d.size} distortion coefficients; the "
                         "k1 k2 p1 p2 [k3] model is supported")
    d = np.concatenate([d[:5], np.zeros(5 - min(d.size, 5))])
    return tuple(float(v) for v in d)


def undistort_map(K, D, H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """The map of ``cv2.undistort(img, K, D)`` for an (H, W) image, as
    OpenCV rounds it (``initUndistortRectifyMap`` to ``CV_16SC2``): the
    integer source pixel (x, y) of each output pixel, (H, W, 2) int32, and
    its 1/32 sub-pixel table index ``ty * 32 + tx``, (H, W) int32. Each
    output pixel is mapped forward through the 5-term model in double,
    stripe by stripe as ``cv::undistort`` computes it."""
    A = np.asarray(K, np.float64).reshape(3, 3)
    k1, k2, p1, p2, k3 = _dist5(D)
    u0, v0, fx, fy = A[0, 2], A[1, 2], A[0, 0], A[1, 1]
    stripe = min(max(1, _STRIPE_PIXELS // max(W, 1)), H)
    j = np.arange(W, dtype=np.float64)
    iu = np.empty((H, W), np.float64)
    iv = np.empty((H, W), np.float64)
    for y0 in range(0, H, stripe):
        Ar = A.copy()
        Ar[1, 2] = v0 - y0
        ir = _inv3(Ar).reshape(-1)
        rows = np.arange(min(stripe, H - y0), dtype=np.float64)[:, None]
        _x = rows * ir[1] + ir[2] + j * ir[0]
        _y = rows * ir[4] + ir[5] + j * ir[3]
        _w = rows * ir[7] + ir[8] + j * ir[6]
        w = 1.0 / _w
        x, y = _x * w, _y * w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
        xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
        yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
        iu[y0:y0 + len(rows)] = fx * xd + u0
        iv[y0:y0 + len(rows)] = fy * yd + v0
    # saturate_cast<int>: round half to even
    lim = float(np.iinfo(np.int32).max)
    iu = np.clip(np.rint(iu * INTER_TAB_SIZE), -lim - 1, lim).astype(np.int64)
    iv = np.clip(np.rint(iv * INTER_TAB_SIZE), -lim - 1, lim).astype(np.int64)
    # the integer part is stored as a short
    xy = np.stack([iu >> INTER_BITS, iv >> INTER_BITS], -1)
    xy = ((xy + 2 ** 15) % 2 ** 16 - 2 ** 15).astype(np.int32)
    frac = ((iv & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE
            + (iu & (INTER_TAB_SIZE - 1))).astype(np.int32)
    return xy, frac


def _bilinear_tables() -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``initInterTab2D(INTER_LINEAR)``: for each of the 32 x 32
    sub-pixel positions the four weights (w00, w01, w10, w11) in float32
    and scaled by 2^15 to int32."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.float32) * np.float32(
        1.0 / INTER_TAB_SIZE)
    one = np.stack([np.float32(1) - t, t], -1)           # (32, 2)
    ty, tx = np.meshgrid(np.arange(INTER_TAB_SIZE), np.arange(INTER_TAB_SIZE),
                         indexing="ij")
    f = (one[ty.reshape(-1)][:, :, None] * one[tx.reshape(-1)][:, None, :]
         ).reshape(-1, 4).astype(np.float32)
    i = np.rint(f.astype(np.float64) * (1 << REMAP_COEF_BITS)).astype(np.int32)
    return f, i


_TAB_F, _TAB_I = _bilinear_tables()


def remap_bilinear(img: np.ndarray, xy: np.ndarray, frac: np.ndarray
                   ) -> np.ndarray:
    """``cv2.remap(img, xy, frac, INTER_LINEAR, BORDER_CONSTANT)`` with
    fixed-point maps: the four neighbours of each mapped pixel (zeros
    outside the image) weighted by the sub-pixel table. Float32 images sum
    ``((v00 w00 + v01 w01) + v10 w10) + v11 w11`` in float32; u8 images
    the integer weights, rounded back by (sum + 2^14) >> 15."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.uint8):
        raise TypeError(f"remap_bilinear: float32 or uint8 image, got "
                        f"{img.dtype}")
    H, W = img.shape[:2]
    sx, sy = xy[..., 0].astype(np.int64), xy[..., 1].astype(np.int64)
    u8 = img.dtype == np.uint8
    wt = (_TAB_I if u8 else _TAB_F)[frac]                # (h, w, 4)
    acc = None
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        yy, xx = sy + dy, sx + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        shape = inside.shape + (1,) * (img.ndim - 2)
        v = np.where(inside.reshape(shape), v, 0)
        w = wt[..., k].reshape(shape)
        term = v.astype(np.int64) * w if u8 else v * w
        acc = term if acc is None else acc + term
    if u8:
        return np.clip((acc + (1 << (REMAP_COEF_BITS - 1)))
                       >> REMAP_COEF_BITS, 0, 255).astype(np.uint8)
    return acc.astype(np.float32)


def undistort(img: np.ndarray, K, D) -> np.ndarray:
    """``cv2.undistort(img, K, D)`` of a float32 or uint8 (H, W[, C]) image:
    the undistorted image at the same camera matrix, zeros where the map
    leaves the source."""
    xy, frac = undistort_map(K, D, img.shape[0], img.shape[1])
    return remap_bilinear(img, xy, frac)


def dilate(mask: np.ndarray, size: int = 5) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((size, size), np.uint8))``: the maximum
    over a centered ``size`` x ``size`` square (anchor at the center, the
    border adding nothing)."""
    if size < 1 or size % 2 == 0:
        raise ValueError(f"dilate: odd size expected, got {size}")
    mask = np.asarray(mask)
    r = size // 2
    pad = [(r, r), (r, r)] + [(0, 0)] * (mask.ndim - 2)
    low = np.iinfo(mask.dtype).min if mask.dtype.kind in "ui" else -np.inf
    p = np.pad(mask, pad, constant_values=low)
    H, W = mask.shape[:2]
    rows = p[:, 0:W].copy()
    for dx in range(1, size):
        np.maximum(rows, p[:, dx:dx + W], out=rows)
    out = rows[0:H].copy()
    for dy in range(1, size):
        np.maximum(out, rows[dy:dy + H], out=out)
    return out


# fillPoly's fixed point: x in 1/65536 pixel
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _i64(v: int) -> int:
    """``v`` wrapped to a C int64."""
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


def _div_trunc(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` for a w x h image: the end points moved onto
    [0, w-1] x [0, h-1] along the segment (in double, truncated), and
    whether the segment meets the image. Like OpenCV, it may move an end
    point of a segment that misses."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int,
           value) -> None:
    """OpenCV's 8-connected ``Line``: a ``LineIterator`` from left to
    right over the segment clipped to the image."""
    h, w = mask.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        x1, y1, x2, y2, inside = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # err < 0 steps the minor axis too
    steps = np.empty(dx + 1, np.int64)
    e = dx - 2 * dy
    for i in range(dx + 1):
        steps[i] = e < 0
        e += -2 * dy + (2 * dx if e < 0 else 0)
    minor = np.concatenate([[0], np.cumsum(steps[:-1])])
    major = np.arange(dx + 1, dtype=np.int64)
    if vert:
        xs, ys = x1 + minor, y1 + sy * major
    else:
        xs, ys = x1 + major, y1 + sy * minor
    mask[ys, xs] = value


def fill_poly(mask: np.ndarray, pts, value) -> np.ndarray:
    """``cv2.fillPoly(mask, [pts], value)`` in place (and returned): one
    polygon of integer vertices, no antialiasing (``LINE_8``), no shift.
    As OpenCV 5 fills: each edge is drawn as an 8-connected line clipped to
    the image; an edge that leaves the image takes the x of its clipped end
    points, and their y too unless clipping leaves them on one row (then
    the edge keeps its rows and runs straight down at the clipped x); then
    each row is filled from the ceiling of one fixed-point crossing to the
    floor of the next, for the 1st and 2nd sorted crossings, the 3rd and
    4th, ..., clipped to the image. The crossings of a closed polygon's
    edges on a row are even in number, so every edge steps on every row:
    its crossing on row y is ``x0 + (y - y0) dx``. Held against OpenCV, it
    is exact for polygons inside, across and behind the image's border
    (``tests/test_torch_jpeg.py``)."""
    pts = np.asarray(pts).reshape(-1, 2)
    # the vertices as OpenCV's Python binding passes them (int32)
    pts = np.clip(pts, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    h, w = mask.shape[:2]
    edges = []
    px0, py0 = int(pts[-1][0]) << _XY_SHIFT, int(pts[-1][1])
    for i in range(len(pts)):
        px1, py1 = int(pts[i][0]) << _XY_SHIFT, int(pts[i][1])
        t0x = (px0 + (_XY_ONE >> 1)) >> _XY_SHIFT
        t1x = (px1 + (_XY_ONE >> 1)) >> _XY_SHIFT
        _line8(mask, t0x, py0, t1x, py1, value)
        c0x, c0y, c1x, c1y = px0, py0, px1, py1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= py0 < h
                and 0 <= py1 < h):
            x0_, y0_, x1_, y1_, _ = _clip_line(w, h, t0x, py0, t1x, py1)
            if y0_ != y1_:
                c0y, c1y = y0_, y1_
            c0x, c1x = x0_ << _XY_SHIFT, x1_ << _XY_SHIFT
        if py0 != py1:
            dx = _div_trunc(c1x - c0x, c1y - c0y)
            if py0 < py1:
                edges.append((py0, py1, _i64(c0x + _i64((py0 - c0y) * dx)),
                              dx))
            else:
                edges.append((py1, py0, _i64(c1x + _i64((py1 - c1y) * dx)),
                              dx))
        px0, py0 = px1, py1
    _fill_edges(mask, edges, value)
    return mask


def _fill_edges(mask: np.ndarray, edges: list, value) -> None:
    """The scan fill of ``fill_poly`` over rows [0, h): on each row the
    crossings of the edges with y0 <= y < y1, sorted, filled from the
    ceiling of the 1st to the floor of the 2nd, the 3rd to the 4th, ..."""
    h, w = mask.shape[:2]
    if len(edges) < 2:
        return
    y0 = np.array([e[0] for e in edges], np.int64)
    y1 = np.array([e[1] for e in edges], np.int64)
    x0 = [e[2] for e in edges]
    ends = [_i64(e[2] + _i64((e[1] - e[0]) * e[3])) for e in edges]
    if (y1.max() < 0 or y0.min() >= h or max(x0 + ends) < 0
            or min(x0 + ends) >= (w << _XY_SHIFT)):
        return
    lo, hi = max(int(y0.min()), 0), min(int(y1.max()), h)
    if lo >= hi:
        return
    ys = np.arange(lo, hi, dtype=np.int64)
    active = (ys[:, None] >= y0) & (ys[:, None] < y1)
    # the crossings in int64 (C's wrap-around), sorted, inactive edges last
    xi = np.empty((len(ys), len(edges)), np.int64)
    for k, (a, b, x, dx) in enumerate(edges):
        with np.errstate(over="ignore"):
            xi[:, k] = np.int64(x) + (ys - a) * np.int64(dx)
    big = np.iinfo(np.int64).max
    xi = np.sort(np.where(active, xi, big), axis=1)
    n_act = active.sum(1)
    cover = np.zeros((len(ys), w + 1), np.int32)
    rows = np.arange(len(ys))
    for p in range(0, len(edges) - 1, 2):
        ok = n_act >= p + 2
        xa = (xi[:, p] + (_XY_ONE - 1)) >> _XY_SHIFT
        xb = xi[:, p + 1] >> _XY_SHIFT
        ok &= (xa < w) & (xb >= 0)
        xa = np.clip(xa, 0, w - 1)
        xb = np.clip(xb, 0, w - 1)
        np.add.at(cover, (rows[ok], xa[ok]), 1)
        np.add.at(cover, (rows[ok], xb[ok] + 1), -1)
    fill = np.cumsum(cover[:, :w], axis=1) > 0
    sub = mask[lo:hi]
    sub[fill] = value


def rodrigues(rvec) -> np.ndarray:
    """``cv2.Rodrigues(rvec)[0]`` for a rotation vector: the 3x3 rotation
    in OpenCV's arithmetic (double), in ``rvec``'s float dtype; identity
    when the angle is below ``DBL_EPSILON``."""
    src = np.asarray(rvec)
    r = src.astype(np.float64).reshape(3)
    theta = float(np.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]))
    dtype = src.dtype if src.dtype in (np.float32, np.float64) else np.float64
    if theta < np.finfo(np.float64).eps:
        return np.eye(3, dtype=dtype)
    c, s = np.cos(theta), np.sin(theta)
    c1 = 1.0 - c
    r = r * (1.0 / theta)
    x, y, z = r
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z],
                    [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return (c * np.eye(3) + c1 * rrt + s * r_x).astype(dtype)


def bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect`` of a 2-D mask: (x, y, w, h) of the smallest
    upright rectangle holding its non-zero pixels; (0, 0, 0, 0) when there
    are none."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return 0, 0, 0, 0
    x0, y0 = int(xs.min()), int(ys.min())
    return x0, y0, int(xs.max()) + 1 - x0, int(ys.max()) + 1 - y0


def resize_by(img: np.ndarray, ratio: float, nearest: bool = False
              ) -> np.ndarray:
    """``cv2.resize(img, None, fx=ratio, fy=ratio, interpolation=...)``
    with ``INTER_AREA`` (a float32 image), or ``INTER_NEAREST`` when
    ``nearest``: the output is ``saturate_cast<int>(W * ratio)`` wide
    (rounding half to even) and the source step is 1 / ratio."""
    if nearest:
        return resize_nearest_scale(img, ratio)
    hw = (int(np.rint(img.shape[0] * ratio)), int(np.rint(img.shape[1] * ratio)))
    return resize_area(img, hw, scale=(1.0 / ratio, 1.0 / ratio))

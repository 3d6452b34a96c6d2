"""Image grid / concat helpers and a depth colormap; counterpart of
``enerf_tpu/utils/img.py`` (reference lib/utils/img_utils.py:27-52).
Host numpy only."""

from __future__ import annotations

import numpy as np


def horizon_concate(inp0: np.ndarray, inp1: np.ndarray) -> np.ndarray:
    h0, w0 = inp0.shape[:2]
    h1, w1 = inp1.shape[:2]
    shape = (max(h0, h1), w0 + w1) + inp0.shape[2:]
    out = np.zeros(shape, inp0.dtype)
    out[:h0, :w0] = inp0
    out[:h1, w0:w0 + w1] = inp1
    return out


def vertical_concate(inp0: np.ndarray, inp1: np.ndarray) -> np.ndarray:
    h0, w0 = inp0.shape[:2]
    h1, w1 = inp1.shape[:2]
    shape = (h0 + h1, max(w0, w1)) + inp0.shape[2:]
    out = np.zeros(shape, inp0.dtype)
    out[:h0, :w0] = inp0
    out[h0:h0 + h1, :w1] = inp1
    return out


def colorize_depth(depth: np.ndarray, d_min=None, d_max=None) -> np.ndarray:
    """Min-max normalized turbo-ish colormap without matplotlib."""
    d_min = depth.min() if d_min is None else d_min
    d_max = depth.max() if d_max is None else d_max
    t = np.clip((depth - d_min) / max(d_max - d_min, 1e-8), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)

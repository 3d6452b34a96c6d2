"""Camera paths for free-viewpoint video; the part of
``enerf_tpu/utils/rend.py`` that the datasets use (reference
lib/utils/rend_utils.py: create_center_radius :66-87), with
``utils/cv.py:rodrigues`` in place of ``cv2.Rodrigues``."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from enerf_tpu_torch.utils.cv import rodrigues


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

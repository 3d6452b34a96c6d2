"""Interactive free-viewpoint camera (reference lib/interactive/camera.py,
glm-based); counterpart of ``enerf_tpu/interactive/camera.py``, the same
math in float64 numpy.

Conventions (reference camera.py:82-91): the camera basis is
right = normalize(front x world_up), down = front x right; c2w columns are
[right | down | front | center]. Drag gestures: rotate about front or the
origin, pan in the image plane, and a camera rail along B-splines (scipy
``splev``) driven by a scalar u in [0, 1) (camera.py:119-142).
"""

from __future__ import annotations

import numpy as np

PI = np.pi


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _rotation(angle: float, axis: np.ndarray) -> np.ndarray:
    """Rodrigues rotation matrix about ``axis`` (matches glm.rotate)."""
    axis = _normalize(np.asarray(axis, np.float64))
    c, s = np.cos(angle), np.sin(angle)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(axis, axis)


def _splev3(u: float, tck) -> np.ndarray:
    from scipy import interpolate

    return np.array(interpolate.splev(u, tck), np.float64).reshape(3)


class Camera:
    def __init__(self,
                 worldup=(0.0, 0.0, 1.0),
                 front=(-0.10432957, -0.93850941, -0.32911311),
                 center=(0.29572367, 3.29936877, 1.9140842),
                 front_tck=None, center_tck=None, worldup_tck=None):
        self.CLIP_NEAR = 1e-3
        # drag state
        self.is_dragging = False
        self.is_panning = False
        self.about_origin = False
        self.fix_y = False
        self.drag_start = np.zeros(2)
        self.movement_speed = 1.0

        self.width, self.height = 512, 512
        self.fx = self.fy = 1111.1
        self.center = np.array(center, np.float64)
        self.v_front = np.array(front, np.float64)
        self.v_world_up = np.array(worldup, np.float64)
        self.origin = np.zeros(3)
        self.c2w = np.eye(4)
        self.w2c = np.eye(4)
        self.update_trans()

        # camera-rail control (B-spline tcks from the dataset)
        self.front_tck = front_tck
        self.center_tck = center_tck
        self.worldup_tck = worldup_tck
        self.on_cam_path = False
        self.cam_path_u = 0.0

    @property
    def has_cam_path(self) -> bool:
        return (self.front_tck is not None and self.center_tck is not None
                and self.worldup_tck is not None)

    def update_trans(self):
        self.v_front = _normalize(self.v_front)
        self.v_right = _normalize(np.cross(self.v_front, self.v_world_up))
        self.v_down = np.cross(self.v_front, self.v_right)
        self.c2w = np.eye(4)
        self.c2w[:3, 0] = self.v_right
        self.c2w[:3, 1] = self.v_down
        self.c2w[:3, 2] = self.v_front
        self.c2w[:3, 3] = self.center
        R = self.c2w[:3, :3]
        self.w2c = np.eye(4)
        self.w2c[:3, :3] = R.T
        self.w2c[:3, 3] = -R.T @ self.center

    def intrinsics(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.width / 2.0],
                         [0, self.fy, self.height / 2.0],
                         [0, 0, 1]], np.float32)

    # -- drag gestures (reference camera.py:100-170) ------------------------
    def begin_drag(self, x, y, is_pan=False, about_origin=False, fix_y=False):
        self.is_dragging = True
        self.drag_start = np.array([x, y], np.float64)
        self.drag_start_front = self.v_front.copy()
        self.drag_start_right = self.v_right.copy()
        self.drag_start_down = self.v_down.copy()
        self.drag_start_center = self.center.copy()
        self.drag_start_origin = self.origin.copy()
        self.is_panning = is_pan
        self.about_origin = about_origin
        self.fix_y = fix_y
        self.drag_cam_path_u = self.cam_path_u

    def end_drag(self):
        self.is_dragging = False

    def update_from_cam_path(self):
        self.center = _splev3(self.cam_path_u, self.center_tck)
        self.v_front = _normalize(_splev3(self.cam_path_u, self.front_tck))
        self.v_world_up = _normalize(_splev3(self.cam_path_u, self.worldup_tck))
        self.update_trans()

    def drag_update(self, x, y):
        if not self.is_dragging:
            return
        delta = (np.array([x, y], np.float64) - self.drag_start)
        delta *= self.movement_speed / max(self.height, self.width)
        if self.fix_y:
            delta[1] = 0.0

        if self.has_cam_path and self.on_cam_path:
            self.cam_path_u = (self.drag_cam_path_u - delta[0]) % 1.0
            self.update_from_cam_path()
        elif self.is_panning:
            diff = delta[0] * self.drag_start_right + delta[1] * self.drag_start_down
            self.center = self.drag_start_center + diff
            if self.about_origin:
                self.origin = self.drag_start_origin + diff
        else:
            if self.about_origin:
                delta = -delta
            m = (_rotation(delta[0] % (2 * PI), self.v_world_up)
                 @ _rotation(delta[1], self.drag_start_right))
            self.v_front = m @ self.drag_start_front
            if self.about_origin:
                self.center = (-(m @ (self.origin - self.drag_start_center))
                               + self.origin)
        self.update_trans()

    def move(self, xyz):
        delta = np.asarray(xyz, np.float64) * self.movement_speed
        self.center = self.center + delta
        if self.is_dragging:
            self.drag_start_center = self.drag_start_center + delta
        self.update_trans()

    def get_c2w(self) -> np.ndarray:
        return self.c2w.astype(np.float32)

    def get_w2c(self) -> np.ndarray:
        return self.w2c.astype(np.float32)

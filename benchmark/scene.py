"""The benchmark's one frame generator: posed source views of a procedural
scene, drawn from the seed, and the target camera's rays, as the cells'
traffic files describe them (their ``scene`` block). It is a copy, moved
to the device, of the port's synthetic scene
(``enerf_tpu_torch/datasets/synthetic.py``: ``_look_at``, ``_shade``,
``_render_view``, ``make_cameras`` and ``make_synthetic_batch``, and the
full-grid branch of ``datasets/ray_utils.py:build_rays_host``), so that
the yardstick does not move with the program.

Two scene kinds:

- ``object_arc`` (DTU): a textured sphere at the origin seen from cameras
  on a clustered arc (``make_cameras``); each frame draws its arc's start
  angle, height, distance and texture phases, so every frame has its own
  target camera and source views.
- ``performer_rig`` (ZJU-MoCap): a performer's axis-aligned 3D box, an
  ellipsoid body inside it, a ring of rig cameras at one distance looking
  at the box, and target cameras on an orbit rail at that distance. A
  frame's source views are the rig cameras nearest its target;
  ``mask_at_box`` marks the target rays that hit the box (the dataset's
  slab test), ``bounds`` holds the box's corners (lo, hi); the near and
  far planes bracket the box.

Every tensor is float32 on the device, batch 1. The same seed gives the
same frames.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.spec import cascade


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


def _intrinsics(focal: float, H: int, W: int) -> np.ndarray:
    return np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                    dtype=np.float64)


def _pixel_dirs(ext: np.ndarray, ixt: np.ndarray, H: int, W: int, device):
    """World-space (unnormalized) directions and the origin of the pixel
    grid's rays: XYZ @ (K^-1)^T @ R_c2w^T, in float64."""
    c2w = np.linalg.inv(ext)
    M = torch.from_numpy(np.linalg.inv(ixt).T @ c2w[:3, :3].T).to(device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                            torch.arange(W, dtype=torch.float64, device=device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    return pix @ M, torch.from_numpy(c2w[:3, 3]).to(device), xs, ys


def grid_rays(ext: np.ndarray, ixt: np.ndarray, H: int, W: int, device
              ) -> torch.Tensor:
    """The (H·W, 8) raster-order rays o | d | x | y of a camera at the
    render size (H, W) (``ixt`` already at that size)."""
    d, o, xs, ys = _pixel_dirs(ext, ixt, H, W, device)
    rays = torch.cat([o.expand(H, W, 3), d, xs[..., None], ys[..., None]], -1)
    return rays.reshape(-1, 8).float()


def _shade(pts: torch.Tensor, phase: np.ndarray) -> torch.Tensor:
    """Smooth, view-consistent procedural texture of 3D points."""
    r = torch.sin(3.1 * pts[..., 0] + phase[0]) * 0.5 + 0.5
    g = torch.sin(2.3 * pts[..., 1] + 1.0 + phase[1]) * 0.5 + 0.5
    b = torch.sin(4.7 * pts[..., 2] + 2.0 + phase[2]) * 0.5 + 0.5
    return torch.stack([r, g, b], dim=-1)


def render_view(ext, ixt, H, W, center, radii, phase, bg_gain, device
                ) -> torch.Tensor:
    """Analytic render (H, W, 3) in [0, 1] of a textured ellipsoid at
    ``center`` with semi-axes ``radii`` over a shaded background of gain
    ``bg_gain`` (0: black)."""
    d, o, _, _ = _pixel_dirs(ext, ixt, H, W, device)
    d = d / d.norm(dim=-1, keepdim=True)
    c = torch.as_tensor(center, dtype=torch.float64, device=device)
    r = torch.as_tensor(radii, dtype=torch.float64, device=device)
    oo, dd = (o - c) / r, d / r            # the unit sphere's frame
    a = (dd * dd).sum(-1)
    b = (dd * oo).sum(-1)
    disc = b * b - a * ((oo * oo).sum() - 1.0)
    t = (-b - torch.sqrt(disc.clamp(min=0.0))) / a
    hit = (disc > 0) & (t > 0)
    pts = o + d * t[..., None]
    fg = _shade(pts, phase)
    bg = _shade(d * 3.0, phase) * 0.3 + 0.2
    img = torch.where(hit[..., None], fg, bg * bg_gain)
    return img.float()


def _area_down(img: torch.Tensor, k: int) -> torch.Tensor:
    """Mean over k×k blocks of (H, W, 3) (cv2.INTER_AREA at 1/k)."""
    H, W, C = img.shape
    return img.reshape(H // k, k, W // k, k, C).mean(dim=(1, 3))


def _pack(cas: dict, H: int, W: int, tar_ext, ixt, src_exts, src_ixts, imgs,
          tar_img, near_far, levels, device, train: bool) -> Dict:
    """A batch-1 dict of device tensors for the port and the reference."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)[None]
    S = len(src_exts)
    batch = {"src_inps": (imgs * 2.0 - 1.0)[None],
             "src_exts": f(src_exts), "src_ixts": f(src_ixts),
             "tar_ext": f(tar_ext), "tar_ixt": f(ixt),
             "near_far": f(near_far),
             "view_mask": torch.ones(1, S, device=device)}
    for i in levels:
        s = cas["render_scale"][i]
        k = ixt.copy()
        k[:2] *= s
        h, w = int(H * s), int(W * s)
        batch[f"rays_{i}"] = grid_rays(tar_ext, k, h, w, device)[None]
        if train:
            img = tar_img if s == 1.0 else _area_down(tar_img, int(round(1 / s)))
            batch[f"rgb_{i}"] = img.reshape(1, -1, 3).contiguous()
    return batch


def object_arc_frame(rng, scene: dict, cas: dict, H: int, W: int, S: int,
                     levels, device, train: bool) -> Dict:
    """One DTU-like frame: ``make_cameras``' clustered arc, its start
    angle, height and distance drawn from ``rng``."""
    radius = scene["radius"] + rng.uniform(-1, 1) * scene["radius_jitter"]
    focal = scene["focal_of_max_side"] * max(H, W)
    a0 = rng.uniform(0.0, 2.0 * math.pi)
    lift = rng.uniform(-1, 1) * scene["height_jitter"]
    exts = []
    for i in range(S + 1):
        ang = a0 + 2 * math.pi * i / (S + 1) * scene["arc_spread"]
        eye = np.array([radius * math.sin(ang), -radius * math.cos(ang),
                        1.0 + lift + 0.3 * math.sin(2 * ang)])
        exts.append(_look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0])))
    ixt = _intrinsics(focal, H, W)
    phase = rng.uniform(0.0, 2.0 * math.pi, size=3)
    r = scene["object_radius"]
    views = [render_view(e, ixt, H, W, (0, 0, 0), (r, r, r), phase, 1.0, device)
             for e in exts]
    near_far = [radius - scene["near_far_margin"], radius + scene["near_far_margin"]]
    batch = _pack(cas, H, W, exts[0], ixt, exts[1:], [ixt] * S,
                  torch.stack(views[1:]), views[0], near_far, levels, device,
                  train)
    return batch


def slab_margin(rays: torch.Tensor, lo, hi) -> torch.Tensor:
    """far − near of each ray o | d (N, >=6) through the box [lo, hi] along
    its unit direction, in float64: positive where the ray's line crosses
    the box (the slab test of ZJU-MoCap's ``mask_at_box``), in metres."""
    o, d = rays[:, :3].double(), rays[:, 3:6].double()
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=rays.device)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=rays.device)
    t0, t1 = (lo - o) / d, (hi - o) / d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return torch.where(far > 0, far - near, torch.full_like(far, -math.inf))


def slab_mask(rays: torch.Tensor, lo, hi) -> torch.Tensor:
    """Whether each ray o | d (N, >=6) hits the box [lo, hi] in front of
    its origin."""
    return slab_margin(rays, lo, hi) > 0


def performer_rig_frame(rng, scene: dict, cas: dict, H: int, W: int, S: int,
                        k: int, n_frames: int, rail0: float, levels, device,
                        train: bool) -> Dict:
    """Frame ``k`` of ``n_frames`` on the orbit rail that starts at angle
    ``rail0``: the performer's box of this video frame, the target camera
    on the rail, the ``S`` nearest rig cameras as source views."""
    half = np.array(scene["box_half"]) * (
        1.0 + rng.uniform(-1, 1, size=3) * scene["box_jitter"])
    center = np.array([0.0, 0.0, half[2]]) + np.append(
        rng.uniform(-1, 1, size=2) * scene["sway"], 0.0)
    lo, hi = center - half, center + half
    dist, cam_z = scene["distance"], center[2] + scene["camera_lift"]
    focal = scene["focal_of_max_side"] * max(H, W)
    ixt = _intrinsics(focal, H, W)
    look = np.array([center[0], center[1], center[2]])

    def cam(angle):
        eye = np.array([center[0] + dist * math.cos(angle),
                        center[1] + dist * math.sin(angle), cam_z])
        return _look_at(eye, look, np.array([0.0, 0.0, 1.0]))

    rail = rail0 + 2 * math.pi * scene["rail_turns"] * k / n_frames
    tar = cam(rail)
    n_rig = scene["rig_cameras"]
    rig = [2 * math.pi * j / n_rig for j in range(n_rig)]
    gap = [abs((a - rail + math.pi) % (2 * math.pi) - math.pi) for a in rig]
    near_views = np.argsort(gap, kind="stable")[:S]
    srcs = [cam(rig[j]) for j in near_views]
    phase = rng.uniform(0.0, 2.0 * math.pi, size=3)
    views = [render_view(e, ixt, H, W, center, half, phase, 0.0, device)
             for e in [tar] + srcs]
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    depths = (tar[:3, :3] @ corners.T + tar[:3, 3:4])[2]
    near_far = [max(depths.min() - scene["near_far_margin"], 0.05),
                depths.max() + scene["near_far_margin"]]
    batch = _pack(cas, H, W, tar, ixt, srcs, [ixt] * S, torch.stack(views[1:]),
                  views[0], near_far, levels, device, train)
    last = cas["num"] - 1
    batch["mask_at_box"] = slab_mask(batch[f"rays_{last}"][0], lo, hi).float()[None]
    batch["bounds"] = torch.tensor(np.stack([lo, hi]), dtype=torch.float32,
                                   device=device)[None]
    return batch


def make_frames(cfg: dict, traffic: dict, seed: int, device, n: int,
                train: bool = False) -> List[Dict]:
    """``n`` frames of the traffic's scene for configuration ``cfg`` (the
    configuration file's dict), drawn from ``seed``: each a batch-1 dict of
    float32 device tensors (``src_inps`` … ``rays_{i}``, and in training
    ``rgb_{i}``; ``mask_at_box`` for the performer), of the
    configuration's ``image_hw``."""
    scene = traffic["scene"]
    cas = cascade(cfg, train)
    H, W = cfg["image_hw"]
    S = cfg["source_views"]
    levels = [i for i in range(cas["num"]) if cas["render_if"][i]]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 len(traffic["name"])])
    if scene["kind"] == "object_arc":
        return [object_arc_frame(rng, scene, cas, H, W, S, levels, device, train)
                for _ in range(n)]
    if scene["kind"] == "performer_rig":
        rail0 = rng.uniform(0.0, 2.0 * math.pi)
        return [performer_rig_frame(rng, scene, cas, H, W, S, k, n, rail0,
                                    levels, device, train) for k in range(n)]
    raise ValueError(f"unknown scene kind {scene['kind']!r}")

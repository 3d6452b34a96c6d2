"""The ``outdoor_actor`` scene: ENeRF-Outdoor's layout (``actor1``), drawn
from the seed, as the batches of ``enerf_tpu_torch/datasets/
enerf_outdoor.py`` hold it, for the composite model.

- A rig of ``rig_cameras`` cameras on an arc of radius ``arc_radius`` m
  around the stage, spanning ``arc_span_deg``, each at ``camera_height``
  m looking at the stage's centre at ``aim_height`` m. A frame's target
  camera lies on the arc between two rig cameras, within
  ``target_span_deg`` of the arc's middle; its source views are the
  ``source_views`` rig cameras nearest to it.
- The performer: an axis-aligned box of half sizes ``box_half`` standing
  on the ground, textured, that walks a loop of half axes ``walk`` m
  (across the arc's middle view, then along it) over the ring's frames,
  from a phase drawn from the seed.
- The background: a textured ground plane (z = 0) and a back wall of
  height ``wall_height`` m facing the arc's middle camera at a depth drawn
  from ``wall_depth`` (m from that camera), a sky above it. The
  ``bg_src_inps`` are the source views without the performer.
- ``near_far``: the fg row from the depths of the box's corners in the
  target camera, the bg row from the depths of the background seen in the
  target view (``enerf_outdoor.py`` takes them from the bbox's corners and
  the background's points).
- ``bbox``: the fixed ``fg_bbox_hw`` window centred on the box's bounding
  rectangle in the target view, clamped into the frame
  (``enerf_outdoor.py:_fg_window``).

Cameras and geometry are worked out in float64 on the host; images and
rays are made on the device (``scene.py``'s pixel directions, whose
camera-space depth is 1 a unit, so a hit's ray parameter is its depth).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.scene import _intrinsics, _look_at, _pixel_dirs, _shade, grid_rays
from benchmark.spec import cascade


def _rig(scene: dict) -> List[float]:
    """The rig cameras' angles on the arc (0: the arc's middle)."""
    n, span = scene["rig_cameras"], math.radians(scene["arc_span_deg"])
    return [-span / 2 + span * j / (n - 1) for j in range(n)]


def _camera(scene: dict, angle: float) -> np.ndarray:
    r = scene["arc_radius"]
    eye = np.array([r * math.sin(angle), -r * math.cos(angle), scene["camera_height"]])
    return _look_at(eye, np.array([0.0, 0.0, scene["aim_height"]]),
                    np.array([0.0, 0.0, 1.0]))


def _corners(lo, hi) -> np.ndarray:
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])])


def fg_window(ext, ixt, lo, hi, H: int, W: int, fg_hw) -> List[int]:
    """[x, y, w, h] of the fixed window centred on the box's bounding
    rectangle in the view (its corners projected, clipped to the frame),
    clamped into the frame."""
    cam = _corners(lo, hi) @ ext[:3, :3].T + ext[:3, 3]
    uv = cam @ ixt.T
    uv = uv[:, :2] / uv[:, 2:]
    x0 = int(np.clip(np.floor(uv[:, 0].min()), 0, W - 1))
    x1 = int(np.clip(np.ceil(uv[:, 0].max()), 0, W - 1))
    y0 = int(np.clip(np.floor(uv[:, 1].min()), 0, H - 1))
    y1 = int(np.clip(np.ceil(uv[:, 1].max()), 0, H - 1))
    fh, fw = fg_hw
    x = x0 - (fw - (x1 - x0 + 1)) // 2
    y = y0 - (fh - (y1 - y0 + 1)) // 2
    return [int(np.clip(x, 0, W - fw)), int(np.clip(y, 0, H - fh)), fw, fh]


def frame_geometry(rng, scene: dict, H: int, W: int, S: int, fg_hw, k: int,
                   n_frames: int, phase0: float) -> dict:
    """Frame ``k``'s cameras, box and window (float64, on the host)."""
    half = np.array(scene["box_half"], dtype=np.float64)
    a = phase0 + 2 * math.pi * k / n_frames
    c = np.array([scene["walk"][0] * math.cos(a), scene["walk"][1] * math.sin(a)])
    lo = np.array([c[0] - half[0], c[1] - half[1], 0.0])
    hi = np.array([c[0] + half[0], c[1] + half[1], 2 * half[2]])
    rig = _rig(scene)
    span = math.radians(scene["target_span_deg"])
    mid = [j for j in range(len(rig) - 1)
           if abs(rig[j] + rig[j + 1]) / 2 <= span / 2]
    j = mid[int(rng.integers(0, len(mid)))]
    angle = rig[j] + (rig[j + 1] - rig[j]) * rng.uniform(0.2, 0.8)
    tar = _camera(scene, angle)
    near = np.argsort([abs(r - angle) for r in rig], kind="stable")[:S]
    ixt = _intrinsics(scene["focal_of_max_side"] * max(H, W), H, W)
    depths = (_corners(lo, hi) @ tar[:3, :3].T + tar[:3, 3])[:, 2]
    return {"tar": tar, "srcs": [_camera(scene, rig[i]) for i in near], "ixt": ixt,
            "lo": lo, "hi": hi, "fg_near_far": [depths.min(), depths.max()],
            "bbox": fg_window(tar, ixt, lo, hi, H, W, fg_hw)}


def _hits(ext, ixt, H, W, lo, hi, wall_depth, scene, device):
    """Per pixel of a view: the world point, the depth, the kind hit (0
    sky, 1 ground, 2 wall, 3 the box; ``lo`` None: no box) and the ray's
    direction."""
    d, o, _, _ = _pixel_dirs(ext, ixt, H, W, device)
    inf = torch.full(d.shape[:2], math.inf, dtype=d.dtype, device=device)
    t_best, kind = inf.clone(), torch.zeros(d.shape[:2], dtype=torch.long, device=device)

    def take(t, k):
        better = (t > 1e-6) & (t < t_best)
        t_best[better] = t[better]
        kind[better] = k

    dz = d[..., 2]
    take(torch.where(dz < 0, -o[2] / dz, inf), 1)
    # the wall faces the arc's middle camera, at (0, -arc_radius): its
    # points have y = wall_depth − arc_radius
    dy = d[..., 1]
    t = torch.where(dy > 0, (wall_depth - scene["arc_radius"] - o[1]) / dy, inf)
    z = o[2] + t * dz
    take(torch.where((z >= 0) & (z <= scene["wall_height"]), t, inf), 2)
    if lo is not None:
        lo_t = torch.as_tensor(lo, dtype=d.dtype, device=device)
        hi_t = torch.as_tensor(hi, dtype=d.dtype, device=device)
        dd = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t0, t1 = (lo_t - o) / dd, (hi_t - o) / dd
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        take(torch.where((tf > tn) & (tn > 0), tn, inf), 3)
    pts = o + d * torch.where(torch.isfinite(t_best), t_best, 0.0)[..., None]
    return pts, t_best, kind, d


def _image(pts, kind, d, phases) -> torch.Tensor:
    """The view's colours (H, W, 3) in [0, 1] from its hits (the sky's
    by the height of the ray's direction ``d``)."""
    ground = _shade(pts * 1.7, phases[0]) * 0.6 + 0.2
    wall = _shade(pts * 0.9, phases[1]) * 0.7 + 0.15
    box = _shade(pts * 4.0, phases[2])
    up = (d[..., 2:3] / d.norm(dim=-1, keepdim=True)).clamp(0, 1)
    sky = (0.55 + 0.35 * up).expand_as(ground) * torch.tensor(
        [0.6, 0.75, 1.0], dtype=ground.dtype, device=ground.device)
    img = torch.where((kind == 1)[..., None], ground, sky)
    img = torch.where((kind == 2)[..., None], wall, img)
    return torch.where((kind == 3)[..., None], box, img).float()


def render_views(geo: dict, scene: dict, wall_depth: float, phases, H: int, W: int,
                 device, box: bool):
    """The source views (S, H, W, 3) with the performer or without it
    (``box`` False)."""
    imgs = []
    lo, hi = (geo["lo"], geo["hi"]) if box else (None, None)
    for ext in geo["srcs"]:
        pts, _, kind, d = _hits(ext, geo["ixt"], H, W, lo, hi, wall_depth, scene, device)
        imgs.append(_image(pts, kind, d, phases))
    return torch.stack(imgs)


def bg_near_far(geo: dict, scene: dict, wall_depth: float, H: int, W: int, device):
    """The depths of the background seen in the target view: [min, max]."""
    _, t, kind, _ = _hits(geo["tar"], geo["ixt"], H, W, None, None, wall_depth, scene,
                          device)
    seen = t[kind > 0]
    return [float(seen.min()), float(seen.max())]


def make_frames(cfg: dict, traffic: dict, seed: int, device, n: int) -> List[Dict]:
    """``n`` frames of the ``outdoor_actor`` scene for configuration
    ``cfg``, drawn from ``seed``: batch-1 dicts of float32 device tensors
    (``src_inps``, ``bg_src_inps``, ``src_exts``, ``src_ixts``,
    ``tar_ext``, ``tar_ixt``, ``near_far`` (1, 2, 2), ``bbox`` (1, 1, 4),
    ``view_mask``, ``rays_{i}`` of each rendered level)."""
    scene = traffic["scene"]
    cas = cascade(cfg, False)
    H, W = cfg["image_hw"]
    S = cfg["source_views"]
    fg_hw = cfg["enerf"]["fg_bbox_hw"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 len(traffic["name"])])
    phase0 = rng.uniform(0.0, 2.0 * math.pi)
    wall_depth = rng.uniform(*scene["wall_depth"])
    phases = rng.uniform(0.0, 2.0 * math.pi, size=(3, 3))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)[None]
    frames = []
    for k in range(n):
        geo = frame_geometry(rng, scene, H, W, S, fg_hw, k, n, phase0)
        batch = {"src_inps": render_views(geo, scene, wall_depth, phases, H, W, device,
                                          True)[None] * 2.0 - 1.0,
                 "bg_src_inps": render_views(geo, scene, wall_depth, phases, H, W,
                                             device, False)[None] * 2.0 - 1.0,
                 "src_exts": f32(geo["srcs"]), "src_ixts": f32([geo["ixt"]] * S),
                 "tar_ext": f32(geo["tar"]), "tar_ixt": f32(geo["ixt"]),
                 "near_far": f32([geo["fg_near_far"],
                                  bg_near_far(geo, scene, wall_depth, H, W, device)]),
                 "bbox": f32([geo["bbox"]]),
                 "view_mask": torch.ones(1, S, device=device)}
        for i in range(cas["num"]):
            if cas["render_if"][i]:
                s = cas["render_scale"][i]
                kk = geo["ixt"].copy()
                kk[:2] *= s
                batch[f"rays_{i}"] = grid_rays(geo["tar"], kk, int(H * s), int(W * s),
                                               device)[None]
        frames.append(batch)
    return frames

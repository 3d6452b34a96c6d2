"""LLFF forward-facing dataset; counterpart of
``enerf_tpu/datasets/llff.py`` (reference lib/datasets/llff/enerf.py).

``poses_bounds.npy`` decode (columns: -u, r, -t convention → c2w), images
from ``images_4`` (intrinsics ×0.25) resized to ``input_h_w``, scene-global
near/far = min/max of all per-view bounds, view splits from
``data/mvsnerf/pairs.th``. Images are read by the port's PNG decoder and
downscaled by ``resize_area``, OpenCV's ``INTER_AREA`` in numpy.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.dtu import load_pairs
from enerf_tpu_torch.datasets.ray_utils import build_rays_host
from enerf_tpu_torch.utils.image_io import imread

SCENES = ("fern", "flower", "fortress", "horns", "leaves", "orchids",
          "room", "trex")


def _area_taps(ssize: int, dsize: int, scale: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` along one axis (``scale`` source
    pixels an output pixel): for each output index, the source indices and
    their float32 weights (the overlap of the output cell with each source
    pixel over the cell's width), padded with zero weights to a common tap
    count."""
    taps = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(r) for r in taps)
    idx = np.zeros((dsize, k), np.int64)
    wgt = np.zeros((dsize, k), np.float32)
    for d, row in enumerate(taps):
        for j, (si, a) in enumerate(row):
            idx[d, j], wgt[d, j] = si, a
    return idx, wgt


def _resize_area_int(img: np.ndarray, hw: Tuple[int, int], sy: int,
                     sx: int) -> np.ndarray:
    """OpenCV's ``resizeAreaFast`` (whole scale factors on both axes): each
    output pixel is the float32 sum of its sy x sx block, row by row,
    added in groups of four, times 1 / (sy sx); a block cut by the image's
    edge is the sum of its pixels over their count."""
    h, w = hw
    H, W = img.shape[:2]
    area = sy * sx
    offs = [(dy, dx) for dy in range(sy) for dx in range(sx)]
    hb, wb = min(h, H // sy), min(w, W // sx)
    out = np.zeros((h, w) + img.shape[2:], np.float32)

    def tap(dy, dx):
        return img[dy:dy + hb * sy:sy, dx:dx + wb * sx:sx]

    acc = np.zeros((hb, wb) + img.shape[2:], np.float32)
    k = 0
    while k + 4 <= area:
        acc += ((tap(*offs[k]) + tap(*offs[k + 1])) + tap(*offs[k + 2])
                ) + tap(*offs[k + 3])
        k += 4
    for dy, dx in offs[k:]:
        acc += tap(dy, dx)
    out[:hb, :wb] = acc * np.float32(1.0 / area)
    for y in range(h):
        for x in range(w):
            if y < hb and x < wb:
                continue
            block = img[y * sy:(y + 1) * sy, x * sx:(x + 1) * sx]
            n = block.shape[0] * block.shape[1]
            if n == 0:
                continue
            total = np.zeros(img.shape[2:], np.float32)
            for row in block:
                for px in row:
                    total += px
            out[y, x] = total / np.float32(n)
    return out


def resize_area(img: np.ndarray, hw: Tuple[int, int],
                scale: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` for a
    float32 (H, W[, C]) image and a downscale on both axes: each output
    pixel averages the source pixels its cell covers, weighted by overlap,
    the rows of a source line first, then the lines, in float32 in
    OpenCV's order; at whole scale factors OpenCV's block average
    (``_resize_area_int``). ``scale`` (source pixels an output pixel, y
    and x) is OpenCV's when the call gives ``fx``, ``fy`` (1 / fx); by
    default H / h and W / w. Raises on an upscale (OpenCV switches to
    another filter there)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    h, w = hw
    if h > H or w > W:
        raise ValueError(f"resize_area: ({H}, {W}) -> ({h}, {w}) is an "
                         "upscale; only downscales are supported")
    if (h, w) == (H, W) and scale is None:
        return img.copy()
    sy, sx = scale if scale is not None else (1.0 / (h / H), 1.0 / (w / W))
    eps = np.finfo(np.float64).eps
    if abs(sy - round(sy)) < eps and abs(sx - round(sx)) < eps:
        return _resize_area_int(img, hw, int(round(sy)), int(round(sx)))
    xi, xw = _area_taps(W, w, sx)
    yi, yw = _area_taps(H, h, sy)
    shape = (-1,) + (1,) * (img.ndim - 2)
    rows = np.zeros((H, w) + img.shape[2:], np.float32)
    for k in range(xi.shape[1]):
        rows += img[:, xi[:, k]] * xw[:, k].reshape(shape)
    out = np.zeros((h, w) + img.shape[2:], np.float32)
    for k in range(yi.shape[1]):
        out += rows[yi[:, k]] * yw[:, k].reshape((-1, 1) + (1,) * (img.ndim - 2))
    return out


class Dataset:
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig):
        self.cfg = cfg
        self.split = ds_cfg.split
        self.data_root = os.path.join(cfg.workspace, ds_cfg.data_root)
        self.input_h_w = tuple(ds_cfg.input_h_w or (640, 960))
        self.scenes = [ds_cfg.scene] if ds_cfg.scene else list(SCENES)
        self.rng = np.random.RandomState(0 if cfg.fix_random else None)
        self.build_metas()

    def build_metas(self):
        pairs = load_pairs()
        self.scene_infos: Dict[str, Dict] = {}
        self.metas: List = []
        for scene in self.scenes:
            pb = np.load(os.path.join(self.data_root, scene,
                                      "poses_bounds.npy"))
            poses = pb[:, :15].reshape(-1, 3, 5)
            c2ws = np.tile(np.eye(4)[None], (len(poses), 1, 1))
            # column convention: (-u, r, -t) → (r, -u ... ) flip
            # (reference llff/enerf.py:40-43)
            c2ws[:, :3, 0] = poses[:, :3, 1]
            c2ws[:, :3, 1] = poses[:, :3, 0]
            c2ws[:, :3, 2] = -poses[:, :3, 2]
            c2ws[:, :3, 3] = poses[:, :3, 3]
            ixts = np.tile(np.eye(3)[None], (len(poses), 1, 1))
            ixts[:, 0, 0] = ixts[:, 1, 1] = poses[:, 2, 4]
            ixts[:, 0, 2] = poses[:, 1, 4] / 2.0
            ixts[:, 1, 2] = poses[:, 0, 4] / 2.0
            ixts[:, :2] *= 0.25  # images_4 (reference :47)

            names = sorted(n for n in os.listdir(
                os.path.join(self.data_root, scene, "images_4"))
                if ".png" in n)
            info = {"ixts": ixts.astype(np.float32),
                    "c2ws": c2ws.astype(np.float32),
                    "image_names": names,
                    "depth_ranges": pb[:, -2:].astype(np.float32),
                    "scene_name": scene}
            self.scene_infos[scene] = info

            train_ids = pairs[f"{scene}_train"]
            render_ids = train_ids if self.split == "train" \
                else pairs[f"{scene}_val"]
            tc2ws = c2ws[train_ids]
            n_src = (self.cfg.enerf.train_input_views[1] + 1
                     if self.split == "train"
                     else self.cfg.enerf.test_input_views)
            for i in render_ids:
                dist = np.linalg.norm(
                    info["c2ws"][i][:3, 3][None] - tc2ws[:, :3, 3], axis=-1)
                order = dist.argsort()
                order = order[1:] if i in train_ids else order
                src_views = [train_ids[j] for j in order[:n_src]]
                self.metas.append((scene, i, src_views))

    def read_image(self, info, idx):
        path = os.path.join(self.data_root, info["scene_name"], "images_4",
                            info["image_names"][idx])
        img = imread(path).astype(np.float32)
        orig_size = img.shape[:2][::-1]
        return resize_area(img, self.input_h_w), orig_size

    def read_cam(self, info, idx, orig_size):
        ext = np.linalg.inv(info["c2ws"][idx].astype(np.float64))
        ixt = info["ixts"][idx].copy()
        ixt[0] *= self.input_h_w[1] / orig_size[0]
        ixt[1] *= self.input_h_w[0] / orig_size[1]
        return ixt.astype(np.float32), ext.astype(np.float32)

    def __getitem__(self, index_meta):
        index, n_views = index_meta
        scene, tar_view, src_views = self.metas[index]
        if self.split == "train":
            if self.rng.random_sample() < 0.1:
                src_views = src_views + [tar_view]
            sel = self.rng.permutation(len(src_views))[:n_views]
            src_views = [src_views[i] for i in sel]
        info = self.scene_infos[scene]

        tar_img, orig = self.read_image(info, tar_view)
        tar_img = native.u8_to_unit(tar_img)
        tar_ixt, tar_ext = self.read_cam(info, tar_view, orig)
        tar_mask = np.ones_like(tar_img[..., 0]).astype(np.uint8)

        src_inps, src_exts, src_ixts = [], [], []
        for sv in src_views:
            img, orig = self.read_image(info, sv)
            src_inps.append(native.u8_to_pm1(img))
            ixt, ext = self.read_cam(info, sv, orig)
            src_exts.append(ext)
            src_ixts.append(ixt)

        S_max = self.cfg.enerf.max_views
        pad = S_max - len(src_views)
        view_mask = np.concatenate(
            [np.ones(len(src_views)), np.zeros(pad)]).astype(np.float32)
        for _ in range(pad):
            src_inps.append(np.zeros_like(src_inps[0]))
            src_exts.append(np.eye(4, dtype=np.float32))
            src_ixts.append(tar_ixt.copy())

        dr = info["depth_ranges"]
        near_far = np.array([dr[:, 0].min(), dr[:, 1].max()], np.float32)
        ret = {
            "src_inps": np.stack(src_inps),
            "src_exts": np.stack(src_exts),
            "src_ixts": np.stack(src_ixts),
            "tar_ext": tar_ext,
            "tar_ixt": tar_ixt,
            "near_far": near_far,
            "view_mask": view_mask,
            "meta": {"scene": scene, "tar_view": tar_view, "frame_id": 0},
        }
        if self.split != "train":
            ret["tar_img"] = tar_img
            ret["tar_mask"] = tar_mask

        cas = self.cfg.enerf.cas_config
        for i in range(cas.num):
            train_sample = self.split == "train" and not cas.train_img[i]
            rays, rgb, msk = build_rays_host(
                tar_img, tar_ext, tar_ixt, tar_mask, cas.render_scale[i],
                train_sample=train_sample, num_rays=cas.num_rays[i],
                num_patches=cas.num_patchs[i], patch_size=cas.patch_size[i],
                rng=self.rng)
            ret[f"rays_{i}"] = rays
            ret[f"rgb_{i}"] = rgb
            ret[f"msk_{i}"] = msk.astype(np.float32)
        return ret

    def __len__(self):
        return len(self.metas)

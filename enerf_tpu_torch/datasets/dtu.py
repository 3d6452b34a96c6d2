"""DTU MVS dataset; counterpart of ``enerf_tpu/datasets/dtu.py``
(reference lib/datasets/dtu/enerf.py).

49 cameras a scene from ``Cameras/train/*_cam.txt`` (MVSNet text format,
intrinsics ×4 to full resolution), PFM ground-truth depth (×0.5, then the
crop [44:556, 80:720]), nearest-train-camera source-view selection, fixed
near/far [425, 905]. Emits fixed-shape samples padded to S_max with
``view_mask``. Images are read by the port's PNG decoder and resized with
numpy: no imageio, no OpenCV.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.ray_utils import build_rays_host
from enerf_tpu_torch.utils.image_io import imread

DEPTH_RANGES = (425.0, 905.0)


def _read_pfm_payload(path: str):
    """(header, (h, w) or (h, w, 3) payload rows bottom-up, |scale|): the
    endianness from the scale's sign, little-endian when negative."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if dims is None:
            raise ValueError(f"{path}: bad PFM size line")
        w, h = map(int, dims.groups())
        scale = float(f.readline().decode("utf-8").rstrip())
        data = np.fromfile(f, "<f4" if scale < 0 else ">f4")
    shape = (h, w, 3) if header == "PF" else (h, w)
    return header, data.reshape(shape), abs(scale)


def read_pfm(path: str):
    """Minimal PFM reader (reference lib/utils/data_utils.py:68-103):
    (top-down rows, |scale|)."""
    _, payload, scale = _read_pfm_payload(path)
    return np.flipud(payload), scale


def read_pfm_depth_half(path: str) -> np.ndarray:
    """Grayscale PFM -> f32 depth at half resolution: the flipud +
    cv2.resize(INTER_NEAREST, 0.5) chain (reference dtu/enerf.py:90-91)
    fused into one native pass over the raw bottom-up payload."""
    header, payload, _ = _read_pfm_payload(path)
    if header != "Pf":  # color pfm: fall back to the generic reader
        return read_pfm(path)[0].astype(np.float32)[::2, ::2]
    if payload.dtype != np.float32:  # big-endian source
        payload = payload.astype(np.float32)
    return native.pfm_flip_downsample(payload, 2)


def write_pfm(path: str, depth: np.ndarray) -> None:
    """A (h, w) f32 depth map as a little-endian grayscale PFM (rows
    bottom-up, scale -1), as DTU's ``Depths/*/depth_map_*.pfm`` are."""
    depth = np.asarray(depth, np.float32)
    with open(path, "wb") as f:
        f.write(f"Pf\n{depth.shape[1]} {depth.shape[0]}\n-1\n".encode())
        f.write(np.ascontiguousarray(depth[::-1]).astype("<f4").tobytes())


def read_cam_file(path: str):
    """MVSNet camera txt: extrinsic 4x4 + intrinsic 3x3 + depth params
    (reference data_utils.py:41-52)."""
    with open(path) as f:
        lines = [l.rstrip() for l in f.readlines()]
    ext = np.array(" ".join(lines[1:5]).split(), np.float32).reshape(4, 4)
    ixt = np.array(" ".join(lines[7:10]).split(), np.float32).reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    return ixt, ext, depth_min


def resize_nearest_scale(img: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=scale, fy=scale, INTER_NEAREST)`` in
    numpy: the output is round(H * scale) × round(W * scale) (OpenCV's
    ``saturate_cast<int>``, round half to even), and destination pixel
    (y, x) takes source pixel (floor(y / scale), floor(x / scale)) clamped
    into the source, as OpenCV's ``resizeNN`` computes it."""
    H, W = img.shape[:2]
    inv = 1.0 / scale
    ys = np.minimum(np.floor(np.arange(round(H * scale)) * inv)
                    .astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(round(W * scale)) * inv)
                    .astype(np.int64), W - 1)
    return img[ys[:, None], xs[None, :]]


class Dataset:
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig):
        self.cfg = cfg
        self.split = ds_cfg.split
        self.data_root = os.path.join(cfg.workspace, ds_cfg.data_root)
        self.input_ratio = ds_cfg.input_ratio
        self.scenes = [ds_cfg.scene] if ds_cfg.scene else []
        self.rng = np.random.RandomState(0 if cfg.fix_random else None)
        self.build_metas(ds_cfg.ann_file)

    # -- meta construction (reference dtu/enerf.py:32-79) -----------------
    def build_metas(self, ann_file: str):
        with open(ann_file) as f:
            scenes = [l.strip() for l in f.readlines()]
        if self.scenes:
            scenes = self.scenes
        pairs = load_pairs()

        self.scene_infos: Dict[str, Dict] = {}
        self.metas: List = []
        for scene in scenes:
            info = {"ixts": [], "exts": [], "dpt_paths": [], "img_paths": []}
            for i in range(49):
                cam_path = os.path.join(
                    self.data_root, f"Cameras/train/{i:08d}_cam.txt")
                ixt, ext, _ = read_cam_file(cam_path)
                ixt = ixt.copy()
                ixt[:2] *= 4
                info["ixts"].append(ixt.astype(np.float32))
                info["exts"].append(ext.astype(np.float32))
                info["dpt_paths"].append(os.path.join(
                    self.data_root, f"Depths/{scene}/depth_map_{i:04d}.pfm"))
                info["img_paths"].append(os.path.join(
                    self.data_root,
                    f"Rectified/{scene}_train/rect_{i + 1:03d}_3_r5000.png"))

            if self.split == "train" and len(self.scenes) != 1:
                train_ids = list(range(49))
                test_ids = list(range(49))
            elif self.split == "train":
                train_ids = pairs["dtu_train"]
                test_ids = pairs["dtu_train"]
            else:
                train_ids = pairs["dtu_train"]
                test_ids = pairs["dtu_val"]
            info.update({"train_ids": train_ids, "test_ids": test_ids})
            self.scene_infos[scene] = info

            cam_pts = np.array([np.linalg.inv(info["exts"][i])[:3, 3]
                                for i in train_ids])
            n_src = (max(self.cfg.enerf.train_input_views) + 1
                     if self.split == "train"
                     else self.cfg.enerf.test_input_views)
            for tar in test_ids:
                c = np.linalg.inv(info["exts"][tar])[:3, 3]
                dist = np.linalg.norm(cam_pts - c[None], axis=-1)
                arg = dist.argsort()
                arg = arg[1:] if tar in train_ids else arg
                src_views = [train_ids[i] for i in arg[:n_src]]
                self.metas.append((scene, tar, src_views))

    # -- sample assembly (reference dtu/enerf.py:81-124) -------------------
    def __getitem__(self, index_meta):
        index, n_views = index_meta
        scene, tar_view, src_views = self.metas[index]
        if self.split == "train":
            if self.rng.random_sample() < 0.1:
                src_views = src_views + [tar_view]
            sel = self.rng.permutation(len(src_views[: n_views + 1]))[:n_views]
            src_views = [src_views[: n_views + 1][i] for i in sel]
        info = self.scene_infos[scene]

        tar_img = native.u8_to_unit(imread(info["img_paths"][tar_view]))
        tar_ext, tar_ixt = info["exts"][tar_view], info["ixts"][tar_view]

        if self.split != "train":
            tar_dpt = read_pfm_depth_half(info["dpt_paths"][tar_view])
            tar_dpt = tar_dpt[44:556, 80:720]
            tar_mask = (tar_dpt > 0.0).astype(np.uint8)
        else:
            tar_dpt = np.ones_like(tar_img[..., 0])
            tar_mask = np.ones(tar_img.shape[:2], np.uint8)

        src_inps, src_exts, src_ixts = [], [], []
        for sv in src_views:
            src_inps.append(native.u8_to_pm1(imread(info["img_paths"][sv])))
            src_exts.append(info["exts"][sv])
            src_ixts.append(info["ixts"][sv])

        # pad to S_max (the static-shape contract; no reference equivalent)
        S_max = self.cfg.enerf.max_views
        pad = S_max - len(src_views)
        view_mask = np.concatenate(
            [np.ones(len(src_views)), np.zeros(pad)]).astype(np.float32)
        for _ in range(pad):
            src_inps.append(np.zeros_like(src_inps[0]))
            src_exts.append(np.eye(4, dtype=np.float32))
            src_ixts.append(tar_ixt.copy())

        ret = {
            "src_inps": np.stack(src_inps),
            "src_exts": np.stack(src_exts).astype(np.float32),
            "src_ixts": np.stack(src_ixts).astype(np.float32),
            "tar_ext": tar_ext.astype(np.float32),
            "tar_ixt": tar_ixt.astype(np.float32),
            "near_far": np.array(DEPTH_RANGES, np.float32),
            "view_mask": view_mask,
            "meta": {"scene": scene, "tar_view": tar_view, "frame_id": 0},
        }
        if self.split != "train":
            ret["tar_img"] = tar_img
            ret["tar_dpt"] = tar_dpt
            ret["tar_mask"] = tar_mask

        cas = self.cfg.enerf.cas_config
        for i in range(cas.num):
            train_sample = self.split == "train" and not cas.train_img[i]
            rays, rgb, msk = build_rays_host(
                tar_img, tar_ext, tar_ixt, tar_mask, cas.render_scale[i],
                train_sample=train_sample, num_rays=cas.num_rays[i],
                sample_on_mask=self.cfg.enerf.sample_on_mask,
                num_patches=cas.num_patchs[i], patch_size=cas.patch_size[i],
                rng=self.rng)
            ret[f"rays_{i}"] = rays
            ret[f"rgb_{i}"] = rgb
            ret[f"msk_{i}"] = msk.astype(np.float32)
            if self.split != "train":
                ret[f"tar_dpt_{i}"] = resize_nearest_scale(
                    tar_dpt, cas.volume_scale[i]).astype(np.float32)
        return ret

    def __len__(self):
        return len(self.metas)


def load_pairs():
    """data/mvsnerf/pairs.th — torch-pickled view-id splits, relative to
    the working directory (reference dtu/enerf.py:34)."""
    import torch

    return torch.load("data/mvsnerf/pairs.th", weights_only=False)

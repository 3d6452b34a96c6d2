"""NeRF-synthetic (Blender) dataset; counterpart of
``enerf_tpu/datasets/nerf_synthetic.py`` (reference
lib/datasets/nerf/enerf.py).

``transforms_train.json`` poses with the blender→cv flip ``b2c``, focal
from ``camera_angle_x`` at 800×800, alpha composited to white, fixed
near/far [2.5, 5.5], view splits from ``data/mvsnerf/pairs.th``. The
RGBA PNGs are read by the port's PNG decoder.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.dtu import load_pairs
from enerf_tpu_torch.datasets.ray_utils import build_rays_host
from enerf_tpu_torch.utils.image_io import imread

SCENES = ("chair", "drums", "ficus", "hotdog", "lego", "materials", "mic",
          "ship")
NEAR_FAR = (2.5, 5.5)
_B2C = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
                np.float64)


class Dataset:
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig):
        self.cfg = cfg
        self.split = ds_cfg.split
        self.data_root = os.path.join(cfg.workspace, ds_cfg.data_root)
        self.scenes = [ds_cfg.scene] if ds_cfg.scene else list(SCENES)
        self.rng = np.random.RandomState(0 if cfg.fix_random else None)
        self.build_metas()

    def build_metas(self):
        pairs = load_pairs()
        self.scene_infos: Dict[str, Dict] = {}
        self.metas: List = []
        for scene in self.scenes:
            info = {"ixts": [], "exts": [], "img_paths": []}
            with open(os.path.join(self.data_root, scene,
                                   "transforms_train.json")) as f:
                meta = json.load(f)
            focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"])
            for idx, frame in enumerate(meta["frames"]):
                c2w = np.array(frame["transform_matrix"]) @ _B2C
                ixt = np.eye(3)
                ixt[0, 0] = ixt[1, 1] = focal
                ixt[0, 2] = ixt[1, 2] = 400.0
                info["exts"].append(np.linalg.inv(c2w).astype(np.float32))
                info["ixts"].append(ixt.astype(np.float32))
                info["img_paths"].append(os.path.join(
                    self.data_root, scene, f"train/r_{idx}.png"))
            self.scene_infos[scene] = info

            train_ids = pairs[f"{scene}_train"]
            render_ids = train_ids if self.split == "train" \
                else pairs[f"{scene}_val"]
            c2ws = np.stack([np.linalg.inv(info["exts"][i])
                             for i in train_ids])
            # train pool size uses train_input_views[1] + 1
            # (reference nerf/enerf.py:66)
            n_src = (self.cfg.enerf.train_input_views[1] + 1
                     if self.split == "train"
                     else self.cfg.enerf.test_input_views)
            for idx in render_ids:
                c2w = np.linalg.inv(info["exts"][idx])
                dist = np.linalg.norm(c2w[:3, 3][None] - c2ws[:, :3, 3],
                                      axis=-1)
                order = dist.argsort()
                order = order[1:] if idx in train_ids else order
                src_views = [train_ids[i] for i in order[:n_src]]
                self.metas.append((scene, idx, src_views))

    def read_image(self, info, idx):
        img = imread(info["img_paths"][idx])
        if img.ndim == 3 and img.shape[-1] == 4:
            # alpha-composite onto white (reference nerf/enerf.py:127),
            # fused with the u8 -> [0,1] normalize in one native pass
            return native.u8_rgba_over_white(img)
        return native.u8_to_unit(img)

    def __getitem__(self, index_meta):
        index, n_views = index_meta
        scene, tar_view, src_views = self.metas[index]
        if self.split == "train":
            if self.rng.random_sample() < 0.1:
                src_views = src_views + [tar_view]
            sel = self.rng.permutation(len(src_views))[:n_views]
            src_views = [src_views[i] for i in sel]
        info = self.scene_infos[scene]

        tar_img = self.read_image(info, tar_view)
        tar_ext, tar_ixt = info["exts"][tar_view], info["ixts"][tar_view]
        tar_mask = np.ones_like(tar_img[..., 0]).astype(np.uint8)

        src_inps, src_exts, src_ixts = [], [], []
        for sv in src_views:
            src_inps.append(native.unit_to_pm1(self.read_image(info, sv)))
            src_exts.append(info["exts"][sv])
            src_ixts.append(info["ixts"][sv])

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
            "near_far": np.array(NEAR_FAR, np.float32),
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
                tar_img, tar_ext.astype(np.float32),
                tar_ixt.astype(np.float32), tar_mask, cas.render_scale[i],
                train_sample=train_sample, num_rays=cas.num_rays[i],
                num_patches=cas.num_patchs[i], patch_size=cas.patch_size[i],
                rng=self.rng)
            ret[f"rays_{i}"] = rays
            ret[f"rgb_{i}"] = rgb
            ret[f"msk_{i}"] = msk.astype(np.float32)
        return ret

    def __len__(self):
        return len(self.metas)

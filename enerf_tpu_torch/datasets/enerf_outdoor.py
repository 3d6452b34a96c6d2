"""ENeRF-Outdoor layered dataset; counterpart of
``enerf_tpu/datasets/enerf_outdoor.py`` (reference
lib/datasets/enerf_outdoor/enerf.py).

- easymocap ``intri.yml`` / ``extri.yml`` cameras (``utils/camera_io.py``);
  each JPEG undistorted, resized by ``input_ratio`` (area), then cropped
  to ``input_h_w`` about the center, 65 % of the vertical crop taken from
  the top (reference :120-133);
- per frame the visual-hull bbox ``vhull/{frame:06d}.npy`` -> fg near /
  far and the fg window; ``background.ply`` -> per-view bg near / far;
- ``bg_src_inps`` plates from ``bkgd/``, a 2-row ``near_far`` (fg layers
  + bg) and the fg ``bbox`` window.

The fg window has the fixed size ``cfg.enerf.fg_bbox_hw``, centered on the
bbox's bounding rectangle and clamped to the frame, as the JAX package
fixes it (its static-shape contract), where the reference rounds the bbox
up to x32 each frame.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List

import numpy as np

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.ray_utils import build_rays_host
from enerf_tpu_torch.datasets.zjumocap import view_range
from enerf_tpu_torch.utils.camera_io import read_camera
from enerf_tpu_torch.utils.cv import bounding_rect, resize_by, undistort
from enerf_tpu_torch.utils.geometry import get_bound_2d_mask, get_bound_corners
from enerf_tpu_torch.utils.image_io import imread
from enerf_tpu_torch.utils.ply import load_ply_vertices


class Dataset:
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig):
        self.cfg = cfg
        self.split = ds_cfg.split
        self.data_root = os.path.join(cfg.workspace, ds_cfg.data_root)
        self.input_ratio = ds_cfg.input_ratio
        self.input_h_w = ds_cfg.input_h_w
        self.frames = tuple(ds_cfg.frames)
        self.scene = ds_cfg.scene
        self.extra = dict(ds_cfg.extra)
        self.rng = np.random.RandomState(0 if cfg.fix_random else None)
        self.build_metas()

    def build_metas(self):
        scene_root = os.path.join(self.data_root, self.scene)
        self.scene_root = scene_root
        cams = read_camera(os.path.join(scene_root, "intri.yml"),
                           os.path.join(scene_root, "extri.yml"))
        cam_ids = sorted(c for c in os.listdir(os.path.join(scene_root,
                                                            "images"))
                         if c[0] != ".")
        n_cams = len(cam_ids)
        info = {
            "ixts": np.array([cams[c]["K"] for c in cam_ids],
                             np.float32).reshape(n_cams, 3, 3),
            "Ds": np.array([cams[c]["dist"] for c in cam_ids],
                           np.float32).reshape(n_cams, 5),
            "bbox": {},
        }
        exts = np.array([cams[c]["RT"] for c in cam_ids],
                        np.float32).reshape(n_cams, 3, 4)
        ones = np.zeros_like(exts[:, :1])
        ones[..., 3] = 1.0
        info["exts"] = np.concatenate([exts, ones], axis=1)
        self.scene_info = info

        frame_len = len(glob(f"{scene_root}/images/00/*.jpg"))
        frame_ids = view_range(self.frames, frame_len)
        for fid in frame_ids:
            bounds = np.load(os.path.join(scene_root, "vhull",
                                          f"{fid:06d}.npy"))
            info["bbox"][int(fid)] = get_bound_corners(bounds)

        # per-view background near / far from the background point cloud
        points = load_ply_vertices(os.path.join(scene_root, "background.ply"))
        self.bkgd_near_far = []
        for vi in range(n_cams):
            img, ext, ixt = self.read_data(vi, 0)
            h, w = img.shape[:2]
            cam_pts = points @ ext[:3, :3].T + ext[:3, 3].T
            uv = cam_pts @ ixt.T
            uv[:, :2] = uv[:, :2] / uv[:, 2:]
            keep = ((uv[:, 0] >= 0) & (uv[:, 1] >= 0)
                    & (uv[:, 0] <= w - 1) & (uv[:, 1] <= h - 1))
            z = uv[keep, 2]
            self.bkgd_near_far.append(np.array([z.min(), z.max()]))

        input_views = view_range(self.extra.get("input_views", (0, -1, 1)),
                                 n_cams)
        render_views = view_range(self.extra.get("render_views", (0, -1, 1)),
                                  n_cams)
        c2ws = np.linalg.inv(info["exts"])
        train_pos = c2ws[input_views, :3, 3]
        n_src = (self.cfg.enerf.train_input_views[-1] + 1
                 if self.split == "train"
                 else self.cfg.enerf.test_input_views)
        self.metas: List = []
        for tv in render_views:
            dist = np.linalg.norm(train_pos - c2ws[tv, :3, 3][None], axis=-1)
            order = dist.argsort()
            if tv not in input_views:
                src = [input_views[i] for i in order[:n_src]]
            else:
                src = [input_views[i] for i in order[1:n_src + 1]]
            self.metas += [(int(tv), src, int(fid)) for fid in frame_ids]

    # -- image IO (reference :120-157) --------------------------------------
    def _crop(self, img, ixt):
        if self.input_h_w is None:
            return img, ixt
        H, W = img.shape[:2]
        h, w = self.input_h_w
        ch = int((H - h) * 0.65)  # more of the crop from the top (:122)
        ch_ = (H - h) - ch
        cw = int((W - w) * 0.5)
        cw_ = W - w - cw
        img = img[ch:H - ch_, cw:W - cw_]
        ixt = ixt.copy()
        ixt[1, 2] -= ch
        ixt[0, 2] -= cw
        return img, ixt

    def _load_undistorted(self, path, view_id):
        img = native.u8_to_unit(imread(path))
        ixt = self.scene_info["ixts"][view_id].copy()
        img = undistort(img, ixt, self.scene_info["Ds"][view_id])
        if self.input_ratio != 1.0:
            img = resize_by(img, self.input_ratio)
            ixt[:2] *= self.input_ratio
        return self._crop(img, ixt)

    def read_data(self, view_id, frame_id):
        path = os.path.join(self.scene_root, "images", f"{view_id:02d}",
                            f"{frame_id:06d}.jpg")
        img, ixt = self._load_undistorted(path, view_id)
        return img, self.scene_info["exts"][view_id].copy(), ixt

    def read_data_bg(self, view_id):
        path = os.path.join(self.scene_root, "bkgd", f"{view_id:02d}.jpg")
        img, _ = self._load_undistorted(path, view_id)
        return img

    def _fg_window(self, bound_mask, H, W):
        """The fixed-size fg window centered on the bbox's bounding
        rectangle, clamped to the frame."""
        x, y, w, h = bounding_rect(bound_mask.astype(np.uint8))
        fh, fw = self.cfg.enerf.fg_bbox_hw
        x -= (fw - w) // 2
        y -= (fh - h) // 2
        x = int(np.clip(x, 0, W - fw))
        y = int(np.clip(y, 0, H - fh))
        return np.array([[x, y, fw, fh]], np.int32)

    def tar_ext(self, view_id, frame_id):
        return self.scene_info["exts"][view_id].copy()

    def read_tar(self, view_id, frame_id):
        img, _, ixt = self.read_data(view_id, frame_id)
        ext = self.tar_ext(view_id, frame_id)
        corners = (self.scene_info["bbox"][frame_id] @ ext[:3, :3].T
                   + ext[:3, 3].T)
        bound_mask = get_bound_2d_mask(corners, ixt, img.shape[0],
                                       img.shape[1])
        near_far = np.array([corners[:, 2].min(), corners[:, 2].max()])
        xywh = self._fg_window(bound_mask, img.shape[0], img.shape[1])
        return img, ext, ixt, xywh, near_far

    def __getitem__(self, index_meta):
        index, n_views = index_meta
        tar_view, src_views, frame_id = self.metas[index]
        if self.split == "train":
            if self.rng.random_sample() < 0.1:
                src_views = src_views + [tar_view]
            pool = src_views[: n_views + 1]
            sel = self.rng.permutation(len(pool))[:n_views]
            src_views = [pool[i] for i in sel]

        tar_img, tar_ext, tar_ixt, xywh, near_far = self.read_tar(
            tar_view, frame_id)

        src_inps, src_exts, src_ixts, bg_inps = [], [], [], []
        for sv in src_views:
            img, ext, ixt = self.read_data(sv, frame_id)
            src_inps.append(native.unit_to_pm1(img))
            src_exts.append(ext)
            src_ixts.append(ixt)
            bg_inps.append(native.unit_to_pm1(self.read_data_bg(sv)))

        S_max = self.cfg.enerf.max_views
        pad = S_max - len(src_views)
        view_mask = np.concatenate(
            [np.ones(len(src_views)), np.zeros(pad)]).astype(np.float32)
        for _ in range(pad):
            src_inps.append(np.zeros_like(src_inps[0]))
            bg_inps.append(np.zeros_like(bg_inps[0]))
            src_exts.append(np.eye(4, dtype=np.float32))
            src_ixts.append(tar_ixt.copy())

        L = self.cfg.enerf.num_fg_layers
        nf = np.stack([near_far] * L + [self.bkgd_near_far[tar_view]]
                      ).astype(np.float32)
        ret = {
            "src_inps": np.stack(src_inps),
            "bg_src_inps": np.stack(bg_inps),
            "src_exts": np.stack(src_exts).astype(np.float32),
            "src_ixts": np.stack(src_ixts).astype(np.float32),
            "tar_ext": tar_ext.astype(np.float32),
            "tar_ixt": tar_ixt.astype(np.float32),
            "near_far": nf,
            "bbox": np.tile(xywh, (L, 1)).astype(np.int32),
            "view_mask": view_mask,
            "meta": {"scene": f"{self.scene}_{frame_id:04d}",
                     "tar_view": tar_view, "frame_id": frame_id},
        }
        if self.split != "train":
            ret["tar_img"] = tar_img

        cas = self.cfg.enerf.cas_config
        ones = np.ones_like(tar_img[..., 0])
        for i in range(cas.num):
            train_sample = self.split == "train" and not cas.train_img[i]
            rays, rgb, msk = build_rays_host(
                tar_img, tar_ext.astype(np.float32), tar_ixt, ones,
                cas.render_scale[i], train_sample=train_sample,
                num_rays=cas.num_rays[i],
                num_patches=cas.num_patchs[i], patch_size=cas.patch_size[i],
                rng=self.rng)
            ret[f"rays_{i}"] = rays
            ret[f"rgb_{i}"] = rgb
            ret[f"msk_{i}"] = msk.astype(np.float32)
        return ret

    def __len__(self):
        return len(self.metas)

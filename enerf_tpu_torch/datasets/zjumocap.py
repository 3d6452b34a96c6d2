"""ZJU-MoCap dynamic-human dataset; counterpart of
``enerf_tpu/datasets/zjumocap.py`` (reference
lib/datasets/zjumocap/enerf.py).

- ``annots.npy`` cameras (K, R, T/1000, distortion);
- per frame the SMPL-vertex bbox (+-0.1 m) -> camera-space near / far and
  the 2-D ``mask_at_box`` of its faces;
- frame and view ranges ``[begin, end, step]``; source views picked by
  camera-center distance among the views nearest in direction
  (reference zjumocap/enerf.py:84-98);
- an image: the JPEG (the port's decoder), its mask (PNG) dilated 5 px,
  both undistorted, resized by ``input_ratio`` (area for the image,
  nearest for the mask), the background zeroed; the OpenCV calls are
  ``utils/cv.py``'s;
- fixed-shape samples padded to S_max with ``view_mask``; the train split
  draws from ``self.rng`` in the JAX package's order (source views, then
  rays).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.ray_utils import build_rays_host
from enerf_tpu_torch.utils.cv import dilate, resize_by, undistort
from enerf_tpu_torch.utils.geometry import get_bound_2d_mask
from enerf_tpu_torch.utils.image_io import imread


def view_range(spec, n: int) -> np.ndarray:
    """The views ``[begin, end, step]`` of ``n`` (end -1: all)."""
    b, e, s = spec
    return np.arange(n)[b:(e if e != -1 else n):s]


class Dataset:
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig):
        self.cfg = cfg
        self.split = ds_cfg.split
        self.data_root = os.path.join(cfg.workspace, ds_cfg.data_root)
        self.input_ratio = ds_cfg.input_ratio
        self.scenes = [ds_cfg.scene]
        self.rng = np.random.RandomState(0 if cfg.fix_random else None)
        extra = dict(ds_cfg.extra)
        self.frames = tuple(ds_cfg.frames)
        self.input_views = tuple(extra.get("input_views", (0, -1, 1)))
        self.render_views = tuple(extra.get("render_views", (0, -1, 1)))
        self.build_metas()

    # -- metas (reference zjumocap/enerf.py:25-103) ------------------------
    def build_metas(self):
        self.scene_infos: Dict[str, Dict] = {}
        self.annots: Dict[str, Dict] = {}
        self.metas: List = []
        for scene in self.scenes:
            scene_root = os.path.join(self.data_root, scene)
            annots = np.load(os.path.join(scene_root, "annots.npy"),
                             allow_pickle=True).item()
            info = {"ixts": [], "exts": [], "Ds": [], "bbox": {}}
            cam_len = len(annots["cams"]["K"])
            for ci in range(cam_len):
                R = np.array(annots["cams"]["R"][ci])
                T = np.array(annots["cams"]["T"][ci]) / 1000.0
                ext = np.eye(4)
                ext[:3, :3], ext[:3, 3:] = R, T.reshape(3, 1)
                info["exts"].append(ext.astype(np.float32))
                info["ixts"].append(np.array(annots["cams"]["K"][ci],
                                             np.float32))
                info["Ds"].append(np.array(annots["cams"]["D"][ci],
                                           np.float32))

            frame_ids = view_range(self.frames, len(annots["ims"]))
            for fid in frame_ids:
                verts = np.load(f"{scene_root}/new_vertices/{fid + 1}.npy")
                mi, ma = verts.min(0) - 0.1, verts.max(0) + 0.1
                corners = np.array([[x, y, z] for x in (mi[0], ma[0])
                                    for y in (mi[1], ma[1])
                                    for z in (mi[2], ma[2])])
                info["bbox"][int(fid)] = corners

            self.scene_infos[scene] = info
            self.annots[scene] = annots
            train_ids = view_range(self.input_views, cam_len)
            render_ids = view_range(self.render_views, cam_len)

            c2ws = np.linalg.inv(np.array(info["exts"]))
            pos, dirs = c2ws[train_ids, :3, 3], c2ws[train_ids, :3, :3]
            n_src = (self.cfg.enerf.train_input_views[-1] + 1
                     if self.split == "train"
                     else self.cfg.enerf.test_input_views)
            for rid in render_ids:
                d_pos = np.linalg.norm(pos - c2ws[rid, :3, 3][None], axis=-1)
                d_dir = np.linalg.norm(dirs - c2ws[rid, :3, :3][None],
                                       axis=(1, 2))
                near_dir = set(d_dir.argsort()[: 2 * n_src].tolist())
                order = d_pos.argsort()
                if rid not in train_ids or self.split == "test":
                    cand = [train_ids[i] for i in order[: 2 * n_src]
                            if i in near_dir][:n_src]
                else:
                    cand = [train_ids[i] for i in order[1: 2 * n_src + 1]
                            if i in near_dir][:n_src]
                assert len(cand) >= min(n_src, len(train_ids)), (
                    f"too few source views for render view {rid}")
                self.metas += [(scene, int(rid), cand, int(fid))
                               for fid in frame_ids]

    # -- image I/O (reference zjumocap/enerf.py:126-155) -------------------
    def read_data(self, scene, view, frame_id):
        scene_root = os.path.join(self.data_root, scene)
        info = self.scene_infos[scene]
        rel = self.annots[scene]["ims"][frame_id]["ims"][view]
        img = native.u8_to_unit(imread(os.path.join(scene_root, rel)))
        mask = imread(os.path.join(scene_root, "mask", rel[:-4] + ".png"))
        mask = dilate((mask != 0).astype(np.uint8), 5)

        ext = info["exts"][view]
        ixt = info["ixts"][view].copy()
        img = undistort(img, ixt, info["Ds"][view])
        mask = undistort(mask, ixt, info["Ds"][view])
        if self.input_ratio != 1.0:
            img = resize_by(img, self.input_ratio)
            mask = resize_by(mask, self.input_ratio, nearest=True)
            ixt[:2] *= self.input_ratio
        img[mask == 0] = 0.0
        return img, mask, ext, ixt

    def read_tar(self, scene, view, frame_id):
        img, mask, ext, ixt = self.read_data(scene, view, frame_id)
        corners = self.scene_infos[scene]["bbox"][frame_id]
        cam = np.concatenate([corners, np.ones_like(corners[:, :1])],
                             -1) @ ext.T
        near_far = [max(cam[..., 2].min(), 0.1), cam[..., 2].max()]
        bound_mask = get_bound_2d_mask(cam, ixt, img.shape[0], img.shape[1])
        return img, ext, ixt, mask, near_far, bound_mask

    # -- sample assembly (reference zjumocap/enerf.py:105-124) -------------
    def __getitem__(self, index_meta):
        index, n_views = index_meta
        scene, tar_view, src_views, frame_id = self.metas[index]
        if self.split == "train":
            if self.rng.random_sample() < 0.05:
                src_views = src_views + [tar_view]
            pool = src_views[: n_views + 1]
            sel = self.rng.permutation(len(pool))[:n_views]
            src_views = [pool[i] for i in sel]

        tar_img, tar_ext, tar_ixt, tar_msk, near_far, mask_at_box = \
            self.read_tar(scene, tar_view, frame_id)

        src_inps, src_exts, src_ixts = [], [], []
        for sv in src_views:
            img, _, ext, ixt = self.read_data(scene, sv, frame_id)
            src_inps.append(native.unit_to_pm1(img))
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

        ret = {
            "src_inps": np.stack(src_inps),
            "src_exts": np.stack(src_exts).astype(np.float32),
            "src_ixts": np.stack(src_ixts).astype(np.float32),
            "tar_ext": tar_ext.astype(np.float32),
            "tar_ixt": tar_ixt.astype(np.float32),
            "near_far": np.array(near_far, np.float32),
            "view_mask": view_mask,
            "meta": {"scene": scene, "tar_view": tar_view,
                     "frame_id": frame_id},
        }
        if self.split != "train":
            ret["mask_at_box"] = mask_at_box.reshape(-1).astype(np.float32)
            ret["tar_img"] = tar_img
            ret["tar_mask"] = tar_msk

        cas = self.cfg.enerf.cas_config
        for i in range(cas.num):
            train_sample = self.split == "train" and not cas.train_img[i]
            rays, rgb, msk = build_rays_host(
                tar_img, tar_ext.astype(np.float32), tar_ixt, tar_msk,
                cas.render_scale[i], train_sample=train_sample,
                num_rays=cas.num_rays[i],
                sample_on_mask=self.cfg.enerf.sample_on_mask,
                num_patches=cas.num_patchs[i], patch_size=cas.patch_size[i],
                rng=self.rng)
            ret[f"rays_{i}"] = rays
            ret[f"rgb_{i}"] = rgb
            ret[f"msk_{i}"] = msk.astype(np.float32)
        return ret

    def __len__(self):
        return len(self.metas)

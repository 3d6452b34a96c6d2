"""Interactive ZJU-MoCap dataset (reference
lib/datasets/zjumocap/enerf_interactive.py); counterpart of
``enerf_tpu/datasets/zjumocap_interactive.py``.

Not an index-based dataset: ``__getitem__((frame, c2w, w2c))`` builds a
batch of tensors on ``device`` for any camera pose. Every frame's source
images are read and cached on the host at init (reference :138-153), as
``datasets/zjumocap.py`` reads them: the port's JPEG / PNG decoders,
``utils/cv.py``'s dilate and undistort, the ratio resize (area for the
image, nearest for the mask), the background zeroed. The pixel grid's
ray directions K^-1 [x, y, 1] are computed once and kept on ``device``
(:87-99). A query (``host_query`` then ``upload``):

- on the host: near / far from the frame's box corners in the camera, the
  ``test_input_views`` cameras nearest to it, padded to ``max_views`` with
  ``view_mask`` (camera 0's matrices in the padded slots, as in JAX);
- the upload: the chosen views' cached images (not the padded ones, which
  are zeros made on ``device``) and the small arrays;
- on ``device``: the rays (the grid rotated into the world) and
  ``mask_at_box``, the slab test of ``utils/geometry.rays_aabb_mask`` with
  its rule (the +-1e-5 clamp of the unit direction, ``near < far``) on the
  rays where they are, so nothing is read back. Against JAX's numpy mask
  the only differences are rays whose ``near - far`` lies within float
  rounding of 0.

Also the camera-rail API (``get_camera_tck``, reference :260-277).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.zjumocap import view_range
from enerf_tpu_torch.utils.cv import dilate, resize_by, undistort
from enerf_tpu_torch.utils.image_io import imread
from enerf_tpu_torch.utils.profiling import span


def rays_aabb_mask(rays: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """``utils/geometry.rays_aabb_mask`` in torch, on the rays' device:
    (..., >= 6) rays (origin | direction) against (2, 3) bounds; True
    where the ray's slab ``near`` is below its ``far``."""
    rays_o, rays_d = rays[..., :3], rays[..., 3:6]
    viewdir = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    viewdir = torch.where((viewdir >= 0) & (viewdir < 1e-5),
                          torch.full_like(viewdir, 1e-5), viewdir)
    viewdir = torch.where((viewdir < 0) & (viewdir > -1e-5),
                          torch.full_like(viewdir, -1e-5), viewdir)
    tmin = (bounds[0] - rays_o) / viewdir
    tmax = (bounds[1] - rays_o) / viewdir
    near = torch.minimum(tmin, tmax).amax(dim=-1)
    far = torch.maximum(tmin, tmax).amin(dim=-1)
    return near < far


class Dataset:
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.split = ds_cfg.split
        self.data_root = os.path.join(cfg.workspace, ds_cfg.data_root)
        self.scene = ds_cfg.scene
        self.input_ratio = ds_cfg.input_ratio
        extra = dict(ds_cfg.extra)

        scene_root = os.path.join(self.data_root, self.scene)
        annots = np.load(os.path.join(scene_root, "annots.npy"),
                         allow_pickle=True).item()
        self.annots = annots
        info = {"ixts": [], "exts": [], "Ds": [], "bbox": {}}
        cam_len = len(annots["cams"]["K"])
        for ci in range(cam_len):
            R = np.array(annots["cams"]["R"][ci])
            T = np.array(annots["cams"]["T"][ci]) / 1000.0
            ext = np.eye(4)
            ext[:3, :3], ext[:3, 3:] = R, T.reshape(3, 1)
            info["exts"].append(ext.astype(np.float32))
            info["ixts"].append(np.array(annots["cams"]["K"][ci], np.float32))
            info["Ds"].append(np.array(annots["cams"]["D"][ci], np.float32))

        self.render_frames = view_range(ds_cfg.frames,
                                        len(annots["ims"])).tolist()
        for fid in self.render_frames:
            verts = np.load(f"{scene_root}/new_vertices/{fid + 1}.npy")
            mi, ma = verts.min(0) - 0.1, verts.max(0) + 0.1
            info["bbox"][int(fid)] = np.array(
                [[x, y, z] for x in (mi[0], ma[0]) for y in (mi[1], ma[1])
                 for z in (mi[2], ma[2])])
        self.scene_info = info

        self.exts = np.array(info["exts"], np.float32)
        self.ixts = np.array(info["ixts"], np.float32).copy()
        c2ws = np.linalg.inv(self.exts)
        self.cam_points = c2ws[:, :3, 3].astype(np.float32)
        self.ixts[:, :2] *= self.input_ratio
        self.ixt = np.mean(self.ixts, axis=0).astype(np.float32)

        n_known = int(extra.get("n_known_cams", min(21, cam_len)))
        self.known_cams = np.arange(n_known)

        base_hw = extra.get("base_hw", (1024, 1024))
        self.input_h_w = [int(v * self.input_ratio) for v in base_hw]
        H, W = self.input_h_w
        X, Y = np.meshgrid(np.arange(W), np.arange(H))
        XYZ = np.concatenate(
            [X[..., None], Y[..., None], np.ones_like(X[..., None])],
            axis=-1).astype(np.float32)
        # the pixel grid and its directions, kept on the device
        self.XY = torch.from_numpy(np.concatenate(
            [X[..., None], Y[..., None]], -1).astype(np.float32)).to(
                self.device)
        self.XYZ = torch.from_numpy(
            XYZ @ np.linalg.inv(self.ixt).T).to(self.device)

        self.cache: Dict[int, Dict] = {}
        for fid in self.render_frames:
            self.cache_data(fid)

    # -- frame caching (reference :138-153) ---------------------------------
    def read_data(self, view: int, frame_id: int) -> np.ndarray:
        scene_root = os.path.join(self.data_root, self.scene)
        rel = self.annots["ims"][frame_id]["ims"][view]
        img = native.u8_to_unit(imread(os.path.join(scene_root, rel)))
        mask = imread(os.path.join(scene_root, "mask", rel[:-4] + ".png"))
        mask = dilate((mask != 0).astype(np.uint8), 5)
        ixt = self.scene_info["ixts"][view].copy()
        img = undistort(img, ixt, self.scene_info["Ds"][view])
        mask = undistort(mask, ixt, self.scene_info["Ds"][view])
        if self.input_ratio != 1.0:
            img = resize_by(img, self.input_ratio)
            mask = resize_by(mask, self.input_ratio, nearest=True)
        img[mask == 0] = 0.0
        return img

    def cache_data(self, frame: int) -> Dict:
        if frame in self.cache:
            return self.cache[frame]
        inps = native.collate([native.unit_to_pm1(self.read_data(c, frame))
                               for c in self.known_cams])
        verts = self.scene_info["bbox"][frame].astype(np.float32)
        bounds = np.stack([verts.min(0), verts.max(0)]).astype(np.float32)
        self.cache[frame] = {"inps": inps, "vertices": verts,
                             "bounds": bounds}
        return self.cache[frame]

    # -- per-query conversion (reference :169-227) ---------------------------
    def build_rays(self, c2w: np.ndarray):
        """(H W, 8) rays on the device: origin, direction, pixel x y."""
        H, W = self.input_h_w
        R = torch.from_numpy(np.ascontiguousarray(c2w[:3, :3])).to(self.device)
        dirs = self.XYZ @ R.T
        rays_o = torch.from_numpy(np.ascontiguousarray(c2w[:3, 3])).to(
            self.device).expand(H, W, 3)
        rays = torch.cat([rays_o, dirs, self.XY], dim=-1)
        return rays.reshape(-1, 8), H, W

    def host_query(self, frame: int, c2w: np.ndarray, w2c: np.ndarray
                   ) -> Dict:
        """The host side of a query (span ``query.host``): near / far, the
        chosen views and their padding, and the host arrays to upload."""
        with span("query.host"):
            cfg = self.cfg
            data = self.cache_data(frame)
            verts = data["vertices"] @ w2c[:3, :3].T + w2c[:3, 3:].T
            near_far = np.array([max(verts[:, 2].min(), 0.05),
                                 verts[:, 2].max()], np.float32)

            dist = np.linalg.norm(self.cam_points - c2w[:3, 3][None], axis=-1)
            near_views = np.argsort(dist)[: cfg.enerf.test_input_views]

            S_max = cfg.enerf.max_views
            pad = S_max - len(near_views)
            view_mask = np.concatenate(
                [np.ones(len(near_views)), np.zeros(pad)]).astype(np.float32)
            sel = np.concatenate([near_views, np.zeros(pad, near_views.dtype)])
            return {"c2w": c2w, "inps": data["inps"][near_views],
                    "n_pad": pad, "bounds": data["bounds"],
                    "tar_ext": np.asarray(w2c, np.float32),
                    "tar_ixt": self.ixt, "src_exts": self.exts[sel],
                    "src_ixts": self.ixts[sel], "view_mask": view_mask,
                    "near_far": near_far}

    def upload(self, host: Dict) -> Dict[str, torch.Tensor]:
        """The host arrays of ``host_query`` on the device (span
        ``query.upload``), the padded views' zeros made there; returns the
        batch without its rays. ``upload_bytes`` holds the bytes it
        copied."""
        self.upload_bytes = 0

        def put(a):
            a = np.ascontiguousarray(a)
            self.upload_bytes += a.nbytes
            return torch.from_numpy(a).to(self.device)

        with span("query.upload"):
            inps = put(host["inps"])
            if host["n_pad"]:
                inps = torch.cat([inps, inps.new_zeros(
                    (host["n_pad"],) + inps.shape[1:])])
            return {"src_inps": inps,
                    **{k: put(host[k]) for k in ("tar_ext", "tar_ixt",
                                                 "src_exts", "src_ixts",
                                                 "view_mask", "near_far",
                                                 "bounds")}}

    def finish(self, host: Dict, ret: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The device side of a query (span ``query.finish``): the rays and
        ``mask_at_box`` of ``host``'s camera; every key with a batch dim,
        as the model takes it (reference add_batch, data_utils.py:14-26)."""
        with span("query.finish"):
            i = self.cfg.enerf.cas_config.num - 1
            rays, _, _ = self.build_rays(host["c2w"])
            bounds = ret.pop("bounds")
            ret[f"rays_{i}"] = rays
            ret["mask_at_box"] = rays_aabb_mask(rays, bounds).float()
            return {k: v[None] for k, v in ret.items()}

    def __getitem__(self, query: Tuple[int, np.ndarray, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        index, c2w, w2c = query
        host = self.host_query(index, c2w, w2c)
        return self.finish(host, self.upload(host))

    # -- camera-path API (reference :239-277) --------------------------------
    def get_camera_up_front_center(self, index: int = 0):
        ext = self.exts[index]
        worldup = -ext.T[:3, 1]
        front = ext.T[:3, 2]
        center = -ext[:3, :3].T @ ext[:3, 3]
        return worldup, front, center

    def get_closest_camera(self, center: np.ndarray) -> int:
        return int(np.argmin(np.linalg.norm(self.cam_points - center,
                                            axis=-1)))

    def get_camera_tck(self, smoothing_term: float = 0.0):
        """Periodic B-splines through every camera's center, front and world
        up (reference :260-277, scipy ``splprep`` with ``per=1``)."""
        from scipy import interpolate

        exts = self.exts
        cens = (-np.einsum("bij,bj->bi",
                           exts[:, :3, :3].transpose(0, 2, 1),
                           exts[:, :3, 3])).T
        fros = exts[:, 2, :3].T
        wups = -exts[:, 1, :3].T
        cen_tck, cen_u = interpolate.splprep(cens, s=smoothing_term, per=1)
        fro_tck, fro_u = interpolate.splprep(fros, s=smoothing_term, per=1)
        wup_tck, wup_u = interpolate.splprep(wups, s=smoothing_term, per=1)
        return cen_tck, cen_u, fro_tck, fro_u, wup_tck, wup_u

    @property
    def n_cams(self) -> int:
        return len(self.known_cams)

    def __len__(self):
        return len(self.render_frames)

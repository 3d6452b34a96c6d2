"""ENeRF-Outdoor circular-path renderer; counterpart of
``enerf_tpu/datasets/enerf_outdoor_path.py`` (reference
lib/datasets/enerf_outdoor/enerf_path.py): the eval dataset's data, but
the target extrinsics come from a synthesized circular orbit
(``num_circle_view`` poses, ping-pong indexed over frames); the source
views are picked per frame by distance from the orbit camera, and the
target image and intrinsics come from camera 0 (enerf_path.py:186)."""

from __future__ import annotations

import numpy as np

from enerf_tpu_torch.config import Config, DatasetConfig
from enerf_tpu_torch.datasets.enerf_outdoor import Dataset as _Base
from enerf_tpu_torch.datasets.zjumocap import view_range
from enerf_tpu_torch.utils.rend import create_center_radius


class Dataset(_Base):
    def __init__(self, cfg: Config, ds_cfg: DatasetConfig):
        super().__init__(cfg, ds_cfg)
        num_views = int(self.extra.get("num_circle_view", 100))
        self.num_circle_view = num_views
        w2cs = create_center_radius(
            center=np.array([0.4, 0.25, 1.22]), angle_x=2, up="z",
            radius=5, ranges=[60, 120, num_views]).astype(np.float32)
        bottom = np.tile(np.array([[[0, 0, 0, 1.0]]], np.float32),
                         (num_views, 1, 1))
        self.w2cs = np.concatenate([w2cs, bottom], axis=1)
        self._rebuild_path_metas()

    def _path_index(self, frame_id: int) -> int:
        n = self.num_circle_view
        fwd = (frame_id // n) % 2 == 0
        return frame_id % n if fwd else n - 1 - frame_id % n

    def _rebuild_path_metas(self):
        """One meta per frame; the source views nearest to the orbit
        camera (reference enerf_path.py:105-115)."""
        n_cams = len(self.scene_info["exts"])
        input_views = view_range(self.extra.get("input_views", (0, -1, 1)),
                                 n_cams)
        c2ws = np.linalg.inv(self.scene_info["exts"])
        train_pos = c2ws[input_views, :3, 3]
        n_src = self.cfg.enerf.test_input_views

        frame_ids = sorted({fid for _, _, fid in self.metas})
        self.metas = []
        for fid in frame_ids:
            c2w = np.linalg.inv(self.w2cs[self._path_index(fid)])
            dist = np.linalg.norm(train_pos - c2w[:3, 3][None], axis=-1)
            order = dist.argsort()
            src = [input_views[i] for i in order[1:n_src + 1]]
            self.metas.append((-1, src, int(fid)))

    def tar_ext(self, view_id, frame_id):
        # ping-pong along the orbit (reference enerf_path.py:168)
        return self.w2cs[self._path_index(frame_id)].copy()

    def read_tar(self, view_id, frame_id):
        # the target image and intrinsics of camera 0
        # (reference enerf_path.py:186)
        return super().read_tar(0, frame_id)

"""Camera / projection math; counterpart of ``enerf_tpu/ops/camera.py``.

Extrinsics are world→camera 4x4, intrinsics 3x3; the plane-sweep projection
maps *target volume* pixel+depth to *source feature* pixels:

    proj = [K_src * s_src | 0] @ E_src @ inv([K_tar * s_tar | 0] @ E_tar)
"""

from __future__ import annotations

import torch


def scale_intrinsics(ixt: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale the first two rows of (..., 3, 3) intrinsics by ``scale``."""
    return torch.cat([ixt[..., :2, :] * scale, ixt[..., 2:, :]], dim=-2)


def get_proj_mats(src_exts: torch.Tensor, src_ixts: torch.Tensor,
                  tar_ext: torch.Tensor, tar_ixt: torch.Tensor,
                  src_scale: float, tar_scale: float) -> torch.Tensor:
    """Per-(batch, view) 3x4 src-from-target projection matrices.

    src_exts (B, S, 4, 4), src_ixts (B, S, 3, 3), tar_ext (B, 4, 4),
    tar_ixt (B, 3, 3). Returns (B, S, 3, 4)."""
    B = src_exts.shape[0]
    src_projs = scale_intrinsics(src_ixts, src_scale) @ src_exts[:, :, :3]
    tar_projs = scale_intrinsics(tar_ixt, tar_scale) @ tar_ext[:, :3]
    bottom = torch.zeros(B, 1, 4, dtype=tar_projs.dtype, device=tar_projs.device)
    bottom[..., 3] = 1.0
    tar_inv = torch.linalg.inv(torch.cat([tar_projs, bottom], dim=1))
    return src_projs @ tar_inv[:, None]


def cam_centers(exts: torch.Tensor) -> torch.Tensor:
    """Camera centers in world space from world→camera extrinsics:
    c = -R^T t. exts (..., 4, 4) → (..., 3)."""
    R = exts[..., :3, :3]
    t = exts[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)

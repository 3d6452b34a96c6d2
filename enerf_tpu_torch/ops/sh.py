"""Spherical-harmonics basis evaluation; counterpart of
``enerf_tpu/ops/sh.py`` (reference lib/networks/enerf/utils.py:797-873
eval_sh_bases; not on the stock forward path). Basis dims 1, 4, 9, 16, 25.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
# The standard real-SH degree-2 constants, as the JAX package corrected
# them (the reference's SH_C2 list, utils.py:802-809, has six entries and
# indexes the first five, which gives wrong constants for Y_2^0, Y_2^1 and
# Y_2^2; that code path is dead upstream).
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
SH_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
         -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
         0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh_bases(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """dirs: (..., 3) unit directions → (..., basis_dim) SH bases."""
    if basis_dim not in (1, 4, 9, 16, 25):
        raise ValueError(f"basis_dim must be 1, 4, 9, 16 or 25, got {basis_dim}")
    out = [torch.full(dirs.shape[:-1], SH_C0, dtype=dirs.dtype,
                      device=dirs.device)]
    if basis_dim > 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if basis_dim > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz,
                SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if basis_dim > 9:
        out += [SH_C3[0] * y * (3 * xx - yy),
                SH_C3[1] * xy * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy),
                SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    if basis_dim > 16:
        out += [SH_C4[0] * xy * (xx - yy),
                SH_C4[1] * yz * (3 * xx - yy),
                SH_C4[2] * xy * (7 * zz - 1),
                SH_C4[3] * yz * (7 * zz - 3),
                SH_C4[4] * (zz * (35 * zz - 30) + 3),
                SH_C4[5] * xz * (7 * zz - 3),
                SH_C4[6] * (xx - yy) * (7 * zz - 1),
                SH_C4[7] * xz * (xx - 3 * yy),
                SH_C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)

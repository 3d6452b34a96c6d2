"""Mesh extraction from a density query function; counterpart of
``enerf_tpu/utils/mesh.py`` (reference lib/utils/mesh_utils.py:7-45: dense
grid query -> marching cubes -> ply export through skimage and trimesh).

The isosurface is extracted by **marching tetrahedra** on the host (each
grid cube split into 6 tetrahedra): valid watertight triangles without the
256-entry cube tables, the JAX package's numpy code; its triangulation
differs from skimage's marching cubes. The density query runs where the
query function's device is, the card by default.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from enerf_tpu_torch import resolve_device
from enerf_tpu_torch.utils.ply import save_ply_mesh

# cube corner offsets, index = bit code (x<<2 | y<<1 | z legacy order kept
# simple: corner c -> offset)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
# 6 tetrahedra covering the cube (corner indices)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def _tet_triangles(p: np.ndarray, v: np.ndarray, level: float):
    """Triangles of the isosurface inside one batch of tetrahedra.

    p: (N, 4, 3) corner positions; v: (N, 4) densities.
    Returns (M, 3, 3) triangle vertices.
    """
    inside = v > level  # (N, 4)
    code = (inside * np.array([1, 2, 4, 8])).sum(-1)

    def interp(a, b):
        va, vb = v[np.arange(len(v)), a], v[np.arange(len(v)), b]
        t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
        pa, pb = p[np.arange(len(p)), a], p[np.arange(len(p)), b]
        return pa + t[:, None] * (pb - pa)

    tris = []
    # single-corner cases (1 triangle), double-corner cases (2 triangles)
    single = {1: (0, 1, 2, 3), 2: (1, 0, 3, 2), 4: (2, 0, 1, 3),
              8: (3, 0, 2, 1), 14: (0, 1, 2, 3), 13: (1, 0, 3, 2),
              11: (2, 0, 1, 3), 7: (3, 0, 2, 1)}
    double = {3: (0, 1, 2, 3), 5: (0, 2, 1, 3), 9: (0, 3, 1, 2),
              6: (1, 2, 0, 3), 10: (1, 3, 0, 2), 12: (2, 3, 0, 1)}
    for c in range(1, 15):
        m = code == c
        if not m.any():
            continue
        idx = np.where(m)[0]
        pi, vi = p[idx], v[idx]
        sub = lambda a, b: _interp_pairs(pi, vi, a, b, level)
        if c in single:
            a, b1, b2, b3 = single[c]
            t = np.stack([sub(a, b1), sub(a, b2), sub(a, b3)], axis=1)
            tris.append(t)
        elif c in double:
            a1, a2, b1, b2 = double[c]
            e11, e12 = sub(a1, b1), sub(a1, b2)
            e21, e22 = sub(a2, b1), sub(a2, b2)
            tris.append(np.stack([e11, e12, e21], axis=1))
            tris.append(np.stack([e21, e12, e22], axis=1))
    if not tris:
        return np.zeros((0, 3, 3))
    return np.concatenate(tris, axis=0)


def _interp_pairs(p, v, a, b, level):
    va, vb = v[:, a], v[:, b]
    t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
    return p[:, a] + np.clip(t, 0.0, 1.0)[:, None] * (p[:, b] - p[:, a])


def marching_tetrahedra(density: np.ndarray, level: float,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0)
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a dense (Nx, Ny, Nz) field. Returns (verts, faces)."""
    N = np.array(density.shape)
    # only cubes whose corner values straddle the level contribute
    grid = np.stack(np.meshgrid(*[np.arange(n - 1) for n in N],
                                indexing="ij"), axis=-1).reshape(-1, 3)
    corner_vals = np.stack(
        [density[grid[:, 0] + c[0], grid[:, 1] + c[1], grid[:, 2] + c[2]]
         for c in _CORNERS], axis=-1)  # (M, 8)
    active = ((corner_vals > level).any(-1)
              & (corner_vals <= level).any(-1))
    grid = grid[active]
    corner_vals = corner_vals[active]
    if len(grid) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    corner_pos = (grid[:, None] + _CORNERS[None]).astype(np.float64)
    all_tris = []
    for tet in _TETS:
        p = corner_pos[:, tet]            # (M, 4, 3)
        v = corner_vals[:, tet]           # (M, 4)
        all_tris.append(_tet_triangles(p, v, level))
    tris = np.concatenate(all_tris, axis=0) * np.asarray(spacing)

    # weld duplicate vertices
    flat = tris.reshape(-1, 3)
    keys = np.round(flat / (np.min(spacing) * 1e-6)).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=len(uniq))
    verts /= counts[:, None]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def extract_mesh(queryfn: Callable, level: float, bbox,
                 output_path: str = "test.ply", N: int = 256,
                 batch_size: int = 8192, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate ``queryfn`` (world xyz (P, 3) float32 tensor on ``device``,
    the card unless ``device`` says otherwise -> density (P, 1)) on an N^3
    grid inside ``bbox``, bring each density batch back to the host, and
    write the isosurface at ``level`` to ``output_path`` (reference
    mesh_utils.py:7-45). Returns (verts, faces)."""
    device = resolve_device(device)
    bbox = np.asarray(bbox, np.float64).reshape(2, 3)
    size = bbox[1] - bbox[0]
    # every axis takes the x extent, as the reference's grid does
    # (mesh_utils.py:13,26-28)
    axes = [np.linspace(bbox[0][d], bbox[0][d] + size[0], N)
            for d in range(3)]
    xyz = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)

    density = []
    with torch.inference_mode():
        for i in range(0, len(xyz), batch_size):
            pts = torch.from_numpy(xyz[i:i + batch_size].astype(np.float32))
            d = queryfn(pts.to(device))
            density.append(d.detach().cpu().numpy()[..., 0])
    field = np.concatenate(density).reshape(N, N, N)

    verts, faces = marching_tetrahedra(field, level,
                                       spacing=[float(v) / (N - 1)
                                                for v in size])
    # offset by the grid origin, not by the bbox centre as the reference
    # does (mesh_utils.py:44: wrong for any bbox; its mesh path is dead
    # upstream)
    verts = verts + bbox[0]
    save_ply_mesh(output_path, verts, faces)
    return verts, faces

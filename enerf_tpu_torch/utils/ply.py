"""PLY vertex reader and triangle-mesh writer; counterpart of
``enerf_tpu/utils/ply.py`` (the reference loads ``background.ply`` point
clouds and writes meshes through trimesh, enerf_outdoor/enerf.py:68,
mesh_utils.py:43-45). Reads ascii and binary_little_endian vertex elements
with float x, y, z properties; writes binary_little_endian meshes."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_NP = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
       "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
       "short": "i2", "ushort": "u2", "int": "i4", "uint": "u4",
       "int32": "i4", "uint32": "u4"}


def save_ply_mesh(path: str, vertices: np.ndarray,
                  faces: np.ndarray) -> None:
    """Write a binary_little_endian triangle mesh: float32 x, y, z vertices
    and uchar-counted int32 faces (the JAX package's bytes)."""
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(np.asarray(vertices).astype("<f4").tobytes())
        tri = np.empty((len(faces), 13), np.uint8)
        tri[:, 0] = 3
        tri[:, 1:] = np.asarray(faces).astype("<i4").view(np.uint8).reshape(
            len(faces), 12)
        f.write(tri.tobytes())


def load_ply_vertices(path: str) -> np.ndarray:
    """The (N, 3) float64 x, y, z of a PLY file's vertex element."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_verts = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: no end_header")
            line = raw.decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_verts = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list" or parts[1] not in _NP:
                    raise ValueError(f"{path}: vertex property {line!r}")
                props.append((parts[1], parts[2]))
            elif line == "end_header":
                break
        names = [n for _, n in props]
        if not {"x", "y", "z"} <= set(names):
            raise ValueError(f"{path}: vertices without x, y, z")
        if fmt == "ascii":
            data = np.loadtxt([f.readline() for _ in range(n_verts)],
                              dtype=np.float64, ndmin=2)
            return data[:, [names.index(c) for c in ("x", "y", "z")]]
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: PLY format {fmt} is not read")
        dtype = np.dtype([(n, "<" + _NP[t]) for t, n in props])
        raw = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype,
                            count=n_verts)
        return np.stack([raw["x"], raw["y"], raw["z"]],
                        axis=-1).astype(np.float64)

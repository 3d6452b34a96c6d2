"""COLMAP sparse / dense reconstruction IO; counterpart of
``enerf_tpu/utils/colmap.py`` (the reference vendors COLMAP's scripts under
lib/utils/colmap/: read_write_model.py, read_write_dense.py,
read_write_fused_vis.py). The COLMAP formats are a fixed public spec; the
records are read and written with vectorized numpy record IO:

- sparse models (``cameras`` / ``images`` / ``points3D``) in ``.bin`` and
  ``.txt``, with detection of which is present;
- dense map arrays (``*.photometric.bin`` depth / normal maps);
- fused point-cloud visibility files (``fused.ply.vis``);
- quaternion helpers and a converter to the datasets' (ixt, ext) camera
  convention.

Host numpy only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

# model name -> (model_id, num_params); the fixed COLMAP camera-model table
CAMERA_MODELS: Dict[str, Tuple[int, int]] = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
_MODEL_BY_ID = {mid: (name, n) for name, (mid, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str          # model name, e.g. "PINHOLE"
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64


@dataclass
class Image:
    id: int
    qvec: np.ndarray          # (4,) w,x,y,z
    tvec: np.ndarray          # (3,)
    camera_id: int
    name: str
    xys: np.ndarray           # (N, 2) keypoint locations
    point3D_ids: np.ndarray   # (N,) int64, -1 = no 3D point


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray           # (3,)
    rgb: np.ndarray           # (3,) uint8
    error: float
    image_ids: np.ndarray     # (T,) int32 track
    point2D_idxs: np.ndarray  # (T,) int32


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(w,x,y,z) unit quaternion -> 3x3 rotation."""
    w, x, y, z = np.asarray(qvec, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (w,x,y,z) quaternion with w >= 0 (Shepperd's
    eigen-free branch selection for numerical safety)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q


# ---------------------------------------------------------------- binary IO
# Record layouts per the COLMAP binary spec. Fixed-size parts are decoded
# with np.frombuffer over the whole file; variable-length tails (image
# names, 2D point lists, tracks) advance an offset cursor.

def _u64(buf: bytes, off: int) -> Tuple[int, int]:
    return int(np.frombuffer(buf, "<u8", 1, off)[0]), off + 8


# one image 2D-point record: double x, double y, int64 point3D_id
_PT2D = np.dtype([("xy", "<f8", 2), ("pid", "<i8")])


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    with open(path, "rb") as f:
        buf = f.read()
    n, off = _u64(buf, 0)
    cams: Dict[int, Camera] = {}
    for _ in range(n):
        cam_id, model_id = np.frombuffer(buf, "<i4", 2, off)
        off += 8
        w, h = np.frombuffer(buf, "<u8", 2, off)
        off += 16
        name, n_params = _MODEL_BY_ID[int(model_id)]
        params = np.frombuffer(buf, "<f8", n_params, off).copy()
        off += 8 * n_params
        cams[int(cam_id)] = Camera(int(cam_id), name, int(w), int(h), params)
    return cams


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    parts = [np.uint64(len(cameras)).tobytes()]
    for cam in cameras.values():
        model_id, n_params = CAMERA_MODELS[cam.model]
        parts.append(np.array([cam.id, model_id], "<i4").tobytes())
        parts.append(np.array([cam.width, cam.height], "<u8").tobytes())
        parts.append(np.asarray(cam.params, "<f8")[:n_params].tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def read_images_binary(path: str) -> Dict[int, Image]:
    with open(path, "rb") as f:
        buf = f.read()
    n, off = _u64(buf, 0)
    images: Dict[int, Image] = {}
    for _ in range(n):
        img_id = int(np.frombuffer(buf, "<i4", 1, off)[0]); off += 4
        qt = np.frombuffer(buf, "<f8", 7, off).copy(); off += 56
        cam_id = int(np.frombuffer(buf, "<i4", 1, off)[0]); off += 4
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8"); off = end + 1
        n_pts, off = _u64(buf, off)
        # each 2D point record: double x, double y, int64 point3D_id
        rec = np.frombuffer(buf, _PT2D, n_pts, off)
        off += 24 * n_pts
        images[img_id] = Image(
            img_id, qt[:4], qt[4:], cam_id, name,
            xys=rec["xy"].copy(), point3D_ids=rec["pid"].copy())
    return images


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    parts = [np.uint64(len(images)).tobytes()]
    for im in images.values():
        parts.append(np.array([im.id], "<i4").tobytes())
        parts.append(np.concatenate([im.qvec, im.tvec]).astype("<f8").tobytes())
        parts.append(np.array([im.camera_id], "<i4").tobytes())
        parts.append(im.name.encode("utf-8") + b"\x00")
        n_pts = len(im.xys)
        parts.append(np.uint64(n_pts).tobytes())
        rec = np.empty(n_pts, _PT2D)
        rec["xy"] = im.xys
        rec["pid"] = im.point3D_ids
        parts.append(rec.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def read_points3D_binary(path: str) -> Dict[int, Point3D]:
    with open(path, "rb") as f:
        buf = f.read()
    n, off = _u64(buf, 0)
    pts: Dict[int, Point3D] = {}
    for _ in range(n):
        pid = int(np.frombuffer(buf, "<i8", 1, off)[0]); off += 8
        xyz = np.frombuffer(buf, "<f8", 3, off).copy(); off += 24
        rgb = np.frombuffer(buf, "<u1", 3, off).copy(); off += 3
        err = float(np.frombuffer(buf, "<f8", 1, off)[0]); off += 8
        track_len, off = _u64(buf, off)
        track = np.frombuffer(buf, "<i4", 2 * track_len, off).reshape(-1, 2)
        off += 8 * track_len
        pts[pid] = Point3D(pid, xyz, rgb, err,
                           track[:, 0].copy(), track[:, 1].copy())
    return pts


def write_points3D_binary(points3D: Dict[int, Point3D], path: str) -> None:
    parts = [np.uint64(len(points3D)).tobytes()]
    for p in points3D.values():
        parts.append(np.array([p.id], "<i8").tobytes())
        parts.append(np.asarray(p.xyz, "<f8").tobytes())
        parts.append(np.asarray(p.rgb, "<u1").tobytes())
        parts.append(np.array([p.error], "<f8").tobytes())
        parts.append(np.uint64(len(p.image_ids)).tobytes())
        track = np.stack([np.asarray(p.image_ids, "<i4"),
                          np.asarray(p.point2D_idxs, "<i4")], axis=1)
        parts.append(track.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# ------------------------------------------------------------------ text IO

def _data_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    for ln in _data_lines(path):
        tok = ln.split()
        cams[int(tok[0])] = Camera(
            int(tok[0]), tok[1], int(tok[2]), int(tok[3]),
            np.array(tok[4:], np.float64))
    return cams


def write_cameras_text(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def read_images_text(path: str) -> Dict[int, Image]:
    lines = _data_lines(path)
    images: Dict[int, Image] = {}
    for head, body in zip(lines[0::2], lines[1::2]):
        tok = head.split()
        img_id = int(tok[0])
        vals = np.array(body.split(), np.float64).reshape(-1, 3) \
            if body else np.zeros((0, 3))
        images[img_id] = Image(
            img_id,
            qvec=np.array(tok[1:5], np.float64),
            tvec=np.array(tok[5:8], np.float64),
            camera_id=int(tok[8]), name=tok[9],
            xys=vals[:, :2].copy(),
            point3D_ids=vals[:, 2].astype(np.int64))
    return images


def write_images_text(images: Dict[int, Image], path: str) -> None:
    n_obs = np.mean([len(im.xys) for im in images.values()]) if images else 0
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}, "
                f"mean observations per image: {n_obs}\n")
        for im in images.values():
            pose = " ".join(repr(float(v))
                            for v in np.concatenate([im.qvec, im.tvec]))
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)) + "\n")


def read_points3D_text(path: str) -> Dict[int, Point3D]:
    pts: Dict[int, Point3D] = {}
    for ln in _data_lines(path):
        tok = ln.split()
        pid = int(tok[0])
        track = np.array(tok[8:], np.int64).reshape(-1, 2)
        pts[pid] = Point3D(
            pid, np.array(tok[1:4], np.float64),
            np.array(tok[4:7], np.uint8), float(tok[7]),
            track[:, 0].astype(np.int32), track[:, 1].astype(np.int32))
    return pts


def write_points3D_text(points3D: Dict[int, Point3D], path: str) -> None:
    n_trk = np.mean([len(p.image_ids) for p in points3D.values()]) \
        if points3D else 0
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points3D)}, "
                f"mean track length: {n_trk}\n")
        for p in points3D.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}"
                             for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))} {track}\n")


# ------------------------------------------------------------- model facade

def detect_model_format(path: str) -> str:
    for ext in (".bin", ".txt"):
        if all(os.path.exists(os.path.join(path, f + ext))
               for f in ("cameras", "images", "points3D")):
            return ext
    raise FileNotFoundError(f"no COLMAP model (bin or txt) under {path}")


def read_model(path: str, ext: str = ""):
    """-> (cameras, images, points3D) dicts keyed by id."""
    ext = ext or detect_model_format(path)
    readers = {
        ".bin": (read_cameras_binary, read_images_binary,
                 read_points3D_binary),
        ".txt": (read_cameras_text, read_images_text, read_points3D_text),
    }[ext]
    return tuple(rd(os.path.join(path, name + ext))
                 for rd, name in zip(readers, ("cameras", "images",
                                               "points3D")))


def write_model(cameras, images, points3D, path: str,
                ext: str = ".bin") -> None:
    writers = {
        ".bin": (write_cameras_binary, write_images_binary,
                 write_points3D_binary),
        ".txt": (write_cameras_text, write_images_text,
                 write_points3D_text),
    }[ext]
    os.makedirs(path, exist_ok=True)
    for wr, obj, name in zip(writers, (cameras, images, points3D),
                             ("cameras", "images", "points3D")):
        wr(obj, os.path.join(path, name + ext))


# --------------------------------------------------- dense map arrays (.bin)
# Header is ASCII "W&H&C&", payload float32 in Fortran order over
# (W, H, C) — i.e. channel planes of H rows x W cols.

def read_array(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            header += f.read(1)
        w, h, c = (int(v) for v in header.split(b"&")[:3])
        data = np.fromfile(f, "<f4", w * h * c)
    arr = data.reshape(c, h, w).transpose(1, 2, 0)  # (H, W, C)
    return arr[:, :, 0] if c == 1 else arr


def write_array(arr: np.ndarray, path: str) -> None:
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        f.write(arr.transpose(2, 0, 1).astype("<f4").tobytes())


# ------------------------------------------------- fused visibility (.vis)
# uint64 point count, then per point: uint32 k, uint32 image_idx[k].

def read_fused_vis(path: str) -> List[np.ndarray]:
    with open(path, "rb") as f:
        buf = f.read()
    n, off = _u64(buf, 0)
    out: List[np.ndarray] = []
    for _ in range(n):
        k = int(np.frombuffer(buf, "<u4", 1, off)[0]); off += 4
        out.append(np.frombuffer(buf, "<u4", k, off).copy())
        off += 4 * k
    return out


def write_fused_vis(vis: Sequence[np.ndarray], path: str) -> None:
    parts = [np.uint64(len(vis)).tobytes()]
    for v in vis:
        v = np.asarray(v, "<u4")
        parts.append(np.uint32(len(v)).tobytes())
        parts.append(v.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# -------------------------------------------------------- framework glue

def camera_intrinsics(cam: Camera) -> np.ndarray:
    """COLMAP camera -> 3x3 K (ignores distortion params — the framework's
    datasets expect pre-undistorted images, like the reference's)."""
    p = cam.params
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        fx = fy = p[0]; cx, cy = p[1], p[2]
    else:  # PINHOLE / OPENCV / FULL_OPENCV / OPENCV_FISHEYE / ...
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def model_to_enerf_cameras(cameras: Dict[int, Camera],
                           images: Dict[int, Image]):
    """-> (names, ixts (N,3,3), exts (N,4,4 world-to-camera)) sorted by
    image name — the (ixt, ext) convention every dataset here uses."""
    items = sorted(images.values(), key=lambda im: im.name)
    ixts = np.stack([camera_intrinsics(cameras[im.camera_id])
                     for im in items])
    exts = np.tile(np.eye(4), (len(items), 1, 1))
    for i, im in enumerate(items):
        exts[i, :3, :3] = qvec2rotmat(im.qvec)
        exts[i, :3, 3] = im.tvec
    return [im.name for im in items], ixts, exts

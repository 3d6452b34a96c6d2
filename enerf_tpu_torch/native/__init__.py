"""Native (C++) host-side data-pipeline kernels with numpy fallbacks; the
port's copy of ``enerf_tpu/native``, plus the PNG row unfilter and a
baseline JPEG codec (``jpeg.cc``).

The loaders' host work (image decode and normalize, PFM flips, batch
collation) runs on the CPU beside the card, where numpy's multi-pass
expressions (``(img / 255 * 2 - 1).astype(np.float32)`` walks the image
four times through float64 temporaries) cost more than the one fused pass
of ``host_ops.cc``. This module builds ``host_ops.cc`` and ``jpeg.cc``
with g++ at first use into one library,
``build/native/libhost_ops-<hash>.so`` beside the package (the hash covers
the sources, so an edited source is built again), and falls back to numpy
when no compiler is available, except for the JPEG codec: a Huffman
decoder in Python would take seconds an image, so without the library
``jpeg_decode`` and ``jpeg_encode`` raise.

API (all return np.ndarray, C-contiguous):
- ``u8_to_unit(img)``        u8 -> f32 in [0, 1]
- ``u8_to_pm1(img)``         u8 -> f32 in [-1, 1]
- ``unit_to_pm1(img)``       f32 [0, 1] -> [-1, 1]
- ``f32_unit_to_u8(img)``    f32 [0, 1] -> u8, clipped and truncated
- ``u8_rgba_over_white(img)``  RGBA u8 -> RGB f32 over white
- ``pfm_flip_downsample(payload, scale)``  bottom-up pfm -> top-down,
  fused nearest 1/scale downsample (DTU depth path)
- ``collate(samples)``       stack into a preallocated batch buffer
- ``png_unfilter(raw, h, stride, bpp)``  PNG scanlines -> pixel bytes
- ``jpeg_decode(data)``      JPEG bytes -> u8 (H, W) or (H, W, 3), equal to
  libjpeg-turbo's default decode (``jpeg.cc`` says what it reads)
- ``jpeg_encode(img, quality)``  u8 image -> baseline JPEG bytes
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRCS = tuple(Path(__file__).resolve().parent / name
              for name in ("host_ops.cc", "jpeg.cc"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _so_path() -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _SRCS)
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libhost_ops-{digest}.so"


def _build(so: Path) -> bool:
    """g++ into a file of this process, then an atomic rename: concurrent
    builders (test workers) never load a half-written library."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                        *map(str, _SRCS), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=180)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    """Build-once, load-once; returns None when unavailable (fallbacks)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not so.is_file() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        st = ctypes.c_size_t
        lib.u8_to_unit_f32.argtypes = [u8p, f32p, st]
        lib.u8_to_pm1_f32.argtypes = [u8p, f32p, st]
        lib.u8_to_pm1_masked_f32.argtypes = [u8p, u8p, f32p, st, st, st]
        lib.f32_scale_offset.argtypes = [f32p, f32p, st,
                                         ctypes.c_float, ctypes.c_float]
        lib.u8_rgba_over_white_f32.argtypes = [u8p, f32p, st]
        lib.f32_unit_to_u8.argtypes = [f32p, u8p, st]
        lib.collate_f32.argtypes = [f32p, f32p, st, st]
        lib.pfm_flip_downsample_f32.argtypes = [f32p, f32p, st, st, st]
        lib.png_unfilter.argtypes = [u8p, u8p, st, st, st]
        lib.png_unfilter.restype = ctypes.c_int
        cp, ip = ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)
        lib.jpeg_header.argtypes = [u8p, st, ip, ip, ip, cp, st]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [u8p, st, u8p, st, cp, st]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, u8p, st]
        lib.jpeg_encode.restype = st
        for fn in (lib.u8_to_unit_f32, lib.u8_to_pm1_f32,
                   lib.u8_to_pm1_masked_f32,
                   lib.f32_scale_offset, lib.u8_rgba_over_white_f32,
                   lib.f32_unit_to_u8,
                   lib.collate_f32, lib.pfm_flip_downsample_f32):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _scale_offset_f32(img: np.ndarray, scale: float, offset: float
                      ) -> np.ndarray:
    """Fused x*scale+offset for a f32 array (native when possible)."""
    lib = _load()
    if lib is not None and img.dtype == np.float32 and img.flags.c_contiguous:
        out = np.empty(img.shape, np.float32)
        lib.f32_scale_offset(_f32p(img), _f32p(out), img.size,
                             scale, offset)
        return out
    out = np.asarray(img, dtype=np.float32) * np.float32(scale)
    if offset:
        out += np.float32(offset)
    return out


def u8_to_unit(img: np.ndarray) -> np.ndarray:
    """u8 (or [0,255] float) image -> f32 in [0, 1], one pass."""
    lib = _load()
    if lib is None or img.dtype != np.uint8 or not img.flags.c_contiguous:
        return _scale_offset_f32(img, 1.0 / 255.0, 0.0)
    out = np.empty(img.shape, np.float32)
    lib.u8_to_unit_f32(_u8p(img), _f32p(out), img.size)
    return out


def u8_to_pm1(img: np.ndarray) -> np.ndarray:
    """u8 (or [0,255] float) image -> f32 in [-1, 1], one pass."""
    lib = _load()
    if lib is None or img.dtype != np.uint8 or not img.flags.c_contiguous:
        return _scale_offset_f32(img, 2.0 / 255.0, -1.0)
    out = np.empty(img.shape, np.float32)
    lib.u8_to_pm1_f32(_u8p(img), _f32p(out), img.size)
    return out


def u8_to_pm1_masked(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """u8 (H, W, C) image + u8 (H, W) mask -> f32 in [-1, 1] with the
    mask == 0 pixels at -1 (the zeroed-then-normalized value), one pass."""
    lib = _load()
    if lib is None or img.dtype != np.uint8 or mask.dtype != np.uint8 \
            or not (img.flags.c_contiguous and mask.flags.c_contiguous):
        out = np.asarray(img, dtype=np.float32) * np.float32(2.0 / 255.0) \
            - np.float32(1.0)
        out[np.asarray(mask) == 0] = -1.0
        return out
    h, w, c = img.shape
    if mask.shape != (h, w):
        raise ValueError(f"mask {mask.shape} for an image of {img.shape}")
    out = np.empty(img.shape, np.float32)
    lib.u8_to_pm1_masked_f32(_u8p(img), _u8p(mask), _f32p(out), h, w, c)
    return out


def unit_to_pm1(img: np.ndarray) -> np.ndarray:
    """[0,1] f32 image -> [-1,1] (the img*2-1 normalize), one pass."""
    return _scale_offset_f32(img, 2.0, -1.0)


def f32_unit_to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] image -> u8, one pass: clipped to [0, 1], times 255,
    truncated (the reference's ``(img * 255).astype(np.uint8)`` after a
    clip), as ``enerf_tpu.native.f32_unit_to_u8``."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    if lib is None:
        return (np.clip(img, 0.0, 1.0) * np.float32(255.0)).astype(np.uint8)
    out = np.empty(img.shape, np.uint8)
    lib.f32_unit_to_u8(_f32p(img), _u8p(out), img.size)
    return out


def u8_rgba_over_white(img: np.ndarray) -> np.ndarray:
    """u8 (H, W, 4) RGBA -> f32 (H, W, 3) in [0,1], alpha-composited onto
    white in one pass (reference nerf/enerf.py:127 semantics)."""
    lib = _load()
    if lib is None or img.dtype != np.uint8 or img.shape[-1] != 4 \
            or not img.flags.c_contiguous:
        f = np.asarray(img, dtype=np.float32) / np.float32(255.0)
        return (f[..., :3] * f[..., 3:] + (1.0 - f[..., 3:])
                ).astype(np.float32)
    out = np.empty(img.shape[:-1] + (3,), np.float32)
    lib.u8_rgba_over_white_f32(_u8p(img), _f32p(out),
                               img.shape[0] * img.shape[1])
    return out


def pfm_flip_downsample(payload: np.ndarray, scale: int = 1) -> np.ndarray:
    """(H, W) f32 bottom-up pfm scanlines -> top-down, nearest-downsampled
    by ``scale`` (1 or 2) in the same pass (cv2.resize INTER_NEAREST
    fx=1/scale picks source index floor(x*scale) — matched exactly)."""
    if scale not in (1, 2):
        raise ValueError(f"pfm_flip_downsample: scale {scale} is not 1 or 2")
    lib = _load()
    payload = np.ascontiguousarray(payload, dtype=np.float32)
    h, w = payload.shape
    if lib is None:
        flipped = payload[::-1]
        return np.ascontiguousarray(flipped[::scale, ::scale])
    out = np.empty((h // scale, w // scale), np.float32)
    lib.pfm_flip_downsample_f32(_f32p(payload), _f32p(out), h, w, scale)
    return out


def collate(samples: List[np.ndarray]) -> np.ndarray:
    """np.stack for f32 samples via direct writes into the batch buffer."""
    lib = _load()
    if lib is None or not isinstance(samples[0], np.ndarray) \
            or samples[0].dtype != np.float32 \
            or not all(isinstance(s, np.ndarray) and s.flags.c_contiguous
                       and s.shape == samples[0].shape
                       and s.dtype == np.float32 for s in samples):
        return np.stack(samples)
    out = np.empty((len(samples),) + samples[0].shape, np.float32)
    n = samples[0].size
    for i, s in enumerate(samples):
        lib.collate_f32(_f32p(s), _f32p(out), i, n)
    return out


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int
                 ) -> np.ndarray:
    """PNG scanline reconstruction (filter method 0): ``raw`` holds ``h``
    rows of a filter-type byte + ``stride`` filtered bytes; returns the
    (h, stride) u8 pixel bytes. ``bpp`` is the bytes of a whole pixel.
    Raises ``ValueError`` on a filter type other than 0..4. A pixel's
    prediction reads its left, upper and upper-left neighbours, so the
    numpy version walks the anti-diagonals of the pixel grid (h + w - 1
    steps), each one vectorised over its pixels and every filter type."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != h * (stride + 1) or not 1 <= bpp <= 8 or stride % bpp:
        raise ValueError(f"png_unfilter: {raw.size} bytes for {h} rows of "
                         f"{stride} + 1, bpp {bpp}")
    out = np.empty((h, stride), np.uint8)
    lib = _load()
    if lib is not None:
        bad = lib.png_unfilter(_u8p(raw), _u8p(out), h, stride, bpp)
        if bad:
            raise ValueError(f"png_unfilter: row {bad - 1} has filter type "
                             f"{raw[(bad - 1) * (stride + 1)]}")
        return out
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    bad = np.flatnonzero(kinds > 4)
    if bad.size:
        raise ValueError(f"png_unfilter: row {bad[0]} has filter type "
                         f"{kinds[bad[0]]}")
    w = stride // bpp
    line = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # one row and one column of zeros above and left of the image: the
    # neighbours that the first row and column read
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[y, None], [np.zeros_like(a), a, b,
                                          (a + b) >> 1, paeth])
        rec[y + 1, x + 1] = (line[y, x] + pred) & 0xFF
    out[:] = rec[1:, 1:].reshape(h, stride)
    return out


def _jpeg_lib(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"{what}: JPEG files are coded only by the native library "
            f"(enerf_tpu_torch/native/jpeg.cc), which did not build or load "
            f"here (g++ into {BUILD_DIR})")
    return lib


def jpeg_decode(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """The pixels of a baseline JPEG file's bytes: u8 (H, W) for gray,
    (H, W, 3) RGB for YCbCr, as libjpeg-turbo decodes them by default.
    Raises ``ValueError`` for a file the decoder does not read (see
    ``jpeg.cc``) and ``RuntimeError`` without the native library."""
    lib = _jpeg_lib(name)
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(_u8p(buf), buf.size, ctypes.byref(h), ctypes.byref(w),
                       ctypes.byref(c), err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.jpeg_decode(_u8p(buf), buf.size, _u8p(out), out.size, err,
                       len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def jpeg_encode(img: np.ndarray, quality: int = 75) -> bytes:
    """Baseline JPEG bytes of a u8 (H, W) gray or (H, W, 3) RGB image: 4:2:0
    for RGB, the IJG ``quality``-scaled Annex K tables, the standard
    Huffman tables. Raises ``RuntimeError`` without the native library."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"jpeg_encode: u8 (H, W) or (H, W, 3) image "
                         f"expected, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f"jpeg_encode: size {h}x{w} out of JPEG's range")
    lib = _jpeg_lib("jpeg_encode")
    cap = img.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(_u8p(img), h, w, c, int(quality), _u8p(out), cap)
        if n == 0:
            raise ValueError("jpeg_encode: the encoder failed")
        if n <= cap:
            return out[:n].tobytes()
        cap = n

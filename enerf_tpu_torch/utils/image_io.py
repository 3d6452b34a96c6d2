"""Image files without an image library: the PNG and JPEG readers and
writers of the port's loaders, in place of the ``imageio.v2.imread`` /
``imwrite`` calls of the JAX package's datasets.

A PNG is a chain of chunks; the image is the zlib stream of its IDAT
chunks, one filter-type byte before each row of pixel bytes. ``imread``
inflates it with ``zlib`` and undoes the five row filters with
``native.png_unfilter`` (C when g++ is there; numpy otherwise). It reads
8-bit gray, gray + alpha, RGB and RGBA, not interlaced, and returns what
imageio returns for them: u8 (H, W), (H, W, 2), (H, W, 3) or (H, W, 4).
Anything else (a palette, 16-bit samples, Adam7 interlacing, a
transparency chunk, a bad checksum) raises rather than giving a wrong
image.

A JPEG is decoded by the native library's baseline decoder
(``native/jpeg.cc``): u8 (H, W) for gray, (H, W, 3) for colour, equal to
what ``imageio.v2.imread`` returns through libjpeg-turbo. A JPEG it does
not read (progressive, arithmetic-coded, 12-bit, CMYK, an EXIF rotation,
truncated) raises ``JPEGError``; without the native library, reading a
JPEG raises ``RuntimeError``: there is no slow fallback.

``imwrite`` writes a PNG of the same four kinds, each row filtered by the
type the caller picks (``filters``, cycled over the rows), so a test can
make every filter type appear in one file; or, to a ``.jpg`` / ``.jpeg``
path, a baseline JPEG (``encode_jpeg``: 4:2:0, IJG quality 75 by
default).
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

from enerf_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> samples a pixel, for 8-bit gray, RGB, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


class PNGError(ValueError):
    """A PNG file this reader does not decode (or a damaged one)."""


class JPEGError(ValueError):
    """A JPEG file the decoder does not read (or a damaged one)."""


def imread(path: str) -> np.ndarray:
    """The image at ``path`` as u8, shaped as ``imageio.v2.imread`` shapes
    it: a PNG or a JPEG, each by the port's own decoder."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path)
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """Decode the bytes of a baseline JPEG file (see the module
    docstring)."""
    try:
        return native.jpeg_decode(data, name)
    except ValueError as e:
        raise JPEGError(str(e)) from None


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """Baseline JPEG bytes of a u8 (H, W) or (H, W, 3) image: 4:2:0 for
    colour, the IJG ``quality``-scaled Annex K tables, the standard Huffman
    tables."""
    return native.jpeg_encode(img, quality)


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """Decode the bytes of a PNG file (see the module docstring)."""
    if not data.startswith(PNG_SIGNATURE):
        raise PNGError(f"{name}: no PNG signature")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise PNGError(f"{name}: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind in (b"PLTE", b"tRNS"):
            raise PNGError(f"{name}: {kind.decode()} chunk (palette or "
                           "transparency key) is not supported")
        elif kind[0] & 0x20 == 0:    # an unknown critical chunk
            raise PNGError(f"{name}: unknown critical chunk {kind!r}")
    if header is None:
        raise PNGError(f"{name}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise PNGError(f"{name}: bit depth {depth}, colour type {color}; "
                       "only 8-bit gray, gray+alpha, RGB and RGBA are read")
    if interlace or compression or filtering:
        raise PNGError(f"{name}: interlace {interlace}, compression "
                       f"{compression}, filter method {filtering} "
                       "(only 0, 0, 0 are read)")
    c = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: bad image data ({e})") from None
    stride = w * c
    if len(raw) != h * (stride + 1):
        raise PNGError(f"{name}: {len(raw)} bytes of image data for "
                       f"{h} rows of {stride} + 1")
    try:
        pix = native.png_unfilter(np.frombuffer(raw, np.uint8), h, stride, c)
    except ValueError as e:
        raise PNGError(f"{name}: {e}") from None
    return pix.reshape(h, w) if c == 1 else pix.reshape(h, w, c)


def _filter_rows(img: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) u8 pixel bytes -> (h, stride + 1) filtered scanlines,
    row y by filter type ``kinds[y]`` (PNG spec, section 9)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    rows = np.arange(img.shape[0])
    out = np.empty((img.shape[0], img.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    out[:, 1:] = ((x - pred[kinds, rows]) & 0xFF).astype(np.uint8)
    return out


def encode_png(img: np.ndarray,
               filters: Union[int, Sequence[int]] = 0) -> bytes:
    """PNG bytes of a u8 image ((H, W) gray, (H, W, 2|3|4)); row y filtered
    by ``filters[y % len(filters)]`` (each 0..4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png: u8 image expected, got {img.dtype}")
    c = 1 if img.ndim == 2 else img.shape[-1]
    if img.ndim not in (2, 3) or c not in _COLOR_TYPE:
        raise ValueError(f"encode_png: shape {img.shape} is not (H, W) or "
                         "(H, W, 2|3|4)")
    h, w = img.shape[:2]
    kinds = np.resize(np.asarray(filters, np.int64).reshape(-1), h)
    if ((kinds < 0) | (kinds > 4)).any():
        raise ValueError(f"encode_png: filter types {filters} not in 0..4")
    rows = _filter_rows(img.reshape(h, w * c), kinds, c)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray,
            filters: Union[int, Sequence[int]] = 0,
            quality: int = 75) -> None:
    """Write ``img`` as a JPEG file when ``path`` ends in ``.jpg`` or
    ``.jpeg`` (``encode_jpeg`` at ``quality``), else as a PNG file
    (``encode_png`` with ``filters``)."""
    if path.lower().endswith((".jpg", ".jpeg")):
        data = encode_jpeg(img, quality)
    else:
        data = encode_png(img, filters)
    with open(path, "wb") as f:
        f.write(data)

"""MP4 video files without a video library: Motion JPEG in an ISO base
media file (ISO/IEC 14496-12 and -14), in place of the imageio / OpenCV
``mp4v`` writers of the JAX package's visualizers
(``enerf_tpu/eval/visualizer.py:_write_video``).

Each frame is one baseline JPEG from the port's encoder
(``image_io.encode_jpeg``, 4:2:0 at ``JPEG_QUALITY``) and one sample of a
single video track, whose sample entry is ``mp4v`` with object type 0x6C
(ISO/IEC 10918-1, JPEG): the layout ffmpeg writes for MJPEG in MP4, which
ffmpeg-based readers (OpenCV's ``VideoCapture`` among them) play. The file
is ``ftyp``, ``mdat`` (the JPEGs back to back), then ``moov`` (one chunk;
the sizes, the offset and a constant frame duration of 1 / ``fps``).

``read_mp4`` reads back that one layout and no other (one track of JPEG
samples in one chunk, 32-bit chunk offsets), decoding each frame with the
port's JPEG decoder. There is no fallback: an encoder or file error
raises, and so does a file of 4 GiB or more.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

from enerf_tpu_torch.utils.image_io import decode_jpeg, encode_jpeg

# the IJG quality of every frame's JPEG
JPEG_QUALITY = 90
# ticks of the movie's and the track's clock a frame: the clock runs at
# TICKS_PER_FRAME * fps ticks a second, so every frame lasts exactly 1 / fps
TICKS_PER_FRAME = 512
# MPEG-4 object type of JPEG (ISO/IEC 10918-1), and the visual stream type
_OBJECT_TYPE_JPEG = 0x6C
_STREAM_TYPE_VISUAL = 0x04
# the identity transform of a track: 16.16 and 2.30 fixed point
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    """An MPEG-4 descriptor with its length in four 7-bit bytes, as ffmpeg
    writes it."""
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


def _esds(max_bytes: int, avg_bitrate: int) -> bytes:
    decoder_config = _descriptor(0x04, struct.pack(
        ">BB3sII", _OBJECT_TYPE_JPEG, (_STREAM_TYPE_VISUAL << 2) | 1,
        max_bytes.to_bytes(3, "big"), avg_bitrate, avg_bitrate))
    sl_config = _descriptor(0x06, b"\x02")
    es = _descriptor(0x03, struct.pack(">HB", 1, 0) + decoder_config
                     + sl_config)
    return _full_box(b"esds", 0, 0, es)


def _mp4v_entry(w: int, h: int, max_bytes: int, avg_bitrate: int) -> bytes:
    name = b"Motion JPEG"
    compressor = bytes([len(name)]) + name.ljust(31, b"\0")
    visual = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16
              + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
              + compressor + struct.pack(">Hh", 24, -1))
    return _box(b"mp4v", visual, _esds(max_bytes, avg_bitrate))


def _moov(w: int, h: int, sizes: List[int], offset: int, fps: int) -> bytes:
    n = len(sizes)
    delta, timescale = TICKS_PER_FRAME, TICKS_PER_FRAME * fps
    duration = n * delta
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
        ">IIIIIH10x", 0, 0, timescale, duration, 0x10000, 0x100),
        _MATRIX, b"\0" * 24, struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(
        ">IIIIIIIhhH2x", 0, 0, 1, 0, duration, 0, 0, 0, 0, 0),
        _MATRIX, struct.pack(">II", w << 16, h << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))  # language 'und'
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                     b"VideoHandler\0")
    vmhd = _full_box(b"vmhd", 0, 1, b"\0" * 8)
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 0, 1)))
    seconds = duration / timescale
    avg_bitrate = int(8 * sum(sizes) / seconds) if seconds else 0
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1),
                     _mp4v_entry(w, h, max(sizes), avg_bitrate))
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes))
    stco = _full_box(b"stco", 0, 0, struct.pack(">II", 1, offset))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
    minf = _box(b"minf", vmhd, dinf, stbl)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
    return _box(b"moov", mvhd, trak)


def write_mp4(path: str, frames: Sequence[np.ndarray], fps: int) -> None:
    """Write ``frames`` (u8 (H, W, 3) RGB or (H, W) gray, all of one size)
    as a Motion-JPEG MP4 at ``fps`` frames a second."""
    if not frames:
        raise ValueError("write_mp4: no frames")
    if int(fps) != fps or not 1 <= fps <= 1000:
        raise ValueError(f"write_mp4: fps {fps} is not an integer in "
                         "[1, 1000]")
    h, w = frames[0].shape[:2]
    if any(f.shape != frames[0].shape for f in frames):
        raise ValueError("write_mp4: frames of different shapes")
    if not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f"write_mp4: size {h}x{w} out of range")
    samples = [encode_jpeg(f, JPEG_QUALITY) for f in frames]
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isom", b"iso2", b"mp41")
    payload = sum(len(s) for s in samples)
    if payload + 1024 >= 1 << 32:
        raise ValueError(f"write_mp4: {payload} bytes of frames: 4 GiB or "
                         "more needs 64-bit boxes, which this writer omits")
    mdat_head = struct.pack(">I", 8 + payload) + b"mdat"
    offset = len(ftyp) + len(mdat_head)
    moov = _moov(w, h, [len(s) for s in samples], offset, int(fps))
    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(mdat_head)
        for s in samples:
            f.write(s)
        f.write(moov)


def _children(data: bytes, start: int, end: int):
    """(kind, body start, body end) of each box in ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        if size < 8 or pos + size > end:
            raise ValueError(f"read_mp4: bad box {kind!r} at {pos}")
        yield kind, pos + 8, pos + size
        pos += size


def _find(data: bytes, start: int, end: int, path: Tuple[bytes, ...]):
    for kind, a, b in _children(data, start, end):
        if kind == path[0]:
            return (a, b) if len(path) == 1 else _find(data, a, b, path[1:])
    raise ValueError(f"read_mp4: no {b'/'.join(path)!r} box")


def read_mp4(path: str) -> Tuple[List[np.ndarray], float]:
    """The frames (u8, as the port's JPEG decoder gives them) and the frame
    rate of a Motion-JPEG MP4 in the one layout ``write_mp4`` writes: one
    ``mp4v`` track, a version-0 ``mdhd``, one ``stts`` run, a size per
    sample and all samples in one chunk. Any other layout raises."""
    with open(path, "rb") as f:
        data = f.read()

    def fail(what):
        raise ValueError(f"read_mp4: {path}: {what}, which write_mp4 "
                         "does not write")

    moov = _find(data, 0, len(data), (b"moov",))
    mdhd = _find(data, *moov, (b"trak", b"mdia", b"mdhd"))
    if data[mdhd[0]] != 0:
        fail("a version-1 mdhd")
    timescale = struct.unpack_from(">I", data, mdhd[0] + 12)[0]
    stbl = _find(data, *moov, (b"trak", b"mdia", b"minf", b"stbl"))
    stsd = _find(data, *stbl, (b"stsd",))
    if data[stsd[0] + 12:stsd[0] + 16] != b"mp4v":
        fail("a track other than mp4v")
    stts = _find(data, *stbl, (b"stts",))
    n_stts, count, delta = struct.unpack_from(">III", data, stts[0] + 4)
    if n_stts != 1:
        fail(f"{n_stts} stts runs")
    stsz = _find(data, *stbl, (b"stsz",))
    fixed, n = struct.unpack_from(">II", data, stsz[0] + 4)
    if fixed or count != n:
        fail("a fixed sample size or an stts count unlike stsz's")
    sizes = struct.unpack_from(f">{n}I", data, stsz[0] + 12)
    stsc = _find(data, *stbl, (b"stsc",))
    stsc_entries = struct.unpack_from(">IIII", data, stsc[0] + 4)
    stco = _find(data, *stbl, (b"stco",))
    n_co, offset = struct.unpack_from(">II", data, stco[0] + 4)
    if stsc_entries[:3] != (1, 1, n) or n_co != 1:
        fail("samples in more than one chunk")
    frames = []
    for k, size in enumerate(sizes):
        frames.append(decode_jpeg(data[offset:offset + size],
                                  f"{path} frame {k}"))
        offset += size
    return frames, timescale / delta

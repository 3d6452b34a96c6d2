"""The port's image and camera codecs against the libraries the JAX package
calls: the native JPEG decoder against ``imageio.v2.imread`` (Pillow over
libjpeg-turbo) on files written by Pillow and OpenCV, the encoder read back
by imageio, and ``utils/cv.py`` (``undistort``, ``dilate``, ``fill_poly``,
``rodrigues``) and ``utils/camera_io.py`` against OpenCV.

Tolerances: exact everywhere (the JPEG pixels bit for bit, the undistorted
float and u8 images, the masks, ``fill_poly`` inside and across the
image's border, the rotations, the camera files)."""

import hashlib
import io
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from enerf_tpu_torch import native
from enerf_tpu_torch.utils import camera_io
from enerf_tpu_torch.utils import cv as pcv
from enerf_tpu_torch.utils import image_io
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SIZES = [(45, 63), (17, 1), (1, 17), (2, 3), (64, 48), (33, 47)]

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain for the native "
                                "library")


def _image(h, w, seed, noise=40.0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k)
                    for k in range(3)], -1) * 100 + 128
    return np.clip(img + rng.randn(h, w, 3) * noise, 0, 255).astype(np.uint8)


def _pillow_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _assert_decodes_as_imageio(data):
    ref = imageio.imread(io.BytesIO(data))
    got = image_io.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
def test_decoder_matches_imageio(quality, subsampling):
    """Pillow's files at three qualities and the three samplings, at odd,
    one-pixel-wide and even sizes."""
    ss = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[subsampling]
    for i, (h, w) in enumerate(SIZES):
        _assert_decodes_as_imageio(_pillow_jpeg(_image(h, w, i),
                                                quality=quality,
                                                subsampling=ss))


@pytest.mark.parametrize("size", SIZES)
def test_decoder_gray_and_restarts(size):
    """A gray file, and OpenCV's 4:2:0 files with a restart marker every 1
    and every 3 MCUs."""
    h, w = size
    img = _image(h, w, 3)
    _assert_decodes_as_imageio(_pillow_jpeg(img[..., 1], quality=80))
    for rst in (1, 3):
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok
        data = enc.tobytes()
        assert b"\xff\xdd" in data            # a DRI segment
        _assert_decodes_as_imageio(data)


def test_committed_fixture_decodes_to_its_checksum():
    """``native/testdata/odd_420.jpg`` (Pillow, 4:2:0, 61x45) decodes as
    imageio decodes it, to the pixel checksum ``chip_smoke.py`` holds the
    card's build to."""
    from chip_smoke import JPEG_FIXTURE, JPEG_FIXTURE_SHA256

    path = REPO / JPEG_FIXTURE
    ref = imageio.imread(path)
    got = image_io.imread(str(path))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (45, 61, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == JPEG_FIXTURE_SHA256


def _refused():
    img = _image(40, 56, 5)
    plain = _pillow_jpeg(img, quality=80)
    exif = Image.Exif()
    exif[0x0112] = 6
    sof = plain.index(b"\xff\xc0")
    twelve = plain[:sof + 4] + bytes([12]) + plain[sof + 5:]
    return {
        "progressive": (_pillow_jpeg(img, quality=80, progressive=True),
                        "progressive"),
        "cmyk": (_cmyk(img), "CMYK"),
        "truncated": (plain[:len(plain) // 2], "truncated"),
        "no_eoi": (plain[:-2], "EOI"),
        "12bit": (twelve, "12-bit"),
        "exif_rotated": (_pillow_jpeg(img, quality=80, exif=exif.tobytes()),
                         "orientation"),
    }


def _cmyk(img):
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("case", ["progressive", "cmyk", "truncated",
                                  "no_eoi", "12bit", "exif_rotated"])
def test_decoder_refuses(case):
    """Never a wrong image: what the decoder does not read raises."""
    data, match = _refused()[case]
    with pytest.raises(image_io.JPEGError, match=match):
        image_io.decode_jpeg(data)


def _segments(data, marker):
    """The payloads of every ``marker`` segment before the scan."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == marker:
            out.append(data[pos + 4:pos + 2 + n])
        pos += 2 + n
    return out


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_encoder_tables_match_pillow(quality):
    """The encoder's quantization tables are IJG's quality-scaled Annex K
    tables and its Huffman tables the standard ones: Pillow's (libjpeg's)
    at the same quality, 4:2:0."""
    img = _image(24, 40, 1)
    ours = image_io.encode_jpeg(img, quality)
    theirs = _pillow_jpeg(img, quality=quality, subsampling=2)
    assert _segments(ours, 0xDB) == [
        seg for s in _segments(theirs, 0xDB)
        for seg in (s[i:i + 65] for i in range(0, len(s), 65))]
    assert b"".join(_segments(ours, 0xC4)) == b"".join(
        _segments(theirs, 0xC4))
    sof = _segments(ours, 0xC0)[0]
    assert sof[6:] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])


@pytest.mark.parametrize("size", [(1080 // 8, 1920 // 8), (45, 63), (1, 1)])
def test_encoder_reads_back(size, tmp_path):
    """imageio reads the port's JPEG as the port's decoder does; on a smooth
    image at quality 75 it is within 30 dB PSNR of the source; a gray
    image round-trips too; ``imwrite`` picks the format by extension."""
    h, w = size
    img = _image(h, w, 2, noise=0.0)
    path = str(tmp_path / "im.jpg")
    image_io.imwrite(path, img)
    ref = imageio.imread(path)
    got = image_io.imread(path)
    np.testing.assert_array_equal(got, ref)
    if h * w > 1:
        mse = np.mean((got.astype(np.float64) - img) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) >= 30.0
    gray = image_io.encode_jpeg(img[..., 0], 90)
    np.testing.assert_array_equal(image_io.decode_jpeg(gray),
                                  imageio.imread(io.BytesIO(gray)))


# ---------------------------------------------------------------------------
# utils/cv.py against OpenCV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(64, 64), (45, 63), (17, 300)])
def test_undistort_matches_cv2(shape, seed):
    """Random camera matrices and 5-term distortions, a float32 image and a
    u8 mask (OpenCV's two sampling paths)."""
    rng = np.random.RandomState(seed)
    H, W = shape
    K = np.array([[rng.uniform(50, 150), 0, W / 2 + rng.randn() * 3],
                  [0, rng.uniform(50, 150), H / 2 + rng.randn() * 3],
                  [0, 0, 1]], np.float32)
    D = (rng.randn(5) * [0.2, 0.1, 0.01, 0.01, 0.05]).astype(np.float32)
    img = rng.rand(H, W, 3).astype(np.float32)
    np.testing.assert_array_equal(pcv.undistort(img, K, D),
                                  cv2.undistort(img, K, D))
    mask = (rng.rand(H, W) > 0.5).astype(np.uint8) * rng.randint(1, 256)
    np.testing.assert_array_equal(pcv.undistort(mask, K, D),
                                  cv2.undistort(mask, K, D))


def test_dilate_matches_cv2():
    rng = np.random.RandomState(0)
    for _ in range(20):
        m = (rng.rand(rng.randint(1, 30), rng.randint(1, 30)) > 0.9
             ).astype(np.uint8)
        np.testing.assert_array_equal(
            pcv.dilate(m, 5), cv2.dilate(m, np.ones((5, 5), np.uint8)))


def _box_faces(rng, H, W, depth):
    """The projected faces of a random box at ``depth`` in front of (or,
    when negative, behind) a camera, as ``get_bound_2d_mask`` draws them."""
    from enerf_tpu_torch.utils.geometry import _FACES, get_bound_corners

    c = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), depth])
    half = rng.uniform(0.2, 1.0, 3)
    corners = get_bound_corners(np.stack([c - half, c + half]))
    K = np.array([[W * 0.8, 0, W / 2], [0, W * 0.8, H / 2], [0, 0, 1.0]])
    pts = corners @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        c2d = np.round(pts[:, :2] / pts[:, 2:]).astype(int)
    return [c2d[f] for f in _FACES]


@pytest.mark.parametrize("where", ["inside", "crossing", "behind"])
def test_fill_poly_matches_cv2(where):
    """Box faces inside the image, crossing its border, and with corners
    behind the camera (very large coordinates): exact in all three."""
    rng = np.random.RandomState({"inside": 0, "crossing": 1, "behind": 2}[where])
    for _ in range(60):
        H, W = rng.randint(8, 60), rng.randint(8, 60)
        depth = {"inside": 8.0, "crossing": 2.0, "behind": 0.3}[where]
        for face in _box_faces(rng, H, W, depth):
            if where == "inside" and not (
                    (face[:, 0] >= 0).all() and (face[:, 0] < W).all()
                    and (face[:, 1] >= 0).all() and (face[:, 1] < H).all()):
                continue
            ref = np.zeros((H, W), np.uint8)
            cv2.fillPoly(ref, [face], 1)
            got = pcv.fill_poly(np.zeros((H, W), np.uint8), face, 1)
            ys, xs = np.nonzero(got != ref)
            assert ys.size == 0, (face.tolist(), ys.tolist(), xs.tolist())


def test_bound_2d_mask_across_border_matches_jax():
    """``get_bound_2d_mask`` of boxes whose faces cross the image's border
    (a subject at the frame's edge), against the JAX package's, which
    calls ``cv2.fillPoly``: exact. The first box is the face on which the
    border rule once differed (a clipped edge left on one row)."""
    from enerf_tpu.utils import geometry as jgeo
    from enerf_tpu_torch.utils import geometry as pgeo

    H, W = 45, 38
    K = np.array([[W * 0.8, 0, W / 2], [0, W * 0.8, H / 2], [0, 0, 1.0]])
    rng = np.random.RandomState(3)
    boxes = [np.array([[-1.901, -0.762, 1.024], [-0.696, 0.036, 2.976]])]
    for _ in range(40):
        c = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5), 2.0])
        half = rng.uniform(0.2, 1.0, 3)
        boxes.append(np.stack([c - half, c + half]))
    n_cross = 0
    for box in boxes:
        corners = pgeo.get_bound_corners(box)
        uv = corners @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        n_cross += bool(((uv < 0) | (uv >= [W, H])).any())
        np.testing.assert_array_equal(
            pgeo.get_bound_2d_mask(corners, K, H, W),
            jgeo.get_bound_2d_mask(corners, K, H, W))
    assert n_cross >= 20


def test_rodrigues_matches_cv2():
    rng = np.random.RandomState(0)
    for scale in (1e-20, 1e-3, 1.0, 3.0):
        for dt in (np.float64, np.float32):
            r = (rng.randn(3, 1) * scale).astype(dt)
            ref = cv2.Rodrigues(r)[0]
            got = pcv.rodrigues(r)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def test_read_camera_matches_cv2(tmp_path):
    """Camera files written by ``cv2.FileStorage`` (a float32 rotation, an
    exponent, a matrix over several lines) read as OpenCV reads them; the
    port's writer's files read back by OpenCV."""
    rng = np.random.RandomState(0)
    names = ["00", "01", "02"]
    intri = cv2.FileStorage(str(tmp_path / "intri.yml"),
                            cv2.FILE_STORAGE_WRITE)
    extri = cv2.FileStorage(str(tmp_path / "extri.yml"),
                            cv2.FILE_STORAGE_WRITE)
    intri.startWriteStruct("names", cv2.FileNode_SEQ)
    for n in names:
        intri.write("", n)
    intri.endWriteStruct()
    for i, n in enumerate(names):
        intri.write(f"K_{n}", np.array([[1000.0 + i, 0, 960.5],
                                        [0, 999.25, 540.0], [0, 0, 1]]))
        intri.write(f"dist_{n}", rng.randn(5, 1) * 1e-3)
        extri.write(f"R_{n}", (rng.randn(3, 1) * 0.5).astype(
            np.float32 if i == 1 else np.float64))
        extri.write(f"T_{n}", rng.randn(3, 1) * 1e4)
    intri.release()
    extri.release()
    from enerf_tpu.utils.camera_io import read_camera as j_read_camera

    ref = j_read_camera(str(tmp_path / "intri.yml"),
                        str(tmp_path / "extri.yml"))
    got = camera_io.read_camera(str(tmp_path / "intri.yml"),
                                str(tmp_path / "extri.yml"))
    assert got["basenames"] == ref["basenames"] == names
    for n in names:
        for k in ("K", "invK", "R", "T", "RT", "P", "dist"):
            assert got[n][k].dtype == ref[n][k].dtype, (n, k)
            np.testing.assert_array_equal(got[n][k], ref[n][k], err_msg=k)
    nodes = camera_io.read_storage(str(tmp_path / "intri.yml"))
    camera_io.write_storage(str(tmp_path / "copy.yml"), nodes)
    fs = cv2.FileStorage(str(tmp_path / "copy.yml"), cv2.FILE_STORAGE_READ)
    for n in names:
        np.testing.assert_array_equal(fs.getNode(f"K_{n}").mat(),
                                      nodes[f"K_{n}"])
    fs.release()
    (tmp_path / "bad.yml").write_text("%YAML:1.0\n---\nK: {a: 1}\n")
    with pytest.raises(ValueError):
        camera_io.read_storage(str(tmp_path / "bad.yml"))

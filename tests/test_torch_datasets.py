"""The port's data path from files on disk, held against the JAX package:
the config reader without PyYAML, the PNG codec, ``native``, the numpy
resizes in place of OpenCV's, each ported ``Dataset`` sample by sample
and the ``DataLoader``'s batch stream.

The datasets run on the tiny on-disk fixtures of ``tests/test_datasets.py``
(its writers are imported, the DTU and LLFF layouts repeated here), each
JAX loader (numpy, no JAX compile) against the port's on the same files
with ``fix_random``. Tolerances: arrays exact, except where a float path
differs (the 1/4-scale target image, OpenCV's area filter in JAX and an
average pool in the port): 1e-6.
"""

import dataclasses
import io
import os
import struct
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

from enerf_tpu import config as jconfig
from enerf_tpu import native as jnative
from enerf_tpu_torch import config as pconfig
from enerf_tpu_torch import native as pnative
from enerf_tpu_torch.utils import image_io
from tests.test_datasets import _imwrite, _make_nerf_fixture, _make_pairs
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "configs").rglob("*.yaml"))
ATOL = 1e-6


# ---------------------------------------------------------------------------
# The config reader
# ---------------------------------------------------------------------------

def _pyyaml_tree(path):
    """The port's ``load_yaml_tree`` as it read the files with PyYAML
    before its own reader replaced it."""
    with open(path) as f:
        cur = yaml.safe_load(f) or {}
    if "parent_cfg" in cur:
        parent_path = cur["parent_cfg"]
        if not os.path.isabs(parent_path) and not os.path.exists(parent_path):
            cand = os.path.join(os.path.dirname(path), parent_path)
            if os.path.exists(cand):
                parent_path = cand
        parent = _pyyaml_tree(parent_path)
        cur = {k: v for k, v in cur.items() if k != "parent_cfg"}
        return pconfig._deep_merge(parent, cur)
    return cur


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_pyyaml(path, monkeypatch):
    """Every config file reads as ``yaml.safe_load`` reads it, and
    ``make_cfg`` builds the same Config as with the PyYAML reader."""
    monkeypatch.chdir(REPO)
    text = (REPO / path).read_text()
    assert pconfig.parse_yaml(text, path) == (yaml.safe_load(text) or {})
    new = pconfig.make_cfg(path, workspace="ws")
    monkeypatch.setattr(pconfig, "load_yaml_tree", _pyyaml_tree)
    assert new == pconfig.make_cfg(path, workspace="ws")


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  - x\n", 3),            # a block sequence
    ("a: &x 1\n", 1),                    # an anchor
    ("a: *x\n", 1),                      # an alias
    ("a: !!str 1\n", 1),                 # a tag
    ("a: first\n  second\n", 2),         # a multi-line plain scalar
    ("a: |\n  text\n", 1),               # a block scalar
    ("a: {b: 1}\n", 1),                  # a flow mapping
    ("a: [1, [2]]\n", 1),                # a nested flow list
    ("a: 'open\n", 1),                   # an unterminated quote
    ('a: "x\\ty"\n', 1),                 # an escape
    ("a: 2001-12-14\n", 1),              # a timestamp
    ("a: 1:30\n", 1),                    # a sexagesimal number
    ("a:\n\tb: 1\n", 2),                 # a tab
    ("a: 1\n---\nb: 2\n", 2),            # a second document
    ("a:\n    b: 1\n  c: 2\n", 3),       # misaligned keys
])
def test_yaml_reader_rejects_outside_the_subset(text, line):
    with pytest.raises(pconfig.YAMLSubsetError, match=f"cfg.yaml:{line}:"):
        pconfig.parse_yaml(text, "cfg.yaml")


@pytest.mark.parametrize("raw", ["5e-4", "1.", "true", "On", "010", "0x1f",
                                 "null", "~", "[a, 1, 'b c']", "[1, 2,]",
                                 "enerf_tpu.datasets.dtu", "48,8",
                                 "False,True", "'quoted'", "1_000", "x: y"])
def test_override_values_match_pyyaml(raw):
    """``_coerce`` (a CLI override) keeps ``ast.literal_eval`` first and
    falls back to the files' value rule, which gives ``yaml.safe_load``'s
    value where PyYAML gave a scalar or a list."""
    import ast

    try:
        ref = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        ref = yaml.safe_load(raw)
        if isinstance(ref, dict):     # a mapping: no value of the subset
            ref = raw
    assert pconfig._coerce(raw) == ref


@pytest.mark.parametrize("ref,module", [
    ("lib.datasets.dtu.enerf", "enerf_tpu.datasets.dtu"),
    ("lib.datasets.nerf.enerf", "enerf_tpu.datasets.nerf_synthetic"),
    ("lib.datasets.llff.enerf", "enerf_tpu.datasets.llff"),
    ("lib.datasets.zjumocap.enerf", "enerf_tpu.datasets.zjumocap"),
    ("lib.datasets.enerf_outdoor.enerf_path",
     "enerf_tpu.datasets.enerf_outdoor_path"),
])
def test_reference_dataset_paths_map_as_in_jax(ref, module):
    opts = ["train_dataset_module", ref, "test_dataset_module", ref]
    port, jax_cfg = pconfig.make_cfg(opts=opts), jconfig.make_cfg(opts=opts)
    assert (port.train_dataset_module == port.test_dataset_module
            == jax_cfg.test_dataset_module == module)


@pytest.mark.parametrize("module", [
    "enerf_tpu.datasets.zjumocap_interactive"])
def test_unported_dataset_raises(module):
    """The last dataset the port lacked, the interactive ZJU-MoCap one,
    maps to the port's module (``tests/test_torch_interactive.py`` holds
    it against JAX's); a dataset module with no counterpart raises."""
    from enerf_tpu_torch.datasets import zjumocap_interactive
    from enerf_tpu_torch.datasets.loader import dataset_module, make_dataset

    assert dataset_module(module) == zjumocap_interactive.__name__
    cfg = pconfig.make_cfg(opts=["test_dataset_module",
                                 "enerf_tpu.datasets.colmap_scene"])
    with pytest.raises(ValueError, match="not ported"):
        make_dataset(cfg, "test")


# ---------------------------------------------------------------------------
# PNG codec and native
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "numpy"])
def lib_mode(request, monkeypatch):
    """Both implementations of both packages' ``native``: the C library
    (built by g++) and the numpy fallback."""
    if request.param == "numpy":
        for mod in (pnative, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    elif not (pnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain for the native libraries")
    return request.param


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_decoder_matches_imageio(channels, kind, lib_mode):
    """The port's writer forces every row to one filter type; imageio and
    the port's decoder read the file back as the image written."""
    rng = np.random.RandomState(10 * channels + kind)
    shape = (11, 13) if channels == 1 else (11, 13, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    # smooth rows too, so that predictions are near their pixels
    img[5:] = np.cumsum(rng.randint(0, 3, img[5:].shape), axis=1)
    data = image_io.encode_png(img, filters=kind)
    ref = imageio.imread(io.BytesIO(data), format="png")
    got = image_io.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape == img.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


def test_png_decoder_reads_imageio_files(tmp_path):
    """A photo-like image written by imageio (its own filter choice), and
    a file whose rows cycle through all five filter types."""
    y, x = np.mgrid[0:96, 0:128]
    photo = np.stack([np.sin(x / 9.0), np.cos(y / 7.0), np.sin((x + y) / 13.)],
                     -1) * 100 + 128 + np.random.RandomState(0).rand(96, 128, 1) * 20
    photo = photo.astype(np.uint8)
    path = str(tmp_path / "photo.png")
    imageio.imwrite(path, photo)
    np.testing.assert_array_equal(image_io.imread(path), photo)
    image_io.imwrite(path, photo, filters=[0, 1, 2, 3, 4])
    np.testing.assert_array_equal(imageio.imread(path), photo)
    np.testing.assert_array_equal(image_io.imread(path), photo)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(ihdr, rows, extra=b""):
    return (image_io.PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["palette", "16bit", "interlaced", "crc",
                                  "filter5", "short", "trns"])
def test_png_decoder_refuses(case):
    """Never a wrong image: what the reader does not decode raises."""
    rows = bytes([0, 1, 2, 3]) * 2
    ihdr = struct.pack(">IIBBBBB", 1, 2, 8, 2, 0, 0, 0)
    data = {
        "palette": _png(struct.pack(">IIBBBBB", 1, 2, 8, 3, 0, 0, 0),
                        bytes([0, 0]) * 2, _chunk(b"PLTE", bytes(3))),
        "16bit": _png(struct.pack(">IIBBBBB", 1, 2, 16, 2, 0, 0, 0),
                      bytes(7) * 2),
        "interlaced": _png(struct.pack(">IIBBBBB", 1, 2, 8, 2, 0, 0, 1),
                           rows),
        "crc": _png(ihdr, rows).replace(b"IEND\xae", b"IEND\xaf"),
        "filter5": _png(ihdr, bytes([5, 1, 2, 3]) * 2),
        "short": _png(ihdr, rows[:6]),
        "trns": _png(ihdr, rows, _chunk(b"tRNS", bytes(6))),
    }[case]
    with pytest.raises(image_io.PNGError):
        image_io.decode_png(data)


def test_jpeg_without_imageio_raises(tmp_path, monkeypatch):
    """A JPEG is read by the native decoder, imageio made unimportable;
    without the native library as well, reading it raises (no fallback)."""
    import sys

    path = str(tmp_path / "im.jpg")
    img = np.random.RandomState(0).randint(0, 256, (8, 8, 3)).astype(np.uint8)
    imageio.imwrite(path, img)
    ref = imageio.imread(path)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    if pnative.available():
        np.testing.assert_array_equal(image_io.imread(path), ref)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_tried", True)
    with pytest.raises(RuntimeError, match="JPEG"):
        image_io.imread(path)


@pytest.mark.parametrize("bpp,h,w", [(1, 10, 7), (2, 10, 7), (3, 10, 7),
                                     (4, 10, 7), (3, 5, 40)])
def test_png_unfilter_native_matches_numpy(bpp, h, w):
    """The C unfilter against the numpy one on the same scanlines, every
    filter type in one image, 1-4 bytes a pixel, taller and wider than
    square (the numpy version walks the anti-diagonals)."""
    if not pnative.available():
        pytest.skip("no C++ toolchain for the native library")
    rng = np.random.RandomState(3 + bpp + w)
    stride = w * bpp
    raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = np.arange(h) % 5
    c_out = pnative.png_unfilter(raw.reshape(-1), h, stride, bpp)
    lib = pnative._lib
    try:
        pnative._lib, pnative._tried = None, True
        np_out = pnative.png_unfilter(raw.reshape(-1), h, stride, bpp)
    finally:
        pnative._lib = lib
    np.testing.assert_array_equal(c_out, np_out)


def _native_cases(rng):
    u8 = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    rgba = rng.randint(0, 256, (9, 11, 4)).astype(np.uint8)
    unit = rng.rand(9, 11, 3).astype(np.float32)
    pfm = rng.rand(12, 10).astype(np.float32)
    return {
        "u8_to_unit": lambda m: m.u8_to_unit(u8),
        "u8_to_unit_f32": lambda m: m.u8_to_unit(unit * 255),
        "u8_to_pm1": lambda m: m.u8_to_pm1(u8),
        "unit_to_pm1": lambda m: m.unit_to_pm1(unit),
        "u8_rgba_over_white": lambda m: m.u8_rgba_over_white(rgba),
        "pfm_flip": lambda m: m.pfm_flip_downsample(pfm, 1),
        "pfm_flip_half": lambda m: m.pfm_flip_downsample(pfm, 2),
        "collate": lambda m: m.collate([unit, unit * 2, unit + 1]),
    }


@pytest.mark.parametrize("op", sorted(_native_cases(np.random.RandomState(0))))
def test_native_matches_jax(op, lib_mode):
    fn = _native_cases(np.random.RandomState(0))[op]
    port, ref = fn(pnative), fn(jnative)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def test_native_builds_into_build_dir():
    if not pnative.available():
        pytest.skip("no C++ toolchain for the native library")
    so = pnative._so_path()
    assert so.is_file() and so.parent == REPO / "build" / "native"
    assert not list((REPO / "enerf_tpu_torch" / "native").glob("*.so"))


# ---------------------------------------------------------------------------
# The resizes in place of OpenCV's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((756, 1008), (640, 960)),
                                     ((56, 72), (48, 64)),
                                     ((64, 80), (16, 20))])
def test_resize_area_matches_cv2(src, dst):
    from enerf_tpu_torch.datasets.llff import resize_area

    img = (np.random.RandomState(0).rand(*src, 3) * 255).astype(np.float32)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(resize_area(img, dst), ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="upscale"):
        resize_area(img, (src[0] + 1, src[1]))


@pytest.mark.parametrize("scale", [0.125, 0.5])
@pytest.mark.parametrize("shape", [(512, 640), (61, 77)])
def test_resize_nearest_scale_matches_cv2(scale, shape):
    from enerf_tpu_torch.datasets.dtu import resize_nearest_scale

    img = np.random.RandomState(1).rand(*shape).astype(np.float32)
    ref = cv2.resize(img, None, fx=scale, fy=scale,
                     interpolation=cv2.INTER_NEAREST)
    got = resize_nearest_scale(img, scale)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# Each Dataset against the JAX one, sample by sample
# ---------------------------------------------------------------------------

def _cfgs(**enerf_kw):
    """The same small config in both packages (``tests/test_datasets.py``'s
    ``_cfg``), with ``fix_random``."""
    enerf_kw.setdefault("train_input_views", (2, 3))
    enerf_kw.setdefault("test_input_views", 2)
    out = []
    for mod in (jconfig, pconfig):
        cas = mod.CascadeConfig(num=2, volume_planes=(8, 8),
                                num_rays=(64, 256))
        out.append(mod.Config(enerf=mod.ENeRFConfig(cas_config=cas,
                                                    **enerf_kw),
                              fix_random=True))
    return out


def _assert_samples_equal(port, ref):
    assert set(port) == set(ref)
    assert port["meta"] == ref["meta"]
    for k in ref:
        if k == "meta":
            continue
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.startswith("rgb_"):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _compare_datasets(jmod, pmod, jcfg, pcfg, ds_kw, items):
    """Both datasets over ``items`` in order (their rngs advance alike)."""
    jds = jmod.Dataset(jcfg, jconfig.DatasetConfig(**ds_kw))
    pds = pmod.Dataset(pcfg, pconfig.DatasetConfig(**ds_kw))
    assert len(pds) == len(jds) and pds.metas == jds.metas
    for item in items:
        _assert_samples_equal(pds[item], jds[item])


def _write_dtu(tmp, H=64, W=80, depth_views=()):
    """``tests/test_datasets.py``'s DTU layout (49 cams, ``scan1``), and a
    1200×1600 depth PFM for each of ``depth_views``."""
    from enerf_tpu_torch.datasets.dtu import write_pfm

    rng = np.random.RandomState(0)
    root = os.path.join(tmp, "dtu")
    os.makedirs(os.path.join(root, "Cameras/train"), exist_ok=True)
    for i in range(49):
        ang = 0.1 * i
        ext = np.eye(4)
        ext[:3, 3] = [np.sin(ang), np.cos(ang), 600.0]
        ixt = np.array([[50.0, 0, W / 8], [0, 50.0, H / 8], [0, 0, 1]])
        lines = ["extrinsic"]
        lines += [" ".join(str(v) for v in row) for row in ext]
        lines += ["", "intrinsic"]
        lines += [" ".join(str(v) for v in row) for row in ixt]
        lines += ["", "425.0 2.5"]
        with open(os.path.join(root, "Cameras/train",
                               f"{i:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines))
    for i in range(49):
        _imwrite(os.path.join(
            root, "Rectified/scan1_train",
            f"rect_{i + 1:03d}_3_r5000.png"), rng.rand(H, W, 3))
    os.makedirs(os.path.join(root, "Depths/scan1"), exist_ok=True)
    for i in depth_views:
        dpt = (500 + 300 * rng.rand(1200, 1600)).astype(np.float32)
        dpt[rng.rand(1200, 1600) < 0.2] = 0.0
        write_pfm(os.path.join(root, f"Depths/scan1/depth_map_{i:04d}.pfm"),
                  dpt)
    os.makedirs(os.path.join(tmp, "data/mvsnerf"), exist_ok=True)
    with open(os.path.join(tmp, "data/mvsnerf/dtu_train_all.txt"), "w") as f:
        f.write("scan1\n")
    _make_pairs(tmp, ["dtu"], 10)


@pytest.mark.parametrize("split", ["train", "test"])
def test_dtu_dataset_matches_jax(split, tmp_path, monkeypatch):
    """DTU: the train split over all 49 views (the rng's draws in JAX's
    order, three samples in a row), the test split of one scene with its
    1200×1600 PFM depths (``tar_dpt``, ``tar_dpt_{i}``, ``tar_mask``)."""
    from enerf_tpu.datasets import dtu as jdtu
    from enerf_tpu_torch.datasets import dtu as pdtu

    tmp = str(tmp_path)
    _write_dtu(tmp, depth_views=(8, 9) if split == "test" else ())
    monkeypatch.chdir(tmp)
    jcfg, pcfg = _cfgs()
    ds_kw = dict(data_root="dtu", ann_file="data/mvsnerf/dtu_train_all.txt",
                 split=split)
    if split == "test":
        ds_kw["scene"] = "scan1"
    items = [(0, 2), (5, 3), (11, 2)] if split == "train" else [(0, 2),
                                                                (1, 2)]
    _compare_datasets(jdtu, pdtu, jcfg, pcfg, ds_kw, items)


def test_dtu_pfm_readers_match_jax(tmp_path):
    """Both PFM endiannesses and the colour variant, read by both
    packages' readers."""
    from enerf_tpu.datasets import dtu as jdtu
    from enerf_tpu_torch.datasets import dtu as pdtu

    rng = np.random.RandomState(2)
    gray = rng.rand(6, 8).astype(np.float32)
    color = rng.rand(6, 8, 3).astype(np.float32)
    for name, header, arr, dt, scale in [
            ("le.pfm", "Pf", gray, "<f4", "-1"),
            ("be.pfm", "Pf", gray, ">f4", "1"),
            ("rgb.pfm", "PF", color, "<f4", "-1")]:
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(f"{header}\n8 6\n{scale}\n".encode())
            f.write(arr[::-1].astype(dt).tobytes())
        np.testing.assert_array_equal(pdtu.read_pfm(path)[0],
                                      jdtu.read_pfm(path)[0])
        np.testing.assert_array_equal(pdtu.read_pfm_depth_half(path),
                                      jdtu.read_pfm_depth_half(path))
        np.testing.assert_array_equal(pdtu.read_pfm(path)[0], arr)


@pytest.mark.parametrize("split", ["train", "test"])
def test_nerf_synthetic_dataset_matches_jax(split, tmp_path, monkeypatch):
    from enerf_tpu.datasets import nerf_synthetic as jnerf
    from enerf_tpu_torch.datasets import nerf_synthetic as pnerf

    tmp = str(tmp_path)
    _make_nerf_fixture(os.path.join(tmp, "nerf_synthetic"))
    _make_pairs(tmp, ["lego"], 6)
    # a translucent image, so that the white compositing is held too
    rgba = np.random.RandomState(4).randint(0, 256, (40, 40, 4), np.uint8)
    imageio.imwrite(os.path.join(tmp, "nerf_synthetic/lego/train/r_1.png"),
                    rgba)
    monkeypatch.chdir(tmp)
    jcfg, pcfg = _cfgs()
    items = [(0, 2), (1, 3), (2, 2)] if split == "train" else [(0, 2),
                                                                (1, 2)]
    _compare_datasets(jnerf, pnerf, jcfg, pcfg,
                      dict(data_root="nerf_synthetic", scene="lego",
                           split=split), items)


def test_llff_dataset_matches_jax(tmp_path, monkeypatch):
    """LLFF: images at 56×72 resized to ``input_h_w`` (48, 64) (OpenCV's
    area filter in JAX, ``resize_area`` in the port), intrinsics scaled."""
    from enerf_tpu.datasets import llff as jllff
    from enerf_tpu_torch.datasets import llff as pllff

    tmp = str(tmp_path)
    rng = np.random.RandomState(0)
    n, H, W = 6, 56, 72
    root = os.path.join(tmp, "nerf_llff_data", "flower")
    pb = np.zeros((n, 17))
    for i in range(n):
        pose = np.zeros((3, 5))
        pose[:3, :3] = np.eye(3)[:, [1, 0, 2]] * np.array([1, 1, -1])
        pose[:3, 3] = [0.1 * i, 0, 0]
        pose[0, 4], pose[1, 4], pose[2, 4] = H * 4, W * 4, 200.0
        pb[i, :15] = pose.reshape(-1)
        pb[i, 15:] = [2.0 + 0.1 * i, 6.0 + 0.1 * i]
        _imwrite(os.path.join(root, "images_4", f"im_{i:03d}.png"),
                 rng.rand(H, W, 3))
    np.save(os.path.join(root, "poses_bounds.npy"), pb)
    _make_pairs(tmp, ["flower"], n)
    monkeypatch.chdir(tmp)
    jcfg, pcfg = _cfgs()
    _compare_datasets(jllff, pllff, jcfg, pcfg,
                      dict(data_root="nerf_llff_data", scene="flower",
                           split="test", input_h_w=(48, 64)),
                      [(0, 2), (1, 2)])


# ---------------------------------------------------------------------------
# The DataLoader
# ---------------------------------------------------------------------------

def test_loader_stream_matches_jax(tmp_path, monkeypatch):
    """One dataset through both loaders, one worker: the same batches (view
    counts, samples, collation, meta) in the same order."""
    from enerf_tpu.datasets import loader as jloader
    from enerf_tpu.datasets import nerf_synthetic as jnerf
    from enerf_tpu_torch.datasets import loader as ploader
    from enerf_tpu_torch.datasets import nerf_synthetic as pnerf

    tmp = str(tmp_path)
    _make_nerf_fixture(os.path.join(tmp, "nerf_synthetic"))
    _make_pairs(tmp, ["lego"], 6)
    monkeypatch.chdir(tmp)
    jcfg, pcfg = _cfgs()
    ds_kw = dict(data_root="nerf_synthetic", scene="lego", split="train")
    streams = []
    for mod, ds, cfgmod in ((jloader, jnerf.Dataset(jcfg, jconfig.DatasetConfig(
            **ds_kw)), jconfig), (ploader, pnerf.Dataset(
                pcfg, pconfig.DatasetConfig(**ds_kw)), pconfig)):
        sampler = mod.ViewCountSampler(len(ds), [2, 3], [0.5, 0.5],
                                       shuffle=True, seed=5)
        streams.append(list(mod.DataLoader(ds, batch_size=2, sampler=sampler,
                                           max_iter=3, num_workers=1)))
    port, ref = streams
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        _assert_samples_equal(p, r)


class _FakeDataset:
    """``tests/test_loader.py``'s: a sample naming (index, n_views)."""

    def __init__(self, n=12):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, item):
        idx, nv = item
        return {"x": np.full((2, 3), idx, np.float32),
                "nv": np.array(nv, np.int32), "meta": {"idx": idx}}


def test_view_count_sampler_distribution_and_determinism():
    from enerf_tpu_torch.datasets.loader import ViewCountSampler

    s = ViewCountSampler(2000, views=[2, 3, 4], probs=[0.1, 0.8, 0.1],
                         shuffle=True, seed=7)
    s.set_epoch(3)
    items = list(s)
    assert items == list(s)
    assert sorted(i for i, _ in items) == list(range(2000))
    counts = np.bincount([nv for _, nv in items], minlength=5)[2:5]
    assert 120 < counts[0] < 280 and 1450 < counts[1] < 1750
    s.set_epoch(4)
    assert list(s) != items


def test_batch_shares_view_count_and_caps_iterations():
    from enerf_tpu_torch.datasets.loader import DataLoader, ViewCountSampler

    sampler = ViewCountSampler(10, [2, 3], [0.5, 0.5], shuffle=True)
    dl = DataLoader(_FakeDataset(10), batch_size=4, sampler=sampler,
                    max_iter=7, num_workers=2)
    batches = list(dl)
    assert len(batches) == len(dl) == 7 == len(dl.host_ms)
    for b in batches:
        assert b["x"].shape == (4, 2, 3) and b["nv"].shape == (4,)
        assert len(set(b["nv"].tolist())) == 1
        assert b["meta"]["idx"] == [int(v) for v in b["x"][:, 0, 0]]


def test_per_host_sharding_disjoint_and_covering():
    from enerf_tpu_torch.datasets.loader import DataLoader, ViewCountSampler

    seen = []
    for rank in range(2):
        sampler = ViewCountSampler(16, [3], [1.0], shuffle=False)
        dl = DataLoader(_FakeDataset(16), batch_size=2, sampler=sampler,
                        max_iter=None, num_workers=1, process_index=rank,
                        process_count=2)
        got = [int(v) for b in dl for v in b["x"][:, 0, 0]]
        assert got == sorted(got)
        seen.append(set(got))
    assert seen[0] & seen[1] == set()
    assert seen[0] | seen[1] == set(range(16))


def test_loader_propagates_worker_errors():
    from enerf_tpu_torch.datasets.loader import DataLoader, ViewCountSampler

    class _Boom(_FakeDataset):
        def __getitem__(self, item):
            raise RuntimeError("boom")

    dl = DataLoader(_Boom(4), batch_size=2,
                    sampler=ViewCountSampler(4, [2], [1.0], shuffle=False),
                    max_iter=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(dl)


# ---------------------------------------------------------------------------
# Host-only keys
# ---------------------------------------------------------------------------

def test_host_only_keys_stay_on_the_host():
    """``device_batch`` uploads the device inputs only (JAX's
    ``device_batch`` keys), and ``render`` of a batch with or without the
    host-only ground truth gives the same output."""
    import enerf_tpu_torch as et
    from enerf_tpu.datasets.loader import is_host_only as j_is_host_only
    from enerf_tpu_torch.datasets.loader import device_batch, is_host_only
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch

    cfg = pconfig.dtu_eval_config()
    batch = make_synthetic_batch(cfg, H=32, W=64)
    batch["tar_dpt"] = np.ones((1, 32, 64), np.float32)
    batch["tar_dpt_0"] = np.ones((1, 4, 8), np.float32)
    batch["tar_mask"] = np.ones((1, 32, 64), np.uint8)
    batch["meta"] = {"scene": ["s"]}
    keys = set(device_batch(batch, "cpu"))
    assert keys == {k for k in batch if not j_is_host_only(k)}
    assert all(is_host_only(k) == j_is_host_only(k) for k in batch)
    assert "tar_img" not in keys and "tar_ext" in keys
    model = et.build_model(cfg, device="cpu")
    slim = {k: v for k, v in batch.items() if not is_host_only(k)}
    out, out_slim = et.render(model, batch), et.render(model, slim)
    assert set(out) == set(out_slim)
    for k in out:
        torch.testing.assert_close(out[k], out_slim[k], rtol=0, atol=0)


def test_dataset_paths_need_no_image_library(tmp_path, monkeypatch):
    """The DTU loader reads its PNGs, cameras and PFMs with imageio and
    OpenCV made unimportable, as on a machine that has neither."""
    import sys

    from enerf_tpu_torch.datasets import dtu as pdtu

    tmp = str(tmp_path)
    _write_dtu(tmp, depth_views=(8,))
    monkeypatch.chdir(tmp)
    for mod in ("imageio", "imageio.v2", "cv2", "yaml"):
        monkeypatch.setitem(sys.modules, mod, None)
    _, pcfg = _cfgs()
    ds = pdtu.Dataset(pcfg, pconfig.DatasetConfig(
        data_root="dtu", ann_file="data/mvsnerf/dtu_train_all.txt",
        split="test", scene="scan1"))
    s = ds[(0, 2)]
    assert s["tar_dpt_0"].shape == (64, 80) and s["tar_img"].shape == (64, 80, 3)
    cfg = pconfig.make_cfg(str(REPO / "configs/enerf/dtu_pretrain.yaml"))
    assert dataclasses.asdict(cfg)["test_dataset"]["split"] == "test"

"""The port's dynamic-scene datasets held against the JAX package's, sample
by sample: ZJU-MoCap (both splits, non-zero lens distortion,
``input_ratio`` 0.5), ENeRF-Outdoor (ratio 0.75 and the ``input_h_w``
crop, both splits, non-zero distortion) and the outdoor orbit path.

The scenes are written as ``tests/test_datasets.py`` writes them (its
``_imwrite`` and ``_make_outdoor_fixture`` are imported): JPEG frames by
imageio, PNG masks, ``annots.npy``, OpenCV ``FileStorage`` cameras, a
``background.ply``. The JAX datasets decode with imageio and OpenCV, the
port's with its own JPEG decoder and ``utils/cv.py``, both with
``fix_random`` so that their rngs draw alike. Tolerances: every array
exact, except the level's ``rgb_i`` (1e-6; the 1/4-scale target image is
OpenCV's area filter in JAX, an average pool in the port)."""

import dataclasses
import os

import cv2
import numpy as np
import pytest

from enerf_tpu import config as jconfig
from tests.test_datasets import _imwrite, _make_outdoor_fixture
from tests.test_torch_datasets import _assert_samples_equal, _cfgs
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

N_CAMS, N_FRAMES, ZJU_HW = 6, 2, 64


def _zju_distortion(c):
    return np.array([[-0.2 + 0.03 * c], [0.08], [1e-3 * (c - 2)],
                     [-2e-3], [0.01 * c]])


def _write_zjumocap(root):
    """``tests/test_datasets.py``'s ZJU-MoCap layout with lens distortion
    and a disc-shaped mask per view."""
    rng = np.random.RandomState(0)
    scene_root = os.path.join(root, "zju_mocap", "CoreView_313")
    H = W = ZJU_HW
    Ks, Rs, Ts, Ds, ims = [], [], [], [], []
    for c in range(N_CAMS):
        # on a circle of radius 2 at height 0.5, looking at the subject
        ang = 2 * np.pi * c / N_CAMS
        eye = np.array([2 * np.sin(ang), -2 * np.cos(ang), 0.5])
        fwd = np.array([0.25, 0.25, 0.25]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        Ks.append(np.array([[80.0, 0, W / 2 + c], [0, 80.0, H / 2 - c],
                            [0, 0, 1]]))
        Rs.append(R)
        Ts.append((-R @ eye).reshape(3, 1) * 1000.0)
        Ds.append(_zju_distortion(c))
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(N_FRAMES):
        paths = []
        for c in range(N_CAMS):
            rel = f"Camera_B{c + 1}/{f:06d}.jpg"
            _imwrite(os.path.join(scene_root, rel), rng.rand(H, W, 3))
            mask = ((yy - 30 - c) ** 2 + (xx - 34 + f) ** 2 < 15 ** 2)
            _imwrite(os.path.join(scene_root, "mask", rel[:-4] + ".png"),
                     mask.astype(np.float64))
            paths.append(rel)
        ims.append({"ims": paths})
        os.makedirs(os.path.join(scene_root, "new_vertices"), exist_ok=True)
        np.save(os.path.join(scene_root, "new_vertices", f"{f + 1}.npy"),
                rng.rand(10, 3) * 0.5)
    np.save(os.path.join(scene_root, "annots.npy"),
            {"cams": {"K": Ks, "R": Rs, "T": Ts, "D": Ds}, "ims": ims})


def _write_outdoor(root):
    """``tests/test_datasets.py``'s ENeRF-Outdoor scene, its ``intri.yml``
    rewritten by OpenCV with non-zero distortion."""
    scene_root = _make_outdoor_fixture(root)
    path = os.path.join(scene_root, "intri.yml")
    src = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    names = [src.getNode("names").at(i).string()
             for i in range(src.getNode("names").size())]
    Ks = {n: src.getNode(f"K_{n}").mat() for n in names}
    src.release()
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.startWriteStruct("names", cv2.FileNode_SEQ)
    for n in names:
        fs.write("", n)
    fs.endWriteStruct()
    for c, n in enumerate(names):
        fs.write(f"K_{n}", Ks[n])
        fs.write(f"dist_{n}", np.array([[-0.1 + 0.02 * c], [0.03], [5e-4],
                                        [-1e-3 * c], [0.002]]))
    fs.release()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("video_scenes"))
    _write_zjumocap(root)
    _write_outdoor(root)
    return root


def _pair(root, **enerf_kw):
    return [dataclasses.replace(c, workspace=root)
            for c in _cfgs(**enerf_kw)]


def _compare(jmod, pmod, cfgs, ds_kw, items):
    from enerf_tpu_torch import config as pconfig

    jcfg, pcfg = cfgs
    jds = jmod.Dataset(jcfg, jconfig.DatasetConfig(**ds_kw))
    pds = pmod.Dataset(pcfg, pconfig.DatasetConfig(**ds_kw))
    assert len(pds) == len(jds) and pds.metas == jds.metas
    for item in items:
        _assert_samples_equal(pds[item], jds[item])
    return pds


@pytest.mark.parametrize("split", ["train", "test"])
def test_zjumocap_matches_jax(split, scenes):
    """Both splits at ``input_ratio`` 0.5 with distorted lenses: the
    undistorted, dilated and resized images and masks, the bbox near / far
    and ``mask_at_box``, and on the train split the source-view draws and
    the ray samples, three samples in a row."""
    from enerf_tpu.datasets import zjumocap as jzju
    from enerf_tpu_torch.datasets import zjumocap as pzju

    views = (0, -1, 1) if split == "train" else (0, -1, 2)
    render = (0, -1, 1) if split == "train" else (1, -1, 2)
    ds_kw = dict(data_root="zju_mocap", scene="CoreView_313", split=split,
                 frames=(0, -1, 1), input_ratio=0.5,
                 extra=(("input_views", views), ("render_views", render)))
    items = [(0, 2), (3, 3), (7, 2)] if split == "train" else [(0, 2),
                                                                (3, 2)]
    pds = _compare(jzju, pzju, _pair(scenes, sample_on_mask=True), ds_kw,
                   items)
    s = pds[items[-1]]
    assert s["src_inps"].shape[1:3] == (ZJU_HW // 2, ZJU_HW // 2)
    if split == "test":
        assert 0 < s["mask_at_box"].sum() < s["mask_at_box"].size


@pytest.mark.parametrize("split", ["train", "test"])
def test_enerf_outdoor_matches_jax(split, scenes):
    """Both splits at ratio 0.75 then the ``input_h_w`` crop (96 -> 72 ->
    64x56), distorted lenses: the images, the bg plates, the fg window,
    the fg and per-view bg near / far, the rays."""
    from enerf_tpu.datasets import enerf_outdoor as jout
    from enerf_tpu_torch.datasets import enerf_outdoor as pout

    ds_kw = dict(data_root="enerf_outdoor", scene="actor1", split=split,
                 frames=(0, -1, 1), input_ratio=0.75, input_h_w=(64, 56),
                 extra=(("input_views", (0, -1, 1)),
                        ("render_views", (0, -1, 1) if split == "train"
                         else (0, 2, 1))))
    items = [(0, 2), (4, 3), (9, 2)] if split == "train" else [(0, 2),
                                                                (3, 2)]
    pds = _compare(jout, pout, _pair(scenes, num_fg_layers=1,
                                     fg_bbox_hw=(32, 32), viewdir_agg=False),
                   ds_kw, items)
    s = pds[items[0]]
    assert s["src_inps"].shape[1:3] == (64, 56)
    assert s["bg_src_inps"].shape == s["src_inps"].shape


def test_enerf_outdoor_path_matches_jax(scenes):
    """The orbit path: one meta a frame, the targets' synthesized
    extrinsics and the source views nearest to each."""
    from enerf_tpu.datasets import enerf_outdoor_path as jpath
    from enerf_tpu_torch.datasets import enerf_outdoor_path as ppath

    ds_kw = dict(data_root="enerf_outdoor", scene="actor1", split="test",
                 frames=(0, -1, 1), input_ratio=0.75, input_h_w=(64, 56),
                 extra=(("input_views", (0, -1, 1)),
                        ("render_views", (0, 2, 1)),
                        ("num_circle_view", 10)))
    pds = _compare(jpath, ppath, _pair(scenes, num_fg_layers=1,
                                       fg_bbox_hw=(32, 32),
                                       viewdir_agg=False),
                   ds_kw, [(0, 2), (1, 2)])
    assert len(pds) == N_FRAMES


@pytest.mark.parametrize("module", ["zjumocap", "enerf_outdoor",
                                    "enerf_outdoor_path"])
def test_video_datasets_ported(module):
    """The loader maps the configs' module paths to the port's datasets."""
    from enerf_tpu_torch.datasets.loader import dataset_module

    assert dataset_module(f"enerf_tpu.datasets.{module}") == (
        f"enerf_tpu_torch.datasets.{module}")


def test_geometry_matches_jax():
    """``utils/geometry.py``'s projection, ray / box intersections and box
    corners against the JAX package's on the same random inputs."""
    from enerf_tpu.utils import geometry as jgeo
    from enerf_tpu_torch.utils import geometry as pgeo

    rng = np.random.RandomState(3)
    bounds = np.sort(rng.randn(2, 3), axis=0)
    rays = np.concatenate([rng.randn(50, 3) * 3, rng.randn(50, 3),
                           rng.rand(50, 2)], -1)
    K = np.array([[100.0, 0, 32], [0, 90.0, 24], [0, 0, 1]])
    RT = np.concatenate([cv2.Rodrigues(rng.randn(3))[0],
                         rng.randn(3, 1) + [[0], [0], [6]]], 1)
    np.testing.assert_array_equal(pgeo.get_bound_corners(bounds),
                                  jgeo.get_bound_corners(bounds))
    np.testing.assert_array_equal(pgeo.project(rays[:, :3], K, RT),
                                  jgeo.project(rays[:, :3], K, RT))
    np.testing.assert_array_equal(pgeo.rays_aabb_mask(rays, bounds),
                                  jgeo.rays_aabb_mask(rays, bounds))
    for a, b in zip(pgeo.get_near_far(bounds, rays[:, :3], rays[:, 3:6]),
                    jgeo.get_near_far(bounds, rays[:, :3], rays[:, 3:6])):
        np.testing.assert_array_equal(a, b)

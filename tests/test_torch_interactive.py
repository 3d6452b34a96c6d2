"""The port's interactive path against the JAX package's on the CPU: the
camera, the interactive ZJU-MoCap dataset and its rail, and the headless
GUI loop end to end.

The scene is ``tests/test_interactive.py``'s fixture (8 cameras on a ring,
2 frames of 64x64 JPEGs written by imageio, PNG masks, no distortion),
read through ``configs/enerf/interactive/zjumocap.yaml`` at 64x64 (its
planes (32, 8), 2 of the 8 cameras a query, level 1 rendered) with a
(48, 48) mask window, and JAX's gather tables in f32 (the YAML's
``gather_bf16`` off; its Pallas kernels run in interpret mode). One JAX ``gui_human.Renderer`` serves the file: its
weights are seeded in the JAX variables tree (``jax.eval_shape``, no init
compile) and its eval step compiles at ``xla_backend_optimization_level``
0; the port's ``Renderer`` takes the same weights through the converter.

Tolerances: the camera's float64 matrices to 1e-12; the query's arrays
exactly but ``rays_1`` (rtol 1e-6: the grid's rotation is a torch and an
XLA matmul) and ``mask_at_box`` (exact but for rays whose slab
``near - far`` lies within 1e-5 of 0, counted); the rail's splines
exactly; the rendered frames at rtol 1e-3 / atol 3e-4 as
``tests/test_torch_human.py``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests.test_interactive import _make_zjumocap_fixture
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CFG = str(REPO / "configs" / "enerf" / "interactive" / "zjumocap.yaml")
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# 3 poses: two on the rail, one dragged off it (orbit and pan)
RAIL_U = (0.0, 0.37)


def _opts(root):
    return ["workspace", str(root), "test_dataset.frames", "[0, -1, 1]",
            "test_dataset.base_hw", "[64, 64]",
            "test_dataset.input_ratio", "1.0",
            "test_dataset.n_known_cams", "8",
            "enerf.mask_window_hw", "[48, 48]",
            # JAX's bf16 gather tables (a TPU key the port's reader drops;
            # the port computes in f32)
            "enerf.gather_bf16", "False"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("interactive")
    _make_zjumocap_fixture(str(root))
    return root


@pytest.fixture(scope="module")
def jax_renderer(scene):
    """The JAX ``gui_human.Renderer`` on the fixture, with seeded weights
    and a fast-compiled eval step."""
    import jax

    import gui_human
    from enerf_tpu.config import make_cfg as j_make_cfg
    from enerf_tpu.factory import network_class
    from tests.test_torch_modules import seeded_variables

    cfg = j_make_cfg(CFG, _opts(scene))
    rend = gui_human.Renderer(cfg)
    model = network_class(cfg)(cfg=cfg.enerf, train_mode=False)
    rend._load = lambda batch: seeded_variables(
        model, np.random.RandomState(0), batch)
    rend.eval_step = jax.jit(
        lambda params, stats, batch: model.apply(
            {"params": params, "batch_stats": stats}, batch),
        compiler_options=FAST_COMPILE)
    return rend


def _poses(ds, cam_cls):
    """(c2w, w2c) of the 3 test poses through ``ds``'s rail."""
    cen_tck, _, fro_tck, _, wup_tck, _ = ds.get_camera_tck(0.1)
    cam = cam_cls(*ds.get_camera_up_front_center(0), front_tck=fro_tck,
                  center_tck=cen_tck, worldup_tck=wup_tck)
    cam.on_cam_path = True
    poses = []
    for u in RAIL_U:
        cam.cam_path_u = u
        cam.update_from_cam_path()
        poses.append((cam.get_c2w(), cam.get_w2c()))
    cam.on_cam_path = False
    cam.begin_drag(10, 20, about_origin=True)
    cam.drag_update(40, 28)
    cam.end_drag()
    cam.begin_drag(0, 0, is_pan=True)
    cam.drag_update(6, -4)
    cam.end_drag()
    poses.append((cam.get_c2w(), cam.get_w2c()))
    return poses


def test_camera_matches_jax():
    """One sequence of gestures on both cameras: orbit about the origin,
    rotate in place with y fixed, pan, move, the rail at several u."""
    from scipy import interpolate

    from enerf_tpu.interactive.camera import Camera as JCamera
    from enerf_tpu_torch.interactive.camera import Camera as PCamera

    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    ring = np.stack([2 * np.sin(ang), -2 * np.cos(ang), 0.8 + 0.1 * ang])
    tck = interpolate.splprep(ring, s=0.0, per=1)[0]
    fro = interpolate.splprep(-ring / np.linalg.norm(ring, axis=0), s=0.0,
                              per=1)[0]
    wup = interpolate.splprep(np.tile([[0.0], [0.0], [1.0]], 8) + 0.01 * ring,
                              s=0.0, per=1)[0]
    cams = [cls(center_tck=tck, front_tck=fro, worldup_tck=wup)
            for cls in (JCamera, PCamera)]

    def act(cam):
        yield
        cam.begin_drag(100, 100, about_origin=True)
        cam.drag_update(180, 130)
        yield
        cam.drag_update(20, 250)
        cam.end_drag()
        yield
        cam.begin_drag(5, 5, fix_y=True)
        cam.drag_update(300, -40)
        cam.end_drag()
        yield
        cam.begin_drag(0, 0, is_pan=True, about_origin=True)
        cam.drag_update(50, -20)
        cam.move([0.1, -0.2, 0.05])
        cam.end_drag()
        yield
        cam.on_cam_path = True
        for u in (0.0, 0.25, 0.93):
            cam.cam_path_u = u
            cam.update_from_cam_path()
            yield
        cam.begin_drag(10, 10)
        cam.drag_update(200, 10)
        cam.end_drag()
        yield

    steps = 0
    for _ in zip(*(act(c) for c in cams)):
        j, p = cams
        np.testing.assert_allclose(p.c2w, j.c2w, rtol=0, atol=1e-12)
        np.testing.assert_allclose(p.w2c, j.w2c, rtol=0, atol=1e-12)
        assert p.cam_path_u == pytest.approx(j.cam_path_u, abs=1e-12)
        np.testing.assert_array_equal(p.intrinsics(), j.intrinsics())
        steps += 1
    assert steps == 9


def _assert_tree_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_interactive_dataset_matches_jax(jax_renderer, scene):
    """The query of 3 poses (two on the rail, one off it) key by key, and
    the rail's splines and the nearest camera."""
    from scipy import interpolate

    from enerf_tpu.interactive.camera import Camera as JCamera
    from enerf_tpu_torch.config import make_cfg
    from enerf_tpu_torch.datasets.loader import make_dataset

    jds = jax_renderer.dataset
    pds = make_dataset(make_cfg(CFG, _opts(scene)), "test", device="cpu")
    assert (len(pds), pds.n_cams, pds.input_h_w) == (2, 8, [64, 64])
    _assert_tree_equal(pds.get_camera_tck(0.1), jds.get_camera_tck(0.1))
    for x, y in zip(pds.get_camera_up_front_center(3),
                    jds.get_camera_up_front_center(3)):
        np.testing.assert_array_equal(x, y)
    cen_tck = pds.get_camera_tck(0.0)[0]
    for u in (0.1, 0.6):
        c = np.array(interpolate.splev(u, cen_tck)).reshape(3)
        assert pds.get_closest_camera(c) == jds.get_closest_camera(c)

    n_ties = 0
    for frame, (c2w, w2c) in zip((0, 1, 1), _poses(jds, JCamera)):
        ref = {k: np.asarray(v) for k, v in jds[(frame, c2w, w2c)].items()}
        got = {k: v.numpy() for k, v in pds[(frame, c2w, w2c)].items()}
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            if k == "rays_1":
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
            elif k != "mask_at_box":
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        # the rays that flip are near-ties of the slab test
        rays = ref["rays_1"].reshape(-1, 8)
        bounds = jds.cache[frame]["bounds"]
        d = rays[:, 3:6] / np.linalg.norm(rays[:, 3:6], axis=-1,
                                          keepdims=True)
        d = np.where((d >= 0) & (d < 1e-5), 1e-5, d)
        d = np.where((d < 0) & (d > -1e-5), -1e-5, d)
        t0, t1 = (bounds[0] - rays[:, :3]) / d, (bounds[1] - rays[:, :3]) / d
        gap = np.minimum(t0, t1).max(-1) - np.maximum(t0, t1).min(-1)
        flip = got["mask_at_box"].reshape(-1) != ref["mask_at_box"].reshape(-1)
        assert (np.abs(gap[flip]) < 1e-5).all()
        n_ties += int(flip.sum())
        m = ref["mask_at_box"]
        assert 0 < m.sum() < m.size
    assert n_ties <= 3, n_ties


def test_headless_loop_matches_jax(jax_renderer, scene, tmp_path):
    """The port's ``Renderer`` on the CPU with the JAX renderer's weights:
    the first 2 rail frames of ``run_headless`` equal JAX's
    ``render_next`` on the same rail; ``interactive.mp4`` reads back with
    OpenCV: 2 frames of 64x64 at ``cfg.fps``."""
    from enerf_tpu_torch import gui_human as pgui
    from enerf_tpu_torch.config import make_cfg
    from enerf_tpu_torch.utils.convert import load_flax_variables

    jrend = jax_renderer
    jrend.iter, jrend.cam.on_cam_path = 0, True
    ref = []
    for i in range(2):
        jrend.cam.cam_path_u = i / 2
        jrend.cam.update_from_cam_path()
        ref.append(jrend.render_next())

    cfg = make_cfg(CFG, _opts(scene) + ["workspace", str(tmp_path)])
    cfg = dataclasses.replace(cfg, test_dataset=dataclasses.replace(
        cfg.test_dataset, data_root=str(scene / "zju_mocap")))
    rend = pgui.Renderer(cfg, device="cpu")
    load_flax_variables(rend.model, jrend.variables)
    res = pgui.run_headless(rend, 2)
    assert res["frames"] == 2 and len(rend.splits) == 2 and rend.fps > 0
    assert res["splits"][0]["upload_bytes"] == (
        2 * 64 * 64 * 3 * 4 + 4 * (16 + 9 + 3 * 16 + 3 * 9 + 3 + 2 + 6))
    for (batch, out), want in zip(
            [(res["first_batch"], res["first_out"]),
             (rend.last_batch, rend.last_out)], ref):
        got = rend.visualizer.visualize(
            {k: v.numpy() for k, v in out.items()}, batch)["pred"]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=3e-4)
    assert float(np.abs(ref[1]).max()) > 0.05
    cap = cv2.VideoCapture(res["path"])
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    assert cap.get(cv2.CAP_PROP_FPS) == cfg.fps
    assert len(frames) == 2 and frames[0].shape == (64, 64, 3)


def test_gui_cli_headless_only(scene, tmp_path):
    """``python -m enerf_tpu_torch.gui_human`` without ``--headless`` opens
    the windowed GUI, which raises JAX's error where ``glfw.init()`` fails
    (a stand-in ``glfw`` without a display here); with ``--headless 1
    --device cpu`` it runs in a fresh interpreter without loading JAX,
    OpenCV, imageio, Pillow, PyYAML, glfw or OpenGL (tqdm is loaded by
    torch.hub where it is installed; no module of the port imports it,
    ``tests/test_torch_guards.py``)."""
    import chip_smoke as cs
    from enerf_tpu_torch import gui_human as pgui

    opts = _opts(scene)
    opts[opts.index("workspace") + 1] = str(tmp_path)
    glfw, gl, rec = cs.stub_gl_modules(frames=1, init_ok=False)
    with cs.stub_gl(glfw, gl), pytest.raises(
            RuntimeError, match="no display. use --headless"):
        pgui.main(["--device", "cpu", *opts, "test_dataset.data_root",
                   str(scene / "zju_mocap")])
    assert rec["polls"] == 0
    code = ("import runpy, sys\n"
            "sys.argv = ['gui_human'] + sys.argv[1:]\n"
            "runpy.run_module('enerf_tpu_torch.gui_human', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "    ('jax', 'flax', 'enerf_tpu', 'yaml', 'cv2', 'imageio', "
            "'PIL', 'glfw', 'OpenGL'))\n"
            "print('LOADED', bad)\n")
    res = subprocess.run(
        [sys.executable, "-c", code, "--headless", "1", "--device", "cpu",
         *opts, "test_dataset.data_root", str(scene / "zju_mocap")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO),
                           OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout and "frame 1/1" in res.stdout
    assert list(tmp_path.glob("result/**/interactive.mp4"))

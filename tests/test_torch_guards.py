"""Guards of the port's contract: it never imports JAX or the JAX package
(nor PyYAML, OpenCV, imageio, Pillow or tqdm, which it does without, nor
glfw or OpenGL outside the windowed GUI's ``run_gui``), its entry points
never drop to the CPU on their own, its kernel wrappers never fall back,
and its own copies of the config and synthetic-data modules equal the JAX
package's."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import enerf_tpu_torch
from enerf_tpu_torch.config import dtu_eval_config, make_cfg
from enerf_tpu_torch.ops.kernels import _build
from enerf_tpu_torch.ops.kernels import conv3d_wgrad as kwg
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import render as krender
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "enerf_tpu")
# packages the port does without: nothing of it imports them
UNNEEDED = ("yaml", "cv2", "imageio", "tqdm", "PIL", "glfw", "OpenGL")
# not loaded at all by the package's modules (torch.hub loads tqdm itself
# where it is installed)
LOADED_FORBIDDEN = ("yaml", "cv2", "imageio", "PIL", "glfw", "OpenGL")


def test_no_jax_import_in_subprocess():
    """Build and run the models (the DTU cascade, the human and the
    composite variants) on the CPU in a fresh interpreter, then check that
    nothing of JAX, flax or enerf_tpu was imported. Building and rendering
    loads nothing of the evaluation layer; the evaluator is then made from
    the config."""
    code = (
        "import sys\n"
        "import enerf_tpu_torch as et\n"
        "from enerf_tpu_torch.config import dtu_eval_config\n"
        "from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch\n"
        "import enerf_tpu_torch.utils.convert, enerf_tpu_torch.ops.warp\n"
        "import enerf_tpu_torch.train\n"
        "cfg = dtu_eval_config()\n"
        "out = et.render(et.build_model(cfg, device='cpu'),\n"
        "                make_synthetic_batch(cfg, H=64, W=96))\n"
        "assert out['rgb_level1'].shape == (1, 64 * 96, 3)\n"
        "import dataclasses\n"
        "from enerf_tpu_torch.config import human_eval_config, human_mask\n"
        "from enerf_tpu_torch.config import composite_eval_config\n"
        "from enerf_tpu_torch.datasets.synthetic import make_composite_batch\n"
        "cfg = human_eval_config()\n"
        "cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(\n"
        "    cfg.enerf, mask_window_hw=(32, 32)))\n"
        "b = dict(make_synthetic_batch(cfg, H=64, W=96),\n"
        "         mask_at_box=human_mask(64, 96))\n"
        "out = et.render(et.build_model(cfg, device='cpu'), b)\n"
        "assert out['rgb_level1'].shape == (1, 64 * 96, 3)\n"
        "cfg = composite_eval_config()\n"
        "cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(\n"
        "    cfg.enerf, fg_bbox_hw=(32, 32)))\n"
        "out = et.render(et.build_model(cfg, device='cpu'),\n"
        "                make_composite_batch(cfg, H=64, W=96))\n"
        "assert out['rgb_level1'].shape == (1, 64 * 96, 3)\n"
        "assert not any(m.startswith('enerf_tpu_torch.eval') for m in\n"
        "               sys.modules)\n"
        "from enerf_tpu_torch.factory import make_evaluator\n"
        "make_evaluator(cfg, device='cpu', lpips_path='absent.npz')\n"
        "import enerf_tpu_torch.native, enerf_tpu_torch.utils.image_io\n"
        "import enerf_tpu_torch.datasets.loader, enerf_tpu_torch.run\n"
        "import enerf_tpu_torch.datasets.dtu\n"
        "import enerf_tpu_torch.datasets.nerf_synthetic\n"
        "import enerf_tpu_torch.datasets.llff\n"
        "import enerf_tpu_torch.datasets.zjumocap\n"
        "import enerf_tpu_torch.datasets.enerf_outdoor\n"
        "import enerf_tpu_torch.datasets.enerf_outdoor_path\n"
        "import enerf_tpu_torch.utils.camera_io, enerf_tpu_torch.utils.ply\n"
        "import enerf_tpu_torch.train.__main__\n"
        "import enerf_tpu_torch.gui_human, enerf_tpu_torch.utils.video\n"
        "import enerf_tpu_torch.interactive.camera\n"
        "import enerf_tpu_torch.interactive.render_options\n"
        "import enerf_tpu_torch.eval.visualizer\n"
        "import enerf_tpu_torch.eval.visualizer_interactive\n"
        "import enerf_tpu_torch.datasets.zjumocap_interactive\n"
        "import enerf_tpu_torch.parallel, enerf_tpu_torch.graft_entry\n"
        "import enerf_tpu_torch.utils.img, enerf_tpu_torch.utils.labels\n"
        "import enerf_tpu_torch.utils.colmap, enerf_tpu_torch.utils.mesh\n"
        "import enerf_tpu_torch.utils.profiling\n"
        "import enerf_tpu_torch.utils.val_data, enerf_tpu_torch.utils.rend\n"
        "import enerf_tpu_torch.utils.geometry, enerf_tpu_torch.ops.sh\n"
        "import enerf_tpu_torch.models.res_unet\n"
        "import enerf_tpu_torch.interactive.font\n"
        "from enerf_tpu_torch.config import make_cfg\n"
        "make_cfg('configs/enerf/dtu_pretrain.yaml')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        f"             {FORBIDDEN + LOADED_FORBIDDEN!r})\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


# the windowed GUI's modules, imported where they are used and nowhere else
GUI_ONLY = ("glfw", "OpenGL")
GUI_SITE = ("enerf_tpu_torch/gui_human.py", "run_gui")


def _imports(path: Path):
    """(module, enclosing top-level function or None) for every import
    statement, lazy ones included."""
    tree = ast.parse(path.read_text())
    for top in tree.body:
        func = top.name if isinstance(top, ast.FunctionDef) else None
        for node in ast.walk(top):
            if isinstance(node, ast.Import):
                yield from ((a.name, func) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                yield node.module or "", func


def test_no_jax_import_in_sources():
    """No module of the package, and not ``chip_smoke.py`` (its ``run_dtu``
    phase included), names JAX, flax or enerf_tpu in an import statement,
    lazy imports included; none imports PyYAML, OpenCV, imageio, Pillow,
    tqdm, glfw or OpenGL, but for glfw and OpenGL inside
    ``gui_human.run_gui``, the windowed GUI, which needs them and imports
    them when it opens its window."""
    paths = sorted((REPO / "enerf_tpu_torch").rglob("*.py"))
    paths.append(REPO / "chip_smoke.py")
    gui_imports = []
    for path in paths:
        rel = str(path.relative_to(REPO))
        for name, func in _imports(path):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, (rel, name)
            if root in GUI_ONLY and (rel, func) == GUI_SITE:
                gui_imports.append(name)
                continue
            assert root not in UNNEEDED, (rel, name)
    assert sorted(gui_imports) == ["OpenGL.GL", "glfw"], gui_imports
    smoke = (REPO / "chip_smoke.py").read_text()
    for phase in ("run_dtu", "jpeg", "run_zjumocap", "run_outdoor",
                  "train_cli", "interactive", "visualize", "ddp", "extras"):
        assert f"def phase_{phase}" in smoke, phase


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        enerf_tpu_torch.build_model(dtu_eval_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        enerf_tpu_torch.build_model(dtu_eval_config(), device="cuda")
    assert enerf_tpu_torch.build_model(dtu_eval_config(), device="cpu")


@pytest.mark.parametrize("entry", ["gui_human", "run_visualize",
                                   "graft_entry"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """``python -m enerf_tpu_torch.gui_human --headless N``, ``run --type
    visualize`` and ``graft_entry.entry()`` without a device ask for the
    GPU and raise without one, before they read or write a file."""
    from enerf_tpu_torch import graft_entry, gui_human, run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = ["workspace", str(tmp_path / "absent")]
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "gui_human":
            gui_human.main(["--headless", "2", *opts])
        elif entry == "graft_entry":
            graft_entry.entry()
        else:
            run.main(["--type", "visualize", "--cfg_file", str(
                REPO / "configs/enerf/enerf_outdoor/actor1_path.yaml"),
                *opts])
    assert not (tmp_path / "absent").exists()


def test_kernel_loader_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc_candidates", lambda: [])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in _build.KERNELS:
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.load_library(name)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize("kernel", ["cost_volume", "cost_volume_crop",
                                    "render", "render_l0", "render_cf19",
                                    "conv3d_wgrad"])
def test_wrappers_raise_off_cpu(kernel):
    """A tensor that is not on the CPU never takes the plain path: off a
    CUDA device the wrapper raises instead of computing; at a head shape no
    render kernel is built for (``render_cf19``: 19 image channels, 8
    samples) it raises for the shape on any device. (Under no_grad: the
    render head's parameters require a gradient, which the wrapper refuses
    first, see ``tests/test_torch_depth_kernel.py``.)"""
    meta = dict(device="meta", dtype=torch.float32)
    before = (kcv.launches, dict(krender.launches), kwg.launches)
    match = "built for" if kernel == "render_cf19" else "CUDA"
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        if kernel == "conv3d_wgrad":
            kwg.wgrad(torch.empty(1, 8, 4, 4, 4, **meta),
                      torch.empty(1, 8, 4, 4, 4, **meta), 1)
        elif kernel.startswith("cost_volume"):
            window = None
            if kernel == "cost_volume_crop":
                window = (torch.zeros(1, 2, dtype=torch.int32,
                                      device="meta"), (4, 4))
            kcv.fused_cost_volume(torch.empty(1, 3, 8, 8, 16, **meta),
                                  torch.empty(1, 3, 3, 4, **meta),
                                  torch.empty(1, 4, 8, 8, **meta),
                                  window=window)
        else:
            from enerf_tpu_torch.models.nerf_head import NeRFHead

            cf, n = {"render": (11, 2), "render_l0": (35, 8),
                     "render_cf19": (19, 8)}[kernel]
            krender.render_rays(
                torch.empty(1, 4, n, 3, **meta), torch.empty(1, 4, n, 3, **meta),
                torch.empty(1, 4, n, **meta), torch.empty(1, 3, 2, 2, cf, **meta),
                torch.empty(1, 8, 2, 2, 8, **meta), torch.empty(1, 3, 4, 4, **meta),
                torch.empty(1, 3, 3, 3, **meta), torch.empty(1, 4, 4, **meta),
                None, NeRFHead(cf).to("meta"), render_scale=1.0)
    assert (kcv.launches, krender.launches, kwg.launches) == before


def test_config_copy_matches_jax():
    from enerf_tpu.config import make_cfg as j_make_cfg

    path = str(REPO / "configs" / "enerf" / "dtu_pretrain.yaml")
    opts = ["enerf.cas_config.volume_planes", "48,8",
            "enerf.cas_config.render_if", "False,True",
            "enerf.fused_render", "True"]
    port, ref = make_cfg(path, opts), j_make_cfg(path, opts)
    assert dataclasses.asdict(port.enerf.cas_config) == dataclasses.asdict(
        ref.enerf.cas_config)
    for f in dataclasses.fields(port.enerf):
        if f.name != "cas_config":
            assert getattr(port.enerf, f.name) == getattr(ref.enerf, f.name), f.name
    assert not hasattr(port.enerf, "fused_render")


@pytest.mark.parametrize("n_src", [3, 2])
def test_synthetic_batch_copy_matches_jax(n_src):
    from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
    from enerf_tpu.datasets.synthetic import make_synthetic_batch as j_batch
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch

    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3),
        cas_config=CascadeConfig(volume_planes=(48, 8))))
    port = make_synthetic_batch(dtu_eval_config(), H=32, W=48, n_src=n_src,
                                seed=3)
    ref = j_batch(jcfg, H=32, W=48, n_src=n_src, seed=3)
    assert set(port) == set(ref)
    for k in ref:
        # rgb_0 is the 1/4-scale target image: the JAX package resizes it
        # with OpenCV's area filter when OpenCV is installed, the port
        # with the equal numpy average pool (float rounding apart)
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("variant,split", [("", "test"), ("human", "test"),
                                           ("human", "train"),
                                           ("composite", "test")])
def test_synthetic_dataset_copy_matches_jax(variant, split):
    """The port's ``Dataset`` (and ``make_composite_batch``) give the JAX
    package's samples for each variant."""
    from enerf_tpu.config import CascadeConfig, Config, DatasetConfig, ENeRFConfig
    from enerf_tpu.datasets import synthetic as jsyn
    from enerf_tpu_torch.config import composite_eval_config
    from enerf_tpu_torch.config import DatasetConfig as PDatasetConfig
    from enerf_tpu_torch.datasets import synthetic as psyn

    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), num_fg_layers=2,
        fg_bbox_hw=(16, 24), cas_config=CascadeConfig(volume_planes=(48, 8))))
    pcfg = dataclasses.replace(composite_eval_config(), enerf=dataclasses.replace(
        composite_eval_config().enerf, num_fg_layers=2, fg_bbox_hw=(16, 24),
        viewdir_agg=True, cas_config=dataclasses.replace(
            composite_eval_config().enerf.cas_config, volume_planes=(48, 8),
            num_samples=(8, 2), render_if=(True, True))))
    extra = (("variant", variant), ("length", 4))
    ref = jsyn.Dataset(jcfg, DatasetConfig(split=split, input_h_w=(32, 48),
                                           extra=extra))[(2, 2)]
    port = psyn.Dataset(pcfg, PDatasetConfig(split=split, input_h_w=(32, 48),
                                             extra=extra))[(2, 2)]
    assert set(port) == set(ref) and port.pop("meta") == ref.pop("meta")
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    if variant == "composite":
        ref = jsyn.make_composite_batch(jcfg, H=32, W=48, batch_size=2)
        port = psyn.make_composite_batch(pcfg, H=32, W=48, batch_size=2)
        assert set(port) == set(ref)
        for k in ref:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)

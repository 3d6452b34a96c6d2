"""Guards of the port's contract: it never imports JAX or the JAX package,
its entry points never drop to the CPU on their own, its kernel wrappers
never fall back, and its own copies of the config and synthetic-data
modules equal the JAX package's."""

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
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import render as krender

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "enerf_tpu")


def test_no_jax_import_in_subprocess():
    """Build and run the model on the CPU in a fresh interpreter, then
    check that nothing of JAX, flax or enerf_tpu was imported."""
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        f"             {FORBIDDEN!r})\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_no_jax_import_in_sources():
    """No module of the package names JAX, flax or enerf_tpu in an
    import statement, lazy imports included."""
    for path in (REPO / "enerf_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        enerf_tpu_torch.build_model(dtu_eval_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        enerf_tpu_torch.build_model(dtu_eval_config(), device="cuda")
    assert enerf_tpu_torch.build_model(dtu_eval_config(), device="cpu")


def test_kernel_loader_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc_candidates", lambda: [])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in _build.KERNELS:
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.load_library(name)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize("kernel", ["cost_volume", "render"])
def test_wrappers_raise_off_cpu(kernel):
    """A tensor that is not on the CPU never takes the plain path: off a
    CUDA device the wrapper raises instead of computing. (Under no_grad: the
    render head's parameters require a gradient, which the wrapper refuses
    first, see ``tests/test_torch_depth_kernel.py``.)"""
    meta = dict(device="meta", dtype=torch.float32)
    before = (kcv.launches, krender.launches)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        if kernel == "cost_volume":
            kcv.fused_cost_volume(torch.empty(1, 3, 8, 8, 16, **meta),
                                  torch.empty(1, 3, 3, 4, **meta),
                                  torch.empty(1, 4, 8, 8, **meta))
        else:
            from enerf_tpu_torch.models.nerf_head import NeRFHead

            krender.render_rays(
                torch.empty(1, 4, 2, 3, **meta), torch.empty(1, 4, 2, 3, **meta),
                torch.empty(1, 4, 2, **meta), torch.empty(1, 3, 2, 2, 11, **meta),
                torch.empty(1, 8, 2, 2, 8, **meta), torch.empty(1, 3, 4, 4, **meta),
                torch.empty(1, 3, 3, 3, **meta), torch.empty(1, 4, 4, **meta),
                None, NeRFHead(11).to("meta"), render_scale=1.0)
    assert (kcv.launches, krender.launches) == before


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

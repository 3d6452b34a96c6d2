"""The network and the evaluator the port's config names:
``network_module`` and ``evaluator_module`` read from the YAML files as
the JAX package reads them, mapped to the port's classes by
``enerf_tpu_torch.factory``; and the human and composite eval
configurations as ``bench.py`` defines them."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from enerf_tpu.config import make_cfg as j_make_cfg
from enerf_tpu_torch import build_model
from enerf_tpu_torch.config import (
    HUMAN_MASK_FRAC,
    HUMAN_WINDOW_HW,
    Config,
    composite_eval_config,
    human_eval_config,
    human_mask,
    make_cfg,
)
from enerf_tpu_torch.eval import evaluator, evaluator_composite, evaluator_human
from enerf_tpu_torch.factory import (
    evaluator_class,
    make_evaluator,
    make_network,
    network_class,
)
from enerf_tpu_torch.models.enerf import ENeRF
from enerf_tpu_torch.models.enerf_composite import ENeRFComposite
from enerf_tpu_torch.models.enerf_human import ENeRFHuman

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("yaml,cls", [
    ("zjumocap_eval.yaml", ENeRFHuman),
    ("synthetic_smoke_human.yaml", ENeRFHuman),
    ("enerf_outdoor/actor1.yaml", ENeRFComposite),
    ("synthetic_smoke_composite.yaml", ENeRFComposite),
    ("dtu_pretrain.yaml", ENeRF),
])
def test_yaml_builds_the_named_network(yaml, cls):
    path = str(REPO / "configs" / "enerf" / yaml)
    cfg = make_cfg(path)
    assert cfg.network_module == j_make_cfg(path).network_module
    model = build_model(cfg, device="cpu")
    assert type(model) is cls


@pytest.mark.parametrize("yaml,cls", [
    ("zjumocap_eval.yaml", evaluator_human.Evaluator),
    ("zjumocap/zjumocap_train.yaml", evaluator_human.Evaluator),
    ("synthetic_smoke_human.yaml", evaluator_human.Evaluator),
    ("enerf_outdoor/actor1.yaml", evaluator_composite.Evaluator),
    ("synthetic_smoke_composite.yaml", evaluator_composite.Evaluator),
    ("dtu_pretrain.yaml", evaluator.Evaluator),
    ("dtu/scan114.yaml", evaluator.Evaluator),
    ("llff/flower.yaml", evaluator.Evaluator),
    ("nerf/lego.yaml", evaluator.Evaluator),
])
def test_yaml_makes_the_named_evaluator(yaml, cls):
    path = str(REPO / "configs" / "enerf" / yaml)
    cfg = make_cfg(path)
    assert cfg.evaluator_module == j_make_cfg(path).evaluator_module
    assert type(make_evaluator(cfg, device="cpu")) is cls


@pytest.mark.parametrize("ref,module", [
    ("lib.evaluators.enerf", "enerf_tpu.eval.evaluator"),
    ("lib.evaluators.enerf_human", "enerf_tpu.eval.evaluator_human"),
    ("lib.evaluators.enerf_composite", "enerf_tpu.eval.evaluator_composite"),
])
def test_reference_evaluator_paths_map_as_in_jax(ref, module):
    opts = ["evaluator_module", ref]
    assert (make_cfg(opts=opts).evaluator_module
            == j_make_cfg(opts=opts).evaluator_module == module)


def test_unknown_evaluator_module_raises():
    cfg = Config(evaluator_module="enerf_tpu.eval.visualizer")
    with pytest.raises(ValueError, match="enerf_tpu.eval.visualizer"):
        evaluator_class(cfg)


def test_reference_module_paths_map_as_in_jax():
    opts = ["network_module", "lib.networks.enerf.network_composite"]
    assert (make_cfg(opts=opts).network_module
            == j_make_cfg(opts=opts).network_module
            == "enerf_tpu.models.enerf_composite")


def test_unknown_network_module_raises():
    cfg = Config(network_module="enerf_tpu.models.res_unet")
    with pytest.raises(ValueError, match="enerf_tpu.models.res_unet"):
        network_class(cfg)
    with pytest.raises(ValueError, match="res_unet"):
        make_network(cfg)
    with pytest.raises(ValueError, match="res_unet"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("where", ["yaml", "command_line"])
def test_compute_dtype_other_than_float32_raises(where, tmp_path):
    """``compute_dtype``, from a YAML file or from the command line:
    ``bfloat16`` loads (the bf16 compute mode, and a network that computes
    in it), ``float32`` loads as before, and any other type raises
    ``ValueError`` naming the two."""
    base = str(REPO / "configs" / "enerf" / "dtu_pretrain.yaml")

    def load(dtype):
        if where == "command_line":
            return make_cfg(base, ["compute_dtype", dtype])
        path = tmp_path / f"{dtype}.yaml"
        path.write_text(f"parent_cfg: {base}\ncompute_dtype: {dtype}\n")
        return make_cfg(str(path))

    cfg = load("bfloat16")
    assert cfg.compute_dtype == "bfloat16"
    assert cfg == dataclasses.replace(make_cfg(base), compute_dtype="bfloat16")
    assert make_network(cfg).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        load("float16")
    assert load("float32") == make_cfg(base)
    assert make_cfg(base).compute_dtype == "float32"


def test_bench_workload_configs():
    """``human_eval_config`` / ``human_mask`` / ``composite_eval_config``
    keep bench.py's constants and mask rule (bench.py:64-65, :256-261)."""
    assert (HUMAN_MASK_FRAC, HUMAN_WINDOW_HW) == (bench.HUMAN_MASK_FRAC,
                                                  bench.HUMAN_WINDOW_HW)
    H = W = 512
    mask = np.zeros((H, W), np.float32)
    mh, mw = int(H * bench.HUMAN_MASK_FRAC[0]), int(W * bench.HUMAN_MASK_FRAC[1])
    mask[(H - mh) // 2:(H - mh) // 2 + mh, (W - mw) // 2:(W - mw) // 2 + mw] = 1
    np.testing.assert_array_equal(human_mask(H, W), mask.reshape(1, -1))
    assert 0.30 < human_mask(H, W).mean() < 0.32
    h, c = human_eval_config(), composite_eval_config()
    assert network_class(h) is ENeRFHuman
    assert network_class(c) is ENeRFComposite
    assert evaluator_class(h) is evaluator_human.Evaluator
    assert evaluator_class(c) is evaluator_composite.Evaluator
    assert (h.enerf.test_input_views, h.enerf.cas_config.volume_planes,
            h.enerf.mask_window_hw) == (2, (32, 8), (384, 224))
    assert (c.enerf.test_input_views, c.enerf.fg_bbox_hw,
            c.enerf.bg_volume_planes, c.enerf.cas_config.num_samples,
            c.enerf.viewdir_agg) == (3, (256, 192), (16, 4), (2, 1), False)

"""Config: frozen dataclasses + reference-compatible YAML loading.

Counterpart of ``enerf_tpu/config.py``, kept as the port's own copy so the
port never imports the JAX package. Same YAML schema as the reference
(``configs/enerf/*.yaml``): recursive ``parent_cfg`` merging and dotted
CLI overrides ``key.subkey value``.

The JAX package's TPU-only knobs (``fused_render``, ``fused_gather_blend``,
``fused_volume``, ``gather_bf16``, ``fused_fast_const``, ``use_pallas``,
``train_packed_render``, ``train_render_chunk``, ``debug_nans``,
``mesh_shape``, ``mesh_axes``) are not fields here: the port's kernels have
no switch, and the loader drops those keys (see ``_TPU_ONLY_KEYS``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _tup(x):
    """Recursively convert lists to tuples so dataclasses stay hashable;
    coerce numeric strings (pyyaml parses ``5e-4`` as a string)."""
    if isinstance(x, list):
        return tuple(_tup(v) for v in x)
    if isinstance(x, str):
        try:
            return int(x)
        except ValueError:
            pass
        try:
            return float(x)
        except ValueError:
            pass
    return x


@dataclass(frozen=True)
class CascadeConfig:
    """Per-level cascade hyperparameters (``cfg.enerf.cas_config``). All
    per-level vectors are tuples indexed by cascade level."""

    num: int = 2
    depth_inv: Tuple[bool, ...] = (True, False)
    volume_scale: Tuple[float, ...] = (0.125, 0.5)
    volume_planes: Tuple[int, ...] = (64, 8)
    im_feat_scale: Tuple[float, ...] = (0.25, 0.5)
    im_ibr_scale: Tuple[float, ...] = (0.25, 1.0)
    render_scale: Tuple[float, ...] = (0.25, 1.0)
    render_im_feat_level: Tuple[int, ...] = (0, 2)
    nerf_model_feat_ch: Tuple[int, ...] = (32, 8)
    render_if: Tuple[bool, ...] = (True, True)
    num_samples: Tuple[int, ...] = (8, 2)
    num_rays: Tuple[int, ...] = (4096, 32768)
    num_patchs: Tuple[int, ...] = (0, 0)
    train_img: Tuple[bool, ...] = (True, True)
    patch_size: Tuple[int, ...] = (-1, -1)
    loss_weight: Tuple[float, ...] = (0.1, 1.0)


@dataclass(frozen=True)
class ENeRFConfig:
    """The ``cfg.enerf`` block."""

    train_input_views: Tuple[int, ...] = (2, 3, 4)
    train_input_views_prob: Tuple[float, ...] = (0.1, 0.8, 0.1)
    test_input_views: int = 3
    viewdir_agg: bool = True
    chunk_size: int = 1_000_000
    white_bkgd: bool = False
    eval_depth: bool = False
    eval_center: bool = False
    sample_on_mask: bool = False
    num_fg_layers: int = 1
    # Eval rays are the FULL raster grid in raster order (the test-split
    # ray builder emits exactly that): ray bounds are a reshape, and the
    # plain vox sampling is a spatial resize + tent over the depth planes.
    grid_rays: bool = False
    bg_volume_planes: Tuple[int, ...] = (16, 4)
    fg_bbox_hw: Tuple[int, int] = (256, 256)
    mask_ray_capacity: float = 1.0
    mask_window_hw: Optional[Tuple[int, int]] = None
    cas_config: CascadeConfig = field(default_factory=CascadeConfig)

    @property
    def max_views(self) -> int:
        """Padded source-view count of a batch."""
        return max(max(self.train_input_views), self.test_input_views)


@dataclass(frozen=True)
class SchedulerConfig:
    type: str = "exponential"
    gamma: float = 0.5
    decay_epochs: int = 50
    milestones: Tuple[int, ...] = (80, 120, 200, 240)
    warmup_factor: float = 1.0 / 3
    warmup_iters: int = 5


@dataclass(frozen=True)
class DatasetConfig:
    data_root: str = "dtu"
    ann_file: str = "data/mvsnerf/dtu_train_all.txt"
    split: str = "train"
    batch_size: int = 1
    input_ratio: float = 1.0
    scene: Optional[str] = None
    input_h_w: Optional[Tuple[int, int]] = None
    frames: Tuple[int, ...] = (0, 1, 1)  # [begin, end, step]
    extra: Tuple[Tuple[str, Any], ...] = ()  # dataset-specific keys


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1
    lr: float = 5e-4
    weight_decay: float = 0.0
    eps: float = 1e-8
    epoch: int = 300
    optim: str = "adam"
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    num_workers: int = 4
    grad_clip_value: float = 40.0
    input_views_num: Tuple[int, ...] = (2, 3, 4)
    input_views_prob: Tuple[float, ...] = (0.1, 0.8, 0.1)


@dataclass(frozen=True)
class Config:
    """Root config; mirrors the reference's top-level cfg keys."""

    task: str = "enerf"
    exp_name: str = "dtu_pretrain"
    exp_name_tag: str = ""
    save_tag: str = "default"
    gpus: Tuple[int, ...] = (0,)
    workspace: str = ""
    # the network class, named by the JAX package's module path as the YAML
    # files carry it; ``factory.make_network`` maps it to the port's class
    network_module: str = "enerf_tpu.models.enerf"
    # the evaluator, named the same way; ``factory.make_evaluator`` maps it
    evaluator_module: str = "enerf_tpu.eval.evaluator"

    enerf: ENeRFConfig = field(default_factory=ENeRFConfig)
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    test_dataset: DatasetConfig = field(
        default_factory=lambda: DatasetConfig(
            ann_file="data/mvsnerf/dtu_val_all.txt", split="test"))
    train: TrainConfig = field(default_factory=TrainConfig)

    save_result: bool = False
    eval_lpips: bool = True
    fix_random: bool = False
    resume: bool = True
    pretrain: str = ""
    ep_iter: int = 1000
    save_ep: int = 5
    eval_ep: int = 5
    save_latest_ep: int = 1
    log_interval: int = 1
    record_interval: int = 20
    fps: int = 24

    @property
    def trained_model_dir(self) -> str:
        return os.path.join(self.workspace, "trained_model", self.task,
                            self.exp_name)

    @property
    def record_dir(self) -> str:
        return os.path.join(self.workspace, "record", self.task, self.exp_name)

    @property
    def result_dir(self) -> str:
        return os.path.join(self.workspace, "result", self.task,
                            self.exp_name, self.save_tag)


# ---------------------------------------------------------------------------
# YAML loading (reference-compatible)
# ---------------------------------------------------------------------------

# Keys of the JAX package's config that tune its TPU kernels and mesh. The
# port runs its CUDA kernels unconditionally on the card and has no mesh in
# this slice, so a YAML that sets them (written for either package) loads
# with them dropped rather than failing.
_TPU_ONLY_KEYS = {
    "fused_render", "fused_gather_blend", "fused_volume", "gather_bf16",
    "fused_fast_const", "use_pallas", "train_packed_render",
    "train_render_chunk", "debug_nans", "mesh_shape", "mesh_axes",
    "bn_update_every",
}


def _deep_merge(base: Dict, new: Dict) -> Dict:
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_tree(path: str) -> Dict:
    """Load a YAML file, recursively merging ``parent_cfg`` chains."""
    import yaml  # only the YAML path needs PyYAML

    with open(path) as f:
        cur = yaml.safe_load(f) or {}
    if "parent_cfg" in cur:
        parent_path = cur["parent_cfg"]
        if not os.path.isabs(parent_path) and not os.path.exists(parent_path):
            cand = os.path.join(os.path.dirname(path), parent_path)
            if os.path.exists(cand):
                parent_path = cand
        parent = load_yaml_tree(parent_path)
        cur = {k: v for k, v in cur.items() if k != "parent_cfg"}
        return _deep_merge(parent, cur)
    return cur


def _coerce(value: str) -> Any:
    """Parse a CLI override string: ``ast.literal_eval`` so ``False,True``
    and ``48,8`` become tuples (yacs semantics), else YAML, else the raw
    string."""
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    import yaml

    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def apply_opts(tree: Dict, opts: List[str]) -> Dict:
    """Apply ``key.subkey value`` CLI override pairs."""
    out = dict(tree)
    if "other_opts" in opts:
        opts = opts[: opts.index("other_opts")]
    assert len(opts) % 2 == 0, f"opts must be key/value pairs, got {opts}"
    for key, raw in zip(opts[0::2], opts[1::2]):
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
            node[p] = dict(nxt)
            node = node[p]
        node[parts[-1]] = _coerce(raw)
    return out


_DC_FIELDS = {
    cls: {f.name: f for f in fields(cls)}
    for cls in (Config, ENeRFConfig, CascadeConfig, TrainConfig,
                SchedulerConfig, DatasetConfig)
}

_NESTED = {
    "enerf": ENeRFConfig,
    "cas_config": CascadeConfig,
    "train": TrainConfig,
    "scheduler": SchedulerConfig,
    "train_dataset": DatasetConfig,
    "test_dataset": DatasetConfig,
}


def _build_dataclass(cls, tree: Dict):
    known = _DC_FIELDS[cls]
    kwargs = {}
    extra = []
    for k, v in tree.items():
        if k in _TPU_ONLY_KEYS:
            continue
        if k in _NESTED and k in known:
            kwargs[k] = _build_dataclass(_NESTED[k],
                                         v if isinstance(v, dict) else {})
        elif k in known:
            kwargs[k] = _tup(v)
        elif cls is DatasetConfig:
            extra.append((k, _tup(v)))
        elif cls is TrainConfig and k == "sampler_meta" and isinstance(v, dict):
            if "input_views_num" in v:
                kwargs["input_views_num"] = _tup(v["input_views_num"])
            if "input_views_prob" in v:
                kwargs["input_views_prob"] = _tup(v["input_views_prob"])
        # other unknown keys are ignored, as yacs tolerated extra keys
    if cls is DatasetConfig and extra:
        kwargs["extra"] = tuple(extra)
    return cls(**kwargs)


def make_cfg(cfg_file: Optional[str] = None, opts: Optional[List[str]] = None,
             workspace: Optional[str] = None) -> Config:
    """Build a Config from a YAML file + CLI overrides."""
    tree: Dict = {}
    if cfg_file:
        tree = load_yaml_tree(cfg_file)
    if opts:
        tree = apply_opts(tree, list(opts))
    if workspace is not None:
        tree["workspace"] = workspace
    elif "workspace" not in tree:
        tree["workspace"] = os.environ.get("workspace", ".")
    exp_name = tree.get("exp_name", Config.exp_name)
    if tree.get("exp_name_tag"):
        exp_name += "_" + str(tree["exp_name_tag"])
    tree["exp_name"] = exp_name
    # the reference's actor1.yaml puts num_fg_layers at top level; it
    # belongs to the enerf block
    if "num_fg_layers" in tree:
        enerf_tree = dict(tree.get("enerf", {}))
        enerf_tree["num_fg_layers"] = tree.pop("num_fg_layers")
        tree["enerf"] = enerf_tree
    # the reference's module paths name the networks and evaluators as the
    # JAX package's make_cfg maps them (enerf_tpu/config.py:446-449,
    # :462-468)
    for key in ("network_module", "evaluator_module"):
        name = tree.get(key)
        if isinstance(name, str) and name in _REFERENCE_MODULES:
            tree[key] = _REFERENCE_MODULES[name]
    return _build_dataclass(Config, tree)


_REFERENCE_MODULES = {
    "lib.networks.enerf.network": "enerf_tpu.models.enerf",
    "lib.networks.enerf.network_human": "enerf_tpu.models.enerf_human",
    "lib.networks.enerf.network_composite": "enerf_tpu.models.enerf_composite",
    "lib.evaluators.enerf": "enerf_tpu.eval.evaluator",
    "lib.evaluators.enerf_human": "enerf_tpu.eval.evaluator_human",
    "lib.evaluators.enerf_composite": "enerf_tpu.eval.evaluator_composite",
}


def dtu_eval_config() -> Config:
    """The DTU eval render configuration (``bench.py:run_dtu``): 3 source
    views, a two-level cascade with ``volume_planes (48, 8)`` rendering
    level 1 only, grid rays."""
    return Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True,
        cas_config=CascadeConfig(num=2, volume_planes=(48, 8),
                                 render_if=(False, True))))


# The human workload of ``bench.py:run_human`` (bench.py:64-65): the mask is
# a centered 0.74H x 0.42W box (31% of a 512x512 frame, a standing human at
# ZJU-MoCap framing), the window (384, 224) its 16-snapped static cover.
HUMAN_MASK_FRAC = (0.74, 0.42)
HUMAN_WINDOW_HW = (384, 224)


def human_eval_config() -> Config:
    """The ZJU-MoCap-shaped human render configuration (``bench.py:
    run_human``, bench.py:215-279): ``ENeRFHuman``, 2 source views,
    ``volume_planes (32, 8)``, level 1 rendered on grid rays inside the
    static ``HUMAN_WINDOW_HW`` window of the mask ``human_mask``."""
    return Config(
        network_module="enerf_tpu.models.enerf_human",
        evaluator_module="enerf_tpu.eval.evaluator_human",
        enerf=ENeRFConfig(
            test_input_views=2, train_input_views=(2,), grid_rays=True,
            mask_window_hw=HUMAN_WINDOW_HW,
            cas_config=CascadeConfig(num=2, volume_planes=(32, 8),
                                     render_if=(False, True))))


def human_mask(H: int, W: int) -> np.ndarray:
    """``bench.py:run_human``'s ``mask_at_box`` (bench.py:256-261): a
    centered ``HUMAN_MASK_FRAC`` box, (1, H * W) float32."""
    mask = np.zeros((H, W), np.float32)
    mh, mw = int(H * HUMAN_MASK_FRAC[0]), int(W * HUMAN_MASK_FRAC[1])
    y0, x0 = (H - mh) // 2, (W - mw) // 2
    mask[y0:y0 + mh, x0:x0 + mw] = 1.0
    return mask.reshape(1, -1)


def composite_eval_config() -> Config:
    """The ENeRF-Outdoor-shaped composite render configuration
    (``bench.py:run_composite``, bench.py:281-330): ``ENeRFComposite``, 3
    source views, 1 fg layer in a static (256, 192) window,
    ``bg_volume_planes (16, 4)``, ``volume_planes (32, 8)``,
    ``num_samples (2, 1)``, level 1 rendered, no view-direction
    aggregation."""
    return Config(
        network_module="enerf_tpu.models.enerf_composite",
        evaluator_module="enerf_tpu.eval.evaluator_composite",
        enerf=ENeRFConfig(
            test_input_views=3, train_input_views=(2, 3), viewdir_agg=False,
            num_fg_layers=1, fg_bbox_hw=(256, 192), bg_volume_planes=(16, 4),
            cas_config=CascadeConfig(num=2, volume_planes=(32, 8),
                                     num_samples=(2, 1),
                                     render_if=(False, True))))


def asdict(cfg) -> Dict:
    return dataclasses.asdict(cfg)


__all__ = [
    "CascadeConfig", "ENeRFConfig", "TrainConfig", "SchedulerConfig",
    "DatasetConfig", "Config", "make_cfg", "load_yaml_tree", "apply_opts",
    "dtu_eval_config", "human_eval_config", "human_mask",
    "composite_eval_config", "HUMAN_MASK_FRAC", "HUMAN_WINDOW_HW", "replace",
    "asdict",
]

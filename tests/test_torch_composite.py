"""The port's composite (ENeRF-Outdoor) model vs ``enerf_tpu``'s
``ENeRFComposite`` on the CPU, and its parts: the crop-window cost volume
(``cost_volume_plain`` in crop mode vs ``build_cost_volume_crop``) and
the converter on the composite's module names (the ``use_vox_feat=False``
head is a case of ``tests/test_torch_modules.py::test_nerf_head``).

The model cases follow ``tests/test_composite.py``: 64×64, 2 source views,
1 and 2 fg layers in (32, 32) windows, both levels rendered, with seeded
weights in the JAX model's variables tree carried across by the port's
converter; then
windows that cross the frame's edges (right and bottom; a negative
origin). Tolerance as ``tests/test_torch_enerf.py``: rtol 1e-3, atol 3e-4
on rgb and weights, 3e-3 on depth."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu.datasets.synthetic import make_composite_batch
from enerf_tpu.models.enerf_composite import ENeRFComposite as JComposite
from enerf_tpu.ops.warp import build_cost_volume_crop
from enerf_tpu_torch import build_model, render
from enerf_tpu_torch.ops.kernels.cost_volume import cost_volume_plain
from enerf_tpu_torch.utils.convert import flax_state_dict, load_flax_variables
from tests.test_torch_modules import seeded_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

H = W = 64
RTOL = 1e-3
ATOL = {"rgb": 3e-4, "weights": 3e-4, "depth": 3e-3}


def _jcfg(L):
    return Config(enerf=ENeRFConfig(
        test_input_views=2, train_input_views=(2,), viewdir_agg=False,
        num_fg_layers=L, fg_bbox_hw=(32, 32), bg_volume_planes=(16, 4),
        cas_config=CascadeConfig(num=2, volume_planes=(16, 8),
                                 num_samples=(2, 1), render_if=(True, True))))


def _port_cfg(jcfg):
    """The port's Config of the same fields (the JAX Config has more)."""
    from enerf_tpu_torch.config import CascadeConfig as PCas
    from enerf_tpu_torch.config import Config as PConfig
    from enerf_tpu_torch.config import ENeRFConfig as PENeRF

    e = jcfg.enerf
    names = {f.name for f in dataclasses.fields(PENeRF)} - {"cas_config"}
    return PConfig(network_module="enerf_tpu.models.enerf_composite",
                   enerf=PENeRF(**{k: getattr(e, k) for k in names},
                                cas_config=PCas(**dataclasses.asdict(
                                    e.cas_config))))


# XLA's CPU backend without its slow optimization passes: compiles the
# model in ~2/3 of the time, runs it no slower at this size
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", params=[1, 2])
def composite(request):
    """Per fg-layer count: the JAX model compiled once, its variables
    (seeded, in the JAX model's tree) and the port model carrying them."""
    L = request.param
    jcfg = _jcfg(L)
    batch = make_composite_batch(jcfg, H=H, W=W)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JComposite(cfg=jcfg.enerf, train_mode=False)
    variables = seeded_variables(jmodel, np.random.RandomState(L), jb)
    apply = jax.jit(jmodel.apply).lower(variables, jb).compile(
        compiler_options=FAST_COMPILE)
    model = load_flax_variables(build_model(_port_cfg(jcfg), device="cpu"),
                                variables)
    return L, batch, apply, variables, model


# (x, y) of each fg layer's window at full resolution: centered; across the
# right and bottom edges; a negative origin (truncated toward 0 at each
# scale) and one across the right edge
BBOXES = {"centered": None, "edge": [(44, 40), (40, 44)],
          "negative": [(-12, 20), (50, -4)]}


@pytest.mark.parametrize("where", list(BBOXES))
def test_composite_matches_jax(composite, where):
    L, batch, apply, variables, model = composite
    batch = dict(batch)
    if BBOXES[where] is not None:
        bbox = batch["bbox"].copy()
        bbox[0, :, :2] = BBOXES[where][:L]
        batch["bbox"] = bbox
    ref = apply(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    out = render(model, batch)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL[k.split("_")[0]],
                                   err_msg=k)
    # the fg samples take weight inside their windows only
    if where == "centered":
        w = out["weights_level1"][0].numpy()
        assert np.all(w[:, :L].sum(-1).reshape(H, W)[:16] == 0.0)


@pytest.mark.parametrize("origins,hw", [
    ([(3, 2), (0, 0)], (8, 6)),        # inside the frame, B = 2
    ([(12, 9), (13, 1)], (8, 6)),      # across the right / bottom edge
    ([(-2, 4), (5, -3)], (7, 5)),      # negative origins, a ragged window
])
def test_crop_cost_volume_matches_jax(origins, hw):
    """The crop volume's edge rule: depth planes from the clamped window,
    warp coordinates from the unclamped origin."""
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.config import dtu_eval_config
    from enerf_tpu_torch.ops.camera import get_proj_mats

    rng = np.random.RandomState(7)
    b = make_synthetic_batch(dtu_eval_config(), H=64, W=80, n_src=2,
                             batch_size=2)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    projs = get_proj_mats(tb["src_exts"], tb["src_ixts"], tb["tar_ext"],
                          tb["tar_ixt"], src_scale=0.25, tar_scale=0.25)
    feats = rng.randn(2, 3, 16, 20, 16).astype(np.float32)
    depth = (3.0 + rng.rand(2, 8, 16, 20)).astype(np.float32)
    xy0 = np.array(origins, np.int32)
    ref = jax.jit(build_cost_volume_crop, static_argnums=4)(
        jnp.asarray(feats), jnp.asarray(projs.numpy()), jnp.asarray(depth),
        jnp.asarray(xy0), hw, jnp.asarray(b["view_mask"]))
    out = cost_volume_plain(torch.from_numpy(feats), projs,
                            torch.from_numpy(depth), tb["view_mask"],
                            window=(torch.from_numpy(xy0), hw))
    assert out.shape == (2, 8) + hw + (16,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_converter_maps_composite_names(composite):
    """Every JAX leaf of the composite lands on the port parameter of the
    same name and shape, and every port entry is covered."""
    L, _, _, variables, model = composite
    sd = flax_state_dict(variables)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert {k: v.shape for k, v in sd.items()} == own
    tops = {k.split(".")[0] for k in sd}
    assert tops == {"feature_net", "feature_net_bg"} | {
        f"{kind}_{i}_{name}" for kind in ("cost_reg", "nerf")
        for i in range(2) for name in [f"layer{l}" for l in range(L)] + ["bg"]}

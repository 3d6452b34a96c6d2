"""The bf16 compute mode (``compute_dtype: bfloat16``) of the port vs the
JAX package's ``dtype=jnp.bfloat16`` on the CPU, the JAX side with its
fused flags off and its weights carried across by
``utils/convert.py:load_flax_variables``.

Every JAX program here is compiled with ``xla_allow_excess_precision``
off: with it on (XLA's default), XLA's CPU backend computes the bf16 ops
in f32 and drops the f32 → bf16 → f32 round trips between them, so the
"bf16" train forward rounds almost nowhere (its loss was within 4e-6 of
the f32 loss at this file's train case; 5.5e-3 with the flag off).

The reference is JAX in bf16 at its TPU kernels' arithmetic
(``kernel_arithmetic``). The port's kernels compute as the JAX package's
TPU kernels do: K1 (``fused_corner_variance``) reads bf16 features,
accumulates in f32 and rounds once; K4 computes in f32
(``reductions.py:49-53``); K2 (``fused_render_rays``) reads the head's f32
weights (``render.py:576``). The JAX jnp path rounds more: its variance,
its depth softmax and, in eval, its IBR head run in bf16. So the reference
runs those stages (``build_cost_volume`` / ``build_cost_volume_crop``,
``depth_regression``, the eval head) by the JAX package's own functions on
f32 inputs, rounding once where the TPU kernel rounds. It keeps one
rounding that the port drops: both JAX grid paths resize the bf16 volume
by two bf16 products before the depth tent, while the port's K2 samples
the un-resized volume trilinearly in f32 (there is no resized volume to
round). Each output of the port is held within half (``HALF_GAP``) of
JAX's own bf16-vs-f32 gap: its bf16 mode as it runs on the CPU (the jnp
path) against f32 (the composite: of the reference's own gap to f32,
tighter). Most of that gap is the jnp path's extra rounding,
which the port does not do, so the port's distance to the jnp path is
about that gap (the DTU case holds it within ``JNP_GAP_FACTOR`` times it).

In training, BN adds one more rule: flax's BN computes its batch variance
as E[x²] − E[x]², torch's (the port's) as E[(x − E[x])²]. The two differ
in the last f32 bits, and the bf16 roundings after every BN multiply such
a difference through the convs until the two bf16 steps sit about as far
apart as bf16 and f32 do. On the BN running statistics (the largest
error, in units of JAX's own bf16-vs-f32 distance, at three seeds), JAX's
bf16 step with only its variance computed in two passes sits 0.93, 1.62
and 0.38 from its default bf16 step, and the port 0.80, 1.62 and 0.28. So
the train step's reference computes the variance in two passes (flax's
``use_fast_variance=False``, ``two_pass_bn``).

Tests: the DTU eval forward (3 views, then 2 real + 1 padded), the human
window mode and the composite forward, one bf16 train step, and the
bf16 inputs of the K1, K4 and render-stage plain versions.
"""

import contextlib
import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enerf_tpu.models.enerf as jenerf
import enerf_tpu.models.enerf_composite as jcomposite
from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig, TrainConfig
from enerf_tpu.datasets.synthetic import (
    make_composite_batch,
    make_synthetic_batch,
)
from enerf_tpu.models.enerf import ENeRF as JENeRF
from enerf_tpu.models.enerf_composite import ENeRFComposite as JComposite
from enerf_tpu.models.enerf_human import ENeRFHuman as JHuman
from enerf_tpu.models.nerf_head import NeRFHead as JNeRFHead
from enerf_tpu.ops.depth import depth_regression as j_depth_regression
from enerf_tpu.ops.warp import build_cost_volume as j_build_cost_volume
from enerf_tpu.train.loss import compute_loss as j_compute_loss
from enerf_tpu.train.state import create_train_state as j_create_train_state
from enerf_tpu_torch import build_model, render
from enerf_tpu_torch import config as pc
from enerf_tpu_torch.config import dtu_eval_config, human_mask
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.ops.camera import get_proj_mats
from enerf_tpu_torch.ops.kernels.cost_volume import cost_volume_plain
from enerf_tpu_torch.ops.kernels.depth_regression import (
    depth_regression_plain,
)
from enerf_tpu_torch.ops.kernels.render import render_rays_plain
from enerf_tpu_torch.train import create_train_state, make_train_step
from enerf_tpu_torch.utils.convert import (
    flax_leaves_by_param,
    flax_state_dict,
    load_flax_variables,
)
from tests.test_torch_composite import _jcfg as composite_jcfg
from tests.test_torch_composite import _port_cfg as composite_port_cfg
from tests.test_torch_modules import randomize_batch_stats, to_numpy_tree
from tests.test_torch_render import H as RH
from tests.test_torch_render import W as RW
from tests.test_torch_render import _jax_render, _port_args, _stage_inputs
from tests.test_torch_train_step import seeded_variables as step_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

BF16 = jnp.bfloat16
F32 = jnp.float32
COMPILE = {"xla_backend_optimization_level": 0,
           "xla_allow_excess_precision": False}
HALF_GAP = 0.5
# the DTU case vs the kernel-arithmetic reference (about 3x the largest
# error measured at its two cases: 9.1e-5, 9.4e-5, 3.4e-5, 1.9e-4, 1.4e-4)
ATOL = {"depth": 3e-4, "depth_mvs": 3e-4, "std": 1e-4, "rgb": 6e-4,
        "weights": 4e-4}
# the DTU case vs the jnp path, in units of that path's gap to f32
JNP_GAP_FACTOR = 1.1


def jit_compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` with ``COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE)


@contextlib.contextmanager
def kernel_arithmetic(module):
    """The JAX model module's K1, K4 and eval head as the TPU kernels
    compute them in the bf16 mode, while the context lasts: the JAX
    package's own functions on f32 inputs, each K1 volume rounded once to
    the features' type."""
    mp = pytest.MonkeyPatch()

    def wrap_volume(name):
        fn = getattr(module, name)
        mp.setattr(module, name, lambda feats, *a, **k: fn(
            feats.astype(F32), *a, **k).astype(feats.dtype))

    wrap_volume("build_cost_volume")
    if module is jcomposite:
        wrap_volume("build_cost_volume_crop")
    dr = module.depth_regression
    mp.setattr(module, "depth_regression",
               lambda l, v, inv, use_pallas=False: dr(l.astype(F32), v, inv))
    if module is jenerf:
        mp.setattr(module, "NeRFHead",
                   lambda **kw: JNeRFHead(**{**kw, "dtype": F32}))
    try:
        yield
    finally:
        mp.undo()


@contextlib.contextmanager
def two_pass_bn():
    """Flax's BN computing its batch variance in two passes,
    E[(x − E[x])²], as torch's BN (the port's) does, while the context
    lasts (flax's ``use_fast_variance=False``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "BatchNorm", functools.partial(
        flax.linen.BatchNorm, use_fast_variance=False))
    try:
        yield
    finally:
        mp.undo()


def init_variables(model, rng, jb):
    """``model``'s variables (shapes by ``jax.eval_shape``, nothing
    compiled) at the reference's initial scale: kernels U(±1/√fan_in),
    biases 0.05 N(0, 1), BN scales 1 + 0.1 N(0, 1), random BN running
    statistics (``randomize_batch_stats``). A numpy tree."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jb)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            b = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            v = rng.uniform(-b, b, leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    variables = to_numpy_tree(jax.tree_util.tree_map_with_path(fill, shapes))
    return randomize_batch_stats(variables, rng)


def jax_forwards(jcls, jcfg, module, variables, jb, jnp_path=True,
                 f32=True):
    """The JAX eval forward in bf16 at the kernels' arithmetic and, with
    ``jnp_path``, in bf16 on the jnp path and, with ``f32``, in f32, each
    compiled."""
    m16 = jcls(cfg=jcfg.enerf, train_mode=False, dtype=BF16)
    with kernel_arithmetic(module):
        out = [jit_compiled(m16.apply, variables, jb)]
    if jnp_path:
        out.append(jit_compiled(m16.apply, variables, jb))
    if f32:
        m32 = jcls(cfg=jcfg.enerf, train_mode=False)
        out.append(jit_compiled(m32.apply, variables, jb))
    return out


def port_models(cfg, variables):
    """The port's f32 and bf16 models of ``cfg`` (eval) with
    ``variables``."""
    return [load_flax_variables(build_model(dataclasses.replace(
        cfg, compute_dtype=d), device="cpu"), variables)
        for d in ("float32", "bfloat16")]


def check_forward(out16, out32, jk, j16, j32, what, dtu=False):
    """The port's bf16 outputs ``out16`` vs the kernel-arithmetic
    reference ``jk``: within ``HALF_GAP`` of the jnp path ``j16``'s gap to
    the f32 forward ``j32`` (the DTU case also within ``ATOL``, and its
    distance to the jnp path within ``JNP_GAP_FACTOR`` of that gap); the
    outputs are float32, and differ from the port's f32 ones ``out32``."""
    jk, j16, j32 = ({k: np.asarray(v, np.float32) for k, v in r.items()}
                    for r in (jk, j16, j32))
    assert set(out16) == set(j32) == set(jk) == set(j16)
    for k in sorted(out16):
        assert out16[k].dtype == torch.float32, k
        o = out16[k].numpy()
        gap = np.abs(j16[k] - j32[k]).max()
        err = np.abs(o - jk[k]).max()
        assert err <= HALF_GAP * gap, (what, k, err, gap)
        assert np.abs(o - out32[k].numpy()).max() > 0, (what, k)
        if dtu:
            assert err <= ATOL[k.rsplit("_level", 1)[0]], (what, k, err)
            assert np.abs(o - j16[k]).max() <= JNP_GAP_FACTOR * gap, (
                what, k, np.abs(o - j16[k]).max(), gap)


# --- 1. the DTU eval forward ----------------------------------------------

def test_dtu_eval_forward_bf16():
    """``tests/test_torch_enerf.py``'s configuration at 64x96: 3 real
    views, then 2 real + 1 padded (one compile for both)."""
    jcfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True,
        cas_config=CascadeConfig(num=2, volume_planes=(48, 8),
                                 render_if=(False, True))))
    applies = None
    for n_src in (3, 2):
        batch = make_synthetic_batch(jcfg, H=64, W=96, n_src=n_src)
        batch.pop("tar_img")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        v = init_variables(JENeRF(cfg=jcfg.enerf, train_mode=False),
                           np.random.RandomState(n_src), jb)
        if applies is None:
            applies = jax_forwards(JENeRF, jcfg, jenerf, v, jb)
        jk, jn, j32 = (apply(v, jb) for apply in applies)
        m32, m16 = port_models(pc.Config(enerf=dtu_eval_config().enerf), v)
        check_forward(render(m16, batch), render(m32, batch), jk, jn, j32,
                      f"dtu n_src={n_src}", dtu=True)


# --- 2. the human window mode and the composite ----------------------------

def _human_case():
    """``tests/test_torch_human.py``'s 64x96 window case."""
    cas = dict(num=2, volume_planes=(8, 8), render_if=(False, True))
    kw = dict(test_input_views=2, train_input_views=(2,), grid_rays=True,
              mask_window_hw=(64, 64))
    jcfg = Config(enerf=ENeRFConfig(cas_config=CascadeConfig(**cas), **kw))
    pcfg = pc.Config(network_module="enerf_tpu.models.enerf_human",
                     enerf=pc.ENeRFConfig(cas_config=pc.CascadeConfig(**cas),
                                          **kw))
    batch = make_synthetic_batch(jcfg, H=64, W=96)
    batch["mask_at_box"] = human_mask(64, 96)
    return jcfg, pcfg, batch, JHuman, jenerf


def _composite_case():
    """``tests/test_torch_composite.py``'s 64x64 case, 1 fg layer."""
    jcfg = composite_jcfg(1)
    return (jcfg, composite_port_cfg(jcfg), make_composite_batch(
        jcfg, H=64, W=64), JComposite, jcomposite)


@pytest.mark.parametrize("variant", ["human_window", "composite"])
def test_variant_eval_forward_bf16(variant):
    jcfg, pcfg, batch, jcls, module = (
        _human_case() if variant == "human_window" else _composite_case())
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = init_variables(jcls(cfg=jcfg.enerf, train_mode=False),
                               np.random.RandomState(5), jb)
    # the yardstick: the human window's grid render is held within half of
    # JAX's own gap (the jnp path's), as the port's K2 drops the rounding
    # of the volume's resize (measured 0.11 of it; 0.86 of the reference's
    # own gap to f32); the composite, which has no grid resize, within
    # half of the reference's own gap to f32, 40 times tighter (rgb) and
    # one JAX compile fewer. The f32 side: the port's f32 forward, which
    # tests/test_torch_human.py and tests/test_torch_composite.py hold to
    # JAX's
    applies = jax_forwards(jcls, jcfg, module, variables, jb,
                           jnp_path=variant == "human_window", f32=False)
    jk = applies[0](variables, jb)
    jn = applies[1](variables, jb) if len(applies) > 1 else jk
    p32, p16 = port_models(pcfg, variables)
    out16, out32 = render(p16, batch), render(p32, batch)
    check_forward(out16, out32, jk, jn, out32, variant)
    if variant == "human_window":
        outside = batch["mask_at_box"][0] == 0
        assert np.all(out16["rgb_level1"][0].numpy()[outside] == 0.0)


# --- 3. one train step -----------------------------------------------------

H = W = 32
LR = 1e-3


def _train_cfgs(dtype):
    cas = dict(num=2, volume_planes=(16, 8), train_img=(True, True))
    kw = dict(test_input_views=2, train_input_views=(2,), grid_rays=True)
    jcfg = Config(enerf=ENeRFConfig(
        train_render_chunk=0, cas_config=CascadeConfig(**cas), **kw),
        train=TrainConfig(lr=LR), ep_iter=10, compute_dtype=dtype)
    pcfg = pc.Config(enerf=pc.ENeRFConfig(
        cas_config=pc.CascadeConfig(**cas), **kw),
        train=pc.TrainConfig(lr=LR), ep_iter=10, compute_dtype=dtype)
    return jcfg, pcfg


def _jax_step(jcfg, variables, jb):
    """``enerf_tpu/train/step.py:make_train_step``'s step written out: the
    stats, gradients, new parameters and mutated BN statistics; compiled,
    numpy outputs."""
    model = JENeRF(cfg=jcfg.enerf, train_mode=True, dtype=BF16)

    def run(variables, batch):
        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, mutable=["batch_stats"])
            loss, stats = j_compute_loss(out, batch, jcfg.enerf, (H, W), None)
            return loss, (stats, mut["batch_stats"])

        grads, (stats, bs) = jax.grad(loss_fn, has_aux=True)(
            variables["params"])
        state = j_create_train_state(jcfg, variables).apply_gradients(
            grads=grads)
        return stats, grads, state.params, bs

    out = jit_compiled(run, variables, jb)(variables, jb)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_step(pcfg, variables, batch):
    """One port step of ``pcfg``: (model after it, its stats, and each
    BN's elements per channel)."""
    model = load_flax_variables(build_model(pcfg, device="cpu", train=True),
                                variables)
    n_per_channel = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_hook(
                lambda mod, inp, o, name=name: n_per_channel.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    _, stats = make_train_step(pcfg, (H, W))(create_train_state(pcfg, model),
                                             batch)
    return model, stats, n_per_channel


def _cos(a, b):
    a, b = a.ravel(), b.ravel()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _step_distances(model, stats, n_per_channel, ref, old_bs):
    """A port step's distances to the JAX step ``ref`` (stats, gradients,
    parameters after the step, BN statistics): the loss's, the worst and
    the median over the parameters of 1 − the gradient's cosine, the
    largest gradient error, the share of parameter entries more than
    0.1·lr off after the Adam step, the largest BN running-statistic
    error. The color logits' bias is left out of the gradients: it has
    none (the softmax over views cancels it) but for rounding; JAX's
    gradients take the step's clip by value."""
    jstats, jgrads, jparams, jbs = ref
    grads = flax_leaves_by_param(model, jgrads)
    after = flax_leaves_by_param(model, jparams)
    cos, gerr, moved = [], 0.0, []
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        moved.append(np.abs(p.detach().numpy() - after[k]).ravel())
        if k.endswith("color.2.bias"):
            continue
        g = np.clip(grads[k], -40.0, 40.0)
        cos.append(_cos(p.grad.numpy(), g))
        gerr = max(gerr, float(np.abs(p.grad.numpy() - g).max()))
    moved = np.concatenate(moved)
    assert moved.max() <= 2 * LR + 1e-6, moved.max()

    # flax updates the running variance with the biased batch variance,
    # torch with the unbiased: flax's batch term is scaled by n/(n-1)
    old = flax_state_dict({"batch_stats": old_bs})
    new = flax_state_dict({"batch_stats": jbs})
    buffers = dict(model.named_buffers())
    keys = [k for k in old if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * len(n_per_channel)
    bn = 0.0
    for k in keys:
        want = new[k]
        if k.endswith("running_var"):
            n = n_per_channel[k.rsplit(".", 1)[0]]
            want = 0.9 * old[k] + (want - 0.9 * old[k]) * n / (n - 1)
        bn = max(bn, float(np.abs(buffers[k].numpy() - want).max()))
    return {"loss": abs(float(stats["loss"]) - float(jstats["loss"])),
            "worst 1 - grad cos": 1.0 - min(cos),
            "median 1 - grad cos": 1.0 - float(np.median(cos)),
            "grad max err": gerr,
            "adam share > 0.1 lr": float(np.mean(moved > 0.1 * LR)),
            "bn max err": bn}


def test_train_step_bf16():
    """One bf16 step at ``tests/test_torch_train_step.py``'s size (grid
    rays, 32x32) vs the JAX bf16 step at the kernels' arithmetic with the
    variance of its BNs in two passes (``two_pass_bn``): the loss, the
    gradients (their worst and median cosine over the parameters, their
    largest error), the parameters after one Adam step (the share of
    entries more than 0.1·lr off; Adam's first step moves each by about
    lr) and the BN running statistics after the step's forward, each
    within half of the same distance of the port's f32 step, which
    ``tests/test_torch_train_step.py`` holds to JAX's f32 step at rtol 1e-5
    (measured at 1 and at 8 torch threads: 0.014 / 0.027, 0.41 / 0.41,
    0.056 / 0.044, 0.18 / 0.16, 0.32 / 0.27 and 0.48 / 0.45 of it).
    Parameters, gradients, the loss and the optimizer stay f32."""
    jcfg, pcfg = _train_cfgs("bfloat16")
    _, pcfg32 = _train_cfgs("float32")
    batch = make_synthetic_batch(jcfg, H=H, W=W, split="train", seed=1)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = step_variables(JENeRF(cfg=jcfg.enerf, train_mode=True), jb,
                               np.random.RandomState(0))
    with kernel_arithmetic(jenerf), two_pass_bn():
        ref = _jax_step(jcfg, variables, jb)
    model, pstats, n_per_channel = _port_step(pcfg, variables, batch)
    model32, pstats32, _ = _port_step(pcfg32, variables, batch)
    assert model.dtype == torch.bfloat16
    assert set(pstats) == set(ref[0])
    assert pstats["loss"].dtype == torch.float32

    d16, d32 = (_step_distances(m, st, n_per_channel, ref,
                                variables["batch_stats"])
                for m, st in ((model, pstats), (model32, pstats32)))
    for k in d16:
        assert d16[k] <= HALF_GAP * d32[k], (k, d16[k], d32[k])


# --- 4. the kernels' plain versions on bf16 inputs -------------------------

# K1 on bf16 features vs JAX on the same values in f32, rounded once to
# bf16: one bf16 ulp (at most 2^-7 of the value) beside the f32 atol of
# chip_smoke.py's K1_TOL (grid_sample's normalized coordinates move a
# sample by ~3e-5 px)
K1_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
# vs the jnp path in bf16, whose Σf²/n − (Σf/n)² cancels in bf16: within
# 2^-6 of the largest mean square (a few of its ulps)
K1_JNP_ULPS = 2.0 ** -6
# K4 (bf16 logits, f32 values, f32 out) vs JAX on the logits in f32
K4_TOL = dict(rtol=1e-5, atol=1e-6)
# vs the jnp path, whose softmax rounds each probability to bf16: within
# 2^-7 of the largest plane value (disparity or depth)
K4_JNP_SHARE = 2.0 ** -7
# the render stage with a bf16 volume vs JAX on its values in f32 (f32 on
# both sides: tests/test_torch_render.py's tolerance)
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
# vs JAX reading the bf16 volume as its TPU path does (the resized volume
# rounded to bf16 by the resize's two products)
RENDER_JNP_TOL = dict(rtol=1e-2, atol=2e-3)


def test_kernels_plain_bf16():
    rng = np.random.RandomState(11)
    b = make_synthetic_batch(dtu_eval_config(), H=64, W=80, n_src=2)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    projs = get_proj_mats(tb["src_exts"], tb["src_ixts"], tb["tar_ext"],
                          tb["tar_ixt"], src_scale=0.25, tar_scale=0.25)
    feats = torch.from_numpy(rng.randn(1, 3, 16, 20, 32).astype(np.float32)
                             ).to(torch.bfloat16)
    depth = (3.0 + rng.rand(1, 12, 16, 20)).astype(np.float32)
    out = cost_volume_plain(feats, projs, torch.from_numpy(depth),
                            tb["view_mask"])
    assert out.dtype == torch.bfloat16
    jargs = (jnp.asarray(feats.float().numpy()), jnp.asarray(projs.numpy()),
             jnp.asarray(depth), jnp.asarray(b["view_mask"]))
    ref = jit_compiled(lambda f, *a: j_build_cost_volume(f, *a).astype(BF16),
                       *jargs)(*jargs)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **K1_TOL)
    ref_jnp = jit_compiled(lambda f, *a: j_build_cost_volume(
        f.astype(BF16), *a), *jargs)(*jargs)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref_jnp, np.float32), rtol=0,
        atol=K1_JNP_ULPS * float(np.asarray(ref, np.float32).max()))

    logits = torch.from_numpy(3 * rng.randn(1, 12, 16, 20).astype(np.float32)
                              ).to(torch.bfloat16)
    jl, jd = jnp.asarray(logits.float().numpy()), jnp.asarray(depth)
    for inv in (True, False):
        got = depth_regression_plain(logits, torch.from_numpy(depth), inv)
        refs = jit_compiled(lambda l, d: j_depth_regression(l, d, inv),
                            jl, jd)(jl, jd)
        refs_jnp = jit_compiled(lambda l, d: j_depth_regression(
            l.astype(BF16), d, inv), jl, jd)(jl, jd)
        vmax = float(np.max(1.0 / depth if inv else depth))
        for o, r, rj in zip(got, refs, refs_jnp):
            assert o.dtype == torch.float32 and rj.dtype == F32
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **K4_TOL)
            np.testing.assert_allclose(o.numpy(), np.asarray(rj), rtol=0,
                                       atol=K4_JNP_SHARE * vmax)

    a, jhead, variables = _stage_inputs(3, level=1, slots=3)
    vol16 = jnp.asarray(a["feat_volume"]).astype(BF16)
    a = dict(a, feat_volume=np.asarray(vol16, np.float32))
    head = load_flax_variables(NeRFHead(jhead.feat_ch).eval(), variables)
    args, kw = _port_args(a, head)
    args = (*args[:4], args[4].to(torch.bfloat16), *args[5:])
    with torch.no_grad():
        got = render_rays_plain(*args, **kw)
    ref = jit_compiled(lambda a, v: _jax_render(a, jhead, v), a,
                       variables)(a, variables)
    a16 = dict(a, feat_volume=vol16)
    ref_jnp = jit_compiled(lambda a, v: _jax_render(a, jhead, v), a16,
                           variables)(a16, variables)
    assert got["rgb"].shape == (1, RH * RW, 3)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **RENDER_TOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_jnp[k]),
                                   **RENDER_JNP_TOL, err_msg=k)

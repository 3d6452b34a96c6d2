"""The port's composite (ENeRF-Outdoor) model in training mode vs
``enerf_tpu``'s ``ENeRFComposite(train_mode=True)`` on the CPU: one forward
with batch statistics in BN (the port's training branch: the plain cost
volumes of the fg window and of the background), then the gradient of an
MSE loss on both levels' rgb against seeded targets. 64×64, 2 source
views, 1 fg layer in a (32, 32) window, both levels rendered, as
``tests/test_torch_composite.py``; seeded weights in the JAX model's
variables tree carried across by the port's converter.

Tolerances: the outputs as ``tests/test_torch_enerf.py`` (rtol 1e-3, atol
3e-4 on rgb and weights, 3e-3 on depth) plus, at each element, the port's
own f32 rounding there (|f32 − f64| of the same port forward): with batch
statistics the level-1 samples of a few pixels are so sensitive that f32
rounding alone moves a weight by up to 8.5e-4; the loss rtol 1e-5; each
parameter's gradient at cosine ≥ 0.999 with JAX's, as
``tests/test_torch_train_step.py``, except the background branch's
(``feature_net_bg``, ``cost_reg_*_bg``, ``nerf_*_bg``) at ≥ 0.99. Those
differ from JAX's by more than rounding: at this size the worst,
``cost_reg_0_bg.conv11.1.bias``, is at cosine 0.9967 with JAX's, while the
port's f32 and f64 gradients agree to 2e-5 and JAX's at two XLA
optimization levels to 1.4e-4 (other bg planes, sample counts and JAX's
unpacked head give 0.994–0.999); the forward agrees.

``test_composite_head_gradients_on_jax_inputs`` and
``test_composite_bg_stage_gradients_on_jax_inputs`` hold each module of
that branch apart: JAX's recorded inputs and output cotangents replayed
through the port's heads, bg FeatureNet and bg cost-regularization nets
give JAX's gradients at cosine ≥ 0.999 and relative L2 ≤ 1e-4. So every
stage and its backward agree, and the end-to-end gap is the conditioning
of the batch-statistics forward: each stage's inputs differ between the
two sides by rounding, which the forward amplifies."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.datasets.synthetic import make_composite_batch
from enerf_tpu.models.enerf_composite import ENeRFComposite as JComposite
from enerf_tpu_torch import build_model
from enerf_tpu_torch.utils.convert import (
    flax_leaves_by_param,
    load_flax_variables,
)
from tests.test_torch_composite import (
    ATOL,
    FAST_COMPILE,
    RTOL,
    _jcfg,
    _port_cfg,
)
from tests.test_torch_modules import seeded_variables
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

H = W = 64
L = 1
# the background branch's gradients: see the docstring
BG_COSINE = 0.99


@pytest.fixture(scope="module")
def train_pair():
    """One training-mode forward and loss gradient on each side."""
    jcfg = _jcfg(L)
    batch = make_composite_batch(jcfg, H=H, W=W)
    batch.pop("tar_img")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JComposite(cfg=jcfg.enerf, train_mode=True)
    rng = np.random.RandomState(11)
    variables = seeded_variables(jmodel, rng, jb)
    stats = variables["batch_stats"]

    def forward(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, jb,
                              mutable=["batch_stats"])
        return out

    shapes = jax.eval_shape(forward, variables["params"])
    targets = {k: rng.rand(*v.shape).astype(np.float32)
               for k, v in shapes.items() if k.startswith("rgb")}

    def loss_fn(params):
        out = forward(params)
        loss = sum(jnp.mean((out[k] - targets[k]) ** 2) for k in targets)
        return loss, out

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        variables["params"]).compile(compiler_options=FAST_COMPILE)
    (jloss, jout), jgrads = step(variables["params"])

    model = load_flax_variables(build_model(_port_cfg(jcfg), device="cpu"),
                                variables).train()
    out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    loss = sum(torch.mean((out[k] - torch.from_numpy(t)) ** 2)
               for k, t in targets.items())
    loss.backward()
    with torch.no_grad():      # the same forward in f64: f32's rounding
        out64 = copy.deepcopy(model).double()({
            k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32
                                else v) for k, v in batch.items()})
    return dict(jloss=float(jloss), jout=jout, jgrads=jgrads, model=model,
                jcfg=jcfg, jb=jb, variables=variables, targets=targets,
                loss=float(loss.detach()),
                out={k: v.detach().numpy() for k, v in out.items()},
                out64={k: v.numpy() for k, v in out64.items()})


def test_composite_train_forward_matches_jax(train_pair):
    ref, out = train_pair["jout"], train_pair["out"]
    out64 = train_pair["out64"]
    assert set(out) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        rounding = np.abs(out[k] - out64[k])
        bad = (np.abs(out[k] - r)
               > ATOL[k.split("_")[0]] + RTOL * np.abs(r) + rounding)
        assert not bad.any(), (k, int(bad.sum()),
                               float(np.abs(out[k] - r)[bad].max()))
    np.testing.assert_allclose(train_pair["loss"], train_pair["jloss"],
                               rtol=1e-5)


def test_composite_train_gradients_match_jax(train_pair):
    model = train_pair["model"]
    ref = flax_leaves_by_param(model, train_pair["jgrads"])
    assert set(ref) == {k for k, _ in model.named_parameters()}
    worst = {True: (2.0, None), False: (2.0, None)}     # by bg branch
    for k, p in model.named_parameters():
        g_ref = ref[k]
        if np.abs(g_ref).max() < 1e-7:
            # no gradient in JAX (or 0 but for rounding, as a bias whose
            # effect a softmax over views cancels)
            assert p.grad is None or float(p.grad.abs().max()) < 1e-6, k
            continue
        assert p.grad is not None, k
        g = p.grad.numpy().ravel()
        cos = float(np.dot(g, g_ref.ravel())
                    / (np.linalg.norm(g) * np.linalg.norm(g_ref)))
        bg = k.split(".")[0].endswith("_bg")
        worst[bg] = min(worst[bg], (cos, k))
    print(f"worst gradient cosine {worst[False]}, background {worst[True]}")
    assert worst[False][0] >= 0.999, worst[False]
    assert worst[True][0] >= BG_COSINE, worst[True]


# every head of the model: the fg layer's and the background's, per level
HEADS = ("nerf_0_layer0", "nerf_1_layer0", "nerf_0_bg", "nerf_1_bg")
# the background branch's stages upstream of its heads: its FeatureNet and
# each level's cost-regularization net
BG_STAGES = ("feature_net_bg", "cost_reg_0_bg", "cost_reg_1_bg")


@pytest.fixture(scope="module")
def head_replay(train_pair):
    """JAX's own inputs, output cotangent and parameter gradients of each
    NeRF head and each upstream stage of the background branch
    (``BG_STAGES``) in the fixture's training-mode forward and loss,
    recorded without touching the JAX package: ``flax.linen.intercept_methods``
    catches each ``NeRFHead``, ``FeatureNet`` and ``MinCostRegNet``
    ``__call__``, keeps its arguments and adds a zero probe to each of its
    outputs, whose gradient is that output's cotangent. A module's
    parameters serve that one call only, so their gradient in the same
    program is the vjp of that module alone at those inputs and that
    cotangent (with batch statistics in its BN, which are a function of
    its inputs). JAX runs its per-view jnp head here
    (``train_packed_render`` off), the head whose arguments the port's
    head takes; one compiled gradient, with respect to the probes and the
    recorded modules' parameters only."""
    import dataclasses

    from flax import linen as nn

    from enerf_tpu.models.cost_reg import MinCostRegNet as JMinCostRegNet
    from enerf_tpu.models.feature_net import FeatureNet as JFeatureNet
    from enerf_tpu.models.nerf_head import NeRFHead as JNeRFHead

    jcfg, jb = train_pair["jcfg"], train_pair["jb"]
    variables, targets = train_pair["variables"], train_pair["targets"]
    jmodel = JComposite(cfg=dataclasses.replace(
        jcfg.enerf, train_packed_render=False), train_mode=True)
    names = HEADS + BG_STAGES

    def run(module_params, probes=None):
        recorded = {}

        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            name = context.module.name
            if (isinstance(context.module, (JNeRFHead, JFeatureNet,
                                            JMinCostRegNet))
                    and context.method_name == "__call__" and name in names):
                assert name not in recorded, f"{name} called twice"
                recorded[name] = (args, out)
                if probes is not None:
                    out = jax.tree_util.tree_map(jnp.add, out, probes[name])
            return out

        params = {**variables["params"], **module_params}
        with nn.intercept_methods(intercept):
            out, _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jb, mutable=["batch_stats"])
        loss = sum(jnp.mean((out[k] - targets[k]) ** 2) for k in targets)
        return loss, recorded

    module_params = {k: variables["params"][k] for k in names}
    shapes = jax.eval_shape(lambda p: run(p)[1], module_params)
    assert set(shapes) == set(names)
    probes = {k: jax.tree_util.tree_map(lambda o: jnp.zeros(o.shape, o.dtype),
                                        v[1]) for k, v in shapes.items()}
    grad = jax.jit(jax.grad(lambda p, q: run(p, q), argnums=(0, 1),
                            has_aux=True)).lower(module_params, probes).compile(
        compiler_options=FAST_COMPILE)
    (jgrads, cotangents), recorded = grad(module_params, probes)
    return {k: ([np.array(a) for a in recorded[k][0]],
                jax.tree_util.tree_map(np.array, cotangents[k]), jgrads[k])
            for k in names}


def _hold_module_gradients(model, name, module, jgrads):
    """The port's ``module`` (a copy of ``name`` after its backward) holds
    each parameter's gradient against JAX's at cosine ≥ 0.999 and relative
    L2 error ≤ 1e-4; a parameter with no gradient in JAX (0 but for
    rounding) has none in the port either. Returns the worst (cosine,
    -relative L2, parameter)."""
    ref = flax_leaves_by_param(model, {name: jgrads})
    grads = {f"{name}.{k}": p.grad for k, p in module.named_parameters()}
    assert set(ref) == set(grads)
    worst = (2.0, 0.0, None)
    for k, g_ref in ref.items():
        if np.abs(g_ref).max() < 1e-7:
            assert grads[k] is None or float(grads[k].abs().max()) < 1e-6, k
            continue
        g = grads[k].numpy().ravel().astype(np.float64)
        g_ref = g_ref.ravel().astype(np.float64)
        rel = np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
        cos = float(np.dot(g, g_ref) / (np.linalg.norm(g)
                                        * np.linalg.norm(g_ref)))
        worst = min(worst, (cos, -rel, k))
        assert cos >= 0.999 and rel <= 1e-4, (k, cos, rel)
    return worst


@pytest.mark.parametrize("head", HEADS)
def test_composite_head_gradients_on_jax_inputs(train_pair, head_replay, head):
    """Each head's backward, held apart from the forward's conditioning:
    JAX's recorded inputs and output cotangent (``head_replay``) replayed
    through the port's head, whose parameter gradients must match JAX's
    head's at cosine ≥ 0.999 and relative L2 error ≤ 1e-4 each (f32 on
    both sides; the head's products and softmaxes reassociate)."""
    args, ct, jgrads = head_replay[head]
    model = train_pair["model"]
    port_head = copy.deepcopy(model.get_submodule(head))
    for p in port_head.parameters():
        p.grad = None
    out = port_head(*[torch.from_numpy(a) for a in args])
    assert tuple(out.shape) == ct.shape
    out.backward(torch.from_numpy(ct))
    worst = _hold_module_gradients(model, head, port_head, jgrads)
    print(f"{head}: worst gradient (cosine, -relative L2, parameter) {worst}")


@pytest.mark.parametrize("stage", BG_STAGES)
def test_composite_bg_stage_gradients_on_jax_inputs(train_pair, head_replay,
                                                    stage):
    """Each upstream stage of the background branch held as the heads are:
    JAX's recorded inputs and output cotangents replayed through the
    port's stage in training mode (batch statistics in BN), its parameter
    gradients against JAX's at cosine ≥ 0.999 and relative L2 ≤ 1e-4.
    That they hold shows the stages and their backwards agree, and the
    end-to-end gap of the branch (``BG_COSINE``) is the conditioning of
    the forward, whose inputs differ between the two sides by rounding."""
    args, cts, jgrads = head_replay[stage]
    model = train_pair["model"]
    port = copy.deepcopy(model.get_submodule(stage)).train()
    for p in port.parameters():
        p.grad = None
    outs = port(*[torch.from_numpy(a) for a in args])
    assert [tuple(o.shape) for o in outs] == [c.shape for c in cts]
    torch.autograd.backward(list(outs), [torch.from_numpy(c) for c in cts])
    worst = _hold_module_gradients(model, stage, port, jgrads)
    print(f"{stage}: worst gradient (cosine, -relative L2, parameter) {worst}")

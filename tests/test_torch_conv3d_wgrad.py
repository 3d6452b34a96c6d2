"""The 3D CNNs' weight-gradient route on the CPU
(``ops/kernels/conv3d_wgrad.py``, ``models/layers.py:conv_f32``).

- One conv through the route (stride 1 and 2, one output channel,
  ConvTranspose3d) against the module, and a transposed conv's weight
  gradient as a conv's with its input and output gradient in each other's
  place, the operands the kernel gets; ``plan``'s partition of the rows
  and tiles.
- Where the route engages: every Conv3d and ConvTranspose3d of the 3D CNNs
  in a float32 step that records their gradient, and nowhere in an eval
  frame, a ``no_grad`` or ``inference_mode`` call or the bf16 mode.
- The route against the modules' own forwards: on the CPU both compute
  the same aten calls, so outputs and gradients are equal bit for bit.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import re

import pytest
import torch
from torch import nn

import enerf_tpu_torch as et
from enerf_tpu_torch import config as pc
from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
from enerf_tpu_torch.models import layers
from enerf_tpu_torch.models.cost_reg import (
    CostRegNet,
    MinCostRegNet,
    MinCostRegNetTri,
)
from enerf_tpu_torch.models.layers import init_weights
from enerf_tpu_torch.ops.kernels import _build
from enerf_tpu_torch.ops.kernels import conv3d_wgrad as kwg
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import depth_regression as kdr
from enerf_tpu_torch.ops.kernels import layer_render as klr
from enerf_tpu_torch.ops.kernels import render as krender
from enerf_tpu_torch.train import create_train_state, make_train_step
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

H, W = 32, 32
CONV3D = (nn.Conv3d, nn.ConvTranspose3d)


@pytest.mark.parametrize("Ci,Co,shape,stride,transposed", [
    (16, 8, (8, 16, 20), 1, False),      # a U-Net's first conv
    (8, 1, (8, 16, 20), 1, False),       # the depth head
    (8, 16, (8, 16, 20), 2, False),      # a strided encoder stage
    (32, 64, (2, 4, 6), 2, False),       # the deepest stage
    (16, 8, (5, 7, 9), 1, False),        # odd sizes
    (16, 8, (4, 8, 10), 2, True),        # a decoder stage (ConvTranspose3d)
    (64, 32, (1, 2, 3), 2, True),
])
def test_wgrad_scheme_matches_plain(Ci, Co, shape, stride, transposed):
    """One conv through the route against the module's own forward and
    backward, bit for bit on the CPU: the output, the input gradient and
    the weight gradient. And the identity the kernel's route rests on:
    the weight gradient is ``wgrad_plain`` of (input, output gradient),
    for a transposed conv of (output gradient, input), the operands that
    ``Conv3d.backward`` hands the kernel on the card."""
    g = torch.Generator().manual_seed(Ci * 100 + Co)
    if transposed:
        conv = nn.ConvTranspose3d(Ci, Co, 3, stride=2, padding=1,
                                  output_padding=1, bias=False)
    else:
        conv = nn.Conv3d(Ci, Co, 3, stride=stride, padding=1, bias=False)
    assert kwg.takes(conv)
    x = torch.randn(2, Ci, *shape, generator=g).requires_grad_()
    y_ref = conv(x)
    gy = torch.randn(y_ref.shape, generator=g)
    gx_ref, gw_ref = torch.autograd.grad(y_ref, (x, conv.weight), gy)
    y = kwg.conv3d(conv, x)
    gx, gw = torch.autograd.grad(y, (x, conv.weight), gy)
    assert torch.equal(y, y_ref)
    assert torch.equal(gx, gx_ref)
    assert torch.equal(gw, gw_ref)
    a, b = (gy, x.detach()) if transposed else (x.detach(), gy)
    assert torch.equal(kwg.wgrad_plain(a, b, stride), gw_ref)


def test_takes_every_3d_conv_and_no_2d_conv():
    cfg = pc.Config(enerf=pc.ENeRFConfig(cas_config=pc.CascadeConfig(num=2)))
    model = et.build_model(cfg, device="cpu", train=True)
    convs = [m for m in model.modules()
             if isinstance(m, (nn.Conv2d, *CONV3D))]
    for m in convs:
        assert kwg.takes(m) == isinstance(m, CONV3D), m
    assert sum(isinstance(m, CONV3D) for m in convs) == 21


def _cfg(dtype="float32"):
    return pc.Config(
        enerf=pc.ENeRFConfig(test_input_views=2, train_input_views=(2,),
                             grid_rays=True,
                             cas_config=pc.CascadeConfig(
                                 num=2, volume_planes=(8, 8))),
        compute_dtype=dtype)


@pytest.fixture
def routed(monkeypatch):
    """Counts of the calls through the route: ``conv3d`` (a forward), and
    ``Conv3d.backward`` (a backward) with a weight gradient."""
    calls = {"forward": 0, "backward": 0}
    conv3d, backward = kwg.conv3d, kwg.Conv3d.backward

    def count_conv3d(conv, x):
        calls["forward"] += 1
        return conv3d(conv, x)

    def count_backward(ctx, gy):
        out = backward(ctx, gy)
        calls["backward"] += out[1] is not None
        return out

    monkeypatch.setattr(kwg, "conv3d", count_conv3d)
    monkeypatch.setattr(kwg.Conv3d, "backward", staticmethod(count_backward))
    return calls


def test_route_engages_on_the_f32_grad_path_only(routed):
    """One f32 train step (2 views, 32x32, planes 8, 8) routes each of the
    21 3D convs once a step (MinCostRegNet's 9 at level 0, CostRegNet's 12
    at level 1), forward and backward, and no FPN conv; an eval frame, a
    ``no_grad`` and an ``inference_mode`` forward of the trained model and
    a bf16 step route none."""
    cfg = _cfg()
    batch = make_synthetic_batch(cfg, H=H, W=W, split="train")
    batch.pop("tar_img")
    model = et.build_model(cfg, device="cpu", seed=0, train=True)
    step = make_train_step(cfg, (H, W))
    state, stats = step(create_train_state(cfg, model), batch)
    assert torch.isfinite(stats["loss"])
    assert routed == {"forward": 21, "backward": 21}

    tb = et.device_batch(batch, "cpu")
    model.train()
    with torch.no_grad():
        model(tb)
    with torch.inference_mode():
        model(tb)
    eval_batch = make_synthetic_batch(cfg, H=H, W=W)
    model.eval()
    et.render(model, eval_batch)
    assert routed == {"forward": 21, "backward": 21}

    bf16 = _cfg("bfloat16")
    m16 = et.build_model(bf16, device="cpu", seed=0, train=True)
    make_train_step(bf16, (H, W))(create_train_state(bf16, m16), batch)
    assert routed == {"forward": 21, "backward": 21}


@pytest.mark.parametrize("net,shape", [
    (MinCostRegNet, (1, 8, 8, 12, 32)),
    (CostRegNet, (1, 8, 16, 16, 16)),
    (MinCostRegNetTri, (1, 8, 8, 12, 32)),
])
def test_route_equals_module_forward(monkeypatch, net, shape):
    """Each U-Net in training mode, through the route and through its
    modules' own forwards (``takes`` patched to refuse): the outputs, every
    parameter's gradient, the volume's gradient and the BN running
    statistics are equal."""
    g = torch.Generator().manual_seed(3)
    vol = torch.randn(shape, generator=g)
    a = net(shape[-1])
    init_weights(a, g)
    b = net(shape[-1])
    b.load_state_dict(a.state_dict())
    cot = None

    def run(model):
        nonlocal cot
        v = vol.clone().requires_grad_()
        feat, logits = model(v)
        if cot is None:
            cot = (torch.randn(feat.shape, generator=g),
                   torch.randn(logits.shape, generator=g))
        (feat * cot[0]).sum().add((logits * cot[1]).sum()).backward()
        return feat, logits, v.grad

    routed = run(a)
    monkeypatch.setattr(layers.conv3d_wgrad, "takes", lambda conv: False)
    plain = run(b)
    for u, v in zip(routed, plain):
        assert torch.equal(u, v)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p.grad, q.grad), n
    for (n, s), t in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(s, t), n


def test_plan_covers_rows_and_tiles():
    """Every output row falls to one block and every thread tile to one
    group, with at most ``THREADS`` tiles a block."""
    for Co, Ci, rows in [(8, 16, 2048), (1, 8, 2048), (64, 64, 32),
                         (16, 8, 7), (32, 16, 128), (4, 12, 77)]:
        tm, per, groups, rpb, splits = kwg.plan(Co, Ci, rows, 132)
        tiles = Co // tm * 27 * Ci // 4
        assert tm == (8 if Co % 8 == 0 else 1) and per <= kwg.THREADS
        assert (groups - 1) * per < tiles <= groups * per
        assert (splits - 1) * rpb < rows <= splits * rpb


@pytest.mark.parametrize("source,symbol,wrapper", [
    ("conv3d_wgrad", "enerf_conv3d_wgrad", kwg),
    ("cost_volume", "enerf_cost_volume", kcv),
    ("depth_regression", "enerf_depth_regression", kdr),
    ("render", "enerf_render_rays", krender),
    ("render_l0", "enerf_render_rays_l0", krender),
    ("layer_render", "enerf_layer_render", klr),
])
def test_argtypes_match_the_c_signature(source, symbol, wrapper):
    """Each wrapper binds its C function with one ctypes type a parameter
    of the source's declaration: a pointer or the stream as a
    ``c_void_p``, an int as a ``c_int``, a float as a ``c_float`` (a
    mismatch raises, or cuts a pointer to 32 bits, only on the card)."""
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "cudaStream_t": ctypes.c_void_p}
    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    types = [p.strip().rsplit(" ", 1)[0] for p in decl.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in t else kinds[t] for t in types]
    assert wrapper._ARGTYPES == want

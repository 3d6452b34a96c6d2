"""Depth regression (K4) and the two repairs of the first port slice, on
the CPU.

- The port's ``depth_regression`` (its autograd Function, whose forward is
  the plain version on a CPU tensor) vs the JAX package's Pallas kernel
  ``depth_regression_pallas`` in interpret mode (as ``tests/test_pallas.py``
  runs it), and its gradients vs those of ``depth_regression_fused``, for
  ``depth_inv`` True and False. Tolerance: rtol 1e-5 / atol 1e-6 on
  depth, and on std and the gradients rtol 1e-4 / atol 1e-6 (the class of
  ``tests/test_pallas.py``: f32, reductions summed in another order).
- The composite depth map passes no gradient to ``z_vals``, as in JAX.
- The cost-volume and render kernel wrappers refuse inputs that need a
  gradient (their kernels have no backward), before any device check; the
  depth-regression wrapper refuses a tensor that is on neither the CPU nor
  a CUDA device.
- The CUDA kernel's scheme (per-thread central partials over plane chunks,
  Chan's merge of the plane groups with max rescaling), emulated in
  float32 torch ops with the launcher's plans and with one group, vs the
  Pallas kernel within ``chip_smoke.py``'s K4 tolerance; the launcher's
  plan for every plane count in ``configs/``; bfloat16 inputs and outputs
  vs the Pallas kernel on bfloat16 inputs (``tests/test_pallas.py``'s
  bf16 tolerances).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from enerf_tpu.ops.composite import raw2outputs as j_raw2outputs
from enerf_tpu.ops.pallas.reductions import (
    depth_regression_fused,
    depth_regression_pallas,
)
from enerf_tpu_torch.ops.composite import raw2outputs
from enerf_tpu_torch.ops.depth import depth_regression
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import depth_regression as kdr
from enerf_tpu_torch.ops.kernels import render as krender
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

D_TOL = dict(rtol=1e-5, atol=1e-6)
S_TOL = dict(rtol=1e-4, atol=1e-6)
# chip_smoke.py's K4_TOL: the kernel's f32 sums in its own order
K4_TOL = dict(rtol=1e-4, atol=1e-6)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed, B=2, D=16, H=12, W=20):
    """Logits and per-pixel plane values as the cascade has them: planes
    spread over [2, 6] with a per-pixel jitter."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, D, H, W).astype(np.float32)
    values = (np.linspace(2.0, 6.0, D, dtype=np.float32)[None, :, None, None]
              + 0.1 * rng.rand(B, D, H, W).astype(np.float32))
    return logits, values


@pytest.mark.parametrize("depth_inv", [False, True])
def test_forward_matches_pallas(interpret, depth_inv):
    logits, values = _inputs(1)
    d_ref, s_ref = depth_regression_pallas(jnp.asarray(logits),
                                           jnp.asarray(values), depth_inv,
                                           tile_p=128)
    d, s = depth_regression(torch.from_numpy(logits),
                            torch.from_numpy(values), depth_inv)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), **D_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **S_TOL)


@pytest.mark.parametrize("depth_inv", [False, True])
def test_gradients_match_fused(interpret, depth_inv):
    logits, values = _inputs(2, B=1, D=8, H=8, W=16)

    def loss(l, v):
        d, s = depth_regression_fused(l, v, depth_inv)
        return jnp.sum(d * 1.3 + s * 0.7)

    gl_ref, gv_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(logits),
                                                    jnp.asarray(values))
    lt = torch.from_numpy(logits).requires_grad_()
    vt = torch.from_numpy(values).requires_grad_()
    d, s = depth_regression(lt, vt, depth_inv)
    assert d.grad_fn is not None and "DepthRegression" in type(d.grad_fn).__name__
    gl, gv = torch.autograd.grad(torch.sum(d * 1.3 + s * 0.7), (lt, vt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(gl_ref), **S_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_ref), **S_TOL)
    # one input alone: the other gets no gradient
    (gl_only,) = torch.autograd.grad(
        depth_regression(lt, vt.detach(), depth_inv)[0].sum(), (lt,))
    assert gl_only.shape == lt.shape


def test_composite_depth_passes_no_gradient_to_z_vals():
    rng = np.random.RandomState(3)
    raw = rng.randn(1, 5, 4, 4).astype(np.float32)
    z = np.sort(rng.rand(1, 5, 4).astype(np.float32) + 2.0, axis=-1)
    g_ref = jax.grad(lambda zv: jnp.sum(
        j_raw2outputs(jnp.asarray(raw), zv)["depth"]))(jnp.asarray(z))
    assert not np.any(np.asarray(g_ref))
    zt = torch.from_numpy(z).requires_grad_()
    rt = torch.from_numpy(raw).requires_grad_()
    out = raw2outputs(rt, zt)
    g, g_raw = torch.autograd.grad(out["depth"].sum(), (zt, rt),
                                   allow_unused=True, materialize_grads=True)
    assert not torch.any(g) and torch.any(g_raw)
    np.testing.assert_allclose(
        out["depth"].detach().numpy(),
        np.asarray(j_raw2outputs(jnp.asarray(raw), jnp.asarray(z))["depth"]),
        rtol=1e-5, atol=1e-6)


def _meta(*shape, grad=False):
    return torch.empty(*shape, device="meta", dtype=torch.float32,
                       requires_grad=grad)


@pytest.mark.parametrize("kernel,needs_grad", [
    ("cost_volume", "input"), ("render", "input"), ("render", "head")])
def test_kernel_wrappers_refuse_gradients(kernel, needs_grad):
    """A tensor (or a head parameter) that needs a gradient raises
    ``ValueError`` naming the plain version, before the device check;
    under ``no_grad`` the same call reaches the device check."""
    from enerf_tpu_torch.models.nerf_head import NeRFHead

    def call(grad):
        g = grad and needs_grad == "input"
        if kernel == "cost_volume":
            return kcv.fused_cost_volume(_meta(1, 3, 8, 8, 16, grad=g),
                                         _meta(1, 3, 3, 4), _meta(1, 4, 8, 8))
        head = NeRFHead(11).to("meta").requires_grad_(
            grad and needs_grad == "head")
        return krender.render_rays(
            _meta(1, 4, 2, 3, grad=g), _meta(1, 4, 2, 3), _meta(1, 4, 2),
            _meta(1, 3, 2, 2, 11), _meta(1, 8, 2, 2, 8), _meta(1, 3, 4, 4),
            _meta(1, 3, 3, 3), _meta(1, 4, 4), None, head, render_scale=1.0)

    before = (kcv.launches, dict(krender.launches))
    plain = {"cost_volume": "cost_volume_plain",
             "render": "render_rays_plain"}[kernel]
    with pytest.raises(ValueError, match=f"no backward.*{plain}"):
        call(grad=True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call(grad=True)
    assert (kcv.launches, krender.launches) == before


def test_depth_wrapper_raises_off_cpu():
    before = kdr.launches
    with pytest.raises(ValueError, match="CUDA"):
        depth_regression(_meta(1, 8, 4, 4), _meta(1, 8, 4, 4), True)
    with pytest.raises(ValueError, match="CUDA"):
        depth_regression(_meta(1, 8, 4, 4, grad=True), _meta(1, 8, 4, 4), True)
    assert kdr.launches == before


# ---------------------------------------------------------------------------
# the CUDA kernel's scheme, emulated on the CPU


def _merge(a, b):
    """Chan's pairwise update of partials (m, s, mu, M2), as the kernel's
    ``merge``; a partial with s = 0 takes no part."""
    m = torch.maximum(a[0], b[0])
    wa = torch.where(a[1] > 0, torch.exp(a[0] - m), 0.0)
    wb = torch.where(b[1] > 0, torch.exp(b[0] - m), 0.0)
    sa, sb = a[1] * wa, b[1] * wb
    s = sa + sb
    fb = torch.where(s > 0, sb / s, 0.0)
    delta = b[2] - a[2]
    return (m, s, a[2] + delta * fb, a[3] * wa + b[3] * wb + delta ** 2 * sa * fb)


def _emulate_kernel(logits, values, depth_inv, ppt, groups):
    """``csrc/depth_regression.cu`` in float32 torch ops: thread (group g,
    pixel) reduces planes ``c * groups * ppt + g * ppt + k`` (k < ppt) of
    each chunk c to a central partial and merges its chunks pairwise; then
    the groups merge at once, each rescaled to the common max."""
    B, D, H, W = logits.shape
    span = groups * ppt
    chunks = -(-D // span)
    pad = chunks * span - D
    v = 1.0 / torch.clamp(values, min=1e-6) if depth_inv else values
    lg = torch.nn.functional.pad(logits.reshape(B, D, -1), (0, 0, 0, pad),
                                 value=-float("inf"))
    v = torch.nn.functional.pad(v.reshape(B, D, -1), (0, 0, 0, pad), value=1.0)
    lg = lg.reshape(B, chunks, groups, ppt, -1)
    v = v.reshape(B, chunks, groups, ppt, -1)
    m = lg.amax(3)
    valid = m > -float("inf")
    e = torch.exp(lg - torch.where(valid, m, 0.0)[:, :, :, None])
    s = e.sum(3)
    mu = torch.where(valid, (e * v).sum(3) / s, 0.0)
    m2 = torch.where(valid, (e * (v - mu[:, :, :, None]) ** 2).sum(3), 0.0)
    acc = (m[:, 0], s[:, 0], mu[:, 0], m2[:, 0])       # (B, groups, P)
    for c in range(1, chunks):
        acc = _merge(acc, (m[:, c], s[:, c], mu[:, c], m2[:, c]))
    m, s, mu, m2 = acc
    w = torch.where(s > 0, torch.exp(m - m.amax(1, keepdim=True)), 0.0)
    sw = s * w
    S = sw.sum(1)
    depth = (sw * mu).sum(1) / S
    M2 = (m2 * w + sw * (mu - depth[:, None]) ** 2).sum(1)
    std = torch.sqrt(torch.clamp(M2 / S, min=1e-10))
    return depth.reshape(B, H, W), std.reshape(B, H, W)


# Level 0 of the 512x640 frame has 64x80 pixels, level 1 256x320.
_FRAME_PIXELS = {5: 4999, 8: 256 * 320, 48: 64 * 80, 64: 64 * 80}
_EMU_SHAPE = (2, 6, 10)          # B, H, W


def _most_groups(D):
    """The finest split the kernel's C interface takes: the fewest planes a
    thread (a power of two) that leave at most ``MAX_GROUPS`` groups."""
    ppt = 1
    while -(-D // ppt) > kdr.MAX_GROUPS:
        ppt *= 2
    return ppt, -(-D // ppt)


def _emu_cases():
    cases = []
    for D, frame in _FRAME_PIXELS.items():
        plans = {kdr.plan(D, frame)[:2], _most_groups(D), (8, 1)}
        cases += [(D, ppt, g) for ppt, g in sorted(plans)]
    return cases


_PALLAS_REF = {}


@pytest.mark.parametrize("D,ppt,groups", _emu_cases())
def test_kernel_scheme_matches_pallas(interpret, D, ppt, groups):
    """The kernel's chunked partials and group merge, with the plan the
    launcher picks at the frame's size, with the most groups the kernel
    takes (the longest merge through shared memory) and with one group
    (every plane chunk merged in the thread), hold the Pallas kernel within
    K4_TOL. Level-0-like inputs for D >= 48 (disparity planes), level-1-like
    ones otherwise (per-pixel planes in a narrow band, where a wrong
    central moment shows)."""
    B, H, W = _EMU_SHAPE
    depth_inv = D >= 48
    if D not in _PALLAS_REF:
        rng = np.random.RandomState(D)
        logits = (3.0 * rng.randn(B, D, H, W)).astype(np.float32)
        if depth_inv:
            values = (np.linspace(2.5, 5.5, D, dtype=np.float32)[None, :, None, None]
                      + 0.05 * rng.rand(B, D, H, W).astype(np.float32))
        else:
            near = 3.0 + 0.6 * rng.rand(B, 1, H, W)
            band = 0.02 + 0.3 * rng.rand(B, 1, H, W)
            values = (near + np.linspace(0, 1, D)[None, :, None, None]
                      * band).astype(np.float32)
        ref = depth_regression_pallas(jnp.asarray(logits), jnp.asarray(values),
                                      depth_inv, tile_p=128)
        _PALLAS_REF[D] = (logits, values, [np.asarray(r) for r in ref])
    logits, values, ref = _PALLAS_REF[D]
    out = _emulate_kernel(torch.from_numpy(logits), torch.from_numpy(values),
                          depth_inv, ppt, groups)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, **K4_TOL)


def _config_plane_counts():
    counts = {D for cfg_planes in ((64, 8), (16, 4)) for D in cfg_planes}

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("volume_planes", "bg_volume_planes"):
                    counts.update(int(d) for d in v)
                else:
                    walk(v)

    for path in (REPO / "configs").rglob("*.yaml"):
        walk(yaml.safe_load(path.read_text()))
    return sorted(counts)


@pytest.mark.parametrize("D", _config_plane_counts())
def test_launch_plan(D):
    """Every plane count of ``configs/`` (and the config's defaults) at the
    frame's level sizes, a ragged pixel count and a tiny one: 8 planes a
    thread (the least power of two >= D below 8), whatever the pixel
    count; no group without planes, 3 to 32 warps a block (pixel tiles
    fill out a block of fewer than 4 groups), and blocks that cover the
    pixels with less than a block to spare."""
    for n in (1, 33, 4999, 64 * 80, 256 * 320):
        ppt, groups, tiles, blocks = kdr.plan(D, n)
        assert ppt in (1, 2, 4, 8)
        assert (ppt // 2 < D <= ppt) if D < 8 else ppt == 8
        assert 1 <= groups <= kdr.MAX_GROUPS
        assert (groups - 1) * ppt < D
        assert groups * ppt >= D or groups == kdr.MAX_GROUPS
        assert 3 <= groups * tiles <= kdr.MAX_GROUPS
        block_pixels = tiles * kdr.WARP
        assert (blocks - 1) * block_pixels < n <= blocks * block_pixels
    # the main paths: 8 planes a thread; 8 and 6 warps a block at level 0
    # (160 blocks), 4 pixel tiles of one group at level 1 (640 blocks)
    assert kdr.plan(64, 64 * 80) == (8, 8, 1, 160)
    assert kdr.plan(48, 64 * 80) == (8, 6, 1, 160)
    assert kdr.plan(8, 256 * 320) == (8, 1, 4, 640)


@pytest.mark.parametrize("depth_inv", [False, True])
def test_bf16_io_matches_pallas(interpret, depth_inv):
    """bfloat16 logits and values: the outputs in bfloat16 and, within
    ``tests/test_pallas.py``'s bf16 tolerances, the Pallas kernel's on the
    same bf16 inputs; the gradients in bfloat16, equal to the float32
    gradients of the upcast inputs rounded to bfloat16."""
    rng = np.random.RandomState(3)
    B, D, H, W = 1, 16, 8, 16
    logits = rng.randn(B, D, H, W).astype(np.float32)
    values = (np.linspace(2.0, 6.0, D, dtype=np.float32)[None, :, None, None]
              * np.ones((B, D, H, W), np.float32))
    d_ref, s_ref = depth_regression_pallas(
        jnp.asarray(logits).astype(jnp.bfloat16),
        jnp.asarray(values).astype(jnp.bfloat16), depth_inv, tile_p=128)
    lt = torch.from_numpy(logits).bfloat16().requires_grad_()
    vt = torch.from_numpy(values).bfloat16().requires_grad_()
    d, s = depth_regression(lt, vt, depth_inv)
    assert d.dtype == s.dtype == torch.bfloat16
    np.testing.assert_allclose(d.float().detach().numpy(),
                               np.asarray(d_ref, np.float32), rtol=1e-2)
    np.testing.assert_allclose(s.float().detach().numpy(),
                               np.asarray(s_ref, np.float32), rtol=2e-2,
                               atol=1e-3)
    g_d = torch.from_numpy(rng.randn(B, H, W).astype(np.float32)).bfloat16()
    g_s = torch.from_numpy(rng.randn(B, H, W).astype(np.float32)).bfloat16()
    grads = torch.autograd.grad((d, s), (lt, vt), (g_d, g_s))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    l32 = lt.detach().float().requires_grad_()
    v32 = vt.detach().float().requires_grad_()
    d32, s32 = kdr.depth_regression_plain(l32, v32, depth_inv)
    ref32 = torch.autograd.grad((d32, s32), (l32, v32),
                                (g_d.float(), g_s.float()))
    for g, r in zip(grads, ref32):
        torch.testing.assert_close(g, r.bfloat16(), rtol=0, atol=0)

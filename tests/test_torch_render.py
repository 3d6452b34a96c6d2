"""The level-1 render stage: the port's ``render_rays`` on the CPU (the
render kernel's plain version) vs the JAX jnp render — ``get_img_feat`` +
``get_vox_feat_grid`` + ``NeRFHead`` + ``raw2outputs``, the path
``enerf_tpu/models/enerf.py:_render_rays`` takes with the fused flags off —
with the same NeRFHead weights, on grid rays, with all views real and with
a padded view.

Tolerance rtol 1e-4 / atol 1e-5 on rgb, depth and weights: f32 on both
sides; the head's matmuls and the softmaxes reassociate, as in
``test_torch_modules.py``'s head case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enerf_tpu.config import CascadeConfig, Config, ENeRFConfig
from enerf_tpu.datasets.synthetic import make_synthetic_batch
from enerf_tpu.models.nerf_head import NeRFHead as JNeRFHead
from enerf_tpu.ops.composite import raw2outputs as j_raw2outputs
from enerf_tpu.ops.ibr import get_img_feat as j_get_img_feat
from enerf_tpu.ops.ibr import get_vox_feat_grid as j_get_vox_feat_grid
from enerf_tpu.ops.ibr import unpreprocess as j_unpreprocess
from enerf_tpu.ops.rays import build_rays as j_build_rays
from enerf_tpu.ops.rays import sample_along_depth as j_sample_along_depth
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.ops.kernels import render as krender
from enerf_tpu_torch.utils.convert import load_flax_variables
from tests.test_torch_modules import jax_variables

TOL = dict(rtol=1e-4, atol=1e-5)
H, W = 32, 48


def _stage_inputs(n_src, seed=0):
    """numpy inputs of the level-1 render stage of a synthetic frame, the
    JAX head and its variables."""
    rng = np.random.RandomState(seed)
    cfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3),
        cas_config=CascadeConfig(volume_planes=(48, 8))))
    batch = make_synthetic_batch(cfg, H=H, W=W, n_src=n_src)
    Hv, Wv = H // 2, W // 2
    depth = (3.2 + 1.2 * rng.rand(1, Hv, Wv)).astype(np.float32)
    std = (0.05 + 0.2 * rng.rand(1, Hv, Wv)).astype(np.float32)
    nf = np.stack([np.full((1, Hv, Wv), 2.8), np.full((1, Hv, Wv), 5.0)],
                  1).astype(np.float32)
    rays = j_build_rays(jnp.asarray(batch["rays_1"]), jnp.asarray(depth),
                        jnp.asarray(std), jnp.asarray(nf), False, 2.0, True)
    xyz, uvd, z = j_sample_along_depth(rays, 2, False)
    uvd = uvd * jnp.array([1.0 / (W - 1), 1.0 / (H - 1), 1.0])
    feat = rng.randn(1, 3, H, W, 8).astype(np.float32)
    rgbs = np.asarray(j_unpreprocess(jnp.asarray(batch["src_inps"])))
    img = np.concatenate([feat, rgbs], -1)
    vol = rng.randn(1, 8, Hv, Wv, 8).astype(np.float32)
    head = JNeRFHead(feat_ch=11, viewdir_agg=True)
    variables = jax_variables(head, rng, np.zeros((1, 4, 8), np.float32),
                              np.zeros((1, 4, 3, 15), np.float32))
    arrays = dict(world_xyz=np.asarray(xyz), uvd=np.asarray(uvd),
                  z_vals=np.asarray(z), img_feat_rgb=img, feat_volume=vol,
                  src_exts=batch["src_exts"], src_ixts=batch["src_ixts"],
                  tar_ext=batch["tar_ext"], view_mask=batch["view_mask"])
    return arrays, head, variables


def _jax_render(a, head, variables):
    vox = j_get_vox_feat_grid(jnp.asarray(a["feat_volume"]),
                              jnp.asarray(a["uvd"]).reshape(1, -1, 3)[..., 2],
                              (H, W))
    x = j_get_img_feat(jnp.asarray(a["world_xyz"]),
                       jnp.asarray(a["img_feat_rgb"]),
                       jnp.asarray(a["src_exts"]), jnp.asarray(a["src_ixts"]),
                       jnp.asarray(a["tar_ext"]), render_scale=1.0)
    raw = head.apply(variables, vox, x, jnp.asarray(a["view_mask"]))
    return j_raw2outputs(raw.reshape(1, H * W, 2, 4), jnp.asarray(a["z_vals"]))


def _port_args(a, head, device="cpu"):
    t = {k: torch.from_numpy(np.array(v, np.float32)).to(device)
         for k, v in a.items()}
    return ((t["world_xyz"], t["uvd"], t["z_vals"], t["img_feat_rgb"],
             t["feat_volume"], t["src_exts"], t["src_ixts"], t["tar_ext"],
             t["view_mask"], head.to(device)),
            dict(render_scale=1.0, grid_hw=(H, W)))


@pytest.mark.parametrize("n_src", [3, 2])
def test_render_stage_matches_jax(n_src):
    a, jhead, variables = _stage_inputs(n_src)
    assert a["view_mask"].sum() == n_src
    ref = jax.jit(lambda v: _jax_render(a, jhead, v))(variables)
    head = load_flax_variables(NeRFHead(11).eval(), variables)
    args, kw = _port_args(a, head)
    with torch.no_grad():
        out = krender.render_rays(*args, **kw)
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def test_head_params_layout():
    """The kernel's flat weight buffer holds every head weight once, in
    the order csrc/render.cu's HeadLayout reads (10,090 floats)."""
    head = NeRFHead(11)
    flat = krender.head_params(head)
    assert flat.numel() == sum(p.numel() for p in head.parameters()) == 10090
    assert torch.equal(flat[:44], head.agg.view_fc[0].weight.reshape(-1))
    assert torch.equal(flat[-65:-1], head.color[2].weight.reshape(-1))



def _tf32(x):
    """Round f32 to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped
    13 bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _linear_tf32(passes):
    """``F.linear`` as the render kernel's tensor cores compute it: TF32
    operands, products exact, sums in f32. Three passes split each operand
    as hi = tf32(x), lo = tf32(x - hi) and add a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi; one pass is a plain TF32 product."""
    def linear(x, w, b=None):
        xh, wh = _tf32(x), _tf32(w)
        y = xh @ wh.T
        if passes == 3:
            y = (_tf32(x - xh) @ wh.T + xh @ _tf32(w - wh).T) + y
        return y if b is None else y + b
    return linear


@pytest.mark.parametrize("passes", [3, 1])
def test_render_tf32_split_precision(monkeypatch, passes):
    """The render kernel's precision scheme on the CPU, without JAX: every
    Linear of the head (the kernel keeps four small ones in f32, so this
    is the harder case) in three TF32 passes stays within the kernel's
    tolerance of the f32 plain path (rtol 1e-4 / atol 2e-4, as
    chip_smoke.py's K2_TOL); one TF32 pass leaves it."""
    from enerf_tpu_torch.config import dtu_eval_config
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch as t_batch
    from enerf_tpu_torch.models.layers import init_weights
    from enerf_tpu_torch.ops.ibr import unpreprocess
    from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth

    g = torch.Generator().manual_seed(11)
    b = {k: torch.from_numpy(v) for k, v in
         t_batch(dtu_eval_config(), H=H, W=W, n_src=3).items()}
    head = NeRFHead(11)
    init_weights(head, g, kaiming_linear=True)
    head = head.eval()
    Hv, Wv = H // 2, W // 2
    depth = 3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g)
    std = 0.05 + 0.2 * torch.rand(1, Hv, Wv, generator=g)
    nf = torch.stack([torch.full((1, Hv, Wv), 2.8),
                      torch.full((1, Hv, Wv), 5.0)], 1)
    rays = build_rays(b["rays_1"], depth, std, nf, False, 2.0, grid=True)
    xyz, uvd, z = sample_along_depth(rays, 2, False)
    uvd = uvd * torch.tensor([1 / (W - 1), 1 / (H - 1), 1.0])
    img = torch.cat([torch.randn(1, 3, H, W, 8, generator=g),
                     unpreprocess(b["src_inps"])], -1)
    vol = torch.randn(1, 8, Hv, Wv, 8, generator=g)
    args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"], b["tar_ext"],
            b["view_mask"], head)
    kw = dict(render_scale=1.0, grid_hw=(H, W))
    with torch.no_grad():
        ref = krender.render_rays_plain(*args, **kw)
        monkeypatch.setattr(torch.nn.functional, "linear", _linear_tf32(passes))
        out = krender.render_rays_plain(*args, **kw)
    monkeypatch.undo()
    within = all(torch.allclose(out[k], ref[k], rtol=1e-4, atol=2e-4)
                 for k in ("rgb", "depth", "weights"))
    assert within == (passes == 3), {
        k: float((out[k] - ref[k]).abs().max()) for k in out}

"""The render stage of both cascade levels: the port's ``render_rays`` on
the CPU (the render kernels' plain version) vs the JAX jnp render —
``get_img_feat`` + ``get_vox_feat_grid`` + ``NeRFHead`` + ``raw2outputs``,
the path ``enerf_tpu/models/enerf.py:_render_rays`` takes with the fused
flags off — with the same NeRFHead weights, on grid rays, with all views
real and with a padded view. Level 1 is the head shape of
``csrc/render.cu`` (8 FPN channels + rgb, 2 samples, 8 planes); level 0
that of ``csrc/render_l0.cu`` (32 + rgb, 8 samples in disparity, a tent
over 64 planes, the image features at render scale 1/4), at S = 3 and 2.

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
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
H, W = 32, 48


# per level: image feature channels (without rgb), samples a ray, volume
# planes, disparity sampling, and the render scale of the (H, W) frame
LEVELS = {1: (8, 2, 8, False, 1.0), 0: (32, 8, 64, True, 0.25)}


def _stage_inputs(n_src, seed=0, level=1, slots=3):
    """numpy inputs of one level's render stage of a synthetic frame whose
    render frame at that level is (H, W), the JAX head and its
    variables."""
    rng = np.random.RandomState(seed)
    C, n, D, inv, rs = LEVELS[level]
    cfg = Config(enerf=ENeRFConfig(
        test_input_views=slots, train_input_views=(slots,),
        cas_config=CascadeConfig(volume_planes=(48, 8))))
    H0, W0 = int(H / rs), int(W / rs)
    batch = make_synthetic_batch(cfg, H=H0, W=W0, n_src=n_src)
    Hv, Wv = H // 2, W // 2
    if inv:   # depth, its std and the volume bounds in disparity
        depth = 1.0 / (3.2 + 1.2 * rng.rand(1, Hv, Wv))
        std = 0.005 + 0.02 * rng.rand(1, Hv, Wv)
        nf = np.stack([np.full((1, Hv, Wv), 1 / 2.5),
                       np.full((1, Hv, Wv), 1 / 5.5)], 1)
    else:
        depth = 3.2 + 1.2 * rng.rand(1, Hv, Wv)
        std = 0.05 + 0.2 * rng.rand(1, Hv, Wv)
        nf = np.stack([np.full((1, Hv, Wv), 2.8),
                       np.full((1, Hv, Wv), 5.0)], 1)
    depth, std, nf = (x.astype(np.float32) for x in (depth, std, nf))
    rays = j_build_rays(jnp.asarray(batch[f"rays_{level}"]),
                        jnp.asarray(depth), jnp.asarray(std), jnp.asarray(nf),
                        inv, 2.0, True)
    xyz, uvd, z = j_sample_along_depth(rays, n, inv)
    uvd = uvd * jnp.array([1.0 / (W - 1), 1.0 / (H - 1), 1.0])
    feat = rng.randn(1, slots, H, W, C).astype(np.float32)
    rgbs = np.asarray(j_unpreprocess(jnp.asarray(batch["src_inps"]),
                                     render_scale=rs))
    img = np.concatenate([feat, rgbs], -1)
    vol = rng.randn(1, D, Hv, Wv, 8).astype(np.float32)
    head = JNeRFHead(feat_ch=C + 3, viewdir_agg=True)
    variables = jax_variables(head, rng, np.zeros((1, 4, 8), np.float32),
                              np.zeros((1, 4, slots, C + 7), np.float32))
    arrays = dict(world_xyz=np.asarray(xyz), uvd=np.asarray(uvd),
                  z_vals=np.asarray(z), img_feat_rgb=img, feat_volume=vol,
                  src_exts=batch["src_exts"], src_ixts=batch["src_ixts"],
                  tar_ext=batch["tar_ext"], view_mask=batch["view_mask"])
    return arrays, head, variables


def _jax_render(a, head, variables, render_scale=1.0):
    n = a["z_vals"].shape[-1]
    vox = j_get_vox_feat_grid(jnp.asarray(a["feat_volume"]),
                              jnp.asarray(a["uvd"]).reshape(1, -1, 3)[..., 2],
                              (H, W))
    x = j_get_img_feat(jnp.asarray(a["world_xyz"]),
                       jnp.asarray(a["img_feat_rgb"]),
                       jnp.asarray(a["src_exts"]), jnp.asarray(a["src_ixts"]),
                       jnp.asarray(a["tar_ext"]), render_scale=render_scale)
    raw = head.apply(variables, vox, x, jnp.asarray(a["view_mask"]))
    return j_raw2outputs(raw.reshape(1, H * W, n, 4), jnp.asarray(a["z_vals"]))


def _port_args(a, head, device="cpu", render_scale=1.0):
    t = {k: torch.from_numpy(np.array(v, np.float32)).to(device)
         for k, v in a.items()}
    return ((t["world_xyz"], t["uvd"], t["z_vals"], t["img_feat_rgb"],
             t["feat_volume"], t["src_exts"], t["src_ixts"], t["tar_ext"],
             t["view_mask"], head.to(device)),
            dict(render_scale=render_scale, grid_hw=(H, W)))


@pytest.mark.parametrize("level,slots,n_src", [
    pytest.param(1, 3, 3, id="3"), pytest.param(1, 3, 2, id="2"),
    pytest.param(0, 3, 3, id="level0-s3"),
    pytest.param(0, 3, 2, id="level0-s3-padded-view"),
    pytest.param(0, 2, 2, id="level0-s2")])
def test_render_stage_matches_jax(level, slots, n_src):
    a, jhead, variables = _stage_inputs(n_src, level=level, slots=slots)
    assert a["view_mask"].sum() == n_src
    assert a["img_feat_rgb"].shape[1] == slots
    rs = LEVELS[level][4]
    ref = jax.jit(lambda a, v: _jax_render(a, jhead, v, rs))(a, variables)
    head = load_flax_variables(NeRFHead(jhead.feat_ch).eval(), variables)
    args, kw = _port_args(a, head, render_scale=rs)
    with torch.no_grad():
        out = krender.render_rays(*args, **kw)
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def test_head_params_layout():
    """The kernels' flat weight buffer holds every head weight once, in
    the order the HeadLayout of csrc/render.cu (Cf = 11, 10,090 floats) and
    csrc/render_l0.cu (Cf = 35, 14,050) reads."""
    for cf, size in ((11, 10090), (35, 14050)):
        head = NeRFHead(cf)
        flat = krender.head_params(head)
        assert flat.numel() == sum(p.numel() for p in head.parameters()) == size
        assert torch.equal(flat[:4 * cf],
                           head.agg.view_fc[0].weight.reshape(-1))
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


def _precision_case(level, g):
    """The render stage's inputs for the precision test on grid rays of an
    (H, W) render frame: level 1's head (8 FPN channels + rgb, 2 samples,
    8 planes, render scale 1) or level 0's (32 + rgb, 8 samples in
    disparity, 64 planes, render scale 1/4), seeded weights."""
    from enerf_tpu_torch.config import dtu_eval_config
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch as t_batch
    from enerf_tpu_torch.models.layers import init_weights
    from enerf_tpu_torch.ops.ibr import unpreprocess
    from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth

    C, n, D, inv, rs = LEVELS[level]
    b = {k: torch.from_numpy(v) for k, v in
         t_batch(dtu_eval_config(), H=int(H / rs), W=int(W / rs),
                 n_src=3).items()}
    head = NeRFHead(C + 3)
    init_weights(head, g, kaiming_linear=True)
    head = head.eval()
    Hv, Wv = H // 2, W // 2
    if inv:
        depth = 1 / (3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g))
        std = 0.005 + 0.02 * torch.rand(1, Hv, Wv, generator=g)
        nf = torch.stack([torch.full((1, Hv, Wv), 1 / 2.5),
                          torch.full((1, Hv, Wv), 1 / 5.5)], 1)
    else:
        depth = 3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g)
        std = 0.05 + 0.2 * torch.rand(1, Hv, Wv, generator=g)
        nf = torch.stack([torch.full((1, Hv, Wv), 2.8),
                          torch.full((1, Hv, Wv), 5.0)], 1)
    rays = build_rays(b[f"rays_{level}"], depth, std, nf, inv, 2.0, grid=True)
    xyz, uvd, z = sample_along_depth(rays, n, inv)
    uvd = uvd * torch.tensor([1 / (W - 1), 1 / (H - 1), 1.0])
    img = torch.cat([torch.randn(1, 3, H, W, C, generator=g),
                     unpreprocess(b["src_inps"], rs)], -1)
    vol = torch.randn(1, D, Hv, Wv, 8, generator=g)
    args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"], b["tar_ext"],
            b["view_mask"], head)
    return args, dict(render_scale=rs, grid_hw=(H, W))


@pytest.mark.parametrize("level,passes", [
    pytest.param(1, 3, id="3"), pytest.param(1, 1, id="1"),
    pytest.param(0, 3, id="level0-3"), pytest.param(0, 1, id="level0-1")])
def test_render_tf32_split_precision(monkeypatch, level, passes):
    """The render kernels' precision scheme on the CPU, without JAX, at
    both head shapes (level 1's of csrc/render.cu, level 0's of
    csrc/render_l0.cu, whose K sums are longer: 105 and 127 inputs against
    33 and 103): every Linear of the head (the kernels keep four small ones
    in f32, so this is the harder case) in three TF32 passes stays within
    the kernels' tolerance of the f32 plain path (rtol 1e-4 / atol 2e-4, as
    chip_smoke.py's K2_TOL); one TF32 pass leaves it at both levels."""
    g = torch.Generator().manual_seed(11)
    args, kw = _precision_case(level, g)
    with torch.no_grad():
        ref = krender.render_rays_plain(*args, **kw)
        monkeypatch.setattr(torch.nn.functional, "linear", _linear_tf32(passes))
        out = krender.render_rays_plain(*args, **kw)
    monkeypatch.undo()
    within = all(torch.allclose(out[k], ref[k], rtol=1e-4, atol=2e-4)
                 for k in ("rgb", "depth", "weights"))
    assert within == (passes == 3), {
        k: float((out[k] - ref[k]).abs().max()) for k in out}

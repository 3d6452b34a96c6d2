"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Each test skips without a CUDA device (a hand-written kernel has no CPU
mode). The render stage is held at both of its kernels' head shapes:
level 1's (``csrc/render.cu``) and level 0's (``csrc/render_l0.cu``). This file imports neither JAX nor the JAX package, so on a machine
with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs are seeded and small; tolerances as ``chip_smoke.py`` states them
(f32 with TF32 off in torch; the kernels sum in another order than the
plain versions, and the render kernel's products run in three TF32 passes
that keep f32 accuracy, see ``tests/test_torch_render.py``)."""

import dataclasses

import pytest
import torch

from enerf_tpu_torch.config import dtu_eval_config
from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
from enerf_tpu_torch.models.layers import init_weights
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.ops.camera import get_proj_mats
from enerf_tpu_torch.ops.depth import init_depth_values
from enerf_tpu_torch.ops.ibr import unpreprocess
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import depth_regression as kdr
from enerf_tpu_torch.ops.kernels import render as krender
from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth

H, W = 64, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(n_src, device, slots=3, hw=(H, W)):
    """A synthetic eval batch of an ``hw`` frame with ``slots`` source-view
    slots, the first ``n_src`` of them real."""
    cfg = dtu_eval_config()
    cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
        cfg.enerf, test_input_views=slots, train_input_views=(slots,)))
    b = make_synthetic_batch(cfg, H=hw[0], W=hw[1], n_src=n_src)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("level,n_src", [(0, 3), (1, 3), (1, 2)])
def test_cost_volume_kernel_matches_plain(cuda, level, n_src):
    g = torch.Generator().manual_seed(level)
    b = _batch(n_src, cuda)
    C, s, vs, D = ((32, 0.25, 0.125, 48), (16, 0.5, 0.5, 8))[level]
    feats = torch.randn(1, 3, int(H * s), int(W * s), C, generator=g).to(cuda)
    projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                          b["tar_ixt"], src_scale=s, tar_scale=vs)
    dv, _ = init_depth_values(b["near_far"], D, int(H * vs), int(W * vs),
                              level == 0)
    args = (feats, projs, dv, b["view_mask"])
    before = kcv.launches
    out = kcv.fused_cost_volume(*args)
    assert kcv.launches == before + 1
    torch.testing.assert_close(out, kcv.cost_volume_plain(*args), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,D,Ht,Wt,n_src", [
    (32, 48, 7, 11, 3),    # 8 lanes a voxel; 3,696 voxels leave a ragged block
    (32, 48, 7, 11, 2),    # ... with a padded view
    (16, 8, 31, 47, 3),    # 4 lanes a voxel; 11,656 voxels, ragged
    (16, 8, 31, 47, 2),
])
def test_cost_volume_kernel_ragged_and_padded(cuda, C, D, Ht, Wt, n_src):
    """Channel widths 16 and 32, a voxel count whose lanes do not fill the
    last block, and a padded view (mask 0, identity extrinsics)."""
    g = torch.Generator().manual_seed(C + n_src)
    b = _batch(n_src, cuda)
    s = 0.25 if C == 32 else 0.5
    feats = torch.randn(1, 3, int(H * s), int(W * s), C, generator=g).to(cuda)
    projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                          b["tar_ixt"], src_scale=s, tar_scale=Wt / W)
    dv, _ = init_depth_values(b["near_far"], D, Ht, Wt, C == 32)
    args = (feats, projs, dv, b["view_mask"])
    assert (D * Ht * Wt * C // 4) % 256 != 0
    assert float(b["view_mask"].sum()) == n_src
    before = kcv.launches
    out = kcv.fused_cost_volume(*args)
    assert kcv.launches == before + 1
    torch.testing.assert_close(out, kcv.cost_volume_plain(*args), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("level,origins,hw,n_src", [
    (1, [(5, 3)], (16, 24), 3),            # inside the frame
    (1, [(40, 20)], (16, 24), 3),          # across the right and bottom edges
    (0, [(-3, 2)], (5, 7), 3),             # a negative origin, ragged window
    (1, [(7, 9), (30, 0)], (13, 21), 2),   # B = 2, an origin each; padded view
])
def test_cost_volume_kernel_crop_mode(cuda, level, origins, hw, n_src):
    """K1's crop-window mode: the window's depth planes from its origin
    clamped into the frame, its warp from the unclamped origin."""
    B = len(origins)
    g = torch.Generator().manual_seed(20 + level + B)
    b = _batch(n_src, cuda)
    C, s, vs, D = ((32, 0.25, 0.125, 32), (16, 0.5, 0.5, 8))[level]
    feats = torch.randn(B, 3, int(H * s), int(W * s), C, generator=g).to(cuda)
    projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                          b["tar_ixt"], src_scale=s, tar_scale=vs).expand(
                              B, -1, -1, -1).contiguous()
    Ht, Wt = int(H * vs), int(W * vs)
    dv = (3.0 + torch.rand(B, D, Ht, Wt, generator=g)).to(cuda)
    vm = b["view_mask"].expand(B, -1).contiguous()
    window = (torch.tensor(origins, dtype=torch.int32).to(cuda), hw)
    before = kcv.launches
    out = kcv.fused_cost_volume(feats, projs, dv, vm, window=window)
    assert kcv.launches == before + 1
    assert out.shape == (B, D) + hw + (C,)
    torch.testing.assert_close(
        out, kcv.cost_volume_plain(feats, projs, dv, vm, window=window),
        rtol=1e-4, atol=1e-4)


def _plain_path(monkeypatch):
    """Every kernel wrapper of the model's path swapped for its plain
    version."""
    import enerf_tpu_torch.models.enerf as enerf_mod
    import enerf_tpu_torch.ops.depth as depth_mod
    import enerf_tpu_torch.ops.warp as warp_mod

    monkeypatch.setattr(warp_mod, "fused_cost_volume", kcv.cost_volume_plain)
    monkeypatch.setattr(enerf_mod, "render_rays", krender.render_rays_plain)
    monkeypatch.setattr(depth_mod, "kernel_depth_regression",
                        kdr.depth_regression_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["human", "composite"])
def test_variant_frame_kernel_vs_plain_path(cuda, monkeypatch, variant):
    """The human frame (window mode) and the composite frame at 128x160
    through ``build_model`` / ``render``: their kernel launches, and the
    kernel path vs the plain path (tolerances of ``tests/test_torch_enerf.py``)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import (
        composite_eval_config,
        human_eval_config,
        human_mask,
    )
    from enerf_tpu_torch.datasets.synthetic import make_composite_batch

    Hs, Ws = 128, 160
    if variant == "human":
        cfg = human_eval_config()
        # the mask's rows 17..110 and columns 46..112; origin (32, 16)
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, mask_window_hw=(96, 96)))
        batch = make_synthetic_batch(cfg, H=Hs, W=Ws)
        batch["mask_at_box"] = human_mask(Hs, Ws)
        per_frame = (2, 1, 2)
    else:
        cfg = composite_eval_config()
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, fg_bbox_hw=(64, 64)))
        batch = make_composite_batch(cfg, H=Hs, W=Ws)
        per_frame = (4, 0, 4)
    model = et.build_model(cfg, seed=3)
    counts = lambda: (kcv.launches, krender.launches["render"],  # noqa: E731
                      kdr.launches)
    before = counts()
    out = et.render(model, batch)
    assert tuple(a - b for a, b in zip(counts(), before)) == per_frame
    _plain_path(monkeypatch)
    ref = et.render(model, batch)
    assert set(out) == set(ref)
    for k in out:
        atol = 3e-3 if k.startswith(("depth", "std")) else 3e-4
        torch.testing.assert_close(out[k], ref[k], rtol=1e-3, atol=atol)


def _render_case(cuda, n_src, slots=3, seed=None, cut=0):
    """The level-1 render stage's inputs on grid rays of a synthetic frame,
    the last ``cut`` rays dropped (then no longer a grid)."""
    g = torch.Generator().manual_seed(n_src if seed is None else seed)
    b = _batch(n_src, cuda, slots)
    head = NeRFHead(11)
    init_weights(head, g, kaiming_linear=True)
    head = head.eval().to(cuda)
    Hv, Wv = H // 2, W // 2
    depth = (3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g)).to(cuda)
    std = (0.05 + 0.2 * torch.rand(1, Hv, Wv, generator=g)).to(cuda)
    nf = torch.stack([torch.full((1, Hv, Wv), 2.8),
                      torch.full((1, Hv, Wv), 5.0)], 1).to(cuda)
    rays = build_rays(b["rays_1"], depth, std, nf, False, 2.0, grid=True)
    xyz, uvd, z = sample_along_depth(rays, 2, False)
    uvd = uvd * torch.tensor([1 / (W - 1), 1 / (H - 1), 1.0], device=cuda)
    img = torch.cat([torch.randn(1, slots, H, W, 8, generator=g).to(cuda),
                     unpreprocess(b["src_inps"])], -1).contiguous()
    vol = torch.randn(1, 8, Hv, Wv, 8, generator=g).to(cuda)
    if cut:
        n = xyz.shape[1] - cut
        xyz, uvd, z = (t[:, :n].contiguous() for t in (xyz, uvd, z))
    args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"], b["tar_ext"],
            b["view_mask"], head)
    return args, dict(render_scale=1.0, grid_hw=None if cut else (H, W))


def _check_render(args, kw, kernel="render"):
    """The render kernel vs its plain version (chip_smoke.py's K2_TOL); the
    wrapper counts the one launch under ``kernel`` (``render`` for
    csrc/render.cu, ``render_l0`` for csrc/render_l0.cu), the other none."""
    with torch.no_grad():
        before = dict(krender.launches)
        out = krender.render_rays(*args, **kw)
        assert krender.launches == {k: v + (k == kernel)
                                    for k, v in before.items()}
        plain = krender.render_rays_plain(*args, **kw)
    for k in ("rgb", "depth", "weights"):
        torch.testing.assert_close(out[k], plain[k], rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_src", [3, 2])
def test_render_kernel_matches_plain(cuda, n_src):
    _check_render(*_render_case(cuda, n_src))


@pytest.mark.cuda
@pytest.mark.parametrize("slots,n_src,cut,white", [
    (2, 2, 0, False),      # S = 2
    (4, 4, 0, False),      # S = 4
    (4, 3, 0, False),      # S = 4 with a padded view
    (3, 3, 5, False),      # 6,139 rays: the last warp tile is ragged
    (2, 2, 3, False),
    (3, 3, 0, True),       # white background
    (3, 2, 1, True),
])
def test_render_kernel_views_ragged_white(cuda, slots, n_src, cut, white):
    args, kw = _render_case(cuda, n_src, slots, seed=10 * slots + n_src, cut=cut)
    assert args[3].shape[1] == slots and float(args[8].sum()) == n_src
    assert args[0].shape[1] == H * W - cut
    _check_render(args, dict(kw, white_bkgd=white))


def _render_l0_case(cuda, n_src, slots=3, seed=0, cut=0, cf=35):
    """Level 0's render stage (the head shape of csrc/render_l0.cu: 32 FPN
    channels + rgb, 8 samples in disparity, a 64-plane volume, the image
    features at render scale 1/4) on the grid rays of a (4H, 4W) synthetic
    frame, whose level-0 render frame is (H, W); the last ``cut`` rays
    dropped (then no longer a grid). ``cf``: another channel count, for the
    shape no kernel takes."""
    g = torch.Generator().manual_seed(100 + seed)
    b = _batch(n_src, cuda, slots, hw=(4 * H, 4 * W))
    head = NeRFHead(cf)
    init_weights(head, g, kaiming_linear=True)
    head = head.eval().to(cuda)
    Hv, Wv = H // 2, W // 2
    depth = (1 / (3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g))).to(cuda)
    std = (0.005 + 0.02 * torch.rand(1, Hv, Wv, generator=g)).to(cuda)
    nf = torch.stack([torch.full((1, Hv, Wv), 1 / 2.5),
                      torch.full((1, Hv, Wv), 1 / 5.5)], 1).to(cuda)
    rays = build_rays(b["rays_0"], depth, std, nf, True, 2.0, grid=True)
    xyz, uvd, z = sample_along_depth(rays, 8, True)
    uvd = uvd * torch.tensor([1 / (W - 1), 1 / (H - 1), 1.0], device=cuda)
    img = torch.cat([torch.randn(1, slots, H, W, cf - 3, generator=g).to(cuda),
                     unpreprocess(b["src_inps"], 0.25)], -1).contiguous()
    vol = torch.randn(1, 64, Hv, Wv, 8, generator=g).to(cuda)
    if cut:
        n = xyz.shape[1] - cut
        xyz, uvd, z = (t[:, :n].contiguous() for t in (xyz, uvd, z))
    args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"], b["tar_ext"],
            b["view_mask"], head)
    return args, dict(render_scale=0.25, grid_hw=None if cut else (H, W))


@pytest.mark.cuda
@pytest.mark.parametrize("slots,n_src,cut,white", [
    (3, 3, 0, False),      # S = 3, the default cascade's level 0
    (3, 2, 0, False),      # a padded view
    (2, 2, 0, False),      # S = 2
    (4, 4, 0, False),      # S = 4: the most scratch a warp holds
    (4, 3, 0, False),
    (3, 3, 5, False),      # a ragged ray count, no longer a grid
    (3, 3, 0, True),       # white background
    (3, 3, 1, False),      # an odd ray count: the last tile's second ray is empty
    (3, 3, H * W - 1, False),   # N = 1: one tile, its second ray empty
    (2, 1, 0, False),      # one valid view: var over a single view is 0
])
def test_render_l0_kernel_matches_plain(cuda, slots, n_src, cut, white):
    args, kw = _render_l0_case(cuda, n_src, slots, seed=10 * slots + n_src,
                               cut=cut)
    assert args[3].shape[1] == slots and float(args[8].sum()) == n_src
    assert args[0].shape[1:3] == (H * W - cut, 8)
    _check_render(args, dict(kw, white_bkgd=white), kernel="render_l0")


@pytest.mark.cuda
@pytest.mark.parametrize("slots,valid,cut", [
    (3, (3, 2), 0),        # the second frame with a padded view
    (4, (4, 2), 3),        # S = 4 and an odd ray count: a tile never holds
                           # two frames' rays, so each frame's last tile
                           # has an empty second ray
])
def test_render_l0_kernel_batch_of_two(cuda, slots, valid, cut):
    """Two frames in one call with different counts of valid views: each
    ray reads its own frame's cameras, view mask, images and volume."""
    a, kw = _render_l0_case(cuda, valid[0], slots, seed=1, cut=cut)
    b, _ = _render_l0_case(cuda, valid[1], slots, seed=2, cut=cut)
    args = tuple(torch.cat([x, y]).contiguous() for x, y in zip(a[:9], b[:9]))
    assert args[8].tolist() == [[1] * v + [0] * (slots - v) for v in valid]
    assert args[0].shape[:2] == (2, H * W - cut)
    _check_render(args + (a[9],), kw, kernel="render_l0")


@pytest.mark.cuda
def test_render_kernel_refuses_other_head_shapes(cuda):
    """A head shape no kernel is built for (19 image channels, 8 samples)
    raises on the card, and launches nothing: there is no plain fallback
    there."""
    args, kw = _render_l0_case(cuda, 3, cf=19)
    before = dict(krender.launches)
    with torch.no_grad(), pytest.raises(ValueError, match="built for"):
        krender.render_rays(*args, **kw)
    assert krender.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["dtu_pretrain", "human_train"])
def test_both_levels_frame_kernel_vs_plain_path(cuda, monkeypatch, variant):
    """Both levels rendered through the kernels at 128x160: the port's
    default cascade (``Config()``, dtu_pretrain's: planes (64, 8), samples
    (8, 2), grid rays) and ``ENeRFHuman`` at zjumocap_train.yaml's cascade
    (render_if (True, True), planes (32, 8), 2 views, the mask window on
    level 1); each level's render launches its kernel once, and the kernel
    path matches the plain path (the tolerances of
    ``test_variant_frame_kernel_vs_plain_path``)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import Config, human_eval_config, human_mask

    Hs, Ws = 128, 160
    if variant == "dtu_pretrain":
        cfg = Config()
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, grid_rays=True))
        batch = make_synthetic_batch(cfg, H=Hs, W=Ws)
    else:
        cfg = human_eval_config()
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, mask_window_hw=(96, 96),
            cas_config=dataclasses.replace(cfg.enerf.cas_config,
                                           render_if=(True, True))))
        batch = make_synthetic_batch(cfg, H=Hs, W=Ws)
        batch["mask_at_box"] = human_mask(Hs, Ws)
    batch.pop("tar_img")
    model = et.build_model(cfg, seed=4)
    counts = lambda: (kcv.launches, krender.launches["render"],  # noqa: E731
                      krender.launches["render_l0"], kdr.launches)
    before = counts()
    out = et.render(model, batch)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 1, 1, 2)
    assert {k.rsplit("_level", 1)[1] for k in out} == {"0", "1"}
    _plain_path(monkeypatch)
    ref = et.render(model, batch)
    assert set(out) == set(ref)
    for k in out:
        atol = 3e-3 if k.startswith(("depth", "std")) else 3e-4
        torch.testing.assert_close(out[k], ref[k], rtol=1e-3, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("depth_inv", [True, False])
def test_depth_regression_kernel_matches_plain(cuda, depth_inv):
    g = torch.Generator().manual_seed(7)
    logits = (2.0 * torch.randn(2, 16, 12, 20, generator=g)).to(cuda)
    values = torch.sort(2.0 + 4.0 * torch.rand(2, 16, 12, 20, generator=g),
                        dim=1).values.to(cuda)
    before = kdr.launches
    out = kdr.depth_regression(logits, values, depth_inv)
    assert kdr.launches == before + 1
    plain = kdr.depth_regression_plain(logits, values, depth_inv)
    for o, p in zip(out, plain):
        torch.testing.assert_close(o, p, rtol=1e-4, atol=1e-6)
    grads = []
    for fn in (kdr.depth_regression, kdr.depth_regression_plain):
        lt, vt = logits.clone().requires_grad_(), values.clone().requires_grad_()
        d, s = fn(lt, vt, depth_inv)
        grads.append(torch.autograd.grad((d * 1.3 + s * 0.7).sum(), (lt, vt)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# bfloat16 inputs: outputs rounded to bfloat16 (tests/test_pallas.py's
# bf16 tolerances)
_K4_TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-6),) * 2,
           torch.bfloat16: (dict(rtol=1e-2, atol=0.0), dict(rtol=2e-2, atol=1e-3))}


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,Hv,Wv,dtype,depth_inv", [
    (1, 5, 7, 13, torch.float32, False),    # 91 pixels: a ragged last block
    (2, 64, 8, 10, torch.float32, True),    # a batch of 2
    (1, 300, 3, 11, torch.float32, False),  # past 32 groups: chunks a thread
    (1, 1, 5, 9, torch.float32, True),      # one plane: 1 a thread
    (2, 2, 5, 7, torch.float32, True),      # 2 planes a thread
    (1, 3, 9, 7, torch.bfloat16, False),    # 4 planes a thread, one masked
    (1, 48, 8, 10, torch.bfloat16, True),
    (1, 8, 16, 20, torch.bfloat16, False),
])
def test_depth_regression_kernel_shapes_and_bf16(cuda, B, D, Hv, Wv, dtype,
                                                 depth_inv):
    """Ragged pixel counts, a batch, plane counts from 1 to past the
    largest block (every planes-per-thread template), bfloat16 inputs and
    outputs; forward and gradient."""
    g = torch.Generator().manual_seed(D)
    logits = (2.0 * torch.randn(B, D, Hv, Wv, generator=g)).to(cuda, dtype)
    values = torch.sort(2.0 + 4.0 * torch.rand(B, D, Hv, Wv, generator=g),
                        dim=1).values.to(cuda, dtype)
    tol_d, tol_s = _K4_TOL[dtype]
    plain = kdr.depth_regression_plain(logits, values, depth_inv)
    before = kdr.launches
    out = kdr.depth_regression(logits, values, depth_inv)
    assert kdr.launches == before + 1
    assert out[0].dtype == out[1].dtype == dtype
    torch.testing.assert_close(out[0], plain[0], **tol_d)
    torch.testing.assert_close(out[1], plain[1], **tol_s)
    grads = []
    for fn in (kdr.depth_regression, kdr.depth_regression_plain):
        lt, vt = logits.clone().requires_grad_(), values.clone().requires_grad_()
        d, s = fn(lt, vt, depth_inv)
        grads.append(torch.autograd.grad((d * 1.3 + s * 0.7).sum(), (lt, vt)))
    for a, b in zip(*grads):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, **tol_s)


# --- the bf16 variants (compute_dtype: bfloat16) ---------------------------

# K1 in bf16: the kernel and the plain version each round an f32 variance
# once; the f32 values differ as K1's f32 ones do (grid_sample's normalized
# coordinates, chip_smoke.py's K1_TOL atol), so a rounding may fall on
# either side: one bf16 ulp (at most 2^-7 of the value) beside that atol
_K1_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("level,n_src,window", [
    (0, 3, None), (1, 3, None), (1, 2, None),
    (1, 3, ([(40, 20)], (16, 24))),         # crop mode, across the edges
    (0, 2, ([(-3, 2)], (5, 7))),            # a negative origin, ragged
])
def test_cost_volume_bf16_kernel_matches_plain(cuda, level, n_src, window):
    """K1's bf16 variant (bf16 features, f32 planes and cameras, a bf16
    volume), full frame and crop mode, vs the plain version on the same
    bf16 features; counted in ``launches_bf16`` only."""
    g = torch.Generator().manual_seed(30 + level + n_src)
    b = _batch(n_src, cuda)
    C, s, vs, D = ((32, 0.25, 0.125, 48), (16, 0.5, 0.5, 8))[level]
    feats = torch.randn(1, 3, int(H * s), int(W * s), C, generator=g).to(
        cuda, torch.bfloat16)
    projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                          b["tar_ixt"], src_scale=s, tar_scale=vs)
    dv, _ = init_depth_values(b["near_far"], D, int(H * vs), int(W * vs),
                              level == 0)
    kw = {}
    if window is not None:
        kw["window"] = (torch.tensor(window[0], dtype=torch.int32).to(cuda),
                        window[1])
    args = (feats, projs, dv, b["view_mask"])
    before = (kcv.launches, kcv.launches_bf16)
    out = kcv.fused_cost_volume(*args, **kw)
    assert (kcv.launches, kcv.launches_bf16) == (before[0], before[1] + 1)
    ref = kcv.cost_volume_plain(*args, **kw)
    assert out.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), **_K1_BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("level,n_src", [(1, 3), (1, 2), (0, 3), (0, 2)])
def test_render_bf16_volume_kernel_matches_plain(cuda, level, n_src):
    """K2's and K2-L0's bf16-volume variants vs the plain version on the
    same bf16 volume (both turn it into f32: K2_TOL, as in f32); counted in
    ``launches_bf16`` only."""
    args, kw = (_render_case(cuda, n_src) if level == 1
                else _render_l0_case(cuda, n_src, seed=7))
    args = (*args[:4], args[4].to(torch.bfloat16), *args[5:])
    kernel = "render" if level == 1 else "render_l0"
    with torch.no_grad():
        before = dict(krender.launches), dict(krender.launches_bf16)
        out = krender.render_rays(*args, **kw)
        assert krender.launches == before[0]
        assert krender.launches_bf16 == {k: v + (k == kernel)
                                         for k, v in before[1].items()}
        plain = krender.render_rays_plain(*args, **kw)
    for k in ("rgb", "depth", "weights"):
        assert out[k].dtype == torch.float32
        torch.testing.assert_close(out[k], plain[k], rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,Hv,Wv,depth_inv", [
    (1, 48, 16, 20, True),     # level 0's planes
    (1, 8, 64, 96, False),     # level 1's
    (2, 5, 7, 13, False),      # a batch, a ragged pixel count
])
def test_depth_regression_mixed_kernel_matches_plain(cuda, B, D, Hv, Wv,
                                                     depth_inv):
    """K4's mixed variant: bf16 logits, f32 plane values, f32 depth and
    std, read without a cast on the host; forward and gradient vs the
    plain version at the f32 tolerance (both compute in f32 from the same
    values); counted in ``launches_mixed`` only."""
    g = torch.Generator().manual_seed(40 + D)
    logits = (2.0 * torch.randn(B, D, Hv, Wv, generator=g)).to(
        cuda, torch.bfloat16)
    values = torch.sort(2.0 + 4.0 * torch.rand(B, D, Hv, Wv, generator=g),
                        dim=1).values.to(cuda)
    before = (kdr.launches, kdr.launches_mixed)
    out = kdr.depth_regression(logits, values, depth_inv)
    assert (kdr.launches, kdr.launches_mixed) == (before[0], before[1] + 1)
    plain = kdr.depth_regression_plain(logits, values, depth_inv)
    for o, p in zip(out, plain):
        assert o.dtype == p.dtype == torch.float32
        torch.testing.assert_close(o, p, rtol=1e-4, atol=1e-6)
    grads = []
    for fn in (kdr.depth_regression, kdr.depth_regression_plain):
        lt, vt = logits.clone().requires_grad_(), values.clone().requires_grad_()
        d, s = fn(lt, vt, depth_inv)
        grads.append(torch.autograd.grad((d * 1.3 + s * 0.7).sum(), (lt, vt)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-6)


@pytest.mark.cuda
def test_kernels_refuse_types_no_variant_takes(cuda):
    """On the card a type no variant takes raises, launches nothing and
    does not fall back: float16 features (K1) and volume (K2); f32 logits
    with bf16 values and float16 logits (K4)."""
    b = _batch(3, cuda)
    projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                          b["tar_ixt"], src_scale=0.5, tar_scale=0.5)
    dv, _ = init_depth_values(b["near_far"], 8, H // 2, W // 2, False)
    feats = torch.randn(1, 3, H // 2, W // 2, 16, device=cuda)
    counts = lambda: (kcv.launches, kcv.launches_bf16,  # noqa: E731
                      dict(krender.launches), dict(krender.launches_bf16),
                      kdr.launches, kdr.launches_mixed)
    before = counts()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kcv.fused_cost_volume(feats.half(), projs, dv, b["view_mask"])
    args, kw = _render_case(cuda, 3)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        krender.render_rays(*args[:4], args[4].half(), *args[5:], **kw)
    logits = torch.randn(1, 8, 4, 6, device=cuda)
    for lt, vt in ((logits, dv[:, :, :4, :6].contiguous().bfloat16()),
                   (logits.half(), dv[:, :, :4, :6].contiguous())):
        with pytest.raises(ValueError, match="takes"):
            kdr.depth_regression(lt, vt, False)
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["dtu", "human", "composite"])
def test_bf16_frame_kernel_vs_plain_path(cuda, monkeypatch, variant):
    """A frame in the bf16 mode at 128x160 through ``build_model`` /
    ``render``: it launches the bf16 variants only (K1-bf16, K2-bf16,
    K4-mixed), and matches the bf16 plain path (tolerances of
    ``tests/test_torch_enerf.py`` doubled: the variance and the 3D CNN
    round to bf16, so a kernel's f32 reassociation may flip a rounding)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import (
        composite_eval_config,
        human_eval_config,
        human_mask,
    )
    from enerf_tpu_torch.datasets.synthetic import make_composite_batch

    Hs, Ws = 128, 160
    if variant == "dtu":
        cfg = dtu_eval_config()
        batch = make_synthetic_batch(cfg, H=Hs, W=Ws)
        per_frame = (2, 1, 2)
    elif variant == "human":
        cfg = human_eval_config()
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, mask_window_hw=(96, 96)))
        batch = make_synthetic_batch(cfg, H=Hs, W=Ws)
        batch["mask_at_box"] = human_mask(Hs, Ws)
        per_frame = (2, 1, 2)
    else:
        cfg = composite_eval_config()
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, fg_bbox_hw=(64, 64)))
        batch = make_composite_batch(cfg, H=Hs, W=Ws)
        per_frame = (4, 0, 4)
    model = et.build_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           seed=3)
    f32_counts = lambda: (kcv.launches, krender.launches["render"],  # noqa: E731
                          kdr.launches)
    counts = lambda: (kcv.launches_bf16,  # noqa: E731
                      krender.launches_bf16["render"], kdr.launches_mixed)
    before, before32 = counts(), f32_counts()
    out = et.render(model, batch)
    assert tuple(a - b for a, b in zip(counts(), before)) == per_frame
    assert f32_counts() == before32
    _plain_path(monkeypatch)
    ref = et.render(model, batch)
    assert set(out) == set(ref)
    for k in out:
        assert out[k].dtype == torch.float32
        atol = 6e-3 if k.startswith(("depth", "std")) else 6e-4
        torch.testing.assert_close(out[k], ref[k], rtol=2e-3, atol=atol)


@pytest.mark.cuda
def test_train_step_on_card(cuda):
    """One train step of the two-level cascade at 64x96 on the card: the
    depth-regression kernel twice, the cost volume and render kernels not
    at all (training runs their plain versions), and the same loss as the
    same step on the CPU (rtol 1e-4: cuDNN and the CPU sum in other
    orders)."""
    import copy

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import CascadeConfig, Config, ENeRFConfig
    from enerf_tpu_torch.train import create_train_state, make_train_step

    cfg = Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True,
        cas_config=CascadeConfig(num=2, volume_planes=(64, 8))))
    batch = make_synthetic_batch(cfg, H=H, W=W, split="train")
    batch.pop("tar_img")
    model = et.build_model(cfg, seed=0, train=True)
    cpu_model = copy.deepcopy(model).cpu()
    p0 = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(cfg, (H, W))
    before = (kcv.launches, dict(krender.launches), kdr.launches)
    _, stats = step(create_train_state(cfg, model), batch)
    assert (kcv.launches, krender.launches, kdr.launches) == (
        before[0], before[1], before[2] + 2)
    assert torch.isfinite(stats["loss"])
    assert any(not torch.equal(a, b) for a, b in zip(p0, model.parameters()))
    _, cpu_stats = step(create_train_state(cfg, cpu_model), batch)
    torch.testing.assert_close(stats["loss"].cpu(), cpu_stats["loss"],
                               rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_run_cli_on_card_matches_cpu(cuda, tmp_path):
    """``python -m enerf_tpu_torch.run --type evaluate`` over
    ``configs/enerf/synthetic_smoke.yaml`` (4 frames at 64x96, both levels
    rendered) on the card: K1 2, K4 2, ``render`` 1 and ``render_l0`` 1
    launches a frame, and the first frame's outputs and the metrics as the
    same command gives on the CPU (the tolerances of
    ``test_both_levels_frame_kernel_vs_plain_path``; PSNR to 0.01 dB)."""
    from pathlib import Path

    from enerf_tpu_torch.run import main

    smoke = str(Path(__file__).resolve().parents[1]
                / "configs" / "enerf" / "synthetic_smoke.yaml")
    args = ["--type", "evaluate", "--cfg_file", smoke,
            "workspace", str(tmp_path)]
    counts = lambda: (kcv.launches, krender.launches["render"],  # noqa: E731
                      krender.launches["render_l0"], kdr.launches)
    before = counts()
    card = main(args)
    assert tuple(a - b for a, b in zip(counts(), before)) == (8, 4, 4, 8)
    assert card["timer"] == "cuda events" and card["frames"] == 4
    cpu = main(["--device", "cpu", *args])
    assert set(card["first_out"]) == set(cpu["first_out"])
    for k, v in card["first_out"].items():
        atol = 3e-3 if k.startswith(("depth", "std")) else 3e-4
        torch.testing.assert_close(torch.from_numpy(v),
                                   torch.from_numpy(cpu["first_out"][k]),
                                   rtol=1e-3, atol=atol)
    assert abs(card["metrics"]["psnr"] - cpu["metrics"]["psnr"]) < 1e-2
    assert abs(card["metrics"]["ssim"] - cpu["metrics"]["ssim"]) < 1e-3


@pytest.mark.cuda
def test_spans_on_card(cuda):
    """The program's spans on the card: ``record(device=True)`` times each
    stage by its CUDA events (read after a synchronize), the stages within
    ``render``; in a profiler session each span is a host range and no
    device record (the card's trace holds the kernels alone)."""
    import enerf_tpu_torch as et
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from enerf_tpu_torch.utils import profiling

    cfg = dtu_eval_config()
    model = et.build_model(cfg, device=cuda)
    batch = make_synthetic_batch(cfg, H, W)
    et.render(model, batch)
    hooks = []
    with profiling.record(device=True) as rec:
        et.render(model, batch, stage_hook=hooks.append)
    torch.cuda.synchronize()
    summary = rec.summary()
    assert set(summary) == {"render", *hooks} and len(hooks) == 8
    assert all(v["count"] == 1 and v["device_ms"] > 0 for v in summary.values())
    assert rec.device_ms("render")[0] >= max(summary[h]["device_ms"]
                                             for h in hooks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        et.render(model, batch)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    dev = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    assert {"enerf.render", *("enerf." + h for h in hooks)} <= host
    assert dev and not [n for n in dev if n.startswith("enerf.")]

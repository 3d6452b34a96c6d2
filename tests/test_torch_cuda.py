"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Each test skips without a CUDA device (a hand-written kernel has no CPU
mode). This file imports neither JAX nor the JAX package, so on a machine
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


def _batch(n_src, device, slots=3):
    """A synthetic eval batch with ``slots`` source-view slots, the first
    ``n_src`` of them real."""
    cfg = dtu_eval_config()
    cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
        cfg.enerf, test_input_views=slots, train_input_views=(slots,)))
    b = make_synthetic_batch(cfg, H=H, W=W, n_src=n_src)
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


def _check_render(args, kw):
    with torch.no_grad():
        before = krender.launches
        out = krender.render_rays(*args, **kw)
        assert krender.launches == before + 1
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
    before = (kcv.launches, krender.launches, kdr.launches)
    _, stats = step(create_train_state(cfg, model), batch)
    assert (kcv.launches, krender.launches, kdr.launches) == (
        before[0], before[1], before[2] + 2)
    assert torch.isfinite(stats["loss"])
    assert any(not torch.equal(a, b) for a, b in zip(p0, model.parameters()))
    _, cpu_stats = step(create_train_state(cfg, cpu_model), batch)
    torch.testing.assert_close(stats["loss"].cpu(), cpu_stats["loss"],
                               rtol=1e-4, atol=0.0)

"""The plain reference against the port's CPU path (its plain PyTorch
versions of every kernel) at small sizes, and the benchmark's FLOP counts
against ``FlopCounterMode`` run on the reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import compare, harness, scene
from benchmark import work as counts
from benchmark.loops import train as train_loop
from benchmark.reference import enerf as ref
from conftest import small

SEED = 3141592653589


def _run(workload, **traffic):
    return harness.Run(small(workload, **traffic), SEED, "cpu")


@pytest.mark.parametrize("workload", ["dtu_stream", "zjumocap_stream"])
def test_reference_matches_the_port_frame(workload):
    import enerf_tpu_torch as et

    run = _run(workload)
    model = run.build_model(train=False)
    frames = scene.make_frames(run.config, run.traffic, run.seed, run.device, 2)
    cas = run.cascade(False)
    level = cas["num"] - 1
    human = workload.startswith("zjumocap")
    for f in frames:
        out = et.render(model, f)
        got = {k: out[f"{k}_level{level}"] for k in compare.RENDER_KEYS}
        want = compare.reference_frame(run.weights(False), cas, f, human, level)
        gaps = compare.render_gaps(got, want, f)
        assert max(gaps.values()) < 1e-4, gaps
        if human:
            outside = f["mask_at_box"][0] == 0
            assert bool(outside.any()) and bool((got["rgb"][0][outside] == 0).all())


def test_reference_matches_the_port_train_step():
    run = _run("dtu_train", checked_steps=1)
    st = train_loop.setup(run)
    ex = st.extra
    r_losses, r_grads, r_after, r_stats = ref.train_steps(
        run.weights(True), run.cascade(True), train_loop._opt(run), st.batches[:1])
    assert abs(float(ex["losses"][0]) - r_losses[0]) <= 1e-5 * r_losses[0]
    nums = compare.train_numbers([float(x) for x in ex["losses"]], ex["grads"],
                                 ex["start"], ex["after"], r_losses, r_grads, r_after,
                                 ex["stats"], r_stats)
    assert nums["bn_stats_rel"] < 1e-4, nums
    # the gradient reaches the level-0 weights through the warp's and the
    # samplers' coordinates, whose bilinear slope jumps at whole pixels:
    # coordinates 1e-6 px apart on the two sides take the other slope now
    # and then, which at this size moves a small leaf's norm by up to ~1 %
    assert nums["grad_norm_gap"] < 2e-2, nums


def _counted(fn):
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    by_op = mode.get_flop_counts()["Global"]
    return sum(v for op, v in by_op.items()
               if any(n in str(op) for n in ("convolution", "addmm", ".mm")))


@pytest.mark.parametrize("workload", ["dtu_stream", "zjumocap_stream"])
def test_frame_flops_match_flop_counter(workload):
    run = _run(workload)
    cas = run.cascade(False)
    f = scene.make_frames(run.config, run.traffic, run.seed, run.device, 1)[0]
    params, stats = ref.split_state(run.weights(False))
    human = workload.startswith("zjumocap")
    level = cas["num"] - 1
    rays = float(f["mask_at_box"].sum()) if human else float(f[f"rays_{level}"].shape[1])
    H, W = run.config["image_hw"]
    with torch.no_grad():
        got = _counted(lambda: ref.forward(params, stats, cas, f, mask_rays=human))
    assert got == counts.frame_flops(cas, H, W, run.config["source_views"], {level: rays})


def test_step_flops_match_flop_counter():
    run = _run("dtu_train")
    cas = run.cascade(True)
    b = scene.make_frames(run.config, run.traffic, run.seed, run.device, 1, train=True)[0]
    params, stats = ref.split_state(run.weights(True))

    def step():
        loss = ref.loss_fn(ref.forward(params, stats, cas, b, train=True), b, cas)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    H, W = run.config["image_hw"]
    rays = {i: float(b[f"rays_{i}"].shape[1]) for i in range(cas["num"])}
    assert _counted(step) == counts.step_flops(cas, H, W, run.config["train_source_views"],
                                               rays)


def test_published_counts_at_the_cells_shapes():
    """K2 at the DTU frame is 18.6 GFLOP counted once (PERF's three-pass
    bound ÷ 3) and K1's footprint 0.0300 ms at 3.35 TB/s."""
    cas = {"num": 2, "depth_inv": [True, False], "volume_scale": [0.125, 0.5],
           "volume_planes": [48, 8], "im_feat_scale": [0.25, 0.5],
           "im_ibr_scale": [0.25, 1.0], "render_scale": [0.25, 1.0],
           "render_im_feat_level": [0, 2], "nerf_model_feat_ch": [32, 8],
           "render_if": [False, True], "num_samples": [8, 2]}
    assert counts.head_macs(11, 3) == (2156, 7744)
    k2 = counts.render_flops(cas, 1, 3, 512 * 640)
    assert abs(k2 - 2 * (3 * 2156 + 7744 + counts.COMPOSITE_MACS) * 2 * 327680) < 1
    assert abs(k2 / 1e9 - 18.6) < 0.1
    t = counts.cost_volume_bytes(cas, 512, 640, 3) / counts.PEAKS["hbm_bytes_per_s"]
    assert abs(t * 1e3 - 0.0300) < 0.0005

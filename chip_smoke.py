#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``enerf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases, each printing one JSON line:
  device   the card's name and its nvidia-smi name / power limit
  build    every CUDA kernel built from csrc/*.cu (one nvcc each, in parallel)
  k1       the cost-volume kernel vs its plain PyTorch version at both
           cascade levels of the 512x640 DTU frame, with a padded view, and
           on a level-0 grid cut to 63x79 (a ragged last block); its time
           by CUDA events around one call, over a run of calls, and on the
           device alone (torch.profiler)
  k2       the render kernel vs its plain version at 327,680 rays, n=2:
           S=3, a padded view, S=2, S=4, a ray count that leaves a ragged
           warp tile, and a white background; times as for k1
  frames   the DTU eval forward (512x640, 3 source views, volume planes
           (48, 8), render_if (False, True), grid rays, seeded random
           weights) through ``build_model`` / ``render``: per-frame and
           per-stage ms, kernel launch counts, the kernel path vs the plain
           path on the card, and the card vs the CPU on a small frame
  profile  torch.profiler over two frames: device busy time, idle share,
           the kernels that take the most device time
  k4       the depth-regression kernel vs its plain version, forward and
           gradient, at the train shapes of both cascade levels and the
           eval level-0 shape
  train    the train step of ``tools/bench_train.py``'s workload (512x640,
           3 source views, volume planes (64, 8), both levels rendering
           the full image on grid rays, MSE, Adam, seeded random weights)
           through ``build_model(train=True)`` / ``make_train_step``: step
           times and their forward / backward / optimizer split, peak
           memory, the loss of every step, kernel launch counts; one step
           with seeded random VGG16 weights (the perceptual term); a
           128x160 step on the card vs the same step on the CPU
  train_profile  torch.profiler over two train steps
then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the last line. Float32 throughout, TF32 off.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 512, 640
N_FRAMES = 3          # the main-path run whose launches are counted
TIMED_FRAMES = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
TF32_PASSES = 3                # K2 splits every f32 product in three
# K1: the plain version samples through grid_sample's normalized
# coordinates, whose round trip moves a point by ~3e-5 px at level 1; over
# the unit-gradient random features used here that moves a variance by up
# to a few 1e-4
K1_TOL = dict(rtol=1e-4, atol=1e-3)
K2_TOL = dict(rtol=1e-4, atol=2e-4)
E2E_ATOL = {"rgb_level1": 3e-4, "weights_level1": 3e-4, "depth_level1": 3e-3,
            "depth_mvs_level1": 3e-3, "std_level1": 3e-3}
E2E_RTOL = 1e-3
# K4: the kernel sums Σe·v / Σe in plane order, the plain version
# softmax-then-sum in torch's reduction order (f32, 8-64 terms)
K4_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_WARMUP = 2
TRAIN_STEPS = 10      # timed steps of the train main path
# the card vs the CPU on a small train step: f32 with TF32 off on both, but
# cuDNN's and the CPU's convolutions and the reductions sum in other orders.
# 128x160, not smaller: at 64x96 the gradient of the first FPN layer's BN
# scale is a sum over few pixels that cancels so far that f32 rounding
# alone (on the CPU as on the card) can turn it by more than the limit.
TRAIN_SMALL_HW = (128, 160)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_COS = 0.999


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> dict:
    """Median / min / max of ``reps`` calls, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def run_ms(torch, fn, n: int = 50, warmup: int = 3) -> float:
    """CUDA events around ``n`` calls back to back, over ``n``: the host
    work of a call hides behind the device work of the one before."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def max_err(torch, out, ref, rtol, atol, what):
    """Max abs error of ``out`` vs ``ref``; fails past atol + rtol |ref|."""
    if out.shape != ref.shape:
        fail(f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail(f"{what}: non-finite values")
    diff = (out - ref).abs()
    bad = diff > atol + rtol * ref.abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} elements past rtol {rtol} atol "
             f"{atol}, max abs err {float(diff.max())}")
    return float(diff.max())


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi_line


def phase_build():
    from enerf_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load_library(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.BUILD_LOGS.items()}
    emit("build", seconds=time.perf_counter() - t0, kernels=list(_build.KERNELS),
         built_now=sorted(_build.BUILD_LOGS), ptxas=ptxas)


def _synthetic(cfg, n_src, slots=None):
    """The 512x640 synthetic batch with ``slots`` source-view slots (the
    config's by default), the first ``n_src`` real."""
    import dataclasses

    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch

    if slots is not None:
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, test_input_views=slots, train_input_views=(slots,)))
    batch = make_synthetic_batch(cfg, H=H, W=W, n_src=n_src)
    batch.pop("tar_img")
    return batch


def phase_k1(torch, cfg):
    """Cost-volume kernel vs plain at the two level shapes of the frame,
    with a padded view, and on a ragged level-0 grid."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.ops.camera import get_proj_mats
    from enerf_tpu_torch.ops.depth import init_depth_values
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv

    g = torch.Generator().manual_seed(1)
    cas = cfg.enerf.cas_config
    cases = []
    for name, level, n_src, cut in (("level0", 0, 3, 0), ("level1", 1, 3, 0),
                                    ("level1_padded_view", 1, 2, 0),
                                    ("level0_ragged", 0, 3, 1)):
        b = et.to_device(_synthetic(cfg, n_src), "cuda")
        C = (32, 16)[level]
        s = cas.im_feat_scale[level]
        feats = torch.randn(1, 3, int(H * s), int(W * s), C, generator=g).cuda()
        projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                              b["tar_ixt"], src_scale=s,
                              tar_scale=cas.volume_scale[level])
        Hv = int(H * cas.volume_scale[level]) - cut
        Wv = int(W * cas.volume_scale[level]) - cut
        if level == 0:
            dv, _ = init_depth_values(b["near_far"], cas.volume_planes[0], Hv,
                                      Wv, True)
        else:  # per-pixel planes in a band around the surface, as level 1 has
            near = 3.0 + 0.6 * torch.rand(1, 1, Hv, Wv, generator=g)
            band = 0.2 + 0.4 * torch.rand(1, 1, Hv, Wv, generator=g)
            lin = torch.linspace(0, 1, cas.volume_planes[1])[None, :, None, None]
            dv = (near + lin * band).cuda()
        vm = b["view_mask"]
        args = (feats, projs, dv.contiguous(), vm)
        plain = kcv.cost_volume_plain(*args)
        out = kcv.fused_cost_volume(*args)
        torch.cuda.synchronize()
        err = max_err(torch, out, plain, what=f"k1 {name}", **K1_TOL)
        call = lambda: kcv.fused_cost_volume(*args)  # noqa: E731
        t_k = time_ms(torch, call)
        t_run = run_ms(torch, call)
        t_dev = device_kernel_ms(torch, call, "cost_volume_kernel")
        t_p = time_ms(torch, lambda: kcv.cost_volume_plain(*args))
        n_valid = float(vm.sum())
        n_vox = out.numel() // C
        flops = n_vox * (n_valid * (8 * C + 24) + 3 * C)
        bd, by = bound_ms(nbytes(feats, projs, dv, vm, out), flops)
        case = dict(case=name, shape=list(out.shape), views_valid=n_valid,
                    max_abs_err=err, tol=K1_TOL, ms=t_k, run_ms=t_run,
                    device_ms=t_dev, plain_ms=t_p, bound_ms=bd, bound_by=by,
                    bytes=nbytes(feats, projs, dv, vm, out), flops=flops)
        emit("k1", **case)
        cases.append(case)
    return cases


def phase_k2(torch, cfg):
    """Render kernel vs plain at the full 512x640 ray grid: S = 3, a
    padded view, S = 2 and 4, a ragged last warp tile (the last 5 rays
    dropped, so no longer a grid), a white background."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.models.nerf_head import NeRFHead
    from enerf_tpu_torch.models.layers import init_weights
    from enerf_tpu_torch.ops.ibr import unpreprocess
    from enerf_tpu_torch.ops.kernels import render as krender
    from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth

    g = torch.Generator().manual_seed(2)
    head = NeRFHead(11)
    init_weights(head, g, kaiming_linear=True)
    head = head.eval().cuda()
    cases = []
    for name, slots, n_src, cut, white in (
            ("full_frame", 3, 3, 0, False),
            ("full_frame_padded_view", 3, 2, 0, False),
            ("s2", 2, 2, 0, False), ("s4", 4, 4, 0, False),
            ("ragged_tile", 3, 3, 5, False), ("white_bkgd", 3, 3, 0, True)):
        b = et.to_device(_synthetic(cfg, n_src, slots), "cuda")
        Hv, Wv = H // 2, W // 2
        depth = (3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g)).cuda()
        std = (0.05 + 0.2 * torch.rand(1, Hv, Wv, generator=g)).cuda()
        nf = torch.stack([torch.full((1, Hv, Wv), 2.8),
                          torch.full((1, Hv, Wv), 5.0)], 1).cuda()
        rays = build_rays(b["rays_1"], depth, std, nf, False, 2.0, grid=True)
        xyz, uvd, z = sample_along_depth(rays, 2, False)
        uvd = uvd * torch.tensor([1 / (W - 1), 1 / (H - 1), 1.0], device="cuda")
        img = torch.cat([torch.randn(1, slots, H, W, 8, generator=g).cuda(),
                         unpreprocess(b["src_inps"])], -1).contiguous()
        vol = torch.randn(1, 8, Hv, Wv, 8, generator=g).cuda()
        if cut:
            n = xyz.shape[1] - cut
            xyz, uvd, z = (t[:, :n].contiguous() for t in (xyz, uvd, z))
        args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"],
                b["tar_ext"], b["view_mask"], head)
        kw = dict(render_scale=1.0, grid_hw=None if cut else (H, W),
                  white_bkgd=white)
        with torch.inference_mode():
            plain = krender.render_rays_plain(*args, **kw)
            out = krender.render_rays(*args, **kw)
            torch.cuda.synchronize()
            err = max(max_err(torch, out[k], plain[k], what=f"k2 {name} {k}",
                              **K2_TOL) for k in ("rgb", "depth", "weights"))
            call = lambda: krender.render_rays(*args, **kw)  # noqa: E731
            t_k = time_ms(torch, call)
            t_run = run_ms(torch, call, n=20)
            t_dev = device_kernel_ms(torch, call, "render_kernel")
            t_p = time_ms(torch, lambda: krender.render_rays_plain(*args, **kw),
                          reps=5, warmup=1)
        n_valid = float(b["view_mask"].sum())
        samples = xyz.shape[1] * xyz.shape[2]
        # multiply-adds per sample: per valid view view_fc, global_fc,
        # agg_w_fc and color_0's 15 per-view inputs + color_2; once fc, lr0,
        # sigma and color_0's 88 shared inputs
        per_view = 4 * 11 + 33 * 32 + 32 + 15 * 64 + 64
        macs = int(n_valid) * per_view + 32 * 16 + 24 * 64 + 64 + 88 * 64
        flops = 2.0 * macs * samples
        io = nbytes(xyz, uvd, z, img, vol, out["rgb"], out["depth"],
                    out["weights"])
        # the kernel's route: its products in three TF32 passes on the
        # tensor cores; beside it the f32 CUDA-core bound of PRs 1-2
        bd, by = bound_ms(io, TF32_PASSES * flops, TF32_FLOPS_PER_S)
        bd_f32, by_f32 = bound_ms(io, flops)
        case = dict(case=name, slots=slots, rays=xyz.shape[1],
                    views_valid=n_valid, white_bkgd=white, max_abs_err=err,
                    tol=K2_TOL, ms=t_k, run_ms=t_run, device_ms=t_dev,
                    plain_ms=t_p, bound_ms=bd, bound_by=by,
                    bound_f32_ms=bd_f32, bound_f32_by=by_f32, bytes=io,
                    flops=flops, macs_per_sample=macs)
        emit("k2", **case)
        cases.append(case)
    return cases


class StageTimer:
    """CUDA events at the model's stage boundaries (``stage_hook``)."""

    def __init__(self, torch):
        self.torch = torch
        self.marks = []

    def start(self):
        self.marks = [("start", self._event())]

    def _event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __call__(self, name):
        self.marks.append((name, self._event()))

    def stages_ms(self):
        self.marks[-1][1].synchronize()
        return {name: prev.elapsed_time(ev) for (_, prev), (name, ev)
                in zip(self.marks, self.marks[1:])}

    def total_ms(self):
        self.marks[-1][1].synchronize()
        return self.marks[0][1].elapsed_time(self.marks[-1][1])


@contextlib.contextmanager
def plain_path():
    """The same forward with each kernel wrapper swapped for its plain
    version (for the on-card comparison only)."""
    import enerf_tpu_torch.models.enerf as enerf_mod
    import enerf_tpu_torch.ops.depth as depth_mod
    import enerf_tpu_torch.ops.warp as warp_mod
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender

    saved = (warp_mod.fused_cost_volume, enerf_mod.render_rays,
             depth_mod.kernel_depth_regression)
    warp_mod.fused_cost_volume = kcv.cost_volume_plain
    enerf_mod.render_rays = krender.render_rays_plain
    depth_mod.kernel_depth_regression = kdr.depth_regression_plain
    try:
        yield
    finally:
        (warp_mod.fused_cost_volume, enerf_mod.render_rays,
         depth_mod.kernel_depth_regression) = saved


def randomize_bn_stats(torch, model, seed):
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.copy_(1.0 + torch.rand(m.running_var.shape,
                                                 generator=g))


def phase_frames(torch, cfg):
    """The main path: ``N_FRAMES`` frames through ``render`` with the launch
    counts reset just before and read just after; then ``TIMED_FRAMES``
    more for the frame and stage times (medians)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender

    model = et.build_model(cfg, seed=0)          # on the GPU
    randomize_bn_stats(torch, model, seed=0)
    # the frame's inputs live on the card before timing, as the reference
    # run.py moves its batch before the timed forward
    batch = et.to_device(_synthetic(cfg, 3), "cuda")
    timer = StageTimer(torch)

    def frames(n):
        out, frame_ms, stages = None, [], []
        for _ in range(n):
            timer.start()
            out = et.render(model, batch, stage_hook=timer)
            frame_ms.append(timer.total_ms())
            stages.append(timer.stages_ms())
        return out, frame_ms, {k: statistics.median(st[k] for st in stages)
                               for k in stages[0]}

    kcv.launches = krender.launches = kdr.launches = 0
    out, first_ms, _ = frames(N_FRAMES)
    launches = {"cost_volume": kcv.launches, "render": krender.launches,
                "depth_regression": kdr.launches}
    expect_launches = {"cost_volume": 2 * N_FRAMES, "render": N_FRAMES,
                       "depth_regression": 2 * N_FRAMES}
    if launches != expect_launches:
        fail(f"kernel launches on the main path {launches}, expected "
             f"{expect_launches}")
    shapes = {k: list(v.shape) for k, v in out.items()}
    expect = {"rgb_level1": [1, H * W, 3], "depth_level1": [1, H * W],
              "weights_level1": [1, H * W, 2],
              "depth_mvs_level1": [1, H // 2, W // 2],
              "std_level1": [1, H // 2, W // 2]}
    if shapes != expect:
        fail(f"output shapes {shapes}, expected {expect}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in {k}")
    _, frame_ms, stages = frames(TIMED_FRAMES)

    # the kernel path vs the plain path on the card
    with plain_path():
        ref, plain_ms, plain_stages = frames(3)
    err = {k: max_err(torch, out[k], ref[k], E2E_RTOL, E2E_ATOL[k],
                      f"frame {k} kernel vs plain path") for k in out}

    # the card vs the CPU (the plain path, as the CPU tests hold it against
    # the JAX package) on a small frame
    small = make_synthetic_batch(cfg, H=64, W=96)
    out_gpu = et.render(model, small)
    out_cpu = et.render(copy.deepcopy(model).cpu(), small)
    err_cpu = {k: max_err(torch, out_gpu[k].cpu(), out_cpu[k], E2E_RTOL,
                          E2E_ATOL[k], f"64x96 frame {k} card vs CPU")
               for k in out_cpu}

    median_ms = statistics.median(frame_ms)
    emit("frames", main_path_frames=N_FRAMES, main_path_frame_ms=first_ms,
         launches=launches,
         launches_per_frame={k: v / N_FRAMES for k, v in launches.items()},
         timed_frames=TIMED_FRAMES, frame_ms=frame_ms, median_frame_ms=median_ms,
         fps=1e3 / median_ms, median_stage_ms=stages,
         plain_path_frame_ms=plain_ms[1:], plain_path_median_stage_ms=plain_stages,
         kernel_vs_plain_max_abs_err=err, card_vs_cpu_64x96_max_abs_err=err_cpu,
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, model, batch


def phase_profile(torch, model, batch, frames: int = 2) -> None:
    """Device kernel time by name and the device's idle share over
    ``frames`` frames."""
    import enerf_tpu_torch as et

    profile_device(torch, "profile", lambda: et.render(model, batch), frames,
                   "frame")


def profile_device(torch, phase, run_once, n: int, unit: str) -> None:
    """Device kernel time by name and the device's idle share over ``n``
    calls of ``run_once``, from torch.profiler's CUDA trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run_once()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_name = {}
    for e in kernels:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit(phase, **{f"{unit}s": n, f"device_busy_ms_per_{unit}": busy / n,
                   f"device_span_ms_per_{unit}": span / n,
                   "idle_share": 1 - busy / span,
                   f"kernel_launches_per_{unit}": len(kernels) / n,
                   "top_kernels": [{"name": name[:90],
                                    f"ms_per_{unit}": ms / n,
                                    f"launches_per_{unit}": k / n}
                                   for name, (ms, k) in top]})


def device_kernel_ms(torch, fn, kernel_name: str, n: int = 20,
                     warmup: int = 5, tries: int = 3) -> float:
    """Mean device time of the kernel named ``kernel_name`` over the last
    ``n`` of ``warmup + n`` calls of ``fn``, from torch.profiler's CUDA
    trace: the kernel alone, without the host time of its wrapper that CUDA
    events around a call include. The trace now and then lacks launches
    (CUPTI drops records): a session with fewer than ``n`` is run again, at
    most ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warmup + n):
                fn()
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events()
                           if e.device_type == DeviceType.CUDA
                           and kernel_name in e.name),
                          key=lambda e: e.time_range.start)
        if len(launches) >= n:
            return statistics.mean(e.time_range.elapsed_us() / 1e3
                                   for e in launches[-n:])
        print(f"chip_smoke: the profiler saw {len(launches)} launches of "
              f"{kernel_name}, expected {warmup + n}; profiling again",
              file=sys.stderr)
    fail(f"the profiler missed launches of {kernel_name} {tries} times")


def phase_k4(torch, cfg):
    """Depth-regression kernel vs plain, forward and gradient, at the
    train shapes of both levels and the eval level-0 shape."""
    from enerf_tpu_torch.ops.depth import init_depth_values
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr

    g = torch.Generator().manual_seed(4)
    near_far = torch.tensor([[2.5, 5.5]])
    cases = []
    for name, (D, Hv, Wv), inv in (
            ("train_level0", (64, H // 8, W // 8), True),
            ("train_level1", (8, H // 2, W // 2), False),
            ("eval_level0", (48, H // 8, W // 8), True)):
        logits = (2.0 * torch.randn(1, D, Hv, Wv, generator=g)).cuda()
        if inv:        # level 0: planes uniform in disparity, every pixel
            values, _ = init_depth_values(near_far, D, Hv, Wv, True)
        else:          # level 1: per-pixel planes in a band around a surface
            near = 3.0 + 0.6 * torch.rand(1, 1, Hv, Wv, generator=g)
            band = 0.05 + 0.4 * torch.rand(1, 1, Hv, Wv, generator=g)
            lin = torch.linspace(0, 1, D)[None, :, None, None]
            values = (near + lin * band).contiguous()
        values = values.cuda()
        plain = kdr.depth_regression_plain(logits, values, inv)
        out = kdr.depth_regression(logits, values, inv)
        torch.cuda.synchronize()
        err = max(max_err(torch, o, p, what=f"k4 {name} {k}", **K4_TOL)
                  for k, o, p in zip(("depth", "std"), out, plain))
        # gradient: the Function's backward vs autograd of the plain version
        gd = torch.randn(1, Hv, Wv, generator=g).cuda()
        gs = torch.randn(1, Hv, Wv, generator=g).cuda()
        grads = []
        for fn in (kdr.depth_regression, kdr.depth_regression_plain):
            lt = logits.clone().requires_grad_()
            vt = values.clone().requires_grad_()
            d, sd = fn(lt, vt, inv)
            grads.append(torch.autograd.grad((d, sd), (lt, vt), (gd, gs)))
        grad_err = max(max_err(torch, a, b, what=f"k4 {name} grad {k}",
                               **K4_TOL)
                       for k, a, b in zip(("logits", "values"), *grads))
        t_k = time_ms(torch, lambda: kdr.depth_regression(logits, values, inv),
                      reps=50, warmup=5)
        dev_ms = device_kernel_ms(
            torch, lambda: kdr.depth_regression(logits, values, inv),
            "depth_regression_kernel")
        t_p = time_ms(torch, lambda: kdr.depth_regression_plain(
            logits, values, inv), reps=50, warmup=5)
        io = nbytes(logits, values, *out)
        # per plane: exp twice, compare, 2 FMA and 3 more for the moment
        flops = logits.numel() * (10 + (2 if inv else 0))
        bd, by = bound_ms(io, flops)
        case = dict(case=name, shape=list(logits.shape), depth_inv=inv,
                    max_abs_err=err, grad_max_abs_err=grad_err, tol=K4_TOL,
                    ms=t_k, device_ms=dev_ms, plain_ms=t_p, bound_ms=bd,
                    bound_by=by, bytes=io, flops=flops)
        emit("k4", **case)
        cases.append(case)
    return cases


def bench_train_config():
    """``tools/bench_train.py``'s workload in the port's config."""
    from enerf_tpu_torch.config import CascadeConfig, Config, ENeRFConfig

    return Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3), grid_rays=True,
        cas_config=CascadeConfig(num=2, volume_planes=(64, 8))))


def grad_cosines(torch, model_a, model_b):
    """Per-parameter cosine of two models' gradients; a parameter whose
    gradient in ``model_b`` is 0 but for rounding (below 1e-7) must have
    one below 1e-6 in ``model_a``."""
    grads_b = dict(model_b.named_parameters())
    out = {}
    for k, p in model_a.named_parameters():
        a, b = p.grad, grads_b[k].grad
        if b is None or float(b.abs().max()) < 1e-7:
            if a is not None and float(a.abs().max()) >= 1e-6:
                fail(f"gradient of {k}: {float(a.abs().max())} on the card, "
                     "none on the CPU")
            continue
        if a is None:
            fail(f"gradient of {k}: none on the card")
        a, b = a.double().cpu().ravel(), b.double().cpu().ravel()
        out[k] = float(a @ b / (a.norm() * b.norm()))
    return out


def phase_train(torch):
    """The train main path: ``TRAIN_WARMUP`` + ``TRAIN_STEPS`` steps at
    512x640 with the launch counts reset just before and read just after;
    then a step with the VGG perceptual term, and a small step on the card
    vs the CPU."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender
    from enerf_tpu_torch.train import create_train_state, make_train_step
    from enerf_tpu_torch.train.vgg import VGG16Blocks

    cfg = bench_train_config()
    model = et.build_model(cfg, seed=0, train=True)        # on the GPU
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, (H, W))
    batch_np = make_synthetic_batch(cfg, H=H, W=W, split="train")
    batch_np.pop("tar_img")
    batch = et.to_device(batch_np, "cuda")
    params0 = [p.detach().clone() for p in model.parameters()]
    timer = StageTimer(torch)   # at the step's phase_hook
    n = TRAIN_WARMUP + TRAIN_STEPS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcv.launches = krender.launches = kdr.launches = 0
    losses, step_ms, phases = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        timer.start()
        state, stats = step(state, batch, phase_hook=timer)
        losses.append({k: float(v) for k, v in stats.items()})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        phases.append(timer.stages_ms())
    launches = {"cost_volume": kcv.launches, "render": krender.launches,
                "depth_regression": kdr.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # training runs the plain, differentiable cost volume and render stage
    # and the depth-regression kernel (plain-recompute backward)
    expect = {"cost_volume": 0, "render": 0, "depth_regression": 2 * n}
    if launches != expect:
        fail(f"kernel launches on the train path {launches}, expected {expect}")
    for i, st in enumerate(losses):
        if not all(map(lambda v: v == v and abs(v) != float("inf"),
                       st.values())):
            fail(f"train step {i}: non-finite stats {st}")
    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(model.parameters(), params0))
    if not moved > 0:
        fail("the train steps changed no parameter")
    timed = phases[TRAIN_WARMUP:]
    emit("train", H=H, W=W, steps=n, warmup=TRAIN_WARMUP,
         launches=launches,
         launches_per_step={k: v / n for k, v in launches.items()},
         step_ms=step_ms, median_step_ms=statistics.median(step_ms[TRAIN_WARMUP:]),
         median_phase_ms={k: statistics.median(p[k] for p in timed)
                          for k in timed[0]},
         peak_mem_gb=peak_gb, loss=[st["loss"] for st in losses],
         last_stats=losses[-1], max_param_change=moved,
         lr=state.optimizer.param_groups[0]["lr"])

    # the perceptual term on the card, seeded random VGG16 weights
    vgg = VGG16Blocks()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in vgg.parameters():
            fan_in = p[0].numel() if p.ndim > 1 else 1
            p.copy_(torch.randn(p.shape, generator=g)
                    * ((2.0 / fan_in) ** 0.5 if p.ndim > 1 else 0.1))
    vgg_step = make_train_step(cfg, (H, W), vgg_params=vgg.cuda())
    vgg_ms, vgg_stats = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        state, stats = vgg_step(state, batch)
        vgg_stats = {k: float(v) for k, v in stats.items()}
        torch.cuda.synchronize()
        vgg_ms.append((time.perf_counter() - t0) * 1e3)
    if not ("perceptual_loss_1" in vgg_stats and all(
            v == v and abs(v) != float("inf") for v in vgg_stats.values())):
        fail(f"VGG train step stats {vgg_stats}")
    emit("train_vgg", step_ms=vgg_ms, stats=vgg_stats,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the card vs the CPU: one small step from the same weights and batch
    sh, sw = TRAIN_SMALL_HW
    small = make_synthetic_batch(cfg, H=sh, W=sw, split="train", seed=3)
    small.pop("tar_img")
    m_gpu = et.build_model(cfg, seed=1, train=True)
    m_cpu = copy.deepcopy(m_gpu).cpu()
    small_step = make_train_step(cfg, (sh, sw))
    _, s_gpu = small_step(create_train_state(cfg, m_gpu), small)
    _, s_cpu = small_step(create_train_state(cfg, m_cpu), small)
    loss_gpu, loss_cpu = float(s_gpu["loss"]), float(s_cpu["loss"])
    if abs(loss_gpu - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
        fail(f"{sh}x{sw} train step loss {loss_gpu} on the card, {loss_cpu} "
             f"on the CPU (rtol {TRAIN_LOSS_RTOL})")
    cos = grad_cosines(torch, m_gpu, m_cpu)
    worst = min(cos.items(), key=lambda kv: kv[1])
    if worst[1] < TRAIN_GRAD_COS:
        fail(f"{sh}x{sw} train step: gradient of {worst[0]} at cosine "
             f"{worst[1]} card vs CPU (limit {TRAIN_GRAD_COS})")
    emit("train_card_vs_cpu", H=sh, W=sw, loss_card=loss_gpu,
         loss_cpu=loss_cpu, loss_rtol=TRAIN_LOSS_RTOL,
         params_compared=len(cos), worst_grad_cosine=worst[1],
         worst_grad_param=worst[0], cosine_limit=TRAIN_GRAD_COS)
    return launches, state, step, batch

def main() -> None:
    if not (ROOT / "enerf_tpu_torch" / "__init__.py").is_file():
        fail(f"no enerf_tpu_torch package next to {Path(__file__).name}: run "
             "it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke drives the port on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from enerf_tpu_torch.config import dtu_eval_config

    cfg = dtu_eval_config()
    smi_line = phase_device(torch)
    phase_build()
    k1 = phase_k1(torch, cfg)
    k2 = phase_k2(torch, cfg)
    launches, model, batch = phase_frames(torch, cfg)
    phase_profile(torch, model, batch)
    del model, batch
    k4 = phase_k4(torch, cfg)
    train_launches, state, step, train_batch = phase_train(torch)
    profile_device(torch, "train_profile",
                   lambda: step(state, train_batch), 2, "step")

    per_frame = [c for c in k1 if c["case"] in ("level0", "level1")]
    full = k2[0]   # the frame's shape: 327,680 rays, S = 3
    k1_bound, k1_by = bound_ms(sum(c["bytes"] for c in per_frame),
                               sum(c["flops"] for c in per_frame))
    per_step = [c for c in k4 if c["case"].startswith("train_")]
    k4_bound, k4_by = bound_ms(sum(c["bytes"] for c in per_step),
                               sum(c["flops"] for c in per_step))
    kernels = [
        {"name": "cost_volume", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/cost_volume.cu",
         "replaces": "enerf_tpu/ops/pallas/cost_volume.py:122",
         "launches": launches["cost_volume"],
         "max_abs_err": max(c["max_abs_err"] for c in k1),
         # per frame: the level-0 and level-1 launches together
         "ms": sum(c["ms"]["median"] for c in per_frame),
         "run_ms": sum(c["run_ms"] for c in per_frame),
         "device_ms": sum(c["device_ms"] for c in per_frame),
         "plain_ms": sum(c["plain_ms"]["median"] for c in per_frame),
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "render", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/render.cu",
         "replaces": "enerf_tpu/ops/pallas/render.py:426",
         "launches": launches["render"],
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         "ms": full["ms"]["median"], "run_ms": full["run_ms"],
         "device_ms": full["device_ms"],
         "plain_ms": full["plain_ms"]["median"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "bound_f32_ms": full["bound_f32_ms"], "library_ms": None},
        {"name": "depth_regression", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/depth_regression.cu",
         "replaces": "enerf_tpu/ops/pallas/reductions.py:66",
         # both main paths: the frames (2 a frame) and the train steps (2 a
         # step)
         "launches": launches["depth_regression"]
         + train_launches["depth_regression"],
         "launches_by_path": {"frames": launches["depth_regression"],
                              "train": train_launches["depth_regression"]},
         "max_abs_err": max(max(c["max_abs_err"], c["grad_max_abs_err"])
                            for c in k4),
         # per train step: the level-0 and level-1 launches together
         "ms": sum(c["ms"]["median"] for c in per_step),
         "device_ms": sum(c["device_ms"] for c in per_step),
         "plain_ms": sum(c["plain_ms"]["median"] for c in per_step),
         "bound_ms": k4_bound, "bound_by": k4_by,
         # no single PyTorch call computes softmax + expectation + std
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

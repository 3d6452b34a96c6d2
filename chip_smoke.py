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
  k1_crop  its crop-window mode: the composite frame's fg windows at both
           levels, a window across the frame's edge, a negative origin, a
           ragged window, a batch of 2
  k2       the render kernel of level 1's head (csrc/render.cu) vs its plain
           version at 327,680 rays, n=2: S=3, a padded view, S=2, S=4, a
           ray count that leaves a ragged warp tile, and a white
           background; the human window's 86,016 rays at S=2; times as
           for k1
  k2_l0    the render kernel of level 0's head (csrc/render_l0.cu: 32 FPN
           channels + rgb, n=8) vs its plain version at a 512x640 frame's
           20,480 level-0 rays: S=3, a padded view, S=2, S=4, a ragged ray
           count, a white background; times as for k1, beside its bound
           (three TF32 passes on the tensor cores, the kernel's route, as
           for k2) and the f32 CUDA-core one
  frames   the DTU eval forward (512x640, 3 source views, volume planes
           (48, 8), render_if (False, True), grid rays, seeded random
           weights) through ``build_model`` / ``render``: per-frame and
           per-stage ms, kernel launch counts, the kernel path vs the plain
           path on the card, and the card vs the CPU on a small frame
  profile  torch.profiler over two frames: device busy time, idle share,
           the kernels that take the most device time
  human    the human frame (``human_eval_config``: 512x512, 2 source views,
           the (384, 224) window over bench.py's centered mask) as
           ``frames``, its synchronizing calls, and each of the three mask
           modes kernel vs plain path and card vs CPU at 64x96; then
           ``human_profile`` and ``human_kernels``: each kernel call of
           one frame held on its own against its plain version on the
           inputs the frame gave it, with its device time and bound
  composite  the composite frame (``composite_eval_config``: 512x640, 3
           views, 1 fg layer in a (256, 192) window) as ``frames``, its
           synchronizing calls, card vs CPU at 128x160 with a centered
           window and one across the frame's edge; then
           ``composite_profile`` and ``composite_kernels`` (as
           ``human_kernels``)
  val      the val main path: ``Trainer.val`` of the port's default cascade
           (``Config()``: planes (64, 8), num_samples (8, 2), render_if
           (True, True), grid rays) over 11 synthetic 512x640 frames,
           scored by ``make_evaluator(cfg)`` (PSNR, SSIM, LPIPS on seeded
           random weights): frame and stage times (first frame excluded),
           launches a frame, the metric dict; the kernel path vs the plain
           path, the card vs the CPU at 128x160; then ``val_profile`` and
           ``val_kernels`` (as ``human_kernels``)
  k4       the depth-regression kernel vs its plain version, forward and
           gradient, at the train shapes of both cascade levels and the
           eval level-0 shape, then 5 planes over a ragged pixel count, a
           batch of 2 at level 0, and bfloat16 inputs at both train levels;
           times as for k1, and at the three main-path shapes and the
           ragged one the device time of every plan (planes per thread),
           launched through the kernel's C function
  k4_floor an empty kernel's device time on the same card: the launch floor
           beside K4's bounds
  train    the train step of ``tools/bench_train.py``'s workload (512x640,
           3 source views, volume planes (64, 8), both levels rendering
           the full image on grid rays, MSE, Adam, seeded random weights)
           through ``build_model(train=True)`` / ``make_train_step``: step
           times and their forward / backward / optimizer split, peak
           memory, the loss of every step, kernel launch counts; one step
           with seeded random VGG16 weights (the perceptual term); a
           128x160 step on the card vs the same step on the CPU
  train_profile  torch.profiler over two train steps
then a ``{"kernels": [...]}`` line (each kernel's launches on every main
path: frames, human, composite, val, train; its calls of a human, a
composite and a val frame in ``per_frame_by_path``), the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Float32 throughout, TF32 off. A bound
counts each input read once and each output written once; K1's source
features only where its voxels' bilinear footprints touch them
(``k1_work``).
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
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
E2E_ATOL = {f"{k}_level{i}": a for i in (0, 1) for k, a in (
    ("rgb", 3e-4), ("weights", 3e-4), ("depth", 3e-3), ("depth_mvs", 3e-3),
    ("std", 3e-3))}
E2E_RTOL = 1e-3
# K4: the kernel sums Σe·v / Σe over plane groups merged by Chan's update,
# the plain version softmax-then-sum in torch's reduction order (f32, 5-64
# terms)
K4_TOL = dict(rtol=1e-4, atol=1e-6)
# K4 on bfloat16 inputs, outputs rounded to bfloat16 (tests/test_pallas.py's
# bf16 tolerances): one rounding of an f32 result, summed in another order
K4_BF16_TOL = {"depth": dict(rtol=1e-2, atol=0.0),
               "std": dict(rtol=2e-2, atol=1e-3)}
# kernel launches a frame (or a train step) on each main path; "render" is
# csrc/render.cu (level 1's head), "render_l0" csrc/render_l0.cu (level 0's)
FRAMES_PER_FRAME = {"cost_volume": 2, "render": 1, "render_l0": 0,
                    "depth_regression": 2}
HUMAN_PER_FRAME = {"cost_volume": 2, "render": 1, "render_l0": 0,
                   "depth_regression": 2}
COMPOSITE_PER_FRAME = {"cost_volume": 4, "render": 0, "render_l0": 0,
                       "depth_regression": 4}
VAL_PER_FRAME = {"cost_volume": 2, "render": 1, "render_l0": 1,
                 "depth_regression": 2}
# the val main path: Trainer.val over this many frames, the first excluded
# from the times (as many timed frames as the other frame phases)
VAL_BATCHES = 1 + TIMED_FRAMES
LIBRARY_NONE_RENDER = ("no single PyTorch call computes the IBR head "
                       "(projection, bilinear gather, Agg, MLPs) and the "
                       "compositing")
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
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"{what}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} "
             f"{ref.dtype}")
    if not bool(torch.isfinite(out).all()):
        fail(f"{what}: non-finite values")
    out, ref = out.float(), ref.float()
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
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def k1_work(torch, feats, projs, dv, vm, out, window=None):
    """The bytes and operations of one cost volume ``out`` (B, D, h, w, C).
    Bytes: the output once; the depth planes of the window (the whole
    ``dv`` in full mode); the matrices, view mask and origin; and of the
    source features only the pixels that some voxel's bilinear footprint
    (its four corners inside the map) touches in a valid view, all C
    channels of each, once. Operations per voxel: per valid view the warp
    and the four-corner blend (8C + 24), then the variance (3C)."""
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.window import Window

    B, S, Hs, Ws, C = feats.shape
    xy0 = None
    if window is not None:
        xy0, hw = window
        dv = Window(xy0, hw, dv.shape[2:]).crop(dv, planes=True)
    if vm is None:
        vm = torch.ones(B, S, device=feats.device)
    x, y = kcv.warp_coords(projs, dv, xy0)               # (B, S, D, h, w)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    touched = torch.zeros(B * S, Hs * Ws + 1, dtype=torch.bool,
                          device=feats.device)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < Ws) & (yi >= 0) & (yi < Hs)
            idx = torch.where(inside, yi * Ws + xi, Hs * Ws)
            touched.scatter_(1, idx.reshape(B * S, -1), True)
    pixels = float((touched[:, :-1].sum(1).reshape(B, S).float()
                    * (vm > 0)).sum())
    io = (pixels * C * feats.element_size() + nbytes(projs, vm, xy0, out)
          + dv.numel() * dv.element_size())
    n_valid = float(vm.sum())
    flops = out.numel() // C * (n_valid / B * (8 * C + 24) + 3 * C)
    return io, flops, pixels


def k2_work(args, out):
    """The bytes and operations of one render call: its ray and sample
    inputs, the image features and volume once, its outputs once; per
    sample and valid view view_fc, global_fc, agg_w_fc and color_0's Cf + 4
    per-view inputs + color_2, once per sample fc, lr0, sigma and
    color_0's 88 shared inputs (multiply-adds, 2 operations each): per
    view 2,156 at Cf = 11 (level 1), 6,092 at Cf = 35 (level 0); per
    sample 7,744 at both."""
    xyz, uvd, z, img, vol = args[:5]
    vm = args[8]
    B, N, n = xyz.shape[:3]
    cf = img.shape[-1]
    n_valid = float(vm.sum()) if vm is not None else float(B * img.shape[1])
    per_view = 4 * cf + 3 * cf * 32 + 32 + (cf + 4) * 64 + 64
    shared = 32 * 16 + 24 * 64 + 64 + 88 * 64
    macs = (n_valid * per_view + B * shared) * N * n
    io = nbytes(xyz, uvd, z, img, vol, out["rgb"], out["depth"],
                out["weights"])
    return io, 2.0 * macs, (n_valid / B * per_view + shared)


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


def ptxas_summary(log: str) -> list:
    """ptxas' registers and spills, one line for each compiled kernel,
    named by its mangled symbol from the kernel's name on (template
    arguments as ``ILi8EfE`` = <8, float>)."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_symbol(ln.split("'")[1])
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return out


def kernel_symbol(sym: str) -> str:
    """The kernel's name and template arguments from a mangled symbol: the
    identifier ending in ``_kernel`` whose length prefix matches it (the
    digits before it may run into a hash of the file's path)."""
    for m in re.finditer(r"\d+", sym):
        digits = m.group(0)
        for k in range(len(digits)):
            n = int(digits[k:])
            ident = sym[m.end():m.end() + n]
            if n and len(ident) == n and ident.endswith("_kernel"):
                return ident + sym[m.end() + n:]
    return sym


def ptxas_resources(log: str, kernel: str) -> dict:
    """ptxas' registers and spill bytes of each instance of ``kernel`` (a
    ``template <int S>`` kernel), by S."""
    out, name, spill = {}, None, (0, 0)
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_symbol(ln.split("'")[1])
        elif "spill" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spill = (int(m.group(1)), int(m.group(2))) if m else spill
        elif "registers" in ln and name:
            m = re.match(rf"{kernel}ILi(\d+)E", name)
            if m:
                out[int(m.group(1))] = {
                    "registers": int(re.search(r"(\d+) registers", ln).group(1)),
                    "spill_store_bytes": spill[0], "spill_load_bytes": spill[1]}
            name, spill = None, (0, 0)
    return out


def render_l0_resources(_build) -> dict:
    """K2-L0's registers, spill bytes and dynamic shared memory a block, by
    S (the shared memory from the kernel's own C function)."""
    import ctypes

    res = ptxas_resources(_build.build_log("render_l0"), "render_l0_kernel")
    fn = _build.load_library("render_l0").enerf_render_rays_l0_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    for s in (2, 3, 4):
        res.setdefault(s, {})["smem_bytes"] = fn(s)
    return {str(k): v for k, v in sorted(res.items())}


def phase_build():
    from enerf_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load_library(name)
    ptxas = {n: ptxas_summary(_build.build_log(n)) for n in _build.KERNELS}
    l0 = render_l0_resources(_build)
    emit("build", seconds=time.perf_counter() - t0, kernels=list(_build.KERNELS),
         built_now=sorted(_build.BUILD_LOGS), ptxas=ptxas,
         render_l0_resources=l0)
    return l0


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
        io, flops, pixels = k1_work(torch, *args, out)
        bd, by = bound_ms(io, flops)
        case = dict(case=name, shape=list(out.shape),
                    views_valid=float(vm.sum()), max_abs_err=err, tol=K1_TOL,
                    ms=t_k, run_ms=t_run, device_ms=t_dev, plain_ms=t_p,
                    bound_ms=bd, bound_by=by, bytes=io, flops=flops,
                    feature_pixels_read=pixels)
        emit("k1", **case)
        cases.append(case)
    return cases


def phase_k1_crop(torch):
    """K1's crop-window mode vs its plain version: the composite frame's fg
    windows at both levels (origin from the centered bbox), a window across
    the frame's bottom-right edge, one at a negative origin, a ragged one,
    and a batch of 2 with an origin each."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import composite_eval_config
    from enerf_tpu_torch.datasets.synthetic import make_composite_batch
    from enerf_tpu_torch.ops.camera import get_proj_mats
    from enerf_tpu_torch.ops.depth import init_depth_values
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv

    g = torch.Generator().manual_seed(6)
    cfg = composite_eval_config()
    cas = cfg.enerf.cas_config
    fg_h, fg_w = cfg.enerf.fg_bbox_hw
    cases = []
    for name, level, origins, hw in (
            ("fg_level0", 0, None, None), ("fg_level1", 1, None, None),
            ("edge_level1", 1, [(280, 200)], None),
            ("negative_level0", 0, [(-5, 37)], None),
            ("ragged_level0", 0, [(17, 21)], (31, 23)),
            ("b2_level1", 1, [(10, 20), (250, 150)], None)):
        B = len(origins) if origins else 1
        bnp = make_composite_batch(cfg, H=H, W=W, batch_size=B)
        b = et.to_device(bnp, "cuda")
        vs, s = cas.volume_scale[level], cas.im_feat_scale[level]
        C, D = (32, 16)[level], cas.volume_planes[level]
        hw = hw or (int(fg_h * vs), int(fg_w * vs))
        if origins is None:      # the model's origin: (bbox * scale) truncated
            xy0 = (b["bbox"][:, 0, :2] * vs).to(torch.int32)
        else:
            xy0 = torch.tensor(origins, dtype=torch.int32).cuda()
        feats = torch.randn(B, 3, int(H * s), int(W * s), C, generator=g).cuda()
        projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                              b["tar_ixt"], src_scale=s, tar_scale=vs)
        Hv, Wv = int(H * vs), int(W * vs)
        if level == 0:
            dv, _ = init_depth_values(b["near_far"][:, 0], D, Hv, Wv, True)
        else:
            near = 3.0 + 0.6 * torch.rand(B, 1, Hv, Wv, generator=g)
            band = 0.2 + 0.4 * torch.rand(B, 1, Hv, Wv, generator=g)
            lin = torch.linspace(0, 1, D)[None, :, None, None]
            dv = (near + lin * band).cuda()
        dv, vm = dv.contiguous(), b["view_mask"]
        args, window = (feats, projs, dv, vm), (xy0, hw)
        plain = kcv.cost_volume_plain(*args, window=window)
        out = kcv.fused_cost_volume(*args, window=window)
        torch.cuda.synchronize()
        err = max_err(torch, out, plain, what=f"k1 crop {name}", **K1_TOL)
        call = lambda: kcv.fused_cost_volume(*args, window=window)  # noqa: E731
        t_k = time_ms(torch, call)
        t_dev = device_kernel_ms(torch, call, "cost_volume_kernel")
        t_p = time_ms(torch, lambda: kcv.cost_volume_plain(*args,
                                                           window=window))
        io, flops, pixels = k1_work(torch, *args, out, window)
        bd, by = bound_ms(io, flops)
        case = dict(case=name, shape=list(out.shape), origin=xy0.tolist(),
                    frame_hw=[Hv, Wv], views_valid=float(vm.sum()),
                    max_abs_err=err, tol=K1_TOL, ms=t_k, device_ms=t_dev,
                    plain_ms=t_p, bound_ms=bd, bound_by=by, bytes=io,
                    flops=flops, feature_pixels_read=pixels)
        emit("k1_crop", **case)
        cases.append(case)
    return cases


def phase_k2(torch, cfg):
    """Render kernel vs plain at the full 512x640 ray grid: S = 3, a
    padded view, S = 2 and 4, a ragged last warp tile (the last 5 rays
    dropped, so no longer a grid), a white background; and the human
    frame's 86,016 rays of a (384, 224) window at S = 2."""
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
            ("ragged_tile", 3, 3, 5, False), ("white_bkgd", 3, 3, 0, True),
            # the human frame's ray count: a (384, 224) window, S = 2
            ("human_window", 2, 2, "window", False)):
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
        if cut == "window":
            xyz, uvd, z = (t.reshape((1, H, W) + t.shape[2:])[
                :, 64:448, 208:432].reshape((1, 384 * 224) + t.shape[2:])
                .contiguous() for t in (xyz, uvd, z))
        elif cut:
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
        io, flops, macs = k2_work(args, out)
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


def phase_k2_l0(torch, cfg):
    """The level-0 render kernel (csrc/render_l0.cu) vs the plain version
    at level 0's head shape (32 FPN channels + rgb, 8 samples in
    disparity, a 64-plane volume at 64x80) over the 20,480 grid rays of a
    512x640 frame's level 0 (128x160, render scale 1/4): S = 3, a padded
    view, S = 2, S = 4, a ray count that is no longer a grid (the last 5
    rays dropped), a white background; times as for k2, beside the same
    bound as k2's (the head's products in three TF32 passes on the tensor
    cores, the kernel's route) and the f32 CUDA-core one."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.models.layers import init_weights
    from enerf_tpu_torch.models.nerf_head import NeRFHead
    from enerf_tpu_torch.ops.ibr import unpreprocess
    from enerf_tpu_torch.ops.kernels import render as krender
    from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth

    g = torch.Generator().manual_seed(8)
    head = NeRFHead(35)
    init_weights(head, g, kaiming_linear=True)
    head = head.eval().cuda()
    h, w = H // 4, W // 4
    Hv, Wv = H // 8, W // 8
    cases = []
    for name, slots, n_src, cut, white in (
            ("level0_s3", 3, 3, 0, False), ("padded_view", 3, 2, 0, False),
            ("s2", 2, 2, 0, False), ("s4", 4, 4, 0, False),
            ("ragged", 3, 3, 5, False), ("white_bkgd", 3, 3, 0, True)):
        b = et.to_device(_synthetic(cfg, n_src, slots), "cuda")
        depth = (1 / (3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g))).cuda()
        std = (0.005 + 0.02 * torch.rand(1, Hv, Wv, generator=g)).cuda()
        nf = torch.stack([torch.full((1, Hv, Wv), 1 / 2.5),
                          torch.full((1, Hv, Wv), 1 / 5.5)], 1).cuda()
        rays = build_rays(b["rays_0"], depth, std, nf, True, 2.0, grid=True)
        xyz, uvd, z = sample_along_depth(rays, 8, True)
        uvd = uvd * torch.tensor([1 / (w - 1), 1 / (h - 1), 1.0], device="cuda")
        img = torch.cat([torch.randn(1, slots, h, w, 32, generator=g).cuda(),
                         unpreprocess(b["src_inps"], 0.25)], -1).contiguous()
        vol = torch.randn(1, 64, Hv, Wv, 8, generator=g).cuda()
        if cut:
            n = xyz.shape[1] - cut
            xyz, uvd, z = (t[:, :n].contiguous() for t in (xyz, uvd, z))
        args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"],
                b["tar_ext"], b["view_mask"], head)
        kw = dict(render_scale=0.25, grid_hw=None if cut else (h, w),
                  white_bkgd=white)
        with torch.inference_mode():
            plain = krender.render_rays_plain(*args, **kw)
            before = krender.launches["render_l0"]
            out = krender.render_rays(*args, **kw)
            torch.cuda.synchronize()
            if krender.launches["render_l0"] != before + 1:
                fail(f"k2_l0 {name}: the wrapper did not launch render_l0")
            err = max(max_err(torch, out[k], plain[k],
                              what=f"k2_l0 {name} {k}", **K2_TOL)
                      for k in ("rgb", "depth", "weights"))
            call = lambda: krender.render_rays(*args, **kw)  # noqa: E731
            t_k = time_ms(torch, call)
            t_run = run_ms(torch, call, n=20)
            t_dev = device_kernel_ms(torch, call, "render_l0_kernel")
            t_p = time_ms(torch, lambda: krender.render_rays_plain(*args, **kw),
                          reps=5, warmup=1)
        io, flops, macs = k2_work(args, out)
        bd, by = bound_ms(io, TF32_PASSES * flops, TF32_FLOPS_PER_S)
        bd_f32, by_f32 = bound_ms(io, flops)
        case = dict(case=name, slots=slots, rays=xyz.shape[1],
                    views_valid=float(b["view_mask"].sum()), white_bkgd=white,
                    max_abs_err=err, tol=K2_TOL, ms=t_k, run_ms=t_run,
                    device_ms=t_dev, plain_ms=t_p, bound_ms=bd, bound_by=by,
                    bound_f32_ms=bd_f32, bound_f32_by=by_f32, bytes=io,
                    flops=flops, macs_per_sample=macs)
        emit("k2_l0", **case)
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


# where the models call each kernel's wrapper: (kernel, module, name)
KERNEL_CALL_SITES = (
    ("cost_volume", "enerf_tpu_torch.ops.warp", "fused_cost_volume"),
    ("render", "enerf_tpu_torch.models.enerf", "render_rays"),
    ("depth_regression", "enerf_tpu_torch.ops.depth",
     "kernel_depth_regression"))


@contextlib.contextmanager
def swapped_kernels(make):
    """Each model-side reference to a kernel wrapper replaced by
    ``make(kernel, wrapper)`` while the context lasts."""
    import importlib

    saved = []
    for kernel, module, name in KERNEL_CALL_SITES:
        mod = importlib.import_module(module)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, make(kernel, getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_path():
    """The same forward with each kernel wrapper swapped for its plain
    version (for the on-card comparison only)."""
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender

    plain = {"cost_volume": kcv.cost_volume_plain,
             "render": krender.render_rays_plain,
             "depth_regression": kdr.depth_regression_plain}
    return swapped_kernels(lambda kernel, wrapper: plain[kernel])


def recorded_kernel_calls(torch, calls: list):
    """The same forward, each kernel call appended to ``calls`` as
    (kernel, args, kwargs) with its tensors cloned before the kernel runs;
    the kernels still run and count their launches."""
    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(snap(v) for v in x)
        if isinstance(x, dict):
            return {k: snap(v) for k, v in x.items()}
        return x

    def make(kernel, wrapper):
        def call(*args, **kwargs):
            calls.append((render_kernel(args) if kernel == "render"
                          else kernel, snap(args), snap(kwargs)))
            return wrapper(*args, **kwargs)
        return call

    return swapped_kernels(make)


def render_kernel(args) -> str:
    """Which render kernel the wrapper launches for these arguments:
    ``render`` (csrc/render.cu) or ``render_l0`` (csrc/render_l0.cu), by
    the head's shape (Cf, Cv, n)."""
    from enerf_tpu_torch.ops.kernels import render as krender

    xyz, img, vol = args[0], args[3], args[4]
    return krender.KERNELS[(img.shape[-1], vol.shape[-1], xyz.shape[2])][0]


def hold_path_kernels(torch, path, model, batch, per_frame):
    """Each kernel call of one frame of ``path`` held on its own against
    its plain version, on the very inputs the frame gave it (recorded by
    ``recorded_kernel_calls``), within the kernel's tolerance; with its
    device time, the plain version's time and its bound. The frame must
    make ``per_frame`` calls of each kernel. Returns the cases."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender

    calls = []
    with recorded_kernel_calls(torch, calls):
        et.render(model, batch)
    made = {k: sum(c[0] == k for c in calls) for k in per_frame}
    if made != per_frame:
        fail(f"{path}: kernel calls in a frame {made}, expected {per_frame}")
    kernel_fns = {
        "cost_volume": (kcv.fused_cost_volume, kcv.cost_volume_plain,
                        "cost_volume_kernel"),
        "render": (krender.render_rays, krender.render_rays_plain,
                   "render_kernel"),
        "render_l0": (krender.render_rays, krender.render_rays_plain,
                      "render_l0_kernel"),
        "depth_regression": (kdr.depth_regression, kdr.depth_regression_plain,
                             "depth_regression_kernel")}
    cases = []
    with torch.inference_mode():
        for i, (kernel, args, kw) in enumerate(calls):
            wrapper, plain_fn, symbol = kernel_fns[kernel]
            call = lambda: wrapper(*args, **kw)            # noqa: E731
            plain_call = lambda: plain_fn(*args, **kw)     # noqa: E731
            out, ref = call(), plain_call()
            torch.cuda.synchronize()
            what = f"{path} call {i} {kernel}"
            case = dict(path=path, call=i, kernel=kernel)
            if kernel == "cost_volume":
                window = kw.get("window")
                err = max_err(torch, out, ref, what=what, **K1_TOL)
                io, flops, pixels = k1_work(torch, *args, out, window)
                bd, by = bound_ms(io, flops)
                case.update(shape=list(out.shape), mode=(
                    "crop" if window is not None else "full"),
                    feature_pixels_read=pixels, tol=K1_TOL)
            elif kernel == "depth_regression":
                logits, values, inv = args
                err = max(max_err(torch, o, p, what=f"{what} {k}", **K4_TOL)
                          for k, o, p in zip(("depth", "std"), out, ref))
                io = nbytes(logits, values, *out)
                flops = logits.numel() * (10 + (2 if inv else 0))
                bd, by = bound_ms(io, flops)
                case.update(shape=list(logits.shape), depth_inv=inv,
                            plan=list(kdr.plan(logits.shape[1],
                                               logits[:, 0].numel())),
                            tol=K4_TOL)
            else:
                err = max(max_err(torch, out[k], ref[k], what=f"{what} {k}",
                                  **K2_TOL) for k in ("rgb", "depth",
                                                      "weights"))
                io, flops, _ = k2_work(args, out)
                # both render kernels: the head's products in three TF32
                # passes on the tensor cores (render.cu's route)
                bd, by = bound_ms(io, TF32_PASSES * flops, TF32_FLOPS_PER_S)
                case.update(rays=args[0].shape[1], samples=args[0].shape[2],
                            slots=args[3].shape[1],
                            views_valid=(None if args[8] is None
                                         else float(args[8].sum())),
                            tol=K2_TOL)
            case.update(max_abs_err=err,
                        device_ms=device_kernel_ms(torch, call, symbol),
                        plain_ms=time_ms(torch, plain_call, reps=5,
                                         warmup=1)["median"],
                        bound_ms=bd, bound_by=by, bytes=io, flops=flops)
            emit(f"{path}_kernels", **case)
            cases.append(case)
    return cases


def randomize_bn_stats(torch, model, seed):
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.copy_(1.0 + torch.rand(m.running_var.shape,
                                                 generator=g))


def reset_launches():
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender

    kcv.launches = kdr.launches = 0
    krender.reset_launches()


def read_launches() -> dict:
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import render as krender

    return {"cost_volume": kcv.launches, **krender.launches,
            "depth_regression": kdr.launches}


def drive_frames(torch, phase, model, batch, per_frame, shapes):
    """A render main path: ``N_FRAMES`` frames through ``render`` with the
    launch counts reset just before and read just after (they must be
    ``per_frame`` times the frames, the outputs of ``shapes`` and finite);
    then ``TIMED_FRAMES`` more for the frame and stage times (medians) and
    the peak memory, the counter reset first; then the same frame with
    each kernel swapped for its plain version. Returns the fields of the
    phase's line, the launches and the kernel path's output."""
    import enerf_tpu_torch as et

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

    reset_launches()
    out, first_ms, _ = frames(N_FRAMES)
    launches = read_launches()
    expect = {k: v * N_FRAMES for k, v in per_frame.items()}
    if launches != expect:
        fail(f"{phase}: kernel launches on the main path {launches}, "
             f"expected {expect}")
    got = {k: list(v.shape) for k, v in out.items()}
    if got != shapes:
        fail(f"{phase}: output shapes {got}, expected {shapes}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"{phase}: non-finite values in {k}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, frame_ms, stages = frames(TIMED_FRAMES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the kernel path vs the plain path on the card
    with plain_path():
        ref, plain_ms, plain_stages = frames(3)
    err = {k: max_err(torch, out[k], ref[k], E2E_RTOL, E2E_ATOL[k],
                      f"{phase} {k} kernel vs plain path") for k in out}
    median_ms = statistics.median(frame_ms)
    return dict(main_path_frames=N_FRAMES, main_path_frame_ms=first_ms,
                launches=launches,
                launches_per_frame={k: v / N_FRAMES
                                    for k, v in launches.items()},
                timed_frames=TIMED_FRAMES, frame_ms=frame_ms,
                median_frame_ms=median_ms, fps=1e3 / median_ms,
                median_stage_ms=stages, plain_path_frame_ms=plain_ms[1:],
                plain_path_median_stage_ms=plain_stages,
                kernel_vs_plain_max_abs_err=err,
                e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL},
                peak_mem_gb=peak_gb), launches, out


def card_vs_cpu(torch, phase, model, batch):
    """One frame of ``model`` on the card vs the same model on the CPU (the
    plain path, as the CPU tests hold it against the JAX package)."""
    import enerf_tpu_torch as et

    out_gpu = et.render(model, batch)
    out_cpu = et.render(copy.deepcopy(model).cpu(), batch)
    return {k: max_err(torch, out_gpu[k].cpu(), out_cpu[k], E2E_RTOL,
                       E2E_ATOL[k], f"{phase} {k} card vs CPU")
            for k in out_cpu}


def count_syncs(torch, run_once) -> dict:
    """The calls that synchronize the host with the card in one
    ``run_once()``, by ``torch.cuda.set_sync_debug_mode("warn")``: their
    count and, for each, the innermost line of the port on the Python
    stack when it warned (file:line)."""
    import traceback
    import warnings

    where = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = [f for f in traceback.extract_stack()
                if "enerf_tpu_torch" in f.filename]
        f = port[-1] if port else traceback.extract_stack()[-3]
        where.append(f"{Path(f.filename).parent.name}/"
                     f"{Path(f.filename).name}:{f.lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_once()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"count": len(where),
            "where": {w: where.count(w) for w in sorted(set(where))}}


def phase_frames(torch, cfg):
    """The DTU frame: ``drive_frames`` at 512x640, then a 64x96 frame on the
    card vs the CPU."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch

    model = et.build_model(cfg, seed=0)          # on the GPU
    randomize_bn_stats(torch, model, seed=0)
    # the frame's inputs live on the card before timing, as the reference
    # run.py moves its batch before the timed forward
    batch = et.to_device(_synthetic(cfg, 3), "cuda")
    shapes = {"rgb_level1": [1, H * W, 3], "depth_level1": [1, H * W],
              "weights_level1": [1, H * W, 2],
              "depth_mvs_level1": [1, H // 2, W // 2],
              "std_level1": [1, H // 2, W // 2]}
    fields, launches, _ = drive_frames(torch, "frames", model, batch,
                                       FRAMES_PER_FRAME, shapes)
    err_cpu = card_vs_cpu(torch, "64x96 frame", model,
                          make_synthetic_batch(cfg, H=64, W=96))
    emit("frames", **fields, card_vs_cpu_64x96_max_abs_err=err_cpu)
    return launches, model, batch


def phase_human(torch):
    """The human frame (``bench.py:run_human``'s workload): ``ENeRFHuman``
    at 512x512, 2 source views, volume planes (32, 8), level 1 rendered on
    the (384, 224) window over the centered mask, through ``build_model`` /
    ``render``; then the two other mask modes, kernel vs plain path at the
    full frame and card vs CPU at 64x96 for all three."""
    import dataclasses

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import human_eval_config, human_mask
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch

    cfg = human_eval_config()
    HH = WH = 512
    model = et.build_model(cfg, seed=0)
    randomize_bn_stats(torch, model, seed=1)
    batch_np = make_synthetic_batch(cfg, H=HH, W=WH)
    batch_np.pop("tar_img")
    batch_np["mask_at_box"] = human_mask(HH, WH)
    batch = et.to_device(batch_np, "cuda")
    N = HH * WH
    shapes = {"rgb_level1": [1, N, 3], "depth_level1": [1, N],
              "weights_level1": [1, N, 2],
              "depth_mvs_level1": [1, HH // 2, WH // 2],
              "std_level1": [1, HH // 2, WH // 2]}
    fields, launches, out = drive_frames(torch, "human", model, batch,
                                         HUMAN_PER_FRAME, shapes)
    outside = batch["mask_at_box"][0] == 0
    if bool((out["rgb_level1"][0][outside] != 0).any()):
        fail("human: rgb outside the mask is not 0")
    syncs = count_syncs(torch, lambda: et.render(model, batch))

    # every mask mode: full frame kernel vs plain path, 64x96 card vs CPU
    small = make_synthetic_batch(cfg, H=64, W=96)
    small["mask_at_box"] = human_mask(64, 96)
    modes = {}
    for mode, kw in (("window", {}),
                     ("multiply", dict(mask_window_hw=None)),
                     ("capacity", dict(mask_window_hw=None,
                                       mask_ray_capacity=0.5))):
        mcfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, **kw))
        m = et.build_model(mcfg, seed=0)
        m.load_state_dict(model.state_dict())
        reset_launches()
        o = et.render(m, batch)
        launched = read_launches()
        if launched != HUMAN_PER_FRAME:
            fail(f"human {mode}: kernel launches {launched} a frame")
        with plain_path():
            ref = et.render(m, batch)
        err = {k: max_err(torch, o[k], ref[k], E2E_RTOL, E2E_ATOL[k],
                          f"human {mode} {k} kernel vs plain path")
               for k in o}
        small_cfg = dataclasses.replace(mcfg, enerf=dataclasses.replace(
            mcfg.enerf, mask_window_hw=(64, 64) if mode == "window" else None))
        sm = et.build_model(small_cfg, seed=0)
        sm.load_state_dict(model.state_dict())
        modes[mode] = {"launches": launched, "kernel_vs_plain_max_abs_err": err,
                       "card_vs_cpu_64x96_max_abs_err": card_vs_cpu(
                           torch, f"human {mode} 64x96", sm, small)}
    emit("human", H=HH, W=WH, window_hw=list(cfg.enerf.mask_window_hw),
         mask_share=float(batch["mask_at_box"].mean()), **fields,
         syncs_per_frame=syncs, modes=modes)
    profile_device(torch, "human_profile", lambda: et.render(model, batch),
                   2, "frame")
    cases = hold_path_kernels(torch, "human", model, batch, HUMAN_PER_FRAME)
    return launches, cases


def phase_composite(torch):
    """The composite frame (``bench.py:run_composite``'s workload):
    ``ENeRFComposite`` at 512x640, 3 source views, 1 fg layer in a
    (256, 192) window, bg volume planes (16, 4), fg volume planes (32, 8),
    num_samples (2, 1), level 1 rendered, through ``build_model`` /
    ``render``; card vs CPU at 128x160 with a centered window and one
    across the frame's edge."""
    import dataclasses

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import composite_eval_config
    from enerf_tpu_torch.datasets.synthetic import make_composite_batch

    cfg = composite_eval_config()
    model = et.build_model(cfg, seed=0)
    randomize_bn_stats(torch, model, seed=2)
    batch_np = make_composite_batch(cfg, H=H, W=W)
    batch_np.pop("tar_img")
    batch = et.to_device(batch_np, "cuda")
    N = H * W
    shapes = {"rgb_level1": [1, N, 3], "depth_level1": [1, N],
              "weights_level1": [1, N, 2]}
    fields, launches, out = drive_frames(torch, "composite", model, batch,
                                         COMPOSITE_PER_FRAME, shapes)
    syncs = count_syncs(torch, lambda: et.render(model, batch))

    small_cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
        cfg.enerf, fg_bbox_hw=(64, 64)))
    sm = et.build_model(small_cfg, seed=0)
    sm.load_state_dict(model.state_dict())
    err_cpu = {}
    for where, xy in (("centered", None), ("edge", (140, 100))):
        small = make_composite_batch(small_cfg, H=128, W=160)
        small.pop("tar_img")
        if xy is not None:
            small["bbox"][0, 0, :2] = xy
        err_cpu[where] = card_vs_cpu(torch, f"composite 128x160 {where}", sm,
                                     small)
    emit("composite", H=H, W=W, fg_bbox_hw=list(cfg.enerf.fg_bbox_hw),
         bbox=batch_np["bbox"].tolist(), **fields, syncs_per_frame=syncs,
         card_vs_cpu_128x160_max_abs_err=err_cpu)
    profile_device(torch, "composite_profile",
                   lambda: et.render(model, batch), 2, "frame")
    cases = hold_path_kernels(torch, "composite", model, batch,
                              COMPOSITE_PER_FRAME)
    return launches, cases


@contextlib.contextmanager
def timed_val_frames(timer, frame_ms, stages):
    """``Trainer.val``'s render with the stage hook of ``timer``: each
    frame's time (CUDA events from before the batch's upload to the last
    stage) and stage times appended to ``frame_ms`` and ``stages``."""
    import enerf_tpu_torch as et
    import enerf_tpu_torch.train.trainer as trainer_mod

    def render(model, batch):
        timer.start()
        out = et.render(model, batch, stage_hook=timer)
        frame_ms.append(timer.total_ms())
        stages.append(timer.stages_ms())
        return out

    saved = trainer_mod.render
    trainer_mod.render = render
    try:
        yield
    finally:
        trainer_mod.render = saved


def phase_val(torch):
    """The val main path: ``Trainer.val`` of the port's default cascade
    (``Config()``, dtu_pretrain's: planes (64, 8), num_samples (8, 2),
    render_if (True, True), grid rays; its val batches carry 4 view slots,
    3 real, as ``train_input_views`` (2, 3, 4) pads them) over
    ``VAL_BATCHES`` 512x640 synthetic frames, scored by the evaluator
    ``make_evaluator(cfg)`` gives (PSNR, SSIM, LPIPS on seeded random
    weights), with the launch counts reset just before and read just after;
    then the kernel path vs the plain path, the card vs the CPU at 128x160,
    a profile of two frames and every kernel call of a frame on its own."""
    import dataclasses
    import tempfile

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import Config
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.eval.lpips import write_seeded_weights
    from enerf_tpu_torch.factory import make_evaluator
    from enerf_tpu_torch.train import Trainer, create_train_state

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(workspace=tmp)
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, grid_rays=True))
        model = et.build_model(cfg, seed=0)
        randomize_bn_stats(torch, model, seed=3)
        batches = []
        for i in range(VAL_BATCHES):
            b = make_synthetic_batch(cfg, H=H, W=W, seed=i)
            b.pop("tar_img")
            batches.append(b)
        lpips_path = str(Path(tmp) / "lpips_vgg.npz")
        write_seeded_weights(lpips_path, seed=9)
        evaluator = make_evaluator(cfg, lpips_path=lpips_path)
        trainer = Trainer(cfg, train_step=None)
        state = create_train_state(cfg, model)

        timer, frame_ms, stages = StageTimer(torch), [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with timed_val_frames(timer, frame_ms, stages):
            result = trainer.val(0, state, batches, evaluator=evaluator)
        val_s = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: v * VAL_BATCHES for k, v in VAL_PER_FRAME.items()}
    if launches != expect:
        fail(f"val: kernel launches on the main path {launches}, expected "
             f"{expect}")
    if not ({"psnr", "ssim", "lpips"} <= set(result) and all(
            v == v and abs(v) != float("inf") for v in result.values())):
        fail(f"val: metrics {result}")
    model.eval()                     # Trainer.val leaves it in training mode

    batch = et.to_device(batches[0], "cuda")
    out = et.render(model, batch)
    n0, n1 = (H // 4) * (W // 4), H * W
    shapes = {"rgb_level0": [1, n0, 3], "depth_level0": [1, n0],
              "weights_level0": [1, n0, 8],
              "depth_mvs_level0": [1, H // 8, W // 8],
              "std_level0": [1, H // 8, W // 8],
              "rgb_level1": [1, n1, 3], "depth_level1": [1, n1],
              "weights_level1": [1, n1, 2],
              "depth_mvs_level1": [1, H // 2, W // 2],
              "std_level1": [1, H // 2, W // 2]}
    got = {k: list(v.shape) for k, v in out.items()}
    if got != shapes:
        fail(f"val: output shapes {got}, expected {shapes}")
    with plain_path():
        ref = et.render(model, batch)
    err = {k: max_err(torch, out[k], ref[k], E2E_RTOL, E2E_ATOL[k],
                      f"val {k} kernel vs plain path") for k in out}
    small = make_synthetic_batch(cfg, H=128, W=160)
    small.pop("tar_img")
    err_cpu = card_vs_cpu(torch, "val 128x160", model, small)
    timed = stages[1:]               # the first frame excluded
    timed_ms = frame_ms[1:]
    emit("val", H=H, W=W, batches=VAL_BATCHES,
         view_slots=int(batch["view_mask"].numel()),
         views_valid=float(batch["view_mask"].sum()),
         launches=launches,
         launches_per_frame={k: v / VAL_BATCHES for k, v in launches.items()},
         frame_ms=frame_ms, median_frame_ms=statistics.median(timed_ms),
         frame_ms_spread={"min": min(timed_ms), "max": max(timed_ms),
                          "stdev": statistics.stdev(timed_ms)},
         median_stage_ms={k: statistics.median(st[k] for st in timed)
                          for k in timed[0]},
         val_seconds=val_s, metrics=result, peak_mem_gb=peak_gb,
         kernel_vs_plain_max_abs_err=err,
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL},
         card_vs_cpu_128x160_max_abs_err=err_cpu)
    profile_device(torch, "val_profile", lambda: et.render(model, batch), 2,
                   "frame")
    cases = hold_path_kernels(torch, "val", model, batch, VAL_PER_FRAME)
    return launches, cases


def phase_profile(torch, model, batch, frames: int = 2) -> None:
    """Device kernel time by name and the device's idle share over
    ``frames`` frames."""
    import enerf_tpu_torch as et

    profile_device(torch, "profile", lambda: et.render(model, batch), frames,
                   "frame")


def profile_device(torch, phase, run_once, n: int, unit: str) -> None:
    """Device kernel time by name and the device's idle share over ``n``
    calls of ``run_once``, from torch.profiler's CUDA trace (a session
    with no device record at all is run again, as in ``device_kernel_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run_once()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
        print(f"chip_smoke: {phase}: the profiler recorded no device "
              "activity; profiling again", file=sys.stderr)
    else:
        fail(f"{phase}: the profiler recorded no device activity 6 times")
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
                     warmup: int = 5, tries: int = 6) -> float:
    """Mean device time of the kernel named ``kernel_name`` over the last
    ``n`` of ``warmup + n`` calls of ``fn``, from torch.profiler's CUDA
    trace: the kernel alone, without the host time of its wrapper that CUDA
    events around a call include. The trace now and then lacks launches
    (CUPTI drops records, up to three sessions in a row have been seen): a
    session with fewer than ``n`` is run again after a short pause, at most
    ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
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


def k4_plan_device_ms(torch, kdr, logits, values, inv, ppt, want):
    """Device time of the depth-regression kernel under another plan than
    the wrapper's: ``ppt`` planes a thread, as many groups as that takes,
    launched through its C function. Its output must equal ``want`` (the
    wrapper's) within K4_TOL. Not counted in the wrapper's launches."""
    from enerf_tpu_torch.ops.kernels import _build

    B, D, Hv, Wv = logits.shape
    groups = -(-D // ppt)
    tiles = max(1, kdr.BLOCK_WARPS // groups)
    fn = _build.load_function("depth_regression", "enerf_depth_regression",
                              kdr._ARGTYPES)
    out = [torch.empty_like(want[0]), torch.empty_like(want[1])]
    stream = _build.stream_handle(logits.device)

    def call():
        _build.check_rc("depth_regression", fn(
            logits.data_ptr(), values.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), B, D, Hv, Wv, int(inv),
            int(logits.dtype == torch.bfloat16), ppt, groups, tiles, stream))

    ms = device_kernel_ms(torch, call, "depth_regression_kernel")
    for k, o, w in zip(("depth", "std"), out, want):
        max_err(torch, o, w, what=f"k4 {ppt} planes a thread {k}", **K4_TOL)
    return ms


def phase_k4(torch, cfg):
    """Depth-regression kernel vs plain, forward and gradient, at the
    train shapes of both levels and the eval level-0 shape, then 5 planes
    over a ragged pixel count, a batch of 2 and bfloat16 inputs; the
    device time of every planes-per-thread plan at the f32 train and eval
    shapes and the ragged one; and the launch floor."""
    from enerf_tpu_torch.ops.depth import init_depth_values
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr

    g = torch.Generator().manual_seed(4)
    cases = []
    for name, (B, D, Hv, Wv), inv, dtype in (
            ("train_level0", (1, 64, H // 8, W // 8), True, torch.float32),
            ("train_level1", (1, 8, H // 2, W // 2), False, torch.float32),
            ("eval_level0", (1, 48, H // 8, W // 8), True, torch.float32),
            ("d5_ragged", (1, 5, 61, 83), False, torch.float32),
            ("b2_level0", (2, 64, H // 8, W // 8), True, torch.float32),
            ("bf16_train_level0", (1, 64, H // 8, W // 8), True,
             torch.bfloat16),
            ("bf16_train_level1", (1, 8, H // 2, W // 2), False,
             torch.bfloat16),
            # D = 32 at the 512x640 level 0 (the composite's fg volume,
            # padded to the frame) and D = 4 at level 1 (its bg); every
            # shape of the human and composite frames is held on the
            # frame's own inputs in ``hold_path_kernels``
            ("d32_level0", (1, 32, H // 8, W // 8), True, torch.float32),
            ("d4_level1", (1, 4, H // 2, W // 2), False, torch.float32)):
        logits = (2.0 * torch.randn(B, D, Hv, Wv, generator=g)).to(
            "cuda", dtype)
        if inv:        # level 0: planes uniform in disparity, every pixel
            near_far = torch.tensor([[2.5, 5.5]]).expand(B, 2)
            values, _ = init_depth_values(near_far, D, Hv, Wv, True)
        else:          # level 1: per-pixel planes in a band around a surface
            near = 3.0 + 0.6 * torch.rand(B, 1, Hv, Wv, generator=g)
            band = 0.05 + 0.4 * torch.rand(B, 1, Hv, Wv, generator=g)
            lin = torch.linspace(0, 1, D)[None, :, None, None]
            values = (near + lin * band).contiguous()
        values = values.to("cuda", dtype)
        tol = (K4_BF16_TOL if dtype == torch.bfloat16
               else {"depth": K4_TOL, "std": K4_TOL})
        plain = kdr.depth_regression_plain(logits, values, inv)
        out = kdr.depth_regression(logits, values, inv)
        torch.cuda.synchronize()
        err = max(max_err(torch, o, p, what=f"k4 {name} {k}", **tol[k])
                  for k, o, p in zip(("depth", "std"), out, plain))
        # gradient: the Function's backward vs autograd of the plain version
        gd = torch.randn(B, Hv, Wv, generator=g).to("cuda", dtype)
        gs = torch.randn(B, Hv, Wv, generator=g).to("cuda", dtype)
        grads = []
        for fn in (kdr.depth_regression, kdr.depth_regression_plain):
            lt = logits.clone().requires_grad_()
            vt = values.clone().requires_grad_()
            d, sd = fn(lt, vt, inv)
            grads.append(torch.autograd.grad((d, sd), (lt, vt), (gd, gs)))
        grad_err = max(max_err(torch, a, b, what=f"k4 {name} grad {k}",
                               **tol["std"])
                       for k, a, b in zip(("logits", "values"), *grads))
        call = lambda: kdr.depth_regression(logits, values, inv)  # noqa: E731
        t_k = time_ms(torch, call, reps=50, warmup=5)
        t_run = run_ms(torch, call)
        dev_ms = device_kernel_ms(torch, call, "depth_regression_kernel")
        t_p = time_ms(torch, lambda: kdr.depth_regression_plain(
            logits, values, inv), reps=50, warmup=5)
        io = nbytes(logits, values, *out)
        # per plane: max, exp, 2 adds, 2 FMA for Σe and Σe·v, 3 for the
        # moment; the disparity's divide
        flops = logits.numel() * (10 + (2 if inv else 0))
        bd, by = bound_ms(io, flops)
        ppt, groups, tiles, blocks = kdr.plan(D, B * Hv * Wv)
        case = dict(case=name, shape=list(logits.shape),
                    dtype=str(dtype).replace("torch.", ""), depth_inv=inv,
                    plan={"planes_per_thread": ppt, "groups": groups,
                          "pixel_tiles": tiles, "blocks": blocks},
                    max_abs_err=err, grad_max_abs_err=grad_err, tol=tol,
                    ms=t_k, run_ms=t_run, device_ms=dev_ms, plain_ms=t_p,
                    bound_ms=bd, bound_by=by, bytes=io, flops=flops)
        if name in ("train_level0", "train_level1", "eval_level0",
                    "d5_ragged"):
            case["device_ms_by_planes_per_thread"] = {
                p: k4_plan_device_ms(torch, kdr, logits, values, inv, p, out)
                for p in (1, 2, 4, 8) if -(-D // p) <= kdr.MAX_GROUPS}
        emit("k4", **case)
        cases.append(case)
    return cases


def phase_k4_floor(torch) -> dict:
    """An empty kernel (``csrc/depth_regression.cu:enerf_empty_kernel``):
    its device time is the least any launch takes on this card."""
    import ctypes

    from enerf_tpu_torch.ops.kernels import _build

    fn = _build.load_function("depth_regression", "enerf_empty_kernel",
                              [ctypes.c_void_p])
    stream = _build.stream_handle(torch.device("cuda"))

    def call():
        _build.check_rc("empty", fn(stream))

    floor = dict(device_ms=device_kernel_ms(torch, call, "empty_kernel"),
                 run_ms=run_ms(torch, call), ms=time_ms(torch, call))
    emit("k4_floor", **floor)
    return floor


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
    reset_launches()
    losses, step_ms, phases = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        timer.start()
        state, stats = step(state, batch, phase_hook=timer)
        losses.append({k: float(v) for k, v in stats.items()})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        phases.append(timer.stages_ms())
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # training runs the plain, differentiable cost volume and render stage
    # and the depth-regression kernel (plain-recompute backward)
    expect = {"cost_volume": 0, "render": 0, "render_l0": 0,
              "depth_regression": 2 * n}
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
    l0_resources = phase_build()
    k1 = phase_k1(torch, cfg)
    k1_crop = phase_k1_crop(torch)
    k2 = phase_k2(torch, cfg)
    k2_l0 = phase_k2_l0(torch, cfg)
    paths = {}
    paths["frames"], model, batch = phase_frames(torch, cfg)
    phase_profile(torch, model, batch)
    del model, batch
    paths["human"], human_calls = phase_human(torch)
    paths["composite"], composite_calls = phase_composite(torch)
    paths["val"], val_calls = phase_val(torch)
    path_calls = {"human": human_calls, "composite": composite_calls,
                  "val": val_calls}
    k4 = phase_k4(torch, cfg)
    floor = phase_k4_floor(torch)
    paths["train"], state, step, train_batch = phase_train(torch)
    profile_device(torch, "train_profile",
                   lambda: step(state, train_batch), 2, "step")

    def launches(kernel):
        by_path = {p: n[kernel] for p, n in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def on_paths(kernel):
        """A frame's calls of ``kernel`` on each variant's path, each held
        on its own (``hold_path_kernels``): summed times and bound."""
        # K2's products (both head shapes) bounded on the tensor cores
        tc = kernel in ("render", "render_l0")
        by_path = {}
        for path, cases in path_calls.items():
            cs = [c for c in cases if c["kernel"] == kernel]
            if not cs:
                continue
            bd, by = bound_ms(
                sum(c["bytes"] for c in cs),
                (TF32_PASSES if tc else 1) * sum(c["flops"] for c in cs),
                TF32_FLOPS_PER_S if tc else F32_FLOPS_PER_S)
            by_path[path] = {
                "calls": len(cs),
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "device_ms": sum(c["device_ms"] for c in cs),
                "plain_ms": sum(c["plain_ms"] for c in cs),
                "bound_ms": bd, "bound_by": by}
        return by_path

    def path_err(kernel):
        return max((c["max_abs_err"] for cases in path_calls.values()
                    for c in cases if c["kernel"] == kernel), default=0.0)

    per_frame = [c for c in k1 if c["case"] in ("level0", "level1")]
    full = k2[0]   # the frame's shape: 327,680 rays, S = 3
    full_l0 = k2_l0[0]   # level 0 of a 512x640 frame: 20,480 rays, S = 3
    k1_bound, k1_by = bound_ms(sum(c["bytes"] for c in per_frame),
                               sum(c["flops"] for c in per_frame))
    per_step = [c for c in k4 if c["case"].startswith("train_")]
    k4_bound, k4_by = bound_ms(sum(c["bytes"] for c in per_step),
                               sum(c["flops"] for c in per_step))
    crop_frame = [c for c in k1_crop if c["case"] in ("fg_level0", "fg_level1")]
    kernels = [
        {"name": "cost_volume", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/cost_volume.cu",
         "replaces": "enerf_tpu/ops/pallas/cost_volume.py:122",
         **launches("cost_volume"),
         "max_abs_err": max(max(c["max_abs_err"] for c in k1 + k1_crop),
                            path_err("cost_volume")),
         # per DTU frame: the level-0 and level-1 launches together
         "ms": sum(c["ms"]["median"] for c in per_frame),
         "run_ms": sum(c["run_ms"] for c in per_frame),
         "device_ms": sum(c["device_ms"] for c in per_frame),
         "plain_ms": sum(c["plain_ms"]["median"] for c in per_frame),
         "bound_ms": k1_bound, "bound_by": k1_by,
         # the crop mode: the composite frame's two fg windows
         "crop_device_ms": sum(c["device_ms"] for c in crop_frame),
         "crop_plain_ms": sum(c["plain_ms"]["median"] for c in crop_frame),
         "crop_bound_ms": sum(c["bound_ms"] for c in crop_frame),
         # a human and a composite frame's calls, each on its own inputs
         "per_frame_by_path": on_paths("cost_volume"),
         "library_ms": None},
        {"name": "render", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/render.cu",
         "replaces": "enerf_tpu/ops/pallas/render.py:426",
         **launches("render"),
         "max_abs_err": max(max(c["max_abs_err"] for c in k2),
                            path_err("render")),
         "ms": full["ms"]["median"], "run_ms": full["run_ms"],
         "device_ms": full["device_ms"],
         "plain_ms": full["plain_ms"]["median"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "bound_f32_ms": full["bound_f32_ms"],
         "per_frame_by_path": on_paths("render"), "library_ms": None,
         "library_ms_reason": LIBRARY_NONE_RENDER},
        {"name": "render_l0", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/render_l0.cu",
         "replaces": "enerf_tpu/ops/pallas/render.py:426",
         **launches("render_l0"),
         "max_abs_err": max(max(c["max_abs_err"] for c in k2_l0),
                            path_err("render_l0")),
         # a 512x640 frame's level 0: 20,480 rays, S = 3
         "ms": full_l0["ms"]["median"], "run_ms": full_l0["run_ms"],
         "device_ms": full_l0["device_ms"],
         "plain_ms": full_l0["plain_ms"]["median"],
         "bound_ms": full_l0["bound_ms"], "bound_by": full_l0["bound_by"],
         "bound_f32_ms": full_l0["bound_f32_ms"],
         "per_frame_by_path": on_paths("render_l0"),
         # by S: ptxas' registers and spill bytes, the dynamic shared memory
         "resources_by_s": l0_resources, "library_ms": None,
         "library_ms_reason": LIBRARY_NONE_RENDER},
        {"name": "depth_regression", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/depth_regression.cu",
         "replaces": "enerf_tpu/ops/pallas/reductions.py:66",
         **launches("depth_regression"),
         "max_abs_err": max(max(max(c["max_abs_err"], c["grad_max_abs_err"])
                                for c in k4 if c["dtype"] == "float32"),
                            path_err("depth_regression")),
         "max_abs_err_bf16": max(max(c["max_abs_err"], c["grad_max_abs_err"])
                                 for c in k4 if c["dtype"] == "bfloat16"),
         # per train step: the level-0 and level-1 launches together
         "ms": sum(c["ms"]["median"] for c in per_step),
         "run_ms": sum(c["run_ms"] for c in per_step),
         "device_ms": sum(c["device_ms"] for c in per_step),
         # an empty kernel's device time, twice (two launches a step)
         "launch_floor_ms": 2 * floor["device_ms"],
         "plain_ms": sum(c["plain_ms"]["median"] for c in per_step),
         "bound_ms": k4_bound, "bound_by": k4_by,
         "per_frame_by_path": on_paths("depth_regression"),
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

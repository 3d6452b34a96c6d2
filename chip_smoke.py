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
           device alone (torch.profiler; every session opens with 128 spin
           kernels, since the trace loses a session's first records)
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
  layer_render  the composite's layered render kernel (csrc/layer_render.cu)
           on a frame of the outdoor_composite cell's scene (768x1024, 3
           views, a 512x256 fg window), its call held against the plain
           version; device, event, run and plain ms beside the bound from
           benchmark/work_composite.py's layer_render bytes and FLOPs
  bf16     the bf16 compute mode (compute_dtype: bfloat16): the DTU,
           human, composite and val frames at full size (launches of the
           bf16 variants only, each counted from 0; frame ms by CUDA
           events, peak memory, the frame vs the bf16 plain path and its
           gap to the float32 frame beside the CPU yardstick; every
           kernel call of a frame vs its plain version), the 512x640 train
           step (ms and split, peak memory, K4-mixed launches, the loss
           beside float32's), and each bf16 variant's device ms
           (torch.profiler, mean of 20, no record lost), event and plain
           ms and bound: K1-bf16, K2-bf16, K2-L0-bf16, K4-mixed
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
           path, the card vs the CPU at 128x160; the bytes a frame uploads
           (every array of the batch, and the device inputs that are
           uploaded); then ``val_profile`` and ``val_kernels`` (as
           ``human_kernels``)
  run_dtu  the data path from files on disk: a DTU-layout scene scan114
           written at DTU's sizes under build/dtu_fixture (49 MVSNet
           cameras, 49 512x640 PNGs whose rows cycle through the five PNG
           filters, 1200x1600 PFM depths of the four dtu_val views) and
           evaluated by ``python -m enerf_tpu_torch.run``'s ``main`` in this
           process on configs/enerf/dtu_pretrain.yaml (4 frames, launches a
           frame K1 2, K4 2, render 1, render_l0 1); the first frame vs the
           plain path, the metrics vs ``Trainer.val`` + ``make_evaluator``
           over the same loader, ``--type dataset`` in a subprocess, the
           native host library loaded; the loader's host ms a batch and its
           parts, frame ms (CUDA events, first frame excluded), bytes
           uploaded a frame, the card's name and power limit; then
           ``run_dtu_profile`` (device busy, idle share over two frames)
  jpeg     the native host library is the build of this checkout; its
           JPEG decoder holds a committed Pillow file to its pixel
           checksum bit for bit; encode + decode of a 1024x1024 and a
           1080x1920 image (PSNR, host ms)
  run_zjumocap  a ZJU-MoCap-layout CoreView_313 written under
           build/video_fixture (6 cameras x 2 frames of 1024x1024 JPEGs,
           PNG masks, annots.npy with lens distortion, new_vertices) and
           evaluated by ``enerf_tpu_torch.run``'s ``main`` on
           zjumocap_eval.yaml (ENeRFHuman at 512x512, window (448, 288)):
           launches a frame K1 2, K4 2, render 1; the first frame vs the
           plain path, the metrics vs Trainer.val; the loader's host ms
           and its parts (decode, undistort, resize, rays)
  run_outdoor  the same for an ENeRF-Outdoor-layout actor1 (4 cameras x 2
           frames of 1080x1920 JPEGs, bkgd plates, intri/extri.yml,
           vhull, background.ply) on actor1.yaml (ENeRFComposite at
           768x1024): K1 4, K4 4, layer_render 1 a frame
  interactive  ``python -m enerf_tpu_torch.gui_human --headless 12`` in a
           subprocess on the ZJU-MoCap scene (configs/enerf/interactive/
           zjumocap.yaml: ENeRFHuman at 512x512, window (448, 288), 2 of
           the 6 cameras a query, both frames cached at init): 12 frames
           along the camera rail, launches a frame K1 2, K4 2, render 1;
           the steady fps, each frame's query, upload (ms, bytes), rays +
           mask, forward, readback and u8 ms, the init seconds, the peak
           memory; the first frame vs the plain path and the CPU; the
           first query's rays and arrays vs their rebuild on the CPU and
           its mask_at_box vs numpy's slab test; interactive.mp4 read back
           by the port's reader
  visualize  ``enerf_tpu_torch.run``'s ``main`` with ``--type visualize`` on
           the outdoor scene (actor1_path.yaml, num_circle_view 4, one
           view a scene frame): launches a frame K1 4, K4 4,
           layer_render 1; frames,
           forward ms, the visualizer's and the encoding's host ms; the
           first frame vs the plain path; color.mp4 and depth.mp4 read
           back (frames, size, fps)
  k4       the depth-regression kernel vs its plain version, forward and
           gradient, at the train shapes of both cascade levels and the
           eval level-0 shape, then 5 planes over a ragged pixel count, a
           batch of 2 at level 0, and bfloat16 inputs at both train levels;
           times as for k1, and at the three main-path shapes and the
           ragged one the device time of every plan (planes per thread),
           launched through the kernel's C function
  k4_floor an empty kernel's device time on the same card: the launch floor
           beside K4's bounds
  wgrad    the 3D CNNs' weight-gradient kernel (csrc/conv3d_wgrad.cu) vs
           its plain version (cuDNN's weight gradient) at the 21 convs of
           the 512x640 train step: error, device ms (torch.profiler, its
           two kernels), event and plain ms, bound
  train    the train step of ``tools/bench_train.py``'s workload (512x640,
           3 source views, volume planes (64, 8), both levels rendering
           the full image on grid rays, MSE, Adam, seeded random weights)
           through ``build_model(train=True)`` / ``make_train_step``: step
           times and their forward / backward / optimizer split, peak
           memory, the loss of every step, kernel launch counts (the
           weight-gradient kernel 21 a step); one step
           with seeded random VGG16 weights (the perceptual term); a
           128x160 step on the card vs the same step on the CPU
  train_profile  torch.profiler over two train steps
  train_cli ``python -m enerf_tpu_torch.train`` in subprocesses: 2 epochs
           of 3 steps of zjumocap_train.yaml on the ZJU-MoCap scene (a
           checkpoint and a validation after each), a resume that starts
           at epoch 2, then 2 steps of actor1.yaml on the outdoor scene:
           step ms, loss, peak memory, K4 launched in training and the
           validation's kernels
  ddp      the data-parallel path: ``python -m torch.distributed.run
           --nproc_per_node 1 -m enerf_tpu_torch.train --distributed`` over
           NCCL on the ZJU-MoCap scene (3 steps; its first loss vs the run
           without --distributed, its checkpoint's keys), then 2 gloo ranks
           on the one card: DDP steps of the train workload at 512x640 on
           a global batch of 2 vs one process on it (loss, gradients,
           running statistics; each rank's step ms and all-reduce share)
           and the ray-split 512x640 DTU frame vs ``render`` (launches a
           rank K1 2, K2 1, K4 2)
  extras   the modules outside the frame paths: the zoo (ResUnet on
           3x512x640, CNNRender on 512x640, MinCostRegNetTri on level 1's
           (1, 8, 256, 320, 8) volume, MVSNeRFHead on 327,680 rays x 2
           samples x 3 views, the layered and dists compositing, the
           plane and shell samplers, the SH bases, homo_warp at level 0)
           on the card vs their CPU forward on the same weights (CUDA
           event ms, max abs error); extract_mesh of an analytic field
           queried on the card at N = 256 vs the same extraction queried
           on the CPU (query ms, marching ms); gui_human.run_gui on the
           interactive scene through stub glfw / OpenGL.GL modules
           (``stub_gl_modules``): 12 frames, launches a frame K1 2, K4 2,
           render 1, the last texture vs the headless frame at its pose,
           the loop's fps, draw_hud's ms
  profiler_lead  the lead-in records every profiler session lost
then a ``{"kernels": [...]}`` line (each kernel's launches on every main
path: frames, human, composite, val, run_dtu, run_zjumocap, run_outdoor,
interactive, visualize, train, train_cli, ddp, extras; its calls of a human, a
composite and a val frame in ``per_frame_by_path``; the bf16 variants as
entries of their own, launched on the bf16 paths), the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Float32 throughout but the bf16 phase,
TF32 off. A bound
counts each input read once and each output written once; K1's source
features only where its voxels' bilinear footprints touch them
(``k1_work``).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# a 61x45 4:2:0 JPEG written by Pillow (quality 85) and the sha256 of its
# pixels as imageio (libjpeg-turbo) decodes them: the native decoder is
# held to it bit for bit on the card, where no image library is installed
JPEG_FIXTURE = "enerf_tpu_torch/native/testdata/odd_420.jpg"
JPEG_FIXTURE_SHA256 = ("74992ce55c3b2963df7a1e2a2aa5333e"
                       "6a5369a7d30732dc899c8dc223d7842b")
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
# The bf16 compute mode (phase bf16). K1's bf16 variant vs its plain
# version: each rounds an f32 variance once to bf16, and the f32 values
# differ as K1_TOL allows, so a rounding may fall on either side: one bf16
# ulp (at most 2^-7 of the value) beside K1_TOL's atol. K2's and K2-L0's
# bf16-volume variants and K4's mixed variant compute in f32 from the same
# bf16 values as their plain versions, and are held as in f32.
BF16_TOLS = {"cost_volume": dict(rtol=2.0 ** -7, atol=1e-3),
             "render": K2_TOL, "depth_regression": K4_TOL,
             "layer_render": K2_TOL}
# The CPU yardstick: JAX's own bf16 forward vs its f32 forward, max |diff|
# at the DTU eval configuration, 64x96, 3 views (the JAX package's jnp path
# on the CPU). A bf16 frame is held to its bf16 plain path within half of
# it: a kernel's f32 reassociation before a bf16 rounding may flip that
# rounding, and a flip moves everything after it.
BF16_YARDSTICK = {"depth": 1.94e-2, "depth_mvs": 2.04e-2, "rgb": 7.5e-3,
                  "std": 3.3e-3, "weights": 2.7e-3}
BF16_FRAMES = 2       # counted frames of each bf16 frame path
BF16_TIMED = 10       # timed frames (CUDA events, after a first frame)
BF16_TRAIN_STEPS = 3  # timed bf16 train steps, after one
# bf16 variant launches a frame on each bf16 path (K1-bf16, K2-bf16,
# K2-L0-bf16, K4-mixed); every float32 variant launches none
BF16_PER_FRAME = {
    "dtu": (2, 1, 0, 2, 0), "human": (2, 1, 0, 2, 0),
    "composite": (4, 0, 0, 4, 1), "val": (2, 1, 1, 2, 0),
    "train": (0, 0, 0, 2, 0)}
BF16_KERNELS = ("cost_volume_bf16", "render_bf16", "render_l0_bf16",
                "depth_regression_mixed", "layer_render_bf16")
# kernel launches a frame (or a train step) on each main path; "render" is
# csrc/render.cu (level 1's head), "render_l0" csrc/render_l0.cu (level 0's),
# "layer_render" csrc/layer_render.cu (the composite's layered render, once
# a composite eval frame); no frame records a gradient, so none launches
# the weight-gradient kernel
FRAMES_PER_FRAME = {"cost_volume": 2, "render": 1, "render_l0": 0,
                    "depth_regression": 2, "conv3d_wgrad": 0,
                    "layer_render": 0}
HUMAN_PER_FRAME = {"cost_volume": 2, "render": 1, "render_l0": 0,
                   "depth_regression": 2, "conv3d_wgrad": 0,
                   "layer_render": 0}
COMPOSITE_PER_FRAME = {"cost_volume": 4, "render": 0, "render_l0": 0,
                       "depth_regression": 4, "conv3d_wgrad": 0,
                       "layer_render": 1}
VAL_PER_FRAME = {"cost_volume": 2, "render": 1, "render_l0": 1,
                 "depth_regression": 2, "conv3d_wgrad": 0,
                 "layer_render": 0}
# the kernels whose products run on the tensor cores in TF32_PASSES passes
TC_KERNELS = ("render", "render_l0", "layer_render")
# the layered render at the outdoor_composite cell's shapes (phase
# layer_render): 768x1024, 3 source views, a 512x256 fg window
K6_HW, K6_WINDOW = (768, 1024), (512, 256)
# the val main path: Trainer.val over this many frames, the first excluded
# from the times (as many timed frames as the other frame phases)
VAL_BATCHES = 1 + TIMED_FRAMES
# each kernel: (its source, the TPU kernel it replaces, why no PyTorch call
# computes the same function)
KERNEL_SOURCES = {
    "cost_volume": (
        "enerf_tpu_torch/csrc/cost_volume.cu",
        "enerf_tpu/ops/pallas/cost_volume.py:122",
        "no single PyTorch call warps, gathers and takes the masked "
        "variance"),
    "render": (
        "enerf_tpu_torch/csrc/render.cu", "enerf_tpu/ops/pallas/render.py:426",
        "no single PyTorch call computes the IBR head (projection, bilinear "
        "gather, Agg, MLPs) and the compositing"),
    "render_l0": (
        "enerf_tpu_torch/csrc/render_l0.cu",
        "enerf_tpu/ops/pallas/render.py:426",
        "no single PyTorch call computes the IBR head (projection, bilinear "
        "gather, Agg, MLPs) and the compositing"),
    "depth_regression": (
        "enerf_tpu_torch/csrc/depth_regression.cu",
        "enerf_tpu/ops/pallas/reductions.py:66",
        "no single PyTorch call computes softmax + expectation + std"),
    "conv3d_wgrad": (
        "enerf_tpu_torch/csrc/conv3d_wgrad.cu",
        "none (XLA's weight gradient of the 3D CNNs' convs)",
        "cuDNN's weight gradient is the plain version (plain_ms)"),
    "layer_render": (
        "enerf_tpu_torch/csrc/layer_render.cu",
        "none (the composite's raw heads and layered compositing, which "
        "the JAX package runs on XLA: render.py:378 render_rays_packed_xla's "
        "raw mode, raw2outputs_composite)",
        "no single PyTorch call shades the layers (projection, bilinear "
        "gather, Agg, MLPs) and composites them"),
}
# the weight-gradient kernel's launches a float32 train step: one a 3D conv
# whose weight gradient the step computes. DTU and ZJU-MoCap: MinCostRegNet's
# 9 at level 0, CostRegNet's 12 at level 1. The composite (actor1.yaml):
# a fg and a bg MinCostRegNet a level, 8 each (the composite keeps only
# the depth logits, so no gradient reaches the feature head)
WGRAD_PER_STEP = 21
WGRAD_PER_STEP_COMPOSITE = 32
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


def k6_work(args, out):
    """The bytes and operations of one layered render call: each layer's
    samples (xyz, z) and the features and rgb its rays read (the bg
    layer's whole tables, the fg layer's over its window, as
    ``benchmark/work_composite.py`` counts an fg table), the outputs once;
    the heads' multiply-adds as ``work_composite.head_macs`` counts them
    and ``COMPOSITE_MACS`` a sample to composite, 2 operations each."""
    from benchmark.work import COMPOSITE_MACS
    from benchmark.work_composite import head_macs

    fg, bg, win = args[:3]
    B, S, H, W = bg.feat.shape[:4]
    hr, wr = win.hw
    io, flops = nbytes(out["rgb"], out["depth"], out["weights"]), 0.0
    for lay, px in ((fg, hr * wr), (bg, H * W)):
        pv, ps = head_macs(lay.head.feat_ch, lay.head.viewdir_agg)
        samples = lay.world_xyz[..., 0].numel()
        flops += 2.0 * (S * pv + ps + COMPOSITE_MACS) * samples
        io += (nbytes(lay.world_xyz, lay.z_vals)
               + B * S * px * (lay.feat.shape[-1] * lay.feat.element_size()
                               + lay.rgb.shape[-1] * lay.rgb.element_size()))
    return io, flops


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
    return make_synthetic_batch(cfg, H=H, W=W, n_src=n_src)


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
        b = et.device_batch(_synthetic(cfg, n_src), "cuda")
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
        b = et.device_batch(bnp, "cuda")
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
        b = et.device_batch(_synthetic(cfg, n_src, slots), "cuda")
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
        b = et.device_batch(_synthetic(cfg, n_src, slots), "cuda")
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
     "kernel_depth_regression"),
    ("layer_render", "enerf_tpu_torch.ops.kernels.layer_render",
     "layer_render"))


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
    from enerf_tpu_torch.ops.kernels import layer_render as klr
    from enerf_tpu_torch.ops.kernels import render as krender

    plain = {"cost_volume": kcv.cost_volume_plain,
             "render": krender.render_rays_plain,
             "depth_regression": kdr.depth_regression_plain,
             "layer_render": klr.layer_render_plain}
    return swapped_kernels(lambda kernel, wrapper: plain[kernel])


def recorded_kernel_calls(torch, calls: list):
    """The same forward, each kernel call appended to ``calls`` as
    (kernel, args, kwargs) with its tensors cloned before the kernel runs;
    the kernels still run and count their launches."""
    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if hasattr(x, "_fields"):    # a NamedTuple (layer_render's Layer)
            return type(x)(*map(snap, x))
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
    ``recorded_kernel_calls``), within the kernel's tolerance for its
    input type (``BF16_TOLS`` for a bf16 variant's call), with its bound.
    The frame must make ``per_frame`` calls of each kernel. Returns the
    cases, each with the call and its plain version bound to its inputs
    (``fn``, ``plain_fn``) and the kernel's symbol, for the caller to time
    (``time_path_kernels``)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import layer_render as klr
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
                             "depth_regression_kernel"),
        "layer_render": (klr.layer_render, klr.layer_render_plain,
                         "layer_render_kernel")}
    cases = []
    with torch.inference_mode():
        for i, (kernel, args, kw) in enumerate(calls):
            wrapper, plain_fn, symbol = kernel_fns[kernel]
            # bound to this call's arguments (the cases keep them)
            call = functools.partial(wrapper, *args, **kw)
            plain_call = functools.partial(plain_fn, *args, **kw)
            out, ref = call(), plain_call()
            torch.cuda.synchronize()
            what = f"{path} call {i} {kernel}"
            case = dict(path=path, call=i, kernel=kernel)
            volume = (args[4] if kernel.startswith("render") else
                      args[0].feat if kernel == "layer_render" else args[0])
            tol = (BF16_TOLS[kernel.replace("_l0", "")]
                   if volume.dtype == torch.bfloat16 else None)
            if kernel == "cost_volume":
                window = kw.get("window")
                tol = tol or K1_TOL
                err = max_err(torch, out, ref, what=what, **tol)
                io, flops, pixels = k1_work(torch, *args, out, window)
                bd, by = bound_ms(io, flops)
                case.update(shape=list(out.shape), mode=(
                    "crop" if window is not None else "full"),
                    feature_pixels_read=pixels, tol=tol)
            elif kernel == "depth_regression":
                logits, values, inv = args
                tol = tol or K4_TOL
                err = max(max_err(torch, o, p, what=f"{what} {k}", **tol)
                          for k, o, p in zip(("depth", "std"), out, ref))
                io = nbytes(logits, values, *out)
                flops = logits.numel() * (10 + (2 if inv else 0))
                bd, by = bound_ms(io, flops)
                case.update(shape=list(logits.shape), depth_inv=inv,
                            plan=list(kdr.plan(logits.shape[1],
                                               logits[:, 0].numel())),
                            tol=tol)
            elif kernel == "layer_render":
                tol = tol or K2_TOL
                err = max(max_err(torch, out[k], ref[k], what=f"{what} {k}",
                                  **tol) for k in ("rgb", "depth", "weights"))
                io, flops = k6_work(args, out)
                bd, by = bound_ms(io, TF32_PASSES * flops, TF32_FLOPS_PER_S)
                fg, bg, win = args[:3]
                case.update(rays=bg.world_xyz.shape[1],
                            window_rays=fg.world_xyz.shape[1],
                            window_origin=win.xy0.tolist(),
                            slots=bg.feat.shape[1],
                            views_valid=(None if args[6] is None
                                         else float(args[6].sum())),
                            tol=tol)
            else:
                tol = tol or K2_TOL
                err = max(max_err(torch, out[k], ref[k], what=f"{what} {k}",
                                  **tol) for k in ("rgb", "depth", "weights"))
                io, flops, _ = k2_work(args, out)
                # both render kernels: the head's products in three TF32
                # passes on the tensor cores (render.cu's route)
                bd, by = bound_ms(io, TF32_PASSES * flops, TF32_FLOPS_PER_S)
                case.update(rays=args[0].shape[1], samples=args[0].shape[2],
                            slots=args[3].shape[1],
                            views_valid=(None if args[8] is None
                                         else float(args[8].sum())),
                            tol=tol)
            case.update(max_abs_err=err, bound_ms=bd, bound_by=by, bytes=io,
                        flops=flops, fn=call, plain_fn=plain_call,
                        symbol=symbol)
            cases.append(case)
    return cases


def emit_cases(cases) -> None:
    """One ``{path}_kernels`` line a case of ``hold_path_kernels``."""
    for case in cases:
        emit(f"{case['path']}_kernels",
             **{k: v for k, v in case.items() if not callable(v)})


def time_path_kernels(torch, cases):
    """``hold_path_kernels``' cases with each call's device time and its
    plain version's time, emitted. Returns the cases."""
    with torch.inference_mode():
        for case in cases:
            case.update(device_ms=device_kernel_ms(torch, case["fn"],
                                                   case["symbol"]),
                        plain_ms=time_ms(torch, case["plain_fn"], reps=5,
                                         warmup=1)["median"])
    emit_cases(cases)
    return cases


def cases_bound(kernel, cases, tensor_cores=True) -> tuple:
    """(bound ms, what bounds it) of ``cases``' calls of ``kernel``
    together: the render kernels' products on the tensor cores
    (TF32_PASSES passes) unless ``tensor_cores`` is False."""
    tc = tensor_cores and kernel in TC_KERNELS
    return bound_ms(sum(c["bytes"] for c in cases),
                    (TF32_PASSES if tc else 1) * sum(c["flops"] for c in cases),
                    TF32_FLOPS_PER_S if tc else F32_FLOPS_PER_S)


def kernel_entry(name, kernel, **fields) -> dict:
    """An entry of the kernels line: ``name``, a variant of ``kernel``,
    with its route, source, the TPU kernel it replaces, ``fields`` and a
    null ``library_ms`` with the reason (``KERNEL_SOURCES``)."""
    source, replaces, why = KERNEL_SOURCES[kernel]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **fields, "library_ms": None,
            "library_ms_reason": why}


def randomize_bn_stats(torch, model, seed):
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.copy_(1.0 + torch.rand(m.running_var.shape,
                                                 generator=g))


def reset_launches():
    from enerf_tpu_torch.ops.kernels import conv3d_wgrad as kwg
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import layer_render as klr
    from enerf_tpu_torch.ops.kernels import render as krender

    kcv.launches = kdr.launches = kcv.launches_bf16 = kdr.launches_mixed = 0
    kwg.launches = 0
    krender.reset_launches()
    klr.reset_launches()


def read_launches() -> dict:
    """The float32 variants' launches since the last reset, by kernel."""
    from enerf_tpu_torch.ops.kernels import conv3d_wgrad as kwg
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import layer_render as klr
    from enerf_tpu_torch.ops.kernels import render as krender

    return {"cost_volume": kcv.launches, **krender.launches,
            "depth_regression": kdr.launches, "conv3d_wgrad": kwg.launches,
            "layer_render": klr.launches}


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
    batch = et.device_batch(_synthetic(cfg, 3), "cuda")
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
    batch_np["mask_at_box"] = human_mask(HH, WH)
    batch = et.device_batch(batch_np, "cuda")
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
    cases = time_path_kernels(torch, hold_path_kernels(
        torch, "human", model, batch, HUMAN_PER_FRAME))
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
    batch = et.device_batch(batch_np, "cuda")
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
        if xy is not None:
            small["bbox"][0, 0, :2] = xy
        err_cpu[where] = card_vs_cpu(torch, f"composite 128x160 {where}", sm,
                                     small)
    emit("composite", H=H, W=W, fg_bbox_hw=list(cfg.enerf.fg_bbox_hw),
         bbox=batch_np["bbox"].tolist(), **fields, syncs_per_frame=syncs,
         card_vs_cpu_128x160_max_abs_err=err_cpu)
    profile_device(torch, "composite_profile",
                   lambda: et.render(model, batch), 2, "frame")
    cases = time_path_kernels(torch, hold_path_kernels(
        torch, "composite", model, batch, COMPOSITE_PER_FRAME))
    return launches, cases


def phase_layer_render(torch):
    """The layered render kernel (csrc/layer_render.cu) at the
    outdoor_composite cell's shapes: a frame of the cell's scene
    (``benchmark/scene_outdoor.py``: 768x1024, 3 source views, a 512x256
    fg window) through the composite model (seeded weights, BN statistics
    randomized), its ``layer_render`` call recorded and held on its own
    against the plain version (max abs error; median and 99th-percentile
    gaps); its device time (torch.profiler, mean of 20), CUDA-event time
    around one call and over a run of calls, and the plain version's,
    beside the bound from ``benchmark/work_composite.py``'s
    ``layer_render_flops`` (three TF32 passes at the tensor cores' rate)
    and ``layer_render_bytes``, and the bound ``layer_render_roofline``
    takes from them (one TF32 pass), the call's own bound (``k6_work``)
    and its f32 CUDA-core bound; ptxas' registers and spills. Returns the
    phase's fields."""
    import dataclasses

    import enerf_tpu_torch as et
    from benchmark import scene_outdoor
    from benchmark import work_composite as wc
    from benchmark.spec import cascade
    from enerf_tpu_torch.config import composite_eval_config
    from enerf_tpu_torch.ops.kernels import _build
    from enerf_tpu_torch.ops.kernels import layer_render as klr

    bench = ROOT / "benchmark"
    cell = json.loads((bench / "configs/enerf_outdoor.json").read_text())
    traffic = json.loads(
        (bench / "traffic/outdoor_composite.json").read_text())
    traffic["name"] = "outdoor_composite"
    if (tuple(cell["image_hw"]), tuple(cell["enerf"]["fg_bbox_hw"])) != (
            K6_HW, K6_WINDOW):
        fail(f"layer_render: the cell's shapes {cell['image_hw']}, "
             f"{cell['enerf']['fg_bbox_hw']} are not {K6_HW}, {K6_WINDOW}")
    batch = scene_outdoor.make_frames(cell, traffic, 7, "cuda", 1)[0]
    cfg = composite_eval_config()
    cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
        cfg.enerf, fg_bbox_hw=K6_WINDOW))
    model = et.build_model(cfg, seed=0)
    randomize_bn_stats(torch, model, seed=5)
    calls = []
    with recorded_kernel_calls(torch, calls):
        et.render(model, batch)
    k6 = [(a, k) for kernel, a, k in calls if kernel == "layer_render"]
    if len(k6) != 1:
        fail(f"layer_render: {len(k6)} calls in a composite frame")
    args, kw = k6[0]
    fn = functools.partial(klr.layer_render, *args, **kw)
    plain_fn = functools.partial(klr.layer_render_plain, *args, **kw)
    with torch.inference_mode():
        out, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        err = max(max_err(torch, out[k], ref[k], what=f"layer_render {k}",
                          **K2_TOL) for k in ("rgb", "depth", "weights"))
        gaps = {k: {p: float(torch.quantile(
            (out[k] - ref[k]).abs().flatten().double(), q))
            for p, q in (("p50", 0.5), ("p99", 0.99))}
            for k in ("rgb", "depth")}
        dev = device_kernel_ms(torch, fn, "layer_render_kernel")
        ev = time_ms(torch, fn)
        run = run_ms(torch, fn)
        plain = time_ms(torch, plain_fn, reps=5, warmup=1)
    io, flops = k6_work(args, out)
    cas = cascade(cell, False)
    H0, W0 = cell["image_hw"]
    S = cell["source_views"]
    cell_flops = wc.layer_render_flops(cell, cas, H0, W0, S)
    cell_bytes = wc.layer_render_bytes(cell, cas, H0, W0, S)
    bd, by = bound_ms(cell_bytes, TF32_PASSES * cell_flops, TF32_FLOPS_PER_S)
    # layer_render_roofline's bound: one pass at the TF32 rate
    roof_bd, roof_by = bound_ms(cell_bytes, cell_flops, TF32_FLOPS_PER_S)
    call_bd, call_by = bound_ms(io, TF32_PASSES * flops, TF32_FLOPS_PER_S)
    fields = dict(
        frame_hw=list(K6_HW), window_hw=list(K6_WINDOW), slots=S,
        window_origin=args[2].xy0.tolist(), max_abs_err=err, tol=K2_TOL,
        gaps=gaps, device_ms=dev, ms=ev, run_ms=run, plain_ms=plain,
        bound_ms=bd, bound_by=by, bound_from="benchmark/work_composite.py",
        work_flops=cell_flops, work_bytes=cell_bytes,
        roofline_bound_ms=roof_bd, roofline_bound_by=roof_by,
        roofline_share_of_kernel=roof_bd / dev,
        call_bound_ms=call_bd, call_bound_by=call_by,
        call_flops=flops, call_bytes=io,
        bound_f32_ms=bound_ms(io, flops)[0],
        ptxas=[ln for ln in ptxas_summary(_build.build_log("layer_render"))])
    emit("layer_render", **fields)
    return fields


@contextlib.contextmanager
def timed_val_frames(timer, frame_ms, stages):
    """``Trainer.val``'s render with the stage hook of ``timer``: each
    frame's time (CUDA events from before the batch's upload to the last
    stage) and stage times appended to ``frame_ms`` and ``stages``."""
    import enerf_tpu_torch as et
    import enerf_tpu_torch.train.trainer as trainer_mod

    def render(model, batch, stage_hook=None):
        # Trainer.val passes its own hook (None here): the timer's is used
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
        batches = [make_synthetic_batch(cfg, H=H, W=W, seed=i)
                   for i in range(VAL_BATCHES)]
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

    batch = et.device_batch(batches[0], "cuda")
    # the bytes a frame uploads: every array of the batch (what the upload
    # moved before host-only keys were kept on the host) and the device
    # inputs alone (``device_batch``), with the upload's time
    upload_all = sum(4 * v.size for v in batches[0].values())
    upload_dev = nbytes(*batch.values())
    upload_ms = time_ms(torch, lambda: et.device_batch(batches[0], "cuda"),
                        reps=10)
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
         upload_bytes_per_frame_all_arrays=upload_all,
         upload_bytes_per_frame=upload_dev, upload_ms=upload_ms,
         kernel_vs_plain_max_abs_err=err,
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL},
         card_vs_cpu_128x160_max_abs_err=err_cpu)
    profile_device(torch, "val_profile", lambda: et.render(model, batch), 2,
                   "frame")
    cases = time_path_kernels(torch, hold_path_kernels(
        torch, "val", model, batch, VAL_PER_FRAME))
    return launches, cases


DTU_SCENE = "scan114"
DTU_FOCAL = 1446.0          # px at 512x640, DTU's (361.5 at 1/4 resolution)
DTU_DISTANCE = 650.0        # camera to scene centre; depths in [425, 905]
DTU_RADIUS = 130.0          # the procedural object's radius
DTU_FILTERS = (0, 1, 2, 3, 4)   # PNG row filters, cycled over the rows
RUN_DTU_FRAMES = 4          # data/mvsnerf/pairs.th's dtu_val views


def _dtu_cameras():
    """49 world-to-camera extrinsics on a 7x7 arc of azimuths and
    elevations, ``DTU_DISTANCE`` from the origin, looking at it."""
    exts = []
    for el in np.linspace(0.15, 0.65, 7):
        for az in np.linspace(-0.5, 0.5, 7):
            eye = DTU_DISTANCE * np.array([np.cos(el) * np.sin(az),
                                           -np.cos(el) * np.cos(az),
                                           np.sin(el)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            R = np.stack([right, np.cross(fwd, right), fwd])
            ext = np.eye(4)
            ext[:3, :3], ext[:3, 3] = R, -R @ eye
            exts.append(ext)
    return exts


def _dtu_trace(ext, ixt, xs, ys, phases):
    """(z-depth, 0 where the ray misses; rgb in [0, 1]) of the pixels
    (xs, ys) of a camera looking at the textured sphere of radius
    ``DTU_RADIUS`` at the origin, over a gradient background."""
    R, t = ext[:3, :3], ext[:3, 3]
    o = -R.T @ t
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    d = pix @ np.linalg.inv(ixt).T @ R           # unit z in the camera
    a = np.einsum("...c,...c->...", d, d)
    b = d @ o
    disc = b * b - a * (o @ o - DTU_RADIUS ** 2)
    z = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    hit = (disc > 0) & (z > 0)
    p = (o + d * z[..., None]) / DTU_RADIUS
    fg = 0.5 + 0.45 * np.sin(p @ phases[:3].T * 12.0 + phases[3])
    bg = 0.25 + 0.2 * np.sin(d[..., :1] * 3.0 + phases[3])
    return np.where(hit, z, 0.0), np.where(hit[..., None], fg, bg)


def write_dtu_scene(root: Path, seed: int = 0) -> dict:
    """A DTU-layout scene ``DTU_SCENE`` under ``root/dtu`` at DTU's sizes:
    49 MVSNet cameras (intrinsics at 1/4 resolution), 49 512x640 RGB PNGs
    written by the port's PNG writer with the rows cycling through all five
    filter types, and 1200x1600 PFM depths of the ``dtu_val`` views, of a
    seeded procedural object. Returns the seconds each part took."""
    import shutil

    from enerf_tpu_torch.datasets.dtu import load_pairs, write_pfm
    from enerf_tpu_torch.utils.image_io import imwrite

    phases = np.random.RandomState(seed).uniform(-1.0, 1.0, (4, 3))
    base = root / "dtu"
    shutil.rmtree(base, ignore_errors=True)
    for sub in ("Cameras/train", f"Rectified/{DTU_SCENE}_train",
                f"Depths/{DTU_SCENE}"):
        (base / sub).mkdir(parents=True)
    ixt = np.array([[DTU_FOCAL, 0, W / 2], [0, DTU_FOCAL, H / 2], [0, 0, 1]])
    ixt4 = ixt.copy()
    ixt4[:2] /= 4
    secs = {"images": 0.0, "depths": 0.0}
    ys, xs = np.mgrid[0:H, 0:W]
    dys, dxs = np.mgrid[0:1200, 0:1600]
    val = set(load_pairs()["dtu_val"])
    for i, ext in enumerate(_dtu_cameras()):
        rows = ["extrinsic", *(" ".join(f"{v:.9g}" for v in r) for r in ext),
                "", "intrinsic",
                *(" ".join(f"{v:.9g}" for v in r) for r in ixt4),
                "", "425.0 2.5"]
        (base / f"Cameras/train/{i:08d}_cam.txt").write_text("\n".join(rows))
        t0 = time.perf_counter()
        _, rgb = _dtu_trace(ext, ixt, xs, ys, phases)
        imwrite(str(base / f"Rectified/{DTU_SCENE}_train/"
                           f"rect_{i + 1:03d}_3_r5000.png"),
                (rgb * 255).astype(np.uint8), filters=DTU_FILTERS)
        secs["images"] += time.perf_counter() - t0
        if i in val:
            # full-resolution pixel (u, v) of DTU's depth maps is pixel
            # (u / 2 - 80, v / 2 - 44) of the 512x640 image: the loader
            # halves the map and crops [44:556, 80:720]
            t0 = time.perf_counter()
            z, _ = _dtu_trace(ext, ixt, dxs / 2.0 - 80, dys / 2.0 - 44,
                              phases)
            write_pfm(str(base / f"Depths/{DTU_SCENE}/depth_map_{i:04d}.pfm"),
                      z.astype(np.float32))
            secs["depths"] += time.perf_counter() - t0
    return secs


def host_breakdown_ms(root: Path, cfg) -> dict:
    """The loader's host work of a test batch, each part timed alone on
    the fixture (median of 5, one thread): one PNG decode, its u8 -> float
    normalize, one PFM read at half resolution, the rays of both levels."""
    from enerf_tpu_torch import native
    from enerf_tpu_torch.datasets.dtu import read_pfm_depth_half
    from enerf_tpu_torch.datasets.ray_utils import build_rays_host
    from enerf_tpu_torch.utils.image_io import imread

    png = str(root / f"dtu/Rectified/{DTU_SCENE}_train/rect_001_3_r5000.png")
    pfm = str(next((root / f"dtu/Depths/{DTU_SCENE}").glob("*.pfm")))
    u8 = imread(png)
    img = native.u8_to_unit(u8)
    ext = np.eye(4, dtype=np.float32)
    ixt = np.array([[DTU_FOCAL, 0, W / 2], [0, DTU_FOCAL, H / 2], [0, 0, 1]],
                   np.float32)
    msk = np.ones((H, W), np.uint8)
    cas = cfg.enerf.cas_config

    def median_ms(fn, n=5):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    return {"png_decode": median_ms(lambda: imread(png)),
            "u8_to_unit": median_ms(lambda: native.u8_to_unit(u8)),
            "pfm_half": median_ms(lambda: read_pfm_depth_half(pfm)),
            "rays_both_levels": median_ms(lambda: [
                build_rays_host(img, ext, ixt, msk, cas.render_scale[i])
                for i in range(cas.num)])}


def phase_run_dtu(torch, smi_line: str):
    """The data path from files on disk: a DTU-layout scene written at
    DTU's sizes (``write_dtu_scene``) evaluated through the port's CLI,
    ``enerf_tpu_torch.run``'s ``main`` in this process (``--type evaluate``
    on ``configs/enerf/dtu_pretrain.yaml``, ``test_dataset.scene
    scan114``), its YAML read by the port's reader, its batches by the
    port's loader and DTU dataset, rendered by the model with all four
    kernels, scored by the evaluator; the launch counts reset just before
    and read just after. Then the first frame vs the plain path, the
    metrics vs ``Trainer.val`` + ``make_evaluator`` over the same loader,
    ``python -m enerf_tpu_torch.run --type dataset`` in a subprocess, a
    profile of two frames, and the loader's host parts alone."""
    import os

    import enerf_tpu_torch as et
    from enerf_tpu_torch import native, run
    from enerf_tpu_torch.config import make_cfg
    from enerf_tpu_torch.datasets.loader import make_data_loader
    from enerf_tpu_torch.factory import make_evaluator
    from enerf_tpu_torch.train import Trainer, create_train_state

    if not native.available():
        fail("run_dtu: the native host library did not build or load (g++): "
             "the loader would run its numpy fallbacks")
    fixture = ROOT / "build" / "dtu_fixture"
    cwd = os.getcwd()
    os.chdir(ROOT)       # the loaders read data/mvsnerf/pairs.th from here
    try:
        t0 = time.perf_counter()
        secs = write_dtu_scene(fixture)
        write_s = time.perf_counter() - t0
        args = ["--type", "evaluate", "--cfg_file",
                "configs/enerf/dtu_pretrain.yaml", "test_dataset.scene",
                DTU_SCENE, "workspace", str(fixture)]
        reset_launches()
        t0 = time.perf_counter()
        res = run.main(args)
        cli_s = time.perf_counter() - t0
        launches = read_launches()
        if res["frames"] != RUN_DTU_FRAMES:
            fail(f"run_dtu: {res['frames']} frames, expected {RUN_DTU_FRAMES}")
        expect = {k: v * RUN_DTU_FRAMES for k, v in VAL_PER_FRAME.items()}
        if launches != expect:
            fail(f"run_dtu: kernel launches on the main path {launches}, "
                 f"expected {expect}")
        cfg = make_cfg(args[3], args[4:])
        model, batch = res["model"], res["first_batch"]
        with plain_path():
            ref = et.render(model, batch)
        err = {k: max_err(torch, torch.from_numpy(v).cuda(), ref[k], E2E_RTOL,
                          E2E_ATOL[k], f"run_dtu {k} kernel vs plain path")
               for k, v in res["first_out"].items()}
        val = Trainer(cfg, train_step=None).val(
            0, create_train_state(cfg, run.load_eval_model(cfg, "cuda")),
            make_data_loader(cfg, "test"), evaluator=make_evaluator(cfg))
        metrics = res["metrics"]
        if not ({"psnr", "ssim"} <= set(metrics) and all(
                np.isfinite(v) for v in metrics.values())):
            fail(f"run_dtu: metrics {metrics}")
        metric_diff = {k: abs(metrics[k] - val[k]) for k in metrics}
        if any(d > 1e-6 * max(1.0, abs(metrics[k]))
               for k, d in metric_diff.items()):
            fail(f"run_dtu: the CLI's metrics {metrics} differ from "
                 f"Trainer.val's {val}")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        sub = subprocess.run(
            [sys.executable, "-m", "enerf_tpu_torch.run", "--type", "dataset",
             *args[2:]], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        sub_s = time.perf_counter() - t0
        if sub.returncode != 0 or f"batches: {RUN_DTU_FRAMES}" not in sub.stdout:
            fail(f"run_dtu: python -m enerf_tpu_torch.run --type dataset: rc "
                 f"{sub.returncode}\n{sub.stdout[-2000:]}\n{sub.stderr[-4000:]}")
        breakdown = host_breakdown_ms(fixture, cfg)
    finally:
        os.chdir(cwd)
    timed = res["frame_ms"][1:]
    emit("run_dtu", scene=DTU_SCENE, H=H, W=W, frames=res["frames"],
         fixture_seconds=write_s, fixture_parts_seconds=secs,
         png_filters=list(DTU_FILTERS), native=native.available(),
         cli_seconds=cli_s, launches=launches,
         launches_per_frame={k: v / RUN_DTU_FRAMES
                             for k, v in launches.items()},
         loader_host_ms=res["loader_host_ms"],
         median_loader_host_ms=statistics.median(res["loader_host_ms"]),
         loader_wait_ms=res["loader_wait_ms"],
         loader_host_parts_ms=breakdown,
         frame_ms=res["frame_ms"], median_frame_ms=statistics.median(timed),
         mean_frame_ms=statistics.mean(timed), fps=res["fps"],
         upload_ms=res["upload_ms"], upload_bytes_per_frame=res["upload_bytes"],
         view_slots=int(batch["view_mask"].shape[-1]),
         views_valid=float(batch["view_mask"].sum()),
         metrics=metrics, trainer_val_metrics={k: val[k] for k in metrics},
         metric_abs_diff=metric_diff, kernel_vs_plain_max_abs_err=err,
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL},
         dataset_subprocess_seconds=sub_s, nvidia_smi=smi_line)
    dev_batch = et.device_batch(batch, "cuda")
    with torch.inference_mode():
        profile_device(torch, "run_dtu_profile", lambda: model(dev_batch), 2,
                       "frame")
    return launches


def phase_profile(torch, model, batch, frames: int = 2) -> None:
    """Device kernel time by name and the device's idle share over
    ``frames`` frames."""
    import enerf_tpu_torch as et

    profile_device(torch, "profile", lambda: et.render(model, batch), frames,
                   "frame")


# torch.profiler's CUDA trace loses the first kernel records of a session,
# torch's own kernels as well as the port's (cause not found: ROADMAP.md,
# Queue 3 item 3). A pause of LEAD_PAUSE_S on the host between opening a
# session and its first kernel makes the large losses rare (on the H100:
# a session lost 35 to all 128 of its lead-in in 7 of 162 sessions
# without the pause, in 3 of 342 with it), not the small ones (1-12
# records in most sessions either way). Each session therefore pauses,
# then opens with LEAD_LAUNCHES spin kernels that take and count the loss
# (the ``profiler_lead`` line); a session in which none of them survived
# may have lost measured launches and is run again.
LEAD_PAUSE_S = 0.02
LEAD_LAUNCHES = 128
LEAD_KERNEL = "spin_kernel"      # the kernel of torch.cuda._sleep
LEAD_LOST = []                   # (session label, lead records lost)
CURRENT_PHASE = "start"          # main()'s running phase (``run_phase``)


def run_phase(name: str, fn, *args):
    """``fn(*args)`` as the phase ``name``, which labels its profiler
    sessions."""
    global CURRENT_PHASE
    CURRENT_PHASE = name
    return fn(*args)


def lead_in(torch) -> None:
    """Open a profiler session: a LEAD_PAUSE_S pause on the host, then
    LEAD_LAUNCHES spin kernels of ~100 cycles, then a synchronize."""
    time.sleep(LEAD_PAUSE_S)
    for _ in range(LEAD_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def split_lead(events, label: str) -> tuple:
    """(whether a lead-in record survived, the device records past it);
    the lead records lost go to LEAD_LOST under ``label``."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    rest = [e for e in device if LEAD_KERNEL not in e.name]
    LEAD_LOST.append((label, LEAD_LAUNCHES - (len(device) - len(rest))))
    return len(rest) < len(device), rest


def profile_device(torch, phase, run_once, n: int, unit: str) -> None:
    """Device kernel time by name and the device's idle share over ``n``
    calls of ``run_once``, from torch.profiler's CUDA trace (a session
    that lost its whole lead-in, or recorded no device activity, is run
    again, as in ``device_kernel_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            for _ in range(n):
                run_once()
            torch.cuda.synchronize()
        whole, kernels = split_lead(prof.events(),
                                    f"{CURRENT_PHASE}: {phase}")
        if whole and kernels:
            break
        print(f"chip_smoke: {CURRENT_PHASE}: {phase}: the profiler lost "
              "the session's lead-in or recorded no device activity; "
              "profiling again",
              file=sys.stderr)
    else:
        fail(f"{phase}: the profiler lost the lead-in or recorded no device "
             "activity 6 times")
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
                     warmup: int = 5, tries: int = 6,
                     label: str = None) -> float:
    """Mean device time of the kernel named ``kernel_name`` over the last
    ``n`` of ``warmup + n`` calls of ``fn``, from torch.profiler's CUDA
    trace: the kernel alone, without the host time of its wrapper that CUDA
    events around a call include. Each session opens with ``lead_in``; one
    that lost the whole lead-in or any record of the measured kernel (the
    trace now and then records nothing at all) is run again after a short
    pause, at most ``tries`` times. The session is named by the running
    phase and ``label`` (the kernel's name by default) in the rerun
    message and in ``LEAD_LOST``."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            for _ in range(warmup + n):
                fn()
            torch.cuda.synchronize()
        session = f"{CURRENT_PHASE}: {label or kernel_name}"
        whole, kernels = split_lead(prof.events(), session)
        launches = sorted((e for e in kernels if kernel_name in e.name),
                          key=lambda e: e.time_range.start)
        if whole and len(launches) >= warmup + n:
            return statistics.mean(e.time_range.elapsed_us() / 1e3
                                   for e in launches[-n:])
        print(f"chip_smoke: {session}: the profiler saw {len(launches)} "
              f"launches of {kernel_name}, expected {warmup + n}, lead-in "
              f"kept: {whole}; profiling again", file=sys.stderr)
    fail(f"{session}: the profiler missed launches of {kernel_name} {tries} "
         "times")


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


def read_bf16_launches() -> dict:
    """The bf16 variants' launch counts (``BF16_KERNELS`` order)."""
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import depth_regression as kdr
    from enerf_tpu_torch.ops.kernels import layer_render as klr
    from enerf_tpu_torch.ops.kernels import render as krender

    return dict(zip(BF16_KERNELS, (
        kcv.launches_bf16, krender.launches_bf16["render"],
        krender.launches_bf16["render_l0"], kdr.launches_mixed,
        klr.launches_bf16)))


def check_bf16_launches(path, n):
    """The bf16 variants launched ``BF16_PER_FRAME[path]`` times ``n`` since
    the last reset, and no float32 variant."""
    got = read_bf16_launches()
    expect = dict(zip(BF16_KERNELS, (k * n for k in BF16_PER_FRAME[path])))
    f32 = read_launches()
    if got != expect or any(f32.values()):
        fail(f"bf16 {path}: launches {got} and float32 {f32}, expected "
             f"{expect} and none")
    return got


def bf16_models(torch, cfg, seed, bn_seed, train=False):
    """``cfg``'s model in float32 (seeded, BN statistics randomized) and
    in the bf16 mode with the same weights, on the card."""
    import dataclasses

    import enerf_tpu_torch as et

    m32 = et.build_model(cfg, seed=seed, train=train)
    randomize_bn_stats(torch, m32, seed=bn_seed)
    m16 = et.build_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                         seed=seed, train=train)
    m16.load_state_dict(m32.state_dict())
    return m32, m16


def bf16_frame(torch, path, m32, m16, batch, render_frames=None):
    """One bf16 frame path: ``BF16_FRAMES`` frames with the counts reset
    just before and read just after (``render_frames(n)`` renders them, a
    loop of ``render`` by default), the outputs finite; the frame ms (CUDA
    events, median of ``BF16_TIMED`` after a first frame) and peak memory,
    bf16, then the float32 model on the same batch, then bf16 again;
    the frame vs the bf16 plain path (within half of ``BF16_YARDSTICK``);
    its gap to the float32 frame beside the yardstick; then every kernel
    call of one frame vs its plain version (``hold_path_kernels``, not
    timed: ``phase_bf16`` times each variant once). Returns (fields,
    launches, cases)."""
    import enerf_tpu_torch as et

    def frames(n):
        for _ in range(n):
            out = et.render(m16, batch)
        return out

    reset_launches()
    out = (render_frames or frames)(BF16_FRAMES)
    torch.cuda.synchronize()
    launches = check_bf16_launches(path, BF16_FRAMES)
    out = et.render(m16, batch)
    for k, v in out.items():
        if v.dtype != torch.float32 or not bool(torch.isfinite(v).all()):
            fail(f"bf16 {path}: {k} is {v.dtype} or not finite")
    frame, peak_gb = {}, {}
    for name, m in (("bfloat16", m16), ("float32", m32), ("bfloat16_again",
                                                           m16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frame[name] = time_ms(torch, lambda: et.render(m, batch),
                              reps=BF16_TIMED, warmup=1)
        peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
    with plain_path():
        ref = et.render(m16, batch)
    kind = lambda k: k.rsplit("_level", 1)[0]  # noqa: E731
    err = {k: max_err(torch, out[k], ref[k], 0.0,
                      0.5 * BF16_YARDSTICK[kind(k)],
                      f"bf16 {path} {k} kernel vs bf16 plain path")
           for k in out}
    out32 = et.render(m32, batch)
    gap = {k: float((out[k] - out32[k]).abs().max()) for k in out}
    if not all(g > 0 for g in gap.values()):
        fail(f"bf16 {path}: the bf16 frame equals the float32 one {gap}")
    per_frame = dict(zip(("cost_volume", "render", "render_l0",
                          "depth_regression", "layer_render"),
                         BF16_PER_FRAME[path]))
    cases = hold_path_kernels(torch, f"bf16_{path}", m16, batch, per_frame)
    emit_cases(cases)
    fields = dict(launches=launches, frame_ms=frame,
                  peak_mem_gb=peak_gb, kernel_vs_plain_max_abs_err=err,
                  tol_atol={k: 0.5 * BF16_YARDSTICK[kind(k)] for k in out},
                  gap_to_float32={k: {"card": gap[k],
                                      "cpu_yardstick": BF16_YARDSTICK[kind(k)]}
                                  for k in out})
    return fields, launches, cases


def float32_twin(torch, call):
    """``call`` (a ``functools.partial`` of a kernel wrapper) with every
    bfloat16 tensor argument in float32: the float32 variant's launch on
    the same values."""
    def f32(a):
        if hasattr(a, "_fields"):    # a NamedTuple (layer_render's Layer)
            return type(a)(*map(f32, a))
        return (a.float() if isinstance(a, torch.Tensor)
                and a.dtype == torch.bfloat16 else a)

    return functools.partial(call.func, *map(f32, call.args),
                             **call.keywords)


def phase_bf16(torch):
    """The bf16 compute mode on the card (``compute_dtype: bfloat16``):
    the DTU frame (512x640, planes (48, 8)), the human frame (512x512), the
    composite frame (512x640) and the val frame (``Trainer.val`` of
    ``Config()``'s cascade, both levels rendered) by ``bf16_frame``; the
    train step at 512x640, planes (64, 8): step ms with its forward /
    backward / optimizer split, peak memory, launches (K4-mixed only: the
    cost volume and render stage train on their plain versions), its
    loss beside the float32 step's on the same weights and batch; then
    each bf16 variant's device time (torch.profiler, mean of 20, no record
    lost), CUDA-event and plain times and bound at the DTU frame's shapes
    (K2-L0 at the val frame's level 0). Returns (launches by path, the
    variants' entries of the kernels line)."""
    import dataclasses
    import tempfile

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import (
        Config,
        composite_eval_config,
        dtu_eval_config,
        human_eval_config,
        human_mask,
    )
    from enerf_tpu_torch.datasets.synthetic import (
        make_composite_batch,
        make_synthetic_batch,
    )
    from enerf_tpu_torch.train import Trainer, create_train_state, make_train_step

    t0 = time.perf_counter()
    paths, cases, fields = {}, {}, {}
    cfg = dtu_eval_config()
    m32, m16 = bf16_models(torch, cfg, 0, 0)
    batch = et.device_batch(_synthetic(cfg, 3), "cuda")
    fields["dtu"], paths["dtu"], cases["dtu"] = bf16_frame(
        torch, "dtu", m32, m16, batch)
    profile_device(torch, "bf16_profile", lambda: et.render(m16, batch), 2,
                   "frame")
    profile_device(torch, "bf16_profile_float32",
                   lambda: et.render(m32, batch), 2, "frame")

    cfg = human_eval_config()
    m32, m16 = bf16_models(torch, cfg, 0, 1)
    hb = make_synthetic_batch(cfg, H=512, W=512)
    hb["mask_at_box"] = human_mask(512, 512)
    fields["human"], paths["human"], cases["human"] = bf16_frame(
        torch, "human", m32, m16, et.device_batch(hb, "cuda"))

    cfg = composite_eval_config()
    m32, m16 = bf16_models(torch, cfg, 0, 2)
    cb = et.device_batch(make_composite_batch(cfg, H=H, W=W), "cuda")
    fields["composite"], paths["composite"], cases["composite"] = bf16_frame(
        torch, "composite", m32, m16, cb)

    with tempfile.TemporaryDirectory() as tmp:   # Trainer's records
        cfg = Config(workspace=tmp)
        cfg = dataclasses.replace(cfg, enerf=dataclasses.replace(
            cfg.enerf, grid_rays=True))
        m32, m16 = bf16_models(torch, cfg, 0, 3)
        val_batches = [make_synthetic_batch(cfg, H=H, W=W, seed=i)
                       for i in range(BF16_FRAMES)]
        trainer = Trainer(cfg, train_step=None)
        metrics = {}

        def val_frames(n):
            metrics.update(trainer.val(0, create_train_state(cfg, m16),
                                       val_batches[:n]))
            m16.eval()               # Trainer.val leaves it in training mode

        fields["val"], paths["val"], cases["val"] = bf16_frame(
            torch, "val", m32, m16, et.device_batch(val_batches[0], "cuda"),
            render_frames=val_frames)
    fields["val"]["metrics"] = metrics
    for path, f in fields.items():
        emit("bf16_frame", path=path, **f)

    # the train step
    cfg = bench_train_config()
    m32, m16 = bf16_models(torch, cfg, 0, 4, train=True)
    tb = et.device_batch(make_synthetic_batch(cfg, H=H, W=W, split="train"),
                         "cuda")
    timer = StageTimer(torch)

    def steps(model, cfg):
        """1 + BF16_TRAIN_STEPS steps: losses, step ms, phase ms, peak."""
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, (H, W))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, phases = [], [], []
        for _ in range(1 + BF16_TRAIN_STEPS):
            t1 = time.perf_counter()
            timer.start()
            state, stats = step(state, tb, phase_hook=timer)
            losses.append(float(stats["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            phases.append(timer.stages_ms())
        return losses, step_ms, phases, torch.cuda.max_memory_allocated() / 1e9

    loss32, ms32, phases32, peak32 = steps(m32, cfg)
    del m32
    reset_launches()
    losses, step_ms, phases, peak16 = steps(
        m16, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    paths["train"] = check_bf16_launches("train", 1 + BF16_TRAIN_STEPS)
    if not all(v == v and abs(v) != float("inf") for v in losses):
        fail(f"bf16 train: losses {losses}")
    if any(p.dtype != torch.float32 for p in m16.parameters()):
        fail("bf16 train: a parameter is not float32")
    med = lambda ph: {k: statistics.median(p[k] for p in ph[1:])  # noqa: E731
                      for k in ph[1]}
    emit("bf16_train", H=H, W=W, steps=1 + BF16_TRAIN_STEPS,
         launches=paths["train"], step_ms=step_ms,
         median_step_ms=statistics.median(step_ms[1:]),
         median_phase_ms=med(phases), peak_mem_gb=peak16, loss=losses,
         float32_step_ms=ms32, float32_median_step_ms=statistics.median(
             ms32[1:]), float32_median_phase_ms=med(phases32),
         float32_peak_mem_gb=peak32, float32_loss=loss32,
         first_loss_rel_gap=abs(losses[0] - loss32[0]) / abs(loss32[0]))
    del m16

    # each variant at the main path's shapes: the DTU frame's calls (K2-L0:
    # the val frame's)
    kernels = []
    for name, kernel, path in (("cost_volume_bf16", "cost_volume", "dtu"),
                               ("render_bf16", "render", "dtu"),
                               ("render_l0_bf16", "render_l0", "val"),
                               ("depth_regression_mixed", "depth_regression",
                                "dtu"),
                               ("layer_render_bf16", "layer_render",
                                "composite")):
        cs = [c for c in cases[path] if c["kernel"] == kernel]
        with torch.inference_mode():
            dev = [device_kernel_ms(torch, c["fn"], c["symbol"], label=name)
                   for c in cs]
            # the float32 variant on the same inputs in float32
            dev32 = [device_kernel_ms(torch, float32_twin(torch, c["fn"]),
                                      c["symbol"], label=f"{name} float32")
                     for c in cs]
            ms = [time_ms(torch, c["fn"])["median"] for c in cs]
            plain = [time_ms(torch, c["plain_fn"], reps=5,
                             warmup=1)["median"] for c in cs]
        bd, by = cases_bound(kernel, cs)
        by_path = {p: v[name] for p, v in paths.items()}
        entry = kernel_entry(
            name, kernel, launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for cases_p in cases.values()
                            for c in cases_p if c["kernel"] == kernel),
            # per frame at the main path's shapes: every call of the frame
            calls=len(cs), shapes_from=path, ms=sum(ms), device_ms=sum(dev),
            device_ms_by_call=dev, float32_device_ms=sum(dev32),
            plain_ms=sum(plain), bound_ms=bd, bound_by=by,
            tol=BF16_TOLS[kernel.replace("_l0", "")])
        if kernel in TC_KERNELS:
            entry["bound_f32_ms"] = cases_bound(kernel, cs,
                                                tensor_cores=False)[0]
        kernels.append(entry)
    emit("bf16", seconds=time.perf_counter() - t0,
         launches_by_path=paths,
         kernels={e["name"]: {k: e[k] for k in ("device_ms",
                                                  "float32_device_ms", "ms",
                                                  "plain_ms", "bound_ms",
                                                  "bound_by", "launches")}
                  for e in kernels})
    return paths, kernels


def phase_wgrad(torch) -> dict:
    """The weight-gradient kernel at each of the 21 3D convs of the train
    step (their inputs' shapes read by forward pre-hooks from a ``no_grad``
    forward of the train model at 512x640) on seeded channels-last inputs
    and output gradients, against its plain version (cuDNN's weight
    gradient, the path it replaces): the error (rtol 1e-4, atol 1e-5 of
    the largest entry: the same float32 products summed in other orders),
    the device time of its two kernels (torch.profiler), event and plain
    ms, and the bound. Returns the step's totals."""
    from torch import nn

    import enerf_tpu_torch as et
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.ops.kernels import conv3d_wgrad as kwg

    cfg = bench_train_config()
    model = et.build_model(cfg, seed=0, train=True)
    batch = et.device_batch(make_synthetic_batch(cfg, H=H, W=W, split="train"),
                            "cuda")
    convs = []
    hooks = [m.register_forward_pre_hook(
        lambda m, inp, name=name: convs.append((name, m, inp[0].shape)))
        for name, m in model.named_modules() if kwg.takes(m)]
    with torch.no_grad():
        model(batch)
    for h in hooks:
        h.remove()
    if len(convs) != WGRAD_PER_STEP:
        fail(f"wgrad: {len(convs)} 3D convs in the train step, expected "
             f"{WGRAD_PER_STEP}")
    cl = torch.channels_last_3d
    g = torch.Generator(device="cuda").manual_seed(17)
    cases = []
    for name, m, shape in convs:
        x = torch.randn(shape, device="cuda", generator=g).contiguous(
            memory_format=cl)
        with torch.no_grad():
            y = m(x)
        gy = torch.randn(y.shape, device="cuda", generator=g).contiguous(
            memory_format=cl)
        stride = m.stride[0]
        # a transposed conv's weight gradient: its output gradient as the
        # input, its input as the output gradient
        a, b = (gy, x) if isinstance(m, nn.ConvTranspose3d) else (x, gy)
        want = kwg.wgrad_plain(a, b, stride)
        err = max_err(torch, kwg.wgrad(a, b, stride), want,
                      rtol=1e-4, atol=1e-5 * float(want.abs().max()),
                      what=f"wgrad {name}")
        call = functools.partial(kwg.wgrad, a, b, stride)
        device = sum(device_kernel_ms(torch, call, k, label=f"{name} {k}")
                     for k in ("wgrad_partial_kernel", "wgrad_sum_kernel"))
        voxels_in = a[0, 0].numel() * a.shape[0]
        voxels_out = b[0, 0].numel() * b.shape[0]
        Ci, Co = a.shape[1], b.shape[1]
        # each output voxel against the weight entries of the taps that
        # fall inside the input (the kernel skips the padding): the
        # (voxel, tap) pairs, a product over the three dims. x and gy read
        # once, the weight gradient written once
        pairs = b.shape[0]
        for n_in, n_out in zip(a.shape[2:], b.shape[2:]):
            pairs *= sum(0 <= stride * o - 1 + k < n_in
                         for k in range(3) for o in range(n_out))
        flops = 2.0 * Co * Ci * pairs
        n_bytes = 4.0 * (Ci * voxels_in + Co * voxels_out + Co * Ci * kwg.TAPS)
        cases.append(dict(
            conv=name, Ci=Ci, Co=Co, in_shape=list(a.shape[2:]),
            out_shape=list(b.shape[2:]), stride=stride,
            plan=kwg.plan(Co, Ci, b.shape[0] * b.shape[2] * b.shape[3],
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count),
            max_abs_err=err, max_abs=float(want.abs().max()),
            device_ms=device, ms=time_ms(torch, call),
            plain_ms=time_ms(torch, functools.partial(kwg.wgrad_plain, a, b,
                                                      stride)),
            flops=flops, bytes=n_bytes))
    for case in cases:
        emit("wgrad_conv", **case)
    bound, by = bound_ms(sum(c["bytes"] for c in cases),
                         sum(c["flops"] for c in cases))
    total = dict(device_ms=sum(c["device_ms"] for c in cases),
                 ms=sum(c["ms"]["median"] for c in cases),
                 plain_ms=sum(c["plain_ms"]["median"] for c in cases),
                 bound_ms=bound, bound_by=by,
                 max_rel_err=max(c["max_abs_err"] / c["max_abs"]
                                 for c in cases))
    emit("wgrad", convs=len(cases), **total)
    return total


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
    batch = et.device_batch(batch_np, "cuda")
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
    # training runs the plain, differentiable cost volume and render stage,
    # the depth-regression kernel (plain-recompute backward) and the 3D
    # convs' weight-gradient kernel
    expect = {"cost_volume": 0, "render": 0, "render_l0": 0,
              "depth_regression": 2 * n, "conv3d_wgrad": WGRAD_PER_STEP * n,
              "layer_render": 0}
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

# ---------------------------------------------------------------------------
# the dynamic-scene data paths: JPEG scenes from files on disk


ZJU_HW = 1024                 # ZJU-MoCap's 1024x1024 frames
ZJU_CAMS, ZJU_FRAMES = 6, 2
OUT_HW = (1080, 1920)         # ENeRF-Outdoor's 1080x1920 frames
OUT_CAMS, OUT_FRAMES = 4, 2
# the test splits of both configs cut to the fixtures' frames
VIDEO_FRAMES_OPT = ["test_dataset.frames", "[0, -1, 1]"]
INTERACTIVE_FRAMES = 12       # rail frames of the headless GUI loop


def _look_at(eye, target):
    """A world-to-camera extrinsic (4x4) at ``eye`` looking at
    ``target``, z up in the world, y down in the image."""
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    ext = np.eye(4)
    ext[:3, :3], ext[:3, 3] = R, -R @ eye
    return ext


def _trace_ellipsoid(ext, ixt, hw, center, radii, phases, bg_phase):
    """(hit mask, rgb in [0, 1]) of an (h, w) camera looking at a textured
    ellipsoid over a gradient background."""
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w]
    R, t = ext[:3, :3], ext[:3, 3]
    o = (-R.T @ t - center) / radii
    d = (np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
         @ np.linalg.inv(ixt).T @ R) / radii
    a = np.einsum("...c,...c->...", d, d)
    b = d @ o
    disc = b * b - a * (o @ o - 1.0)
    z = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    hit = (disc > 0) & (z > 0)
    p = o + d * z[..., None]
    fg = 0.5 + 0.4 * np.sin(p @ phases[:3].T * 6.0 + phases[3])
    return hit, np.where(hit[..., None], fg, _background(hw, bg_phase))


def _background(hw, phase):
    """A smooth (h, w, 3) gradient in [0.1, 0.6]."""
    ys, xs = np.mgrid[0:hw[0], 0:hw[1]]
    v = 0.35 + 0.25 * np.sin(xs / 97.0 + ys / 61.0 + phase)
    return v[..., None] * np.array([1.0, 0.9, 0.8])


def write_zjumocap_scene(root: Path, seed: int = 0) -> dict:
    """A ZJU-MoCap-layout ``CoreView_313`` under ``root/zju_mocap`` at
    ZJU-MoCap's sizes: ``ZJU_CAMS`` cameras on a ring 3 m from a standing
    subject (a textured ellipsoid), ``ZJU_FRAMES`` frames of 1024x1024
    JPEGs written by the port's encoder, PNG masks, ``annots.npy`` with
    non-zero lens distortion, and ``new_vertices`` on the subject's
    surface. Returns the seconds each part took."""
    import shutil

    from enerf_tpu_torch.utils.image_io import imwrite

    rng = np.random.RandomState(seed)
    base = root / "zju_mocap" / "CoreView_313"
    shutil.rmtree(base, ignore_errors=True)
    (base / "new_vertices").mkdir(parents=True)
    center, radii = np.array([0.0, 0.0, 0.9]), np.array([0.22, 0.16, 0.8])
    f = 1100.0 * ZJU_HW / 1024
    K = np.array([[f, 0, ZJU_HW / 2], [0, f, ZJU_HW / 2], [0, 0, 1]])
    cams = {"K": [], "R": [], "T": [], "D": []}
    exts = []
    for c in range(ZJU_CAMS):
        ang = 2 * np.pi * c / ZJU_CAMS
        ext = _look_at(np.array([3 * np.sin(ang), -3 * np.cos(ang), 1.0]),
                       center)
        exts.append(ext)
        cams["K"].append(K.copy())
        cams["R"].append(ext[:3, :3])
        cams["T"].append(ext[:3, 3:] * 1000.0)
        cams["D"].append(np.array([[-0.25 + 0.02 * c], [0.1], [5e-4],
                                   [-4e-4], [-0.02]]))
    secs = {"images": 0.0, "masks": 0.0}
    ims = []
    for f in range(ZJU_FRAMES):
        phases = rng.uniform(-1.0, 1.0, (4, 3))
        rel = []
        for c, ext in enumerate(exts):
            t0 = time.perf_counter()
            hit, rgb = _trace_ellipsoid(ext, K, (ZJU_HW, ZJU_HW), center,
                                        radii, phases, 0.3 * f)
            name = f"Camera_B{c + 1}/{f:06d}.jpg"
            (base / name).parent.mkdir(parents=True, exist_ok=True)
            imwrite(str(base / name), (rgb * 255).astype(np.uint8))
            t1 = time.perf_counter()
            (base / "mask" / name).parent.mkdir(parents=True, exist_ok=True)
            imwrite(str(base / "mask" / (name[:-4] + ".png")),
                    hit.astype(np.uint8) * 255)
            secs["images"] += t1 - t0
            secs["masks"] += time.perf_counter() - t1
            rel.append(name)
        ims.append({"ims": rel})
        u = rng.normal(size=(600, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        np.save(base / "new_vertices" / f"{f + 1}.npy", center + u * radii)
    np.save(base / "annots.npy", {"cams": cams, "ims": ims})
    return secs


def _write_ply_points(path: Path, pts: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(pts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n"
                b"end_header\n")
        f.write(pts.astype("<f4").tobytes())


def write_outdoor_scene(root: Path, seed: int = 0) -> dict:
    """An ENeRF-Outdoor-layout ``actor1`` under ``root/enerf_outdoor`` at
    its sizes: ``OUT_CAMS`` cameras on an arc 5 m from an actor (a textured
    ellipsoid), ``OUT_FRAMES`` frames of 1080x1920 JPEGs and one ``bkgd/``
    plate a camera (the port's encoder), ``intri.yml`` / ``extri.yml`` in
    OpenCV's format (``utils/camera_io.write_storage``) with non-zero
    distortion, ``vhull/`` bounds and a ``background.ply`` point cloud.
    Returns the seconds each part took."""
    import shutil

    from enerf_tpu_torch.utils.camera_io import write_storage
    from enerf_tpu_torch.utils.image_io import imwrite

    rng = np.random.RandomState(seed)
    base = root / "enerf_outdoor" / "actor1"
    shutil.rmtree(base, ignore_errors=True)
    (base / "vhull").mkdir(parents=True)
    (base / "bkgd").mkdir()
    h, w = OUT_HW
    center, radii = np.array([0.0, 0.0, 0.9]), np.array([0.25, 0.2, 0.85])
    K = np.array([[1500.0, 0, w / 2], [0, 1500.0, h / 2 + 20], [0, 0, 1]])
    intri = {"names": [f"{c:02d}" for c in range(OUT_CAMS)]}
    extri = {}
    exts = []
    from enerf_tpu_torch.utils.cv import rodrigues

    for c in range(OUT_CAMS):
        ang = -0.5 + c / (OUT_CAMS - 1)
        ext = _look_at(np.array([5 * np.sin(ang), -5 * np.cos(ang), 1.2]),
                       center)
        exts.append(ext)
        name = f"{c:02d}"
        intri[f"K_{name}"] = K
        intri[f"dist_{name}"] = np.array([[-0.08 + 0.01 * c], [0.02],
                                          [1e-4], [-2e-4], [0.0]])
        # the rotation vector of R (its axis times its angle)
        R = ext[:3, :3]
        angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / (2 * np.sin(angle))
        rvec = (axis * angle).reshape(3, 1)
        assert np.allclose(rodrigues(rvec), R, atol=1e-9)
        extri[f"R_{name}"] = rvec
        extri[f"T_{name}"] = ext[:3, 3:]
        (base / "images" / name).mkdir(parents=True)
    write_storage(str(base / "intri.yml"), intri)
    write_storage(str(base / "extri.yml"), extri)
    secs = {"images": 0.0, "plates": 0.0}
    for c, ext in enumerate(exts):
        t0 = time.perf_counter()
        plate = _background(OUT_HW, 0.1 * c)
        imwrite(str(base / "bkgd" / f"{c:02d}.jpg"),
                (plate * 255).astype(np.uint8))
        secs["plates"] += time.perf_counter() - t0
    for f in range(OUT_FRAMES):
        phases = rng.uniform(-1.0, 1.0, (4, 3))
        for c, ext in enumerate(exts):
            t0 = time.perf_counter()
            _, rgb = _trace_ellipsoid(ext, K, OUT_HW, center, radii, phases,
                                      0.1 * c)
            imwrite(str(base / "images" / f"{c:02d}" / f"{f:06d}.jpg"),
                    (rgb * 255).astype(np.uint8))
            secs["images"] += time.perf_counter() - t0
        np.save(base / "vhull" / f"{f:06d}.npy",
                np.stack([center - radii - 0.05, center + radii + 0.05]))
    # the background: points on a ground plane and a far wall
    g = rng.uniform(-8, 8, (4000, 2))
    wall = np.stack([rng.uniform(-12, 12, 4000), np.full(4000, 10.0),
                     rng.uniform(0, 6, 4000)], -1)
    _write_ply_points(base / "background.ply", np.concatenate(
        [np.stack([g[:, 0], g[:, 1] + 4, np.zeros(4000)], -1), wall]))
    return secs


def video_host_parts_ms(cfg, K, D, jpeg_path: str, mask_path) -> dict:
    """The loader's host work on one image of a video dataset (camera
    ``K``, ``D``), each part timed alone on the fixture (median of 3): the
    JPEG decode, its u8 -> float normalize, the undistort of the image
    (and of the mask), the ratio resize (area, and nearest for the mask),
    the rays of both levels of the target."""
    from enerf_tpu_torch import native
    from enerf_tpu_torch.datasets.ray_utils import build_rays_host
    from enerf_tpu_torch.utils.cv import dilate, resize_by, undistort
    from enerf_tpu_torch.utils.image_io import imread

    K = np.asarray(K, np.float32)
    D = np.asarray(D, np.float32).reshape(-1)
    ratio = cfg.test_dataset.input_ratio
    u8 = imread(jpeg_path)
    img = native.u8_to_unit(u8)
    und = undistort(img, K, D)
    small = resize_by(und, ratio)
    cas = cfg.enerf.cas_config
    ixt = K.copy()
    ixt[:2] *= ratio
    ones = np.ones(small.shape[:2], np.uint8)

    def median_ms(fn, n=3):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    parts = {"jpeg_decode": median_ms(lambda: imread(jpeg_path)),
             "u8_to_unit": median_ms(lambda: native.u8_to_unit(u8)),
             "undistort": median_ms(lambda: undistort(img, K, D)),
             "resize_area": median_ms(lambda: resize_by(und, ratio)),
             "rays_both_levels": median_ms(lambda: [
                 build_rays_host(small, np.eye(4, dtype=np.float32), ixt,
                                 ones, cas.render_scale[i])
                 for i in range(cas.num)])}
    if mask_path is not None:
        mask = (imread(mask_path) != 0).astype(np.uint8)
        parts["mask_png_decode"] = median_ms(lambda: imread(mask_path))
        parts["mask_dilate"] = median_ms(lambda: dilate(mask, 5))
        parts["mask_undistort"] = median_ms(lambda: undistort(mask, K, D))
        parts["mask_resize_nearest"] = median_ms(
            lambda: resize_by(mask, ratio, nearest=True))
    return {"image_hw": list(u8.shape[:2]), **parts}


def phase_jpeg(torch, smi_line: str) -> None:
    """The native library is the one built from this checkout's sources,
    its JPEG decoder holds the committed Pillow fixture to its checksum bit
    for bit, and the encoder and decoder round-trip a 1024x1024 and a
    1080x1920 image (PSNR against the source, host ms of each)."""
    import hashlib

    from enerf_tpu_torch import native
    from enerf_tpu_torch.utils.image_io import decode_jpeg, encode_jpeg, imread

    if not native.available() or not native._so_path().is_file():
        fail("jpeg: the native host library did not build or load (g++): "
             "the port reads no JPEG without it")
    if Path(native._lib._name).resolve() != native._so_path().resolve():
        fail(f"jpeg: loaded {native._lib._name}, not the build of this "
             f"checkout's sources {native._so_path()}")
    pix = imread(str(ROOT / JPEG_FIXTURE))
    digest = hashlib.sha256(pix.tobytes()).hexdigest()
    if pix.shape != (45, 61, 3) or digest != JPEG_FIXTURE_SHA256:
        fail(f"jpeg: {JPEG_FIXTURE} decoded to {pix.shape} sha256 {digest}, "
             f"expected (45, 61, 3) {JPEG_FIXTURE_SHA256}")
    cases = []
    for hw in ((ZJU_HW, ZJU_HW), OUT_HW):
        _, rgb = _trace_ellipsoid(_look_at(np.array([0.0, -3.0, 1.0]),
                                           [0.0, 0.0, 0.9]),
                                  np.array([[1100.0, 0, hw[1] / 2],
                                            [0, 1100.0, hw[0] / 2],
                                            [0, 0, 1]]), hw,
                                  np.array([0.0, 0.0, 0.9]),
                                  np.array([0.22, 0.16, 0.8]),
                                  np.full((4, 3), 0.5), 0.0)
        src = (rgb * 255).astype(np.uint8)
        enc_ms, dec_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            data = encode_jpeg(src, 75)
            t1 = time.perf_counter()
            out = decode_jpeg(data)
            enc_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (time.perf_counter() - t1))
        mse = float(np.mean((out.astype(np.float64) - src) ** 2))
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        if out.shape != src.shape or psnr < 30.0:
            fail(f"jpeg: {hw} round trip {out.shape}, PSNR {psnr:.2f} dB")
        cases.append({"hw": list(hw), "bytes": len(data), "psnr_db": psnr,
                      "encode_ms": statistics.median(enc_ms),
                      "decode_ms": statistics.median(dec_ms)})
    emit("jpeg", native_library=str(native._so_path().name),
         fixture=JPEG_FIXTURE, fixture_sha256=digest, fixture_bit_exact=True,
         quality=75, cases=cases, nvidia_smi=smi_line)


class RecordingLoader:
    """A data loader that appends each batch it yields to ``into``."""

    def __init__(self, loader, into: list):
        self.loader, self.into = loader, into

    def __iter__(self):
        for batch in self.loader:
            self.into.append(batch)
            yield batch

    def __getattr__(self, name):
        return getattr(self.loader, name)


def run_cli_eval(torch, phase: str, cfg_file: str, opts: list,
                 per_frame: dict, smi_line: str, extra: dict) -> tuple:
    """``enerf_tpu_torch.run``'s ``main`` (``--type evaluate``) on
    ``cfg_file`` with ``opts``, in this process, the launch counts reset
    just before and read just after (``per_frame`` times the frames); the
    first frame vs the plain path; the metrics vs ``Trainer.val`` +
    ``make_evaluator`` over the same batches (kept as the CLI's loader
    yields them). Emits the phase's line (with ``extra``) and returns
    (launches, the run's result)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch import run
    from enerf_tpu_torch.config import make_cfg
    from enerf_tpu_torch.datasets.loader import make_data_loader
    from enerf_tpu_torch.factory import make_evaluator
    from enerf_tpu_torch.train import Trainer, create_train_state

    args = ["--type", "evaluate", "--cfg_file", cfg_file, *opts]
    # the CLI's batches, kept for Trainer.val (one pass of the slow loader)
    batches = []
    run.make_data_loader = lambda *a, **kw: RecordingLoader(
        make_data_loader(*a, **kw), batches)
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = run.main(args)
    finally:
        run.make_data_loader = make_data_loader
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    n = res["frames"]
    expect = {k: v * n for k, v in per_frame.items()}
    if n < 2 or launches != expect:
        fail(f"{phase}: {n} frames, kernel launches on the main path "
             f"{launches}, expected {expect}")
    cfg = make_cfg(cfg_file, opts)
    model, batch = res["model"], res["first_batch"]
    with plain_path():
        ref = et.render(model, batch)
    err = {}
    for k, v in res["first_out"].items():
        if not np.isfinite(v).all():
            fail(f"{phase}: non-finite {k}")
        if k in E2E_ATOL:
            err[k] = max_err(torch, torch.from_numpy(v).cuda(), ref[k],
                             E2E_RTOL, E2E_ATOL[k],
                             f"{phase} {k} kernel vs plain path")
    if not err:
        fail(f"{phase}: no output held against the plain path "
             f"({sorted(res['first_out'])})")
    if len(batches) != n:
        fail(f"{phase}: recorded {len(batches)} of the CLI's {n} batches")
    val = Trainer(cfg, train_step=None).val(
        0, create_train_state(cfg, run.load_eval_model(cfg, "cuda")),
        batches, evaluator=make_evaluator(cfg))
    metrics = res["metrics"]
    if not ({"psnr", "ssim"} <= set(metrics) and all(
            np.isfinite(v) for v in metrics.values())):
        fail(f"{phase}: metrics {metrics}")
    metric_diff = {k: abs(metrics[k] - val[k]) for k in metrics}
    if any(d > 1e-6 * max(1.0, abs(metrics[k]))
           for k, d in metric_diff.items()):
        fail(f"{phase}: the CLI's metrics {metrics} differ from "
             f"Trainer.val's {val}")
    timed = res["frame_ms"][1:]
    emit(phase, cfg_file=cfg_file, opts=opts, frames=n,
         frame_hw=list(batch["src_inps"].shape[2:4]), cli_seconds=cli_s,
         launches=launches,
         launches_per_frame={k: v / n for k, v in launches.items()},
         loader_host_ms=res["loader_host_ms"],
         median_loader_host_ms=statistics.median(res["loader_host_ms"]),
         loader_wait_ms=res["loader_wait_ms"],
         frame_ms=res["frame_ms"], median_frame_ms=statistics.median(timed),
         fps=res["fps"], upload_ms=res["upload_ms"],
         upload_bytes_per_frame=res["upload_bytes"], metrics=metrics,
         trainer_val_metrics={k: val[k] for k in metrics},
         metric_abs_diff=metric_diff, kernel_vs_plain_max_abs_err=err,
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL}, nvidia_smi=smi_line,
         **extra)
    return launches, res


def phase_run_zjumocap(torch, smi_line: str) -> dict:
    """ZJU-MoCap from files on disk: ``write_zjumocap_scene`` evaluated by
    ``python -m enerf_tpu_torch.run``'s ``main`` on
    configs/enerf/zjumocap_eval.yaml (``ENeRFHuman`` at 512x512 from the
    1024x1024 JPEGs, window (448, 288), planes (32, 8), level 1 rendered):
    a frame launches K1 (crop mode) 2, K4 2, ``render`` 1."""
    from enerf_tpu_torch.config import make_cfg

    fixture = ROOT / "build" / "video_fixture"
    t0 = time.perf_counter()
    secs = write_zjumocap_scene(fixture)
    write_s = time.perf_counter() - t0
    cfg_file = "configs/enerf/zjumocap_eval.yaml"
    # one rendered view (camera 2) of both frames
    opts = ["workspace", str(fixture), *VIDEO_FRAMES_OPT,
            "test_dataset.render_views", "[1, 2, 1]"]
    cfg = make_cfg(cfg_file, opts)
    base = fixture / "zju_mocap" / "CoreView_313"
    cams = np.load(base / "annots.npy", allow_pickle=True).item()["cams"]
    parts = video_host_parts_ms(cfg, cams["K"][0], cams["D"][0],
                                str(base / "Camera_B1/000000.jpg"),
                                str(base / "mask/Camera_B1/000000.png"))
    launches, res = run_cli_eval(
        torch, "run_zjumocap", cfg_file, opts, HUMAN_PER_FRAME, smi_line,
        {"fixture_seconds": write_s, "fixture_parts_seconds": secs,
         "cameras": ZJU_CAMS, "scene_frames": ZJU_FRAMES,
         "jpeg_hw": [ZJU_HW, ZJU_HW], "loader_host_parts_ms": parts,
         "mask_window_hw": list(cfg.enerf.mask_window_hw)})
    batch = res["first_batch"]
    if not 0 < float(batch["mask_at_box"].sum()) < batch["mask_at_box"].size:
        fail("run_zjumocap: the subject's bbox mask is empty or the frame")
    return launches


def phase_run_outdoor(torch, smi_line: str) -> dict:
    """ENeRF-Outdoor from files on disk: ``write_outdoor_scene`` evaluated
    by ``enerf_tpu_torch.run``'s ``main`` on
    configs/enerf/enerf_outdoor/actor1.yaml (``ENeRFComposite`` at
    768x1024 from the 1080x1920 JPEGs: ratio 0.75, then the crop; 1 fg
    layer, planes (32, 8)): a frame launches K1 4 (full frame and fg
    crops), K4 4 and the layered render 1."""
    from enerf_tpu_torch.config import make_cfg
    from enerf_tpu_torch.utils.camera_io import read_camera

    fixture = ROOT / "build" / "video_fixture"
    t0 = time.perf_counter()
    secs = write_outdoor_scene(fixture)
    write_s = time.perf_counter() - t0
    cfg_file = "configs/enerf/enerf_outdoor/actor1.yaml"
    opts = ["workspace", str(fixture), *VIDEO_FRAMES_OPT]
    cfg = make_cfg(cfg_file, opts)
    base = fixture / "enerf_outdoor" / "actor1"
    cam = read_camera(str(base / "intri.yml"), str(base / "extri.yml"))["00"]
    parts = video_host_parts_ms(cfg, cam["K"], cam["dist"],
                                str(base / "images/00/000000.jpg"), None)
    launches, res = run_cli_eval(
        torch, "run_outdoor", cfg_file, opts, COMPOSITE_PER_FRAME, smi_line,
        {"fixture_seconds": write_s, "fixture_parts_seconds": secs,
         "cameras": OUT_CAMS, "scene_frames": OUT_FRAMES,
         "jpeg_hw": list(OUT_HW), "loader_host_parts_ms": parts,
         "fg_bbox_hw": list(cfg.enerf.fg_bbox_hw)})
    bbox = res["first_batch"]["bbox"]
    emit("run_outdoor_bbox", bbox=np.asarray(bbox).tolist(),
         near_far=np.asarray(res["first_batch"]["near_far"]).tolist())
    return launches


# the interactive main path: ``python -m enerf_tpu_torch.gui_human
# --headless N`` in a subprocess (the module's ``main`` on the command line's
# arguments, as ``-m`` runs it), the launch counts set to 0 just before
# and read just after; then the first frame against the plain path on the
# card and the same model on the CPU, the first query (rays, mask_at_box,
# the uploaded arrays) against its rebuild on the CPU, the video read back
# by the port's reader, the peak memory; a "GUI_HUMAN {json}" line at the end
GUI_RUNNER = r"""
import copy, json, sys
import numpy as np
import torch
import chip_smoke as cs
from enerf_tpu_torch import gui_human
from enerf_tpu_torch.utils.video import read_mp4

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.reset_launches()
res = gui_human.main(sys.argv[1:])
launches = cs.read_launches()
peak = torch.cuda.max_memory_allocated() / 2 ** 30
model, batch, out = res["renderer"].model, res["first_batch"], res["first_out"]
with torch.inference_mode():
    with cs.plain_path():
        ref = model(batch)
    cpu = copy.deepcopy(model).cpu()(
        {k: v.cpu() for k, v in batch.items()})
plain_err = {k: cs.max_err(torch, out[k], ref[k], cs.E2E_RTOL, cs.E2E_ATOL[k],
                           f"interactive {k} kernel vs plain path")
             for k in out if k in cs.E2E_ATOL}
cpu_err = {k: cs.max_err(torch, out[k].cpu(), cpu[k], cs.E2E_RTOL,
                         cs.E2E_ATOL[k], f"interactive {k} card vs CPU")
           for k in out if k in cs.E2E_ATOL}
# the first query rebuilt on the CPU: its host part through a CPU copy of
# the dataset's upload and finish; the rays to rtol 1e-6, the other keys
# exactly, and the card's mask_at_box against numpy's slab test of
# rays_aabb_mask's rule, differing only where near - far is within 1e-5 of 0
ds = copy.copy(res["renderer"].dataset)
ds.device, ds.XY, ds.XYZ = torch.device("cpu"), ds.XY.cpu(), ds.XYZ.cpu()
host = res["first_host"]
cpu_q = ds.finish(host, ds.upload(host))
if set(cpu_q) != set(batch):
    cs.fail(f"interactive: query keys {sorted(batch)} vs the CPU's "
            f"{sorted(cpu_q)}")
query_err = {}
for k, v in cpu_q.items():
    if k != "mask_at_box":
        tol = 1e-6 if k.startswith("rays_") else 0.0
        query_err[k] = cs.max_err(torch, batch[k].cpu(), v, tol, tol,
                                  f"interactive query {k} card vs CPU")
rays = next(v for k, v in cpu_q.items() if k.startswith("rays_"))
rays = rays[0].numpy()
d = rays[:, 3:6] / np.linalg.norm(rays[:, 3:6], axis=-1, keepdims=True)
d = np.where((d >= 0) & (d < 1e-5), np.float32(1e-5), d)
d = np.where((d < 0) & (d > -1e-5), np.float32(-1e-5), d)
t0 = (host["bounds"][0] - rays[:, :3]) / d
t1 = (host["bounds"][1] - rays[:, :3]) / d
gap = np.minimum(t0, t1).max(-1) - np.maximum(t0, t1).min(-1)
card_mask = batch["mask_at_box"][0].cpu().numpy() > 0.5
flip = card_mask != (gap < 0)
if not (np.abs(gap[flip]) < 1e-5).all():
    cs.fail(f"interactive: mask_at_box differs from numpy's slab test on "
            f"{int(flip.sum())} rays, of which "
            f"{int((np.abs(gap[flip]) >= 1e-5).sum())} are no near-ties")
frames, fps = read_mp4(res["path"])
mask = batch["mask_at_box"]
rec = {k: res[k] for k in ("frames", "fps", "splits", "median_splits",
                           "encode_ms", "frame_hw", "init_s",
                           "dataset_init_s")}
rec.update(launches=launches, peak_mem_gib=peak,
           kernel_vs_plain_max_abs_err=plain_err,
           card_vs_cpu_max_abs_err=cpu_err, query_card_vs_cpu_max_abs_err=
           query_err, mask_near_tie_flips=int(flip.sum()),
           video_frames=len(frames),
           video_hw=list(frames[0].shape[:2]), video_fps=fps,
           mask_rays=int(mask.sum()), rays=int(mask.numel()))
print("GUI_HUMAN " + json.dumps(rec), flush=True)
"""


def phase_interactive(torch, smi_line: str) -> dict:
    """The interactive main path: ``python -m enerf_tpu_torch.gui_human
    --headless INTERACTIVE_FRAMES`` (``GUI_RUNNER``, a subprocess) on
    configs/enerf/interactive/zjumocap.yaml over ``run_zjumocap``'s scene
    (``ENeRFHuman`` at 512x512 from the 1024x1024 JPEGs, window (448,
    288), 2 of the 6 cameras a query, both frames cached at init): the
    steady fps, each frame's query, upload, rays + mask, forward, readback
    and u8 ms, the bytes uploaded, the init seconds, the peak memory;
    launches a frame K1 (crop mode) 2, K4 2, ``render`` 1; the first
    frame vs the plain path and the CPU; the first query's rays and
    arrays vs the CPU's and its ``mask_at_box`` vs numpy's slab test
    (near-ties counted); ``interactive.mp4`` read back."""
    import os

    fixture = ROOT / "build" / "video_fixture"
    args = ["--headless", str(INTERACTIVE_FRAMES), "--cfg_file",
            "configs/enerf/interactive/zjumocap.yaml",
            "workspace", str(fixture), *VIDEO_FRAMES_OPT]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-c", GUI_RUNNER, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    line = next((ln for ln in sub.stdout.splitlines()
                 if ln.startswith("GUI_HUMAN ")), None)
    if sub.returncode != 0 or line is None:
        fail(f"interactive: python -m enerf_tpu_torch.gui_human "
             f"{' '.join(args)}: rc {sub.returncode}\n{sub.stdout[-3000:]}"
             f"\n{sub.stderr[-5000:]}")
    rec = json.loads(line[len("GUI_HUMAN "):])
    n = rec["frames"]
    expect = {k: v * n for k, v in HUMAN_PER_FRAME.items()}
    if rec["launches"] != expect:
        fail(f"interactive: kernel launches on the main path "
             f"{rec['launches']}, expected {expect}")
    if (rec["video_frames"], rec["video_hw"]) != (n, rec["frame_hw"]) \
            or rec["frame_hw"] != [512, 512]:
        fail(f"interactive: interactive.mp4 holds {rec['video_frames']} "
             f"frames of {rec['video_hw']}, expected {n} of 512x512")
    if not 0 < rec["mask_rays"] < rec["rays"]:
        fail(f"interactive: mask_at_box holds {rec['mask_rays']} of "
             f"{rec['rays']} rays")
    emit("interactive", subprocess_seconds=secs,
         launches_per_frame={k: v / n for k, v in rec["launches"].items()},
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL}, nvidia_smi=smi_line,
         **rec)
    return rec["launches"]


# glfw's constants (the values of glfw 3's C header)
GLFW_CONSTANTS = dict(
    CONTEXT_VERSION_MAJOR=0x22002, CONTEXT_VERSION_MINOR=0x22003,
    OPENGL_PROFILE=0x22008, OPENGL_COMPAT_PROFILE=0x32002,
    RELEASE=0, PRESS=1, REPEAT=2, MOUSE_BUTTON_LEFT=0, MOUSE_BUTTON_RIGHT=1,
    MOUSE_BUTTON_MIDDLE=2, MOD_SHIFT=1, MOD_CONTROL=2, KEY_SPACE=32,
    KEY_MINUS=45, KEY_EQUAL=61, KEY_A=65, KEY_D=68, KEY_E=69, KEY_H=72,
    KEY_P=80, KEY_Q=81, KEY_S=83, KEY_T=84, KEY_W=87, KEY_ESCAPE=256)


def stub_gl_modules(frames: int, events=None, init_ok: bool = True):
    """Stand-ins for the ``glfw`` and ``OpenGL.GL`` modules (built as
    ``types.ModuleType`` objects, nothing imported) for ``run_gui`` without
    a display: the window closes after ``frames`` swapped frames or when
    the GUI asks; ``events[i]`` (a list of ("key", key, action, mods),
    ("mouse", button, action, mods), ("cursor", x, y) or ("scroll", dy))
    runs through the GUI's callbacks at the i-th ``poll_events``;
    ``glfw.init()`` returns ``init_ok``. Returns (glfw, gl, record):
    ``record["frames"]`` holds a copy of every ``glTexSubImage2D`` buffer,
    ``record["titles"]`` the window titles."""
    import types

    record = {"frames": [], "titles": [], "polls": 0, "swaps": 0,
              "close": False, "terminated": 0}
    cb, cursor = {}, [0.0, 0.0]
    glfw = types.ModuleType("glfw")
    for k, v in GLFW_CONSTANTS.items():
        setattr(glfw, k, v)

    def poll_events():
        for ev in (events or {}).get(record["polls"], []):
            if ev[0] == "key":
                cb["key"]("win", ev[1], 0, ev[2], ev[3])
            elif ev[0] == "mouse":
                cb["mouse"]("win", ev[1], ev[2], ev[3])
            elif ev[0] == "cursor":
                cursor[:] = ev[1:]
                cb["cursor"]("win", *ev[1:])
            else:
                cb["scroll"]("win", 0.0, ev[1])
        record["polls"] += 1

    def swap_buffers(_w):
        record["swaps"] += 1

    def terminate():
        record["terminated"] += 1

    def set_close(_w, value):
        record["close"] = bool(value)

    glfw.init = lambda: init_ok
    glfw.window_hint = lambda *a: None
    glfw.create_window = lambda w, h, title, mon, share: "win"
    glfw.make_context_current = lambda w: None
    glfw.terminate = terminate
    glfw.get_cursor_pos = lambda w: tuple(cursor)
    glfw.set_window_should_close = set_close
    glfw.window_should_close = lambda w: (record["close"]
                                          or record["swaps"] >= frames)
    glfw.poll_events = poll_events
    glfw.swap_buffers = swap_buffers
    glfw.set_window_title = lambda w, t: record["titles"].append(t)
    for name, key in (("mouse_button", "mouse"), ("cursor_pos", "cursor"),
                      ("scroll", "scroll"), ("key", "key")):
        setattr(glfw, f"set_{name}_callback",
                lambda w, fn, key=key: cb.__setitem__(key, fn))

    gl = types.ModuleType("OpenGL.GL")
    for i, name in enumerate((
            "GL_TEXTURE_2D", "GL_RGB8", "GL_RGB", "GL_UNSIGNED_BYTE",
            "GL_TEXTURE_MAG_FILTER", "GL_TEXTURE_MIN_FILTER", "GL_NEAREST",
            "GL_READ_FRAMEBUFFER", "GL_COLOR_ATTACHMENT0",
            "GL_COLOR_BUFFER_BIT", "GL_DEPTH_BUFFER_BIT", "GL_LINEAR")):
        setattr(gl, name, 0x1000 + i)
    for name in ("glBindTexture", "glTexImage2D", "glTexParameteri",
                 "glBindFramebuffer", "glFramebufferTexture2D", "glClear",
                 "glBlitFramebuffer"):
        setattr(gl, name, lambda *a: None)
    gl.glGenTextures = lambda n: 1
    gl.glGenFramebuffers = lambda n: 1

    def tex_sub_image(target, level, x, y, w, h, fmt, typ, data):
        record["frames"].append(np.array(data, np.uint8).reshape(h, w, 3))

    gl.glTexSubImage2D = tex_sub_image
    return glfw, gl, record


@contextlib.contextmanager
def stub_gl(glfw, gl):
    """``glfw`` and ``OpenGL.GL`` in ``sys.modules`` for the block (and
    whatever stood there before restored after it)."""
    import types

    opengl = types.ModuleType("OpenGL")
    opengl.GL = gl
    new = {"glfw": glfw, "OpenGL": opengl, "OpenGL.GL": gl}
    old = {k: sys.modules.get(k) for k in new}
    sys.modules.update(new)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


# the zoo on the card vs its own CPU forward: the networks' convs and
# matmuls sum in other orders on the two (TF32 off); the ops differ by the
# last bits of CUDA's and the CPU's exp / sqrt / arcsin
ZOO_NET_TOL = dict(rtol=1e-3, atol=1e-4)
ZOO_OP_TOL = dict(rtol=1e-4, atol=1e-5)
# the shell sampler's theta is arcsin(x) / 2 pi with |x| up to 1, whose
# slope turns the last bit of x (6e-8) into up to sqrt(2 * 6e-8) / 2 pi =
# 5.5e-5
ZOO_SPHERE_TOL = dict(rtol=1e-4, atol=2e-4)
MESH_N = 256                   # enerf_tpu/utils/mesh.py's default grid
MESH_FALLBACK_N = 128
MESH_LIMIT_S = 60.0
GUI_FRAMES = 12


def _zoo_cases(torch):
    """(name, module or None, fn, inputs on the CPU, tolerance): the zoo
    networks and ops at the DTU 512x640 frame's shapes, seeded."""
    from enerf_tpu_torch.models.cost_reg import MinCostRegNetTri
    from enerf_tpu_torch.models.feature_net import CNNRender
    from enerf_tpu_torch.models.nerf_head import MVSNeRFHead
    from enerf_tpu_torch.models.res_unet import ResUnet
    from enerf_tpu_torch.ops import composite, rays, sh, warp

    g = torch.Generator().manual_seed(13)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    P = H * W                                   # level 1 renders every pixel
    torch.manual_seed(13)
    nets = [("res_unet", ResUnet(), (rand(3, H, W, 3),)),
            ("cnn_render", CNNRender(), (rand(1, H, W, 3),)),
            ("cost_reg_tri", MinCostRegNetTri(8),
             (rand(1, 8, H // 2, W // 2, 8, lo=-1.0),)),
            ("mvsnerf_head", MVSNeRFHead(11, 3),
             (rand(1, P * 2, 8, lo=-1.0), rand(1, P * 2, 3, 15, lo=-1.0)))]
    cases = []
    for i, (name, net, args) in enumerate(nets):
        randomize_bn_stats(torch, net, 100 + i)
        cases.append((name, net.eval(), None, args, ZOO_NET_TOL))

    def raw(n):
        r = rand(1, P, n, 4)
        r[..., 3] = 2.0 * torch.randn(1, P, n, generator=g).abs()
        return r

    z2 = [rand(1, P, 2, lo=2.0, hi=6.0) for _ in range(2)]
    z32 = torch.sort(rand(1, P, 32, lo=2.0, hi=6.0), dim=-1).values
    ray8 = torch.cat([rand(1, P, 3, lo=-0.5, hi=0.5),
                      torch.randn(1, P, 3, generator=g), rand(1, P, 2)], -1)
    dirs = torch.nn.functional.normalize(torch.randn(1, P, 3, generator=g),
                                         dim=-1)
    proj = torch.tensor([[1.02, 0.01, -3.0, 20.0], [0.005, 0.98, 2.0, -15.0],
                         [1e-5, 2e-5, 1.0, 0.05]])
    ops = [
        ("raw2outputs_layer", lambda a, b, c, d: composite.raw2outputs_layer(
            [a, b], [c, d]), (raw(2), raw(2), *z2)),
        ("raw2outputs_ngp", composite.raw2outputs_ngp,
         (raw(32), z32, ray8[..., 3:6])),
        ("sample_points_on_plane", rays.sample_points_on_plane, (ray8,)),
        ("sample_points_along_sphere", rays.sample_points_along_sphere,
         (ray8 + torch.tensor([4.0, 0, 0, 0, 0, 0, 0, 0]),)),
        *[(f"eval_sh_bases_{n}", functools.partial(sh.eval_sh_bases, n),
           (dirs,)) for n in (9, 16, 25)],
        # level 0's warp: 32 FPN channels at 1/4, 48 planes
        ("homo_warp", warp.homo_warp,
         (rand(H // 4, W // 4, 32, lo=-1.0), proj,
          rand(48, H // 4, W // 4, lo=425.0, hi=905.0)))]
    cases += [(name, None, fn, args, ZOO_SPHERE_TOL if "sphere" in name
               else ZOO_OP_TOL) for name, fn, args in ops]
    return cases


def _outputs(out) -> list:
    if isinstance(out, dict):
        return [(k, v) for k, v in out.items()]
    if isinstance(out, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(out)]
    return [("out", out)]


def extras_zoo(torch) -> list:
    """Each zoo network and op on the card vs its own CPU forward on the
    same weights and inputs: CUDA-event ms (median of 10) and the max abs
    error of every output."""
    rows = []
    with torch.inference_mode():
        for name, net, fn, args, tol in _zoo_cases(torch):
            cpu_out = (net or fn)(*args)
            dev_args = [a.cuda() for a in args]
            call = net.cuda() if net is not None else fn
            out = call(*dev_args)
            errs = {k: max_err(torch, v.cpu(), dict(_outputs(cpu_out))[k],
                               tol["rtol"], tol["atol"],
                               f"extras {name} {k} card vs CPU")
                    for k, v in _outputs(out)}
            ms = time_ms(torch, lambda: call(*dev_args), reps=10, warmup=2)
            rows.append({"name": name, "device_ms": ms["median"],
                         "device_ms_min": ms["min"], "max_abs_err": errs,
                         "shapes": [list(a.shape) for a in args], "tol": tol})
            del cpu_out, out, dev_args
            if net is not None:
                net.cpu()
            torch.cuda.empty_cache()
    return rows


def mesh_field(torch, xyz):
    """A seeded analytic density: the larger of two ellipsoids' 1 - r^2,
    by multiplications, subtractions and a maximum only, which round alike
    on the card and the CPU."""
    out = None
    for c, k in (((0.12, -0.2, 0.05), (1.6, 2.1, 1.3)),
                 ((-0.3, 0.25, -0.1), (2.4, 1.7, 2.9))):
        q = None
        for d in range(3):
            t = (xyz[:, d:d + 1] - c[d]) * k[d]
            q = t * t if q is None else q + t * t
        q = 1.0 - q
        out = q if out is None else torch.maximum(out, q)
    return out


def extras_mesh(torch) -> dict:
    """``extract_mesh`` with ``mesh_field`` queried on the card at N = 256
    (128 where 256 takes more than a minute): the query's ms on the card
    (its own loop, batches of 8192 as extract_mesh queries them, each
    density back on the host), marching tetrahedra's ms on the host, and
    the extraction's vertices and faces vs the same extraction queried on
    the CPU."""
    import tempfile

    from enerf_tpu_torch.utils.mesh import extract_mesh, marching_tetrahedra

    bbox = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
    rec = {}
    for N in (MESH_N, MESH_FALLBACK_N):
        axes = [np.linspace(-1.0, 1.0, N)] * 3
        xyz = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        t0 = time.perf_counter()
        dens = []
        with torch.inference_mode():
            for i in range(0, len(xyz), 8192):
                pts = torch.from_numpy(xyz[i:i + 8192].astype(np.float32))
                dens.append(mesh_field(torch, pts.cuda()).cpu().numpy()[:, 0])
        query_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        verts, faces = marching_tetrahedra(np.concatenate(dens).reshape(
            N, N, N), 0.5, [2.0 / (N - 1)] * 3)
        march_s = time.perf_counter() - t0
        rec = {"N": N, "query_ms": 1e3 * query_s, "marching_ms": 1e3 * march_s,
               "points": len(xyz), "verts": len(verts), "faces": len(faces)}
        if query_s + march_s <= MESH_LIMIT_S:
            break
        rec_256 = rec
        rec = {}
    if not rec:
        fail("extras: the mesh took more than a minute at N = 128 too")
    if rec["N"] != MESH_N:
        rec["why_not_256"] = (f"N = 256 took {rec_256['query_ms']:.0f} ms of "
                              f"query and {rec_256['marching_ms']:.0f} ms of "
                              f"marching, past {MESH_LIMIT_S:.0f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[dev] = extract_mesh(lambda p: mesh_field(torch, p), 0.5, bbox,
                                    f"{tmp}/{dev}.ply", N=rec["N"], device=dev)
            rec[f"extract_{dev}_ms"] = 1e3 * (time.perf_counter() - t0)
    for a, b, what in zip(got["cuda"], got["cpu"], ("vertices", "faces")):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"extras: mesh {what} queried on the card {a.shape} differ "
                 f"from the CPU's {b.shape}")
    if not 1000 < len(got["cuda"][1]):
        fail(f"extras: the mesh has {len(got['cuda'][1])} faces")
    rec["verts_equal_cpu"] = rec["faces_equal_cpu"] = True
    return rec


def extras_gui(torch) -> dict:
    """``gui_human.run_gui`` on ``phase_interactive``'s renderer and scene
    through ``stub_gl_modules`` (12 frames; the panel on for frames 0-5,
    H at frame 6 turns it off; moves, a drag and the rail's keys before
    that): launches a frame, the loop's fps, ``draw_hud``'s ms on a
    512x512 frame; the last texture upload vs the headless loop's u8 frame
    at the same pose and frame, flipped."""
    from enerf_tpu_torch import gui_human, native
    from enerf_tpu_torch.config import make_cfg

    cfg = make_cfg(str(ROOT / "configs/enerf/interactive/zjumocap.yaml"),
                   ["workspace", str(ROOT / "build" / "video_fixture"),
                    *VIDEO_FRAMES_OPT])
    rend = gui_human.Renderer(cfg)
    k = GLFW_CONSTANTS
    events = {2: [("key", k["KEY_W"], k["PRESS"], 0),
                  ("key", k["KEY_A"], k["REPEAT"], 0)],
              3: [("cursor", 100.0, 100.0),
                  ("mouse", k["MOUSE_BUTTON_LEFT"], k["PRESS"], 0),
                  ("cursor", 140.0, 120.0),
                  ("mouse", k["MOUSE_BUTTON_LEFT"], k["RELEASE"], 0)],
              4: [("scroll", 1.0), ("key", k["KEY_T"], k["PRESS"], 0),
                  ("key", k["KEY_T"], k["PRESS"], 0),
                  ("key", k["KEY_T"], k["PRESS"], 0),
                  ("key", k["KEY_T"], k["PRESS"], 0)],
              5: [("key", k["KEY_P"], k["PRESS"], 0),
                  ("key", k["KEY_EQUAL"], k["PRESS"], 0)],
              6: [("key", k["KEY_H"], k["PRESS"], 0)]}
    poses = []
    render_next = rend.render_next

    def recorded():
        poses.append((rend.iter, rend.cam.get_c2w(), rend.cam.get_w2c()))
        return render_next()

    rend.render_next = recorded
    glfw, gl, rec = stub_gl_modules(GUI_FRAMES, events)
    reset_launches()
    t0 = time.perf_counter()
    with stub_gl(glfw, gl):
        gui_human.run_gui(rend)
    loop_s = time.perf_counter() - t0
    launches = read_launches()
    expect = {kk: v * GUI_FRAMES for kk, v in HUMAN_PER_FRAME.items()}
    if launches != expect or len(rec["frames"]) != GUI_FRAMES:
        fail(f"extras: the GUI loop launched {launches} over "
             f"{len(rec['frames'])} frames, expected {expect}")
    if rend.opt.show_hud or rend.opt.type != 0 or not rend.cam.on_cam_path:
        fail("extras: the GUI's keys did not set the options")
    # the headless loop's frame at the last frame's pose
    it, c2w, w2c = poses[-1]
    rend.render_next = render_next
    rend.iter = it
    rend.cam.get_c2w, rend.cam.get_w2c = (lambda: c2w), (lambda: w2c)
    want = native.f32_unit_to_u8(rend.render_next())[::-1]
    got = rec["frames"][-1]
    diff = int((got != want).any(-1).sum()) if got.shape == want.shape else -1
    if diff:
        fail(f"extras: the GUI's last texture {got.shape} differs from the "
             f"headless frame {want.shape} at {diff} pixels")
    hud_in = native.f32_unit_to_u8(np.zeros((512, 512, 3), np.float32))
    hud_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        gui_human.draw_hud(hud_in.copy(), rend)
        hud_ms.append(1e3 * (time.perf_counter() - t0))
    hud_pixels = int((gui_human.draw_hud(hud_in.copy(), rend) != 0).any(-1)
                     .sum())
    return {"window": "stub", "frames": GUI_FRAMES, "frame_hw": list(got.shape),
            "loop_fps": GUI_FRAMES / loop_s,
            "steady_fps": rend.fps, "launches": launches,
            "launches_per_frame": {kk: v / GUI_FRAMES
                                   for kk, v in launches.items()},
            "draw_hud_ms": statistics.median(hud_ms),
            "hud_pixels": hud_pixels, "last_frame_vs_headless_pixels": diff,
            "polls": rec["polls"]}


def phase_extras(torch, smi_line: str) -> dict:
    """The modules outside the frame paths (the last slice of the port):
    the zoo networks and ops on the card vs the CPU, the mesh extractor's
    query on the card, and the windowed GUI's loop through stub glfw and
    OpenGL modules (the card machine has no display). Returns the GUI
    loop's launches."""
    zoo = extras_zoo(torch)
    mesh = extras_mesh(torch)
    gui = extras_gui(torch)
    emit("extras", zoo=zoo, mesh=mesh, gui=gui, tf32=(
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32), nvidia_smi=smi_line)
    return gui["launches"]


def phase_visualize(torch, smi_line: str) -> dict:
    """The video main path: ``enerf_tpu_torch.run``'s ``main`` with ``--type
    visualize`` on configs/enerf/enerf_outdoor/actor1_path.yaml over
    ``run_outdoor``'s scene (``ENeRFComposite`` at 768x1024, the orbit of
    ``num_circle_view`` 4, a frame a scene frame): launches a frame K1 4,
    K4 4, layer_render 1; frames, forward ms, the visualizer's and the
    encoding's host
    ms; the first frame vs the plain path; ``color.mp4`` and
    ``depth.mp4`` read back (frames, size, fps)."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch import run
    from enerf_tpu_torch.config import make_cfg
    from enerf_tpu_torch.utils.video import read_mp4

    fixture = ROOT / "build" / "video_fixture"
    cfg_file = "configs/enerf/enerf_outdoor/actor1_path.yaml"
    opts = ["workspace", str(fixture), *VIDEO_FRAMES_OPT,
            "test_dataset.num_circle_view", "4"]
    cfg = make_cfg(cfg_file, opts)
    reset_launches()
    t0 = time.perf_counter()
    res = run.main(["--type", "visualize", "--cfg_file", cfg_file, *opts])
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    n = res["frames"]
    expect = {k: v * n for k, v in COMPOSITE_PER_FRAME.items()}
    if n < 2 or launches != expect:
        fail(f"visualize: {n} frames, kernel launches on the main path "
             f"{launches}, expected {expect}")
    with plain_path():
        ref = et.render(res["model"], res["first_batch"])
    err = {k: max_err(torch, torch.from_numpy(v).cuda(), ref[k], E2E_RTOL,
                      E2E_ATOL[k], f"visualize {k} kernel vs plain path")
           for k, v in res["first_out"].items() if k in E2E_ATOL}
    if not err:
        fail(f"visualize: no output held against the plain path "
             f"({sorted(res['first_out'])})")
    h, w = res["first_batch"]["src_inps"].shape[2:4]
    crop = [h - int(h * 0.1), w - 2 * int(w * 0.1)]
    videos = {}
    for name in ("color.mp4", "depth.mp4"):
        frames, fps = read_mp4(str(Path(cfg.result_dir) / name))
        videos[name] = {"frames": len(frames),
                        "hw": list(frames[0].shape[:2]), "fps": fps}
        if (len(frames), list(frames[0].shape[:2]), fps) != (n, crop,
                                                              cfg.fps):
            fail(f"visualize: {name} holds {videos[name]}, expected {n} "
                 f"frames of {crop} at {cfg.fps} fps")
    timed = res["frame_ms"][1:]
    emit("visualize", cfg_file=cfg_file, opts=opts, frames=n,
         frame_hw=[int(h), int(w)], cli_seconds=cli_s, launches=launches,
         launches_per_frame={k: v / n for k, v in launches.items()},
         frame_ms=res["frame_ms"], median_frame_ms=statistics.median(timed),
         upload_ms=res["upload_ms"], loader_host_ms=res["loader_host_ms"],
         loader_wait_ms=res["loader_wait_ms"],
         visualize_host_ms=res["visualize_ms"],
         encode_host_ms=res["encode_ms"], videos=videos,
         kernel_vs_plain_max_abs_err=err,
         e2e_tol={"rtol": E2E_RTOL, "atol": E2E_ATOL}, nvidia_smi=smi_line)
    return launches


# the train CLI in a subprocess: ``python -m enerf_tpu_torch.train`` run by
# runpy, the train step timed by CUDA events (a synchronize after each) and
# the kernel launches counted apart in the train epochs and in Trainer.val;
# a "TRAIN_CLI {json}" line at the end
TRAIN_RUNNER = r"""
import json, runpy, sys, time
import torch
import enerf_tpu_torch.train as T
from enerf_tpu_torch.train.trainer import Trainer
from enerf_tpu_torch.ops.kernels import conv3d_wgrad as kwg
from enerf_tpu_torch.ops.kernels import cost_volume as kcv
from enerf_tpu_torch.ops.kernels import depth_regression as kdr
from enerf_tpu_torch.ops.kernels import layer_render as klr
from enerf_tpu_torch.ops.kernels import render as krender

rec = {"step_ms": [], "loss": [], "train_launches": {}, "val_launches": {}}
def counts():
    return {"cost_volume": kcv.launches, **krender.launches,
            "depth_regression": kdr.launches, "conv3d_wgrad": kwg.launches,
            "layer_render": klr.launches}
def add(into, before):
    for k, v in counts().items():
        into[k] = into.get(k, 0) + v - before[k]
make = T.make_train_step
def timed_make(*a, **kw):
    step = make(*a, **kw)
    def timed(state, batch, phase_hook=None):
        a_, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a_.record()
        out = step(state, batch, phase_hook)
        b_.record(); b_.synchronize()
        rec["step_ms"].append(a_.elapsed_time(b_))
        rec["loss"].append(float(out[1]["loss"]))
        return out
    return timed
T.make_train_step = timed_make
for name, key in (("train_epoch", "train_launches"), ("val", "val_launches")):
    fn = getattr(Trainer, name)
    def wrapped(self, *a, _fn=fn, _key=key, **kw):
        before = counts()
        out = _fn(self, *a, **kw)
        add(rec[_key], before)
        return out
    setattr(Trainer, name, wrapped)
sys.argv = ["python -m enerf_tpu_torch.train"] + sys.argv[1:]
torch.cuda.reset_peak_memory_stats()
runpy.run_module("enerf_tpu_torch.train", run_name="__main__", alter_sys=True)
rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
print("TRAIN_CLI " + json.dumps(rec), flush=True)
"""


def run_train_cli(args: list, timeout: int = 600,
                  nproc: int = 0) -> tuple:
    """``TRAIN_RUNNER`` with ``args`` in a subprocess, or with ``nproc``
    under ``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` (the runner written to build/train_runner.py): (its record, its
    stdout); fails on a non-zero exit."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-c", TRAIN_RUNNER]
    if nproc:
        runner = ROOT / "build" / "train_runner.py"
        runner.parent.mkdir(parents=True, exist_ok=True)
        runner.write_text(TRAIN_RUNNER)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), str(runner)]
    t0 = time.perf_counter()
    sub = subprocess.run([*cmd, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    line = next((ln for ln in sub.stdout.splitlines()
                 if ln.startswith("TRAIN_CLI ")), None)
    if sub.returncode != 0 or line is None:
        fail(f"train_cli: python -m enerf_tpu_torch.train {' '.join(args)}: "
             f"rc {sub.returncode}\n{sub.stdout[-3000:]}\n{sub.stderr[-5000:]}")
    rec = json.loads(line[len("TRAIN_CLI "):])
    rec["seconds"] = secs
    if not rec["loss"] or not all(np.isfinite(rec["loss"])):
        fail(f"train_cli: losses {rec['loss']}")
    return rec, sub.stdout


def phase_train_cli(smi_line: str) -> dict:
    """``python -m enerf_tpu_torch.train`` in subprocesses on the fixtures
    of ``run_zjumocap`` and ``run_outdoor``: zjumocap_train.yaml for 2
    epochs of 3 steps with a checkpoint and a validation after each, then
    a resume that starts at epoch 2 and runs it (no validation); then 2
    steps of actor1.yaml. Each step's ms (CUDA events), the loss, the peak memory;
    the checkpoints and ``config/`` files; K4 launched in training (K1 and
    K2 take their differentiable plain versions there) and the
    validation's kernels launched; the weight-gradient kernel (K5)
    ``WGRAD_PER_STEP`` a ZJU-MoCap step and ``WGRAD_PER_STEP_COMPOSITE`` a
    composite step, none in validation."""
    from enerf_tpu_torch.config import make_cfg

    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()     # the subprocesses take the card's memory
    fixture = ROOT / "build" / "video_fixture"
    # the fixture's 6 cameras all train (the config takes every other of
    # ZJU-MoCap's 23, too few here for 4 source views); the validation
    # renders one view of both frames
    zju = ["--cfg_file", "configs/enerf/zjumocap/zjumocap_train.yaml",
           "workspace", str(fixture), "train.epoch", "2", "ep_iter", "3",
           "eval_ep", "1", "save_ep", "1", "train.num_workers", "4",
           *VIDEO_FRAMES_OPT, "test_dataset.render_views", "[1, 2, 1]",
           "train_dataset.frames", "[0, -1, 1]",
           "train_dataset.input_views", "[0, -1, 1]",
           "train_dataset.render_views", "[0, -1, 1]", "eval_lpips", "False"]
    cfg = make_cfg(zju[1], zju[2:])
    model_dir = Path(cfg.trained_model_dir)
    import shutil

    shutil.rmtree(model_dir, ignore_errors=True)
    first, out1 = run_train_cli(zju)
    want = {"0.pth", "1.pth"}
    have = {p.name for p in model_dir.glob("*.pth")}
    cfg_files = {p.name for p in (model_dir / "config").glob("*")}
    if have != want or cfg_files != {"train_cmd.txt", "train_config.yaml"}:
        fail(f"train_cli: checkpoints {sorted(have)}, config files "
             f"{sorted(cfg_files)}")
    if make_cfg(str(model_dir / "config" / "train_config.yaml")) != cfg:
        fail("train_cli: config/train_config.yaml does not read back as the "
             "run's config")
    resume_args = list(zju)
    resume_args[resume_args.index("train.epoch") + 1] = "3"
    resume_args[resume_args.index("eval_ep") + 1] = "100"
    second, out2 = run_train_cli(resume_args)
    if "resumed at epoch 2" not in out2 or not (model_dir / "2.pth").is_file():
        fail(f"train_cli: the resume did not start at epoch 2\n{out2[-2000:]}")
    for name, rec, steps in (("zjumocap", first, 6),
                             ("zjumocap_resume", second, 3)):
        if len(rec["step_ms"]) != steps:
            fail(f"train_cli {name}: {len(rec['step_ms'])} steps, expected "
                 f"{steps}")
        t = rec["train_launches"]
        if (t.get("depth_regression"), t.get("conv3d_wgrad"),
                t.get("layer_render")) != (2 * steps,
                                           WGRAD_PER_STEP * steps, 0):
            fail(f"train_cli {name}: launched {t} in {steps} train steps, "
                 f"expected K4 2, K5 {WGRAD_PER_STEP} and K6 0 a step")
    v = first["val_launches"]
    if not (v.get("cost_volume", 0) > 0 and v.get("render", 0) > 0
            and v.get("render_l0", 0) > 0 and v.get("depth_regression", 0) > 0
            and v.get("conv3d_wgrad") == 0 and v.get("layer_render") == 0):
        fail(f"train_cli zjumocap: the validation launched {v}")
    outdoor = ["--cfg_file", "configs/enerf/enerf_outdoor/actor1.yaml",
               "workspace", str(fixture), "train.epoch", "1", "ep_iter", "2",
               "eval_ep", "100", "save_ep", "1", "train.num_workers", "4",
               "train_dataset.frames", "[0, -1, 1]"]
    shutil.rmtree(make_cfg(outdoor[1], outdoor[2:]).trained_model_dir,
                  ignore_errors=True)
    third, _ = run_train_cli(outdoor)
    k4_step = COMPOSITE_PER_FRAME["depth_regression"]
    t = third["train_launches"]
    if len(third["step_ms"]) != 2 or \
            (t.get("depth_regression"), t.get("conv3d_wgrad"),
             t.get("layer_render")) != (
                2 * k4_step, 2 * WGRAD_PER_STEP_COMPOSITE, 0):
        fail(f"train_cli actor1: 2 steps, K4 {k4_step}, K5 "
             f"{WGRAD_PER_STEP_COMPOSITE} and K6 0 a step expected: {third}")
    launches = {k: first["train_launches"].get(k, 0)
                + first["val_launches"].get(k, 0) for k in FRAMES_PER_FRAME}
    emit("train_cli", zjumocap=first, zjumocap_resume=second,
         actor1=third, launches=launches, checkpoints=sorted(have),
         nvidia_smi=smi_line)
    return launches


# the ddp phase: the zjumocap_train.yaml run under torch.distributed.run
# (world 1, NCCL) and its one-process reference, deterministic: one loader
# worker (the dataset's rng is then drawn in order) and fix_random
DDP_CLI_STEPS = 3
DDP_TRAIN_STEPS = 4   # world-2 DDP steps at 512x640: the first held, 3 timed
DDP_WORLD = 2
# the ranks' BN running statistics vs one process's: the merged moments sum
# in another order; the atol serves the means near 0 (8e-8 apart there)
DDP_STATS_TOL = dict(rtol=1e-4, atol=1e-6)


def _zju_ddp_args(exp_name: str, steps: int) -> list:
    fixture = ROOT / "build" / "video_fixture"
    return ["--cfg_file", "configs/enerf/zjumocap/zjumocap_train.yaml",
            "workspace", str(fixture), "exp_name", exp_name,
            "train.epoch", "1", "ep_iter", str(steps), "eval_ep", "100",
            "save_ep", "1", "train.num_workers", "1", "fix_random", "True",
            "train_dataset.frames", "[0, -1, 1]",
            "train_dataset.input_views", "[0, -1, 1]",
            "train_dataset.render_views", "[0, -1, 1]"]


def ddp_rank(dev, steps: int, hw: tuple) -> dict:
    """One rank of the ddp phase's world-2 run over gloo, every rank on the
    one card: ``steps`` DDP steps of ``tools/bench_train.py``'s workload
    at ``hw`` (512x640), this rank on its half of a global batch of 2
    (the first step's loss, clipped gradients and BN running statistics
    kept; each step's ms, the host ms of its ``torch.distributed``
    all-reduces (the synced BNs' and the stats', each timed after a
    synchronize: gloo would block on the card's queue first), and DDP's
    own gradient-communication and overlap times; K4's launches over the
    steps), then the 512x640 DTU frame through
    ``make_sharded_render_step`` (this rank's K1, K2 and K4 launches and
    frame ms). Results as numpy."""
    import torch
    import torch.distributed as dist

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import dtu_eval_config
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.parallel import local_batch_slice
    from enerf_tpu_torch.train import create_train_state, make_train_step
    from enerf_tpu_torch.train.step import make_sharded_render_step, wrap_ddp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks = [("start", time.perf_counter())]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    coll_ms = []
    all_reduce = dist.all_reduce

    def timed_all_reduce(*a, **kw):
        # gloo blocks the host until the card has made the tensor: wait
        # for that first, so that the time is the collective's own
        sync()
        t0 = time.perf_counter()
        out = all_reduce(*a, **kw)
        coll_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    dist.all_reduce = timed_all_reduce
    h, w = hw
    cfg = bench_train_config()
    batch = make_synthetic_batch(cfg, H=h, W=w, split="train",
                                 batch_size=DDP_WORLD)
    part = local_batch_slice(DDP_WORLD)
    local = et.device_batch({k: v[part] for k, v in batch.items()}, dev)
    model = et.build_model(cfg, device=dev, seed=0, train=True)
    state = create_train_state(cfg, model)
    state.model = wrap_ddp(cfg, model)
    step = make_train_step(cfg, (h, w))
    rec = {"step_ms": [], "allreduce_host_ms": [], "loss": []}
    sync()
    marks.append(("build", time.perf_counter()))
    reset_launches()
    for i in range(steps):
        coll_ms.clear()
        t0 = time.perf_counter()
        state, stats = step(state, local)
        rec["loss"].append(float(stats["loss"]))
        sync()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["allreduce_host_ms"].append(sum(coll_ms))
        if i == 0:
            rec["grads"] = {k: p.grad.detach().cpu().numpy()
                            for k, p in model.named_parameters()
                            if p.grad is not None}
            rec["buffers"] = {k: b.detach().cpu().numpy().copy()
                              for k, b in model.named_buffers()
                              if k.endswith(("running_mean", "running_var"))}
    rec["train_launches"] = read_launches()
    ddp_stats = state.model._get_ddp_logging_data()
    rec["ddp_logging"] = {k: ddp_stats.get(k) for k in (
        "avg_forward_compute_time", "avg_backward_compute_time",
        "avg_backward_comm_time", "avg_backward_compute_comm_overlap_time",
        "comm_hook", "backend_name", "find_unused_parameters")}
    del state, step, model, local
    marks.append(("train", time.perf_counter()))

    rcfg = dtu_eval_config()
    rmodel = et.build_model(rcfg, device=dev, seed=0)
    rbatch = make_synthetic_batch(rcfg, H=h, W=w)
    render = make_sharded_render_step(rcfg, rmodel)
    render(rbatch)                                    # warm-up
    sync()
    reset_launches()
    t0 = time.perf_counter()
    out = render(rbatch)
    sync()
    rec["frame_ms"] = (time.perf_counter() - t0) * 1e3
    rec["render_launches"] = read_launches()
    rec["out"] = {k: v.cpu().numpy() for k, v in out.items()}
    marks.append(("render", time.perf_counter()))
    rec["seconds"] = {b: tb - ta for (_, ta), (b, tb) in zip(marks, marks[1:])}
    dist.all_reduce = all_reduce
    return rec


def phase_ddp(torch, smi_line: str) -> dict:
    """The data-parallel path (``enerf_tpu_torch.parallel``, the synced BN,
    ``wrap_ddp``, the ray-split render, ``train --distributed``) on the
    one card:

    - world 1 over NCCL: ``python -m torch.distributed.run --standalone
      --nproc_per_node 1 -m enerf_tpu_torch.train --distributed`` on
      zjumocap_train.yaml over ``run_zjumocap``'s scene, 3 steps: step ms,
      loss, peak memory, K4 launches, the checkpoint's keys (none with a
      ``module.`` prefix); its first loss vs the same run without
      ``--distributed`` (1 step, in this process, cuDNN's TF32 on as in
      the CLI), rtol TRAIN_LOSS_RTOL;
    - world 2 over gloo, both ranks on this card (NCCL takes one rank a
      card): ``ddp_rank``'s DDP steps at 512x640 vs one process's step on
      the batch of 2 (loss TRAIN_LOSS_RTOL, every gradient at cosine ≥
      TRAIN_GRAD_COS, running statistics rtol 1e-4), each rank's step ms
      and all-reduce share; then the ray-split DTU frame vs ``render`` in
      this process (E2E tolerances) and each rank's launches (K1 2, K2 1,
      K4 2).

    Returns the phase's kernel launches, summed over its runs and ranks.
    One card shows no multi-GPU speedup: two ranks share its SMs."""
    import gc
    import os
    import shutil

    import enerf_tpu_torch as et
    from enerf_tpu_torch.config import dtu_eval_config, make_cfg
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
    from enerf_tpu_torch.parallel import spawn_ranks
    from enerf_tpu_torch.train import create_train_state, make_train_step
    from enerf_tpu_torch.train.__main__ import main as train_main

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    args = _zju_ddp_args("zjumocap_ddp", DDP_CLI_STEPS)
    model_dir = Path(make_cfg(args[1], args[2:]).trained_model_dir)
    shutil.rmtree(model_dir, ignore_errors=True)
    parts_s = {}
    world1, _ = run_train_cli(["--distributed", *args], nproc=1)
    parts_s["world1_cli"] = world1["seconds"]
    if len(world1["step_ms"]) != DDP_CLI_STEPS or \
            (world1["train_launches"].get("depth_regression"),
             world1["train_launches"].get("conv3d_wgrad")) != (
                2 * DDP_CLI_STEPS, WGRAD_PER_STEP * DDP_CLI_STEPS):
        fail(f"ddp world 1: {world1}")
    ckpt = torch.load(model_dir / "0.pth", map_location="cpu",
                      weights_only=True)
    keys = sorted(ckpt["net"])
    if any(k.startswith("module.") for k in keys) or not any(
            k.startswith("feature_net.") for k in keys):
        fail(f"ddp world 1: checkpoint keys {keys[:5]}...")
    # the same run without --distributed, one step, in this process under
    # the CLI's own TF32 defaults (cuDNN's on)
    ref_args = _zju_ddp_args("zjumocap_ddp_ref", 1)
    shutil.rmtree(make_cfg(ref_args[1], ref_args[2:]).trained_model_dir,
                  ignore_errors=True)
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    try:
        with contextlib.redirect_stdout(sys.stderr):
            _, trainer, _ = train_main(ref_args)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ref_loss = trainer.recorder.scalars["loss"].deque[0]
    del trainer
    parts_s["reference_cli"] = time.perf_counter() - t0
    if abs(world1["loss"][0] - ref_loss) > TRAIN_LOSS_RTOL * abs(ref_loss):
        fail(f"ddp world 1: first loss {world1['loss'][0]}, {ref_loss} "
             f"without --distributed (rtol {TRAIN_LOSS_RTOL})")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_ranks(ddp_rank, DDP_WORLD, (DDP_TRAIN_STEPS, (H, W)),
                        device="cuda:0", backend="gloo", timeout=600)
    parts_s["world2_ranks"] = time.perf_counter() - t0
    print(f"ddp: parts {parts_s}", file=sys.stderr, flush=True)
    cfg = bench_train_config()
    batch = make_synthetic_batch(cfg, H=H, W=W, split="train",
                                 batch_size=DDP_WORLD)
    model = et.build_model(cfg, seed=0, train=True)
    _, stats = make_train_step(cfg, (H, W))(create_train_state(cfg, model),
                                            batch)
    loss_one = float(stats["loss"])
    buffers = dict(model.named_buffers())
    per_rank = []
    for r, rec in enumerate(ranks):
        if abs(rec["loss"][0] - loss_one) > TRAIN_LOSS_RTOL * abs(loss_one):
            fail(f"ddp rank {r}: loss {rec['loss'][0]}, one process on the "
                 f"batch of 2 {loss_one} (rtol {TRAIN_LOSS_RTOL})")
        worst = (2.0, None)
        for k, p in model.named_parameters():
            g = p.grad.double().cpu().ravel() if p.grad is not None else None
            if g is None or float(g.abs().max()) < 1e-7:
                continue
            if k not in rec["grads"]:
                fail(f"ddp rank {r}: no gradient of {k}")
            a = torch.from_numpy(rec["grads"][k]).double().ravel()
            worst = min(worst, (float(a @ g / (a.norm() * g.norm())), k))
        if worst[0] < TRAIN_GRAD_COS:
            fail(f"ddp rank {r}: gradient of {worst[1]} at cosine {worst[0]} "
                 f"vs one process (limit {TRAIN_GRAD_COS})")
        for k, v in rec["buffers"].items():
            max_err(torch, torch.from_numpy(v), buffers[k].cpu(),
                    DDP_STATS_TOL["rtol"], DDP_STATS_TOL["atol"],
                    f"ddp rank {r} {k} vs one process")
        t = rec["train_launches"]
        if (t["depth_regression"], t["conv3d_wgrad"]) != (
                2 * DDP_TRAIN_STEPS, WGRAD_PER_STEP * DDP_TRAIN_STEPS):
            fail(f"ddp rank {r}: train launches {t}")
        if rec["render_launches"] != FRAMES_PER_FRAME:
            fail(f"ddp rank {r}: ray-split frame launches "
                 f"{rec['render_launches']}")
        timed = rec["step_ms"][1:]
        # DDP's gradient all-reduce where the backward does not hide it
        log = rec["ddp_logging"]
        comm = ((log.get("avg_backward_comm_time") or 0)
                - (log.get("avg_backward_compute_comm_overlap_time") or 0)) / 1e6
        per_rank.append({
            "rank": r, "loss": rec["loss"], "step_ms": rec["step_ms"],
            "median_step_ms": statistics.median(timed),
            "allreduce_host_ms": rec["allreduce_host_ms"],
            "ddp_logging": rec["ddp_logging"],
            "allreduce_share": (statistics.median(rec["allreduce_host_ms"][1:])
                                + comm) / statistics.median(timed),
            "worst_grad_cosine": worst[0], "worst_grad_param": worst[1],
            "train_launches": rec["train_launches"],
            "frame_ms": rec["frame_ms"], "seconds": rec["seconds"],
            "render_launches": rec["render_launches"]})
    del model, stats
    rcfg = dtu_eval_config()
    ref = et.render(et.build_model(rcfg, seed=0),
                    make_synthetic_batch(rcfg, H=H, W=W))
    err = {}
    for r, rec in enumerate(ranks):
        if set(rec["out"]) != set(ref):
            fail(f"ddp rank {r}: ray-split outputs {sorted(rec['out'])}")
        for k, v in rec["out"].items():
            err[f"rank{r}_{k}"] = max_err(
                torch, torch.from_numpy(v).cuda(), ref[k], E2E_RTOL,
                E2E_ATOL[k], f"ddp rank {r} ray-split {k} vs render")
    launches = {k: world1["train_launches"].get(k, 0)
                + sum(rec["train_launches"][k] + rec["render_launches"][k]
                      for rec in ranks)
                for k in FRAMES_PER_FRAME}
    emit("ddp", world1_nccl={
             "steps": DDP_CLI_STEPS, "step_ms": world1["step_ms"],
             "loss": world1["loss"], "loss_without_distributed": ref_loss,
             "peak_mem_gib": world1["peak_mem_gib"],
             "train_launches": world1["train_launches"],
             "checkpoint_keys": len(keys), "checkpoint_key_sample": keys[:3],
             "seconds": world1["seconds"]},
         world2_gloo={"H": H, "W": W, "global_batch": DDP_WORLD,
                      "steps": DDP_TRAIN_STEPS, "loss_one_process": loss_one,
                      "ranks": per_rank, "ray_split_max_abs_err": err},
         launches=launches, seconds=time.perf_counter() - t_phase,
         parts_seconds=parts_s,
         cpu_threads=os.cpu_count(), nvidia_smi=smi_line)
    return launches


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
    smi_line = run_phase("device", phase_device, torch)
    l0_resources = run_phase("build", phase_build)
    k1 = run_phase("k1", phase_k1, torch, cfg)
    k1_crop = run_phase("k1_crop", phase_k1_crop, torch)
    k2 = run_phase("k2", phase_k2, torch, cfg)
    k2_l0 = run_phase("k2_l0", phase_k2_l0, torch, cfg)
    k6 = run_phase("layer_render", phase_layer_render, torch)
    bf16_paths, bf16_kernels = run_phase("bf16", phase_bf16, torch)
    paths = {}
    paths["frames"], model, batch = run_phase("frames", phase_frames, torch,
                                              cfg)
    run_phase("profile", phase_profile, torch, model, batch)
    del model, batch
    paths["human"], human_calls = run_phase("human", phase_human, torch)
    paths["composite"], composite_calls = run_phase(
        "composite", phase_composite, torch)
    paths["val"], val_calls = run_phase("val", phase_val, torch)
    paths["run_dtu"] = run_phase("run_dtu", phase_run_dtu, torch, smi_line)
    run_phase("jpeg", phase_jpeg, torch, smi_line)
    paths["run_zjumocap"] = run_phase("run_zjumocap", phase_run_zjumocap,
                                      torch, smi_line)
    paths["run_outdoor"] = run_phase("run_outdoor", phase_run_outdoor, torch,
                                     smi_line)
    paths["interactive"] = run_phase("interactive", phase_interactive, torch,
                                     smi_line)
    paths["visualize"] = run_phase("visualize", phase_visualize, torch,
                                   smi_line)
    path_calls = {"human": human_calls, "composite": composite_calls,
                  "val": val_calls}
    k4 = run_phase("k4", phase_k4, torch, cfg)
    floor = run_phase("k4_floor", phase_k4_floor, torch)
    wgrad = run_phase("wgrad", phase_wgrad, torch)
    paths["train"], state, step, train_batch = run_phase("train", phase_train,
                                                         torch)
    profile_device(torch, "train_profile",
                   lambda: step(state, train_batch), 2, "step")
    del state, step, train_batch
    paths["train_cli"] = run_phase("train_cli", phase_train_cli, smi_line)
    paths["ddp"] = run_phase("ddp", phase_ddp, torch, smi_line)
    paths["extras"] = run_phase("extras", phase_extras, torch, smi_line)
    emit("profiler_lead", lead_launches=LEAD_LAUNCHES,
         sessions=len(LEAD_LOST), max_lost=max(n for _, n in LEAD_LOST),
         sessions_with_loss=sum(n > 0 for _, n in LEAD_LOST),
         lost_by_session=LEAD_LOST)

    def launches(kernel):
        by_path = {p: n[kernel] for p, n in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def on_paths(kernel):
        """A frame's calls of ``kernel`` on each variant's path, each held
        on its own (``hold_path_kernels``): summed times and bound."""
        by_path = {}
        for path, cases in path_calls.items():
            cs = [c for c in cases if c["kernel"] == kernel]
            if not cs:
                continue
            bd, by = cases_bound(kernel, cs)
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
        kernel_entry(
            "cost_volume", "cost_volume", **launches("cost_volume"),
            max_abs_err=max(max(c["max_abs_err"] for c in k1 + k1_crop),
                            path_err("cost_volume")),
            # per DTU frame: the level-0 and level-1 launches together
            ms=sum(c["ms"]["median"] for c in per_frame),
            run_ms=sum(c["run_ms"] for c in per_frame),
            device_ms=sum(c["device_ms"] for c in per_frame),
            plain_ms=sum(c["plain_ms"]["median"] for c in per_frame),
            bound_ms=k1_bound, bound_by=k1_by,
            # the crop mode: the composite frame's two fg windows
            crop_device_ms=sum(c["device_ms"] for c in crop_frame),
            crop_plain_ms=sum(c["plain_ms"]["median"] for c in crop_frame),
            crop_bound_ms=sum(c["bound_ms"] for c in crop_frame),
            # a human and a composite frame's calls, each on its own inputs
            per_frame_by_path=on_paths("cost_volume")),
        kernel_entry(
            "render", "render", **launches("render"),
            max_abs_err=max(max(c["max_abs_err"] for c in k2),
                            path_err("render")),
            ms=full["ms"]["median"], run_ms=full["run_ms"],
            device_ms=full["device_ms"], plain_ms=full["plain_ms"]["median"],
            bound_ms=full["bound_ms"], bound_by=full["bound_by"],
            bound_f32_ms=full["bound_f32_ms"],
            per_frame_by_path=on_paths("render")),
        kernel_entry(
            "render_l0", "render_l0", **launches("render_l0"),
            max_abs_err=max(max(c["max_abs_err"] for c in k2_l0),
                            path_err("render_l0")),
            # a 512x640 frame's level 0: 20,480 rays, S = 3
            ms=full_l0["ms"]["median"], run_ms=full_l0["run_ms"],
            device_ms=full_l0["device_ms"],
            plain_ms=full_l0["plain_ms"]["median"],
            bound_ms=full_l0["bound_ms"], bound_by=full_l0["bound_by"],
            bound_f32_ms=full_l0["bound_f32_ms"],
            per_frame_by_path=on_paths("render_l0"),
            # by S: ptxas' registers and spill bytes, the dynamic shared
            # memory
            resources_by_s=l0_resources),
        kernel_entry(
            "depth_regression", "depth_regression",
            **launches("depth_regression"),
            max_abs_err=max(max(max(c["max_abs_err"], c["grad_max_abs_err"])
                                for c in k4 if c["dtype"] == "float32"),
                            path_err("depth_regression")),
            max_abs_err_bf16=max(max(c["max_abs_err"], c["grad_max_abs_err"])
                                 for c in k4 if c["dtype"] == "bfloat16"),
            # per train step: the level-0 and level-1 launches together
            ms=sum(c["ms"]["median"] for c in per_step),
            run_ms=sum(c["run_ms"] for c in per_step),
            device_ms=sum(c["device_ms"] for c in per_step),
            # an empty kernel's device time, twice (two launches a step)
            launch_floor_ms=2 * floor["device_ms"],
            plain_ms=sum(c["plain_ms"]["median"] for c in per_step),
            bound_ms=k4_bound, bound_by=k4_by,
            per_frame_by_path=on_paths("depth_regression")),
        kernel_entry(
            "conv3d_wgrad", "conv3d_wgrad",
            **launches("conv3d_wgrad"),
            # per train step: the 21 3D convs' weight gradients together
            **wgrad),
        kernel_entry(
            "layer_render", "layer_render", **launches("layer_render"),
            max_abs_err=max(k6["max_abs_err"], path_err("layer_render")),
            # the outdoor_composite cell's frame: one call
            ms=k6["ms"]["median"], run_ms=k6["run_ms"],
            device_ms=k6["device_ms"], plain_ms=k6["plain_ms"]["median"],
            bound_ms=k6["bound_ms"], bound_by=k6["bound_by"],
            bound_f32_ms=k6["bound_f32_ms"],
            per_frame_by_path=on_paths("layer_render")),
    ] + bf16_kernels
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``enerf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases, each printing one JSON line:
  device   the card's name and its nvidia-smi name / power limit
  build    every CUDA kernel built from csrc/*.cu (one nvcc each, in parallel)
  k1       the cost-volume kernel vs its plain PyTorch version at both
           cascade levels of the 512x640 DTU frame, and with a padded view
  k2       the render kernel vs its plain version at 327,680 rays, S=3, n=2,
           and with a padded view
  frames   the DTU eval forward (512x640, 3 source views, volume planes
           (48, 8), render_if (False, True), grid rays, seeded random
           weights) through ``build_model`` / ``render``: per-frame and
           per-stage ms, kernel launch counts, the kernel path vs the plain
           path on the card, and the card vs the CPU on a small frame
  profile  torch.profiler over two frames: device busy time, idle share,
           the kernels that take the most device time
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
# K1: the plain version samples through grid_sample's normalized
# coordinates, whose round trip moves a point by ~3e-5 px at level 1; over
# the unit-gradient random features used here that moves a variance by up
# to a few 1e-4
K1_TOL = dict(rtol=1e-4, atol=1e-3)
K2_TOL = dict(rtol=1e-4, atol=2e-4)
E2E_ATOL = {"rgb_level1": 3e-4, "weights_level1": 3e-4, "depth_level1": 3e-3,
            "depth_mvs_level1": 3e-3, "std_level1": 3e-3}
E2E_RTOL = 1e-3


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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
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


def _synthetic(cfg, n_src):
    from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch

    batch = make_synthetic_batch(cfg, H=H, W=W, n_src=n_src)
    batch.pop("tar_img")
    return batch


def phase_k1(torch, cfg):
    """Cost-volume kernel vs plain at the two level shapes of the frame."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.ops.camera import get_proj_mats
    from enerf_tpu_torch.ops.depth import init_depth_values
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv

    g = torch.Generator().manual_seed(1)
    cas = cfg.enerf.cas_config
    cases = []
    for name, level, n_src in (("level0", 0, 3), ("level1", 1, 3),
                               ("level1_padded_view", 1, 2)):
        b = et.to_device(_synthetic(cfg, n_src), "cuda")
        C = (32, 16)[level]
        s = cas.im_feat_scale[level]
        feats = torch.randn(1, 3, int(H * s), int(W * s), C, generator=g).cuda()
        projs = get_proj_mats(b["src_exts"], b["src_ixts"], b["tar_ext"],
                              b["tar_ixt"], src_scale=s,
                              tar_scale=cas.volume_scale[level])
        Hv, Wv = int(H * cas.volume_scale[level]), int(W * cas.volume_scale[level])
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
        t_k = time_ms(torch, lambda: kcv.fused_cost_volume(*args))
        t_p = time_ms(torch, lambda: kcv.cost_volume_plain(*args))
        n_valid = float(vm.sum())
        n_vox = out.numel() // C
        flops = n_vox * (n_valid * (8 * C + 24) + 3 * C)
        bd, by = bound_ms(nbytes(feats, projs, dv, vm, out), flops)
        case = dict(case=name, shape=list(out.shape), views_valid=n_valid,
                    max_abs_err=err, tol=K1_TOL, ms=t_k, plain_ms=t_p,
                    bound_ms=bd, bound_by=by, bytes=nbytes(feats, projs, dv, vm, out),
                    flops=flops)
        emit("k1", **case)
        cases.append(case)
    return cases


def phase_k2(torch, cfg):
    """Render kernel vs plain at the full 512x640 ray grid."""
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
    for name, n_src in (("full_frame", 3), ("full_frame_padded_view", 2)):
        b = et.to_device(_synthetic(cfg, n_src), "cuda")
        Hv, Wv = H // 2, W // 2
        depth = (3.2 + 1.2 * torch.rand(1, Hv, Wv, generator=g)).cuda()
        std = (0.05 + 0.2 * torch.rand(1, Hv, Wv, generator=g)).cuda()
        nf = torch.stack([torch.full((1, Hv, Wv), 2.8),
                          torch.full((1, Hv, Wv), 5.0)], 1).cuda()
        rays = build_rays(b["rays_1"], depth, std, nf, False, 2.0, grid=True)
        xyz, uvd, z = sample_along_depth(rays, 2, False)
        uvd = uvd * torch.tensor([1 / (W - 1), 1 / (H - 1), 1.0], device="cuda")
        img = torch.cat([torch.randn(1, 3, H, W, 8, generator=g).cuda(),
                         unpreprocess(b["src_inps"])], -1).contiguous()
        vol = torch.randn(1, 8, Hv, Wv, 8, generator=g).cuda()
        args = (xyz, uvd, z, img, vol, b["src_exts"], b["src_ixts"],
                b["tar_ext"], b["view_mask"], head)
        kw = dict(render_scale=1.0, grid_hw=(H, W))
        with torch.inference_mode():
            plain = krender.render_rays_plain(*args, **kw)
            out = krender.render_rays(*args, **kw)
            torch.cuda.synchronize()
            err = max(max_err(torch, out[k], plain[k], what=f"k2 {name} {k}",
                              **K2_TOL) for k in ("rgb", "depth", "weights"))
            t_k = time_ms(torch, lambda: krender.render_rays(*args, **kw))
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
        bd, by = bound_ms(io, flops)
        case = dict(case=name, rays=xyz.shape[1], views_valid=n_valid,
                    max_abs_err=err, tol=K2_TOL, ms=t_k, plain_ms=t_p,
                    bound_ms=bd, bound_by=by, bytes=io, flops=flops,
                    macs_per_sample=macs)
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
    import enerf_tpu_torch.ops.warp as warp_mod
    from enerf_tpu_torch.ops.kernels import cost_volume as kcv
    from enerf_tpu_torch.ops.kernels import render as krender

    saved = warp_mod.fused_cost_volume, enerf_mod.render_rays
    warp_mod.fused_cost_volume = kcv.cost_volume_plain
    enerf_mod.render_rays = krender.render_rays_plain
    try:
        yield
    finally:
        warp_mod.fused_cost_volume, enerf_mod.render_rays = saved


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

    kcv.launches = krender.launches = 0
    out, first_ms, _ = frames(N_FRAMES)
    launches = {"cost_volume": kcv.launches, "render": krender.launches}
    if launches != {"cost_volume": 2 * N_FRAMES, "render": N_FRAMES}:
        fail(f"kernel launches on the main path {launches}, expected "
             f"cost_volume {2 * N_FRAMES} and render {N_FRAMES}")
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
    ``frames`` frames, from torch.profiler's CUDA trace."""
    import enerf_tpu_torch as et
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            et.render(model, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit("profile", frames=frames, device_busy_ms_per_frame=busy / frames,
         device_span_ms_per_frame=span / frames, idle_share=1 - busy / span,
         top_kernels=[{"name": name[:90], "ms_per_frame": ms / frames,
                       "launches_per_frame": n / frames}
                      for name, (ms, n) in top])


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

    per_frame = [c for c in k1 if c["case"] in ("level0", "level1")]
    k1_bound, k1_by = bound_ms(sum(c["bytes"] for c in per_frame),
                               sum(c["flops"] for c in per_frame))
    kernels = [
        {"name": "cost_volume", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/cost_volume.cu",
         "replaces": "enerf_tpu/ops/pallas/cost_volume.py:122",
         "launches": launches["cost_volume"],
         "max_abs_err": max(c["max_abs_err"] for c in k1),
         # per frame: the level-0 and level-1 launches together
         "ms": sum(c["ms"]["median"] for c in per_frame),
         "plain_ms": sum(c["plain_ms"]["median"] for c in per_frame),
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "render", "route": "cuda",
         "source": "enerf_tpu_torch/csrc/render.cu",
         "replaces": "enerf_tpu/ops/pallas/render.py:426",
         "launches": launches["render"],
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         "ms": k2[0]["ms"]["median"], "plain_ms": k2[0]["plain_ms"]["median"],
         "bound_ms": k2[0]["bound_ms"], "bound_by": k2[0]["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``reference/enerf.py``), run after the window on the
same inputs and the same seeded weights, each number beside the limit that
the cell's traffic file gives it (``limits``).

Render cells, over a seeded sample of the window's frames, of each output
the widest gap of any element (``*_max_*``), the root mean square of a
frame's gaps (``*_rms_*``) and their median and 99th percentile
(``*_p50_*``, ``*_p99_*``), the worst sampled frame's:

- ``rgb_*_abs``: the rendered colour (in [0, 1]);
- ``depth_*_rel``: the rendered depth, over the frame's far − near;
- ``depth_mvs_*_rel``, ``std_*_rel``: the last level's MVS depth and its
  standard deviation, over the frame's far − near.

For the performer the reference renders the masked rays alone and leaves
zeros elsewhere: rgb and depth are compared over the reference's masked
rays, and ``outside_rays_nonzero`` counts the rays outside its mask that
the program did not leave at 0.

Train cells, over the first three steps (``train_numbers``):

- ``loss_rel.<step>``: the gap of a step's loss, over the reference's;
- ``grad_norm_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer takes it, over the larger of the reference
  leaf's norm and the median leaf's;
- ``update_norm_gap``: the same of the parameters' change over the three
  steps, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (the rest move under Adam by rounding
  alone);
- ``grad_norm_gap.median``, ``update_norm_gap.median``: the gap of the
  median leaf's norm, over the reference's median; ``.total`` the gap of
  the norm of all leaves as one vector;
- ``grad_cos_gap``: 1 − the cosine between the program's first gradient
  and the reference's, all leaves as one vector;
- ``update_cos_gap``: 1 − the cosine between the program's change of the
  parameters over the three steps and the reference's, the leaves of
  ``update_norm_gap`` as one vector (a change of the wrong direction);
- ``bn_stats_rel``: the norm of the gap between the two changes of the
  BatchNorm running statistics in the first step, over the norm of the
  reference's, all of them as one vector.

Only the numbers that the traffic file gives a limit are compared.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.reference import enerf as ref

RENDER_KEYS = ("rgb", "depth", "depth_mvs", "std")


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for cuDNN's convs and cuBLAS' products."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_frame(state: dict, cas: dict, batch: dict, mask_rays: bool,
                    level: int, tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's outputs of ``level`` on one frame."""
    params, stats = ref.split_state(state)
    with torch.no_grad(), precision(tf32):
        out = ref.forward(params, stats, cas, batch, mask_rays=mask_rays)
    return {k: out[f"{k}_level{level}"] for k in RENDER_KEYS}


def render_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                batch: dict, rays: Optional[torch.Tensor] = None,
                outside: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The numbers of one frame, ``got`` against ``want``: of each output
    the widest gap (``*_max_*``), the root mean square of the gaps
    (``*_rms_*``), their median and 99th percentile. ``rays`` (N,) bool,
    where given, picks the rays whose outputs (rgb, depth) these compare;
    the maps of the volume (depth_mvs, std) are compared whole. Where
    ``outside`` (N,) bool is given, ``outside_rays_nonzero`` counts the
    rays there whose rgb or depth the program did not leave 0."""
    nf = batch["near_far"].reshape(-1, 2)[0]
    scale = float(nf[1] - nf[0])
    out = {}
    for k in RENDER_KEYS:
        a = torch.as_tensor(got[k]).to(want[k].device, torch.float32)
        d = (a.reshape(want[k].shape) - want[k]).abs()
        if rays is not None and k in ("rgb", "depth"):
            d = d.reshape(rays.shape[0], -1)[rays]
        s = 1.0 if k == "rgb" else scale
        kind = "abs" if k == "rgb" else "rel"
        if bool(torch.isfinite(a).all()):
            d = d.flatten().double()
            q = torch.quantile(d, torch.tensor([0.5, 0.99], dtype=d.dtype,
                                               device=d.device))
            vals = {"max": float(d.max()), "rms": float(d.pow(2).mean().sqrt()),
                    "p50": float(q[0]), "p99": float(q[1])}
        else:
            vals = dict.fromkeys(("max", "rms", "p50", "p99"), math.inf)
        for stat, v in vals.items():
            out[f"{k}_{stat}_{kind}"] = v / s
    if outside is not None:
        hit = torch.zeros_like(outside)
        for k in ("rgb", "depth"):
            a = torch.as_tensor(got[k]).to(outside.device, torch.float32)
            hit |= (a.reshape(outside.shape[0], -1) != 0).any(dim=-1)
        out["outside_rays_nonzero"] = float((hit & outside).sum())
    return out


def worst(per_frame: Sequence[Dict[str, float]]) -> Dict[str, float]:
    keys = per_frame[0].keys()
    return {k: max(p[k] for p in per_frame) for k in keys}


def with_limits(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> List[Tuple[str, float, float]]:
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]


def _leaf_gaps(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
               keys: Sequence[str]) -> float:
    """The worst leaf's |‖a‖ − ‖b‖| over max(‖b‖, the median leaf's ‖b‖)."""
    na = {k: float(a[k].double().norm()) for k in keys}
    nb = {k: float(b[k].double().norm()) for k in keys}
    med = sorted(nb.values())[len(nb) // 2]
    return max(abs(na[k] - nb[k]) / max(nb[k], med) for k in keys)


def train_numbers(losses: Sequence[float], grads: Dict[str, torch.Tensor],
                  start: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor],
                  r_losses: Sequence[float], r_grads: Dict[str, torch.Tensor],
                  r_after: Dict[str, torch.Tensor],
                  stats: Sequence[Dict[str, torch.Tensor]] = (),
                  r_stats: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, float]:
    """The train numbers (module docstring) from the program's losses,
    first gradients and parameters before and after the steps, and the
    reference's; ``stats`` the program's BatchNorm running statistics
    before and after the first step, ``r_stats`` the reference's after
    it."""
    names = ([f"loss_rel.{i + 1}" for i in range(len(r_losses))]
             + ["grad_norm_gap", "grad_norm_gap.median", "grad_norm_gap.total",
                "grad_cos_gap", "update_norm_gap", "update_norm_gap.median",
                "update_norm_gap.total", "update_cos_gap", "bn_stats_rel"])
    if not all(math.isfinite(x) for x in losses):
        return {n: math.inf for n in names}
    out = {f"loss_rel.{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(losses, r_losses))}
    keys = sorted(r_grads)
    out["grad_norm_gap"] = _leaf_gaps(grads, r_grads, keys)
    out["grad_norm_gap.median"] = _median_gap(grads, r_grads, keys)
    out["grad_norm_gap.total"] = _total_gap(grads, r_grads, keys)
    out["grad_cos_gap"] = 1.0 - _cosine(grads, r_grads, keys)
    gnorm = {k: float(r_grads[k].double().norm()) for k in keys}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    d_prog = {k: after[k] - start[k] for k in moved}
    d_ref = {k: r_after[k] - start[k] for k in moved}
    out["update_norm_gap"] = _leaf_gaps(d_prog, d_ref, moved)
    out["update_norm_gap.median"] = _median_gap(d_prog, d_ref, moved)
    out["update_norm_gap.total"] = _total_gap(d_prog, d_ref, moved)
    out["update_cos_gap"] = 1.0 - _cosine(d_prog, d_ref, moved)
    if r_stats is not None:
        s0, s1 = stats
        out["bn_stats_rel"] = _diff_rel({k: s1[k] - s0[k] for k in r_stats},
                                        {k: r_stats[k] - s0[k] for k in r_stats})
    return out


def _cosine(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
            keys: Sequence[str]) -> float:
    """The cosine of a and b, ``keys``' leaves as one vector (0 where
    either is zero)."""
    dot = sum(float((a[k].double() * b[k].double()).sum()) for k in keys)
    na = math.sqrt(sum(float(a[k].double().pow(2).sum()) for k in keys))
    nb = math.sqrt(sum(float(b[k].double().pow(2).sum()) for k in keys))
    return dot / (na * nb) if na > 0 and nb > 0 else 0.0


def _diff_rel(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    """‖a − b‖ over ‖b‖, every leaf as one vector."""
    num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in b)
    den = sum(float(b[k].double().pow(2).sum()) for k in b)
    return math.sqrt(num / den)


def _total_gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
               keys: Sequence[str]) -> float:
    """|‖a‖ − ‖b‖| over ‖b‖, all leaves as one vector."""
    na = math.sqrt(sum(float(a[k].double().pow(2).sum()) for k in keys))
    nb = math.sqrt(sum(float(b[k].double().pow(2).sum()) for k in keys))
    return abs(na - nb) / nb


def _median_gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                keys: Sequence[str]) -> float:
    """|median leaf norm of a − that of b| over that of b."""
    na = sorted(float(a[k].double().norm()) for k in keys)
    nb = sorted(float(b[k].double().norm()) for k in keys)
    m = len(keys) // 2
    return abs(na[m] - nb[m]) / nb[m]

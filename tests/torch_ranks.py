"""The ranks that the port's data-parallel CPU tests spawn
(``enerf_tpu_torch.parallel.spawn_ranks``: gloo, one torch thread a rank).

Each function runs in a fresh process, so this module imports torch, numpy
and the port only: no rank loads JAX or the JAX package, and each reports
what of them it loaded (``forbidden_loaded``). Inputs and results cross
the process boundary as numpy arrays."""

import sys

import numpy as np
import torch

from enerf_tpu_torch import build_model
from enerf_tpu_torch.models.layers import SyncBatchNorm2d, SyncBatchNorm3d
from enerf_tpu_torch.parallel import local_batch_slice, rank
from enerf_tpu_torch.train import create_train_state, make_train_step
from enerf_tpu_torch.train.step import make_sharded_render_step, wrap_ddp

FORBIDDEN = ("jax", "jaxlib", "flax", "enerf_tpu")


def forbidden_loaded():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _numpy(named):
    return {k: v.detach().cpu().numpy().copy() for k, v in named}


def synced_bn(dev, cases):
    """Per case (x, dy, weight, bias): this rank's share of the batch of
    ``x`` through a synced BN (2d or 3d by ``x``'s rank) in training mode,
    the cotangent ``dy`` of its share pulled back: the output, the input
    gradient, the rank's parameter gradients and the running
    statistics."""
    out = []
    for x, dy, weight, bias in cases:
        cls = SyncBatchNorm2d if x.ndim == 4 else SyncBatchNorm3d
        bn = cls(x.shape[1], eps=1e-5).to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
        part = local_batch_slice(len(x))
        xs = torch.from_numpy(x[part]).requires_grad_(True)
        y = bn(xs)
        y.backward(torch.from_numpy(dy[part]))
        out.append(dict(
            y=y.detach().numpy(), dx=xs.grad.numpy(),
            grads=_numpy((k, p.grad) for k, p in bn.named_parameters()),
            buffers=_numpy(bn.named_buffers()), loaded=forbidden_loaded()))
    return out


def ddp_step(dev, cfg, weights, batch, src_hw, steps=1):
    """``steps`` DDP train steps of ``cfg``'s network from ``weights``,
    each rank on its share of ``batch``: the stats of each step, then the
    last step's (clipped) gradients, the parameters and the buffers."""
    model = build_model(cfg, device=dev, train=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    state = create_train_state(cfg, model)
    state.model = wrap_ddp(cfg, model)
    part = local_batch_slice(len(batch["src_inps"]))
    local = {k: v[part] for k, v in batch.items()}
    step = make_train_step(cfg, src_hw)
    stats = []
    for _ in range(steps):
        state, s = step(state, local)
        stats.append({k: float(v) for k, v in s.items()})
    return dict(rank=rank(), stats=stats,
                grads=_numpy((k, p.grad) for k, p in model.named_parameters()
                             if p.grad is not None),
                params=_numpy(model.named_parameters()),
                buffers=_numpy(model.named_buffers()),
                loaded=forbidden_loaded())


def sharded_render(dev, cfg, weights, batch):
    """One frame of ``cfg``'s network from ``weights`` through
    ``make_sharded_render_step``: the outputs every rank holds."""
    model = build_model(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    out = make_sharded_render_step(cfg, model)(batch)
    return dict(out=_numpy(out.items()), loaded=forbidden_loaded())


def seeded_batch(shape, seed, offset=100.0):
    """A normal batch whose channels (dim 1) sit at ``offset`` plus up to
    1, the case where Σx² − (Σx)²/n cancels in f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    shift = (offset + rng.rand(shape[1])).astype(np.float32)
    return x + shift.reshape((1, -1) + (1,) * (len(shape) - 2))

"""The train step and the ray-split render; counterpart of
``enerf_tpu/train/step.py`` (``make_train_step``,
``make_sharded_render_step``).

One step: forward in training mode (BN by batch statistics, running
statistics updated in place), loss, backward, gradient clip by value,
optimizer step, scheduler step.

Data parallelism (``wrap_ddp``): one process a GPU, the model's BNs synced
over the ranks (``models/layers.py:convert_sync_bn``) and the model
wrapped in ``DistributedDataParallel``, each rank on its share of the
global batch. The JAX package writes its step on the global batch over a
mesh, so its BN statistics and its gradient are the global batch's; here
the synced BN computes the same statistics, DDP's all-reduce averages the
ranks' gradients before the clip, and the step's stats are the global
batch's.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from enerf_tpu_torch import device_batch, render
from enerf_tpu_torch.config import Config
from enerf_tpu_torch.factory import network_class
from enerf_tpu_torch.models.enerf import RAY_OUTPUTS, ENeRF
from enerf_tpu_torch.models.enerf_composite import ENeRFComposite
from enerf_tpu_torch.models.layers import convert_sync_bn
from enerf_tpu_torch.parallel.dist import all_reduce_sum, rank, world_size
from enerf_tpu_torch.train.loss import compute_loss, mse2psnr
from enerf_tpu_torch.train.state import TrainState
from enerf_tpu_torch.train.vgg import VGG16Blocks
from enerf_tpu_torch.utils.profiling import span

PhaseHook = Optional[Callable[[str], None]]


def make_train_step(cfg: Config, src_hw: Tuple[int, int],
                    vgg_params: Optional[VGG16Blocks] = None) -> Callable:
    """Returns ``step(state, batch, phase_hook=None) -> (state, stats)``.

    ``batch`` is a dict of numpy arrays or tensors (moved to the model's
    device); ``stats`` holds detached scalar tensors (``loss``,
    ``color_mse_i``, ``psnr_i``, ``perceptual_loss_i``); reading them
    waits for the device. The step runs in the span ``train.step``, each
    phase in its own (``utils/profiling.span``: ``train.forward``, loss
    included, ``train.backward``, ``train.optimizer``); ``phase_hook(name)``,
    when given, is called as each closes, right after the ``forward``,
    ``backward`` or ``optimizer`` phase is enqueued.

    With ``state.model`` wrapped by ``wrap_ddp``, ``batch`` is this rank's
    share of the global batch; the gradient is clipped after DDP's
    all-reduce (the global batch's, as the JAX step clips it), and the
    stats are the global batch's: their mean over the ranks, and each
    ``psnr_i`` that of the mean ``color_mse_i``."""
    clip = cfg.train.grad_clip_value

    def step(state: TrainState, batch, phase_hook: PhaseHook = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step"):
            model = state.model
            with _phase("forward", phase_hook):
                batch = device_batch(batch, next(model.parameters()).device)
                model.train()
                output = model(batch)
                loss, stats = compute_loss(output, batch, cfg.enerf, src_hw,
                                           vgg_params)
            with _phase("backward", phase_hook):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with _phase("optimizer", phase_hook):
                torch.nn.utils.clip_grad_value_(model.parameters(), clip)
                state.optimizer.step()
                state.scheduler.step()
            stats = {k: v.detach() for k, v in stats.items()}
            if isinstance(model, nn.parallel.DistributedDataParallel):
                stats = _global_stats(stats)
            return state, stats

    return step


def _phase(name: str, hook: PhaseHook) -> span:
    """The span ``train.<name>`` of a step's phase; it calls ``hook(name)``
    as it closes."""
    return span("train." + name, hook and (lambda _: hook(name)))


def _global_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' stats as the global batch's, by one all-reduce."""
    keys = sorted(stats)
    mean = all_reduce_sum(torch.stack([stats[k] for k in keys])) / world_size()
    out = dict(zip(keys, mean.unbind()))
    for k in keys:
        if k.startswith("psnr_"):
            out[k] = mse2psnr(out["color_mse_" + k[len("psnr_"):]])
    return out


def has_unused_parameters(cfg: Config) -> bool:
    """Whether a train step of ``cfg``'s network leaves parameters without
    a gradient, which ``DistributedDataParallel`` must be told of (it
    raises at the next step otherwise). A level that does not render
    (``render_if`` False) leaves its NeRF head and its cost net's
    ``feat_conv`` out of the loss; the composite's heads read no volume
    feature, so no ``feat_conv`` of it gets one. ``train_img`` changes
    neither: grid and gathered rays reach the same parameters."""
    cas = cfg.enerf.cas_config
    return (not all(cas.render_if[:cas.num])
            or issubclass(network_class(cfg), ENeRFComposite))


def wrap_ddp(cfg: Config, model: nn.Module
             ) -> nn.parallel.DistributedDataParallel:
    """``model`` (on this rank's device, its weights and any resumed state
    already loaded) with its BNs synced over the ranks, in
    ``DistributedDataParallel``: its parameters and buffers are rank 0's
    from here on (DDP broadcasts them at the wrap and the buffers again at
    each forward), its gradients the ranks' mean."""
    dev = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        convert_sync_bn(model),
        device_ids=[dev] if dev.type == "cuda" else None,
        find_unused_parameters=has_unused_parameters(cfg))


def make_sharded_render_step(cfg: Config, model: nn.Module) -> Callable:
    """``step(batch, stage_hook=None) -> outputs``: one frame rendered by
    every rank of the process group, each shading a contiguous 1/world of
    the rays of every rendered level (the JAX package's ray-sharded render
    over a mesh). The feature, volume and depth stages run on every rank;
    each rank writes its rays' outputs into zero-filled full buffers
    (``ray_slice`` of the model's forward), and one ``all_reduce`` (sum)
    gives every rank the whole frame: exact, since every other rank adds
    zeros. A ray count not divisible by the world size raises.

    ``model`` (``ENeRF`` or ``ENeRFHuman``) is put in eval mode: the K1,
    K2 and K4 kernels run on a card. In a world of 1 the step is
    ``render``."""
    if not isinstance(model, ENeRF):
        raise ValueError(f"the ray-split render takes ENeRF or ENeRFHuman, "
                         f"not {type(model).__name__}")
    cas = cfg.enerf.cas_config
    keys = [f"{k}_level{i}" for i in range(cas.num) if cas.render_if[i]
            for k in RAY_OUTPUTS]
    model.eval()

    def step(batch: Mapping, stage_hook=None) -> Dict[str, torch.Tensor]:
        world = world_size()
        if world == 1:
            return render(model, batch, stage_hook=stage_hook)
        out = render(model, batch, stage_hook=stage_hook,
                     ray_slice=(rank(), world))
        with torch.inference_mode():
            flat = all_reduce_sum(torch.cat([out[k].reshape(-1)
                                             for k in keys]))
            parts = flat.split([out[k].numel() for k in keys])
            out.update({k: p.view_as(out[k]) for k, p in zip(keys, parts)})
        return out

    return step

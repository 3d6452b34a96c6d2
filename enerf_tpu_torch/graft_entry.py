"""Entry points of the port: the flagship forward on the card,
and a multi-rank dry run of the data-parallel path on the CPU; the port's
counterpart of the repo's ``__graft_entry__.py``::

    python -m enerf_tpu_torch.graft_entry             # the forward, on the GPU
    python -m enerf_tpu_torch.graft_entry dryrun 2    # 2 gloo ranks on the CPU

The dry run mirrors ``__graft_entry__.py:dryrun_multichip`` with one process
a rank in place of a device mesh. Two of its parts have no counterpart
here: the remat'd ``train_render_chunk`` tiling (the port's config drops
the key: the 512x640 step fits the card's memory without it), and the BN
refresh step (torch updates the running statistics inside the train
step; the JAX package refreshes them apart only because of an XLA
lowering).
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile

import numpy as np
import torch

from enerf_tpu_torch import build_model, device_batch, render
from enerf_tpu_torch.config import (
    CascadeConfig,
    Config,
    ENeRFConfig,
    TrainConfig,
)
from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
from enerf_tpu_torch.parallel.dist import (
    barrier,
    local_batch_slice,
    rank,
    spawn_ranks,
    unwrap,
)
from enerf_tpu_torch.train import (
    create_train_state,
    load_model,
    make_train_step,
    save_model,
)
from enerf_tpu_torch.train.step import make_sharded_render_step, wrap_ddp

DRY_HW = (64, 96)


def _eval_cfg() -> Config:
    """The DTU evaluation config of ``__graft_entry__.py:_eval_cfg``:
    volume_planes (48, 8), render_if (False, True)."""
    return Config(enerf=ENeRFConfig(
        test_input_views=3, train_input_views=(2, 3),
        cas_config=CascadeConfig(num=2, volume_planes=(48, 8),
                                 render_if=(False, True))))


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` renders one 256x320 frame of the
    flagship cascade (seeded random weights, synthetic scene) with
    ``render``, on the GPU unless ``device`` says otherwise."""
    cfg = _eval_cfg()
    model = build_model(cfg, device=device, seed=0)
    batch = make_synthetic_batch(cfg, H=256, W=320, batch_size=1)
    batch.pop("tar_img")
    return render, (model, device_batch(batch, next(model.parameters()).device))


def _dry_cfg() -> Config:
    """``__graft_entry__.py``'s dry-run cascade (its tile size dropped)."""
    return Config(
        enerf=ENeRFConfig(
            test_input_views=2, train_input_views=(2,),
            cas_config=CascadeConfig(num=2, volume_planes=(16, 8),
                                     render_if=(False, True),
                                     num_rays=(1024, 2048))),
        train=TrainConfig(lr=1e-3))


def _human_cfg(cfg: Config) -> Config:
    return dataclasses.replace(
        cfg, network_module="enerf_tpu.models.enerf_human",
        enerf=dataclasses.replace(cfg.enerf, grid_rays=True,
                                  mask_window_hw=(32, 48)))


def _ddp_state(cfg: Config, dev, weights=None):
    model = build_model(cfg, device=dev, seed=0, train=True)
    if weights is not None:
        model.load_state_dict(weights)
    state = create_train_state(cfg, model)
    state.model = wrap_ddp(cfg, model)
    return state


def _dryrun_rank(dev, world: int, ckpt_dir: str) -> dict:
    """One rank of ``dryrun_multichip``; what the parent checks across
    the ranks."""
    cfg = _dry_cfg()
    H, W = DRY_HW
    batch = make_synthetic_batch(cfg, H=H, W=W, batch_size=world,
                                 split="train")
    batch.pop("tar_img")
    local = {k: v[local_batch_slice(world)] for k, v in batch.items()}
    step = make_train_step(cfg, (H, W))

    state = _ddp_state(cfg, dev)
    losses = []
    for _ in range(3):
        state, stats = step(state, local)
        losses.append(float(stats["loss"]))
    module = unwrap(state.model)
    running = np.concatenate([b.detach().numpy().ravel()
                              for k, b in module.named_buffers()
                              if k.endswith(("running_mean", "running_var"))])

    # checkpoint round trip: rank 0 writes, every rank resumes before the
    # wrap and takes one more step
    if rank() == 0:
        save_model(ckpt_dir, state, epoch=0)
    barrier()
    fresh = create_train_state(cfg, build_model(cfg, device=dev, seed=1,
                                                train=True))
    next_epoch = load_model(ckpt_dir, fresh)
    restored_equal = all(
        torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                          module.state_dict().values()))
    fresh.model = wrap_ddp(cfg, fresh.model)
    _, stats = step(fresh, local)
    resumed_loss = float(stats["loss"])

    # the ray-split render of one frame
    eval_batch = make_synthetic_batch(cfg, H=H, W=W, batch_size=1)
    eval_batch.pop("tar_img")
    rout = make_sharded_render_step(cfg, module)(eval_batch)
    render_finite = all(bool(torch.isfinite(v).all()) for v in rout.values())

    # the human variant: the window render of a masked frame, split over
    # the ranks, and one DDP step
    hcfg = _human_cfg(cfg)
    mask = np.zeros((H, W), np.float32)
    mask[16:48, 32:64] = 1.0     # a 16-aligned box inside the (32, 48) window
    hmodel = build_model(hcfg, device=dev)
    hmodel.load_state_dict(module.state_dict())
    hout = make_sharded_render_step(hcfg, hmodel)(
        dict(eval_batch, mask_at_box=mask.reshape(1, -1)))
    hrgb = hout["rgb_level1"][0].numpy()
    hstate = _ddp_state(hcfg, dev, module.state_dict())
    _, hstats = make_train_step(hcfg, (H, W))(hstate, local)
    return dict(losses=losses, running=running, next_epoch=next_epoch,
                restored_equal=restored_equal, resumed_loss=resumed_loss,
                render_finite=render_finite,
                human_finite=bool(np.all(np.isfinite(hrgb))),
                human_outside=float(np.abs(hrgb[mask.reshape(-1) == 0]).max()),
                human_loss=float(hstats["loss"]))


def dryrun_multichip(n: int) -> str:
    """``n`` gloo ranks on the CPU (one torch thread each) through the
    data-parallel path at 64x96: 3 DDP steps with a falling loss, BN
    running statistics finite and equal on every rank, a checkpoint saved
    by rank 0 and restored on every rank with one more step, the ray-split
    render of a frame (finite), and the human variant's window render
    (nothing outside the mask) and one DDP step. Raises on any failure;
    returns the OK line it prints."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ranks = spawn_ranks(_dryrun_rank, n, (n, ckpt_dir))
    first = ranks[0]
    losses = first["losses"]
    checks = {
        "finite losses": all(np.isfinite(r["losses"]).all() for r in ranks),
        "falling loss": losses[-1] < losses[0],
        "the same loss on every rank": all(r["losses"] == losses
                                           for r in ranks),
        "finite running statistics": bool(np.isfinite(first["running"]).all()),
        "equal running statistics": all(
            np.array_equal(r["running"], first["running"]) for r in ranks),
        "restored checkpoint": all(r["next_epoch"] == 1 and r["restored_equal"]
                                   for r in ranks),
        "a step after the restore": all(np.isfinite(r["resumed_loss"])
                                        for r in ranks),
        "finite ray-split render": all(r["render_finite"] for r in ranks),
        "human window render": all(r["human_finite"]
                                   and r["human_outside"] == 0.0
                                   for r in ranks),
        "human DDP step": all(np.isfinite(r["human_loss"]) for r in ranks),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n}) failed: {failed}; "
                           f"losses {[r['losses'] for r in ranks]}")
    line = (f"dryrun_multichip({n}): OK, "
            f"losses={['%.4f' % v for v in losses]}, "
            "ckpt_roundtrip OK, ray-split render OK, "
            "human window render+train step OK")
    print(line)
    return line


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "dryrun":
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 2)
        return
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK:", {k: tuple(v.shape) for k, v in out.items()})


if __name__ == "__main__":
    # the ranks unpickle their function from this module under its own
    # name, not as __main__
    from enerf_tpu_torch import graft_entry

    graft_entry.main()

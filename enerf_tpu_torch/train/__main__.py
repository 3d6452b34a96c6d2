"""The port's training CLI; counterpart of the repo's ``train.py``
(reference train_net.py:19-117)::

    python -m enerf_tpu_torch.train --cfg_file configs/enerf/dtu_pretrain.yaml [key value ...]
    python -m enerf_tpu_torch.train --test --cfg_file ...    # evaluate instead
    python -m torch.distributed.run --nproc_per_node N \
        -m enerf_tpu_torch.train --distributed --cfg_file ...

It trains on the card unless ``--device cpu`` is given. In order: the
train loader (``cfg.ep_iter`` batches an epoch), the network
``cfg.network_module`` names, a warm start from ``cfg.pretrain``, the
train state and a resume from ``cfg.trained_model_dir``, the command line
and resolved config saved beside the checkpoints, VGG16 for the
perceptual loss (a notice when its weights are missing), the train step
and ``Trainer``; then the epoch loop, saving a checkpoint every
``save_ep`` (else every ``save_latest_ep``) epochs and validating every
``eval_ep`` epochs with ``Trainer.val`` and the evaluator the config
names. ``--test`` runs ``enerf_tpu_torch.run.run_evaluate``;
``debug_nans`` turns on ``torch.autograd.set_detect_anomaly``.

``--distributed``: one process a GPU under ``torch.distributed.run``
(NCCL; gloo with ``--device cpu``), each rank on ``cuda:{LOCAL_RANK}``
and on its shard of the train set, the model's BNs synced and the model
in ``DistributedDataParallel`` (``train/step.py:wrap_ddp``). Every rank
loads the pretrained weights and the resume before the wrap; rank 0 alone
prints, writes the config, the checkpoints and the record, and validates,
while the others wait. Without the launcher's environment it exits 2.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from enerf_tpu_torch import build_model, resolve_device
from enerf_tpu_torch.config import Config, make_cfg
from enerf_tpu_torch.datasets.loader import make_data_loader
from enerf_tpu_torch.parallel.dist import (
    LAUNCHER_ENV,
    barrier,
    init_distributed,
    is_main,
    rank,
    world_size,
)
from enerf_tpu_torch.train import (
    Trainer,
    create_train_state,
    load_model,
    load_pretrain,
    load_vgg16_params,
    make_train_step,
    save_model,
    save_trained_config,
)
from enerf_tpu_torch.train.step import wrap_ddp

NO_LAUNCHER = (
    "--distributed needs the environment of torch.distributed.run "
    "({} unset): python -m torch.distributed.run --nproc_per_node N "
    "-m enerf_tpu_torch.train --distributed --cfg_file ...")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m enerf_tpu_torch.train",
        description="Train (or with --test evaluate) a config with the "
                    "PyTorch/CUDA port.")
    parser.add_argument("--cfg_file",
                        default="configs/enerf/dtu_pretrain.yaml")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--distributed", action="store_true",
                        help="data-parallel training, one process a GPU "
                             "under torch.distributed.run")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.distributed:
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            parser.exit(2, f"{parser.prog}: error: "
                        f"{NO_LAUNCHER.format(', '.join(missing))}\n")
        if args.test:
            parser.exit(2, f"{parser.prog}: error: --test evaluates on one "
                        "device; run it without --distributed\n")
    return args


def train(cfg: Config, device=None, argv: Optional[List[str]] = None,
          distributed: bool = False):
    """The training run of ``train.py:train``; returns the final train
    state, the ``Trainer`` and the metrics of each validation (none on a
    rank other than 0). ``distributed``: this process is a rank of the
    process group that ``init_distributed`` joined, ``device`` its
    device."""
    device = resolve_device(device)
    main_rank = is_main()
    say = print if main_rank else (lambda *a, **k: None)
    if cfg.fix_random:
        np.random.seed(0)
    train_loader = make_data_loader(cfg, "train", max_iter=cfg.ep_iter,
                                    process_index=rank(),
                                    process_count=world_size())
    sample = train_loader.dataset[(0, int(cfg.train.input_views_num[0]))]
    src_hw = tuple(sample["src_inps"].shape[1:3])

    seed = 0 if cfg.fix_random else int.from_bytes(os.urandom(4), "little")
    model = build_model(cfg, device=device, seed=seed, train=True)
    if load_pretrain(cfg, model):
        say(f"loaded pretrained weights of {cfg.pretrain}")
    elif cfg.pretrain:
        say(f"NOTICE: no pretrained checkpoint of {cfg.pretrain!r} under "
            f"{os.path.join(cfg.workspace, 'trained_model', cfg.task)}; "
            "training from the seeded random init")
    state = create_train_state(cfg, model)
    trainer = Trainer(cfg, train_step=None)
    begin_epoch = load_model(cfg.trained_model_dir, state,
                             recorder=trainer.recorder, resume=cfg.resume)
    if begin_epoch:
        say(f"resumed at epoch {begin_epoch} from {cfg.trained_model_dir}")
    if distributed:
        state.model = wrap_ddp(cfg, model)
    if main_rank:
        save_trained_config(cfg, argv)

    vgg = load_vgg16_params(device=device)
    if vgg is None and any(cfg.enerf.cas_config.train_img):
        say("WARNING: vgg16 weights missing (data/vgg16_features.npz) — "
            "perceptual loss disabled, training with MSE only")
    trainer.train_step = make_train_step(cfg, src_hw, vgg_params=vgg)
    vals = []

    for epoch in range(begin_epoch, cfg.train.epoch):
        train_loader.sampler.set_epoch(epoch)
        state = trainer.train_epoch(epoch, state, train_loader)
        if (epoch + 1) % cfg.save_ep == 0 or \
                (epoch + 1) % cfg.save_latest_ep == 0:
            if main_rank:
                save_model(cfg.trained_model_dir, state, epoch,
                           recorder=trainer.recorder)
            barrier()
        if (epoch + 1) % cfg.eval_ep == 0:
            if main_rank:
                from enerf_tpu_torch.factory import make_evaluator

                vals.append(trainer.val(epoch, state,
                                        make_data_loader(cfg, "test"),
                                        make_evaluator(cfg, device=device)))
            barrier()
    return state, trainer, vals


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (default: the command line) and train, or evaluate
    with ``--test``; returns what ``train`` (or ``run_evaluate``)
    returns."""
    args = parse_args(argv)
    cfg = make_cfg(args.cfg_file, args.opts)
    torch.autograd.set_detect_anomaly(cfg.debug_nans)
    if args.test:
        from enerf_tpu_torch.run import run_evaluate

        return run_evaluate(cfg, args.device)
    cmd = [sys.argv[0] if argv is None else "python -m enerf_tpu_torch.train",
           *(sys.argv[1:] if argv is None else argv)]
    if not args.distributed:
        return train(cfg, args.device, cmd)
    device = init_distributed(args.device)
    try:
        return train(cfg, device, cmd, distributed=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

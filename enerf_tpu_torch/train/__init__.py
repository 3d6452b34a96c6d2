"""Training of the port's ENeRF on one GPU, or data-parallel on several
(``step.wrap_ddp``); counterpart of ``enerf_tpu/train``."""

from enerf_tpu_torch.train.checkpoint import (
    load_model,
    load_network,
    load_pretrain,
    save_model,
    save_trained_config,
)
from enerf_tpu_torch.train.loss import compute_loss
from enerf_tpu_torch.train.recorder import Recorder
from enerf_tpu_torch.train.state import TrainState, create_train_state
from enerf_tpu_torch.train.step import make_train_step
from enerf_tpu_torch.train.trainer import Trainer
from enerf_tpu_torch.train.vgg import load_vgg16_params

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "compute_loss", "Trainer", "Recorder", "load_vgg16_params",
           "save_model", "load_model", "load_network", "load_pretrain",
           "save_trained_config"]

"""Training: schedule samplers, the train state and step, BertAdam,
checkpoints, the loop and its tasks (counterpart of ``mm_diffusion_tpu/train``)."""

from .checkpoint import latest_checkpoint_step, restore_checkpoint, save_checkpoint
from .loop import TrainLoop, parse_ema_rates
from .optimization import SCHEDULES, BertAdam
from .resample import LossSecondMomentResampler, UniformSampler, create_named_schedule_sampler
from .state import (
    AdamW,
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    quartile_metrics,
)
from .tasks import ImageSRTask, MultimodalTask, SingleModalTask

__all__ = [
    "AdamW",
    "BertAdam",
    "ImageSRTask",
    "LossSecondMomentResampler",
    "MultimodalTask",
    "SCHEDULES",
    "SingleModalTask",
    "TrainLoop",
    "TrainState",
    "UniformSampler",
    "create_named_schedule_sampler",
    "create_train_state",
    "latest_checkpoint_step",
    "make_optimizer",
    "make_train_step",
    "parse_ema_rates",
    "quartile_metrics",
    "restore_checkpoint",
    "save_checkpoint",
]

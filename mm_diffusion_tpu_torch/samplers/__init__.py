"""Samplers: DPM-Solver(++), DDIM and ancestral loops, and the zero-shot
conditional loops."""

from .ancestral import (
    conditional_gradient_step,
    conditional_p_sample_loop,
    ddim_reverse_loop,
    ddim_sample_loop,
    p_sample_loop,
    p_sample_loop_diverse,
)
from .dpm import (
    DPMSolver,
    NoiseScheduleFlow,
    NoiseScheduleVP,
    model_input_time,
    noise_schedule_from_diffusion,
    wrap_model,
)

__all__ = [
    "DPMSolver",
    "NoiseScheduleFlow",
    "NoiseScheduleVP",
    "conditional_gradient_step",
    "conditional_p_sample_loop",
    "ddim_reverse_loop",
    "ddim_sample_loop",
    "model_input_time",
    "noise_schedule_from_diffusion",
    "p_sample_loop",
    "p_sample_loop_diverse",
    "wrap_model",
]

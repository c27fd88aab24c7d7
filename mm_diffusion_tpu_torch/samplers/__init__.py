"""Samplers: DPM-Solver(++), DDIM and ancestral loops."""

from .ancestral import ddim_sample_loop, p_sample_loop
from .dpm import DPMSolver, NoiseScheduleVP, model_input_time, noise_schedule_from_diffusion

__all__ = [
    "DPMSolver",
    "NoiseScheduleVP",
    "ddim_sample_loop",
    "model_input_time",
    "noise_schedule_from_diffusion",
    "p_sample_loop",
]

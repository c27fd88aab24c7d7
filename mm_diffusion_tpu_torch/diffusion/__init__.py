"""Diffusion schedules and the Gaussian reverse process."""

from .gaussian import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    tree_map,
    tree_randn_like,
)
from .schedules import ScheduleTables, make_schedule, space_timesteps

__all__ = [
    "GaussianDiffusion",
    "LossType",
    "ModelMeanType",
    "ModelVarType",
    "ScheduleTables",
    "make_schedule",
    "space_timesteps",
    "tree_map",
    "tree_randn_like",
]

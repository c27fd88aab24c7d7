"""Checkpoints of the whole train state (counterpart of
``mm_diffusion_tpu/train/checkpoint.py``).

One ``torch.save`` file per saved step, ``<ckpt_dir>/step_<step>.pt``,
holding the step, the fp32 parameters, the AdamW state, every EMA copy and
the schedule sampler.  The resume contract is the JAX package's: point at a
run directory and the latest step is found.  A file is written under a
temporary name and renamed, so a save cut short never shadows the last
complete one.

On a mesh the file is the same: every rank gathers the whole state from
the shards, rank 0 writes it, and a restore loads each tensor into every
rank's own part, so a checkpoint of one world size resumes in any other.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState) -> int:
    """Save the full train state; returns its step.  On a mesh every rank
    calls it: all gather, rank 0 writes, the others wait for the file."""
    whole = state.state_dict()
    if state.parallel.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = checkpoint_path(ckpt_dir, state.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(whole, tmp)
        os.replace(tmp, path)
    state.parallel.barrier()
    return state.step


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The newest saved step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Load a saved step (the latest by default) into ``state`` in place,
    each tensor onto the device of its counterpart in ``state``."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    saved = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    state.load_state_dict(saved)
    return state

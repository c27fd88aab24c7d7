"""Training tasks: the model-specific pieces the generic TrainLoop delegates
(counterpart of ``mm_diffusion_tpu/train/tasks.py``; the image-SR and
single-modal tasks are not ported yet).
"""

from __future__ import annotations

import copy
import os

import torch

from ..data import media
from ..sampling import build_base_sampler
from ..utils import logger as kvlogger
from .state import ema_params


class MultimodalTask:
    """Joint audio-video training of the coupled MM-UNet."""

    def preview(self, loop, step: int) -> str:
        """Sample ``loop.preview_samples`` clips with the EMA weights and
        write a grid video plus one audio-video pair per clip under
        ``<output_dir>/previews``; returns the grid's path."""
        ema_model = copy.deepcopy(loop.state.model).eval()
        with torch.no_grad():
            params = dict(ema_model.named_parameters())
            for name, x in ema_params(loop.state).items():
                params[name].copy_(x)
        sample = build_base_sampler(
            ema_model, loop.diffusion, sample_fn=loop.sample_fn_name, steps=20,
            shift_generator=loop.shift_generator,
        )
        out = sample(loop.preview_samples, generator=loop.noise_generator)
        vids = out["video"].float().cpu().numpy()
        auds = out["audio"].float().cpu().numpy()
        del ema_model
        base = os.path.join(loop.output_dir, "previews", f"step_{step:06d}")
        grid = media.save_video_grid(vids, base + "_grid.mp4")
        for i in range(vids.shape[0]):
            media.save_multimodal(vids[i], auds[i], f"{base}_{i:02d}")
        kvlogger.log(f"wrote preview samples -> {base}*")
        return grid

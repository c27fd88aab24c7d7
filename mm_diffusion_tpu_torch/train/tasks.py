"""Training tasks: the model-specific pieces the generic TrainLoop delegates
(counterpart of ``mm_diffusion_tpu/train/tasks.py``).

One TrainLoop owns the step, checkpoint and log machinery; a task owns what
varies between models:

* ``adapter(loop)`` -- the train step's ``(model, batch) -> (x_start,
  model_fn)``;
* ``preview(loop, step)`` -- EMA-weight sampling and a media dump at save
  intervals; returns the primary media path (streamed to wandb under
  ``use_db``).  On a mesh every rank calls it to gather the EMA weights;
  rank 0 alone samples (the others return None).  A preview draws from
  generators of its own, keyed by the step, so that the training draws,
  alike on every rank, stay so.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import create_gaussian_diffusion
from ..data import media
from ..parallel.mesh import full_tensor
from ..sampling import build_base_sampler, build_single_sampler, build_sr_sampler
from ..utils import logger as kvlogger
from ..utils.seeds import derive_seed
from .state import ema_params, multimodal_adapter


def ema_model(loop):
    """On rank 0, a plain copy of the loop's model in eval mode holding the
    first EMA rate's weights (gathered from the shards under FSDP: every
    rank calls it); None on the other ranks."""
    whole = {name: full_tensor(x) for name, x in ema_params(loop.state).items()}
    if not loop.is_main:
        return None
    trained = loop.state.model
    with torch.device("meta"):  # no initialisation, no draw from torch's generator
        model = loop.state.parallel.model_class(trained.cfg)
    model.to_empty(device=loop.device)
    with torch.no_grad():
        for name, x in model.named_parameters():
            x.copy_(whole[name])
        for name, x in model.named_buffers():
            x.copy_(trained.get_buffer(name))
    return model.eval()


def preview_generators(loop, step: int):
    """(noise generator on the loop's device, host shift generator) of the
    preview at ``step``, keyed on the run's seed and the step (streams 4
    and 5; the loop's own generators take 0-3)."""
    return (torch.Generator(device=loop.device).manual_seed(derive_seed(loop.seed, step, 4)),
            torch.Generator().manual_seed(derive_seed(loop.seed, step, 5)))


class MultimodalTask:
    """Joint audio-video training of the coupled MM-UNet."""

    def adapter(self, loop):
        return multimodal_adapter(loop.shift_generator)

    def preview(self, loop, step: int) -> str:
        """Sample ``loop.preview_samples`` clips with the EMA weights and
        write a grid video plus one audio-video pair per clip under
        ``<output_dir>/previews``; returns the grid's path."""
        model = ema_model(loop)
        if model is None:
            return None
        noise_gen, shift_gen = preview_generators(loop, step)
        sample = build_base_sampler(
            model, loop.diffusion, sample_fn=loop.sample_fn_name, steps=20,
            shift_generator=shift_gen,
        )
        out = sample(loop.preview_samples, generator=noise_gen)
        vids = out["video"].float().cpu().numpy()
        auds = out["audio"].float().cpu().numpy()
        del model
        base = os.path.join(loop.output_dir, "previews", f"step_{step:06d}")
        grid = media.save_video_grid(vids, base + "_grid.mp4")
        for i in range(vids.shape[0]):
            media.save_multimodal(vids[i], auds[i], f"{base}_{i:02d}")
        kvlogger.log(f"wrote preview samples -> {base}*")
        return grid


class ImageSRTask:
    """64->256 image super-resolution training on batches ``{"high_res":
    [B,H,W,3], "low_res": [B,h,w,3]}``: the SR U-Net denoises ``high_res``
    conditioned on ``low_res``."""

    def __init__(self, preview_steps: int = 25):
        self.preview_steps = preview_steps

    def adapter(self, loop):
        def adapt(model, batch):
            return batch["high_res"], lambda x, t_model: model(x, t_model, batch["low_res"])

        return adapt

    def preview(self, loop, step: int):
        """A bicubic | sample | ground-truth triptych per image of the last
        training batch (at most 4), sampled with the EMA weights by ddim
        over ``preview_steps``; returns the image's path (``.npz`` where no
        image writer is installed)."""
        batch = loop.last_batch
        if batch is None:
            return None
        model = ema_model(loop)
        if model is None:
            return None
        diffusion = create_gaussian_diffusion(
            steps=loop.diffusion.num_timesteps,
            learn_sigma=model.cfg.out_channels == 6,
            timestep_respacing=f"ddim{self.preview_steps}",
        ).to(loop.device)
        sampler = build_sr_sampler(model, diffusion, "ddim", steps=self.preview_steps)
        low, hr = batch["low_res"][:4], batch["high_res"][:4]
        sample = sampler(low, generator=preview_generators(loop, step)[0]).float().cpu().numpy()
        del model
        large = hr.shape[1]
        bic = F.interpolate(low.float().permute(0, 3, 1, 2), size=(large, large), mode="bicubic",
                            align_corners=False).permute(0, 2, 3, 1).cpu().numpy()
        hr = hr.float().cpu().numpy()
        rows = [np.concatenate([bic[i], sample[i], hr[i]], axis=1) for i in range(len(hr))]
        out_path = media.save_image(np.concatenate(rows, axis=0),
                                    os.path.join(loop.output_dir, "previews", f"step_{step:06d}.png"))
        kvlogger.log(f"wrote SR preview -> {out_path}")
        return out_path


class SingleModalTask:
    """Plain video or audio diffusion training on batches ``{"x": [B,
    ...]}`` over a :class:`~..models.single_unet.SingleModalUNet`.
    Previews: a video sample grid, or one wav file per audio sample."""

    def __init__(self, sample_fn: str = "ddim", preview_steps: int = 50):
        self.sample_fn = sample_fn
        self.preview_steps = preview_steps

    def adapter(self, loop):
        def adapt(model, batch):
            return batch["x"], model

        return adapt

    def preview(self, loop, step: int) -> str:
        model = ema_model(loop)
        if model is None:
            return None
        sample = build_single_sampler(model, loop.diffusion, sample_fn=self.sample_fn,
                                      steps=self.preview_steps)
        out = sample(loop.preview_samples, generator=preview_generators(loop, step)[0]).float().cpu().numpy()
        modality = model.cfg.modality
        del model
        base = os.path.join(loop.output_dir, "previews", f"step_{step:06d}")
        if modality == "video":
            grid = media.save_video_grid(out, base + "_grid.mp4")
            kvlogger.log(f"wrote video preview grid -> {grid}")
            return grid
        for i in range(out.shape[0]):
            media.save_audio(out[i], f"{base}_{i:02d}.wav")
        kvlogger.log(f"wrote {out.shape[0]} audio previews -> {base}_*.wav")
        return f"{base}_00.wav"

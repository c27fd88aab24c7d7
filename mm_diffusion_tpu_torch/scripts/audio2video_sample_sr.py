"""Zero-shot audio->video generation, then 64->256 frame super-resolution
(PyTorch port of ``mm_diffusion_tpu/scripts/audio2video_sample_sr.py``,
same flags, plus ``--device``).

Ground-truth (video, audio) pairs come from the dataset; the audio is the
condition and the video is generated by the replacement method
(``--classifier_scale 0``) or the gradient method (``> 0``), which
differentiates every step through the MM-UNet.  With ``--sr_model_path``
(``random`` or a ``.pt`` state_dict) the generated frames are
super-resolved, all frames of a clip sharing one noise image.  Each sample
and its ground truth are written side by side.  The ground truth comes
from ``--data_dir``: ``synthetic`` (the procedural AV dataset) or a folder
of videos with their audio (``data/video.py``; needs OpenCV).  The default
device is ``cuda``; without a CUDA device the script stops unless
``--device cpu`` is given.

    python -m mm_diffusion_tpu_torch.scripts.audio2video_sample_sr \\
        --multimodal_model_path Landscape.pt --sr_model_path Landscape_SR.pt \\
        --classifier_scale 3.0 --use_fp16 True ...
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict

import torch

from .. import configs
from ..configs import add_dict_to_argparser, args_to_dict
from ..data import media
from ..data.video import load_data
from ..parallel.bootstrap import refuse_launcher, resolve_device
from ..sampling import build_conditional_sampler, build_sr_sampler, shared_clip_noise
from ..utils import logger
from ..utils.timing import sync
from .multimodal_sample_sr import load_weights


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        data_dir="synthetic",
        multimodal_model_path="random",
        sr_model_path="",
        output_dir="./a2v_samples",
        batch_size=1,
        sample_num=4,
        classifier_scale=0.0,  # 0: the replacement method; > 0: the gradient method
        seed=42,
        video_fps=10,
        audio_fps=16000,
        sr_sample_fn="ddim",
        sr_sample_steps=25,
        device="cuda",
    )
    defaults.update(configs.model_and_diffusion_defaults())
    defaults.update(configs.image_sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def run_conditional(args, condition_key: str, save_prefix: str) -> Dict[str, Any]:
    """Sample ``args.sample_num`` clips conditioned on the ground truth of
    ``condition_key``; returns the written paths, the last batch's samples
    (numpy) and each batch's timings: the conditional stage's wall seconds
    (``base_s``) with each step's (``step_s``), and the SR stage's
    (``sr_s``), each measured to a device synchronisation."""
    refuse_launcher("the conditional sampler")
    device = resolve_device(args.device)
    logger.configure(args.output_dir)
    log = logger.get_current()

    torch.manual_seed(args.seed)  # seeds the "random" initialisation
    model_kwargs = args_to_dict(args, configs.model_and_diffusion_defaults().keys())
    model, diffusion = configs.create_model_and_diffusion(**model_kwargs)
    cfg = model.cfg
    log.log("loading base model weights...")
    load_weights(model, args.multimodal_model_path)
    model.to(device).eval()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    shift_generator = torch.Generator().manual_seed(args.seed)  # host draws
    sampler = build_conditional_sampler(
        model, diffusion, condition_key, class_scale=args.classifier_scale,
        shift_generator=shift_generator,
    )

    sr = None
    if args.sr_model_path and condition_key == "audio":
        sr_kwargs = args_to_dict(args, configs.image_sr_model_and_diffusion_defaults().keys())
        sr_model, sr_diffusion = configs.image_sr_create_model_and_diffusion(**sr_kwargs)
        if args.sr_sample_fn == "ddim":
            sr_diffusion = configs.create_gaussian_diffusion(
                steps=sr_kwargs["sr_diffusion_steps"],
                learn_sigma=sr_kwargs["sr_learn_sigma"],
                noise_schedule=sr_kwargs["noise_schedule"],
                timestep_respacing=f"ddim{args.sr_sample_steps}",
            )
        log.log("loading SR model weights...")
        load_weights(sr_model, args.sr_model_path)
        sr_model.to(device).eval()
        sr_size = sr_model.cfg.image_size
        sr = build_sr_sampler(sr_model, sr_diffusion, sample_fn=args.sr_sample_fn,
                              steps=args.sr_sample_steps)

    data = load_data(
        data_dir=args.data_dir, batch_size=args.batch_size, video_size=cfg.video_size,
        audio_size=cfg.audio_size, video_fps=args.video_fps, audio_fps=args.audio_fps,
        num_workers=0, shard=0, num_shards=1, seed=args.seed,
    )
    frames = cfg.video_size[0]
    paths, timings, samples = [], [], {}
    idx = 0
    while idx < args.sample_num:
        batch = next(data)
        condition = torch.from_numpy(batch[condition_key]).to(device)
        timing = {"step_s": []}
        t0 = time.perf_counter()
        out = sampler(condition, generator=generator, step_seconds=timing["step_s"])
        sync(device)
        timing["base_s"] = time.perf_counter() - t0
        if sr is not None:
            t1 = time.perf_counter()
            out["sr_video"] = torch.stack([
                sr(clip, x_T=shared_clip_noise(1, frames, sr_size, generator, device), generator=generator)
                for clip in out["video"]
            ])
            sync(device)
            timing["sr_s"] = time.perf_counter() - t1
        timings.append(timing)
        samples = {k: v.float().cpu().numpy() for k, v in out.items()}
        first = idx
        for i in range(condition.shape[0]):
            base = os.path.join(args.output_dir, f"{save_prefix}_{idx:05d}")
            paths.extend(media.save_multimodal(
                samples["video"][i], samples["audio"][i], base,
                fps=args.video_fps, audio_rate=args.audio_fps,
            ))
            paths.extend(media.save_multimodal(
                batch["video"][i], batch["audio"][i], base + "_gt",
                fps=args.video_fps, audio_rate=args.audio_fps,
            ))
            idx += 1
        if "sr_video" in samples:
            for i, clip in enumerate(samples["sr_video"]):
                paths.append(media.save_video(
                    clip, os.path.join(args.output_dir, f"{save_prefix}_{first + i:05d}_sr.mp4"),
                    fps=args.video_fps,
                ))
        log.log(f"{idx}/{args.sample_num} samples written: base {timing['base_s']:.2f} s"
                + (f", SR {timing['sr_s']:.2f} s" if "sr_s" in timing else ""))
    return {"paths": [p for p in paths if p], "samples": samples, "timings": timings}


def main(argv=None) -> Dict[str, Any]:
    return run_conditional(create_argparser().parse_args(argv), condition_key="audio", save_prefix="a2v")


if __name__ == "__main__":
    main()

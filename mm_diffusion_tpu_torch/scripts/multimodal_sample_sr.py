"""Unconditional joint audio-video sampling, then 64->256 frame
super-resolution (PyTorch port of ``mm_diffusion_tpu/scripts/
multimodal_sample_sr.py``, same flags, plus ``--device``).

``--multimodal_model_path`` / ``--sr_model_path`` take ``random`` (seeded
default initialisation) or an original PyTorch ``.pt`` state_dict.

``--save_type npz`` writes one AV batch file instead of per-sample media
(``evaluation/npz_batch.py``: uint8 ``arr_0`` SR video, ``audio``, the fps
and the pre-SR ``video_base``); ``--run_eval --ref_path <dir or .npz>``
then scores the samples with ``evaluation.eval_multimodal`` on the same
device.

On several GPUs: ``torchrun --nproc_per_node N ... --n_sample_data N``.
``--batch_size`` is the global batch, split over the N processes; rank 0
gathers the samples and writes the same files as a one-process run at the
same seed (and alone evaluates them).  The
default device is ``cuda``; without a CUDA device the script stops unless
``--device cpu`` is given.

    python -m mm_diffusion_tpu_torch.scripts.multimodal_sample_sr \\
        --multimodal_model_path Landscape.pt --sr_model_path Landscape_SR.pt ...
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import configs
from ..configs import add_dict_to_argparser, args_to_dict
from ..data import media
from ..evaluation import eval_multimodal
from ..evaluation.npz_batch import save_av_npz_batch
from ..models.mm_unet import MultimodalUNet
from ..parallel import all_gather_rows, process_data_shard, setup_dist
from ..sampling import build_base_sampler, build_sr_sampler, sample_base_and_sr
from ..utils import logger
from ..utils.seeds import derive_seed
from ..weights import load_reference_checkpoint

# The flagship configuration: the model and sampler flags of the reference
# launch script (ssh_scripts/multimodal_sample_sr.sh), batch 1, one clip.
LAUNCH_SCRIPT_ARGS = (
    "--num_channels 128 --num_head_channels 64 --resblock_updown True --use_fp16 True "
    "--cross_attention_resolutions 2,4,8 --cross_attention_windows 1,4,8 "
    "--video_attention_resolutions 2,4,8 --audio_attention_resolutions -1 "
    "--sample_fn dpm_solver --sample_steps 20 "
    "--large_size 256 --small_size 64 --sr_num_channels 192 --sr_attention_resolutions 32,16,8 "
    "--sr_num_head_channels 64 --sr_resblock_updown True --sr_learn_sigma True "
    "--sr_sample_fn ddim --sr_sample_steps 25 --batch_size 1 --sample_num 1"
).split()


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        multimodal_model_path="random",
        sr_model_path="random",
        output_dir="./samples",
        batch_size=1,
        sample_num=4,
        sample_fn="dpm_solver",
        sr_sample_fn="ddim",
        skip_steps=0,
        seed=42,
        save_type="mp4",
        video_fps=10,
        audio_fps=16000,
        classifier_scale=0.0,
        run_eval=False,
        ref_path="",
        sample_steps=20,
        sr_sample_steps=50,
        n_sample_data=1,
        device="cuda",
    )
    defaults.update(configs.model_and_diffusion_defaults())
    defaults.update(configs.image_sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def load_weights(model: torch.nn.Module, path: str) -> None:
    if path != "random":
        load_reference_checkpoint(model, path)


def build_pipeline(args, device: torch.device):
    """The CLI's samplers and generators on ``device``: ``(base, sr,
    generator, step_generator, frames, sr_size)``.  The models' weights
    (``random``: seeded by ``--seed``) and the three generators -- the
    global batch's noise, the samplers' per-step draws (ddpm's) and the
    RS-MMA shifts' host generator -- are alike on every rank."""
    log = logger.get_current()
    torch.manual_seed(args.seed)  # seeds the "random" initialisation
    model_kwargs = args_to_dict(args, configs.model_and_diffusion_defaults().keys())
    cfg = configs.create_model_config(**model_kwargs)
    model = MultimodalUNet(cfg)
    diffusion = configs.create_gaussian_diffusion(
        steps=args.diffusion_steps,
        learn_sigma=args.learn_sigma,
        noise_schedule=args.noise_schedule,
        timestep_respacing=args.timestep_respacing,
    )
    sr_kwargs = args_to_dict(args, configs.image_sr_model_and_diffusion_defaults().keys())
    sr_model, sr_diffusion = configs.image_sr_create_model_and_diffusion(**sr_kwargs)
    if args.sr_sample_fn == "ddim":
        sr_diffusion = configs.create_gaussian_diffusion(
            steps=sr_kwargs["sr_diffusion_steps"],
            learn_sigma=sr_kwargs["sr_learn_sigma"],
            noise_schedule=sr_kwargs["noise_schedule"],
            timestep_respacing=f"ddim{min(args.sr_sample_steps, 250)}",
        )

    log.log("loading base model weights...")
    load_weights(model, args.multimodal_model_path)
    log.log("loading SR model weights...")
    load_weights(sr_model, args.sr_model_path)
    model.to(device).eval()
    sr_model.to(device).eval()

    f = cfg.video_size[0]
    sr_size = sr_model.cfg.image_size
    generator = torch.Generator(device=device).manual_seed(args.seed)  # the global batch's noise
    step_generator = torch.Generator(device=device).manual_seed(derive_seed(args.seed, 1))
    shift_generator = torch.Generator().manual_seed(args.seed)  # host draws, alike on every rank
    base = build_base_sampler(
        model, diffusion, sample_fn=args.sample_fn, steps=args.sample_steps,
        shift_generator=shift_generator,
    )
    sr = build_sr_sampler(
        sr_model, sr_diffusion, sample_fn=args.sr_sample_fn, steps=args.sr_sample_steps
    )
    return base, sr, generator, step_generator, f, sr_size


def main(argv=None) -> Dict[str, Any]:
    """Run the CLI; returns the written paths (rank 0's; none on the other
    ranks), the last batch's samples (numpy; the whole batch, gathered
    on every rank), the stage wall times of each batch, and with
    ``--run_eval`` the metrics (rank 0's)."""
    args = create_argparser().parse_args(argv)
    device = setup_dist(args.device)
    rank, world = process_data_shard()
    if args.n_sample_data != world:
        raise ValueError(
            f"--n_sample_data {args.n_sample_data} needs as many processes, this run has {world}: "
            f"torchrun --nproc_per_node {args.n_sample_data} -m mm_diffusion_tpu_torch.scripts."
            f"multimodal_sample_sr --n_sample_data {args.n_sample_data} ..."
        )
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} must divide over --n_sample_data {world}")
    logger.configure(args.output_dir)
    log = logger.get_current()

    base, sr, generator, step_generator, f, sr_size = build_pipeline(args, device)

    n_batches = (args.sample_num + args.batch_size - 1) // args.batch_size
    paths, timings, out = [], [], {}
    # --save_type npz: the batches are gathered into one batch file
    npz_accum = {"video": [], "audio": [], "base": []} if args.save_type == "npz" else None
    idx = 0
    for b in range(n_batches):
        t = {}
        t0 = time.perf_counter()
        out = sample_base_and_sr(
            base, sr, args.batch_size, sr_size, f, generator=generator, timings=t,
            rank=rank, world=world, step_generator=step_generator,
        )
        if world > 1:
            out = {k: all_gather_rows(v) for k, v in out.items()}
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        t["batch_s"] = time.perf_counter() - t0
        timings.append(t)
        if npz_accum is not None:
            npz_accum["video"].append(out["sr_video"])
            npz_accum["audio"].append(out["audio"])
            npz_accum["base"].append(out["video"])
        elif rank == 0:  # the other ranks' rows are gathered here
            for i in range(args.batch_size):
                base_path = os.path.join(args.output_dir, f"sample_{idx + i:05d}")
                paths.extend(
                    media.save_multimodal(
                        out["sr_video"][i], out["audio"][i], base_path,
                        fps=args.video_fps, audio_rate=args.audio_fps,
                    )
                )
                paths.append(
                    media.save_video(out["video"][i], base_path + "_base64.mp4", fps=args.video_fps)
                )
        idx += args.batch_size
        log.log(f"batch {b + 1}/{n_batches} written ({idx} samples): {t}")

    sample_path, metrics = args.output_dir, None
    if npz_accum is not None and rank == 0:
        sample_path = save_av_npz_batch(
            os.path.join(args.output_dir, f"{args.sample_fn}_samples_{idx}.npz"),
            np.concatenate(npz_accum["video"]),
            np.concatenate(npz_accum["audio"]),
            video_fps=args.video_fps,
            audio_fps=args.audio_fps,
            extra_arrays={"video_base": np.concatenate(npz_accum["base"]).astype(np.float32)},
        )
        paths.append(sample_path)
        log.log(f"npz batch written: {sample_path}")
    if args.run_eval and args.ref_path and rank == 0:
        metrics = eval_multimodal(args.ref_path, sample_path, device=device)
        log.log(f"eval: {metrics}")
    return {"paths": [p for p in paths if p], "samples": out, "timings": timings, "metrics": metrics}


if __name__ == "__main__":
    main()

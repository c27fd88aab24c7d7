"""Train the multimodal (joint audio-video) diffusion model on one GPU, or
on several under ``torchrun`` (PyTorch port of ``mm_diffusion_tpu/
scripts/multimodal_train.py``, same flags, plus ``--device``).

Under ``torchrun --nproc_per_node N`` each process trains on its own card
(DDP; ``--n_fsdp F`` shards the state over F of them with FSDP2, N
divisible by F), ``--batch_size`` is the batch of each process, and rank
0 logs and writes the checkpoints and previews.

``--data_dir synthetic`` trains on the procedural AV dataset, a directory
on its videos with their audio (``data/video.py``; needs OpenCV).
``--use_db True`` streams the logged scalars and previews to wandb when it
is installed.  The default device is ``cuda``; without a CUDA device the
script stops unless ``--device cpu`` is given.  Re-running with the same
``--output_dir`` resumes from its latest checkpoint.

    python -m mm_diffusion_tpu_torch.scripts.multimodal_train \\
        --data_dir synthetic --output_dir /tmp/run --num_channels 128 \\
        --num_head_channels 64 --resblock_updown True --use_fp16 True \\
        --use_checkpoint True --batch_size 4 --lr 1e-4 --max_steps 1000
"""

from __future__ import annotations

import argparse

from .. import configs
from ..configs import add_dict_to_argparser, args_to_dict, create_gaussian_diffusion
from ..data.video import load_data
from ..models.mm_unet import MultimodalUNet
from ..parallel import device_info, make_mesh, process_data_shard, setup_dist
from ..train import TrainLoop
from ..utils import logger


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        data_dir="synthetic",
        schedule_sampler="uniform",
        lr=1e-4,
        seed=42,
        weight_decay=0.0,
        lr_anneal_steps=0,
        batch_size=4,
        num_workers=4,
        save_type="mp4",
        microbatch=-1,
        ema_rate="0.9999",
        log_interval=100,
        devices=None,  # unused: one device per process, chosen by --device and the launcher
        save_interval=10000,
        output_dir="./output",
        resume_checkpoint="",
        use_db=False,
        sample_fn="dpm_solver",
        frame_gap=1,
        video_fps=10,
        audio_fps=16000,
        max_steps=0,
        n_fsdp=1,
        fsdp_min_size=2**18,
        device="cuda",
    )
    defaults.update(configs.model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def main(argv=None) -> TrainLoop:
    """Run the CLI; returns the finished :class:`TrainLoop` (its state and
    its log rows in ``history``)."""
    args = create_argparser().parse_args(argv)
    device = setup_dist(args.device)
    mesh = make_mesh(n_fsdp=args.n_fsdp, device_type=device.type)
    logger.configure(args.output_dir)
    log = logger.get_current()

    log.log("creating model and diffusion...")
    cfg = configs.create_model_config(**args_to_dict(args, configs.model_and_diffusion_defaults()))
    model = MultimodalUNet(cfg)
    diffusion = create_gaussian_diffusion(
        steps=args.diffusion_steps,
        learn_sigma=args.learn_sigma,
        noise_schedule=args.noise_schedule,
        use_kl=args.use_kl,
        predict_xstart=args.predict_xstart,
        rescale_timesteps=args.rescale_timesteps,
        rescale_learned_sigmas=args.rescale_learned_sigmas,
        timestep_respacing=args.timestep_respacing,
    )

    log.log("creating data loader...")
    shard, num_shards = process_data_shard()
    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        video_size=cfg.video_size,
        audio_size=cfg.audio_size,
        video_fps=args.video_fps,
        audio_fps=args.audio_fps,
        num_workers=args.num_workers,
        shard=shard,
        num_shards=num_shards,
        seed=args.seed,
    )
    accum = 1 if args.microbatch <= 0 else max(1, args.batch_size // args.microbatch)
    loop = TrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        output_dir=args.output_dir,
        resume_checkpoint=args.resume_checkpoint or None,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        schedule_sampler=args.schedule_sampler,
        accum_steps=accum,
        seed=args.seed,
        sample_fn=args.sample_fn,
        use_db=args.use_db,
        device=device,
        mesh=mesh,
        fsdp_min_size=args.fsdp_min_size,
    )
    log.log(f"training on {device} ({device_info()})...")
    try:
        loop.run_loop(max_steps=args.max_steps or None)
    finally:
        loop.close()
    return loop


if __name__ == "__main__":
    main()

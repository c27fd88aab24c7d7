"""Train a single-modality (plain video or plain audio) diffusion model on
one GPU, or on several under ``torchrun`` as ``multimodal_train.py`` does
(DDP, or FSDP2 with ``--n_fsdp``; ``--batch_size`` per process) (PyTorch
port of ``mm_diffusion_tpu/scripts/single_modal_train.py``, same flags,
plus ``--device``).

A :class:`~mm_diffusion_tpu_torch.models.single_unet.SingleModalUNet` on the
video or the audio stream of the datasets the multimodal trainer reads
(``--data_dir synthetic`` or a folder of videos with audio), on the same
TrainLoop (``SingleModalTask``: the batch adapter and the video-grid /
wav previews).  As in the JAX package the model computes in bf16 whatever
``--use_fp16`` says.  The default device is ``cuda``; without a CUDA device
the script stops unless ``--device cpu`` is given.  Re-running with the
same ``--output_dir`` resumes from its latest checkpoint.

    python -m mm_diffusion_tpu_torch.scripts.single_modal_train --modality audio \\
        --data_dir synthetic --output_dir /tmp/run --audio_size 1,25600 \\
        --use_checkpoint True --batch_size 4 --lr 1e-4
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterator

import numpy as np

from ..configs import add_dict_to_argparser, args_to_dict, create_gaussian_diffusion
from ..data.video import load_data
from ..models.single_unet import SingleModalUNet, SingleUNetConfig
from ..parallel import device_info, make_mesh, process_data_shard, setup_dist
from ..train import SingleModalTask, TrainLoop
from ..utils import logger


def single_model_defaults():
    """The MM-UNet model flags that apply to one stream, plus ``modality``."""
    return dict(
        modality="video",
        video_size="16,3,64,64",
        audio_size="1,25600",
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        attention_resolutions="2,4,8",
        channel_mult="",
        dropout=0.0,
        class_cond=False,
        use_scale_shift_norm=True,
        resblock_updown=True,
        video_type="2d+1d",
        use_fp16=False,  # accepted for CLI parity; bf16 compute regardless
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
        use_checkpoint=False,
    )


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
        microbatch=-1,
        ema_rate="0.9999",
        log_interval=100,
        save_interval=10000,
        output_dir="./output",
        resume_checkpoint="",
        use_db=False,
        sample_fn="ddim",
        preview_steps=50,
        frame_gap=1,
        video_fps=10,
        audio_fps=16000,
        max_steps=0,
        n_fsdp=1,
        fsdp_min_size=2**18,
        device="cuda",
    )
    defaults.update(single_model_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def create_single_config(dtype: str = "bfloat16", **kw) -> SingleUNetConfig:
    """The model config from the flags of :func:`single_model_defaults`
    (``dtype``: the compute dtype, bf16 as in the JAX package)."""
    video_size = tuple(int(x) for x in str(kw["video_size"]).split(","))
    audio_size = tuple(int(x) for x in str(kw["audio_size"]).split(","))
    if kw["channel_mult"]:
        channel_mult = tuple(int(x) for x in str(kw["channel_mult"]).split(","))
    else:
        channel_mult = (1, 2, 3, 4)
    out_ch = video_size[1] if kw["modality"] == "video" else audio_size[0]
    if kw["learn_sigma"]:
        out_ch *= 2
    if kw["class_cond"]:
        raise NotImplementedError(
            "class_cond single-modal training is dead code in the reference "
            "(train_util.py:414 'y' kwarg); not supported"
        )
    return SingleUNetConfig(
        modality=kw["modality"],
        video_size=video_size,
        audio_size=audio_size,
        model_channels=kw["num_channels"],
        out_channels=out_ch,
        num_res_blocks=kw["num_res_blocks"],
        attention_resolutions=tuple(int(x) for x in str(kw["attention_resolutions"]).split(",")),
        channel_mult=channel_mult,
        dropout=kw["dropout"],
        num_heads=kw["num_heads"],
        use_scale_shift_norm=kw["use_scale_shift_norm"],
        resblock_updown=kw["resblock_updown"],
        video_type=kw["video_type"],
        use_checkpoint=kw["use_checkpoint"],
        dtype=dtype,
    )


def single_stream(data, modality: str) -> Iterator[Dict[str, np.ndarray]]:
    """Adapt the AV loader's ``{"video", "audio"}`` batches to ``{"x": ...}``."""
    key = "video" if modality == "video" else "audio"
    for batch in data:
        yield {"x": batch[key]}


def main(argv=None) -> TrainLoop:
    """Run the CLI; returns the finished :class:`TrainLoop`."""
    args = create_argparser().parse_args(argv)
    device = setup_dist(args.device)
    mesh = make_mesh(n_fsdp=args.n_fsdp, device_type=device.type)
    logger.configure(args.output_dir)
    log = logger.get_current()

    log.log(f"creating single-modal {args.modality} model and diffusion...")
    cfg = create_single_config(**args_to_dict(args, single_model_defaults().keys()))
    model = SingleModalUNet(cfg)
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
    data = single_stream(
        load_data(
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
        ),
        args.modality,
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
        task=SingleModalTask(sample_fn=args.sample_fn, preview_steps=args.preview_steps),
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

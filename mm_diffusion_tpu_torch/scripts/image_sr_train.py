"""Train / finetune the 64->256 image super-resolution U-Net on one GPU, or
data-parallel (DDP) on several under ``torchrun``, ``--batch_size`` per
process (PyTorch port of ``mm_diffusion_tpu/scripts/image_sr_train.py``,
same flags, plus ``--device``).

The SR U-Net denoises the high-resolution image conditioned on the
low-resolution one, on the same TrainLoop as the multimodal trainer
(``ImageSRTask``: the batch adapter and a bicubic | sample | ground-truth
preview).  ``--data_dir synthetic`` generates procedural HR images with
bicubic LR counterparts (no OpenCV needed); an image folder goes through
``data/image.load_sr_data`` (bicubic downsample, noise and JPEG artifacts
under ``--degrade``; needs OpenCV).  ``--resume_checkpoint <file>.pt``
initialises from a guided-diffusion-layout state_dict (the reference's
pretrained upsampler); a directory resumes a run of this CLI, as does
re-running with the same ``--output_dir``.  The default device is
``cuda``; without a CUDA device the script stops unless ``--device cpu``
is given.

    python -m mm_diffusion_tpu_torch.scripts.image_sr_train --data_dir synthetic \\
        --output_dir /tmp/sr --large_size 256 --small_size 64 --sr_num_channels 192 \\
        --sr_attention_resolutions 32,16,8 --sr_num_head_channels 64 \\
        --sr_resblock_updown True --use_fp16 True --use_checkpoint True --batch_size 4
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from .. import configs
from ..configs import add_dict_to_argparser, args_to_dict
from ..parallel import device_info, make_mesh, process_data_shard, setup_dist
from ..train import ImageSRTask, TrainLoop
from ..utils import logger
from ..weights import load_reference_checkpoint


def bicubic_resize(images: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize of ``[B, H, W, C]`` float images to ``size`` square
    (a = -0.75, half-pixel centres, no antialiasing: OpenCV's INTER_CUBIC
    kernel, with the edge pixels repeated at the border)."""
    x = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous().numpy()


def synthetic_sr_data(batch_size: int, large: int, small: int, seed: int = 0,
                      shard: int = 0, num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Procedural (hr, lr) image pairs in [-1,1], channels-last: the JAX
    package's HR images, the LR images by :func:`bicubic_resize`.  Shard
    ``shard`` of ``num_shards`` yields its rows of the one-shard stream's
    batches of ``num_shards * batch_size`` images."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:large, 0:large].astype(np.float32) / large
    while True:
        draws = [(rng.uniform(2, 12), rng.uniform(2, 12), rng.uniform(0, 6.28))
                 for _ in range(batch_size * num_shards)]
        hrs = []
        for f1, f2, ph in draws[shard * batch_size:(shard + 1) * batch_size]:
            img = np.stack(
                [
                    np.sin(f1 * xs * 6.28 + ph + k) * np.cos(f2 * ys * 6.28 + k)
                    for k in range(3)
                ],
                axis=-1,
            ).astype(np.float32)
            hrs.append(img)
        hr = np.stack(hrs)
        yield {"high_res": hr, "low_res": bicubic_resize(hr, small)}


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        data_dir="synthetic",
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,
        batch_size=4,
        ema_rate="0.9999",
        log_interval=100,
        save_interval=10000,
        output_dir="./sr_output",
        resume_checkpoint="",
        use_db=False,
        seed=42,
        max_steps=0,
        degrade=True,  # noise + JPEG LR degradations of an image folder
        device="cuda",
    )
    defaults.update(configs.image_sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def main(argv=None) -> TrainLoop:
    """Run the CLI; returns the finished :class:`TrainLoop`."""
    args = create_argparser().parse_args(argv)
    device = setup_dist(args.device)
    mesh = make_mesh(device_type=device.type)
    logger.configure(args.output_dir)
    log = logger.get_current()

    sr_kwargs = args_to_dict(args, configs.image_sr_model_and_diffusion_defaults().keys())
    model, diffusion = configs.image_sr_create_model_and_diffusion(**sr_kwargs)
    large, small = args.large_size, args.small_size

    shard, num_shards = process_data_shard()
    if args.data_dir == "synthetic":
        data = synthetic_sr_data(args.batch_size, large, small, args.seed, shard, num_shards)
    else:
        from ..data.image import load_sr_data

        data = load_sr_data(
            data_dir=args.data_dir, batch_size=args.batch_size, large_size=large,
            small_size=small, degrade=args.degrade, shard=shard, num_shards=num_shards,
            seed=args.seed,
        )

    resume_checkpoint = args.resume_checkpoint or None
    if args.resume_checkpoint.endswith((".pt", ".pth", ".ckpt")):
        # the reference's pretrained-model flow: start from a guided-diffusion
        # upsampler's state_dict, not from a checkpoint of this CLI
        load_reference_checkpoint(model, args.resume_checkpoint)
        resume_checkpoint = None
        log.log(f"initialized from torch checkpoint {args.resume_checkpoint}")

    loop = TrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        output_dir=args.output_dir,
        resume_checkpoint=resume_checkpoint,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        seed=args.seed,
        task=ImageSRTask(),
        use_db=args.use_db,
        device=device,
        mesh=mesh,
    )
    log.log(f"training on {device} ({device_info()})...")
    try:
        loop.run_loop(max_steps=args.max_steps or None)
    finally:
        loop.close()
    return loop


if __name__ == "__main__":
    main()

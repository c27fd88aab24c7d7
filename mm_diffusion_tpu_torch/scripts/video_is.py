"""C3D video Inception Score, the TGAN protocol (PyTorch port of
``mm_diffusion_tpu/scripts/video_is.py``, same arguments, plus
``--device``).

Given the published chainer-format weights (``conv3d_deepnetA_ucf.npz``)
and clip mean (``mean2.npz``) -- plain numpy files, no chainer -- the
UCF-101 C3D posterior IS of an ``.npz`` sample batch (``arr_0`` uint8
``[N, F, H, W, 3]``, or float in [-1, 1]: the ``--save_type npz`` export).
Prints one JSON line.

    python -m mm_diffusion_tpu_torch.scripts.video_is samples.npz \\
        --c3d_npz conv3d_deepnetA_ucf.npz --mean mean2.npz
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..evaluation.c3d import video_inception_score_c3d
from ..evaluation.npz_batch import _to_uint8_video
from ..parallel.bootstrap import resolve_device
from ..utils import logger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("sample_batch", help=".npz batch (arr_0 = [N,F,H,W,3])")
    parser.add_argument("--c3d_npz", type=str, required=True,
                        help="conv3d_deepnetA_ucf.npz (chainer-format numpy)")
    parser.add_argument("--mean", type=str, required=True, help="mean2.npz clip mean")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--sample_num", type=int, default=0,
                        help="cap clips (0 = all; reference default 100)")
    parser.add_argument("--output_dir", type=str, default="./video_is_out")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    logger.configure(args.output_dir)
    with np.load(args.sample_batch) as z:
        key = "arr_0" if "arr_0" in z else list(z.keys())[0]
        videos = z[key]
    if videos.ndim != 5 or videos.shape[-1] != 3:
        raise ValueError(f"expected [N,F,H,W,3] videos, got {videos.shape}")
    videos = _to_uint8_video(videos)
    if args.sample_num:
        videos = videos[: args.sample_num]

    score = video_inception_score_c3d(
        videos, args.c3d_npz, args.mean, batch_size=args.batch_size, device=device
    )
    result = {"video_is": score, "protocol": "c3d_ucf101", "clips": int(len(videos))}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

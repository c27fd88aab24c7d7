"""FVD / KVD / FAD between two sample sets (PyTorch port of
``mm_diffusion_tpu/scripts/eval.py``, same flags, plus ``--device``).

``--ref_dir`` and ``--fake_dir`` take a sample directory or an ``.npz``
batch file; the networks run on ``--device`` (default ``cuda``; without a
CUDA device the script stops unless ``--device cpu`` is given).  Prints the
metrics as one JSON line.

    python -m mm_diffusion_tpu_torch.scripts.eval --ref_dir real.npz \\
        --fake_dir samples.npz --i3d_checkpoint i3d_pretrained_400.pt \\
        --audioclip_checkpoint AudioCLIP-Full-Training.pt --compute_is
"""

from __future__ import annotations

import argparse
import json

from ..evaluation import eval_multimodal
from ..parallel.bootstrap import resolve_device
from ..utils import logger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_dir", type=str, required=True)
    parser.add_argument("--fake_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./eval_out")
    parser.add_argument("--sample_num", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--i3d_checkpoint", type=str, default="")
    parser.add_argument("--audioclip_checkpoint", type=str, default="")
    parser.add_argument("--compute_is", action="store_true")
    parser.add_argument(
        "--allow_fallback",
        action="store_true",
        help="permit pixel/log-mel fallback embedders (relative numbers only; "
        "NOT the published FVD/KVD/FAD protocol)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    logger.configure(args.output_dir)
    metrics = eval_multimodal(
        args.ref_dir,
        args.fake_dir,
        eval_num=args.sample_num,
        i3d_checkpoint=args.i3d_checkpoint or None,
        audioclip_checkpoint=args.audioclip_checkpoint or None,
        batch_size=args.batch_size,
        compute_is=args.compute_is,
        allow_fallback=args.allow_fallback,
        device=device,
    )
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()

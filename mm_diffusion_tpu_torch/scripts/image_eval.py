"""Image-set evaluation: IS / FID / sFID / KID / precision-recall (PyTorch
port of ``mm_diffusion_tpu/scripts/image_eval.py``, same arguments, plus
``--device``).

The positional batches are ``.npz`` files or image directories (a directory
needs Pillow).  ``--inception_pb classify_image_graph_def.pb`` runs the
exact legacy protocol (the frozen TF1 InceptionV3 graph executed with torch
ops); ``--clip_checkpoint`` gives CLIP-visual FID / KID instead.  Prints the
metrics as one JSON line.

    python -m mm_diffusion_tpu_torch.scripts.image_eval ref.npz samples.npz \\
        --inception_pb classify_image_graph_def.pb
"""

from __future__ import annotations

import argparse
import json

from ..evaluation.image_eval import eval_images
from ..parallel.bootstrap import resolve_device
from ..utils import logger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("ref_batch", help=".npz batch or image directory (reference set)")
    parser.add_argument("sample_batch", help=".npz batch or image directory (sample set)")
    parser.add_argument("--output_dir", type=str, default="./image_eval_out")
    parser.add_argument("--clip_checkpoint", type=str, default="",
                        help="AudioCLIP-Full or OpenAI CLIP RN50 .pt (visual tower)")
    parser.add_argument("--inception_pb", type=str, default="",
                        help="classify_image_graph_def.pb: run the EXACT "
                        "legacy protocol (Inception-IS, Inception-FID, sFID) "
                        "by executing the frozen TF1 graph with torch ops")
    parser.add_argument("--sample_num", type=int, default=0,
                        help="cap images per side (0 = all)")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument(
        "--allow_fallback",
        action="store_true",
        help="permit pixel-statistics embeddings when no CLIP checkpoint is "
        "given (relative numbers only; NOT a perceptual metric space)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    logger.configure(args.output_dir)
    metrics = eval_images(
        args.ref_batch,
        args.sample_batch,
        clip_checkpoint=args.clip_checkpoint or None,
        eval_num=args.sample_num or None,
        batch_size=args.batch_size,
        allow_fallback=args.allow_fallback,
        inception_pb=args.inception_pb or None,
        device=device,
    )
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()

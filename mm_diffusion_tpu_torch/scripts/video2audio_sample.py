"""Zero-shot video->audio generation (PyTorch port of
``mm_diffusion_tpu/scripts/video2audio_sample.py``, the flags of
``audio2video_sample_sr.py``, plus ``--device``): the ground-truth video
is the condition, the audio is generated by the replacement (or gradient)
conditional loop; there is no SR stage.

    python -m mm_diffusion_tpu_torch.scripts.video2audio_sample \\
        --multimodal_model_path Landscape.pt --use_fp16 True ...
"""

from __future__ import annotations

from typing import Any, Dict

from .audio2video_sample_sr import create_argparser, run_conditional


def main(argv=None) -> Dict[str, Any]:
    args = create_argparser().parse_args(argv)
    args.sr_model_path = ""  # no SR stage for audio generation
    return run_conditional(args, condition_key="video", save_prefix="v2a")


if __name__ == "__main__":
    main()

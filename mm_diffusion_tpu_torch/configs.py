"""Config defaults and factories with the reference CLI's flag names
(counterpart of ``mm_diffusion_tpu/configs.py``, without JAX).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple

from .diffusion import GaussianDiffusion, LossType, ModelMeanType, ModelVarType, make_schedule
from .models.image_unet import ImageSuperResModel, ImageUNetConfig
from .models.mm_unet import MMUNetConfig, MultimodalUNet


def diffusion_defaults() -> Dict[str, Any]:
    return dict(
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def model_defaults() -> Dict[str, Any]:
    return dict(
        video_size="16,3,64,64",
        audio_size="1,25600",
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        num_heads_upsample=-1,
        num_head_channels=-1,
        cross_attention_resolutions="2,4,8",
        cross_attention_windows="1,4,8",
        cross_attention_shift=True,
        video_attention_resolutions="2,4,8",
        audio_attention_resolutions="-1",
        channel_mult="",
        dropout=0.0,
        class_cond=False,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        resblock_updown=False,
        use_fp16=False,
        video_type="2d+1d",
        audio_type="1d",
    )


def model_and_diffusion_defaults() -> Dict[str, Any]:
    return {**model_defaults(), **diffusion_defaults()}


def _ints(s) -> Tuple[int, ...]:
    if isinstance(s, (tuple, list)):
        return tuple(int(v) for v in s)
    return tuple(int(v) for v in str(s).split(","))


def default_channel_mult(image_size: int) -> Tuple[float, ...]:
    table = {
        512: (0.5, 1, 1, 2, 2, 4, 4),
        256: (1, 1, 2, 2, 4, 4),
        128: (1, 1, 2, 3, 4),
        64: (1, 2, 3, 4),
        32: (1, 2, 2, 2),
    }
    if image_size not in table:
        raise ValueError(f"unsupported image size: {image_size}")
    return table[image_size]


def create_model_config(
    video_size="16,3,64,64",
    audio_size="1,25600",
    num_channels=128,
    num_res_blocks=2,
    channel_mult="",
    learn_sigma=False,
    class_cond=False,
    cross_attention_resolutions="2,4,8",
    cross_attention_windows="1,4,8",
    cross_attention_shift=True,
    video_attention_resolutions="2,4,8",
    audio_attention_resolutions="-1",
    num_heads=4,
    num_head_channels=-1,
    use_scale_shift_norm=True,
    dropout=0.0,
    use_fp16=False,
    video_type="2d+1d",
    resblock_updown=True,
    use_checkpoint=False,
    dtype: Optional[str] = None,
    **_unused,
) -> MMUNetConfig:
    """An :class:`MMUNetConfig` from reference-style flags; ``use_fp16``
    selects bf16 compute, ``use_checkpoint`` the ResBlocks' recompute in
    training.  ``num_heads_upsample`` and ``audio_type`` are accepted and
    unused, as in the reference MM model."""
    video_size = _ints(video_size)
    if class_cond:
        raise NotImplementedError(
            "class_cond=True is unwired in the reference MM model (it sets "
            "num_classes=None); refusing rather than silently ignoring the flag"
        )
    channel_mult = (
        default_channel_mult(video_size[-1]) if channel_mult in ("", None) else _ints(channel_mult)
    )
    return MMUNetConfig(
        video_size=video_size,
        audio_size=_ints(audio_size),
        model_channels=num_channels,
        video_out_channels=6 if learn_sigma else 3,
        audio_out_channels=2 if learn_sigma else 1,
        num_res_blocks=num_res_blocks,
        cross_attention_resolutions=_ints(cross_attention_resolutions),
        cross_attention_windows=_ints(cross_attention_windows),
        cross_attention_shift=bool(cross_attention_shift),
        video_attention_resolutions=_ints(video_attention_resolutions),
        audio_attention_resolutions=_ints(audio_attention_resolutions),
        channel_mult=tuple(channel_mult),
        dropout=dropout,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=bool(use_scale_shift_norm),
        resblock_updown=bool(resblock_updown),
        video_type=video_type,
        dtype=dtype or ("bfloat16" if use_fp16 else "float32"),
        use_checkpoint=bool(use_checkpoint),
    )


def create_gaussian_diffusion(
    *,
    steps=1000,
    learn_sigma=False,
    sigma_small=False,
    noise_schedule="linear",
    use_kl=False,
    predict_xstart=False,
    rescale_timesteps=False,
    rescale_learned_sigmas=False,
    timestep_respacing="",
) -> GaussianDiffusion:
    """The diffusion process; ``use_kl`` / ``rescale_learned_sigmas`` choose
    the training loss (RESCALED_KL, RESCALED_MSE, else MSE)."""
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    else:
        var_type = ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE
    return GaussianDiffusion(
        tables=make_schedule(noise_schedule, steps, timestep_respacing or None),
        mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        var_type=var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
    )


def create_model_and_diffusion(**kwargs):
    """``(MultimodalUNet, GaussianDiffusion)`` from reference-style flags,
    each diffusion flag defaulting to :func:`diffusion_defaults`."""
    dd = {**diffusion_defaults(), **kwargs}
    diffusion = create_gaussian_diffusion(
        steps=dd["diffusion_steps"],
        learn_sigma=dd["learn_sigma"],
        noise_schedule=dd["noise_schedule"],
        use_kl=dd["use_kl"],
        predict_xstart=dd["predict_xstart"],
        rescale_timesteps=dd["rescale_timesteps"],
        rescale_learned_sigmas=dd["rescale_learned_sigmas"],
        timestep_respacing=dd["timestep_respacing"],
    )
    return MultimodalUNet(create_model_config(**kwargs)), diffusion


# -- image / SR model ----------------------------------------------------------


def image_sr_model_and_diffusion_defaults() -> Dict[str, Any]:
    return dict(
        sr_num_channels=128,
        sr_num_res_blocks=2,
        sr_num_heads=4,
        sr_num_heads_upsample=-1,
        sr_num_head_channels=-1,
        sr_attention_resolutions="16,8",
        sr_dropout=0.0,
        sr_class_cond=False,
        use_checkpoint=False,
        sr_use_scale_shift_norm=True,
        sr_resblock_updown=False,
        use_fp16=False,
        sr_learn_sigma=True,
        large_size=256,
        small_size=128,
        sr_diffusion_steps=1000,
        sr_timestep_respacing="",
        noise_schedule="linear",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def sr_channel_mult(large_size: int) -> Tuple[int, ...]:
    if large_size in (512, 256):
        return (1, 1, 2, 2, 4, 4)
    if large_size == 64:
        return (1, 2, 3, 4)
    raise ValueError(f"unsupported large size: {large_size}")


def create_image_sr_config(
    large_size=256,
    small_size=128,
    sr_num_channels=128,
    sr_num_res_blocks=2,
    sr_learn_sigma=True,
    sr_class_cond=False,
    use_checkpoint=False,
    sr_attention_resolutions="16,8",
    sr_num_heads=4,
    sr_num_head_channels=-1,
    sr_num_heads_upsample=-1,
    sr_use_scale_shift_norm=True,
    sr_dropout=0.0,
    sr_resblock_updown=False,
    use_fp16=False,
    dtype: Optional[str] = None,
    **_unused,
) -> ImageUNetConfig:
    """The SR U-Net's config; ``in_channels`` counts the low-res concat and
    ``sr_attention_resolutions`` are downsample rates."""
    return ImageUNetConfig(
        image_size=large_size,
        in_channels=6,
        model_channels=sr_num_channels,
        out_channels=6 if sr_learn_sigma else 3,
        num_res_blocks=sr_num_res_blocks,
        attention_resolutions=tuple(
            int(r) for r in str(sr_attention_resolutions).split(",") if r != ""
        ),
        dropout=sr_dropout,
        channel_mult=sr_channel_mult(large_size),
        num_classes=1000 if sr_class_cond else None,
        num_heads=sr_num_heads,
        num_head_channels=sr_num_head_channels,
        num_heads_upsample=sr_num_heads_upsample,
        use_scale_shift_norm=bool(sr_use_scale_shift_norm),
        resblock_updown=bool(sr_resblock_updown),
        use_checkpoint=bool(use_checkpoint),
        dtype=dtype or ("bfloat16" if use_fp16 else "float32"),
    )


def image_sr_create_model_and_diffusion(**kwargs):
    merged = {**image_sr_model_and_diffusion_defaults(), **kwargs}
    diffusion = create_gaussian_diffusion(
        steps=merged["sr_diffusion_steps"],
        learn_sigma=merged["sr_learn_sigma"],
        noise_schedule=merged["noise_schedule"],
        use_kl=merged["use_kl"],
        predict_xstart=merged["predict_xstart"],
        rescale_timesteps=merged["rescale_timesteps"],
        rescale_learned_sigmas=merged["rescale_learned_sigmas"],
        timestep_respacing=merged["sr_timestep_respacing"],
    )
    return ImageSuperResModel(create_image_sr_config(**merged)), diffusion


# -- text-to-image model (Stable Diffusion XL) ----------------------------------


def sdxl_base_flags() -> Dict[str, Any]:
    """Stable Diffusion XL base's U-Net under SGM's flag names
    (``configs/inference/sd_xl_base.yaml``, ``network_config``; 2.57 B
    parameters, 70 transformer blocks), the latent side of a 1024^2 image,
    and bf16 compute in place of the deployment's fp16."""
    return dict(
        adm_in_channels=2816,
        num_classes="sequential",
        in_channels=4,
        out_channels=4,
        model_channels=320,
        attention_resolutions="4,2",
        num_res_blocks=2,
        channel_mult="1,2,4",
        num_head_channels=64,
        use_linear_in_transformer=True,
        transformer_depth="1,2,10",
        context_dim=2048,
        image_size=128,
        use_fp16=True,
    )


def create_text2img_config(
    *,
    in_channels,
    out_channels,
    model_channels,
    attention_resolutions,
    num_res_blocks,
    channel_mult,
    num_head_channels,
    transformer_depth,
    context_dim,
    use_linear_in_transformer,
    adm_in_channels,
    num_classes,
    image_size,
    use_fp16=False,
    dtype: Optional[str] = None,
    **_unused,
) -> ImageUNetConfig:
    """The text-to-image U-Net's config from SGM's ``UNetModel`` flags
    (SDXL base's: :func:`sdxl_base_flags`): ``attention_resolutions`` are
    downsample rates, ``transformer_depth`` one count per level (or one for
    all; the middle block takes the last), ``num_classes="sequential"``
    with ``adm_in_channels`` the vector condition, ``image_size`` the
    latent's side.  ``use_fp16`` selects bf16 compute.  Only the linear
    ``proj_in`` / ``proj_out`` are built (``use_linear_in_transformer``
    true).  SGM's other flags keep the values SDXL gives them (no
    scale-shift norm, resampling by conv, no dropout)."""
    if not use_linear_in_transformer:
        raise NotImplementedError("the spatial transformers' 1x1-conv projections are not built")
    if adm_in_channels is not None and num_classes != "sequential":
        raise ValueError(f"adm_in_channels needs num_classes='sequential', got {num_classes!r}")
    mult = _ints(channel_mult)
    depth = _ints(transformer_depth)
    return ImageUNetConfig(
        image_size=int(image_size),
        in_channels=int(in_channels),
        model_channels=int(model_channels),
        out_channels=int(out_channels),
        num_res_blocks=int(num_res_blocks),
        attention_resolutions=_ints(attention_resolutions),
        channel_mult=mult,
        num_head_channels=int(num_head_channels),
        dtype=dtype or ("bfloat16" if use_fp16 else "float32"),
        context_dim=int(context_dim),
        transformer_depth=depth * len(mult) if len(depth) == 1 else depth,
        adm_in_channels=None if adm_in_channels is None else int(adm_in_channels),
    )


# -- text-to-video model (Wan 2.1) ----------------------------------------------


def wan_t2v_1_3b_flags() -> Dict[str, Any]:
    """Wan2.1-T2V-1.3B under Wan's names (its ``config.json`` and
    ``wan/configs/wan_t2v_1_3B.py``; 1.42 B parameters, 30 blocks), with
    bf16 compute."""
    return dict(dim=1536, eps=1e-6, ffn_dim=8960, freq_dim=256, in_dim=16, model_type="t2v", num_heads=12,
                num_layers=30, out_dim=16, text_len=512, text_dim=4096, patch_size="1,2,2",
                window_size="-1,-1", qk_norm=True, cross_attn_norm=True, dtype="bfloat16")


def create_text2video_config(*, dim, ffn_dim, freq_dim, num_heads, num_layers, in_dim, out_dim, text_len,
                             text_dim, patch_size, eps, model_type="t2v", window_size="-1,-1", qk_norm=True,
                             cross_attn_norm=True, dtype="bfloat16", **_unused):
    """The text-to-video transformer's config from Wan's ``WanModel``
    arguments (:func:`wan_t2v_1_3b_flags`).  Only what T2V-1.3B uses is
    built: full attention (``window_size`` -1, -1), the q / k RMSNorms and
    the cross-attention LayerNorm."""
    from .models.wan import WanConfig

    if model_type != "t2v":
        raise NotImplementedError(f"Wan model_type {model_type!r}: only 't2v' is built")
    if _ints(window_size) != (-1, -1) or not qk_norm or not cross_attn_norm:
        raise NotImplementedError("windowed attention, or Wan without its q / k or cross-attention norms")
    return WanConfig(dim=int(dim), ffn_dim=int(ffn_dim), freq_dim=int(freq_dim), num_heads=int(num_heads),
                     num_layers=int(num_layers), in_dim=int(in_dim), out_dim=int(out_dim), text_len=int(text_len),
                     text_dim=int(text_dim), patch_size=_ints(patch_size), eps=float(eps), dtype=dtype)


# -- argparse helpers ------------------------------------------------------------


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_dict_to_argparser(parser: argparse.ArgumentParser, default_dict: Dict[str, Any]):
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args, keys):
    return {k: getattr(args, k) for k in keys}

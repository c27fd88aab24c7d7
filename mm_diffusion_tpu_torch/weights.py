"""Weights: load the original's ``.pt`` checkpoints, and turn the JAX
package's parameter trees into this port's ``state_dict``.

The port keeps the original PyTorch module tree, so a published checkpoint
loads with ``load_state_dict`` and no converter.  ``state_dict_from_jax``
and ``image_state_dict_from_jax`` are the exact inverses of the JAX package's importers
(``mm_diffusion_tpu/train/torch_import.py``: ``convert_mm_unet_state_dict``
and ``convert_image_unet_state_dict``); :func:`jax_params_from_state_dict`
maps the MM-UNet the other way, and ``single_state_dict_from_jax`` /
``single_jax_params_from_state_dict`` map the single-modal U-Net both ways.
They take and give nested dicts of numpy arrays, so this module needs no
JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .models.image_unet import ImageUNetConfig, _RB, build_image_plan
from .models.mm_unet import CrossAttnSpec, MMUNetConfig, ResBlockSpec, build_plan
from .models.single_unet import SingleBlockSpec, SingleUNetConfig, build_single_plan

Params = Dict[str, Any]


class _Out:
    """Collects a state_dict: numpy in, fp32 torch tensors out."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def __setitem__(self, key, value):
        if key in self.sd:
            raise KeyError(f"duplicate state_dict key {key}")
        self.sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))


# flax kernel layouts -> torch weight layouts (inverses of torch_import's)
def _dense(k):  # [I, O] -> [O, I]
    return np.transpose(k, (1, 0))


def _conv1x1(k, trailing):  # [I, O] -> [O, I, 1...]
    return np.transpose(k, (1, 0)).reshape(k.shape[1], k.shape[0], *([1] * trailing))


def _conv2d(k):  # [kh, kw, I, O] -> [O, I, kh, kw]
    return np.transpose(k, (3, 2, 0, 1))


def _linear(out: _Out, prefix: str, p: Params):
    out[f"{prefix}.weight"] = _dense(p["kernel"])
    out[f"{prefix}.bias"] = p["bias"]


def _norm(out: _Out, prefix: str, p: Params):
    out[f"{prefix}.weight"] = p["GroupNorm_0"]["scale"]
    out[f"{prefix}.bias"] = p["GroupNorm_0"]["bias"]


# -- the MM-UNet: one table of (state_dict key, flax path, layout) ---------------
#
# Each layout is a pair (flax -> torch, torch -> flax) of exact inverses, so
# the table maps a JAX parameter tree -- or a gradient tree of the same
# structure -- onto the port's state_dict and back.
_LAYOUTS = {
    "same": (lambda k: k, lambda w: w),
    "dense": (_dense, lambda w: np.transpose(w, (1, 0))),
    "conv1x1_1d": (lambda k: _conv1x1(k, 1), lambda w: np.transpose(w.reshape(w.shape[:2]))),
    "conv1x1_3d": (lambda k: _conv1x1(k, 3), lambda w: np.transpose(w.reshape(w.shape[:2]))),
    # [k, I, O] <-> [O, I, k]
    "conv1d": (lambda k: np.transpose(k, (2, 1, 0)), lambda w: np.transpose(w, (2, 1, 0))),
    # the 2d+1d video conv's spatial half: [1, kh, kw, I, O] <-> [O, I, kh, kw]
    "spatial": (lambda k: _conv2d(k[0]), lambda w: np.transpose(w, (2, 3, 1, 0))[None]),
    # its temporal half: [k, 1, 1, I, O] <-> [O, I, k]
    "temporal": (
        lambda k: np.transpose(k[:, 0, 0], (2, 1, 0)),
        lambda w: np.transpose(w, (2, 1, 0))[:, None, None],
    ),
    # [kt, kh, kw, I, O] <-> [O, I, kt, kh, kw]
    "conv3d": (
        lambda k: np.transpose(k, (4, 3, 0, 1, 2)),
        lambda w: np.transpose(w, (2, 3, 4, 1, 0)),
    ),
}

Entry = Tuple[str, Tuple[str, ...], str]


def _e_linear(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{prefix}.weight", path + ("kernel",), "dense"), (f"{prefix}.bias", path + ("bias",), "same")]


def _e_norm(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    gn = path + ("GroupNorm_0",)
    return [(f"{prefix}.weight", gn + ("scale",), "same"), (f"{prefix}.bias", gn + ("bias",), "same")]


def _e_conv(key: str, path: Tuple[str, ...], layout: str) -> List[Entry]:
    return [(f"{key}.weight", path + ("kernel",), layout), (f"{key}.bias", path + ("bias",), "same")]


def _e_video_conv(prefix: str, path: Tuple[str, ...], conv_type: str) -> List[Entry]:
    if conv_type == "2d+1d":
        return _e_conv(f"{prefix}.video_conv_spatial", path + ("spatial",), "spatial") + _e_conv(
            f"{prefix}.video_conv_temporal", path + ("temporal",), "temporal"
        )
    return _e_conv(f"{prefix}.video_conv", path + ("conv",), "conv3d")


def _e_audio_conv(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    return _e_conv(f"{prefix}.audio_conv", path + ("conv",), "conv1d")


def _e_token_attention(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    return (
        _e_norm(f"{prefix}.norm.GroupNorm", path + ("norm",))
        + _e_conv(f"{prefix}.qkv", path + ("qkv",), "conv1x1_1d")
        + _e_conv(f"{prefix}.proj_out", path + ("proj_out",), "conv1x1_1d")
    )


def _e_resblock(prefix: str, path: Tuple[str, ...], spec: ResBlockSpec, cfg: MMUNetConfig):
    p = lambda *names: path + names  # noqa: E731
    entries = (
        _e_norm(f"{prefix}.video_in_layers.0.GroupNorm", p("video_norm_in"))
        + _e_video_conv(f"{prefix}.video_in_layers.2", p("video_conv_in"), cfg.video_type)
        + _e_norm(f"{prefix}.audio_in_layers.0.GroupNorm", p("audio_norm_in"))
        + _e_audio_conv(f"{prefix}.audio_in_layers.2", p("audio_conv_in"))
        + _e_linear(f"{prefix}.emb_layers.1", p("emb_proj"))
        + _e_norm(f"{prefix}.video_out_layers.0.GroupNorm", p("video_norm_out"))
        + _e_video_conv(f"{prefix}.video_out_layers.3", p("video_conv_out"), "3d")
        + _e_norm(f"{prefix}.audio_out_layers.0.GroupNorm", p("audio_norm_out"))
        + _e_audio_conv(f"{prefix}.audio_out_layers.3", p("audio_conv_out"))
    )
    if spec.out_ch != spec.in_ch:
        entries += _e_video_conv(f"{prefix}.video_skip_connection", p("video_skip"), "3d")
        entries += _e_audio_conv(f"{prefix}.audio_skip_connection", p("audio_skip"))
    if spec.video_attention:
        entries += _e_token_attention(f"{prefix}.spatial_attention_block", p("video_attn", "spatial"))
        entries += _e_token_attention(f"{prefix}.temporal_attention_block", p("video_attn", "temporal"))
    if spec.audio_attention:
        entries += _e_token_attention(f"{prefix}.audio_attention_block", p("audio_attn"))
    return entries


def _e_cross_attention(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    entries = _e_norm(f"{prefix}.v_norm.GroupNorm", path + ("v_norm",))
    entries += _e_norm(f"{prefix}.a_norm.GroupNorm", path + ("a_norm",))
    for name in ("v_qkv", "a_qkv"):
        entries += _e_conv(f"{prefix}.{name}", path + (name,), "conv1x1_1d")
    entries += _e_conv(f"{prefix}.video_proj_out.video_conv", path + ("video_proj_out",), "conv1x1_3d")
    entries += _e_conv(f"{prefix}.audio_proj_out.audio_conv", path + ("audio_proj_out",), "conv1x1_1d")
    return entries


def mm_unet_entries(cfg: MMUNetConfig) -> List[Entry]:
    """Every MM-UNet parameter as ``(state_dict key, JAX param path,
    layout)``, in the port's ``state_dict`` order."""
    plan = build_plan(cfg)
    entries = _e_linear("time_embed.0", ("time_embed", "Dense_0"))
    entries += _e_linear("time_embed.2", ("time_embed", "Dense_1"))

    def stage(flax_name, blocks, torch_name):
        out: List[Entry] = []
        for i, specs in enumerate(blocks):
            for j, spec in enumerate(specs):
                tp = f"middle_blocks.{j}" if torch_name == "middle_blocks" else f"{torch_name}.{i}.{j}"
                fp = f"{flax_name}_{i}_{j}"
                if spec == "initial":
                    out += _e_video_conv(f"{tp}.video_conv", (fp + "_init", "video_conv"), "2d+1d")
                    out += _e_audio_conv(f"{tp}.audio_conv", (fp + "_init", "audio_conv"))
                elif isinstance(spec, ResBlockSpec):
                    out += _e_resblock(tp, (fp + "_res",), spec, cfg)
                elif isinstance(spec, CrossAttnSpec):
                    out += _e_cross_attention(tp, (fp + "_xattn",))
        return out

    entries += stage("enc", plan.encoder, "input_blocks")
    entries += stage("mid", [plan.middle], "middle_blocks")
    entries += stage("dec", plan.decoder, "output_blocks")
    entries += _e_norm("video_out.0.GroupNorm", ("video_out_norm",))
    entries += _e_video_conv("video_out.2", ("video_out_conv",), "3d")
    entries += _e_norm("audio_out.0.GroupNorm", ("audio_out_norm",))
    entries += _e_audio_conv("audio_out.2", ("audio_out_conv",))
    return entries


def _state_dict_from_entries(params: Params, entries: List[Entry]) -> Dict[str, torch.Tensor]:
    out = _Out()
    for key, path, layout in entries:
        leaf = params
        for name in path:
            leaf = leaf[name]
        out[key] = _LAYOUTS[layout][0](np.asarray(leaf))
    return out.sd


def _params_from_entries(sd: Dict[str, Any], entries: List[Entry]) -> Params:
    params: Params = {}
    for key, path, layout in entries:
        w = sd[key]
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(_LAYOUTS[layout][1](w.astype(np.float32)))
    return params


def state_dict_from_jax(params: Params, cfg: MMUNetConfig) -> Dict[str, torch.Tensor]:
    """The JAX MultimodalUNet's params (numpy leaves) -> this port's
    ``MultimodalUNet`` state_dict (the original's key names).  A gradient
    tree of the JAX params maps the same way onto the port's ``.grad``s."""
    return _state_dict_from_entries(params, mm_unet_entries(cfg))


def jax_params_from_state_dict(sd: Dict[str, Any], cfg: MMUNetConfig) -> Params:
    """The inverse of :func:`state_dict_from_jax`: a port ``state_dict`` (or
    a dict of its parameters' gradients, same keys) -> the JAX
    MultimodalUNet's nested param dict of fp32 numpy arrays."""
    return _params_from_entries(sd, mm_unet_entries(cfg))


# -- the single-modal U-Net: one stream of the MM-UNet's entries ---------------


def _e_single_resblock(prefix: str, path: Tuple[str, ...], spec: SingleBlockSpec,
                       cfg: SingleUNetConfig) -> List[Entry]:
    p = lambda *names: path + names  # noqa: E731
    if cfg.modality == "video":
        conv = lambda key, fp, k: _e_video_conv(key, fp, cfg.video_type if k == 3 else "3d")  # noqa: E731
    else:
        conv = lambda key, fp, k: _e_audio_conv(key, fp)  # noqa: E731
    entries = (
        _e_norm(f"{prefix}.in_layers.0.GroupNorm", p("norm_in"))
        + conv(f"{prefix}.in_layers.2", p("conv_in"), 3)
        + _e_linear(f"{prefix}.emb_layers.1", p("emb_proj"))
        + _e_norm(f"{prefix}.out_layers.0.GroupNorm", p("norm_out"))
        + conv(f"{prefix}.out_layers.3", p("conv_out"), 1)
    )
    if spec.out_ch != spec.in_ch:
        entries += conv(f"{prefix}.skip_connection", p("skip"), 1)
    if spec.attention and cfg.modality == "video":
        entries += _e_token_attention(f"{prefix}.spatial_attention_block", p("attn", "spatial"))
        entries += _e_token_attention(f"{prefix}.temporal_attention_block", p("attn", "temporal"))
    elif spec.attention:
        entries += _e_token_attention(f"{prefix}.attention_block", p("attn"))
    return entries


def single_unet_entries(cfg: SingleUNetConfig) -> List[Entry]:
    """Every SingleModalUNet parameter as ``(state_dict key, JAX param
    path, layout)``."""
    encoder, middle, decoder = build_single_plan(cfg)
    video = cfg.modality == "video"

    def conv3(key, path, conv_type):
        return _e_video_conv(key, path, conv_type) if video else _e_audio_conv(key, path)

    entries = _e_linear("time_embed.0", ("time_embed", "Dense_0"))
    entries += _e_linear("time_embed.2", ("time_embed", "Dense_1"))
    for flax_name, blocks, torch_name in (("enc", encoder, "input_blocks"), ("mid", [middle], "middle_blocks"),
                                          ("dec", decoder, "output_blocks")):
        for i, specs in enumerate(blocks):
            for j, spec in enumerate(specs):
                tp = f"middle_blocks.{j}" if flax_name == "mid" else f"{torch_name}.{i}.{j}"
                fp = f"{flax_name}_{i}_{j}"
                if spec == "initial":
                    entries += conv3(tp, (fp + "_conv",), "2d+1d")
                elif isinstance(spec, SingleBlockSpec):
                    entries += _e_single_resblock(tp, (fp + "_res",), spec, cfg)
    entries += _e_norm("out.0.GroupNorm", ("out_norm",))
    entries += conv3("out.2", ("out_conv",), "3d")
    return entries


def single_state_dict_from_jax(params: Params, cfg: SingleUNetConfig) -> Dict[str, torch.Tensor]:
    """The JAX SingleModalUNet's params (or a gradient tree of them, numpy
    leaves) -> this port's ``SingleModalUNet`` state_dict."""
    return _state_dict_from_entries(params, single_unet_entries(cfg))


def single_jax_params_from_state_dict(sd: Dict[str, Any], cfg: SingleUNetConfig) -> Params:
    """The inverse of :func:`single_state_dict_from_jax`."""
    return _params_from_entries(sd, single_unet_entries(cfg))


def _thirds_to_legacy(w, heads):
    """Thirds-major rows [q(all heads) | k | v] -> the legacy per-head
    order [h0(q k v) | h1(q k v) | ...] (inverse of torch_import's
    ``_legacy_qkv_to_thirds``)."""
    rows = w.shape[0]
    d = rows // (3 * heads)
    w = w.reshape(3, heads, d, *w.shape[1:])
    return np.swapaxes(w, 0, 1).reshape(rows, *w.shape[3:])


def _image_attention(out: _Out, prefix: str, p: Params, heads: int):
    p = p["TokenSelfAttention_0"]
    _norm(out, f"{prefix}.norm", p["norm"])
    w = _thirds_to_legacy(_dense(p["qkv"]["kernel"]), heads)
    out[f"{prefix}.qkv.weight"] = w[..., None]
    out[f"{prefix}.qkv.bias"] = _thirds_to_legacy(np.asarray(p["qkv"]["bias"]), heads)
    out[f"{prefix}.proj_out.weight"] = _conv1x1(p["proj_out"]["kernel"], 1)
    out[f"{prefix}.proj_out.bias"] = p["proj_out"]["bias"]


def _image_resblock(out: _Out, prefix: str, p: Params, spec: _RB):
    _norm(out, f"{prefix}.in_layers.0", p["norm_in"])
    out[f"{prefix}.in_layers.2.weight"] = _conv2d(p["conv_in"]["kernel"])
    out[f"{prefix}.in_layers.2.bias"] = p["conv_in"]["bias"]
    _linear(out, f"{prefix}.emb_layers.1", p["emb_proj"])
    _norm(out, f"{prefix}.out_layers.0", p["norm_out"])
    out[f"{prefix}.out_layers.3.weight"] = _conv2d(p["conv_out"]["kernel"])
    out[f"{prefix}.out_layers.3.bias"] = p["conv_out"]["bias"]
    if spec.out_ch != spec.in_ch:
        out[f"{prefix}.skip_connection.weight"] = _conv2d(p["skip"]["kernel"])
        out[f"{prefix}.skip_connection.bias"] = p["skip"]["bias"]


def _conv(out: _Out, prefix: str, p: Params):
    out[f"{prefix}.weight"] = _conv2d(p["kernel"])
    out[f"{prefix}.bias"] = p["bias"]


def image_state_dict_from_jax(params: Params, cfg: ImageUNetConfig) -> Dict[str, torch.Tensor]:
    """The JAX ImageUNet / ImageSuperResModel params -> this port's
    ``ImageUNet`` / ``ImageSuperResModel`` state_dict."""
    params = params.get("unet", params)
    out = _Out()
    encoder, middle, decoder, _ = build_image_plan(cfg)
    _linear(out, "time_embed.0", params["time_embed"]["Dense_0"])
    _linear(out, "time_embed.2", params["time_embed"]["Dense_1"])
    if cfg.num_classes is not None:
        out["label_emb.weight"] = params["label_emb"]["embedding"]
    for i, specs in enumerate(encoder):
        spec = specs[0]
        name = f"enc_{i}_0"
        if spec == "initial":
            _conv(out, "input_blocks.0.0", params[name + "_conv"])
        elif spec == "downsample":
            _conv(out, f"input_blocks.{i}.0.op", params[name + "_down"])
        else:
            _image_resblock(out, f"input_blocks.{i}.0", params[name + "_res"], spec)
            if spec.attn_heads:
                _image_attention(out, f"input_blocks.{i}.1", params[name + "_attn"], spec.attn_heads)
    _image_resblock(out, "middle_block.0", params["mid_0_0_res"], middle[0])
    _image_attention(out, "middle_block.1", params["mid_0_0_attn"], middle[0].attn_heads)
    _image_resblock(out, "middle_block.2", params["mid_0_1_res"], middle[1])
    for i, specs in enumerate(decoder):
        tsub = 0
        for j, spec in enumerate(specs):
            name = f"dec_{i}_{j}"
            if spec == "upsample":
                _conv(out, f"output_blocks.{i}.{tsub}.conv", params[name + "_up"])
                tsub += 1
            else:
                _image_resblock(out, f"output_blocks.{i}.{tsub}", params[name + "_res"], spec)
                tsub += 1
                if spec.attn_heads:
                    _image_attention(
                        out, f"output_blocks.{i}.{tsub}", params[name + "_attn"], spec.attn_heads
                    )
                    tsub += 1
    _norm(out, "out.0", params["out_norm"])
    _conv(out, "out.2", params["out_conv"])
    return out.sd


@torch.no_grad()
def randomize_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``seed`` with non-zero values: weights
    ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.1^2).
    Unlike the default initialisation (zero output heads), every layer then
    shapes the output -- for parity checks and smoke runs."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=g)
        if p.dim() > 1:
            p.copy_(noise / np.sqrt(p[0].numel()))
        elif name.endswith("weight"):
            p.copy_(1.0 + 0.1 * noise)
        else:
            p.copy_(0.1 * noise)
    return model


def load_reference_checkpoint(model: nn.Module, path: str) -> None:
    """Load an original PyTorch ``.pt`` state_dict into ``model`` (strict:
    a missing or unexpected key is an error, not a silent partial load)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path} does not hold a state_dict of tensors")
    model.load_state_dict(sd, strict=True)


# -- the evaluation networks (JAX -> port) ----------------------------------------
#
# Each inverts the JAX package's converter of the original checkpoint
# (``mm_diffusion_tpu/evaluation/``: ``i3d.convert_torch_i3d``,
# ``audioclip.convert_audioclip_audio_tower``, ``clip_model.convert_clip_visual``
# and ``convert_clip_text``): a flax ``{"params", "batch_stats"}`` tree of
# numpy arrays in, the port module's ``state_dict`` out (BatchNorm's
# ``num_batches_tracked`` aside, which nothing reads in eval).


def _conv3d(k):  # [kT, kH, kW, I, O] -> [O, I, kT, kH, kW]
    return np.transpose(k, (4, 3, 0, 1, 2))


def _batch_norm(out: _Out, prefix: str, p: Params, s: Params):
    out[f"{prefix}.weight"] = p["bn"]["scale"]
    out[f"{prefix}.bias"] = p["bn"]["bias"]
    out[f"{prefix}.running_mean"] = s["bn"]["mean"]
    out[f"{prefix}.running_var"] = s["bn"]["var"]


def i3d_state_dict_from_jax(variables: Params) -> Dict[str, torch.Tensor]:
    """Flax ``InceptionI3d`` variables -> the port's ``InceptionI3d``."""
    from .evaluation.i3d import INCEPTION_CFG

    params, stats = variables["params"], variables["batch_stats"]
    units = [((n,), n) for n in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3", "logits")]
    units += [((m, b), f"{m}.{b}") for m in INCEPTION_CFG for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")]
    out = _Out()
    for path, prefix in units:
        p, s = params, stats
        for key in path:
            p, s = p[key], s.get(key, {})
        out[f"{prefix}.conv3d.weight"] = _conv3d(p["conv3d"]["kernel"])
        if "bias" in p["conv3d"]:
            out[f"{prefix}.conv3d.bias"] = p["conv3d"]["bias"]
        if "bn" in p:
            _batch_norm(out, f"{prefix}.bn", p, s)
    return out.sd


def audioclip_audio_state_dict_from_jax(variables: Params) -> Dict[str, torch.Tensor]:
    """Flax ``ESResNeXtFBSP`` variables -> the port's tower (the keys of
    ``AudioCLIP-Full-Training.pt`` without its ``audio.`` prefix)."""
    from .evaluation.audioclip import LAYERS

    params, stats = variables["params"], variables["batch_stats"]
    out = _Out()
    for name in ("m", "fb", "fc"):
        out[f"fbsp.{name}"] = params[f"fbsp_{name}"]
    out["conv1.weight"] = _conv2d(params["conv1"]["kernel"])
    _batch_norm(out, "bn1", params["bn1"], stats["bn1"])
    for li, blocks in enumerate(LAYERS):
        for bi in range(blocks):
            p, s, prefix = params[f"layer{li + 1}_{bi}"], stats[f"layer{li + 1}_{bi}"], f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                out[f"{prefix}.conv{ci}.weight"] = _conv2d(p[f"conv{ci}"]["kernel"])
                _batch_norm(out, f"{prefix}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                out[f"{prefix}.downsample.0.weight"] = _conv2d(p["downsample_conv"]["kernel"])
                _batch_norm(out, f"{prefix}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    for ai in range(1, 6):
        if f"att{ai}" not in params:
            continue
        p, s = params[f"att{ai}"], stats[f"att{ai}"]
        for conv in ("conv_depth", "conv_point"):
            out[f"att{ai}.{conv}.weight"] = _conv2d(p[conv]["kernel"])
            out[f"att{ai}.{conv}.bias"] = p[conv]["bias"]
        _batch_norm(out, f"att{ai}.bn", p["bn"], s["bn"])
    _linear(out, "fc", params["fc"])
    return out.sd


def clip_visual_state_dict_from_jax(variables: Params, layers=(3, 4, 6, 3),
                                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``CLIPVisualResNet`` variables -> the port's (CLIP's ``visual.*``
    keys when ``prefix`` is ``"visual."``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = _Out()
    for i in (1, 2, 3):
        out[f"{prefix}conv{i}.weight"] = _conv2d(params[f"conv{i}"]["kernel"])
        _batch_norm(out, f"{prefix}bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            p, s, tp = params[f"layer{li + 1}_{bi}"], stats[f"layer{li + 1}_{bi}"], f"{prefix}layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                out[f"{tp}.conv{ci}.weight"] = _conv2d(p[f"conv{ci}"]["kernel"])
                _batch_norm(out, f"{tp}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                out[f"{tp}.downsample.0.weight"] = _conv2d(p["downsample_conv"]["kernel"])
                _batch_norm(out, f"{tp}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    pool = params["attnpool"]
    out[f"{prefix}attnpool.positional_embedding"] = pool["positional_embedding"]
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(out, f"{prefix}attnpool.{proj}", pool[proj])
    return out.sd


def clip_text_state_dict_from_jax(variables: Params, layers: int = 12) -> Dict[str, torch.Tensor]:
    """Flax ``CLIPTextEncoder`` variables -> the port's (CLIP's top-level
    text keys)."""
    params = variables["params"]
    out = _Out()
    out["token_embedding.weight"] = params["token_embedding"]["embedding"]
    out["positional_embedding"] = params["positional_embedding"]
    out["ln_final.weight"] = params["ln_final"]["scale"]
    out["ln_final.bias"] = params["ln_final"]["bias"]
    out["text_projection"] = params["text_projection"]
    for i in range(layers):
        p, tp = params[f"resblock_{i}"], f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            out[f"{tp}.{ln}.weight"] = p[ln]["scale"]
            out[f"{tp}.{ln}.bias"] = p[ln]["bias"]
        out[f"{tp}.attn.in_proj_weight"] = _dense(p["attn_in"]["kernel"])
        out[f"{tp}.attn.in_proj_bias"] = p["attn_in"]["bias"]
        _linear(out, f"{tp}.attn.out_proj", p["attn_out"])
        _linear(out, f"{tp}.mlp.c_fc", p["c_fc"])
        _linear(out, f"{tp}.mlp.c_proj", p["c_proj"])
    return out.sd

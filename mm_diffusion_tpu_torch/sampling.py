"""Sampling pipelines: the base joint audio-video sampler, the zero-shot
conditional (audio->video, video->audio) sampler, the 64->256 frame
super-resolution sampler, the single-modal (video or audio) sampler, and
the chain of base and SR (counterpart of
``mm_diffusion_tpu/sampling.py``); and the text-to-image latent sampler of
Stable Diffusion XL's U-Net and the text-to-video latent sampler of Wan
2.1, which the JAX package does not have.

Randomness is explicit: a device ``torch.Generator`` for the noise, and a
CPU generator from which the MM-UNet draws each RS-MMA window shift on the
host, so no draw waits on the device.

Each call of a base, SR, text-to-image or text-to-video sampler is span ``sample.call``
and each model evaluation in it span ``sample.nfe`` (``utils/tracing.py``;
off by default).
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

import torch

from .diffusion.gaussian import GaussianDiffusion, tree_map
from .parallel.mesh import rank_rows
from .samplers import (
    DPMSolver,
    NoiseScheduleFlow,
    conditional_p_sample_loop,
    ddim_sample_loop,
    model_input_time,
    noise_schedule_from_diffusion,
    p_sample_loop,
    wrap_model,
)
from .utils import tracing
from .utils.seeds import derive_seed
from .utils.timing import sync

SAMPLE_FNS = ("dpm_solver", "dpm_solver++", "ddpm", "ddim")
_CALLS = itertools.count()  # the id of each base or SR sampler call's span


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _randn(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device)


def rows_noise(generator, rank: int, world: int):
    """The per-step noise of rank ``rank``'s rows of a batch split evenly
    over ``world`` ranks: drawn for the whole batch from ``generator``
    (alike on every rank), then sliced (``rank_rows``), so that the ranks'
    rows together draw what one process draws.  None for one rank (the
    loop's own draw, the same numbers)."""
    if world == 1:
        return None

    def draw(x):
        return tree_map(lambda v: rank_rows(torch.randn(
            (world * v.shape[0],) + v.shape[1:], dtype=v.dtype, device=v.device, generator=generator
        ), rank, world), x)

    return draw


def _ancestral(sample_fn, diffusion, model_fn, x_T, generator, clip_denoised, rows=(0, 1)):
    if sample_fn == "ddpm":
        return p_sample_loop(diffusion, model_fn, x_T, generator, clip_denoised,
                             noise_fn=rows_noise(generator, *rows))
    return ddim_sample_loop(diffusion, model_fn, x_T, clip_denoised, generator=generator)


def mm_raw_model(model, shift_generator: Optional[torch.Generator] = None):
    """MultimodalUNet -> ``raw(x, t_model, strip_sigma) -> {"video", "audio"}``;
    ``strip_sigma`` drops the learned-variance channels for the solvers."""
    learn_sigma = model.cfg.video_out_channels == 6

    def raw(x, t_model, strip_sigma: bool):
        with tracing.span("sample.nfe"):
            v, a = model(x["video"], x["audio"], t_model, shift=shift_generator)
        if strip_sigma and learn_sigma:
            v, a = v[..., : v.shape[-1] // 2], a[..., : a.shape[-1] // 2]
        return {"video": v, "audio": a}

    return raw


def _solver_model(raw, ns, device):
    """Continuous-time noise model: the solver's float32 step time becomes
    the integer model timestep, filled on the device from the host value."""

    def cont_model(x, t_cont):
        leaf = x["video"] if isinstance(x, dict) else x
        t_in = torch.full(
            (leaf.shape[0],), int(model_input_time(ns, t_cont)), dtype=torch.long, device=device
        )
        return raw(x, t_in)

    return cont_model


def build_base_sampler(
    model,
    diffusion: GaussianDiffusion,
    sample_fn: str = "dpm_solver",
    steps: int = 20,
    clip_denoised: bool = True,
    shift_generator: Optional[torch.Generator] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Unconditional joint audio-video sampler.

    ``sample_fn``: 'dpm_solver' (singlestep order 3, logSNR steps),
    'dpm_solver++' (multistep order 2 with thresholding), 'ddpm', 'ddim'.
    Returns ``sample(n, generator=None, x_T=None, rows=(0, 1)) ->
    {"video": [n,F,H,W,3], "audio": [n,L,1]}``; ``sample.noise(n,
    generator)`` draws its ``x_T``.  ``rows = (rank, world)``: the ``n``
    rows are rank ``rank``'s of a batch split over ``world`` ranks, whose
    per-step draws (ddpm's) are made for the whole batch
    (:func:`rows_noise`).
    """
    if sample_fn not in SAMPLE_FNS:
        raise ValueError(f"sample_fn {sample_fn!r} not in {SAMPLE_FNS}")
    f, c, h, w = model.cfg.video_size
    ca, length = model.cfg.audio_size
    device = _device(model)
    raw = mm_raw_model(model, shift_generator)

    def noise(n, generator):
        return {
            "video": _randn((n, f, h, w, c), generator, device),
            "audio": _randn((n, length, ca), generator, device),
        }

    if sample_fn.startswith("dpm_solver"):
        ns = noise_schedule_from_diffusion(diffusion)
        plus = sample_fn == "dpm_solver++"
        solver = DPMSolver(
            _solver_model(lambda x, t: raw(x, t, strip_sigma=True), ns, device),
            ns, predict_x0=plus, thresholding=plus,
        )

        def run(x, generator, rows):
            return solver.sample(
                x, steps=steps, order=2 if plus else 3,
                method="multistep" if plus else "singlestep", skip_type="logSNR",
            )

    else:

        def run(x, generator, rows):
            model_fn = lambda xx, tt: raw(xx, tt, strip_sigma=False)  # noqa: E731
            return _ancestral(sample_fn, diffusion, model_fn, x, generator, clip_denoised, rows)

    @torch.inference_mode()
    def sample(n: int, generator: Optional[torch.Generator] = None, x_T=None, rows=(0, 1)):
        with tracing.span("sample.call", next(_CALLS)):
            return run(noise(n, generator) if x_T is None else x_T, generator, rows)

    sample.noise = noise
    return sample


def build_conditional_sampler(
    model,
    diffusion: GaussianDiffusion,
    condition_key: str,
    class_scale: float = 0.0,
    clip_denoised: bool = True,
    shift_generator: Optional[torch.Generator] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Zero-shot audio->video (``condition_key="audio"``) or video->audio
    sampler: the replacement method at ``class_scale`` 0, else the gradient
    method (``samplers/ancestral.py::conditional_p_sample_loop``).

    Returns ``sample(condition, generator=None, x_T=None, step_seconds=None)
    -> {"video": [n,F,H,W,3], "audio": [n,L,1]}``, ``condition`` being the
    ground truth of ``condition_key`` ([n, ...] on the model's device).
    The gradient method differentiates each step through the model with
    respect to its input alone: the model's parameters are frozen
    (``requires_grad_(False)``), and the loop runs under ``no_grad``, not
    inference mode, because autograd must save the step's tensors."""
    if condition_key not in ("video", "audio"):
        raise ValueError(f"condition_key {condition_key!r} not in ('video', 'audio')")
    f, c, h, w = model.cfg.video_size
    ca, length = model.cfg.audio_size
    device = _device(model)
    raw = mm_raw_model(model, shift_generator)
    if class_scale > 0:
        model.requires_grad_(False)

    @torch.no_grad()
    def sample(condition, generator: Optional[torch.Generator] = None, x_T=None,
               step_seconds: Optional[List[float]] = None):
        n = condition.shape[0]
        if x_T is None:
            x_T = {
                "video": _randn((n, f, h, w, c), generator, device),
                "audio": _randn((n, length, ca), generator, device),
            }
        return conditional_p_sample_loop(
            diffusion, lambda x, t: raw(x, t, strip_sigma=False), x_T, condition, condition_key,
            class_scale=class_scale, clip_denoised=clip_denoised, generator=generator,
            step_seconds=step_seconds,
        )

    return sample


def build_sr_sampler(
    sr_model,
    sr_diffusion: GaussianDiffusion,
    sample_fn: str = "ddim",
    steps: int = 50,
    clip_denoised: bool = True,
):
    """Frame super-resolution sampler: 'ddim' / 'ddpm' over the (respaced)
    diffusion, or 'dpm_solver' / 'dpm_solver++' (multistep order 2,
    uniform time steps).  Returns ``sr(low_res [N,h,w,3], x_T=None,
    generator=None) -> [N,H,W,3]``."""
    if sample_fn not in SAMPLE_FNS:
        raise ValueError(f"sample_fn {sample_fn!r} not in {SAMPLE_FNS}")
    size = sr_model.cfg.image_size
    learn_sigma = sr_model.cfg.out_channels == 6
    device = _device(sr_model)

    def raw(x, t_model, low_res, strip_sigma: bool):
        with tracing.span("sample.nfe"):
            out = sr_model(x, t_model, low_res)
        return out[..., : out.shape[-1] // 2] if strip_sigma and learn_sigma else out

    @torch.inference_mode()
    def sr(low_res, x_T=None, generator: Optional[torch.Generator] = None):
        with tracing.span("sample.call", next(_CALLS)):
            return _sr(low_res, x_T, generator)

    def _sr(low_res, x_T, generator):
        if x_T is None:
            x_T = _randn((low_res.shape[0], size, size, 3), generator, device)
        if sample_fn.startswith("dpm_solver"):
            ns = noise_schedule_from_diffusion(sr_diffusion)
            plus = sample_fn == "dpm_solver++"
            cont = _solver_model(lambda x, t: raw(x, t, low_res, True), ns, device)
            solver = DPMSolver(cont, ns, predict_x0=plus, thresholding=plus)
            return solver.sample(
                x_T, steps=steps, order=2, method="multistep", skip_type="time_uniform"
            )
        model_fn = lambda x, t: raw(x, t, low_res, False)  # noqa: E731
        return _ancestral(sample_fn, sr_diffusion, model_fn, x_T, generator, clip_denoised)

    return sr


def build_text2img_sampler(model, diffusion: GaussianDiffusion, steps: int = 20,
                           guidance_scale: float = 5.0):
    """Text-to-image latent sampler of an ``ImageUNet`` with ``context_dim``
    (Stable Diffusion XL): DPM-Solver++ (``predict_x0``, no thresholding),
    multistep order 2 over time-uniform steps, as DPM-Solver's example for
    Stable Diffusion runs it; classifier-free guidance at
    ``guidance_scale`` through ``wrap_model``, each evaluation one call on
    the doubled batch ``[uncond; cond]``, the model time the truncated
    integer timestep.

    Returns ``sample(cond, uncond, x_T=None, generator=None) -> [n, H, W,
    in_channels]`` latents, ``cond`` and ``uncond`` holding ``"context"``
    ``[n, L, context_dim]`` and ``"y"`` ``[n, adm_in_channels]``
    (``models.image_unet.sdxl_vector``)."""
    ns = noise_schedule_from_diffusion(diffusion)
    device = _device(model)
    shape = (model.cfg.image_size, model.cfg.image_size, model.cfg.in_channels)

    def raw(x, t_model, cond):
        with tracing.span("sample.nfe"):
            return model(x, t_model, context=cond["context"], y=cond.get("y"))

    @torch.inference_mode()
    def sample(cond, uncond, x_T=None, generator: Optional[torch.Generator] = None):
        with tracing.span("sample.call", next(_CALLS)):
            n = cond["context"].shape[0]
            x = _randn((n,) + shape, generator, device) if x_T is None else x_T
            guided = wrap_model(raw, ns, guidance_type="classifier-free", guidance_scale=guidance_scale,
                                condition=cond, unconditional_condition=uncond)
            solver = DPMSolver(guided, ns, predict_x0=True, thresholding=False)
            return solver.sample(x, steps=steps, order=2, method="multistep", skip_type="time_uniform")

    return sample


def build_text2video_sampler(model, steps: int = 50, shift: float = 5.0, guidance_scale: float = 5.0):
    """Text-to-video latent sampler of Wan 2.1's transformer
    (``models.wan.WanModel``): DPM-Solver++ (``predict_x0``, no
    thresholding), multistep order 2 over the flow-matching schedule
    (``NoiseScheduleFlow``: ``steps`` noise levels from 0.999, each shifted
    by ``shift``, then a first-order last step to 0 that returns the data
    prediction), the update of Wan's ``FlowDPMSolverMultistepScheduler``
    with ``dpmsolver++``; the model predicts the velocity at the model time
    1000 sigma; classifier-free guidance at ``guidance_scale`` on the
    velocity through ``wrap_model``, each evaluation one call on the doubled
    batch ``[uncond; cond]``.

    Returns ``sample(cond, uncond, x_T) -> [n, out_dim, F, H, W]``
    latents from ``x_T [n, in_dim, F, H, W]``, ``cond`` and ``uncond``
    holding ``"context"`` ``[n, text_len, text_dim]``."""
    ns = NoiseScheduleFlow(shift=shift)

    def raw(x, t_model, cond):
        with tracing.span("sample.nfe"):
            return model(x, t_model, context=cond["context"])

    @torch.inference_mode()
    def sample(cond, uncond, x_T):
        with tracing.span("sample.call", next(_CALLS)):
            guided = wrap_model(raw, ns, guidance_type="classifier-free", guidance_scale=guidance_scale,
                                condition=cond, unconditional_condition=uncond)
            solver = DPMSolver(guided, ns, predict_x0=True, thresholding=False)
            return solver.sample(x_T, steps=steps, order=2, method="multistep")

    return sample


def build_single_sampler(
    model,
    diffusion: GaussianDiffusion,
    sample_fn: str = "ddim",
    steps: int = 50,
    clip_denoised: bool = True,
) -> Callable[..., torch.Tensor]:
    """Unconditional sampler of a single-modal video or audio U-Net: 'ddim'
    / 'ddpm' over ``diffusion``, or 'dpm_solver' / 'dpm_solver++'
    (multistep order 2, time-uniform steps).  Returns ``sample(n,
    generator=None, x_T=None) -> [n, ...]`` (the config's sample shape)."""
    if sample_fn not in SAMPLE_FNS:
        raise ValueError(f"sample_fn {sample_fn!r} not in {SAMPLE_FNS}")
    shape = tuple(model.cfg.sample_shape)
    learn_sigma = model.cfg.out_channels == 2 * shape[-1]
    device = _device(model)

    def raw(x, t_model, strip_sigma: bool):
        out = model(x, t_model)
        return out[..., : out.shape[-1] // 2] if strip_sigma and learn_sigma else out

    if sample_fn.startswith("dpm_solver"):
        ns = noise_schedule_from_diffusion(diffusion)
        plus = sample_fn == "dpm_solver++"
        solver = DPMSolver(
            _solver_model(lambda x, t: raw(x, t, strip_sigma=True), ns, device),
            ns, predict_x0=plus, thresholding=plus,
        )

        def run(x, generator):
            return solver.sample(x, steps=steps, order=2, method="multistep",
                                 skip_type="time_uniform")

    else:

        def run(x, generator):
            model_fn = lambda xx, tt: raw(xx, tt, strip_sigma=False)  # noqa: E731
            return _ancestral(sample_fn, diffusion, model_fn, x, generator, clip_denoised)

    @torch.inference_mode()
    def sample(n: int, generator: Optional[torch.Generator] = None, x_T=None):
        return run(_randn((n,) + shape, generator, device) if x_T is None else x_T, generator)

    return sample


def shared_clip_noise(
    n_clips: int, frames: int, size: int, generator=None, device=None
) -> torch.Tensor:
    """One noise image per clip, repeated across its frames."""
    base = _randn((n_clips, 1, size, size, 3), generator, device)
    return base.expand(n_clips, frames, size, size, 3).reshape(n_clips * frames, size, size, 3)


def sample_base_and_sr(
    base_sampler,
    sr_sampler,
    n: int,
    sr_size: int,
    frames: int,
    generator: Optional[torch.Generator] = None,
    x_T=None,
    sr_x_T: Optional[torch.Tensor] = None,
    timings: Optional[Dict[str, float]] = None,
    rank: int = 0,
    world: int = 1,
    step_generator: Optional[torch.Generator] = None,
):
    """Base joint sample, then SR clip by clip, all frames of a clip sharing
    one noise image.

    ``n`` is the global batch.  Its noise -- ``x_T``, then the SR noise
    image of every clip -- is drawn from ``generator`` first, or injected
    (``x_T``; ``sr_x_T`` [n, F, S, S, 3]), and rank ``rank`` of ``world``
    samples its rows of it (``rank_rows``) and returns those, so that the
    ranks' rows together are the one-process sample at the same seed.
    The samplers' own draws (ddpm's per-step noise) come from
    ``step_generator`` (``generator`` by default), alike on every rank:
    the base stage draws them for the global batch (:func:`rows_noise`);
    the SR stage gives each clip a generator of its own, seeded from one
    draw of ``step_generator`` and the clip's row in the global batch.
    ``timings``, when given, receives the wall seconds of the two stages
    (measured to a device synchronisation)."""
    if x_T is None:
        x_T = base_sampler.noise(n, generator)
    if sr_x_T is None:
        sr_x_T = shared_clip_noise(n, frames, sr_size, generator, x_T["video"].device)
        sr_x_T = sr_x_T.reshape(n, frames, sr_size, sr_size, 3)
    x_T = tree_map(lambda x: rank_rows(x, rank, world), x_T)
    sr_x_T = rank_rows(sr_x_T, rank, world)
    step_generator = step_generator or generator
    local_n = sr_x_T.shape[0]
    t0 = time.perf_counter()
    out = base_sampler(local_n, generator=step_generator, x_T=x_T, rows=(rank, world))
    video = out["video"]
    if timings is not None:
        sync(video.device)
        timings["base_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    clip_seed = int(torch.randint(2**62, (1,), generator=step_generator, device=video.device))
    clips = [
        sr_sampler(video[b], x_T=sr_x_T[b], generator=torch.Generator(device=video.device).manual_seed(
            derive_seed(clip_seed, rank * local_n + b)))
        for b in range(local_n)
    ]
    sr_video = torch.stack(clips).reshape(local_n, frames, sr_size, sr_size, 3)
    if timings is not None:
        sync(sr_video.device)
        timings["sr_s"] = time.perf_counter() - t1
    return {"video": video, "audio": out["audio"], "sr_video": sr_video}

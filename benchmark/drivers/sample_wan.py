"""Driver ``sample_wan``: the port's text-to-video latent sampler
(``sampling.build_text2video_sampler``: DPM-Solver++ (2M) on the
flow-matching schedule shifted by ``shift``, ``steps`` evaluations a call,
classifier-free guidance at ``guidance_scale`` on the velocity over the
doubled batch ``[uncond; cond]``) on Wan 2.1's transformer
(``models.wan.WanModel``), one clip a call.  A clip is one video's latent.
Calls run back to back, a closed loop with one client.

Each call's ``x_T``, text context and unconditional context, all N(0, 1),
come from the seed and the call's index on the device.

The check.  One of the first ``check_clips`` calls, drawn from the seed, is
recorded while it runs in the window: the model's output of every
evaluation and the input (``x_t`` and the model time) of two of them, the
first and one drawn from the second half, all kept as the device tensors
the program made, with no copy and no wait.  After the window:

* ``velocity_rel_l2``: the reference model (``benchmark/reference/wan.py``,
  float32) evaluates those two inputs on the call's contexts, and the worse
  relative L2 gap of the guided velocity is compared;
* ``latent_rel_l2``: the reference solver (``benchmark/reference/
  dpm_flow.py``) runs from the call's ``x_T`` through the program's
  recorded outputs, and its latent is compared with the program's.  This
  holds the schedule, the shift, the guidance, the order and the last step
  to the reference at the timed size with no model call.

The control (``numbers("fp8")``) puts the reference computed in fp8
(``layers.Precision``) in the program's place: the model with fp8 products
and bf16 activations, and the solver with its state stored in bf16.
"""

from __future__ import annotations

import torch

from benchmark import work_sdxl, work_wan
from benchmark.harness import Check, Spanned, device_generator, free_cuda, rel_l2, sample_indices
from benchmark.reference import dpm_flow
from benchmark.reference.layers import Precision, set_precision
from benchmark.reference.wan import WanRef, WanRefConfig
from benchmark.weights import load_seeded_

UNIT = "clips"
WARM_STEPS = 3  # first-order, second-order and last updates: every shape of the timed call


class Recording:
    """The model as the sampler sees it (``cfg``, ``parameters()``, calls),
    which, while armed, keeps every call's output and the inputs of the
    calls numbered in ``keep``."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.armed = False
        self.keep = ()
        self.outputs = []
        self.inputs = {}

    def parameters(self):
        return self.model.parameters()

    def arm(self, on: bool, keep=()) -> None:
        self.armed = on
        if on:
            self.keep, self.outputs, self.inputs = tuple(keep), [], {}

    def __call__(self, x, t, context):
        out = self.model(x, t, context=context)
        if self.armed:
            if len(self.outputs) in self.keep:
                self.inputs[len(self.outputs)] = (x, t)
            self.outputs.append(out)
        return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.flags = config["model"]
        self.shape = work_wan.latent_shape(config["video"])
        self.sigma_range = (float(config["diffusion"]["sigma_max"]), float(config["diffusion"]["sigma_min"]))
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.steps = int(traffic["steps"])
        self.shift = float(traffic["shift"])
        self.scale = float(traffic["guidance_scale"])
        self.check_call = sample_indices(seed, "wan-check-call", int(traffic["check_clips"]), 1)[0]
        half = self.steps // 2
        self.picks = (0, half + sample_indices(seed, "wan-check-eval", self.steps - half, 1)[0])
        self.outputs = []
        self.refs = {}  # the float32 reference's numbers, by name

    # -- the program -------------------------------------------------------------

    def setup(self) -> None:
        from mm_diffusion_tpu_torch import configs
        from mm_diffusion_tpu_torch.models.wan import WanModel
        from mm_diffusion_tpu_torch.sampling import build_text2video_sampler

        cfg = configs.create_text2video_config(**self.flags)
        with torch.device(self.device):
            model = WanModel(cfg)
        self.model = Spanned(load_seeded_(model.eval(), self.seed))
        self.recording = Recording(self.model)
        self.sampler = build_text2video_sampler(self.recording, self.steps, self.shift, self.scale)
        build_text2video_sampler(self.recording, WARM_STEPS, self.shift, self.scale)(*self.program_args(-1))

    def inputs(self, k: int):
        """Call ``k``'s ``x_T``, context and unconditional context, on the device."""
        g = device_generator(self.device, self.seed, "wan-call", k)
        context = (1, int(self.flags["text_len"]), int(self.flags["text_dim"]))
        x_t = torch.randn(1, *self.shape, generator=g, device=self.device)
        return (x_t, torch.randn(context, generator=g, device=self.device),
                torch.randn(context, generator=g, device=self.device))

    def program_args(self, k: int):
        x_t, context, uncond = self.inputs(k)
        return {"context": context}, {"context": uncond}, x_t

    def call(self) -> int:
        k = len(self.outputs)
        self.recording.arm(k == self.check_call, self.picks)
        self.outputs.append(self.sampler(*self.program_args(k)).cpu())  # the user's copy; waits for the clip
        return 1

    # -- the yardstick -----------------------------------------------------------

    def work(self):
        """(model FLOPs per clip, self-attention bound seconds per clip):
        ``steps`` evaluations of two rows."""
        flops, sites = work_wan.eval_work(self.flags, 2, self.shape)
        return self.steps * flops, self.steps * work_sdxl.self_attention_bound_s(sites)

    # -- the comparison ----------------------------------------------------------

    def release(self) -> None:
        self.recording.model = None
        del self.model, self.sampler
        free_cuda()

    def velocities(self, model, context, uncond):
        """``model``'s guided velocity at each recorded input."""
        out = []
        for i in self.picks:
            x, t = self.recording.inputs[i]
            with torch.no_grad():
                out.append(dpm_flow.guided(model(x.float(), t, torch.cat([uncond, context])), self.scale))
        return out

    def replay(self, x_t, act=lambda v: v):
        """The reference solver's latent from ``x_t`` through the program's
        recorded outputs."""
        sigmas = dpm_flow.shifted_sigmas(self.steps, self.shift, *self.sigma_range)
        outputs = self.recording.outputs
        return dpm_flow.sample(x_t, sigmas, lambda x, i, s: dpm_flow.guided(outputs[i], self.scale), act)

    def numbers(self, candidate: str = "program") -> dict:
        """The compared numbers of the recorded call, with the program's
        outputs, or with the reference computed in ``candidate``'s precision
        in their place (the control)."""
        k = self.check_call
        if k >= len(self.outputs) or len(self.recording.outputs) != self.steps:
            raise RuntimeError(f"call {k} was not recorded: {len(self.outputs)} calls ran")
        x_t, context, uncond = self.inputs(k)
        if not self.refs:
            with torch.device(self.device):
                self.ref_model = load_seeded_(WanRef(WanRefConfig.from_flags(self.flags)).eval(), self.seed)
            self.refs["velocity"] = self.velocities(self.ref_model, context, uncond)
            self.refs["latent"] = self.replay(x_t)
        if candidate == "program":
            velocity = [dpm_flow.guided(self.recording.outputs[i], self.scale) for i in self.picks]
            latent = self.outputs[k]
        else:
            set_precision(self.ref_model, Precision(candidate))
            velocity = self.velocities(self.ref_model, context, uncond)
            set_precision(self.ref_model, Precision())
            latent = self.replay(x_t, Precision(candidate).act)
        return {
            "velocity_rel_l2": max(rel_l2(v.to(r.device), r) for v, r in zip(velocity, self.refs["velocity"])),
            "latent_rel_l2": rel_l2(latent.to(self.refs["latent"].device), self.refs["latent"]),
        }

    def check(self, limits: dict):
        return [Check(n, v, limits[n]) for n, v in self.numbers().items()]

"""Driver ``sample_sr``: the port's frame super-resolution sampler
(``sampling.build_sr_sampler``, DDIM at eta 0 over the learned-sigma
diffusion respaced to ``steps``), called as ``sample_base_and_sr`` calls
it: one clip's frames a call, every frame of the clip starting from one
shared noise image.  Calls run back to back, a closed loop with one
client.

Each call's low-resolution clip (uniform in [-1, 1]) and noise image come
from the seed and the call's index.  After the window the reference
upsamples ``check_clips`` of the finished clips, drawn from the seed, in
float32 from the same inputs and weights, and the clip's relative L2 gap
is compared."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.harness import Check, Spanned, device_generator, free_cuda, rel_l2, sample_indices
from benchmark.reference.diffusion import Tables, ddim_sample
from benchmark.reference.image_unet import SRConfig, SRUNet
from benchmark.reference.layers import Precision
from benchmark.weights import load_seeded_

UNIT = "clips"
WARM_STEPS = 2  # a DDIM call of this many steps warms every shape of the timed call


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.flags = config["model"]
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.frames = int(traffic["frames"])
        self.steps = int(traffic["steps"])
        self.outputs = []
        self.refs = {}  # the float32 reference's clips, by call

    # -- the program -------------------------------------------------------------

    def setup(self) -> None:
        from mm_diffusion_tpu_torch import configs
        from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
        from mm_diffusion_tpu_torch.sampling import build_sr_sampler

        cfg = configs.create_image_sr_config(**self.flags)
        with torch.device(self.device):
            model = ImageSuperResModel(cfg)
        self.model = Spanned(load_seeded_(model.eval(), self.seed))

        def sampler(steps):
            diffusion = configs.create_gaussian_diffusion(
                steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing=f"ddim{steps}")
            return build_sr_sampler(self.model, diffusion, sample_fn="ddim", steps=steps)

        self.sampler = sampler(self.steps)
        low, x_t = self.inputs(-1)
        sampler(WARM_STEPS)(low, x_T=x_t)

    def inputs(self, k: int):
        """Call ``k``'s low-resolution clip and shared noise, on the device."""
        g = device_generator(self.device, self.seed, "sr-call", k)
        small, size = int(self.flags["small_size"]), int(self.flags["large_size"])
        low = torch.rand(self.frames, small, small, 3, generator=g, device=self.device) * 2 - 1
        noise = torch.randn(1, size, size, 3, generator=g, device=self.device)
        return low, noise.expand(self.frames, size, size, 3).contiguous()

    def call(self) -> int:
        low, x_t = self.inputs(len(self.outputs))
        self.outputs.append(self.sampler(low, x_T=x_t).cpu())  # the user's copy; waits for the clip
        return 1

    # -- the yardstick -----------------------------------------------------------

    def work(self):
        """(model FLOPs per clip, attention bound seconds per clip)."""
        flops, sites = work.sr_eval_work(self.flags, self.frames)
        return self.steps * flops, self.steps * work.attention_bound_s(sites)

    # -- the comparison ----------------------------------------------------------

    def release(self) -> None:
        del self.model, self.sampler
        free_cuda()

    def reference_clip(self, k: int, precision: str = "float32") -> torch.Tensor:
        with torch.device(self.device):
            model = load_seeded_(SRUNet(SRConfig.from_flags(self.flags), Precision(precision)), self.seed)
        tables = Tables(1000, respace=self.steps, device=self.device)
        low, x_t = self.inputs(k)
        with torch.no_grad():
            return ddim_sample(tables, lambda x, t: model(x, t, low), x_t, learn_sigma=True)

    def numbers(self, candidate: str = "program") -> dict:
        """The compared numbers of the clips drawn for the check, with the
        program's clips, or with the reference computed in ``candidate``'s
        precision in their place (the control)."""
        picks = sample_indices(self.seed, "sr-check", len(self.outputs), int(self.traffic["check_clips"]))
        gaps = []
        for k in picks:
            if k not in self.refs:
                self.refs[k] = self.reference_clip(k)
            ref = self.refs[k]
            got = self.outputs[k] if candidate == "program" else self.reference_clip(k, candidate)
            gaps.append(rel_l2(got.to(ref.device), ref))
        return {"clip_rel_l2": max(gaps)}

    def check(self, limits: dict):
        return [Check(n, v, limits[n]) for n, v in self.numbers().items()]

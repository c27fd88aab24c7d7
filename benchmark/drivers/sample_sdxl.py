"""Driver ``sample_sdxl``: the port's text-to-image latent sampler
(``sampling.build_text2img_sampler``: DPM-Solver++ multistep of order 2
over time-uniform steps, ``steps`` evaluations a call, classifier-free
guidance at ``guidance_scale`` over the doubled batch ``[uncond; cond]``)
on Stable Diffusion XL base's U-Net, ``batch`` images a call.  A clip is
one image's latent.  Calls run back to back, a closed loop with one client.

Each call's ``x_T``, text contexts and pooled text embeddings, all N(0, 1),
come from the seed and the call's index on the device; the vector
condition adds the configuration's size conditioning, and the
unconditional branch has a zero context and a zero pooled embedding.
After the window the reference samples ``check_images`` of the finished
images, drawn from the seed, one image at a time in float32 from the same
inputs and weights, and the worse image's relative L2 gap of the final
latent is compared."""

from __future__ import annotations

import torch

from benchmark import work_sdxl
from benchmark.harness import Check, Spanned, device_generator, free_cuda, ints, rel_l2, sample_indices
from benchmark.reference.dpm_pp import guided_sample, scaled_linear_vp
from benchmark.reference.layers import Precision
from benchmark.reference.sdxl_unet import SDXLConfig, SDXLUNet, vector_condition
from benchmark.weights import load_seeded_

UNIT = "clips"
WARM_STEPS = 2  # a first-order then a second-order update: every shape of the timed call


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.flags = config["model"]
        self.conditioning = config["conditioning"]
        self.diffusion_steps = int(config["diffusion"]["diffusion_steps"])
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.batch = int(traffic["batch"])
        self.steps = int(traffic["steps"])
        self.scale = float(traffic["guidance_scale"])
        self.outputs = []
        self.refs = {}  # the float32 reference's latents, by (call, row)

    @property
    def sizes(self):
        c = self.conditioning
        return ints(c["original_size"]) + ints(c["crop_coords_top_left"]) + ints(c["target_size"])

    # -- the program -------------------------------------------------------------

    def setup(self) -> None:
        from mm_diffusion_tpu_torch import configs
        from mm_diffusion_tpu_torch.models.image_unet import ImageUNet, sdxl_vector
        from mm_diffusion_tpu_torch.sampling import build_text2img_sampler

        cfg = configs.create_text2img_config(**self.flags)
        with torch.device(self.device):
            model = ImageUNet(cfg)
        self.model = Spanned(load_seeded_(model.eval(), self.seed))
        diffusion = configs.create_gaussian_diffusion(steps=self.diffusion_steps, noise_schedule="scaled_linear")
        s = self.sizes
        size_dim = int(self.conditioning["size_dim"])
        self.vector = lambda pooled: sdxl_vector(pooled, s[0:2], s[2:4], s[4:6], size_dim)
        self.sampler = build_text2img_sampler(self.model, diffusion, self.steps, self.scale)
        build_text2img_sampler(self.model, diffusion, WARM_STEPS, self.scale)(*self.program_args(-1))

    def inputs(self, k: int):
        """Call ``k``'s ``x_T``, contexts and pooled embeddings, on the device."""
        g = device_generator(self.device, self.seed, "sdxl-call", k)
        s, c = int(self.flags["image_size"]), int(self.flags["in_channels"])
        tokens, pooled = int(self.conditioning["context_tokens"]), int(self.conditioning["pooled_dim"])
        x_t = torch.randn(self.batch, s, s, c, generator=g, device=self.device)
        context = torch.randn(self.batch, tokens, int(self.flags["context_dim"]), generator=g, device=self.device)
        return x_t, context, torch.randn(self.batch, pooled, generator=g, device=self.device)

    def program_args(self, k: int):
        x_t, context, pooled = self.inputs(k)
        cond = {"context": context, "y": self.vector(pooled)}
        uncond = {"context": torch.zeros_like(context), "y": self.vector(torch.zeros_like(pooled))}
        return cond, uncond, x_t

    def call(self) -> int:
        cond, uncond, x_t = self.program_args(len(self.outputs))
        self.outputs.append(self.sampler(cond, uncond, x_T=x_t).cpu())  # the user's copy; waits for the images
        return self.batch

    # -- the yardstick -----------------------------------------------------------

    def work(self):
        """(model FLOPs per image, self-attention bound seconds per image):
        ``steps`` evaluations of two rows an image."""
        flops, sites = work_sdxl.eval_work(self.flags, 2 * self.batch, int(self.conditioning["context_tokens"]),
                                           int(self.flags["image_size"]))
        return self.steps * flops / self.batch, self.steps * work_sdxl.self_attention_bound_s(sites) / self.batch

    # -- the comparison ----------------------------------------------------------

    def release(self) -> None:
        del self.model, self.sampler
        free_cuda()

    def reference_model(self, precision: str = "float32"):
        with torch.device(self.device):
            return load_seeded_(SDXLUNet(SDXLConfig.from_flags(self.flags), Precision(precision)), self.seed)

    def reference_image(self, k: int, row: int, model) -> torch.Tensor:
        """Image ``row`` of call ``k``, sampled by the reference ``model``."""
        x_t, context, pooled = (v[row: row + 1] for v in self.inputs(k))
        size_dim = int(self.conditioning["size_dim"])
        cond = {"context": context, "y": vector_condition(pooled, self.sizes, size_dim)}
        uncond = {"context": torch.zeros_like(context),
                  "y": vector_condition(torch.zeros_like(pooled), self.sizes, size_dim)}
        with torch.no_grad():
            return guided_sample(scaled_linear_vp(self.diffusion_steps),
                                 lambda x, t, c: model(x, t, c["context"], c["y"]),
                                 x_t, cond, uncond, self.steps, self.scale)

    def numbers(self, candidate: str = "program") -> dict:
        """The compared number of the images drawn for the check, with the
        program's images, or with the reference computed in ``candidate``'s
        precision in their place (the control)."""
        n = int(self.traffic["check_images"])
        picks = sample_indices(self.seed, "sdxl-check", len(self.outputs) * self.batch, n)
        model = None
        other = None if candidate == "program" else self.reference_model(candidate)
        gaps = []
        for i in picks:
            k, row = divmod(i, self.batch)
            if (k, row) not in self.refs:
                model = model or self.reference_model()
                self.refs[k, row] = self.reference_image(k, row, model)
            ref = self.refs[k, row]
            got = self.outputs[k][row: row + 1] if other is None else self.reference_image(k, row, other)
            gaps.append(rel_l2(got.to(ref.device), ref))
        return {"latent_rel_l2": max(gaps)}

    def check(self, limits: dict):
        return [Check(n, v, limits[n]) for n, v in self.numbers().items()]

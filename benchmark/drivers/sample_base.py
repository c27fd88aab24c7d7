"""Driver ``sample_base``: the port's joint audio-video sampler
(``sampling.build_base_sampler``, singlestep DPM-Solver of order 3 over
logSNR steps, ``steps`` evaluations a call) at ``batch`` clips a call.
Calls run back to back, a closed loop with one client.

Each call's ``x_T`` comes from the seed and the call's index on the
device; its RS-MMA shifts from a host generator seeded from the seed and
the call's index, which every shifting site draws from in turn.  After the
window the reference samples ``check_rows`` rows of the finished calls,
drawn from the seed, one row at a time in float32 from the same ``x_T``,
weights and shifts, and the rows' relative L2 gaps are compared, video and
audio apart."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import work
from benchmark.harness import Check, Spanned, device_generator, free_cuda, ints, rel_l2, sample_indices
from benchmark.reference.diffusion import DiscreteVP, dpm_solver_sample, linear_betas
from benchmark.reference.layers import Precision
from benchmark.reference.mm_unet import MMConfig, MMUNet
from benchmark.weights import derive_seed, load_seeded_

UNIT = "clips"
WARM_STEPS = 5  # orders [3, 2]: the same updates as the timed call, five evaluations


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.flags = config["model"]
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.batch = int(traffic["batch"])
        self.steps = int(traffic["steps"])
        self.outputs = []
        self.refs = {}  # the float32 reference's rows, by (call, row)
        self.shift_gen = torch.Generator()

    def setup(self) -> None:
        from mm_diffusion_tpu_torch import configs
        from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
        from mm_diffusion_tpu_torch.sampling import build_base_sampler

        cfg = configs.create_model_config(**self.flags)
        with torch.device(self.device):
            model = MultimodalUNet(cfg)
        self.model = Spanned(load_seeded_(model.eval(), self.seed))
        diffusion = configs.create_gaussian_diffusion(steps=1000, noise_schedule="linear")

        def sampler(steps):
            return build_base_sampler(self.model, diffusion, sample_fn="dpm_solver", steps=steps,
                                      shift_generator=self.shift_gen)

        self.sampler = sampler(self.steps)
        sampler(WARM_STEPS)(self.batch, x_T=self.inputs(-1))

    def inputs(self, k: int):
        """Call ``k``'s ``x_T``; seeds the shift generator for the call."""
        f, c, h, w = ints(self.flags["video_size"])
        ca, length = ints(self.flags["audio_size"])
        g = device_generator(self.device, self.seed, "base-call", k)
        self.shift_gen.manual_seed(derive_seed(self.seed, "base-shift", k))
        return {"video": torch.randn(self.batch, f, h, w, c, generator=g, device=self.device),
                "audio": torch.randn(self.batch, length, ca, generator=g, device=self.device)}

    def call(self) -> int:
        x_t = self.inputs(len(self.outputs))
        out = self.sampler(self.batch, x_T=x_t)
        self.outputs.append({k: v.cpu() for k, v in out.items()})  # the user's copy; waits for the clips
        return self.batch

    def work(self):
        """(model FLOPs per clip, attention bound seconds per clip)."""
        flops, sites = work.mm_eval_work(self.flags, self.batch)
        return self.steps * flops / self.batch, self.steps * work.attention_bound_s(sites) / self.batch

    def release(self) -> None:
        del self.model, self.sampler
        free_cuda()

    def reference_row(self, k: int, row: int, model) -> dict:
        """Row ``row`` of call ``k``, sampled by the reference ``model``."""
        x_t = {n: v[row: row + 1] for n, v in self.inputs(k).items()}
        gen = torch.Generator().manual_seed(derive_seed(self.seed, "base-shift", k))
        vp = DiscreteVP(np.float32(np.cumprod(1.0 - linear_betas(1000))))

        def eps(x, t_int):
            t = torch.full((1,), t_int, dtype=torch.long, device=self.device)
            v, a = model(x["video"], x["audio"], t, gen)
            return {"video": v, "audio": a}

        with torch.no_grad():
            return dpm_solver_sample(vp, eps, x_t, self.steps)

    def reference_model(self, precision: str = "float32"):
        with torch.device(self.device):
            return load_seeded_(MMUNet(MMConfig.from_flags(self.flags), Precision(precision)), self.seed)

    def numbers(self, candidate: str = "program") -> dict:
        """The compared numbers of the rows drawn for the check, with the
        program's rows, or with the reference computed in ``candidate``'s
        precision in their place (the control)."""
        n = int(self.traffic["check_rows"])
        flat = sample_indices(self.seed, "base-check", len(self.outputs) * self.batch, n)
        model = None
        other = None if candidate == "program" else self.reference_model(candidate)
        gaps = {"video_rel_l2": [], "audio_rel_l2": []}
        for i in flat:
            k, row = divmod(i, self.batch)
            if (k, row) not in self.refs:
                model = model or self.reference_model()
                self.refs[k, row] = self.reference_row(k, row, model)
            ref = self.refs[k, row]
            got = ({key: v[row: row + 1] for key, v in self.outputs[k].items()} if other is None
                   else self.reference_row(k, row, other))
            for key in ("video", "audio"):
                gaps[f"{key}_rel_l2"].append(rel_l2(got[key].to(ref[key].device), ref[key]))
        return {name: max(v) for name, v in gaps.items()}

    def check(self, limits: dict):
        return [Check(n, v, limits[n]) for n, v in self.numbers().items()]

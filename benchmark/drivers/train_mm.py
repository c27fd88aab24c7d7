"""Driver ``train_mm``: the port's MM-UNet train step
(``train.state.make_train_step``) at ``batch`` with ``use_checkpoint``,
bf16 compute, fp32 AdamW and one EMA, the linear 1000-step diffusion, and
the configuration's dropout (masks from the card's generator, seeded from
the seed).

Each step takes the next batch of a pool of ``pool`` batches made on the
device from the seed (the data layer is bypassed), and timesteps and noise
drawn from the seed and the step's index, handed to the step.  Set-up
builds the one train state and drives it through its first ``check_steps``
steps through the window's own call; the window goes on from there.  After
the window (in ``release``) the same call takes one more step from the
state the window left.  Those steps are what the reference follows: the
first steps from the seeded weights (each step's loss, the norm of the
first gradient as AdamW holds it after one step -- its first moment over
1 - b1 -- and the norms of the parameters' and the EMA's change after the
last of them), and the step after the window from the program's own
parameters and moments (the gradient AdamW takes, from the change of its
first moment, and the parameters' change), each leaf against the
reference's.  The checked steps run with dropout's probability set to 0 on
the same modules: the reference cannot draw the card's masks."""

from __future__ import annotations

import contextlib
import dataclasses
import statistics

import torch

from benchmark import work
from benchmark.harness import Check, device_generator, free_cuda, ints, kept_leaves, leaf_gaps
from benchmark.reference.diffusion import Tables
from benchmark.reference.layers import Precision
from benchmark.reference.mm_unet import MMConfig, MMUNet
from benchmark.reference.train import leaf_norms, train_steps
from benchmark.weights import derive_seed, load_seeded_

UNIT = "steps"
B1 = 0.9  # AdamW's first-moment decay: after one step the moment is (1 - B1) g


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.flags = config["model"]
        self.hyper = config["train"]
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.batch = int(traffic["batch"])
        self.check_steps = int(traffic["check_steps"])
        self.steps_done = 0
        self.readings = {"loss": []}

    def setup(self) -> None:
        from mm_diffusion_tpu_torch import configs
        from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
        from mm_diffusion_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step

        cfg = dataclasses.replace(configs.create_model_config(**self.flags),
                                  use_checkpoint=bool(self.hyper["use_checkpoint"]))
        with torch.device(self.device):
            model = MultimodalUNet(cfg)
        model = load_seeded_(model.train(), self.seed)
        torch.manual_seed(derive_seed(self.seed, "train-dropout"))  # the masks, on every device
        self.rate = float(self.hyper["ema_rate"])
        self.state = create_train_state(model, make_optimizer(model, lr=float(self.hyper["lr"])),
                                        ema_rates=(self.rate,))
        diffusion = configs.create_gaussian_diffusion(steps=1000, noise_schedule="linear").to(self.device)
        self.shift_gen = torch.Generator().manual_seed(derive_seed(self.seed, "train-shift"))
        self.step_fn = make_train_step(diffusion, shift=self.shift_gen)
        self.pool = self.make_pool()
        self.shift_states = []
        params = dict(model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in params.items()}
        for k in range(self.check_steps):
            self.shift_states.append(self.shift_gen.get_state())
            with self.no_dropout():
                loss = self.call_metrics()["loss"]
            self.readings["loss"].append(float(loss))
            if k == 0:
                moments = self.state.optimizer.opt.state
                self.readings["grad"] = leaf_norms(  # a parameter AdamW holds no moment of has none
                    {n: moments.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1 - B1)
                     for n, p in params.items()})
        ema = self.state.ema[next(iter(self.state.ema))]
        self.readings["update"] = leaf_norms({n: p.detach() - p0[n] for n, p in params.items()})
        self.readings["ema"] = leaf_norms({n: ema[n] - p0[n] for n in params})
        del p0
        free_cuda()

    def make_pool(self):
        """The pool of batches, clips uniform in [-1, 1], on the device."""
        g = device_generator(self.device, self.seed, "train-pool")
        f, c, h, w = ints(self.flags["video_size"])
        ca, length = ints(self.flags["audio_size"])
        n = int(self.traffic["pool"])
        video = torch.rand(n, self.batch, f, h, w, c, generator=g, device=self.device) * 2 - 1
        audio = torch.rand(n, self.batch, length, ca, generator=g, device=self.device) * 2 - 1
        return [{"video": video[i], "audio": audio[i]} for i in range(n)]

    def feed(self, k: int, pool=None):
        """Step ``k``'s batch, timesteps (host) and noise (device)."""
        batch = (pool or self.pool)[k % int(self.traffic["pool"])]
        t = torch.randint(0, 1000, (self.batch,),
                          generator=torch.Generator().manual_seed(derive_seed(self.seed, "train-t", k)))
        g = device_generator(self.device, self.seed, "train-noise", k)
        noise = {n: torch.randn(x.shape, generator=g, device=self.device) for n, x in batch.items()}
        return batch, t, noise

    @contextlib.contextmanager
    def no_dropout(self):
        """Dropout's probability set to 0 on the model's own modules."""
        mods = [m for m in self.state.model.modules() if isinstance(m, torch.nn.Dropout)]
        saved = [m.p for m in mods]
        for m in mods:
            m.p = 0.0
        try:
            yield
        finally:
            for m, p in zip(mods, saved):
                m.p = p

    def window_step(self) -> None:
        """One step through the window's call from the state the window
        left, dropout off; keeps that state (parameters, moments, the
        optimizer's count) for the reference and the step's readings."""
        params = dict(self.state.model.named_parameters())
        opt_state = self.state.optimizer.opt.state
        moment = lambda p, key: opt_state.get(p, {}).get(key, torch.zeros_like(p))  # noqa: E731
        self.resume = {
            "k": self.steps_done,
            "shift": self.shift_gen.get_state(),
            "step": int(float(opt_state[next(iter(opt_state))]["step"])) if opt_state else 0,
            "params": {n: p.detach().clone() for n, p in params.items()},
            "m": {n: moment(p, "exp_avg").detach().clone() for n, p in params.items()},
            "v": {n: moment(p, "exp_avg_sq").detach().clone() for n, p in params.items()},
        }
        with self.no_dropout():
            loss = self.call_metrics()["loss"]
        r = self.resume
        self.readings["window"] = {
            "loss": [float(loss)],
            "grad": leaf_norms({n: (moment(p, "exp_avg") - B1 * r["m"][n]) / (1 - B1)
                                for n, p in params.items()}),
            "update": leaf_norms({n: p.detach() - r["params"][n] for n, p in params.items()}),
        }

    def call_metrics(self):
        batch, t, noise = self.feed(self.steps_done)
        self.steps_done += 1
        return self.step_fn(self.state, batch, t=t, noise=noise)

    def call(self) -> int:
        self.call_metrics()
        return 1

    def work(self):
        """(model FLOPs per step: three forwards, the recompute not counted;
        attention bound seconds per step, forward and backward)."""
        flops, sites = work.mm_eval_work(self.flags, self.batch)
        return 3 * flops, work.attention_bound_s(sites, backward=True)

    def release(self) -> None:
        self.window_step()
        del self.state, self.step_fn, self.pool
        free_cuda()

    def reference(self, precision: str = "float32", rows=None):
        """The reference's readings of the first ``check_steps`` steps and,
        under ``"window"``, of the step after the window from the state
        the program had reached; ``rows`` keeps only those rows of each
        batch (a fault: part of the batch left out, the mean taken over
        the rest)."""
        pool = self.make_pool()

        def feeds(ks):
            batches, ts, noises = [], [], []
            for k in ks:
                batch, t, noise = self.feed(k, pool)
                if rows is not None:
                    batch = {m: x[rows] for m, x in batch.items()}
                    noise = {m: x[rows] for m, x in noise.items()}
                    t = t[rows]
                batches.append(batch)
                ts.append(t.to(self.device))
                noises.append(noise)
            return batches, ts, noises

        first, window = feeds(range(self.check_steps)), feeds([self.resume["k"]])
        del pool
        hyper = dict(lr=float(self.hyper["lr"]), ema_rate=float(self.hyper["ema_rate"]))
        tables = Tables(1000, device=self.device)

        def plain():
            with torch.device(self.device):
                return load_seeded_(MMUNet(MMConfig.from_flags(self.flags), Precision(precision)), self.seed)

        out = train_steps(plain(), tables, *first, self.shift_states, **hyper)
        model = plain()
        r = self.resume
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(r["params"][n])
        w = train_steps(model, tables, *window, [r["shift"]], moments=(r["m"], r["v"]),
                        first_step=r["step"] + 1, **hyper)
        out["window"] = {k: w[k] for k in ("loss", "grad", "update")}
        return out

    def numbers(self, candidate: str = "program") -> dict:
        """The compared numbers with the program's readings, or in their
        place the reference computed in ``candidate``'s precision (the
        control, "fp8"), or the reference over the first half of each
        batch alone ("half": a fault that leaves rows out).  Of the kept
        leaves' gaps of norms (a leaf is kept where its reference gradient
        is at least a thousandth of the median leaf's): the 90th
        percentile's for the first gradient (``grad_gap``), and the worst
        leaf's for the parameters' and the EMA's change over the first
        steps (``update_gap``, ``ema_gap``) and for the parameters' change
        in the step after the window (``window_update_gap``).

        Not the worst leaf for the first gradient:
        ``audio_out.2.audio_conv.bias`` is one number summed over 25600
        positions whose terms cancel, and reads up to 0.13 in sound runs.
        Not compared: the gradient of the step after the window, whose
        90th-percentile leaf reads 0.003-0.031 in sound runs from seed to
        seed, against 0.0995 at the least for the control; and the loss,
        which neither the control nor a fault reads three times above.
        Both, and every statistic of each number with its worst leaf's
        name, are kept in ``info``."""
        if getattr(self, "ref", None) is None:
            self.ref = self.reference()
        ref = self.ref
        if candidate == "program":
            got = self.readings
        elif candidate == "half":
            got = self.reference(rows=slice(0, self.batch // 2))
        else:
            got = self.reference(candidate)
        keep = kept_leaves(ref["grad"])
        keep_w = kept_leaves(ref["window"]["grad"])
        gaps = {
            "grad_gap": leaf_gaps(got["grad"], ref["grad"], keep),
            "update_gap": leaf_gaps(got["update"], ref["update"], keep),
            "ema_gap": leaf_gaps(got["ema"], ref["ema"], keep),
            "window_grad_gap": leaf_gaps(got["window"]["grad"], ref["window"]["grad"], keep_w),
            "window_update_gap": leaf_gaps(got["window"]["update"], ref["window"]["update"], keep_w),
        }
        self.info = {n: {"worst": max(g.items(), key=lambda kv: kv[1]),
                         "p90": statistics.quantiles(g.values(), n=10)[-1],
                         "median": statistics.median(g.values())} for n, g in gaps.items()}
        self.info["left_out"] = sorted(set(ref["grad"]) - set(keep)) + sorted(
            f"window:{k}" for k in set(ref["window"]["grad"]) - set(keep_w))
        self.info["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
        self.info["window_loss_gap"] = abs(got["window"]["loss"][0] - ref["window"]["loss"][0]) / abs(
            ref["window"]["loss"][0])
        return {"grad_gap": self.info["grad_gap"]["p90"],
                "update_gap": self.info["update_gap"]["worst"][1],
                "ema_gap": self.info["ema_gap"]["worst"][1],
                "window_update_gap": self.info["window_update_gap"]["worst"][1]}

    def check(self, limits: dict):
        return [Check(n, v, limits[n]) for n, v in self.numbers().items()]

"""The train state and the train step (counterpart of
``mm_diffusion_tpu/train/state.py``).

* Parameters and the AdamW moments are fp32; the model computes in its
  config's dtype (bf16 with ``use_fp16``), casting each weight where it is
  used, so gradients arrive in fp32.  There is no loss scale: bf16 keeps
  fp32's exponent range.
* Gradient accumulation runs the microbatches one after another, summing
  their gradients in the parameters' ``.grad``.
* EMA is one fp32 copy of the parameters per rate, updated in place.
* The schedule sampler lives on the host and is updated from each step's
  per-example losses.
* On several ranks (``parallel/``) each rank runs its rows of the global
  batch: timesteps and noise are drawn for the global batch from
  generators seeded alike on every rank and sliced by rank, so a step on
  W ranks computes the one-process step on the global batch.  Under FSDP
  the EMA copies and Adam moments are sharded like the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..diffusion.gaussian import GaussianDiffusion, State, tree_map
from ..parallel.mesh import (
    ParallelModel,
    all_gather_rows,
    all_reduce_sum_,
    copy_full_,
    full_tensor,
    is_dtensor,
    like_placement,
    local,
    rank_rows,
)
from ..utils import tracing
from .resample import UniformSampler

Shift = Union[None, int, torch.Generator]


class AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay),
    optionally after ``optax.clip_by_global_norm``, with the reference's
    linear learning-rate anneal to 0 over ``lr_anneal_steps``.

    Under FSDP the sharded parameters (DTensors) and the replicated ones
    are two parameter groups, because torch's multi-tensor AdamW cannot mix
    the two kinds in one group; :meth:`state_dict` writes the one-group
    format of a one-process run all the same."""

    def __init__(
        self,
        params,
        lr: float,
        weight_decay: float = 0.0,
        lr_anneal_steps: int = 0,
        grad_clip: float = 0.0,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr
        self.lr_anneal_steps = lr_anneal_steps
        self.grad_clip = grad_clip
        groups = [[p for p in self.params if is_dtensor(p)], [p for p in self.params if not is_dtensor(p)]]
        self.opt = torch.optim.AdamW(
            [{"params": g} for g in groups if g], lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )

    def lr_at(self, step: int) -> float:
        if not self.lr_anneal_steps:
            return self.lr
        return self.lr * max(0.0, 1.0 - step / self.lr_anneal_steps)

    def step(self, step: int, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update with the learning rate of optimizer step ``step``
        (0 for the first); ``grad_norm`` is the gradients' global norm when
        the caller has it."""
        if self.grad_clip > 0:
            if grad_norm is None:
                grad_norm = global_norm([p.grad for p in self.params])
            scale = torch.where(grad_norm < self.grad_clip, 1.0, self.grad_clip / grad_norm)
            torch._foreach_mul_([local(p.grad) for p in self.params], scale)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(step)
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def _order(self):
        """Index in ``self.params`` of each parameter in torch's numbering
        (the groups one after another)."""
        index = {id(p): i for i, p in enumerate(self.params)}
        return [index[id(p)] for g in self.opt.param_groups for p in g["params"]]

    def state_dict(self):
        """``torch.optim.AdamW``'s state_dict over one group holding
        ``self.params`` in order, every tensor whole and on the host
        (gathered from its shards under FSDP: every rank calls it)."""
        sd = self.opt.state_dict()
        order = self._order()
        state = {
            order[k]: {n: full_tensor(v).cpu() for n, v in st.items()}
            for k, st in sd["state"].items()
        }
        group = {**sd["param_groups"][0], "params": list(range(len(self.params)))}
        return {"state": dict(sorted(state.items())), "param_groups": [group]}

    def load_state_dict(self, state) -> None:
        """Load :meth:`state_dict`'s format, each moment onto its parameter's
        placement."""
        groups = state["param_groups"]
        if len(groups) != 1 or len(groups[0]["params"]) != len(self.params):
            raise ValueError(
                f"optimizer state for {[len(g['params']) for g in groups]} parameters, "
                f"this model has {len(self.params)}"
            )
        hyper = {k: v for k, v in groups[0].items() if k != "params"}
        by_param = {p: state["state"].get(i) for i, p in enumerate(self.params)}
        torch_state, torch_groups, k = {}, [], 0
        for g in self.opt.param_groups:
            torch_groups.append({**hyper, "params": list(range(k, k + len(g["params"])))})
            for p in g["params"]:
                if by_param[p] is not None:
                    torch_state[k] = {
                        n: v if n == "step" else like_placement(v, p) for n, v in by_param[p].items()
                    }
                k += 1
        self.opt.load_state_dict({"state": torch_state, "param_groups": torch_groups})


def make_optimizer(
    model: nn.Module,
    lr: float,
    weight_decay: float = 0.0,
    lr_anneal_steps: int = 0,
    grad_clip: float = 0.0,
) -> AdamW:
    return AdamW(model.parameters(), lr, weight_decay, lr_anneal_steps, grad_clip)


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of fp32 tensors taken together (one multi-tensor kernel
    per chunk of tensors, not one reduction per tensor).  FSDP's DTensor
    shards count once: their squared sums are summed over the mesh dims
    they are sharded on, so every rank gets the global norm."""
    tensors = list(tensors)
    shards = [x for x in tensors if is_dtensor(x)]
    if not shards:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    sq = torch.stack(torch._foreach_norm([local(x) for x in shards])).square().sum()
    mesh = shards[0].device_mesh
    for dim, placement in enumerate(shards[0].placements):
        if placement.is_shard():
            all_reduce_sum_(sq, group=mesh.get_group(dim))
    plain = [x for x in tensors if not is_dtensor(x)]
    if plain:
        sq = sq + torch.stack(torch._foreach_norm(plain)).square().sum()
    return sq.sqrt()


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module  # fp32 parameters
    optimizer: AdamW
    ema: Dict[str, Dict[str, torch.Tensor]]  # rate string -> parameter name -> fp32 copy
    sampler: UniformSampler
    parallel: ParallelModel  # the module the step calls, the rank and world

    def state_dict(self):
        """The whole state, every tensor whole and on the host (gathered
        from its shards under FSDP: every rank calls it)."""
        host = lambda x: full_tensor(x).detach().cpu()  # noqa: E731
        return {
            "step": self.step,
            "model": {k: host(v) for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "ema": {r: {n: host(x) for n, x in e.items()} for r, e in self.ema.items()},
            "sampler": self.sampler.state_dict(),
        }

    def load_state_dict(self, state) -> None:
        """Load a whole state (:meth:`state_dict`'s), each tensor into this
        rank's part of its counterpart."""
        self.step = int(state["step"])
        own = self.model.state_dict(keep_vars=True)
        if set(own) != set(state["model"]):
            raise KeyError(
                f"checkpoint model keys differ: missing {sorted(set(own) - set(state['model']))}, "
                f"unexpected {sorted(set(state['model']) - set(own))}"
            )
        for name, x in own.items():
            copy_full_(x, state["model"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        if set(state["ema"]) != set(self.ema):
            raise ValueError(f"checkpoint EMA rates {sorted(state['ema'])} != {sorted(self.ema)}")
        for rate, tensors in self.ema.items():
            for name, x in tensors.items():
                copy_full_(x, state["ema"][rate][name])
        self.sampler.load_state_dict(state["sampler"])


def create_train_state(
    model: nn.Module,
    optimizer: AdamW,
    ema_rates: Sequence[float] = (0.9999,),
    sampler: Optional[UniformSampler] = None,
    num_timesteps: int = 1000,
    parallel: Optional[ParallelModel] = None,
) -> TrainState:
    """The state of a model on one process, or on a mesh through
    ``parallel`` (a :class:`ParallelModel` of the same model, built before
    ``optimizer``)."""
    ema = {
        str(r): {n: p.detach().clone() for n, p in model.named_parameters()} for r in ema_rates
    }
    return TrainState(0, model, optimizer, ema, sampler or UniformSampler(num_timesteps),
                      parallel or ParallelModel(model))


def ema_params(state: TrainState, rate: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The EMA copy of one rate (the first by default), by parameter name."""
    return state.ema[rate or next(iter(state.ema))]


def quartile_metrics(name: str, t: torch.Tensor, values: torch.Tensor, num_timesteps: int):
    """Mean of ``values`` per timestep quartile, ``{name}_q0`` .. ``_q3``."""
    quartile = (4 * t) // num_timesteps
    out = {}
    for q in range(4):
        mask = (quartile == q).float()
        out[f"{name}_q{q}"] = (values * mask).sum() / mask.sum().clamp(min=1.0)
    return out


def mm_model_fn(model: nn.Module, shift: Shift):
    """The MM-UNet as the diffusion's ``model_fn(x, t_model)`` on
    ``{"video", "audio"}`` states."""

    def model_fn(x: State, t_model: torch.Tensor) -> State:
        v, a = model(x["video"], x["audio"], t_model, shift=shift)
        return {"video": v, "audio": a}

    return model_fn


Adapter = Callable[[nn.Module, State], Tuple[State, Callable]]


def multimodal_adapter(shift: Shift = None) -> Adapter:
    """The default adapter: a joint ``{"video", "audio"}`` batch is the
    diffusion target of the MM-UNet, run at RS-MMA shift ``shift``."""

    def adapt(model: nn.Module, batch: State):
        return batch, mm_model_fn(model, shift)

    return adapt


def _to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor onto ``device`` without waiting for the card (pinned,
    non-blocking copy)."""
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _first_leaf(x: State) -> torch.Tensor:
    return next(iter(x.values())) if isinstance(x, dict) else x


def make_train_step(
    diffusion: GaussianDiffusion,
    accum_steps: int = 1,
    shift: Shift = None,
    adapter: Optional[Adapter] = None,
):
    """Build ``train_step(state, batch, ...) -> metrics``.

    ``adapter(model, batch) -> (x_start, model_fn)`` maps a batch (a dict
    of tensors on the model's device) to the diffusion target (a tensor or
    a dict of tensors) and the model as the diffusion's ``model_fn(x,
    t_model)``; the default is :func:`multimodal_adapter` at ``shift`` (the
    MM-UNet's RS-MMA shift argument, a host generator in training).  Each
    call draws timesteps from the state's sampler (host generator
    ``t_generator``) and noise of the target's shape from
    ``noise_generator`` (on the batch's device), unless ``t`` / ``noise``
    are given.  The gradient of the importance-weighted mean loss is
    averaged over ``accum_steps`` microbatches, then one AdamW step, the
    EMA update and the sampler update follow.  Metrics stay device tensors
    (no sync).

    On a mesh (``state.parallel``) ``batch`` is this rank's rows; ``t``
    and ``noise``, drawn or given, are the global batch's (world x the
    local batch rows), of which the rank takes its own (``rank_rows``).
    The loss, its quartiles and the sampler update are the global batch's
    (per-example losses all-gathered), the same on every rank.

    The step is span ``train.step`` (id ``state.step``), around
    ``train.forward`` and ``train.backward`` of each microbatch,
    ``train.optimizer`` (the global norm and AdamW) and ``train.ema``
    (``utils/tracing.py``; off by default).
    """
    adapter = adapter or multimodal_adapter(shift)

    def train_step(
        state: TrainState,
        batch: State,
        t_generator: Optional[torch.Generator] = None,
        noise_generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[State] = None,
    ) -> Dict[str, torch.Tensor]:
        with tracing.span("train.step", state.step):
            par = state.parallel
            rank, world = par.rank, par.world
            model = par.module
            x_all, _ = adapter(model, batch)
            leaf = _first_leaf(x_all)
            b, device = leaf.shape[0], leaf.device
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
            rows = b * world
            if t is None:
                t, weights = state.sampler.sample(rows, generator=t_generator)
            else:
                t, weights = t.cpu(), torch.ones(rows)
            if t.shape[0] != rows:
                raise ValueError(f"t has {t.shape[0]} rows, the global batch {rows}")
            t_host = t
            t_mine = _to_device(rank_rows(t, rank, world), device)
            weights = _to_device(rank_rows(weights, rank, world), device)
            if noise is None:
                noise = tree_map(
                    lambda x: torch.randn((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                                          device=x.device, generator=noise_generator),
                    x_all,
                )
            noise = tree_map(lambda x: rank_rows(x, rank, world).to(device), noise)

            state.optimizer.zero_grad()
            micro = b // accum_steps
            losses, flat = [], []
            for i in range(accum_steps):
                sl = slice(i * micro, (i + 1) * micro)
                with par.gradient_sync(i == accum_steps - 1):
                    with tracing.span("train.forward"):
                        x_start, model_fn = adapter(model, {k: v[sl] for k, v in batch.items()})
                        terms = diffusion.training_losses(
                            model_fn, x_start, t_mine[sl], noise=tree_map(lambda x: x[sl], noise),
                        )
                        loss = (terms["loss"] * weights[sl]).mean()
                    with tracing.span("train.backward"):
                        (loss / accum_steps).backward()
                losses.append(loss.detach())
                flat.append(terms["loss"].detach())
            par.reduce_gradients()
            flat_loss = torch.cat(flat)
            loss = torch.stack(losses).mean()
            if world > 1:
                flat_loss = all_gather_rows(flat_loss)
                loss = all_gather_rows(loss.reshape(1)).mean()

            params = state.optimizer.params
            with tracing.span("train.optimizer"):
                grad_norm = global_norm([p.grad for p in params])
                state.optimizer.step(state.step, grad_norm)
            with torch.no_grad(), tracing.span("train.ema"):
                names_params = dict(state.model.named_parameters())
                for rate, ema in state.ema.items():
                    r = float(rate)
                    tensors = [local(x) for x in ema.values()]
                    torch._foreach_mul_(tensors, r)
                    torch._foreach_add_(tensors, [local(names_params[n]) for n in ema],
                                        alpha=1.0 - r)
            state.sampler.update(t_host, flat_loss)

            metrics = {
                "loss": loss,
                "grad_norm": grad_norm,
                "param_norm": global_norm([p.detach() for p in params]),
                "lr_step": torch.tensor(float(state.step)),
            }
            t_all = t_mine if world == 1 else _to_device(t_host, device)
            metrics.update(quartile_metrics("loss", t_all, flat_loss, diffusion.num_timesteps))
            state.step += 1
            return metrics

    return train_step

"""The reference's train steps of the MM-UNet: the epsilon-MSE loss at the
given timesteps and noise, the gradient by autograd through the plain
model, ``torch.optim.AdamW``'s update written out (b1 0.9, b2 0.999, eps
1e-8, no weight decay), and the EMA of the parameters.  The steps start
from the model's parameters with zero moments, or from given moments at a
given optimizer step (one step from a state a run has reached).

The batch runs in blocks of rows, each block's gradient summed into the
batch mean: the model normalises per example, so a block of rows computes
what the whole batch computes, in a fraction of its memory.  Each block
replays the step's RS-MMA shifts from the same generator state."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .diffusion import Tables, mse_loss


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each leaf; a packed ``[q | k | v]`` bias (``*qkv.bias``)
    counts as its three thirds, ``<name>[q]``, ``[k]`` and ``[v]``: a key's
    bias adds one number to every score of a query, which the softmax
    takes away, so its gradient is nought but for rounding."""
    out = {}
    for k, v in tensors.items():
        parts = zip("qkv", v.chunk(3)) if k.endswith("qkv.bias") else ((None, v),)
        for part, x in parts:
            out[k if part is None else f"{k}[{part}]"] = float(torch.linalg.vector_norm(x.float()))
    return out


def train_steps(model, tables: Tables, batches: List[Dict[str, torch.Tensor]], ts: List[torch.Tensor],
                noises: List[Dict[str, torch.Tensor]], shift_states: List[torch.Tensor],
                lr: float, ema_rate: float, rows_per_block: int = 1,
                moments: Optional[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]] = None,
                first_step: int = 1):
    """Run ``len(batches)`` steps from ``model``'s parameters.  Returns
    ``{"loss": [per step], "grad": {leaf: norm of step 1's gradient},
    "update": {leaf: norm of p_n - p_0}, "ema": {leaf: norm of ema_n -
    p_0}}``; ``shift_states[k]`` is the host generator state before step
    ``k``'s forward.  ``moments`` (first and second, by leaf) and
    ``first_step`` (the optimizer's count at the first of these steps)
    resume AdamW where a run left it."""
    params = dict(model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in params.items()}
    if moments is None:
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
    else:
        m, v = ({k: x[k].clone() for k in params} for x in moments)
    ema = {k: p.detach().clone() for k, p in params.items()}
    gen = torch.Generator()
    out = {"loss": []}
    for k, (batch, t, noise) in enumerate(zip(batches, ts, noises)):
        for p in params.values():
            p.grad = None
        b = t.shape[0]
        total = 0.0
        for r in range(0, b, rows_per_block):
            rows = slice(r, r + rows_per_block)
            gen.set_state(shift_states[k])

            def model_fn(x, t_model):
                vo, ao = model(x["video"], x["audio"], t_model, gen)
                return {"video": vo, "audio": ao}

            losses = mse_loss(tables, model_fn, {n: x[rows] for n, x in batch.items()}, t[rows],
                              {n: x[rows] for n, x in noise.items()})
            (losses.sum() / b).backward()
            total += float(losses.detach().sum())
        out["loss"].append(total / b)
        if k == 0:
            out["grad"] = leaf_norms({n: p.grad for n, p in params.items()})
        step = first_step + k
        with torch.no_grad():
            for n, p in params.items():
                g = p.grad
                m[n].mul_(0.9).add_(g, alpha=0.1)
                v[n].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (v[n].sqrt() / (1 - 0.999 ** step) ** 0.5).add_(1e-8)
                p.addcdiv_(m[n], denom, value=-lr / (1 - 0.9 ** step))
                ema[n].mul_(ema_rate).add_(p, alpha=1.0 - ema_rate)
    out["update"] = leaf_norms({n: params[n].detach() - p0[n] for n in params})
    out["ema"] = leaf_norms({n: ema[n] - p0[n] for n in params})
    return out

"""What the evaluation networks share: reading the original ``.pt``
checkpoints into the port's modules, and the fp32 scope they run in."""

from __future__ import annotations

import contextlib
import pickle
from typing import Dict

import torch
from torch import nn


def read_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` state_dict (also one under ``"state_dict"``, or a
    TorchScript archive's) as ``{key: tensor}``."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError):  # a TorchScript archive (OpenAI CLIP's .pt)
        sd = torch.jit.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_weights(module: nn.Module, state_dict: Dict[str, torch.Tensor], prefix: str = "") -> nn.Module:
    """Load the keys under ``prefix`` into ``module`` by the original
    repo's names.  Keys the module does not hold (the rest of a full
    AudioCLIP, the original's unused buffers) are left; a key the module
    needs and the checkpoint lacks is an error (BatchNorm's
    ``num_batches_tracked``, which nothing reads in eval, excepted)."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    missing = module.load_state_dict(sd, strict=False).missing_keys
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys under {prefix!r}: {missing[:5]}")
    return module.eval().requires_grad_(False)


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device.  CUDA divides a
    tensor by a Python scalar as a multiplication by its reciprocal (a bit
    less exact), the CPU divides; where a subtraction cancels after the
    division (the int16 scaling of [-1, 1] audio keeps ~1e-5 of 1.0), that
    last bit becomes a 1e-3 difference between the card and the CPU.  A
    divisor tensor on ``x``'s device takes the true division on both."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def fp32_precision():
    """The evaluation networks run in fp32 with TF32 off, as the JAX package
    evaluates in fp32: cuDNN's and cuBLAS's TF32 would move FVD / FAD.  The
    previous settings come back on exit.  A ``with`` block, or a decorator
    (``@fp32_precision()``) of the evaluation's entry points."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn

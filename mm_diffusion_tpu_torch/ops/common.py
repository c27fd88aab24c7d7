"""What the kernel modules share: the dispatch between a kernel and its
plain version, and the rule that holds a kernel to its plain version."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def kernel_path(x: torch.Tensor) -> str:
    """``"cuda"`` (launch the kernel) or ``"cpu"`` (the plain version), by
    the device of ``x``; any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel path for device {x.device}")
    return x.device.type


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """``|kernel - plain| <= atol + rtol * |plain|`` elementwise.  With
    ``scaled``, ``atol`` is relative to ``max |plain|``: for outputs whose
    rounding error follows the largest terms of a sum, not each element."""

    atol: float
    rtol: float
    scaled: bool = False

    def check(self, out: torch.Tensor, ref: torch.Tensor) -> Tuple[float, bool]:
        """``(max |out - ref|, whether every element is within the limit)``."""
        ref = ref.float()
        diff = (out.float() - ref).abs()
        atol = self.atol * ref.abs().max() if self.scaled else self.atol
        return diff.max().item(), bool((diff <= atol + self.rtol * ref.abs()).all())

    def __str__(self) -> str:
        scale = "*max|plain|" if self.scaled else ""
        return f"|err| <= {self.atol}{scale} + {self.rtol}*|plain|"

"""Process-group bootstrap (counterpart of ``mm_diffusion_tpu/parallel/
bootstrap.py``): one process per GPU under ``torchrun``.

``torchrun --nproc_per_node N`` starts N copies of a CLI with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in
their environment; :func:`setup_dist` turns them into the default
``torch.distributed`` process group (NCCL for CUDA, gloo for the CPU) and
pins the rank to its card.  Without a launcher it does nothing, as the JAX
package's ``setup_dist`` does on a single host.

NCCL refuses two ranks on one card, so a CUDA launch needs a card for
each process of a node.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

def resolve_device(name) -> torch.device:
    """``name`` as a device; a CUDA device must exist (no silent CPU run)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (pass --device cpu to run on the CPU)")
    return device


def launched() -> bool:
    """True when a launcher set this process's rank: ``WORLD_SIZE`` above 1,
    or ``WORLD_SIZE`` with a rendezvous address (``torchrun
    --nproc_per_node 1``)."""
    world = os.environ.get("WORLD_SIZE")
    return world is not None and (int(world) > 1 or "MASTER_ADDR" in os.environ)


def setup_dist(device="cuda", timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Join the launcher's process group and return this rank's device.

    ``device`` is the CLI's ``--device``: ``cuda`` pins the rank to
    ``cuda:LOCAL_RANK`` and joins on NCCL, ``cpu`` joins on gloo.  Without a
    launcher, or when the group exists already, nothing is joined and the
    device is returned as given (``cuda`` as ``cuda:0``'s current device).
    A rendezvous that fails raises: it never falls back to one process,
    which would train on 1/N of the data.
    """
    device = resolve_device(device)
    if dist.is_initialized() or not launched():
        return device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            raise ValueError(
                f"LOCAL_RANK {local_rank} has no card of its own ({cards} visible): launch at most "
                f"{cards} processes per node (torchrun --nproc_per_node {cards})"
            )
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, **kwargs)
    atexit.register(_destroy)
    return device


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def refuse_launcher(name: str) -> None:
    """Raise under a multi-process launcher: ``name`` runs in one process,
    and N copies would only repeat one another."""
    if launched():
        raise ValueError(f"{name} runs in one process; launch it without torchrun")


def device_info() -> str:
    if not dist.is_initialized():
        return "process 0/1 (no process group)"
    dev = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "host"
    return f"process {dist.get_rank()}/{dist.get_world_size()} on {dist.get_backend()}, {dev}"

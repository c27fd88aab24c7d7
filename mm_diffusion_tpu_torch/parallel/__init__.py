"""Multi-GPU training and sampling on ``torch.distributed`` (counterpart of
``mm_diffusion_tpu/parallel``): one process per GPU under ``torchrun``,
DDP, FSDP2 over a ``(data, fsdp)`` mesh, batch rows by rank."""

from .bootstrap import device_info, setup_dist
from .mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    ParallelModel,
    all_gather_rows,
    is_fsdp_sharded,
    make_mesh,
    param_spec,
    process_data_shard,
    rank_rows,
)

__all__ = [
    "device_info",
    "setup_dist",
    "DATA_AXIS",
    "FSDP_AXIS",
    "ParallelModel",
    "all_gather_rows",
    "is_fsdp_sharded",
    "make_mesh",
    "param_spec",
    "process_data_shard",
    "rank_rows",
]

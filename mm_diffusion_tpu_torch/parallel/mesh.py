"""The ``(data, fsdp)`` device mesh, the FSDP placement rule, and the
model's data-parallel wrapping (counterpart of ``mm_diffusion_tpu/parallel/
mesh.py``).

One process per device.  Ranks are laid out on the mesh data-major (rank
``d * n_fsdp + f``), so a rank's place in the global batch is its rank:
every rank reads its own rows, over ``data`` and ``fsdp`` jointly, as the
JAX package shards a batch over both axes.

* ``n_fsdp == 1``: the model is replicated and wrapped in DDP (gradients
  all-reduced over the world).
* ``n_fsdp > 1``: FSDP2 (``fully_shard``) over the mesh -- parameters,
  gradients, Adam moments and EMA sharded ZeRO-3 style over ``fsdp`` and
  replicated over ``data`` -- by the JAX package's placement rule
  (:func:`param_spec`): a parameter of at least ``min_size`` elements is
  sharded on its largest dim that ``n_fsdp`` divides, every other one is
  replicated, outside FSDP, and its gradient all-reduced here.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def process_data_shard() -> Tuple[int, int]:
    """``(shard, num_shards)`` of this process for the data loaders: its rank
    and the world size when a process group exists, else ``(0, 1)`` (the
    counterpart of the reference's ``[rank::num_ranks]`` slicing)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rows ``[rank * B, (rank + 1) * B)`` of a global batch of ``world * B``
    rows: this rank's part, in the order of ``shard_batch``'s contiguous
    rows in the JAX package."""
    if x.shape[0] % world:
        raise ValueError(f"global batch {x.shape[0]} does not split over {world} ranks")
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def make_mesh(n_data: Optional[int] = None, n_fsdp: int = 1, device_type: str = "cuda"):
    """A 2-D ``(data, fsdp)`` DeviceMesh over the world; ``n_data=None`` takes
    the world size over ``n_fsdp``.  Without a process group the only mesh
    is one process, returned as ``None``."""
    if n_fsdp < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh {n_data}x{n_fsdp}: sizes must be positive")
    if not dist.is_initialized():
        if n_fsdp > 1 or (n_data or 1) > 1:
            raise ValueError(
                f"a {n_data or '?'}x{n_fsdp} (data, fsdp) mesh needs one process per device: launch "
                f"with torchrun --nproc_per_node N (N divisible by n_fsdp={n_fsdp})"
            )
        return None
    world = dist.get_world_size()
    if n_data is None:
        if world % n_fsdp:
            raise ValueError(f"n_fsdp={n_fsdp} must divide the world size ({world} processes)")
        n_data = world // n_fsdp
    if n_data * n_fsdp != world:
        raise ValueError(f"mesh {n_data}x{n_fsdp} needs {n_data * n_fsdp} processes, the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_data, n_fsdp), mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def param_spec(shape: Sequence[int], fsdp_size: int, min_size_to_shard: int = 2**18) -> Optional[int]:
    """The FSDP rule: the dim to shard a parameter of ``shape`` on over the
    fsdp axis -- its largest dim divisible by ``fsdp_size`` (the first of
    equals) -- or None to replicate it (fewer than ``min_size_to_shard``
    elements, or no divisible dim)."""
    numel = 1
    for d in shape:
        numel *= d
    if fsdp_size <= 1 or numel < min_size_to_shard:
        return None
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if d % fsdp_size == 0 and d > best_dim:
            best, best_dim = i, d
    return best


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def is_fsdp_sharded(model: nn.Module) -> bool:
    """True if any parameter of ``model`` is a DTensor sharded over a mesh
    dim (the proof that ZeRO-3 is live)."""
    return any(is_dtensor(p) and any(pl.is_shard() for pl in p.placements) for p in model.parameters())


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view), any other tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor gathered from its shards over the mesh
    dims it is sharded on (a collective: every rank calls it), any other
    tensor itself.  Gloo gathers on the host: its DTensor gather of CUDA
    shards (``DTensor.full_tensor``) crashes the process on the H100."""
    if not is_dtensor(x):
        return x
    mesh, out = x.device_mesh, x.detach().to_local()
    for mesh_dim in reversed(range(mesh.ndim)):
        placement = x.placements[mesh_dim]
        if placement.is_shard():
            group = mesh.get_group(mesh_dim)
            wire = _wire(out.contiguous(), group)
            parts = [torch.empty_like(wire) for _ in range(mesh.size(mesh_dim))]
            dist.all_gather(parts, wire, group=group)
            out = torch.cat(parts, dim=placement.dim).to(x.device)
    return out


def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` in the placement of ``like`` (the whole
    of it when ``like`` is not a DTensor); no communication."""
    if not is_dtensor(like):
        return full
    mesh = like.device_mesh
    for mesh_dim, placement in enumerate(like.placements):
        if placement.is_shard():
            full = full.chunk(mesh.size(mesh_dim), dim=placement.dim)[mesh.get_local_rank(mesh_dim)]
    return full


def copy_full_(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a whole tensor into ``dst``, a DTensor taking its own part."""
    with torch.no_grad():
        local(dst).copy_(local_part(full, dst))


def like_placement(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` as a tensor placed as ``like``: a DTensor on ``like``'s mesh
    holding this rank's part, or ``full`` itself."""
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import DTensor

    part = local_part(full, like).to(like.device).contiguous()
    return DTensor.from_local(part, like.device_mesh, like.placements, run_check=False)


def _wire(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` where the group's backend takes it: NCCL on the card, gloo on
    the host (a CUDA tensor goes through a host copy)."""
    return x if dist.get_backend(group) == "nccl" else x.cpu()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape on all ranks) concatenated along dim 0
    in rank order, on every rank of the default group."""
    src = _wire(x.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


def all_reduce_sum_(x: torch.Tensor, group=None) -> None:
    """Sum ``x`` over ``group`` (the world by default) in place."""
    wire = _wire(x, group)
    dist.all_reduce(wire, group=group)
    if wire is not x:
        x.copy_(wire)


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Average ``tensors`` over the world in place (one flat all-reduce)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum_(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class ParallelModel:
    """A model prepared for one train step on every rank of a mesh.

    ``module`` is what the train step calls (the DDP wrapper, or the model
    itself, sharded in place by FSDP2); ``model`` is the model with its
    parameter names.  ``replicated`` lists the parameters whose gradients
    :meth:`reduce_gradients` averages over the world itself (FSDP's
    replicated ones; DDP averages its own)."""

    def __init__(self, model: nn.Module, mesh=None, min_size_to_shard: int = 2**18):
        self.model = model
        self.model_class = type(model)  # before FSDP swaps the class
        self.module = model
        self.replicated: List[nn.Parameter] = []
        self.rank, self.world = (0, 1) if mesh is None else (mesh.get_rank(), mesh.size())
        self.kind = "single"
        if self.world == 1:
            return
        n_fsdp = mesh.size(1)
        if n_fsdp == 1:  # DDP broadcasts rank 0's parameters itself
            device_ids = [next(model.parameters()).device.index] if next(model.parameters()).is_cuda else None
            self.module = nn.parallel.DistributedDataParallel(model, device_ids=device_ids)
            self.kind = "ddp"
            return
        self.kind = "fsdp"
        _broadcast_parameters(model)
        self.replicated = _fully_shard(model, mesh, min_size_to_shard)

    def gradient_sync(self, sync: bool):
        """Context of one microbatch's forward and backward: ``sync=False``
        keeps its gradient in this rank (every microbatch but the last)."""
        if self.kind == "ddp" and not sync:
            return self.module.no_sync()
        if self.kind == "fsdp":
            self.model.set_requires_gradient_sync(sync)
        return contextlib.nullcontext()

    def reduce_gradients(self) -> None:
        """After the last backward: average the replicated parameters'
        gradients over the world (FSDP has reduced the sharded ones)."""
        all_reduce_mean_([p.grad for p in self.replicated if p.grad is not None])

    def barrier(self) -> None:
        """Wait for every rank (rank 0 writing a file or a preview)."""
        if self.world > 1:
            dist.barrier()

    def from_rank0(self, fn):
        """``fn()`` as rank 0 computes it, on every rank: a decision the
        ranks must share (which checkpoint to resume, whether to save)."""
        if self.world == 1:
            return fn()
        box = [fn() if self.rank == 0 else None]
        dist.broadcast_object_list(box, 0)
        return box[0]


def _broadcast_parameters(model: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank: FSDP takes each rank's
    shard from its own copy."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            wire = _wire(t.data)
            dist.broadcast(wire, 0)
            if wire is not t.data:
                t.data.copy_(wire)


def _fully_shard(model: nn.Module, mesh, min_size_to_shard: int) -> List[nn.Parameter]:
    """FSDP2 bottom-up: each block (a module held in a ModuleList) that
    owns a parameter to shard, then the root; the parameters that
    :func:`param_spec` replicates are left out of FSDP.  Returns them."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n_fsdp = mesh.size(1)
    dims = {p: param_spec(p.shape, n_fsdp, min_size_to_shard) for p in model.parameters()}
    replicated = [p for p, d in dims.items() if d is None]
    ignored = set(replicated)

    def placement(p):
        return Shard(dims[p])

    def owns_sharded(m: nn.Module) -> bool:
        return any(dims[p] is not None for p in m.parameters())

    blocks = [
        child
        for parent in model.modules() if isinstance(parent, nn.ModuleList)
        for child in parent if not isinstance(child, nn.ModuleList) and owns_sharded(child)
    ]
    for block in blocks:
        fully_shard(block, mesh=mesh, shard_placement_fn=placement, ignored_params=ignored)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement, ignored_params=ignored)
    return replicated


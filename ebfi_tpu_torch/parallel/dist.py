"""Data parallelism over processes (port of ``ebfi_tpu/parallel/mesh.py``).

The reference trains with one process per card over NCCL, the processes
meeting through RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT
(``torchrun`` sets them, and LOCAL_RANK, the card's index on its node).
The JAX package runs one process per host over a device mesh, and XLA
inserts the gradient all-reduce into its jitted step.  Here each process
holds a replica of the model and its share of the global batch, and the
optimizer's :class:`~ebfi_tpu_torch.train.optim.Updater` averages the
gradients over the processes once per update (:func:`all_reduce_mean_`).
No ``DistributedDataParallel`` wrapper: the bf16 step runs the model
through ``torch.func.functional_call`` on cast parameters, which a
wrapper's reducer would not see, and FrozenEX and the exposure pretrain
take the same path.

Every function here works without a process group too, as the group of
one process: rank 0 of 1, primary, nothing to reduce.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_ADDR = "localhost"
DEFAULT_PORT = "12355"
BUCKET_BYTES = 25 * 2**20  # PyTorch DDP's default bucket cap
GRAD_RANGE = "ebfi::grad_allreduce"
DISC_GRAD_RANGE = "ebfi::disc_grad_allreduce"  # the discriminator's, once per its update


def launched() -> bool:
    """Whether a launcher started this process (RANK and WORLD_SIZE set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_device(name: str = "cuda") -> torch.device:
    """The device of this process: ``cuda`` without an index means the card
    of LOCAL_RANK under a launcher (card 0 otherwise); a name with an
    index, or ``cpu``, stands as given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) if launched() else 0)
    return device


def maybe_init_distributed(backend: Optional[str] = None,
                           device: Optional[torch.device] = None) -> bool:
    """Join the process group the launcher's variables describe (the
    reference's contract, ``train_ours.py:63-84``): RANK, WORLD_SIZE,
    MASTER_ADDR (default localhost), MASTER_PORT (default 12355).  Returns
    whether a group is initialized; without the variables it returns False
    and starts nothing.

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU; ``device`` defaults to :func:`local_device`'s card where one
    is available.  A CUDA device becomes the current device before the
    group starts, so that NCCL binds each rank to its own card.

    Unlike ``ebfi_tpu.parallel.maybe_init_distributed``, which returns
    early at WORLD_SIZE 1, the group starts at any world size the launcher
    gives, 1 included: ``torchrun --nproc_per_node=1`` runs the same
    all-reduce as a larger launch."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    if device is None:
        device = local_device() if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    addr = os.environ.get("MASTER_ADDR", DEFAULT_ADDR)
    port = os.environ.get("MASTER_PORT", DEFAULT_PORT)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        # NCCL binds the group to this rank's card
        **({"device_id": device} if backend == "nccl" else {}),
    )
    return True


def local_shard_info() -> Tuple[int, int]:
    """(rank, world size): this process's shard of the data and the number
    of shards."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """Rank 0, the process that writes checkpoints, snapshots and logs."""
    return local_shard_info()[0] == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _buckets(tensors: List[torch.Tensor], cap: int):
    """Consecutive runs of tensors of one dtype and device, each run at
    most ``cap`` bytes (a larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > cap or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], range_name: str = GRAD_RANGE,
                     divisor: Optional[int] = None) -> None:
    """Replace each tensor by its mean over the ranks, in place.  Every rank
    passes the same tensors (shapes, dtypes) in the same order.  The
    tensors travel in flat buckets of at most BUCKET_BYTES (the model's
    22.8 MB of f32 gradients in one), summed by the backend and divided
    by ``divisor`` (the world size for None; under spatial parallelism
    the data axis, which sums over the model axis and averages over the
    data axis), inside a ``record_function`` range ``range_name``.
    Without a process group nothing happens."""
    if not dist.is_initialized():
        return
    world = dist.get_world_size() if divisor is None else divisor
    with torch.autograd.profiler.record_function(range_name):
        for bucket in _buckets(list(tensors), BUCKET_BYTES):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat)
            flat.div_(world)
            views = flat.split([t.numel() for t in bucket])
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(views, bucket)])


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group`` (the world for None), which
    autograd differentiates: the gradient of each rank's input is the sum
    over the ranks of their outputs' gradients (the backward is this
    Function again, so that a double backward goes through it too).  That
    is the gradient of the sum of the ranks' losses: right where each
    rank backpropagates its own share of the loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the world for None), out
    of place and differentiable (batch statistics over the global batch:
    the discriminators' BN; under spatial parallelism, image statistics
    over the model axis).  Every rank of the group calls it at the same
    point, forward and backward alike.  Without a process group it
    returns ``x``."""
    if not dist.is_initialized():
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer of ``module`` with rank
    ``src``'s.  Without a process group nothing happens."""
    if not dist.is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)

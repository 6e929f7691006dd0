"""Data parallelism of the port: one process per card, gradients averaged
over the processes once per update (see :mod:`.dist`)."""
from .dist import (
    DISC_GRAD_RANGE,
    GRAD_RANGE,
    all_reduce_mean_,
    all_reduce_sum,
    barrier,
    broadcast_module_,
    is_primary,
    local_device,
    local_shard_info,
    maybe_init_distributed,
    spatial_shardings,
)

__all__ = [
    "maybe_init_distributed",
    "local_device",
    "local_shard_info",
    "is_primary",
    "barrier",
    "all_reduce_mean_",
    "all_reduce_sum",
    "GRAD_RANGE",
    "DISC_GRAD_RANGE",
    "broadcast_module_",
    "spatial_shardings",
]

"""Parallelism of the port: data parallelism, one process per card, with
gradients averaged over the processes once per update (see :mod:`.dist`),
and H-sharded spatial parallelism, DP x SP, with every row-coupled op on
its band of rows (see :mod:`.spatial`)."""
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
)
from .spatial import (
    BAND_ALIGN,
    SpatialSpec,
    band_mean,
    band_scope,
    current_band,
    gather_rows,
    halo_rows,
    model_sum,
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
    "SpatialSpec",
    "BAND_ALIGN",
    "band_scope",
    "current_band",
    "halo_rows",
    "model_sum",
    "band_mean",
    "gather_rows",
]

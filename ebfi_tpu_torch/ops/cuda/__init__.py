"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version, kept in the same module, for CPU tensors.  Each counts its
kernel launches in a plain integer attribute ``launches``; B2 and B3, which
route by dtype, also count per route in ``launches_by_route``.
"""
from .fac import kernel_conv2d_cuda, fac_plain
from .mod_fac import (
    modification_fac_fused,
    modification_fac_fused_shared,
    mod_fac_plain,
    mod_fac_shared_plain,
)

KERNELS = {
    "fac": kernel_conv2d_cuda,
    "mod_fac": modification_fac_fused,
    "mod_fac_shared": modification_fac_fused_shared,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """Launches per route of the kernels that route by dtype."""
    return {
        name: dict(fn.launches_by_route)
        for name, fn in KERNELS.items()
        if hasattr(fn, "launches_by_route")
    }


__all__ = [
    "KERNELS",
    "kernel_conv2d_cuda",
    "fac_plain",
    "modification_fac_fused",
    "modification_fac_fused_shared",
    "mod_fac_plain",
    "mod_fac_shared_plain",
    "reset_launch_counts",
    "launch_counts",
    "route_counts",
]

"""Device traces (port of ``ebfi_tpu/utils/profiling.py``'s ``trace``).

The JAX package's other helper, ``enable_compile_cache``, sets XLA's
persistent compile cache; the port compiles nothing at run time but its
CUDA kernels, which ``ops/cuda/build.py`` already caches by a hash of
their sources, so it has no counterpart.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with trace("out/trace"): ...`` -> a Chrome trace of the host and,
    where a card is available, the device (``torch.profiler``), written to
    ``log_dir/trace-<pid>-<time>.json`` (chrome://tracing, Perfetto or
    TensorBoard's profile plugin read it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))

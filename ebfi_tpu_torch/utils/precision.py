"""Mixed precision: parameters stay f32, compute runs in a cast copy.

Counterpart of ``ebfi_tpu/utils/precision.py``'s ``to_bf16``: the engine
keeps the f32 module and computes with a copy whose floating parameters
are cast to the compute dtype (bf16 for serving, f32 for strict parity).
"""
from __future__ import annotations

import copy

import torch
import torch.nn as nn

PRECISIONS = {"f32": torch.float32, "bf16": torch.bfloat16}


def compute_copy(module: nn.Module, precision: str, device) -> nn.Module:
    """A copy of ``module`` on ``device`` with floating parameters in the
    precision's dtype, in eval mode; the original is untouched."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return copy.deepcopy(module).to(device=device, dtype=PRECISIONS[precision]).eval()

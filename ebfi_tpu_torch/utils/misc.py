"""Small helpers (port of ``ebfi_tpu/utils/misc.py``)."""
from __future__ import annotations

import itertools
from typing import Mapping, Union

import numpy as np
import torch
import torch.nn as nn


def normalize_event_tensor(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """The nonzero entries of an event tensor normalised to zero mean and
    unit standard deviation (population), zeros kept."""
    nz = (x != 0).to(x.dtype)
    n = nz.sum().clamp_min(1.0)
    mean = (x * nz).sum() / n
    var = (((x - mean) * nz) ** 2).sum() / n
    return torch.where(nz > 0, (x - mean) / torch.sqrt(var + eps), x)


def to_uint8_image(x) -> np.ndarray:
    """float [0, 1] (H, W, C), a tensor or an array -> uint8, truncated."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return (np.clip(np.asarray(x), 0.0, 1.0) * 255).astype(np.uint8)


def inf_loop(iterable):
    """Repeat a loader's epochs endlessly."""
    for loader in itertools.repeat(iterable):
        yield from loader


def param_count(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Number of parameters of a module (its ``parameters()``) or of the
    tensors of a state dict (buffers included, as they are there)."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(int(t.numel()) for t in tensors)

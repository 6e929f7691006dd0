"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(what: str, tensors: dict, dtype: torch.dtype) -> None:
    """Raise unless every tensor is on one CUDA device, has the kernel's
    dtype, is contiguous and needs no gradient."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32 or bfloat16)")
    device = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{what}: the CUDA kernel has no backward; call it under "
                "torch.no_grad() or torch.inference_mode()"
            )


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

"""Argument checks and the autograd plumbing shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(what: str, tensors: dict, dtype: torch.dtype) -> None:
    """Raise unless every tensor is on one CUDA device, has the kernel's
    dtype and is contiguous."""
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


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device: torch.device):
    """Context that makes ``device`` the CUDA runtime's current device.  The
    C entry points launch their kernels, and set their attributes, on the
    current device, while the stream they are given belongs to the
    tensors' device: every launch runs under this guard, or a launch for
    any card but the current one (every rank but a node's first, or
    ``--device cuda:1``) fails.  The plain-recompute backward runs PyTorch
    ops alone, which follow their tensors' device, and needs no guard."""
    return torch.cuda.device(device)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on these tensors records autograd: outside
    ``no_grad``/``inference_mode``, with some input requiring grad.  Calls
    that do not go straight to the forward and save nothing."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, needs_input_grad, grad_out, range_name: str):
    """Gradients of ``plain(*inputs)`` against ``grad_out``, recomputed
    through autograd of the plain version (the backward of the JAX
    package's ``custom_vjp``s, which recompute through their XLA twins).
    None for every input whose gradient is not needed.  The recompute runs
    inside a ``record_function`` range named ``range_name``, so a profile
    attributes its device time."""
    with torch.enable_grad(), torch.autograd.profiler.record_function(range_name):
        leaves = [x.detach().requires_grad_(need) for x, need in zip(inputs, needs_input_grad)]
        out = plain(*leaves)
        wanted = [x for x, need in zip(leaves, needs_input_grad) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if need else None for need in needs_input_grad)

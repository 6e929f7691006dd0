"""Checkpoints the port serves from.

The port's own format is one file written by ``torch.save``::

    {"format": "ebfi_tpu_torch/1",
     "config": {"model": {"name": ..., "args": {...}}, ...},  # JSON-able
     "model_states": state_dict}

It loads with ``torch.load(weights_only=True)`` and
``load_state_dict(strict=True)``.  ``tools/jax_ckpt_to_torch.py`` writes it
from a JAX package (Orbax) checkpoint.

A reference-format ``.pth`` loads too: ``{"model": {"states": state_dict},
"config": {...}}`` with the reference's module names, mapped by
:func:`ebfi_tpu_torch.models.params_from_reference`.  Its config must have
a "model" entry, which the architecture is rebuilt from.
"""
from __future__ import annotations

import json
from typing import Tuple

import torch
import torch.nn as nn

from ..models import build_model, params_from_reference

FORMAT = "ebfi_tpu_torch/1"


def save_checkpoint(path: str, model: nn.Module, config: dict) -> None:
    """Write ``model``'s weights (f32, on the CPU) with ``config``, which
    must hold the "model" entry that built it and be JSON-able."""
    if "model" not in config:
        raise ValueError("config needs the 'model' entry the architecture is built from")
    config = json.loads(json.dumps(config))  # raises for what is not JSON-able
    states = {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}
    torch.save({"format": FORMAT, "config": config, "model_states": states}, path)


def load_checkpoint(path: str) -> Tuple[nn.Module, dict]:
    """(model with the checkpoint's weights, on the CPU in eval mode, config)
    from a port checkpoint or a reference-format ``.pth``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a checkpoint (a {type(ckpt).__name__})")
    if ckpt.get("format") == FORMAT:
        config, states = ckpt["config"], ckpt["model_states"]
    elif isinstance(ckpt.get("model"), dict) and "states" in ckpt["model"]:
        config = ckpt.get("config") or {}
        if "model" not in config:
            raise ValueError(f"{path}: a reference checkpoint without a 'model' config; "
                             "the architecture cannot be rebuilt from it")
        states = params_from_reference(ckpt["model"]["states"])
    else:
        raise ValueError(f"{path}: neither an {FORMAT} checkpoint nor a reference .pth "
                         "({'model': {'states': ...}, 'config': ...})")
    model = build_model(config["model"])
    model.load_state_dict(states, strict=True)
    return model.eval(), config

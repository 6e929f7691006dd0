"""Training checkpoints (port of ``ebfi_tpu/train/checkpoint.py``).

One ``torch.save`` file per tag in the save directory,
``checkpoint-iteration{N}.pt`` / ``model_best_until_iteration{N}.pt`` (or
``-epoch{N}``), in the port's ``ebfi_tpu_torch/1`` format
(``utils/checkpoint.py``) extended with the training state::

    {"format": "ebfi_tpu_torch/1", "config": the resolved config,
     "model_states": state_dict (f32, CPU),
     "opt_states": the updater's state (optimizer, schedule, accumulation),
     "step": micro-steps taken,
     "meta": {"model": {"name"}, "optimizer": {"name"},
              "lr_scheduler": {"name"}, "trainer": {...}}}

``python -m ebfi_tpu_torch.infer --model_path`` serves such a file as it
is.  The JAX package writes an Orbax directory per tag instead.  Resume
refuses a checkpoint whose model name differs from the configured one,
and, unless ``reset``, one whose optimizer name differs; ``reset`` keeps
the weights and drops the optimizer state, the step and the trainer
state.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..utils.checkpoint import FORMAT


def save_checkpoint(save_dir: str, tag: str, model: torch.nn.Module, opt_state: Optional[dict],
                    step: int, config: dict, trainer_state: Dict[str, Any],
                    model_name: str = "EVFIAutoEx", optimizer_name: str = "Adam",
                    scheduler_name: Optional[str] = "StepLR") -> str:
    path = os.path.abspath(os.path.join(save_dir, f"{tag}.pt"))
    states = {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}
    torch.save({
        "format": FORMAT,
        "config": json.loads(json.dumps(config)),  # raises for what is not JSON-able
        "model_states": states,
        "opt_states": opt_state if opt_state is not None else {},
        "step": int(step),
        "meta": {
            "model": {"name": model_name},
            "optimizer": {"name": optimizer_name},
            "lr_scheduler": {"name": scheduler_name},
            "trainer": trainer_state,
        },
    }, path)
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """{'model_states', 'opt_states', 'step', 'meta', 'config'}, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT or "meta" not in ckpt:
        raise ValueError(f"{path}: not a training checkpoint of the {FORMAT} format")
    return ckpt


def resume(path: str, model_name: str, optimizer_name: str, reset: bool = False) -> Dict[str, Any]:
    """Name-guarded restore."""
    restored = restore_checkpoint(path)
    meta = restored["meta"]
    if meta["model"]["name"] != model_name:
        raise ValueError(f"Checkpoint model {meta['model']['name']!r} != configured {model_name!r}")
    if reset:
        restored["opt_states"] = None
        restored["step"] = 0
        meta["trainer"] = {}
    elif meta["optimizer"]["name"] != optimizer_name:
        raise ValueError(
            f"Checkpoint optimizer {meta['optimizer']['name']!r} != configured {optimizer_name!r}"
        )
    return restored

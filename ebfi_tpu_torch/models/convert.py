"""Weights across from the JAX package.

``params_from_jax`` maps the flax parameter tree of ``EVFIAutoEx.init``
(as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) onto this
package's ``state_dict`` names and layouts; load the result with
``load_state_dict(..., strict=True)``.  Only numpy crosses over.

Layouts: 2D conv kernels HWIO -> OIHW; 3D conv kernels DHWIO -> OIDHW;
transposed 3D conv kernels, stored (kd, kh, kw, O, I) -> torch's
(I, O, kd, kh, kw), the same axis permutation; ResidualControl's stacked
(S, 3, 3, I, O) -> (S, O, I, 3, 3); GroupNorm ``scale`` -> ``weight``.
Module names are the flax names, with ``Conv_0``/``Conv3D_0`` -> ``conv``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RENAME = {"Conv_0": "conv", "Conv3D_0": "conv", "kernel": "weight", "scale": "weight"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(path, arr: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        # ResidualControl's stage stacks are the only 5-D non-kernel leaves
        return arr.transpose(0, 4, 3, 1, 2) if arr.ndim == 5 else arr
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves, with or without the top 'params' key) ->
    a state_dict for the port's module of the same configuration."""
    if "params" in tree:
        tree = tree["params"]
    sd = {}
    for path, leaf in _flatten(tree):
        arr = _to_torch_layout(path, np.asarray(leaf, dtype=np.float32))
        name = ".".join(_RENAME.get(p, p) for p in path)
        sd[name] = torch.tensor(arr)
    return sd

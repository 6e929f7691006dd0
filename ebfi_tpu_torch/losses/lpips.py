"""LPIPS perceptual distance, AlexNet backbone (port of
``ebfi_tpu/losses/lpips.py``).

LPIPS v0.1 (the reference's ``PNetLin``): scaling layer, AlexNet's five
conv stages (ReLU taps, 3x3/s2 max-pools after stages 0 and 1), each tap
unit-normalised over channels, squared difference, the 1x1 linear heads,
spatial mean, summed over the taps.  Images are NHWC in [0, 1].  The
convolutions are cuDNN's on the card (the JAX module is XLA, no Pallas
kernel), and the weights are frozen buffers, not parameters.

Weights (:func:`load_lpips_params`): the reference's ``alex.pth`` linear
heads, by default this package's own copy of them
(``lpips_alex_linear.npz``), and a torchvision ``alexnet`` state dict for
the backbone.  Without a backbone file the backbone is random features
drawn from a seed, the same numbers as the JAX package draws; the module
then reports ``comparable == False``: its values are self-consistent but
not comparable with published LPIPS numbers, and the infer CLI omits them.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

logger = logging.getLogger(__name__)

# AlexNet's feature stages: (out channels, kernel, stride, padding)
ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
ALEX_LAYER_IDS = [0, 3, 6, 8, 10]  # their indices in torchvision's ``alexnet().features``
POOL_AFTER = {0, 1}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
HEADS_FILE = os.path.join(os.path.dirname(__file__), "lpips_alex_linear.npz")


class LPIPS(nn.Module):
    """``lpips(pred, target)`` -> (B,) distances of NHWC images in [0, 1].

    ``params``: ``conv{i}_w`` (O, I, kh, kw), ``conv{i}_b``, ``lin{i}_w``
    (C,) for i in 0..4, and ``_real_backbone`` (whether the backbone came
    from a file), as :func:`load_lpips_params` returns them."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        params = dict(params)
        self.comparable = bool(params.pop("_real_backbone", False))
        for name, value in params.items():
            self.register_buffer(name, torch.as_tensor(value, dtype=torch.float32))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    def _features(self, x: torch.Tensor):
        """x (B, 3, H, W) in [-1, 1] -> the five ReLU taps."""
        h = (x - self.shift) / self.scale
        feats = []
        for i, (_, _, stride, pad) in enumerate(ALEX_CONVS):
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=stride, padding=pad))
            feats.append(h)
            if i in POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        to_nchw = lambda x: (2.0 * x - 1.0).permute(0, 3, 1, 2)  # noqa: E731
        total = 0.0
        for i, (a, b) in enumerate(zip(self._features(to_nchw(pred)),
                                       self._features(to_nchw(target)))):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = getattr(self, f"lin{i}_w").view(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x**2).sum(dim=1, keepdim=True)) + eps)


def load_lpips_params(linear_path: Optional[str] = None, backbone_path: Optional[str] = None,
                      seed: int = 0) -> dict:
    """LPIPS weights, on the CPU in f32.

    linear_path: the reference's ``alex.pth`` linear heads (keys
      ``lin{i}.model.1.weight``, shape (1, C, 1, 1)); by default this
      package's copy of them.  Negative head weights are clamped to 0.
    backbone_path: a torchvision ``alexnet`` state dict (keys
      ``features.{0,3,6,8,10}.{weight,bias}``).  Without one the backbone
      is He-normal random features from ``np.random.default_rng(seed)``,
      drawn in the JAX package's order and layout, with a warning.
    """
    params: dict = {"_real_backbone": backbone_path is not None}
    if backbone_path is not None:
        sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
        for i, lid in enumerate(ALEX_LAYER_IDS):
            params[f"conv{i}_w"] = sd[f"features.{lid}.weight"].float()
            params[f"conv{i}_b"] = sd[f"features.{lid}.bias"].float()
    else:
        logger.warning(
            "LPIPS: no alexnet backbone checkpoint provided; using random features. Values are "
            "self-consistent but NOT comparable to published LPIPS numbers."
        )
        rng = np.random.default_rng(seed)
        cin = 3
        for i, (cout, k, _, _) in enumerate(ALEX_CONVS):
            std = float(np.sqrt(2.0 / (k * k * cin)))
            w = rng.normal(0, std, (k, k, cin, cout)).astype(np.float32)  # HWIO
            params[f"conv{i}_w"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
            params[f"conv{i}_b"] = torch.zeros(cout)
            cin = cout
    if linear_path is not None:
        lin = torch.load(linear_path, map_location="cpu", weights_only=True)
        heads = {f"lin{i}": lin[f"lin{i}.model.1.weight"].float().reshape(-1) for i in range(5)}
    else:
        with np.load(HEADS_FILE) as f:
            heads = {f"lin{i}": torch.from_numpy(f[f"lin{i}"]) for i in range(5)}
    for i in range(5):
        params[f"lin{i}_w"] = heads[f"lin{i}"].clamp_min(0)
    return params

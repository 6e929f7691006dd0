"""Model construction from config dicts and seeded initialisation.

``build_model`` takes the same dict as ``ebfi_tpu/models/factory.py``:
``{'name': ..., 'args': {...}}`` with either this framework's snake_case
names or the reference's YAML keys.  There is no YAML reader here; the
caller parses its config.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from .evfi import EVFIAutoEx
from .exposure import ExposureDecision
from .control import ResidualControl
from .layers import ConvLayer, SEGating
from .unet3d import UNet3d18

_EVFI_KEYMAP = {
    "FrameBasech": "frame_basech",
    "EventBasech": "event_basech",
    "InterCH": "inter_ch",
    "TB": "tb",
    "norm": "norm",
    "activation": "activation",
    "BlurryFashion": "blurry_fashion",
    "BLInch": "bl_in",
    "UseEvents": "use_events",
    "UseGTEx": "use_gt_ex",
    "FixEx": "fix_ex",
    "FrozenEX": "frozen_ex",
    "step": "step",
    "DualPath": "dual_path",
    "residual": "residual",
    "DetailEnabled": "detail_enabled",
    "channels": "channels",
    "FastVariants": "_fast_variants",
}
_EVFI_IGNORED = {"LoadPretrainEX", "PretrainedEXPath"}

_EXPOSURE_KEYMAP = {
    "EventInch": "event_in",
    "BLInch": "bl_in",
    "InterCH": "inter_ch",
    "Group": "groups",
    "norm": "norm",
    "activation": "activation",
}
_EXPOSURE_IGNORED = {"LoadPretrain", "PretrainedEXPath", "Frozen", "BlurryFashion"}


def _translate(args: Dict, keymap: Dict[str, str], ignored: set) -> Dict:
    out = {keymap.get(k, k): v for k, v in args.items() if k not in ignored}
    if out.get("channels") is not None:
        out["channels"] = tuple(out["channels"])
    # the only fast variant the port has is the fused Modification
    if out.pop("_fast_variants", False):
        out.setdefault("fast_mod", True)
    return out


def build_model(model_cfg: Dict) -> nn.Module:
    """model_cfg: {'name': 'EVFIAutoEx' | 'ExposureDecision', 'args': {...}}."""
    name = model_cfg["name"]
    args = model_cfg.get("args", {}) or {}
    if name == "EVFIAutoEx":
        return EVFIAutoEx(**_translate(args, _EVFI_KEYMAP, _EVFI_IGNORED))
    if name == "ExposureDecision":
        return ExposureDecision(**_translate(args, _EXPOSURE_KEYMAP, _EXPOSURE_IGNORED))
    raise ValueError(f"Unknown model {name!r}")


# Gain of the seeded kaiming init relative to sqrt(2/fan_in).  The JAX
# package's training init scales by 0.1, which at the shipped depth makes a
# random-weight model's output constant (sigmoid(0) everywhere); at 1.0 the
# 12 ResidualControl stages saturate it.  0.9 keeps it input-dependent.
RANDOM_CONV_GAIN = 0.9
TRAIN_CONV_GAIN = 0.1  # the JAX training init's kaiming_in_init(0.1)


def init_weights(model: nn.Module, seed: int, scheme: str = "random") -> nn.Module:
    """Deterministic random weights, in place, from a seeded generator.

    scheme "random" (runs without a trained checkpoint): ConvLayer convs
    and the ResidualControl stacks get kaiming-normal fan-in at
    RANDOM_CONV_GAIN and zero bias, GroupNorm ones and zeros, every other
    conv torch's default U(+-1/sqrt(fan_in)).

    scheme "train" (the start of training): the JAX package's training
    init per layer (``ebfi_tpu/models/layers.py:23-35``): kaiming-normal
    fan-in times 0.1 for ConvLayer convs and the ResidualControl stacks
    (fans as flax counts them on the stacked (S, 3, 3, I, O) and (S, 1, C)
    shapes, the stage axis included), zero biases; kaiming-normal fan-out
    for the 3D encoder's convs; U(+-1/sqrt(fan_in)) for the other convs,
    with a transposed conv's fan-in over its input channels; GroupNorm
    ones and zeros."""
    if scheme not in ("random", "train"):
        raise ValueError(f"unknown init scheme {scheme!r}")
    train = scheme == "train"
    gain = TRAIN_CONV_GAIN if train else RANDOM_CONV_GAIN
    g = torch.Generator().manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=g) * std)

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)

    done = set()
    fan_out_convs = set()
    if train:
        se_convs = {id(m.conv) for m in model.modules() if isinstance(m, SEGating)}
        for m in model.modules():
            if isinstance(m, UNet3d18):
                fan_out_convs |= {id(c) for c in m.encoder.modules()
                                  if isinstance(c, nn.Conv3d) and id(c) not in se_convs}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvLayer):
                w = m.conv.weight
                normal(w, gain * math.sqrt(2.0 / math.prod(w.shape[1:])))
                if m.conv.bias is not None:  # BN's conv has none
                    m.conv.bias.zero_()
                done.add(id(m.conv))
            elif isinstance(m, ResidualControl):
                for name, p in m.named_parameters(recurse=False):
                    if name.endswith("_b"):
                        p.zero_()
                        continue
                    # (S, O, I, kh, kw) conv stacks or (S, 1, C) scale maps
                    fan_in = math.prod(p.shape[2:]) if p.dim() == 5 else 1
                    if train:  # flax counts the stage axis into the receptive field
                        fan_in *= p.shape[0]
                    normal(p, gain * math.sqrt(2.0 / fan_in))
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif id(m) in fan_out_convs:
                w = m.weight
                normal(w, math.sqrt(2.0 / (w.shape[0] * math.prod(w.shape[2:]))))
            elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)) and id(m) not in done:
                # torch's fan-in is dim 1 times the window, for convs and
                # transposed convs alike; the JAX training init takes a
                # transposed conv's input channels (dim 0)
                w = m.weight
                fan_dim = 0 if train and isinstance(m, nn.ConvTranspose3d) else 1
                bound = 1.0 / math.sqrt(w.shape[fan_dim] * math.prod(w.shape[2:]))
                uniform(w, bound)
                if m.bias is not None:
                    uniform(m.bias, bound)
    return model

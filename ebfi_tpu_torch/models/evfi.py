"""EVFIAutoEx: blind-exposure blurry-frame interpolation (port of
``ebfi_tpu/models/evfi.py``, standard paths).

Given a blurry frame, its per-polarity event stack and a timestamp T,
produce the sharp latent frame at T.  NHWC throughout; the event stack is
channel-flattened (B, H, W, 2*TB).  ``features`` is the T-independent
trunk and ``from_timestamp`` the T-dependent tail; ``hoist`` and
``from_timestamp_shared`` share per-frame work across the N timestamps
of one frame.  ``norm`` ("BN" or "IN") needs ``dual_path=False``, as in
the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import dark_channel, laplacian_response, pad_amounts_to_multiple, pixel_shuffle
from .control import ResidualControl
from .exposure import ExposureDecision
from .layers import ConvLayer
from .modification import Modification
from .unet3d import UNet3d18


class EVFIAutoEx(nn.Module):
    """Constructor arguments mirror the JAX module's fields."""

    def __init__(
        self,
        frame_basech: int = 64,
        event_basech: int = 64,
        inter_ch: int = 64,
        tb: int = 16,
        norm: Optional[str] = None,
        activation: str = "LeakyReLU",
        blurry_fashion: str = "DarkCh",
        bl_in: int = 1,
        use_events: bool = True,
        use_gt_ex: bool = False,
        fix_ex: Optional[float] = None,
        frozen_ex: bool = False,
        step: int = 32,
        dual_path: bool = True,
        residual: bool = True,
        detail_enabled: bool = True,
        channels: Sequence[int] = (32, 64, 96, 128),
        fast_mod: bool = False,
    ):
        super().__init__()
        # a norm reaches every ConvLayer, as in the JAX module; ResidualControl
        # (dual_path) raises for one, as the JAX one does, and Modification
        # then takes its unfused path.  BN uses its running statistics:
        # the JAX module never passes train=True to these layers
        self.blurry_fashion = blurry_fashion
        self.use_gt_ex, self.fix_ex = use_gt_ex, fix_ex
        self.frozen_ex = frozen_ex
        self.dual_path, self.residual = dual_path, residual
        self.detail_enabled = detail_enabled
        self.frame_feat = ConvLayer(3, frame_basech, 3, 2, 1, activation, norm)
        self.event_feat = ConvLayer(2 * tb, event_basech, 3, 2, 1, activation, norm)
        self.exposure_decision = None
        if not use_gt_ex and not fix_ex and use_events:
            self.exposure_decision = ExposureDecision(
                2 * tb, bl_in, inter_ch, 4, norm, activation
            )
        self.residual_control = (
            ResidualControl(event_basech, step, norm, activation) if dual_path else None
        )
        self.modification = (
            Modification(frame_basech, event_basech, 5, norm, activation, fused=fast_mod)
            if residual
            else None
        )
        self.recon_up = ConvLayer(frame_basech, frame_basech * 4, 3, 1, 1, None, norm)
        self.recon_mid = ConvLayer(frame_basech, frame_basech, 3, 1, 1, activation, norm)
        self.recon_out = ConvLayer(frame_basech, 3, 3, 1, 1, "Sigmoid", norm)
        self.detail = UNet3d18(channels) if detail_enabled else None

    # ------------------------------------------------------------------ #
    # T-independent trunk

    def blurry_level(self, frame: torch.Tensor) -> torch.Tensor:
        """On-device blurriness map per ``blurry_fashion``."""
        lap = lambda f: laplacian_response(f).to(f.dtype)
        if self.blurry_fashion == "DarkCh":
            return dark_channel(frame)
        if self.blurry_fashion == "Lap":
            return lap(frame)
        if self.blurry_fashion == "RGB":
            return frame
        if self.blurry_fashion == "RGBDark":
            return torch.cat([frame, dark_channel(frame)], dim=-1)
        if self.blurry_fashion == "RGBLap":
            return torch.cat([frame, lap(frame)], dim=-1)
        raise ValueError(f"Wrong blurry conversion fashion {self.blurry_fashion!r}")

    def features(self, frame, event, gt_ex=None) -> Tuple[torch.Tensor, ...]:
        """frame (B, H, W, 3) and event (B, H, W, 2*TB), both padded to /8
        -> (frame_feat, event_feat, ex, frame)."""
        frame_feat = self.frame_feat(frame)
        event_feat = self.event_feat(event)
        if self.use_gt_ex:
            if self.fix_ex:
                raise ValueError("set UseGTEx, but FixEx is given!")
            if gt_ex is None:
                raise ValueError("set UseGTEx, but NO GTEx provided!")
            ex = gt_ex
        elif self.fix_ex:
            if not 0.0 <= self.fix_ex <= 1.0:
                raise ValueError("Wrong FixEx!")
            ex = torch.full((frame.shape[0], 1), self.fix_ex, dtype=frame.dtype, device=frame.device)
        else:
            ex = self.exposure_decision(event, self.blurry_level(frame))
        return frame_feat, event_feat, ex.to(frame.dtype), frame

    # ------------------------------------------------------------------ #
    # T-dependent tail

    def _reconstruct(self, processed_fr, frame, n: int):
        up = F.leaky_relu(pixel_shuffle(self.recon_up(processed_fr), 2), 0.01)
        sharp = self.recon_out(self.recon_mid(up))
        if self.detail is None:
            return sharp, sharp
        if frame.shape[0] != n:
            frame = frame.expand(n, *frame.shape[1:])
        return sharp, sharp + self.detail(frame, sharp)

    def from_timestamp(self, frame_feat, event_feat, ex, frame, t):
        """(sharp, final) at timestamps t (B, 1), on the padded grid."""
        ev = self.residual_control(event_feat, ex, t) if self.dual_path else event_feat
        fr = self.modification(frame_feat, ev) if self.residual else frame_feat
        return self._reconstruct(fr, frame, fr.shape[0])

    def hoist(self, trunk) -> dict:
        """T-independent per-stage partials of one frame (batch 1):
        ResidualControl's stage-0 partials and Modification's ff half.
        Needs dual_path and residual."""
        frame_feat, event_feat, ex, _ = trunk
        return {
            "rc": self.residual_control(event_feat, ex, None, mode="hoist"),
            "mod": self.modification(frame_feat, None, mode="hoist"),
        }

    def from_timestamp_shared(self, trunk, hoisted: dict, t):
        """(sharp, final) for N timestamps t (N, 1) of one frame whose trunk
        and hoisted partials stay at batch 1."""
        frame_feat, _, _, frame = trunk
        ev = self.residual_control(None, None, t, mode="tail", hoisted=hoisted["rc"])
        fr = self.modification(frame_feat, ev, mode="tail", hoisted=hoisted["mod"])
        return self._reconstruct(fr, frame, t.shape[0])

    # ------------------------------------------------------------------ #

    def forward(self, frame, event, t, gt_ex=None):
        """frame (B, H, W, 3), event (B, H, W, 2*TB), t and gt_ex (B, 1) ->
        (sharp, final), each (B, H, W, 3); pads to /8 and crops back."""
        B, H, W, _ = frame.shape
        pt, pb, pl, pr = pad_amounts_to_multiple(H, W, 8, 8)
        need_crop = pt or pb or pl or pr
        if need_crop:
            frame = F.pad(frame, (0, 0, pl, pr, pt, pb))
            event = F.pad(event, (0, 0, pl, pr, pt, pb))
        sharp, final = self.from_timestamp(*self.features(frame, event, gt_ex), t)
        if need_crop:
            sharp = sharp[:, pt : pt + H, pl : pl + W, :]
            final = final[:, pt : pt + H, pl : pl + W, :]
        return sharp, final

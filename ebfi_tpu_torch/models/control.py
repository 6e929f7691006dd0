"""ResidualControl: the time-exposure control stack (port of
``ebfi_tpu/models/control.py``, standard paths only).

``step`` sequential stages modulate the event features by per-stage
scales of the exposure ``ex`` and timestamp ``t``:

    exx = act(conv3b(act(conv3a(x))));  tx = act(conv4b(act(conv4a(x))))
    x'  = act(conv5(concat(ex_scale*exx + x, t_scale*tx + x)))

Parameters are stacked over stages as in the JAX module (OIHW per stage
here).  mode='hoist'/'tail' split stage 0's T-independent work out of a
multi-timestamp sweep: 'hoist' runs once at batch 1, 'tail' runs the rest
at batch N, broadcasting against the hoisted tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import activation_fn, conv2d_nhwc


def _conv3x3(x, w, b=None):
    return conv2d_nhwc(x, w, b, padding=1)


class ResidualControl(nn.Module):
    def __init__(
        self,
        basech: int = 16,
        step: int = 4,
        norm: Optional[str] = None,
        activation: str = "LeakyReLU",
    ):
        super().__init__()
        if norm is not None:
            raise NotImplementedError("ResidualControl supports norm=None")
        C, S = basech, step
        self.basech, self.step = C, S
        self.act = activation_fn(activation)
        p = lambda *shape: nn.Parameter(torch.zeros(*shape))
        self.d1, self.d1_b = p(S, 1, C), p(S, C)
        self.d2, self.d2_b = p(S, 1, C), p(S, C)
        for name in ("conv3a", "conv3b", "conv4a", "conv4b"):
            setattr(self, name, p(S, C, C, 3, 3))
            setattr(self, f"{name}_b", p(S, C))
        self.conv5, self.conv5_b = p(S, C, 2 * C, 3, 3), p(S, C)

    def _scales(self, s: torch.Tensor, w, b) -> torch.Tensor:
        """(B, 1) scalars -> (S, B, C) per-stage modulation scales."""
        return self.act(torch.einsum("bi,sic->sbc", s.to(w.dtype), w) + b[:, None, :])

    def forward(
        self,
        data: Optional[torch.Tensor],
        ex: Optional[torch.Tensor],
        t: Optional[torch.Tensor] = None,
        mode: str = "full",
        hoisted: Optional[dict] = None,
    ) -> torch.Tensor:
        """data (B, H, W, C); ex, t (B, 1) -> (B, H, W, C)."""
        if mode == "hoist":
            return self._hoist(data, self._scales(ex, self.d1, self.d1_b))
        t_scales = self._scales(t, self.d2, self.d2_b)
        if mode == "tail":
            return self._tail(hoisted, t_scales)
        if mode != "full":
            raise ValueError(f"unknown mode {mode!r}")
        ex_scales = self._scales(ex, self.d1, self.d1_b)
        out = data
        for s in range(self.step):
            out = self._stage(out, s, ex_scales[s], t_scales[s])
        return out

    def _stage(self, x, s, ex_s, t_s):
        C, act = self.basech, self.act
        # conv3a|conv4a merged on the output axis (one C -> 2C conv)
        a = _conv3x3(
            x,
            torch.cat([self.conv3a[s], self.conv4a[s]]),
            torch.cat([self.conv3a_b[s], self.conv4a_b[s]]),
        )
        exx = act(_conv3x3(act(a[..., :C]), self.conv3b[s], self.conv3b_b[s]))
        tx = act(_conv3x3(act(a[..., C:]), self.conv4b[s], self.conv4b_b[s]))
        u = ex_s[:, None, None, :] * exx + x
        v = t_s[:, None, None, :] * tx + x
        return act(_conv3x3(torch.cat([u, v], dim=-1), self.conv5[s], self.conv5_b[s]))

    def _hoist(self, x, ex_scales) -> dict:
        """Stage 0's T-independent partials: tx0 (the T path before
        modulation) and hu0 = conv5 over the exposure half u, plus bias."""
        C, act = self.basech, self.act
        a3 = act(_conv3x3(x, self.conv3a[0], self.conv3a_b[0]))
        exx = act(_conv3x3(a3, self.conv3b[0], self.conv3b_b[0]))
        a4 = act(_conv3x3(x, self.conv4a[0], self.conv4a_b[0]))
        tx = act(_conv3x3(a4, self.conv4b[0], self.conv4b_b[0]))
        u = ex_scales[0][:, None, None, :] * exx + x
        hu = _conv3x3(u, self.conv5[0][:, :C], self.conv5_b[0])
        return {"x": x, "tx0": tx, "hu0": hu, "ex_scales": ex_scales}

    def _tail(self, hoisted: dict, t_scales) -> torch.Tensor:
        """Per-timestamp remainder: stage 0 needs only conv5's T half;
        stages 1+ run in full at batch N."""
        C, act = self.basech, self.act
        x, ex_scales = hoisted["x"], hoisted["ex_scales"]
        v = t_scales[0][:, None, None, :] * hoisted["tx0"] + x
        out = act(hoisted["hu0"] + _conv3x3(v, self.conv5[0][:, C:]))
        for s in range(1, self.step):
            out = self._stage(out, s, ex_scales[s], t_scales[s])
        return out

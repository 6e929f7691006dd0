"""Modification: event-to-frame feature transfer via filter-adaptive conv
(port of ``ebfi_tpu/models/modification.py``).

Align event features with a 1x1 conv, predict a per-pixel K*K*C kernel
bank (tap-major) from concat(event, frame) features, apply it with FAC,
then the gated residual ``frame * E1 + conv2(E1)`` with E1 = conv3(FAC).

fused=False: the bank conv is a cuDNN conv and the bank is materialised;
FAC runs as kernel B1 (CUDA) or its plain version (CPU).  fused=True: the
bank is predicted and applied in one kernel, B3 in full mode and B2 in
tail mode, and never reaches device memory (the plain versions on CPU).
fused=True takes the fused path only where those kernels take the call
(leaky ReLU, no norm, frame features C1 wide, and on the card C1 = 64 and
K <= 5), as the JAX package gates its Pallas kernels; otherwise it runs
the unfused path, which takes any width and applies the norm to the bank.

Under spatial parallelism (inside a band scope) the fused kernels do not
take the call, as the JAX package's spatial step falls back from its
Pallas kernel: the unfused path runs, its 3x3 convs with their halo rows,
and FAC through B1's band mode on the event features with their 2 halo
rows (the edge row replicated at the image's own top and bottom).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops import kernel_conv2d_auto
from ..ops.cuda.fac import fac_band_cuda
from ..ops.cuda.mod_fac import (
    cuda_kernel_takes,
    modification_fac_fused,
    modification_fac_fused_shared,
)
from ..parallel import current_band, halo_rows
from .layers import ConvLayer, conv2d_nhwc


def _fac(ev: torch.Tensor, bank: torch.Tensor, K: int) -> torch.Tensor:
    """FAC through B1; on a band, through its band mode."""
    if current_band() is None:
        return kernel_conv2d_auto(ev, bank, K)
    p = (K - 1) // 2
    return fac_band_cuda(halo_rows(ev, 1, p, p, "replicate").contiguous(), bank, K)


class Modification(nn.Module):
    def __init__(
        self,
        frame_basech: int = 64,
        event_ch: int = 64,
        kernel_size: int = 5,
        norm: Optional[str] = None,
        activation: str = "LeakyReLU",
        fused: bool = False,
    ):
        super().__init__()
        C1, K = frame_basech, kernel_size
        self.frame_basech, self.kernel_size = C1, K
        # the kernels apply leaky ReLU(0.01) to the conv's output, with no norm
        self.fused_capable = activation == "LeakyReLU" and norm is None
        self.fused = fused
        self.kernel_conv = ConvLayer(2 * C1, C1 * K * K, 3, 1, 1, activation, norm)
        self.conv1 = ConvLayer(event_ch, C1, 1, 1, 0, activation, norm)
        self.conv3 = ConvLayer(C1, C1, 3, 1, 1, activation, norm)
        self.conv2 = ConvLayer(C1, C1, 3, 1, 1, activation, norm)

    def use_fused(self, frame_feat: torch.Tensor) -> bool:
        """Whether a call with these frame features runs the fused kernels.
        Hoist and tail decide alike: both see the frame features, and the
        tail's event features share their dtype and device.  Never on a
        band (spatial parallelism)."""
        C1, K = self.frame_basech, self.kernel_size
        return (
            self.fused
            and current_band() is None
            and self.fused_capable
            and frame_feat.shape[-1] == C1
            and cuda_kernel_takes(C1, K, frame_feat.dtype, frame_feat.device)
        )

    def _bank_weights(self):
        """The bank conv's weight as HWIO (3, 3, 2C, K*K*C) and its bias."""
        conv = self.kernel_conv.conv
        return conv.weight.permute(2, 3, 1, 0), conv.bias

    def forward(
        self,
        frame_feat: torch.Tensor,
        event_feat: Optional[torch.Tensor],
        mode: str = "full",
        hoisted: Optional[dict] = None,
    ):
        """frame_feat (B, H, W, C1), event_feat (B, H, W, Ce) -> (B, H, W, C1).

        mode='hoist' returns the T-independent part for a multi-timestamp
        sweep (frame_feat at batch 1): the ff half of the bank conv plus
        bias, or nothing when fused (B2 computes it itself).  mode='tail'
        takes event_feat at batch N and frame_feat at batch 1."""
        C1, K = self.frame_basech, self.kernel_size
        use_fused = self.use_fused(frame_feat)
        conv = self.kernel_conv.conv
        if mode == "hoist":
            if use_fused:
                return {}
            bank_ff = conv2d_nhwc(frame_feat, conv.weight[:, C1:], conv.bias, padding=1)
            return {"bank_ff": bank_ff}

        ev = self.conv1(event_feat).contiguous()
        frame_feat = frame_feat.contiguous()
        if mode == "tail":
            if use_fused:
                wk, bk = self._bank_weights()
                e1 = modification_fac_fused_shared(ev, frame_feat, wk, bk, K)
            else:
                bank = conv2d_nhwc(ev, conv.weight[:, :C1], padding=1) + hoisted["bank_ff"]
                e1 = kernel_conv2d_auto(ev, self.kernel_conv.act(bank).contiguous(), K)
        elif mode != "full":
            raise ValueError(f"unknown mode {mode!r}")
        elif use_fused:
            wk, bk = self._bank_weights()
            e1 = modification_fac_fused(ev, frame_feat, wk, bk, K)
        else:
            kern = self.kernel_conv(torch.cat([ev, frame_feat], dim=-1))
            e1 = _fac(ev, kern.contiguous(), K)
        e1 = self.conv3(e1)
        return frame_feat * e1 + self.conv2(e1)

"""SuperSloMo adaptive frame-rate upsampler (port of
``ebfi_tpu/models/superslomo.py``).

The offline dataset pipeline upsamples low-fps video before event
simulation with the public Super-SloMo network: a flow UNet predicting
bidirectional flow between a frame pair, and an arbitrary-time UNet
refining intermediate flows and a visibility map.  The number of frames
inserted per pair is adaptive, ``ceil(max flow magnitude)``
(generate_dataset/upsampling/utils/upsampler.py:160-210).

The UNets are NCHW modules named as the reference's ``UNet`` names its
submodules (``conv1``, ``down1.conv1`` ... ``up5.conv2``, ``conv3``), so the
published ``SuperSloMo.ckpt`` (``state_dictFC`` / ``state_dictAT``) loads
with ``load_state_dict(strict=True)``: :func:`load_checkpoint`.  Frames,
flows and warps are NHWC, as in the JAX package.
"""
from __future__ import annotations

import datetime
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.warp import grid_sample

# Input normalisation (upsampling/utils/const.py): (x - mean) / std, std = 1
MEAN = (0.429, 0.431, 0.397)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class _Down(nn.Module):
    """avg_pool 2x2 -> conv+lrelu -> conv+lrelu (utils/model.py:12-73)."""

    def __init__(self, in_ch: int, out_ch: int, filter_size: int):
        super().__init__()
        p = (filter_size - 1) // 2
        self.conv1 = nn.Conv2d(in_ch, out_ch, filter_size, padding=p)
        self.conv2 = nn.Conv2d(out_ch, out_ch, filter_size, padding=p)

    def forward(self, x):
        x = F.avg_pool2d(x, 2)
        return _lrelu(self.conv2(_lrelu(self.conv1(x))))


class _Up(nn.Module):
    """align-corners bilinear 2x -> conv+lrelu -> conv(cat skip)+lrelu
    (utils/model.py:76-135)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.conv2 = nn.Conv2d(2 * out_ch, out_ch, 3, padding=1)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        x = _lrelu(self.conv1(x))
        return _lrelu(self.conv2(torch.cat([x, skip], 1)))


class SloMoUNet(nn.Module):
    """The Super-SloMo UNet (utils/model.py:139-209), NCHW."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 32, 7, padding=3)
        self.conv2 = nn.Conv2d(32, 32, 7, padding=3)
        self.down1 = _Down(32, 64, 5)
        self.down2 = _Down(64, 128, 3)
        self.down3 = _Down(128, 256, 3)
        self.down4 = _Down(256, 512, 3)
        self.down5 = _Down(512, 512, 3)
        self.up1 = _Up(512, 512)
        self.up2 = _Up(512, 256)
        self.up3 = _Up(256, 128)
        self.up4 = _Up(128, 64)
        self.up5 = _Up(64, 32)
        self.conv3 = nn.Conv2d(32, out_ch, 3, padding=1)

    def forward(self, x):
        x = _lrelu(self.conv1(x))
        s1 = _lrelu(self.conv2(x))
        s2 = self.down1(s1)
        s3 = self.down2(s2)
        s4 = self.down3(s3)
        s5 = self.down4(s4)
        x = self.down5(s5)
        x = self.up1(x, s5)
        x = self.up2(x, s4)
        x = self.up3(x, s3)
        x = self.up4(x, s2)
        x = self.up5(x, s1)
        return _lrelu(self.conv3(x))


def unet_nhwc(unet: SloMoUNet, x: torch.Tensor) -> torch.Tensor:
    """The UNet on an NHWC tensor, NHWC out (channels-last memory inside)."""
    y = unet(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    return y.permute(0, 2, 3, 1)


def back_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """I0 = back_warp(I1, F_0_1): bilinear sample img at grid + flow
    (utils/model.py:212-283; align_corners=True normalisation).  NHWC."""
    B, H, W, C = img.shape
    gx = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, None, :] + flow[..., 0]
    gy = torch.arange(H, dtype=flow.dtype, device=flow.device)[None, :, None] + flow[..., 1]
    grid = torch.stack([2 * (gx / W - 0.5), 2 * (gy / H - 0.5)], dim=-1)
    return grid_sample(img, grid)


class SuperSloMo:
    """Host-side adaptive upsampler around the two UNets.

    ``flow_net``: ``SloMoUNet(6, 4)``; ``interp_net``: ``SloMoUNet(20, 5)``,
    on the device the frames go to.  Works on normalised NHWC frames.
    """

    def __init__(self, flow_net: SloMoUNet, interp_net: SloMoUNet):
        self.flow_net = flow_net.eval()
        self.interp_net = interp_net.eval()
        self.device = next(flow_net.parameters()).device

    @torch.no_grad()
    def _interp_fn(self, i0, i1, f01, f10, t: float) -> torch.Tensor:
        """One intermediate frame at time t in (0, 1) (upsampler.py:177-209).
        The time coefficients are f32 scalars, as the JAX step computes them."""
        t, one = np.float32(t), np.float32(1.0)
        temp = float(-t * (one - t))
        ft0 = temp * f01 + float(t * t) * f10
        ft1 = float((one - t) * (one - t)) * f01 + temp * f10
        g0 = back_warp(i0, ft0)
        g1 = back_warp(i1, ft1)
        inp = torch.cat([i0, i1, f01, f10, ft1, ft0, g1, g0], dim=-1)
        out = unet_nhwc(self.interp_net, inp)
        ft0f = out[..., 0:2] + ft0
        ft1f = out[..., 2:4] + ft1
        v0 = torch.sigmoid(out[..., 4:5])
        v1 = 1.0 - v0
        g0f = back_warp(i0, ft0f)
        g1f = back_warp(i1, ft1f)
        w0, w1 = float(one - t), float(t)
        return (w0 * v0 * g0f + w1 * v1 * g1f) / (w0 * v0 + w1 * v1)

    @torch.no_grad()
    def flow(self, i0: torch.Tensor, i1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = unet_nhwc(self.flow_net, torch.cat([i0, i1], dim=-1))
        return out[..., :2], out[..., 2:]

    @staticmethod
    def insert_count(f01: torch.Tensor, f10: torch.Tensor) -> int:
        """Adaptive per-pair insertion count = ceil(max flow magnitude)
        (upsampler.py:171-175).  Reads one scalar to the host: the count
        decides the host loop."""
        m01 = torch.sqrt((f01 ** 2).sum(-1)).max()
        m10 = torch.sqrt((f10 ** 2).sum(-1)).max()
        return int(math.ceil(float(torch.maximum(m01, m10))))

    def interpolate_pair(self, i0, i1) -> Tuple[List[torch.Tensor], List[float]]:
        """All adaptive intermediate frames of a pair of normalised frames
        (each (1, H, W, 3) on the device).  Returns (frames on the device,
        fractional times in (0, 1))."""
        f01, f10 = self.flow(i0, i1)
        n = self.insert_count(f01, f10)
        frames, times = [], []
        for k in range(1, n):
            t = float(k) / n
            frames.append(self._interp_fn(i0, i1, f01, f10, t))
            times.append(t)
        return frames, times

    def upsample_sequence(
        self, frames: np.ndarray, timestamps: Sequence[float]
    ) -> Tuple[np.ndarray, List[float]]:
        """frames: (N, H, W, 3) float in [0, 1].  Returns (upsampled frames
        in [0, 1], timestamps), as Upsampler.upsample_sequence
        (upsampler.py:100-134): each pair emits I0 and its intermediates;
        the sequence's last frame is never emitted."""
        mean = torch.tensor(MEAN, dtype=torch.float32, device=self.device)
        H, W = frames.shape[1:3]
        # the 5-level UNet needs /32 sides: edge-pad for the network, crop
        # the outputs back
        ph, pw = (-H) % 32, (-W) % 32

        def load(f):
            x = torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(self.device)
            x = F.pad(x.permute(2, 0, 1)[None], (0, pw, 0, ph), mode="replicate")
            return x.permute(0, 2, 3, 1) - mean

        out_frames: List[np.ndarray] = []
        out_ts: List[float] = []
        i1 = load(frames[0])
        for idx in range(len(frames) - 1):
            i0, i1 = i1, load(frames[idx + 1])
            t0, t1 = float(timestamps[idx]), float(timestamps[idx + 1])
            out_frames.append(np.asarray(frames[idx], np.float32))
            out_ts.append(t0)
            mids, fracs = self.interpolate_pair(i0, i1)
            for f, fr in zip(mids, fracs):
                out_frames.append(torch.clamp(f[0, :H, :W] + mean, 0.0, 1.0).cpu().numpy())
                out_ts.append(t0 + fr * (t1 - t0))
        return np.stack(out_frames), out_ts


# ---------------------------------------------------------------------- checkpoints


# Non-tensor metadata the upstream Super-SloMo training script stores beside
# the two state dicts: a ``datetime`` timestamp (strings, ints, floats and
# lists of them load under ``weights_only`` without an allowlist).
CHECKPOINT_METADATA_TYPES = [datetime.datetime]


def load_checkpoint(path: str, device="cuda") -> SuperSloMo:
    """The published ``SuperSloMo.ckpt`` (keys ``state_dictFC`` /
    ``state_dictAT``, upsampler.py:66-68), loaded as it is: the
    counterpart of the JAX package's ``convert_torch_checkpoint``.  It
    loads with ``weights_only=True``, allowing the training script's
    metadata types (:data:`CHECKPOINT_METADATA_TYPES`) and refusing any
    other class.  The model goes to the card unless ``device`` says
    otherwise; without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("superslomo.load_checkpoint: no CUDA device is available; pass "
                           "device='cpu' to load on the CPU")
    with torch.serialization.safe_globals(CHECKPOINT_METADATA_TYPES):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    flow, interp = SloMoUNet(6, 4), SloMoUNet(20, 5)
    flow.load_state_dict(ckpt["state_dictFC"], strict=True)
    interp.load_state_dict(ckpt["state_dictAT"], strict=True)
    return SuperSloMo(flow.to(device), interp.to(device))


def save_checkpoint(path: str, flow_sd: Dict[str, torch.Tensor],
                    interp_sd: Dict[str, torch.Tensor]) -> None:
    """Write the two UNets' state_dicts in the published checkpoint's
    layout (what :func:`load_checkpoint` and the JAX package's
    ``convert_torch_checkpoint`` read)."""
    cpu = lambda sd: {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    torch.save({"state_dictFC": cpu(flow_sd), "state_dictAT": cpu(interp_sd)}, path)


def init_unet_(unet: SloMoUNet, generator: torch.Generator) -> SloMoUNet:
    """torch's default Conv2d initialisation, U(+-1/sqrt(fan_in)) for the
    weights and the biases, drawn from ``generator``."""
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
    return unet

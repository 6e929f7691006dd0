"""Reusable block library (port of ``ebfi_tpu/models/library.py``).

Counterparts of the reference's model-misc toolbox
(models/model_misc/submodules.py): residual blocks, recurrent conv cells
(ConvLSTM :460-519, ConvGRU :522-560), up and transposed conv layers
(:204-260), self-attention (:80-112), MLP (:67-77), 1D conv (:115-156),
and the parameterised UNet the JAX package builds from them.

Image blocks take and return NHWC tensors; recurrent cells map
``(carry, x) -> (carry, y)``.  Constructors take the input width first,
which flax infers.  Submodule names are the flax names, so
``params_from_jax`` maps a flax tree onto them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvLayer, activation_fn, conv2d_nhwc, nchw, nhwc


def _act(name: Optional[str], y: torch.Tensor) -> torch.Tensor:
    fn = activation_fn(name)
    return fn(y) if fn else y


def _same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A bare 'SAME' conv on NHWC (flax ``nn.Conv`` with padding k // 2)."""
    return conv2d_nhwc(x, conv.weight, conv.bias, padding=conv.padding[0])


def _carry_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_carry: no CUDA device is available; pass device='cpu' for a "
                           "carry on the CPU")
    return device


class ResidualBlock(nn.Module):
    """conv-act-conv + skip (submodules.py ResidualBlock).  Its ConvLayers
    run as the JAX block calls them, without ``train``: a BN norm uses its
    running statistics."""

    def __init__(self, features: int, activation: str = "ReLU", norm: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.conv1 = ConvLayer(features, features, 3, 1, 1, activation, norm)
        self.conv2 = ConvLayer(features, features, 3, 1, 1, None, norm)

    def forward(self, x):
        return _act(self.activation, self.conv2(self.conv1(x)) + x)


class TransposedConvLayer(nn.Module):
    """2x upsampling transposed conv (submodules.py:204-231): flax
    ``ConvTranspose(strides=2, padding='SAME')``, whose output is 2H x 2W:
    the input dilated by 2 and padded by lax's 'SAME' transpose padding."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4,
                 activation: Optional[str] = "ReLU"):
        super().__init__()
        self.activation = activation
        self.conv = nn.ConvTranspose2d(in_ch, features, kernel_size, stride=2)
        k, s = kernel_size, 2
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
        # conv_transpose2d without padding pads k - 1 on both sides
        self.crop = (k - 1 - lo, k - 1 - (pad_len - lo))

    def forward(self, x):
        y = F.conv_transpose2d(nchw(x), self.conv.weight, self.conv.bias, stride=2)
        a, b = self.crop
        y = F.pad(y, (-a, -b, -a, -b))
        return _act(self.activation, nhwc(y))


class UpsampleConvLayer(nn.Module):
    """Bilinear upsample (half-pixel centres, ``jax.image.resize``) + conv:
    checkerboard-free upsampling (submodules.py:234-260)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, scale: int = 2,
                 activation: Optional[str] = "ReLU"):
        super().__init__()
        self.scale, self.activation = scale, activation
        self.conv = nn.Conv2d(in_ch, features, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        up = F.interpolate(nchw(x), scale_factor=self.scale, mode="bilinear",
                           align_corners=False)
        y = F.conv2d(up, self.conv.weight, self.conv.bias, padding=self.conv.padding)
        return _act(self.activation, nhwc(y))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM (submodules.py:460-519)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.gates = nn.Conv2d(in_ch + features, 4 * features, kernel_size,
                               padding=kernel_size // 2)

    def forward(self, carry, x):
        h, c = carry
        i, f, o, g = torch.chunk(_same_conv(self.gates, torch.cat([x, h], dim=-1)), 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (h_new, c_new), h_new

    @staticmethod
    def init_carry(batch, height, width, features, dtype=torch.float32, device="cuda"):
        """Zero (h, c), each (batch, height, width, features), on the card
        unless ``device`` says otherwise; without a card it raises."""
        z = torch.zeros((batch, height, width, features), dtype=dtype,
                        device=_carry_device(device))
        return (z, z)


class ConvGRUCell(nn.Module):
    """Convolutional GRU (submodules.py:522-560)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3):
        super().__init__()
        conv = lambda: nn.Conv2d(in_ch + features, features, kernel_size,
                                 padding=kernel_size // 2)
        self.update, self.reset, self.out = conv(), conv(), conv()

    def forward(self, carry, x):
        h = carry
        xh = torch.cat([x, h], dim=-1)
        update = torch.sigmoid(_same_conv(self.update, xh))
        reset = torch.sigmoid(_same_conv(self.reset, xh))
        out = torch.tanh(_same_conv(self.out, torch.cat([x, h * reset], dim=-1)))
        h_new = h * (1.0 - update) + out * update
        return h_new, h_new

    @staticmethod
    def init_carry(batch, height, width, features, dtype=torch.float32, device="cuda"):
        """Zero h, (batch, height, width, features), on the card unless
        ``device`` says otherwise; without a card it raises."""
        return torch.zeros((batch, height, width, features), dtype=dtype,
                           device=_carry_device(device))


class RecurrentConvLayer(nn.Module):
    """Downsampling conv + recurrent cell (submodules.py:263-306)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 2,
                 recurrent_block_type: str = "convlstm", activation: str = "ReLU",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = ConvLayer(in_ch, features, kernel_size, stride, kernel_size // 2,
                              activation, norm)
        cell = ConvLSTMCell if recurrent_block_type == "convlstm" else ConvGRUCell
        self.cell = cell(features, features)

    def forward(self, carry, x):
        return self.cell(carry, self.conv(x))


class SelfAttention(nn.Module):
    """Offset self-attention over point or token sets (submodules.py:80-112):
    one projection shared by queries and keys, as the reference has it."""

    def __init__(self, channels: int):
        super().__init__()
        self.qk_proj = nn.Linear(channels, channels // 4, bias=False)
        self.v_proj = nn.Linear(channels, channels)
        self.trans = nn.Linear(channels, channels)

    def forward(self, x):  # (B, N, C)
        q = self.qk_proj(x)
        k = self.qk_proj(x)
        v = self.v_proj(x)
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k), dim=-1)
        attn = attn / (1e-9 + attn.sum(dim=1, keepdim=True))
        r = torch.einsum("bmc,bnm->bnc", v, attn)
        r = self.trans(x - r)
        var, mean = torch.var_mean(r, dim=(0, 1), keepdim=True, correction=0)
        return x + F.relu((r - mean) / torch.sqrt(var + 1e-5))


class MLP(nn.Module):
    """ReLU MLP (submodules.py:67-77): layers ``layer0`` ... ``layer{n-1}``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.num_layers - 1}")(x)


class ConvLayer1D(nn.Module):
    """1D conv + optional norm + activation on (B, L, C) (submodules.py:
    115-156).  "BN" normalises by the batch's statistics, without a scale,
    bias or running statistics, as the JAX layer does."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, activation: Optional[str] = "ReLU",
                 norm: Optional[str] = None):
        super().__init__()
        self.activation, self.norm = activation, norm
        self.conv = nn.Conv1d(in_ch, features, kernel_size, stride, padding, bias=norm != "BN")

    def forward(self, x):
        y = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.norm == "BN":
            var, mean = torch.var_mean(y, dim=(0, 1), keepdim=True, correction=0)
            y = (y - mean) / torch.sqrt(var + 1e-5)
        return _act(self.activation, y)


class UNet(nn.Module):
    """Parameterised encoder-decoder with skip connections (the library
    UNet family, models/model_misc/unet.py): ``num_encoders`` stride-2
    stages, a residual bottleneck, a transposed- or upsample-conv decoder,
    skips summed or concatenated."""

    def __init__(self, in_ch: int, base_channels: int = 32, num_encoders: int = 3,
                 num_residual_blocks: int = 2, out_channels: int = 1, skip_type: str = "sum",
                 upsample_type: str = "transpose", activation: str = "ReLU",
                 final_activation: Optional[str] = "Sigmoid"):
        super().__init__()
        self.num_encoders, self.num_residual_blocks = num_encoders, num_residual_blocks
        self.skip_type, self.final_activation = skip_type, final_activation
        ch = base_channels
        self.head = ConvLayer(in_ch, ch, 5, 1, 2, activation)
        for i in range(num_encoders):
            self.add_module(f"enc{i}", ConvLayer(ch, 2 * ch, 5, 2, 2, activation))
            ch *= 2
        for i in range(num_residual_blocks):
            self.add_module(f"res{i}", ResidualBlock(ch, activation))
        cin = ch
        for i in range(num_encoders):
            ch //= 2
            dec = (TransposedConvLayer(cin, ch, 4, activation) if upsample_type == "transpose"
                   else UpsampleConvLayer(cin, ch, 3, 2, activation))
            self.add_module(f"dec{i}", dec)
            cin = ch if skip_type == "sum" else 2 * ch
        self.pred = ConvLayer(cin, out_channels, 3, 1, 1, None)

    def forward(self, x):
        h = self.head(x)
        skips = []
        for i in range(self.num_encoders):
            skips.append(h)
            h = getattr(self, f"enc{i}")(h)
        for i in range(self.num_residual_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(self.num_encoders):
            h = getattr(self, f"dec{i}")(h)
            skip = skips.pop()
            h = h + skip if self.skip_type == "sum" else torch.cat([h, skip], dim=-1)
        return _act(self.final_activation, self.pred(h))

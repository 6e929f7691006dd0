"""End-to-end numerical parity: reference-style torch checkpoint ->
convert_torch_checkpoint -> our model reproduces the torch forward to float
tolerance.

The oracle is a *functional* torch evaluation of the reference math
(model_singleframe.py semantics) driven directly off a synthetic state_dict
with the reference's parameter names — the exact tensors the converter
consumes.  This validates both the converter's name/layout mapping and the
model's math in one shot (BASELINE.md: outputs match to float tolerance).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_checkpoint import convert_evfi_state_dict

from ebfi_tpu.models import EVFIAutoEx
import torch_threads  # noqa: F401  (one intra-op thread per test process)

C, TB, STEP = 8, 4, 2
CHANNELS = (4, 6, 8, 12)
K = 5


# ----------------------------------------------------------------- #
# synthetic reference-style state_dict

def make_state_dict(rng):
    sd = {}

    def conv2d(name, i, o, k):
        sd[f"{name}.conv2d.weight"] = rng.standard_normal((o, i, k, k)).astype(np.float32) * 0.1
        sd[f"{name}.conv2d.bias"] = rng.standard_normal(o).astype(np.float32) * 0.1

    conv2d("FrameFeatExtract", 3, C, 3)
    conv2d("EventFeatExtract", 2 * TB, C, 3)

    conv2d("ExposureDecision.EventFeatExtract", 2 * TB, C, 3)
    conv2d("ExposureDecision.BLFeatExtract", 4, C, 3)
    sd["ExposureDecision.GroupNorm.weight"] = rng.standard_normal(C).astype(np.float32)
    sd["ExposureDecision.GroupNorm.bias"] = rng.standard_normal(C).astype(np.float32) * 0.1
    conv2d("ExposureDecision.Conv1.0", 2 * C, C, 3)
    conv2d("ExposureDecision.Conv1.1", C, 1, 3)

    for i in range(STEP):
        conv2d(f"ResidualControl.Conv1.{i}.0", 1, C, 1)
        conv2d(f"ResidualControl.Conv2.{i}.0", 1, C, 1)
        conv2d(f"ResidualControl.Conv3.{i}.0", C, C, 3)
        conv2d(f"ResidualControl.Conv3.{i}.1", C, C, 3)
        conv2d(f"ResidualControl.Conv4.{i}.0", C, C, 3)
        conv2d(f"ResidualControl.Conv4.{i}.1", C, C, 3)
        conv2d(f"ResidualControl.Conv5.{i}.0", 2 * C, C, 3)

    conv2d("Modification.Conv1", C, C, 1)
    conv2d("Modification.Conv2", C, C, 3)
    conv2d("Modification.KernelConv", 2 * C, C * K * K, 3)
    conv2d("Modification.Conv3", C, C, 3)

    conv2d("Reconstruction.0.0", C, 4 * C, 3)
    conv2d("Reconstruction.1", C, C, 3)
    conv2d("Reconstruction.2", C, 3, 3)

    # Detail branch (UNet3d_18, bn=False)
    c0, c1, c2, c3 = CHANNELS

    def conv3d(name, i, o, k, bias=False):
        kk = (k, k, k) if isinstance(k, int) else k
        sd[f"{name}.weight"] = rng.standard_normal((o, i, *kk)).astype(np.float32) * 0.1
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(o).astype(np.float32) * 0.1

    conv3d("Detail.encoder.stem.0", 3, c0, (3, 7, 7))
    specs = {1: (c0, c0), 2: (c0, c1), 3: (c1, c2), 4: (c2, c3)}
    for L, (ci, co) in specs.items():
        for B in range(2):
            i = ci if B == 0 else co
            conv3d(f"Detail.encoder.layer{L}.{B}.conv1.0", i, co, 3)
            conv3d(f"Detail.encoder.layer{L}.{B}.conv2.0", co, co, 3)
            conv3d(f"Detail.encoder.layer{L}.{B}.fg.attn_layer.0", co, co, 1, bias=True)
        if ci != co:
            conv3d(f"Detail.encoder.layer{L}.0.downsample.0", ci, co, 1)

    conv3d("Detail.decoder.0.conv.0", c3, c2, 3, bias=True)
    conv3d("Detail.decoder.0.conv.1.attn_layer.0", c2, c2, 1, bias=True)
    # ConvTranspose3d weights are (I, O, kd, kh, kw)
    sd["Detail.decoder.1.upconv.0.weight"] = rng.standard_normal((2 * c2, c1, 3, 4, 4)).astype(np.float32) * 0.1
    sd["Detail.decoder.1.upconv.0.bias"] = rng.standard_normal(c1).astype(np.float32) * 0.1
    conv3d("Detail.decoder.1.upconv.1.attn_layer.0", c1, c1, 1, bias=True)
    sd["Detail.decoder.2.upconv.0.weight"] = rng.standard_normal((2 * c1, c0, 3, 4, 4)).astype(np.float32) * 0.1
    sd["Detail.decoder.2.upconv.0.bias"] = rng.standard_normal(c0).astype(np.float32) * 0.1
    conv3d("Detail.decoder.2.upconv.1.attn_layer.0", c0, c0, 1, bias=True)
    conv3d("Detail.decoder.3.conv.0", 2 * c0, c0, 3, bias=True)
    conv3d("Detail.decoder.3.conv.1.attn_layer.0", c0, c0, 1, bias=True)
    sd["Detail.decoder.4.upconv.0.weight"] = rng.standard_normal((2 * c0, c0, 3, 4, 4)).astype(np.float32) * 0.1
    sd["Detail.decoder.4.upconv.0.bias"] = rng.standard_normal(c0).astype(np.float32) * 0.1
    conv3d("Detail.decoder.4.upconv.1.attn_layer.0", c0, c0, 1, bias=True)
    sd["Detail.feature_fuse.0.weight"] = rng.standard_normal((c0, 2 * c0, 1, 1)).astype(np.float32) * 0.1
    conv2d("Detail.outconv.1", c0, 3, 7)
    del sd["Detail.outconv.1.conv2d.weight"], sd["Detail.outconv.1.conv2d.bias"]
    sd["Detail.outconv.1.weight"] = rng.standard_normal((3, c0, 7, 7)).astype(np.float32) * 0.1
    sd["Detail.outconv.1.bias"] = rng.standard_normal(3).astype(np.float32) * 0.1

    return sd


# ----------------------------------------------------------------- #
# functional torch oracle

def t(sd, k):
    return torch.from_numpy(sd[k])


def cl(sd, name, x, stride=1, pad=1, act="lrelu"):
    y = F.conv2d(x, t(sd, f"{name}.conv2d.weight"), t(sd, f"{name}.conv2d.bias"),
                 stride=stride, padding=pad)
    if act == "lrelu":
        return F.leaky_relu(y, 0.01)
    if act == "sigmoid":
        return torch.sigmoid(y)
    return y


def torch_fac(x, kernel, k):
    p = (k - 1) // 2
    xp = F.pad(x, (p, p, p, p), mode="replicate")
    B, Cc, H, W = x.shape
    patches = F.unfold(xp, k).view(B, Cc * k * k, H, W)
    return (patches * kernel).view(B, Cc, k * k, H, W).sum(2)


def oracle_forward(sd, frame, event, ts, step=STEP):
    """frame (B,3,H,W), event (B,2TB,H,W), ts (B,1); H,W divisible by 8."""
    frame_feat = cl(sd, "FrameFeatExtract", frame, stride=2)
    event_feat = cl(sd, "EventFeatExtract", event, stride=2)

    # ExposureDecision on RGBLap blurriness
    import cv2

    laps = []
    for b in range(frame.shape[0]):
        im = (frame[b].permute(1, 2, 0).numpy() * 255).astype(np.uint8)
        gray = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
        laps.append(cv2.Laplacian(gray, cv2.CV_64F).astype(np.float32))
    bl = torch.cat([frame, torch.from_numpy(np.stack(laps)).unsqueeze(1)], dim=1)

    ef = cl(sd, "ExposureDecision.EventFeatExtract", event)
    bf = cl(sd, "ExposureDecision.BLFeatExtract", bl)
    gn = lambda x: F.group_norm(x, 4, t(sd, "ExposureDecision.GroupNorm.weight"),
                                t(sd, "ExposureDecision.GroupNorm.bias"))
    atten = torch.sigmoid(F.adaptive_avg_pool2d(gn(ef) * gn(bf), 1))
    h = cl(sd, "ExposureDecision.Conv1.0", torch.cat([ef * atten, bf], 1))
    h = cl(sd, "ExposureDecision.Conv1.1", h, act=None)
    ex = torch.sigmoid(F.adaptive_avg_pool2d(h, 1).view(-1, 1))

    # ResidualControl
    exb = ex.unsqueeze(-1).unsqueeze(-1)
    tsb = ts.unsqueeze(-1).unsqueeze(-1)
    inp = event_feat
    for i in range(step):
        ex_scale = cl(sd, f"ResidualControl.Conv1.{i}.0", exb, pad=0)
        t_scale = cl(sd, f"ResidualControl.Conv2.{i}.0", tsb, pad=0)
        exx = cl(sd, f"ResidualControl.Conv3.{i}.1",
                 cl(sd, f"ResidualControl.Conv3.{i}.0", inp))
        tx = cl(sd, f"ResidualControl.Conv4.{i}.1",
                cl(sd, f"ResidualControl.Conv4.{i}.0", inp))
        inp = cl(sd, f"ResidualControl.Conv5.{i}.0",
                 torch.cat([ex_scale * exx + inp, t_scale * tx + inp], 1))

    # Modification
    ev = cl(sd, "Modification.Conv1", inp, pad=0)
    kern = cl(sd, "Modification.KernelConv", torch.cat([ev, frame_feat], 1))
    e1 = cl(sd, "Modification.Conv3", torch_fac(ev, kern, K))
    mod = frame_feat * e1 + cl(sd, "Modification.Conv2", e1)

    # Reconstruction
    up = F.leaky_relu(torch.pixel_shuffle(cl(sd, "Reconstruction.0.0", mod, act=None), 2), 0.01)
    sharp = cl(sd, "Reconstruction.2", cl(sd, "Reconstruction.1", up), act="sigmoid")

    # Detail branch
    final = sharp + detail_forward(sd, frame, sharp)
    return sharp, final


def c3(sd, name, x, stride=(1, 1, 1), pad=(1, 1, 1)):
    w = t(sd, f"{name}.weight")
    b = t(sd, f"{name}.bias") if f"{name}.bias" in sd else None
    return F.conv3d(x, w, b, stride=stride, padding=pad)


def se(sd, name, x):
    g = F.adaptive_avg_pool3d(x, 1)
    g = F.conv3d(g, t(sd, f"{name}.attn_layer.0.weight"), t(sd, f"{name}.attn_layer.0.bias"))
    return x * torch.sigmoid(g)


def block(sd, pre, x, stride=(1, 1, 1), down=False):
    out = F.relu(c3(sd, f"{pre}.conv1.0", x, stride=stride))
    out = c3(sd, f"{pre}.conv2.0", out)
    out = se(sd, f"{pre}.fg", out)
    res = c3(sd, f"{pre}.downsample.0", x, stride=stride, pad=(0, 0, 0)) if down else x
    return F.relu(out + res)


def detail_forward(sd, img0, img1):
    x = torch.stack((img0, img1), dim=2)  # (B, 3, 2, H, W)
    x0 = F.relu(c3(sd, "Detail.encoder.stem.0", x, stride=(1, 2, 2), pad=(1, 3, 3)))
    x1 = block(sd, "Detail.encoder.layer1.0", x0)
    x1 = block(sd, "Detail.encoder.layer1.1", x1)
    x2 = block(sd, "Detail.encoder.layer2.0", x1, stride=(1, 2, 2), down=True)
    x2 = block(sd, "Detail.encoder.layer2.1", x2)
    x3 = block(sd, "Detail.encoder.layer3.0", x2, stride=(1, 2, 2), down=True)
    x3 = block(sd, "Detail.encoder.layer3.1", x3)
    x4 = block(sd, "Detail.encoder.layer4.0", x3, down=True)
    x4 = block(sd, "Detail.encoder.layer4.1", x4)

    lr = lambda v: F.leaky_relu(v, 0.2)
    d3 = lr(se(sd, "Detail.decoder.0.conv.1", c3(sd, "Detail.decoder.0.conv.0", x4)))
    d3 = torch.cat([d3, x3], 1)
    up = lambda name, v: F.conv_transpose3d(
        v, t(sd, f"{name}.0.weight"), t(sd, f"{name}.0.bias"),
        stride=(1, 2, 2), padding=(1, 1, 1))
    d2 = lr(se(sd, "Detail.decoder.1.upconv.1", up("Detail.decoder.1.upconv", d3)))
    d2 = torch.cat([d2, x2], 1)
    d1 = lr(se(sd, "Detail.decoder.2.upconv.1", up("Detail.decoder.2.upconv", d2)))
    d1 = torch.cat([d1, x1], 1)
    d0 = lr(se(sd, "Detail.decoder.3.conv.1", c3(sd, "Detail.decoder.3.conv.0", d1)))
    d0 = torch.cat([d0, x0], 1)
    dout = lr(se(sd, "Detail.decoder.4.upconv.1", up("Detail.decoder.4.upconv", d0)))
    dout = torch.cat(torch.unbind(dout, 2), 1)
    fused = lr(F.conv2d(dout, t(sd, "Detail.feature_fuse.0.weight")))
    pad = F.pad(fused, (3, 3, 3, 3), mode="reflect")
    return F.conv2d(pad, t(sd, "Detail.outconv.1.weight"), t(sd, "Detail.outconv.1.bias"))


# ----------------------------------------------------------------- #

def test_converted_checkpoint_matches_torch_oracle(rng):
    sd = make_state_dict(rng)
    params = convert_evfi_state_dict(sd, step=STEP)

    B, H, W = 2, 32, 32
    frame = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    event = np.abs(rng.standard_normal((B, 2 * TB, H, W))).astype(np.float32)
    ts = rng.uniform(0, 1, (B, 1)).astype(np.float32)

    ref_sharp, ref_final = oracle_forward(
        sd, torch.from_numpy(frame), torch.from_numpy(event), torch.from_numpy(ts)
    )

    model = EVFIAutoEx(
        frame_basech=C, event_basech=C, inter_ch=C, tb=TB,
        blurry_fashion="RGBLap", bl_in=4, step=STEP, channels=CHANNELS,
    )
    sharp, final = model.apply(
        params,
        jnp.asarray(frame.transpose(0, 2, 3, 1)),
        jnp.asarray(event.transpose(0, 2, 3, 1)),
        jnp.asarray(ts),
    )
    np.testing.assert_allclose(
        np.asarray(sharp).transpose(0, 3, 1, 2), ref_sharp.numpy(), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(final).transpose(0, 3, 1, 2), ref_final.numpy(), atol=2e-5
    )

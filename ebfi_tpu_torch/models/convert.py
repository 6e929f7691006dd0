"""Weights across from the JAX package and from reference checkpoints.

``params_from_jax`` maps the flax parameter tree of ``EVFIAutoEx.init``
(as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) onto this
package's ``state_dict`` names and layouts; load the result with
``load_state_dict(..., strict=True)``.  Only numpy crosses over.

Layouts: 2D conv kernels HWIO -> OIHW; 3D conv kernels DHWIO -> OIDHW;
transposed 3D conv kernels, stored (kd, kh, kw, O, I) -> torch's
(I, O, kd, kh, kw), the same axis permutation; ResidualControl's stacked
(S, 3, 3, I, O) -> (S, O, I, 3, 3); GroupNorm and BatchNorm ``scale`` ->
``weight``.  The block library's layers (``models/library.py``) add dense
kernels (in, out) -> (out, in), 1D conv kernels (K, I, O) -> (O, I, K),
and flax ``ConvTranspose`` kernels (kh, kw, I, O), which flax applies
unflipped, -> torch's (I, O, kh, kw) flipped in space.  Module names are
the flax names, with ``Conv_0``/``Conv3D_0``/``ConvTranspose_0`` ->
``conv`` and ``BatchNorm_0``/``GroupNorm_0`` -> ``norm``; the
``batch_stats`` collection's ``mean``/``var`` -> ``running_mean``/
``running_var``.

``superslomo_params_from_jax`` maps the JAX package's SuperSloMo trees
(``{"flow": ..., "interp": ...}``) onto the two UNets' state_dicts, whose
names are the reference checkpoint's.

``lpips_params_from_jax`` does the same for the LPIPS weights, and
``discriminator_params_from_jax`` for the adversarial loss's
discriminators.

``params_from_reference`` maps a reference EVFIAutoEx ``state_dict``
(module names of the reference's ``model_singleframe.py``, as in a ``.pth``
it trained) onto the same ``state_dict``: its name mapping is this
package's copy of ``tools/convert_torch_checkpoint.py``'s, including the
KernelConv bank's reorder from the reference's c-major channels
(c*K*K + tap) to tap-major (tap*C + c); the ResidualControl stages stack.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_RENAME = {"Conv_0": "conv", "Conv3D_0": "conv", "ConvTranspose_0": "conv",
           "BatchNorm_0": "norm", "GroupNorm_0": "norm", "kernel": "weight", "scale": "weight"}
_STATS_RENAME = {"mean": "running_mean", "var": "running_var"}


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
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4 and "ConvTranspose_0" in path:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves, with or without the top 'params' key;
    with it, a 'batch_stats' collection beside it is mapped too) -> a
    state_dict for the port's module of the same configuration."""
    stats = tree.get("batch_stats", {}) if "params" in tree else {}
    if "params" in tree:
        tree = tree["params"]
    sd = {}
    for path, leaf in _flatten(tree):
        arr = _to_torch_layout(path, np.asarray(leaf, dtype=np.float32))
        name = ".".join(_RENAME.get(p, p) for p in path)
        sd[name] = torch.tensor(np.ascontiguousarray(arr))
    for path, leaf in _flatten(stats):
        name = ".".join(_RENAME.get(p, p) for p in path[:-1]) + "." + _STATS_RENAME[path[-1]]
        sd[name] = torch.tensor(np.asarray(leaf, dtype=np.float32))
    return sd


def superslomo_params_from_jax(params: Mapping):
    """``ebfi_tpu.models.superslomo.init_params``' trees (numpy leaves) ->
    (flow UNet state_dict, arbitrary-time UNet state_dict), loadable with
    ``strict=True`` into ``SloMoUNet(6, 4)`` and ``SloMoUNet(20, 5)`` and
    writable as a reference checkpoint (``superslomo.save_checkpoint``)."""
    return params_from_jax(params["flow"]), params_from_jax(params["interp"])


def lpips_params_from_jax(params: Mapping) -> dict:
    """The JAX package's LPIPS weights (``ebfi_tpu.losses.load_lpips_params``,
    numpy or jax leaves) -> the port's (``ebfi_tpu_torch.losses.LPIPS``):
    conv kernels HWIO -> OIHW, biases and heads as they are, the
    ``_real_backbone`` flag kept."""
    out = {}
    for name, leaf in params.items():
        if name == "_real_backbone":
            out[name] = bool(leaf)
            continue
        arr = np.asarray(leaf, dtype=np.float32)
        out[name] = torch.tensor(arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr)
    return out


_DISC_RENAME = {"Conv_0": "conv", "Dense_0": "dense0", "Dense_1": "dense1", "kernel": "weight"}


def discriminator_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The flax tree of one of the JAX package's discriminators (numpy
    leaves) -> the state_dict of the port's (``ebfi_tpu_torch.losses.
    discriminator``) of the same type and input size.  Conv kernels HWIO ->
    OIHW, DHWIO -> OIDHW; linear kernels (in, out) -> (out, in): both
    frameworks flatten the ladder's output in NHWC order, so no row
    permutation is needed; BN ``scale`` and ``bias`` as they are."""
    if "params" in tree:
        tree = tree["params"]
    sd = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=dtype)
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else _to_torch_layout(path, arr)
        sd[".".join(_DISC_RENAME.get(p, p) for p in path)] = torch.tensor(np.ascontiguousarray(arr))
    return sd


# ---------------------------------------------------------------------- reference
# (the name mapping of tools/convert_torch_checkpoint.py, kept here so the
# package imports nothing of the JAX package or its tools)

def _c2d(w):  # torch Conv2d -> HWIO
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _c3d(w):  # torch Conv3d -> DHWIO
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _ct3d(w):  # torch ConvTranspose3d (I,O,kd,kh,kw) -> (kd,kh,kw,O,I)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _conv_layer(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    """Reference ConvLayer 'prefix.conv2d.{weight,bias}' -> flax ConvLayer."""
    out = {"kernel": _c2d(sd[f"{prefix}.conv2d.weight"])}
    if f"{prefix}.conv2d.bias" in sd:
        out["bias"] = sd[f"{prefix}.conv2d.bias"]
    return {"Conv_0": out}


def _se_gating(sd, prefix):
    return {
        "Conv3D_0": {
            "kernel": _c3d(sd[f"{prefix}.attn_layer.0.weight"]),
            "bias": sd[f"{prefix}.attn_layer.0.bias"],
        }
    }


def _reference_to_flax(sd: Dict[str, np.ndarray], step: int) -> dict:
    """Reference EVFIAutoEx state_dict -> the JAX package's flax tree
    (numpy leaves, TPU layouts)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p: dict = {}

    p["frame_feat"] = _conv_layer(sd, "FrameFeatExtract")
    p["event_feat"] = _conv_layer(sd, "EventFeatExtract")

    if "ExposureDecision.EventFeatExtract.conv2d.weight" in sd:
        p["exposure_decision"] = {
            "event_feat": _conv_layer(sd, "ExposureDecision.EventFeatExtract"),
            "bl_feat": _conv_layer(sd, "ExposureDecision.BLFeatExtract"),
            "group_norm": {
                "scale": sd["ExposureDecision.GroupNorm.weight"],
                "bias": sd["ExposureDecision.GroupNorm.bias"],
            },
            "head1": _conv_layer(sd, "ExposureDecision.Conv1.0"),
            "head2": _conv_layer(sd, "ExposureDecision.Conv1.1"),
        }

    if "ResidualControl.Conv1.0.0.conv2d.weight" in sd:
        def stack_w(fmt):
            return np.stack([_c2d(sd[fmt.format(i) + ".weight"]) for i in range(step)])

        def stack_b(fmt):
            return np.stack([sd[fmt.format(i) + ".bias"] for i in range(step)])

        def stack_dense_w(fmt):
            # 1x1 conv over a scalar "image" == Dense: (C,1,1,1) -> (1,C)
            return np.stack([
                sd[fmt.format(i) + ".weight"].reshape(-1, 1).T for i in range(step)
            ])

        p["residual_control"] = {
            "d1": stack_dense_w("ResidualControl.Conv1.{}.0.conv2d"),
            "d1_b": stack_b("ResidualControl.Conv1.{}.0.conv2d"),
            "d2": stack_dense_w("ResidualControl.Conv2.{}.0.conv2d"),
            "d2_b": stack_b("ResidualControl.Conv2.{}.0.conv2d"),
            "conv3a": stack_w("ResidualControl.Conv3.{}.0.conv2d"),
            "conv3a_b": stack_b("ResidualControl.Conv3.{}.0.conv2d"),
            "conv3b": stack_w("ResidualControl.Conv3.{}.1.conv2d"),
            "conv3b_b": stack_b("ResidualControl.Conv3.{}.1.conv2d"),
            "conv4a": stack_w("ResidualControl.Conv4.{}.0.conv2d"),
            "conv4a_b": stack_b("ResidualControl.Conv4.{}.0.conv2d"),
            "conv4b": stack_w("ResidualControl.Conv4.{}.1.conv2d"),
            "conv4b_b": stack_b("ResidualControl.Conv4.{}.1.conv2d"),
            "conv5": stack_w("ResidualControl.Conv5.{}.0.conv2d"),
            "conv5_b": stack_b("ResidualControl.Conv5.{}.0.conv2d"),
        }

    if "Modification.Conv1.conv2d.weight" in sd:
        # The FAC bank-prediction conv: permute torch's c-major output
        # channels (c*K^2 + tap) to the framework's tap-major order
        # (tap*C + c) so each tap is a contiguous lane slice on TPU.
        kc = _conv_layer(sd, "Modification.KernelConv")["Conv_0"]
        ckk = kc["kernel"].shape[-1]
        c_in_bank = sd["Modification.Conv1.conv2d.weight"].shape[0]
        kk = ckk // c_in_bank
        perm = np.arange(ckk).reshape(c_in_bank, kk).T.reshape(-1)  # tap-major
        kc = {"kernel": kc["kernel"][..., perm], "bias": kc["bias"][perm]}
        p["modification"] = {
            "conv1": _conv_layer(sd, "Modification.Conv1"),
            "conv2": _conv_layer(sd, "Modification.Conv2"),
            "conv3": _conv_layer(sd, "Modification.Conv3"),
            "kernel_conv": {"Conv_0": kc},
        }

    p["recon_up"] = _conv_layer(sd, "Reconstruction.0.0")
    p["recon_mid"] = _conv_layer(sd, "Reconstruction.1")
    p["recon_out"] = _conv_layer(sd, "Reconstruction.2")

    if "Detail.encoder.stem.0.weight" in sd:
        enc = {"stem": {"kernel": _c3d(sd["Detail.encoder.stem.0.weight"])}}
        for L in range(1, 5):
            for B in range(2):
                pre = f"Detail.encoder.layer{L}.{B}"
                blk = {
                    "conv1": {"kernel": _c3d(sd[f"{pre}.conv1.0.weight"])},
                    "conv2": {"kernel": _c3d(sd[f"{pre}.conv2.0.weight"])},
                    "fg": _se_gating(sd, f"{pre}.fg"),
                }
                if f"{pre}.downsample.0.weight" in sd:
                    blk["downsample"] = {"kernel": _c3d(sd[f"{pre}.downsample.0.weight"])}
                enc[f"layer{L}_{B}"] = blk
        detail = {"encoder": enc}
        # decoder: 0/3 are Conv_3d, 1/2/4 are upConv3D (model_singleframe.py:182-188)
        for i, kind in ((0, "conv"), (1, "upconv"), (2, "upconv"), (3, "conv"), (4, "upconv")):
            pre = f"Detail.decoder.{i}.{kind}"
            w = sd[f"{pre}.0.weight"]
            entry = {
                ("conv" if kind == "conv" else "upconv"): {
                    "kernel": _c3d(w) if kind == "conv" else _ct3d(w),
                    "bias": sd[f"{pre}.0.bias"],
                },
                "fg": _se_gating(sd, f"{pre}.1"),
            }
            detail[f"dec{i}"] = entry
        detail["feature_fuse"] = {"kernel": _c2d(sd["Detail.feature_fuse.0.weight"])}
        detail["outconv"] = {
            "kernel": _c2d(sd["Detail.outconv.1.weight"]),
            "bias": sd["Detail.outconv.1.bias"],
        }
        p["detail"] = detail

    return {"params": p}


def params_from_reference(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference EVFIAutoEx state_dict (tensors or numpy arrays) -> a
    state_dict for the port's module of the same configuration.  The number
    of ResidualControl stages is read from the names."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in sd.items()}
    stages = {int(m.group(1)) for k in sd
              if (m := re.match(r"ResidualControl\.Conv1\.(\d+)\.", k))}
    return params_from_jax(_reference_to_flax(sd, step=len(stages)))

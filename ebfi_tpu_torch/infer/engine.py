"""Inference engine with multi-timestamp trunk reuse (port of
``ebfi_tpu/infer/engine.py``).

The T-independent trunk (feature extraction, blurriness map, exposure
decision) runs once per blurry frame; only the tail runs per requested
timestamp.  The engine's calls run under ``torch.inference_mode()``;
:func:`interpolate_all`, the multi-timestamp call itself, does not, so
``tools/export.py`` can export it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import pad_amounts_to_multiple
from ..utils.precision import PRECISIONS, compute_copy


class InferenceEngine:
    """Wraps an ``EVFIAutoEx`` module for single- and multi-timestamp calls.

    precision: 'f32' for strict parity, 'bf16' for serving; the module's
    parameters stay f32 and a cast copy computes.  fast_math (default: True
    for bf16, False for f32) hoists the per-frame work out of the
    timestamp sweep and fuses Modification's bank prediction into the FAC
    kernels (B3 in ``forward``, B2 in the hoisted tail) -- the same math up
    to float reassociation and, in bf16, B2's rounding of the frame-feature
    half of the bank.  device: 'cuda' unless the caller asks for 'cpu'.
    """

    def __init__(
        self,
        model,
        precision: str = "f32",
        multi_chunk: int = 16,
        fast_math: Optional[bool] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if fast_math is None:
            fast_math = precision == "bf16"
        self.model = model
        self.precision = precision
        self.dtype = PRECISIONS[precision]
        self.multi_chunk = multi_chunk
        self._hoist = fast_math
        self.compute_model = compute_copy(model, precision, self.device)
        if fast_math and self.compute_model.modification is not None:
            self.compute_model.modification.fused = True

    def _cast(self, *xs):
        return [
            None if x is None else torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
            for x in xs
        ]

    @torch.inference_mode()
    def forward(self, frame, event, t, gt_ex=None):
        """(sharp, final) for one timestamp per frame, f32, NHWC."""
        frame, event, t, gt_ex = self._cast(frame, event, t, gt_ex)
        sharp, final = self.compute_model(frame, event, t, gt_ex)
        return sharp.float(), final.float()

    @torch.inference_mode()
    def interpolate(self, frame, event, ts, gt_ex=None, mode: str = "batched",
                    outputs: str = "both"):
        """All timestamps of each frame with trunk reuse.

        frame (B, H, W, 3), event (B, H, W, 2*TB), ts (B, N) -> (sharp,
        final), each (N, B, H, W, 3) f32.  mode 'batched' folds timestamps
        into the batch in chunks of ``multi_chunk`` (hoisted per frame under
        fast_math); 'scan' runs one timestamp at a time.  outputs='final'
        returns None for sharp."""
        frame, event, ts, gt_ex = self._cast(frame, event, ts, gt_ex)
        return interpolate_all(self.compute_model, frame, event, ts, gt_ex, self.multi_chunk,
                               self._hoist, mode, outputs)


def interpolate_all(m, frame, event, ts, gt_ex, multi_chunk: int, hoist: bool,
                    mode: str = "batched", outputs: str = "both"):
    """:meth:`InferenceEngine.interpolate` on inputs already in the compute
    model ``m``'s dtype and device, without ``inference_mode``: the one
    implementation of the multi-timestamp call, which the engine runs and
    ``tools/export.py`` exports.  ``hoist``: the engine's fast_math."""
    if mode not in ("batched", "scan"):
        raise ValueError(f"unknown mode {mode!r}")
    if outputs not in ("both", "final"):
        raise ValueError(f"unknown outputs {outputs!r}")
    B, H, W, _ = frame.shape
    N = ts.shape[1]
    if gt_ex is None:
        gt_ex = frame.new_zeros((B, 1))
    pt, pb, pl, pr = pad_amounts_to_multiple(H, W, 8, 8)
    if pt or pb or pl or pr:
        frame = F.pad(frame, (0, 0, pl, pr, pt, pb))
        event = F.pad(event, (0, 0, pl, pr, pt, pb))
    trunk = m.features(frame, event, gt_ex)

    chunk = min(N, multi_chunk)
    n_chunks = -(-N // chunk)
    ts_p = torch.cat([ts, ts[:, -1:].expand(B, n_chunks * chunk - N)], dim=1)
    sharps, finals = [], []
    if mode == "batched" and hoist and m.dual_path and m.residual:
        # per frame: hoist its T-independent stage partials at batch 1,
        # then the tail at batch `chunk`
        per_frame_s, per_frame_f = [], []
        for b in range(B):
            tr_f = tuple(x[b : b + 1] for x in trunk)
            h_f = m.hoist(tr_f)
            fs, ff = [], []
            for c in range(n_chunks):
                t_c = ts_p[b, c * chunk : (c + 1) * chunk, None]
                s, f = m.from_timestamp_shared(tr_f, h_f, t_c)
                ff.append(f.float())
                if outputs == "both":
                    fs.append(s.float())
            per_frame_f.append(torch.cat(ff)[:N])
            if fs:
                per_frame_s.append(torch.cat(fs)[:N])
        finals = torch.stack(per_frame_f, dim=1)
        sharps = torch.stack(per_frame_s, dim=1) if per_frame_s else None
    elif mode == "scan":
        for i in range(N):
            s, f = m.from_timestamp(*trunk, ts[:, i : i + 1])
            finals.append(f.float())
            if outputs == "both":
                sharps.append(s.float())
        finals = torch.stack(finals)
        sharps = torch.stack(sharps) if sharps else None
    else:
        # fold a chunk of timestamps into the batch; the trunk repeats
        trunk_rep = tuple(x.repeat_interleave(chunk, dim=0) for x in trunk)
        for c in range(n_chunks):
            t_c = ts_p[:, c * chunk : (c + 1) * chunk].reshape(B * chunk, 1)
            s, f = m.from_timestamp(*trunk_rep, t_c)
            per_t = lambda o: o.float().reshape(B, chunk, *o.shape[1:]).transpose(0, 1)
            finals.append(per_t(f))
            if outputs == "both":
                sharps.append(per_t(s))
        finals = torch.cat(finals)[:N]
        sharps = torch.cat(sharps)[:N] if sharps else None

    crop = lambda o: o[:, :, pt : pt + H, pl : pl + W, :]
    return (crop(sharps) if sharps is not None else None), crop(finals)

"""Export the serving engine's call as a ``torch.export`` program
(counterpart of ``tools/export_stablehlo.py``).

    python -m ebfi_tpu_torch.tools.export --checkpoint model.pt --output model.pt2 \\
        --height 720 --width 1280 --num_t 16 --precision f32|bf16 [--device cuda|cpu]

``num_t > 1`` exports the engine's batched multi-timestamp call
(``InferenceEngine.interpolate``, hoisted under bf16's fast_math), whose
outputs are (sharps, finals), each (num_t, 1, H, W, 3) f32; ``num_t = 1``
the single forward (``InferenceEngine.forward``), (sharp, final), each
(1, H, W, 3) f32.  The inputs are the JAX tool's four, f32 at a fixed
size: frame (1, H, W, 3), event (1, H, W, 2*TB), ts (1, num_t) and gt_ex
(1, 1); the program casts them to the precision's dtype.

The program calls the kernels as the custom ops ``ebfi::fac``,
``ebfi::mod_fac`` and ``ebfi::mod_fac_shared``, with the raw weights as
their inputs.  So loading a ``.pt2`` needs ``import ebfi_tpu_torch.ops``
first, which registers them::

    import ebfi_tpu_torch.ops  # noqa: F401
    program = torch.export.load("model.pt2").module()
    with torch.no_grad():
        sharps, finals = program(frame, event, ts, gt_ex)

On the device it was exported for, the program launches the hand kernels
(CUDA) or runs their plain versions (CPU).  ``--device`` defaults to
``cuda`` and raises without a card.  The program does not carry PyTorch's
TF32 switches: an f32 program computes as the engine does (f32
convolutions) where the caller sets ``torch.backends.cudnn.allow_tf32 =
False``, as the infer CLI does for ``--precision f32``; PyTorch's default
lets cuDNN run them in TF32.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.nn as nn

from ..infer.engine import interpolate_all


class ServingCall(nn.Module):
    """The engine's call as a module over its compute model, whose
    parameters the exported program carries."""

    def __init__(self, engine, num_t: int):
        super().__init__()
        self.model = engine.compute_model
        self.dtype = engine.dtype
        self.num_t = num_t
        self.multi_chunk = engine.multi_chunk
        self.hoist = engine._hoist

    def forward(self, frame, event, ts, gt_ex):
        frame, event, ts, gt_ex = (x.to(self.dtype) for x in (frame, event, ts, gt_ex))
        if self.num_t > 1:
            return interpolate_all(self.model, frame, event, ts, gt_ex, self.multi_chunk,
                                   self.hoist)
        sharp, final = self.model(frame, event, ts, gt_ex)
        return sharp.float(), final.float()


def export_model(checkpoint: str, height: int, width: int, num_t: int,
                 precision: str = "f32", device="cuda") -> torch.export.ExportedProgram:
    """The engine's call on a port checkpoint or a reference ``.pth``
    (``infer.cli.load_model``) at a fixed H x W x num_t, exported."""
    from ..infer.cli import load_model

    _, engine = load_model(checkpoint, precision=precision, device=device)
    return export_engine(engine, height, width, num_t)


def export_engine(engine, height: int, width: int, num_t: int) -> torch.export.ExportedProgram:
    """:func:`export_model` of an ``InferenceEngine`` already built."""
    tb = engine.compute_model.event_feat.conv.in_channels // 2
    call = ServingCall(engine, num_t).eval()
    shapes = [(1, height, width, 3), (1, height, width, 2 * tb), (1, num_t), (1, 1)]
    args = tuple(torch.zeros(s, device=engine.device) for s in shapes)
    with torch.no_grad():
        program = torch.export.export(call, args, strict=False)
    # the zero inputs it was traced with are not kept: at 720p they would be
    # most of the file
    program.example_inputs = None
    return program


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--num_t", type=int, default=16)
    p.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    p.add_argument("--device", default="cuda", help="cuda (default; needs a card) or cpu")
    flags = p.parse_args(argv)

    program = export_model(flags.checkpoint, flags.height, flags.width, flags.num_t,
                           flags.precision, flags.device)
    torch.export.save(program, flags.output)
    size = os.path.getsize(flags.output)
    print(f"wrote {flags.output}: {size / 1e6:.1f} MB ({flags.precision}, {flags.device})")


if __name__ == "__main__":
    main()

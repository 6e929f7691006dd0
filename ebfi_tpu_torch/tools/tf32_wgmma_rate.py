#!/usr/bin/env python3
"""Rate of register-A TF32 wgmma on one Hopper card, at N = 64 and 128,
and how its f32 accumulator rounds.

    python3 -m ebfi_tpu_torch.tools.tf32_wgmma_rate [--steps 20000]

Builds ``tf32_wgmma_rate.cu`` beside it with nvcc (the kernels' flags and
``ebfi_tpu_torch/csrc/hopper.cuh``) into a temporary directory and prints
the card, then one JSON line:
- rate: one block of two warpgroups per SM, each issuing three m64nNk8
  wgmma per step (the 3xTF32 kernel's pattern, no loads): TFLOP/s at each
  width against the 495 TFLOP/s TF32 peak, the ceiling behind
  ``csrc/mod_fac.cu``'s choice of N = 128 (two taps per accumulator);
- rounding: D = A B over a 1152-deep sum (the bank conv's depth) on TF32
  inputs, so every product is exact, one wgmma per k8 step, against the
  exact f64 sum and two emulations that add each step's exact partial to
  an f32 accumulator rounded to nearest or toward zero: the share of
  outputs each emulation matches bit for bit, and the mean error in
  units of the output's f32 ulp, signed toward zero (about 0 for
  round-to-nearest, about -0.5 per add for truncation).
Needs a CUDA card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_TF32 = 495e12  # H100 SXM, dense, NVIDIA data sheet
DEPTH = 1152  # the bank conv's depth, 9 * 2C


def tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits, ties away), as cvt.rna does."""
    bits = x.astype(np.float32).view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    return (sign | ((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000))).view(np.float32)


def toward_zero(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def rounding(lib, torch) -> dict:
    rng = np.random.default_rng(0)
    a = tf32(rng.standard_normal((64, DEPTH)).astype(np.float32))
    b = tf32((0.05 * rng.standard_normal((DEPTH, 64))).astype(np.float32))
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    td = torch.empty((64, 64), device="cuda")
    err = lib.tf32_wgmma_sum(ta.data_ptr(), tb.data_ptr(), td.data_ptr(), DEPTH)
    if err:
        raise RuntimeError(f"tf32_wgmma_rate: the rounding probe failed with CUDA error {err}")
    got = td.cpu().numpy()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = a64 @ b64
    nearest = np.zeros((64, 64), np.float32)
    zero = np.zeros((64, 64), np.float32)
    for k in range(0, DEPTH, 8):
        part = a64[:, k:k + 8] @ b64[k:k + 8]
        nearest = (nearest.astype(np.float64) + part).astype(np.float32)
        zero = toward_zero(zero.astype(np.float64) + part)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    toward = np.sign(exact) * (got.astype(np.float64) - exact) / ulp
    return {"depth": DEPTH, "match_nearest": float((got == nearest).mean()),
            "match_toward_zero": float((got == zero).mean()),
            "mean_ulp_signed_toward_zero": float(toward.mean()),
            "max_abs_err": float(np.abs(got - exact).max()),
            "max_abs_err_nearest": float(np.abs(nearest - exact).max()),
            "max_abs_err_toward_zero": float(np.abs(zero - exact).max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tf32_wgmma_rate: no CUDA device", file=sys.stderr)
        return 2
    from ..ops.cuda import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "tf32_wgmma_rate.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR),
                        "-o", lib_path, os.path.join(HERE, "tf32_wgmma_rate.cu")],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(lib_path)
        lib.tf32_wgmma_ms.argtypes = [ctypes.c_int] * 3
        lib.tf32_wgmma_ms.restype = ctypes.c_float
        lib.tf32_wgmma_sum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        lib.tf32_wgmma_sum.restype = ctypes.c_int
        result = {"card": card, "blocks": blocks, "steps": args.steps}
        for n in [64, 128] * args.repeats:
            ms = lib.tf32_wgmma_ms(n, blocks, args.steps)
            if ms <= 0:
                raise RuntimeError(f"tf32_wgmma_rate: the N={n} launch failed")
            flops = blocks * 2 * 3 * 2 * 64 * n * 8 * args.steps  # warpgroups, wgmma, 2*m*n*k
            result.setdefault(f"tflops_n{n}", []).append(flops / ms / 1e9)
        result["rounding"] = rounding(lib, torch)
    print(card)
    print(json.dumps({**result, "peak_tflops": PEAK_TF32 / 1e12}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

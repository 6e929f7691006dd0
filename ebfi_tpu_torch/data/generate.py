"""Offline dataset generation: frame sequences -> training clips (port of
``tools/generate_dataset.py``).

    python -m ebfi_tpu_torch.data.generate --input_dir SEQS --output_dir OUT \\
        [--fps 240] [--slomo_ckpt SuperSloMo.ckpt | --upsample_factor N] \\
        [--contrast_min 0.2 --contrast_max 0.5 --ct_mu 1.0 --ct_sigma 0.1] \\
        [--refractory 1e-4] [--seed 0] [--device cuda|cpu]

Each directory under ``--input_dir`` is one sequence of PNG frames (e.g. a
240 fps GoPro sequence).  Per sequence, in the JAX tool's order:

1. the frames are read as cv2 reads them (BGR; grey and RGBA PNGs become
   BGR, the alpha dropped).  JPEG frames raise: there is no JPEG decoder
   here;
2. with ``--slomo_ckpt``, SuperSloMo upsamples each frame pair adaptively
   on ``--device`` (``ceil(max |flow|)`` frames per pair, the reference's
   policy), fed the BGR frames / 255 as the JAX tool feeds them, back to
   uint8 as ``x * 255 + 0.5``; otherwise ``--upsample_factor`` blends
   consecutive frames linearly;
3. the contrast thresholds are drawn per sequence (Cp ~ U[min, max], Cn =
   gauss(mu, sigma) * Cp, both clamped) and ESIM-lite simulates events on
   the RGB frames, with the refractory period;
4. the packager writes ``<output_dir>/<seq>.npz`` (``ebfi_clip_npz/1``, the
   groups ori, down2, down4, down8), which the port's loaders read.

The device runs only SuperSloMo; it is the card unless ``--device cpu``,
and without a card the tool raises.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, List

import numpy as np

from ..utils.vis import read_png
from .packager import package_sequence
from .synth import sample_thresholds, simulate_events


def read_frame_bgr(path: str) -> np.ndarray:
    """One frame as ``cv2.imread(path)`` returns it: HxWx3 uint8 BGR."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG frames are read (no JPEG decoder is available "
                         "without cv2); convert the sequence to PNG")
    px = read_png(path)
    if px.ndim == 2:
        return np.repeat(px[:, :, None], 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])


def read_frames(seq_dir: str) -> np.ndarray:
    paths = sorted(glob.glob(os.path.join(seq_dir, "*.png"))
                   + glob.glob(os.path.join(seq_dir, "*.jpg")))
    return np.stack([read_frame_bgr(p) for p in paths])


def upsample_linear(frames: np.ndarray, factor: int) -> np.ndarray:
    """Cheap temporal upsampling between consecutive frames."""
    if factor <= 1:
        return frames
    out = []
    for i in range(len(frames) - 1):
        a, b = frames[i].astype(np.float32), frames[i + 1].astype(np.float32)
        for k in range(factor):
            w = k / factor
            out.append(((1 - w) * a + w * b).astype(np.uint8))
    out.append(frames[-1])
    return np.stack(out)


def upsample_slomo(frames: np.ndarray, ts: np.ndarray, slomo):
    """Adaptive SuperSloMo upsampling (upsampler.py:100-134 policy)."""
    up, up_ts = slomo.upsample_sequence(frames.astype(np.float32) / 255.0, ts)
    return (up * 255.0 + 0.5).astype(np.uint8), np.asarray(up_ts)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_dir", required=True, help="dir of sequence dirs")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--fps", type=float, default=240.0)
    p.add_argument("--upsample_factor", type=int, default=1)
    p.add_argument("--slomo_ckpt", default=None, help="SuperSloMo.ckpt for adaptive upsampling")
    p.add_argument("--contrast_min", type=float, default=0.2)
    p.add_argument("--contrast_max", type=float, default=0.5)
    p.add_argument("--ct_mu", type=float, default=1.0,
                   help="mean of the Cn/Cp gaussian (syn_gopro.py:23)")
    p.add_argument("--ct_sigma", type=float, default=0.1,
                   help="stddev of the Cn/Cp gaussian (syn_gopro.py:24)")
    p.add_argument("--refractory", type=float, default=1e-4,
                   help="per-pixel refractory period in seconds (syn_gopro.py:17)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="where SuperSloMo runs (cuda, cuda:N, cpu)")
    return p.parse_args(argv)


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run SuperSloMo on the CPU)")
    return dev


def main(argv=None) -> List[Dict]:
    """Generates every sequence; returns one record per sequence: its
    output path, frame and event counts, thresholds, and the seconds spent
    reading, upsampling, simulating and writing."""
    flags = parse_args(argv)
    slomo = None
    if flags.slomo_ckpt:
        import torch

        from ..models.superslomo import load_checkpoint

        dev = _device(flags.device)
        if dev.type == "cuda":  # the f32 parity target: no TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        slomo = load_checkpoint(flags.slomo_ckpt, dev)
    os.makedirs(flags.output_dir, exist_ok=True)
    rng = np.random.default_rng(flags.seed)
    seqs = sorted(d for d in glob.glob(os.path.join(flags.input_dir, "*")) if os.path.isdir(d))
    records = []
    for seq in seqs:
        name = os.path.basename(seq)
        out = os.path.join(flags.output_dir, f"{name}.npz")
        rec = {"sequence": name, "path": out}
        t = time.perf_counter()
        frames = read_frames(seq)
        rec["frames_in"], rec["read_s"] = len(frames), time.perf_counter() - t
        t = time.perf_counter()
        if slomo is not None:
            ts0 = np.arange(len(frames)) / flags.fps
            frames, ts = upsample_slomo(frames, ts0, slomo)
        else:
            frames = upsample_linear(frames, flags.upsample_factor)
            ts = np.arange(len(frames)) / (flags.fps * flags.upsample_factor)
        rec["upsample_s"] = time.perf_counter() - t
        # randomised per-sequence per-polarity thresholds (syn_gopro.py:104-118)
        cp, cn = sample_thresholds(rng, (flags.contrast_min, flags.contrast_max),
                                   flags.ct_mu, flags.ct_sigma)
        t = time.perf_counter()
        rgb = frames[:, :, :, ::-1]
        (xs, ys, ets, ps), _ = simulate_events(rgb, ts, seed=flags.seed, cp=cp, cn=cn,
                                               refractory_period=flags.refractory)
        rec["simulate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        H, W = frames.shape[1:3]
        package_sequence(out, frames, ts, (xs, ys, ets, ps), (H, W))
        rec["write_s"] = time.perf_counter() - t
        rec.update(frames_out=len(frames), events=len(xs), cp=cp, cn=cn)
        records.append(rec)
        print(f"{name}: {len(frames)} frames, {len(xs)} events "
              f"(Cp={cp:.2f}, Cn={cn:.2f}) -> {out}", flush=True)
    return records


if __name__ == "__main__":
    main()

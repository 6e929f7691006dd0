"""Repack schema H5 clips into the ``ebfi_clip_npz/1`` container that the
PyTorch port's fetch plane reads (``ebfi_tpu_torch/data/clip_dataset.py``).

The container is one uncompressed ``.npz`` per clip:

- ``format`` = ``"ebfi_clip_npz/1"``, ``sensor_resolution`` = [H, W]
- ``images``: uint8 (N, H, W, 3), exactly as the H5 stores them
- ``image_ts``: (N,) the images' ``timestamp`` attributes
- per event group ``{p}_events`` (p in ori, down2, ...): ``{p}_xs``,
  ``{p}_ys``, ``{p}_ts``, ``{p}_ps`` in the H5's dtypes and
  ``{p}_event_idx`` (N,), the images' ``{p}_event_idx`` attributes
- when the images carry them: ``exposure_begin_t``, ``exposure_end_t`` (N,)

The clip's file stem is kept: ``clip.h5`` becomes ``<output_dir>/clip.npz``.
Needs h5py and numpy only.

Usage:
  python tools/h5_to_npz.py clip.h5 [more.h5 ...] --output_dir npz/
  python tools/h5_to_npz.py --data_list test.txt --output_dir npz/ \
      [--write_list npz/test.txt]
"""
from __future__ import annotations

import argparse
import os

import h5py
import numpy as np

FORMAT = "ebfi_clip_npz/1"


def h5_to_npz(h5_path: str, output_dir: str) -> str:
    """Repack one clip; returns the path of the ``.npz`` written."""
    stem = os.path.splitext(os.path.basename(h5_path))[0]
    out = os.path.join(output_dir, f"{stem}.npz")
    with h5py.File(h5_path, "r") as f:
        images = f["ori_images"]
        n = len(images.keys())
        dsets = [images[f"image{i:09d}"] for i in range(n)]
        arrays = {
            "format": np.array(FORMAT),
            "sensor_resolution": np.asarray(f.attrs["sensor_resolution"]),
            "images": np.stack([d[:] for d in dsets]),
            "image_ts": np.asarray([d.attrs["timestamp"] for d in dsets], np.float64),
        }
        for group in sorted(f.keys()):
            if not group.endswith("_events"):
                continue
            p = group[: -len("_events")]
            for a in ("xs", "ys", "ts", "ps"):
                arrays[f"{p}_{a}"] = f[group][a][:]
            arrays[f"{p}_event_idx"] = np.asarray(
                [d.attrs[f"{p}_event_idx"] for d in dsets], np.int64)
        for a in ("exposure_begin_t", "exposure_end_t"):
            if a in dsets[0].attrs:
                arrays[a] = np.asarray([d.attrs[a] for d in dsets], np.float64)
    os.makedirs(output_dir, exist_ok=True)
    np.savez(out, **arrays)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("h5", nargs="*", help="schema H5 clips")
    ap.add_argument("--data_list", help="a datalist of H5 clips, one path per line")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--write_list", help="write a datalist of the .npz clips here")
    flags = ap.parse_args(argv)
    paths = list(flags.h5)
    if flags.data_list:
        with open(flags.data_list) as f:
            paths += [ln.strip() for ln in f if ln.strip()]
    if not paths:
        ap.error("no H5 clips given")
    outs = []
    for p in paths:
        outs.append(h5_to_npz(p, flags.output_dir))
        print(f"{p} -> {outs[-1]}")
    if flags.write_list:
        with open(flags.write_list, "w") as f:
            f.write("".join(os.path.abspath(o) + "\n" for o in outs))


if __name__ == "__main__":
    main()

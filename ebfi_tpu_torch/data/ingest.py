"""Real recordings -> ``ebfi_clip_npz/1`` clips, and clip utilities.

    python -m ebfi_tpu_torch.data.ingest bag PATH --output_dir DIR \
        [--event_topic /dvs/events] [--image_topic /dvs/image_raw] [--zero_timestamps]
        [--is_color] [--height H --width W] [--start_time S] [--end_time E]
    python -m ebfi_tpu_torch.data.ingest events --events ev.npz --frames_dir DIR \
        --timestamps ts.txt [--exposures exp.txt] --output clip.npz
    python -m ebfi_tpu_torch.data.ingest txt --txt events.txt [--frames_dir DIR \
        [--timestamps ts.txt]] --output clip.npz
    python -m ebfi_tpu_torch.data.ingest inspect --clip clip.npz
    python -m ebfi_tpu_torch.data.ingest to-memmap --clip clip.npz [--prefix ori] \
        --output_dir DIR
    python -m ebfi_tpu_torch.data.ingest set-array --clip clip.npz --name NAME \
        (--values FILE [--column C] | --value LITERAL)

The counterparts of the JAX package's converters, on the npz container
instead of H5 and without h5py, cv2 or a ROS runtime:

- ``bag``: DAVIS rosbags, ``tools/rosbag_to_h5.py`` (a file, or every
  ``.bag`` of a directory; :func:`ebfi_tpu_torch.data.rosbag.extract_bag`);
- ``events``: an events ``.npz`` (``x, y, t, p``) with PNG frames, their
  timestamps and optional per-frame exposures (``begin end`` per line),
  ``tools/convert_npz.py`` (RealSharp-DAVIS, UEVD);
- ``txt``: ``t x y p`` per line, ``tools/h5_utils.py txt-to-h5``;
- ``inspect``, ``to-memmap``: ``h5_utils.py inspect`` / ``to-memmap``;
- ``set-array``: ``h5_utils.py add-attr``'s counterpart: sets or replaces
  one array of the clip (say ``exposure_begin_t`` from a file of per-image
  values) and rewrites the clip atomically (a temporary file, then a
  rename).

Frames are read by :func:`ebfi_tpu_torch.utils.vis.read_png` (8-bit grey,
RGB or RGBA) and turned into 3-channel BGR as ``cv2.imread`` turns them:
grey replicated, RGBA without its alpha.  Events are sorted by time with a
stable sort and polarities p > 0 become +1, the others -1.
"""
from __future__ import annotations

import argparse
import ast
import glob
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from ..utils.vis import read_png
from .clip_dataset import open_clip
from .packager import package_sequence
from .rosbag import Bag, extract_bag

PER_IMAGE = ("exposure_begin_t", "exposure_end_t")


def imread_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of a PNG, as ``cv2.imread(path)`` reads it."""
    px = read_png(path)
    if px.ndim == 2:
        return np.repeat(px[:, :, None], 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])  # RGB(A) -> BGR, alpha dropped


def read_frames(frames_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(frames_dir, "*.png")))


def convert_events(events: str, frames_dir: str, timestamps: str, output: str,
                   exposures: Optional[str] = None) -> dict:
    """``tools/convert_npz.py``: an events npz, PNG frames and their
    timestamps (and exposures) -> one clip."""
    ev = np.load(events)
    xs, ys, ts, ps = (np.asarray(ev[k]).reshape(-1) for k in ("x", "y", "t", "p"))
    order = np.argsort(ts, kind="stable")
    xs, ys, ts, ps = xs[order], ys[order], ts[order], ps[order]
    ps = np.where(ps > 0, 1, -1)
    paths = read_frames(frames_dir)
    if not paths:
        raise ValueError(f"no PNG frames in {frames_dir}")
    frames = np.stack([imread_bgr(p) for p in paths])
    img_ts = np.loadtxt(timestamps).reshape(-1)
    if len(img_ts) != len(frames):
        raise ValueError(f"{len(img_ts)} timestamps for {len(frames)} frames")
    exp = None
    if exposures:
        exp = [tuple(row) for row in np.loadtxt(exposures).reshape(-1, 2)]
    H, W = frames.shape[1:3]
    package_sequence(output, frames, img_ts, (xs, ys, ts, ps), (H, W), exposures=exp)
    return {"frames": len(frames), "events": len(xs), "sensor_size": (H, W)}


def convert_txt(txt: str, output: str, frames_dir: Optional[str] = None,
                timestamps: Optional[str] = None) -> dict:
    """``tools/h5_utils.py txt-to-h5``: ``t x y p`` per line (and optional
    PNG frames) -> one clip; without frames, two black frames at the first
    and last event's time, at the events' extent."""
    data = np.loadtxt(txt)
    ts, xs, ys, ps = data[:, 0], data[:, 1], data[:, 2], data[:, 3]
    ps = np.where(ps > 0, 1, -1)
    order = np.argsort(ts, kind="stable")
    xs, ys, ts, ps = xs[order], ys[order], ts[order], ps[order]
    if frames_dir:
        paths = read_frames(frames_dir)
        frames = np.stack([imread_bgr(p) for p in paths])
        img_ts = (np.loadtxt(timestamps).reshape(-1) if timestamps
                  else np.linspace(ts[0], ts[-1], len(paths)))
        H, W = frames.shape[1:3]
    else:
        H, W = int(ys.max()) + 1, int(xs.max()) + 1
        frames = np.zeros((2, H, W, 3), np.uint8)
        img_ts = np.array([ts[0], ts[-1]])
    package_sequence(output, frames, img_ts, (xs, ys, ts, ps), (H, W))
    return {"frames": len(frames), "events": len(xs), "sensor_size": (H, W)}


def convert_bags(path: str, output_dir: str, **kwargs) -> Dict[str, dict]:
    """``tools/rosbag_to_h5.py::main``: a bag, or every ``.bag`` of a
    directory, each to ``<output_dir>/<bag name>.npz``; returns each one's
    summary."""
    os.makedirs(output_dir, exist_ok=True)
    paths = (sorted(glob.glob(os.path.join(path, "*.bag"))) if os.path.isdir(path) else [path])
    out = {}
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        with Bag(p) as bag:
            out[name] = extract_bag(bag, os.path.join(output_dir, f"{name}.npz"), **kwargs)
    return out


def describe(clip_path: str) -> List[str]:
    """``h5_utils.py inspect``: the clip's arrays, frames and event groups."""
    clip = open_clip(clip_path)
    lines = [f"format: {clip['format']}; sensor_resolution: "
             f"{[int(v) for v in clip['sensor_resolution']]}"]
    for name in sorted(clip):
        a = clip[name]
        lines.append(f"array {name}: shape={tuple(a.shape)} dtype={a.dtype}")
    n, its = clip["images"].shape[0], clip["image_ts"]
    lines.append(f"images: {n}" + (f"  t in [{its[0]:.6f}, {its[-1]:.6f}]" if n else ""))
    for name in sorted(k for k in clip if k.endswith("_ts") and k != "image_ts"):
        ts = clip[name]
        lines.append(f"events {name[:-3]}: {len(ts)}"
                     + (f"  t in [{ts[0]:.6f}, {ts[-1]:.6f}]" if len(ts) else ""))
    lines.append("exposures: " + ("yes" if all(k in clip for k in PER_IMAGE) else "no"))
    return lines


def to_memmap(clip_path: str, output_dir: str, prefix: str = "ori") -> List[str]:
    """``h5_utils.py to-memmap``: one ``.npy`` per event array of a group."""
    os.makedirs(output_dir, exist_ok=True)
    clip = open_clip(clip_path)
    out = []
    for k in ("xs", "ys", "ts", "ps"):
        path = os.path.join(output_dir, f"{k}.npy")
        np.save(path, np.asarray(clip[f"{prefix}_{k}"]))
        out.append(path)
    return out


def set_array(clip_path: str, name: str, value: np.ndarray) -> None:
    """Set or replace the array ``name`` of a clip; the clip is rewritten
    to a temporary file beside it and renamed into place, so a reader sees
    the old clip or the new one, never a part."""
    with np.load(clip_path) as z:
        arrays = {k: z[k] for k in z.files}
    value = np.asarray(value)
    if name in PER_IMAGE and value.shape != (arrays["images"].shape[0],):
        raise ValueError(f"{name} takes one value per image: shape "
                         f"({arrays['images'].shape[0]},), got {value.shape}")
    arrays[name] = value
    fd, tmp = tempfile.mkstemp(prefix=".set_array_", suffix=".npz",
                               dir=os.path.dirname(os.path.abspath(clip_path)))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, clip_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _value(flags) -> np.ndarray:
    if flags.values is not None:
        data = np.loadtxt(flags.values, dtype=np.float64, ndmin=2)
        if flags.column is not None:
            return np.ascontiguousarray(data[:, flags.column])
        return data.reshape(-1) if data.shape[1] == 1 else data
    return np.asarray(ast.literal_eval(flags.value))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bag", help="DAVIS rosbag(s) -> clip(s)")
    b.add_argument("path", help="bag file or directory of .bag files")
    b.add_argument("--output_dir", required=True)
    b.add_argument("--event_topic", default="/dvs/events")
    b.add_argument("--image_topic", default=None)
    b.add_argument("--zero_timestamps", action="store_true")
    b.add_argument("--is_color", action="store_true")
    b.add_argument("--height", type=int, default=None)
    b.add_argument("--width", type=int, default=None)
    b.add_argument("--start_time", type=float, default=None)
    b.add_argument("--end_time", type=float, default=None)

    e = sub.add_parser("events", help="events npz + PNG frames -> clip")
    e.add_argument("--events", required=True, help="npz with x, y, t, p arrays")
    e.add_argument("--frames_dir", required=True)
    e.add_argument("--timestamps", required=True, help="one timestamp per line")
    e.add_argument("--exposures", default=None, help="'begin end' per line (real blur)")
    e.add_argument("--output", required=True)

    t = sub.add_parser("txt", help="event txt ('t x y p' per line) -> clip")
    t.add_argument("--txt", required=True)
    t.add_argument("--frames_dir", default=None)
    t.add_argument("--timestamps", default=None)
    t.add_argument("--output", required=True)

    i = sub.add_parser("inspect", help="print a clip's arrays")
    i.add_argument("--clip", required=True)

    m = sub.add_parser("to-memmap", help="a clip's event arrays as .npy files")
    m.add_argument("--clip", required=True)
    m.add_argument("--prefix", default="ori")
    m.add_argument("--output_dir", required=True)

    s = sub.add_parser("set-array", help="set or replace one array of a clip")
    s.add_argument("--clip", required=True)
    s.add_argument("--name", required=True)
    src = s.add_mutually_exclusive_group(required=True)
    src.add_argument("--values", help="a text file of numbers (np.loadtxt)")
    src.add_argument("--value", help="a Python literal: a number or a list")
    s.add_argument("--column", type=int, default=None, help="take one column of --values")

    flags = p.parse_args(argv)
    if flags.cmd == "bag":
        size = (None if flags.height is None or flags.width is None
                else (flags.height, flags.width))
        stats = convert_bags(
            flags.path, flags.output_dir, event_topic=flags.event_topic,
            image_topic=flags.image_topic, start_time=flags.start_time,
            end_time=flags.end_time, zero_timestamps=flags.zero_timestamps,
            is_color=flags.is_color, sensor_size=size)
        for name, st in stats.items():
            print(f"{name}: {st}")
    elif flags.cmd == "events":
        st = convert_events(flags.events, flags.frames_dir, flags.timestamps, flags.output,
                            flags.exposures)
        print(f"wrote {flags.output}: {st['frames']} frames, {st['events']} events")
    elif flags.cmd == "txt":
        st = convert_txt(flags.txt, flags.output, flags.frames_dir, flags.timestamps)
        print(f"wrote {flags.output}: {st['events']} events, {st['frames']} frames")
    elif flags.cmd == "inspect":
        print("\n".join(describe(flags.clip)))
    elif flags.cmd == "to-memmap":
        for path in to_memmap(flags.clip, flags.output_dir, flags.prefix):
            a = np.load(path, mmap_mode="r")
            print(f"{path}: {a.shape} {a.dtype}")
    else:
        value = _value(flags)
        set_array(flags.clip, flags.name, value)
        print(f"set {flags.name} {value.shape} {value.dtype} on {flags.clip}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

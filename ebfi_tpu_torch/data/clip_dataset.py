"""Clip datasets over schema H5 clips and the ``ebfi_clip_npz/1``
container (port of ``ebfi_tpu/data/h5dataset.py`` and
``h5dataset_fast.py``): windowing, on-the-fly blur synthesis, event
encoding and seeded augmentation.  A dataset tells the formats apart by
the file's first bytes (the HDF5 signature), not by its suffix.

A schema H5 clip (the JAX package's and the reference's interchange
format, written by ``H5Packager``, ``write_clip_h5`` or the reference's
generator) is read by the port's own HDF5 reader (:mod:`.hdf5`, no
``h5py``): :func:`open_h5_clip` gives it the container's keys, as lazy
views over the file.

The container is one uncompressed ``.npz`` per clip, written by
``tools/h5_to_npz.py`` from a schema H5 clip or by
:func:`ebfi_tpu_torch.data.synth.write_clip_npz`:

- ``format`` = ``"ebfi_clip_npz/1"``; ``sensor_resolution`` = [H, W]
- ``images``: uint8 (N, H, W, 3) exactly as the H5 stores them (BGR for the
  synthetic schema; the synthetic-blur reader flips to RGB, the real-blur
  reader keeps them as stored, like the JAX readers)
- ``image_ts``: (N,) frame timestamps
- per event group ``p`` (``ori``, ``down2``, ...): ``{p}_xs``, ``{p}_ys``,
  ``{p}_ts``, ``{p}_ps`` in the H5's dtypes and ``{p}_event_idx`` (N,), the
  index of each frame's first event
- real-blur clips: ``exposure_begin_t`` and ``exposure_end_t`` (N,)

Arrays are memory-mapped from the file (the members are stored, not
compressed), so a dataset reads only the frames and events a window needs,
as the H5 readers do.  Items are bit-identical to ``H5ClipDataset.get``,
``H5ClipDatasetFast.get`` and ``H5ClipDatasetReal.get`` of the JAX package
on the same H5 clip, or on the H5 an npz clip came from; the classes carry
those names too (:data:`H5ClipDataset`, :data:`H5ClipDatasetFast`,
:data:`H5ClipDatasetReal`).  Frames stored at another resolution than
the GT one (``scale``/``ori_scale``) are resized as the JAX readers resize
them with cv2, by :func:`~ebfi_tpu_torch.data.resize.resize_cubic`.

Event stacks and the blur synthesis of frames stored at the GT resolution
run on the C++ host plane (:mod:`ebfi_tpu_torch.native`, built at first
use), bit for bit with the numpy plane of :mod:`.encodings`.
"""
from __future__ import annotations

import random
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from . import hdf5
from .resize import resize_cubic

FORMAT = "ebfi_clip_npz/1"
_HEADER_READERS = {
    (1, 0): np.lib.format.read_array_header_1_0,
    (2, 0): np.lib.format.read_array_header_2_0,
}


def open_clip(path: str) -> Dict[str, np.ndarray]:
    """The container's arrays, memory-mapped read-only (0-d members read)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: member {name!r} is compressed; write the clip "
                                 "with np.savez (tools/h5_to_npz.py), not np.savez_compressed")
            # the local file header: 30 bytes, then the name and the extra field
            f.seek(info.header_offset + 26)
            n_name, n_extra = np.frombuffer(f.read(4), "<u2")
            f.seek(info.header_offset + 30 + int(n_name) + int(n_extra))
            version = np.lib.format.read_magic(f)
            if version not in _HEADER_READERS:
                raise ValueError(f"{path}: member {name!r} has .npy format {version}")
            shape, fortran, dtype = _HEADER_READERS[version](f)
            if dtype.hasobject:
                raise ValueError(f"{path}: member {name!r} holds Python objects")
            if not shape:
                out[name] = np.frombuffer(f.read(dtype.itemsize), dtype).reshape(())
                continue
            out[name] = np.memmap(path, dtype=dtype, mode="r", shape=shape,
                                  order="F" if fortran else "C", offset=f.tell())
    fmt = str(out.get("format", ""))
    if fmt != FORMAT:
        raise ValueError(f"{path}: not an {FORMAT} clip (format {fmt!r})")
    return out


class _H5Frames:
    """``images`` of an H5 clip: (N, H, W, 3), one ``image{i:09d}`` dataset
    read per index."""

    def __init__(self, images: "hdf5.Group", n: int):
        self._images = images
        first = images[f"image{0:09d}"]
        self.shape, self.dtype = (n,) + first.shape, first.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, i) -> np.ndarray:
        i = int(i)
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"frame {i} of a clip of {self.shape[0]} frames")
        return self._images[f"image{i:09d}"][:]


class _H5Column:
    """One attribute of every image of an H5 clip, by image index (read
    when indexed, as the value the file stores)."""

    def __init__(self, images: "hdf5.Group", n: int, name: str):
        self._images, self._n, self._name = images, n, name

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._images[f"image{int(i):09d}"].attrs[self._name]


def open_h5_clip(path: str) -> Dict[str, object]:
    """A schema H5 clip under :func:`open_clip`'s keys: ``images`` (N, H, W,
    3) and the per-image columns ``image_ts`` (``timestamp``),
    ``{p}_event_idx`` and, where the first image has them,
    ``exposure_begin_t`` / ``exposure_end_t``, all read lazily; the event
    datasets ``{p}_xs``, ``{p}_ys``, ``{p}_ts``, ``{p}_ps`` (sliceable);
    ``sensor_resolution`` from the file's attribute.  N counts the members
    of ``ori_images``, as the JAX reader does."""
    f = hdf5.File(path)
    images = f["ori_images"]
    n = len(images)
    out: Dict[str, object] = {
        "sensor_resolution": np.asarray(f.attrs["sensor_resolution"]),
        "images": _H5Frames(images, n),
        "image_ts": _H5Column(images, n, "timestamp"),
    }
    for group in f.keys():
        if group.endswith("_events"):
            p = group[: -len("_events")]
            for a in ("xs", "ys", "ts", "ps"):
                out[f"{p}_{a}"] = f[f"{group}/{a}"]
            out[f"{p}_event_idx"] = _H5Column(images, n, f"{p}_event_idx")
    first = images[f"image{0:09d}"].attrs
    for a in ("exposure_begin_t", "exposure_end_t"):
        if a in first:
            out[a] = _H5Column(images, n, a)
    f.close()  # reopened by the first read: a dataset built holds no handle
    return out


def open_any_clip(path: str) -> Dict[str, object]:
    """A clip in either format, told apart by the HDF5 signature."""
    return open_h5_clip(path) if hdf5.is_hdf5(path) else open_clip(path)


# ----------------------------------------------------------------------- #
# scale resolution

_DOWN = {"ori": 1, "down2": 2, "down4": 4, "down8": 8, "down16": 16}


@dataclass
class ScaleSpec:
    """Input/GT event-group prefix and resolution."""

    inp_prefix: str
    gt_prefix: str
    inp_resolution: Tuple[int, int]
    gt_resolution: Tuple[int, int]

    @staticmethod
    def resolve(sensor_resolution: Sequence[int], scale: int, ori_scale: str) -> "ScaleSpec":
        if ori_scale not in _DOWN:
            raise ValueError(f"Error scale setting: scale {scale}, ori_scale {ori_scale}")
        inp_factor = _DOWN[ori_scale]
        gt_factor = inp_factor // scale if ori_scale != "ori" else 1
        if ori_scale == "ori" and scale != 1:
            raise ValueError(f"Error scale setting: scale {scale}, ori_scale {ori_scale}")
        if gt_factor < 1 or (ori_scale != "ori" and inp_factor % scale != 0):
            raise ValueError(f"Error scale setting: scale {scale}, ori_scale {ori_scale}")
        gt_prefix = next(k for k, v in _DOWN.items() if v == gt_factor)
        H, W = sensor_resolution
        return ScaleSpec(
            inp_prefix=ori_scale,
            gt_prefix=gt_prefix,
            inp_resolution=(round(H / inp_factor), round(W / inp_factor)),
            gt_resolution=(round(H / gt_factor), round(W / gt_factor)),
        )


# ----------------------------------------------------------------------- #
# window computation

def compute_period_windows(
    num_imgs: int,
    num_frame_per_period: int,
    num_frame_per_blurry: int,
    exposure_method: str,
    exposure_time: Optional[Sequence[int]],
):
    """Per-period latent/blurry indices and exposure duty.  ``Auto`` draws
    once, when the dataset is built.  Returns (period_bounds,
    latent_indices, blurry_indices, duty)."""
    if exposure_method not in ("Fixed", "Auto", "Custom"):
        raise ValueError("Error exposure setting!")
    if not (1 <= num_frame_per_blurry <= num_frame_per_period):
        raise ValueError("Number of frames per blurry must be in [1, NumFramePerPeriod]")
    rng = np.random.default_rng()

    starts = np.arange(0, num_imgs, num_frame_per_period)[:-1]
    periods, latents, blurries, duty = [], [], [], []
    for j, idx in enumerate(starts):
        periods.append((int(idx), int(idx + num_frame_per_period - 1)))
        latents.append(list(range(idx, idx + num_frame_per_period)))
        if exposure_method == "Fixed":
            n = num_frame_per_blurry
        elif exposure_method == "Auto":
            n = int(rng.integers(1, num_frame_per_period))
        else:  # Custom
            n = int(exposure_time[j % len(exposure_time)])
            if n > num_frame_per_period:
                raise ValueError("Number of frames per blurry must <= frames per period")
        blurries.append(list(range(idx, idx + n)))
        duty.append(n / num_frame_per_period)
    return periods, latents, blurries, duty


def compute_seq_windows(
    num_period: int,
    num_period_per_seq: int,
    sliding_window_seq: int,
    num_period_per_load: int,
    sliding_window_load: int,
) -> List[List[Tuple[int, int]]]:
    """Sequence -> load-window nesting."""
    seqs = []
    for idx in range(0, num_period, sliding_window_seq):
        start, end = idx, idx + num_period_per_seq - 1
        if end <= num_period - 1:
            loads = [
                (i, i + num_period_per_load - 1)
                for i in range(start, end + 1, sliding_window_load)
                if i + num_period_per_load - 1 <= end
            ]
            seqs.append(loads)
    return seqs


# ----------------------------------------------------------------------- #
# augmentation

def _torch_parity_noise(out, kinds, cfg, seed_noise):
    """Event noise drawn with torch's generator (``data_augment.noise.rng:
    torch``): seeded with seed + 3, then ``randn``/``rand`` on the
    (..., TB, 2, H, W) event stack, as the reference loader draws it after
    ``torch.manual_seed``; the stacks here are channel-flattened NHWC, so
    the noise is drawn in that layout and transposed.  The generator is
    this call's own (the same numbers as the global one after
    ``manual_seed``), so items fetched on concurrent threads do not share
    its state."""
    import torch

    std = cfg["noise"]["noise_std"]
    frac = cfg["noise"]["noise_fraction"]
    out = dict(out)
    for k, v in out.items():
        if kinds.get(k) != "event":
            continue
        lead, (H, W, C) = v.shape[:-3], v.shape[-3:]
        ref_shape = (*lead, C // 2, 2, H, W)
        g = torch.Generator().manual_seed(seed_noise)
        noise = (std * torch.randn(ref_shape, dtype=torch.float32, generator=g)).abs().int()
        if frac < 1.0:
            mask = torch.rand(ref_shape, dtype=torch.float32, generator=g) >= frac
            noise = noise.masked_fill(mask, 0)
        n = noise.numpy()  # (*lead, TB, 2, H, W)
        n = np.moveaxis(n, (-4, -3), (-2, -1))  # (*lead, H, W, TB, 2)
        out[k] = v + n.reshape(v.shape).astype(v.dtype)
    return out


def augment(
    arrays: Dict[str, np.ndarray],
    kinds: Dict[str, str],
    cfg: dict,
    seed: int,
    gt_resolution: Tuple[int, int],
) -> Dict[str, np.ndarray]:
    """Joint seeded augmentation of NHWC arrays.

    kinds: per-key 'frame' or 'event'.  Crops and flips are the same for
    every array (python ``random`` generators seeded with seed, seed + 1,
    seed + 2: the numbers of ``random.seed`` and the module's functions,
    without touching its shared state); noise (seed + 3) and hot pixels
    (seed + 4) touch only events.  In torch-noise mode hot pixels never
    fire, as in the reference loader.
    """
    out = dict(arrays)
    seed_h, seed_v, seed_crop, seed_noise, seed_hot = seed, seed + 1, seed + 2, seed + 3, seed + 4
    order = cfg.get("augment", [])
    for mechanism in order:
        if mechanism == "HorizontalFlip" and cfg["flip"]["enabled"]:
            if random.Random(seed_h).random() < cfg["flip"]["horizontal_prob"]:
                out = {k: np.flip(v, axis=-2) for k, v in out.items()}  # W axis (NHWC)
        elif mechanism == "VertivcalFlip" and cfg["flip"]["enabled"]:
            if random.Random(seed_v).random() < cfg["flip"]["vertical_prob"]:
                out = {k: np.flip(v, axis=-3) for k, v in out.items()}  # H axis
        elif mechanism == "RandomCrop" and cfg["random_crop"]["enabled"]:
            th, tw = cfg["random_crop"]["size"]
            h, w = gt_resolution
            if th < h and tw < w:
                crop = random.Random(seed_crop)
                i = crop.randint(0, h - th)
                j = crop.randint(0, w - tw)
                out = {k: v[..., i : i + th, j : j + tw, :] for k, v in out.items()}
        elif mechanism == "CenterCrop" and cfg["center_crop"]["enabled"]:
            th, tw = cfg["center_crop"]["size"]
            h, w = gt_resolution
            if th < h and tw < w:
                i, j = (h - th) // 2, (w - tw) // 2
                out = {k: v[..., i : i + th, j : j + tw, :] for k, v in out.items()}
        elif mechanism == "Noise" and cfg["noise"]["enabled"]:
            if cfg["noise"].get("rng") == "torch":
                out = _torch_parity_noise(out, kinds, cfg, seed_noise)
                continue
            rng = np.random.default_rng(seed_noise)
            for k, v in out.items():
                if kinds.get(k) == "event":
                    noise = np.abs(rng.normal(0, cfg["noise"]["noise_std"], v.shape)).astype(np.int32)
                    if cfg["noise"]["noise_fraction"] < 1.0:
                        keep = rng.random(v.shape) < cfg["noise"]["noise_fraction"]
                        noise = np.where(keep, noise, 0)
                    out[k] = v + noise.astype(v.dtype)
        elif mechanism == "HotPixel" and cfg["hot_pixel"]["enabled"]:
            if cfg["noise"].get("rng") == "torch":
                continue
            rng = np.random.default_rng(seed_hot)
            for k, v in out.items():
                if kinds.get(k) == "event":
                    h, w = v.shape[-3], v.shape[-2]
                    n = int(cfg["hot_pixel"]["hot_pixel_fraction"] * h * w)
                    ys = rng.integers(0, h, n)
                    xs = rng.integers(0, w, n)
                    add = np.abs(rng.normal(0, cfg["hot_pixel"]["hot_pixel_std"], n)).astype(v.dtype)
                    v = v.copy()
                    v[..., ys, xs, :] += add[:, None]
                    out[k] = v
    return out


# ----------------------------------------------------------------------- #
# datasets

class _ClipReader:
    """What both datasets read from a clip: frames and event stacks."""

    def __init__(self, path: str, config: dict):
        self.config = config
        self.path = path
        self.clip = open_any_clip(path)
        self.sensor_resolution = tuple(self.clip["sensor_resolution"][:2])
        self.spec = ScaleSpec.resolve(self.sensor_resolution, config["scale"], config["ori_scale"])
        self.time_bins = config["time_bins"]
        self.num_period_per_load = config["NumPeriodPerLoad"]
        self.num_images = self.clip["images"].shape[0]

    def _stored_frame(self, i: int) -> np.ndarray:
        """Frame i as stored, bicubic-resized to the GT resolution where it
        differs (``cv2.resize(..., INTER_CUBIC)`` of the JAX readers)."""
        frame = self.clip["images"][i]
        if frame.shape[:-1] != tuple(self.spec.gt_resolution):
            return resize_cubic(np.asarray(frame), self.spec.gt_resolution[::-1])
        return np.array(frame)

    def _event_stack(self, first: int, last: int) -> np.ndarray:
        """(H, W, 2*TB) bin-major, polarity-minor count stack of the events
        from image ``first``'s index to image ``last``'s."""
        prex = self.spec.gt_prefix
        idx = self.clip[f"{prex}_event_idx"]
        i0, i1 = idx[first], idx[last]
        xs, ys, ts, ps = (self.clip[f"{prex}_{a}"][i0:i1] for a in ("xs", "ys", "ts", "ps"))
        if len(xs) == 0:
            xs = ys = ts = ps = np.array([0.0])
        return native.events_to_stack(xs, ys, native.normalize_ts(ts), ps, self.time_bins,
                                      self.spec.gt_resolution)

    def _augment(self, item: dict, kinds: dict, seed: int) -> dict:
        if self.config["data_augment"]["enabled"]:
            spatial = {k: item[k] for k in kinds}
            item.update(augment(
                spatial, kinds, self.config["data_augment"], seed, self.spec.gt_resolution
            ))
        return {k: np.ascontiguousarray(v) for k, v in item.items()}


class NpzClipDataset(_ClipReader):
    """Synthetic-blur dataset over one clip: periods of NumFramePerPeriod
    sharp frames, the blurry frame the mean of a period's first exposure
    frames, exposure regimes Fixed, Auto and Custom.  ``NeedNeighborGT``
    adds the item ``neighbor`` (L, NumP, NumF, 2, H, W, 3): for each latent
    frame the two frames around it within its period (the next two for
    the first, the last two for the last), augmented as frames.  No train
    step reads it, in either package; the trainer moves it to the device
    with the rest of the window."""

    def __init__(self, path: str, config: dict):
        super().__init__(path, config)
        self.num_frame_per_period = config["NumFramePerPeriod"]
        self.deblur_pretrain = config.get("DeblurPretrain", False)
        self.need_neighbor_gt = config.get("NeedNeighborGT", False)
        self.interval = self.num_frame_per_period * self.num_period_per_load
        (self.periods, self.latent_idx, self.blurry_idx, self.duty) = compute_period_windows(
            self.num_images,
            self.num_frame_per_period,
            config["NumFramePerBlurry"],
            config["ExposureMethod"],
            config.get("ExposureTime"),
        )
        self.seq_indices = compute_seq_windows(
            len(self.periods),
            config["NumPeriodPerSeq"],
            config["SlidingWindowSeq"],
            self.num_period_per_load,
            config["SlidingWindowLoad"],
        )

    def __len__(self) -> int:
        return len(self.seq_indices)

    def _read_frame(self, i: int) -> np.ndarray:
        """uint8 HWC, BGR -> RGB."""
        return self._stored_frame(i)[:, :, ::-1]

    def _frames(self, indices: Sequence[int]) -> np.ndarray:
        return np.stack([self._read_frame(i) for i in indices])

    def _blurry(self, indices: Sequence[int]) -> np.ndarray:
        """Blur synthesis: the uint8 mean in f64, cast to f32, then divided
        by 255 in f32 (the reference's op order); on the native plane where
        the frames are stored at the GT resolution, as the JAX reader
        gates its own.  An H5 clip hands over only the window's frames."""
        images = self.clip["images"]
        if images.shape[1:3] == tuple(self.spec.gt_resolution):
            if isinstance(images, _H5Frames):
                return native.blurry_mean(np.stack([images[i] for i in indices]),
                                          range(len(indices)))
            return native.blurry_mean(images, indices)
        return self._frames(indices).mean(0).astype(np.float32) / np.float32(255.0)

    def _neighbors(self, latent: Sequence[int]) -> np.ndarray:
        """(NumF, 2, H, W, 3) f32: each latent frame's pair of neighbours
        (``h5dataset.py:375-389`` of the JAX package)."""
        last = len(latent) - 1
        pairs = [[i, i + 1] if k == 0 else [i - 1, i] if k == last else [i - 1, i + 1]
                 for k, i in enumerate(latent)]
        return np.stack([self._frames(p).astype(np.float32) / 255.0 for p in pairs])

    def get(self, index: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        if seed is None:
            seed = random.randint(0, 2**32)
        sequence = self.seq_indices[index]

        latents, blurries, events, neighbors = [], [], [], []
        latent_ts, rel_ts, blurry_ts, duties = [], [], [], []
        for (left, right) in sequence:
            all_latent: List[int] = []
            all_blurry: List[List[int]] = []
            lat_frames, blur_frames, nei_frames, duty_list = [], [], [], []
            for p in range(left, right + 1):
                li = self.latent_idx[p]
                bi = self.blurry_idx[p]
                all_latent += li
                all_blurry.append(bi)
                sharp_idx = [li[-1]] if self.deblur_pretrain else li
                lat_frames.append(self._frames(sharp_idx).astype(np.float32) / 255.0)
                blur_frames.append(self._blurry(bi))
                if self.need_neighbor_gt:
                    nei_frames.append(self._neighbors(li))
                duty_list.append(self.duty[p])

            latents.append(np.stack(lat_frames))        # (NumP, NumF', H, W, 3)
            blurries.append(np.stack(blur_frames))      # (NumP, H, W, 3)
            if self.need_neighbor_gt:
                neighbors.append(np.stack(nei_frames))  # (NumP, NumF, 2, H, W, 3)
            events.append(self._event_stack(all_latent[0], all_latent[-1]))

            # timestamps normalised by the load interval
            t0 = all_latent[0]
            lts = (np.asarray(all_latent, np.float32) - t0) / self.interval
            bts = (np.asarray([[b[0], b[-1]] for b in all_blurry], np.float32) - t0) / self.interval
            rel = [lts] + [lts - 1.0 / (i + 1) for i in range(1, self.num_period_per_load)]
            latent_ts.append(lts)
            rel_ts.append(np.stack(rel))
            blurry_ts.append(bts)
            duties.append(np.asarray(duty_list, np.float32)[:, None])

        item = {
            "latent": np.stack(latents),        # (L, NumP, NumF', H, W, 3)
            "blurry": np.stack(blurries),       # (L, NumP, H, W, 3)
            "events": np.stack(events),         # (L, H, W, 2*TB)
            "latent_ts": np.stack(latent_ts),   # (L, NumP*NumF)
            "relative_ts": np.stack(rel_ts),    # (L, NumP, NumP*NumF)
            "blurry_ts": np.stack(blurry_ts),   # (L, NumP, 2)
            "exposure": np.stack(duties),       # (L, NumP, 1)
        }
        kinds = {"latent": "frame", "blurry": "frame", "events": "event"}
        if self.need_neighbor_gt:
            item["neighbor"] = np.stack(neighbors)
            kinds["neighbor"] = "frame"
        return self._augment(item, kinds, seed)


class NpzClipDatasetFast(NpzClipDataset):
    """:class:`NpzClipDataset` with every item preloaded, unaugmented, when
    it is built (port of ``ebfi_tpu/data/h5dataset_fast.py``): a fetch is a
    lookup plus the augmentation with the fetch's seed, so it changes
    speed only.  The preload draws no seed from python's ``random`` (the
    JAX one does, unused), so a run with it draws the same augmentation
    seeds as one without.  ``NeedNeighborGT`` raises, as in the JAX
    package."""

    def __init__(self, path: str, config: dict):
        if config.get("NeedNeighborGT"):
            raise ValueError(f"{path}: the fast (preloading) dataset does not take "
                             "NeedNeighborGT, as in the JAX package: set fast: False")
        self._aug_cfg = config["data_augment"]
        super().__init__(path, dict(config, data_augment=dict(self._aug_cfg, enabled=False)))
        self._cache = [super(NpzClipDatasetFast, self).get(i, seed=0) for i in range(len(self))]

    def get(self, index: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        if seed is None:
            seed = random.randint(0, 2**32)
        item = dict(self._cache[index])
        if self._aug_cfg.get("enabled"):
            kinds = {"latent": "frame", "blurry": "frame", "events": "event"}
            spatial = augment({k: item[k] for k in kinds}, kinds, self._aug_cfg, seed,
                              self.spec.gt_resolution)
            item.update({k: np.ascontiguousarray(v) for k, v in spatial.items()})
        return item


class NpzClipDatasetReal(_ClipReader):
    """Real-blur dataset (RealBlur-DAVIS): the stored frames are the blurry
    frames, there is no sharp GT, and the exposure duty comes from
    ``exposure_begin_t`` / ``exposure_end_t``."""

    def __init__(self, path: str, config: dict):
        super().__init__(path, config)
        interp_num = config.get("interp_num", 16)
        # interpolation targets are linspace(0, 1)
        self.relative_ts = np.tile(
            np.linspace(0, 1, interp_num, dtype=np.float32)[None],
            (self.num_period_per_load, 1),
        )
        # the last frame is dropped: it gives the next period's shutter time
        self.seq_indices = compute_seq_windows(
            self.num_images - 1,
            config["NumPeriodPerSeq"],
            config["SlidingWindowSeq"],
            self.num_period_per_load,
            config["SlidingWindowLoad"],
        )

    def __len__(self) -> int:
        return len(self.seq_indices)

    def _duty(self, left: int, right: int) -> np.ndarray:
        begin, end = self.clip["exposure_begin_t"], self.clip["exposure_end_t"]
        out = [(end[i] - begin[i]) / (begin[i + 1] - begin[i]) for i in range(left, right + 1)]
        return np.asarray(out, np.float32)[:, None]

    def get(self, index: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        if seed is None:
            seed = random.randint(0, 2**32)
        sequence = self.seq_indices[index]
        blurries, events, rel_ts, duties = [], [], [], []
        for (left, right) in sequence:
            frames = np.stack(
                [self._stored_frame(i) for i in range(left, right + 1)]  # kept as stored
            ).astype(np.float32) / 255.0  # (NumP, H, W, 3)
            blurries.append(frames)
            # + 1: all events through the end of the last period
            events.append(self._event_stack(left, right + 1))
            rel_ts.append(self.relative_ts)
            duties.append(self._duty(left, right))
        item = {
            "blurry": np.stack(blurries),      # (L, NumP, H, W, 3)
            "events": np.stack(events),        # (L, H, W, 2*TB)
            "relative_ts": np.stack(rel_ts),   # (L, NumP, interp_num)
            "exposure": np.stack(duties),      # (L, NumP, 1)
        }
        return self._augment(item, {"blurry": "frame", "events": "event"}, seed)


# the JAX package's names: each class reads both formats
H5ClipDataset = NpzClipDataset
H5ClipDatasetFast = NpzClipDatasetFast
H5ClipDatasetReal = NpzClipDatasetReal

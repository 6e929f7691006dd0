"""Synthetic clips: frames and ESIM-style events, as schema H5 clips or in
the ``ebfi_clip_npz/1`` container (port of ``ebfi_tpu/data/synth.py``).

Renders a moving scene, simulates threshold-crossing events from
log-intensity changes, and writes a clip that
:mod:`ebfi_tpu_torch.data.clip_dataset` reads.  :func:`write_clip_h5` writes
what the JAX package's ``write_clip_h5`` writes with the same arguments
(through the port's own HDF5 writer); :func:`write_clip_npz` writes the
same arrays as ``tools/h5_to_npz.py`` does from that H5, without an H5
file in between.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .clip_dataset import FORMAT
from .hdf5_write import Writer


def render_frames(
    num_frames: int, H: int, W: int, seed: int = 0, speed: float = 2.0
) -> np.ndarray:
    """(N, H, W, 3) uint8 moving smooth pattern (deterministic)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    phases = rng.uniform(0, 2 * np.pi, (3, 2))
    freqs = rng.uniform(0.05, 0.15, (3, 2))
    frames = np.empty((num_frames, H, W, 3), np.uint8)
    for n in range(num_frames):
        shift = n * speed
        for c in range(3):
            v = (
                np.sin(freqs[c, 0] * (xx + shift) + phases[c, 0])
                * np.cos(freqs[c, 1] * (yy + 0.5 * shift) + phases[c, 1])
            )
            frames[n, :, :, c] = np.clip((v * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    return frames


def sample_thresholds(
    rng: np.random.Generator,
    ct_range: Tuple[float, float] = (0.2, 0.5),
    mu: float = 1.0,
    sigma: float = 0.1,
) -> Tuple[float, float]:
    """Per-sequence contrast-threshold sampling, the reference's scheme
    (generate_dataset/syn_gopro.py:104-118 with config :14-27):
    ``Cp ~ U[ct_range]``, ``Cn = gauss(mu, sigma) * Cp``, both clamped to
    ``ct_range``.  Returns (cp, cn)."""
    cp = float(rng.uniform(ct_range[0], ct_range[1]))
    cn = float(rng.normal(mu, sigma)) * cp
    cp = min(max(cp, ct_range[0]), ct_range[1])
    cn = min(max(cn, ct_range[0]), ct_range[1])
    return cp, cn


def simulate_events(
    frames: np.ndarray,
    timestamps: np.ndarray,
    contrast_threshold: float = 0.2,
    seed: int = 0,
    *,
    cp: Optional[float] = None,
    cn: Optional[float] = None,
    refractory_period: float = 0.0,
):
    """ESIM-lite: per-pixel log-intensity threshold crossings between
    consecutive frames, timestamped by linear interpolation of the
    log-intensity within the interval.

    Mirrors esim_py's model as configured by the reference
    (generate_dataset/syn_gopro.py:14-27,104-118):

    - independent positive / negative thresholds ``cp`` / ``cn`` (both
      default to ``contrast_threshold``); use :func:`sample_thresholds`
      for the reference's per-sequence randomization;
    - a per-pixel ``refractory_period``: a crossing fires only if it is
      more than the refractory period after the pixel's last *emitted*
      event; the reference level still updates for suppressed crossings
      (esim_py semantics; reference config uses 1e-4 s);
    - crossing times are the linear-interpolation solutions
      ``t = t0 + (level - L0)/(L1 - L0) * (t1 - t0)`` plus a small jitter.

    Returns (xs, ys, ts, ps) sorted by t, ps in {-1, +1}, plus the event
    index of each frame (events with t < frame timestamp), matching
    `add_event_indices` (event_packagers.py:204-226).
    """
    cp = contrast_threshold if cp is None else cp
    cn = contrast_threshold if cn is None else cn
    rng = np.random.default_rng(seed)
    logI = np.log(frames.astype(np.float64).mean(-1) / 255.0 + 0.02)
    xs_l, ys_l, ts_l, ps_l = [], [], [], []
    N, H, W = logI.shape
    ref = logI[0].copy()
    last_t = np.full((H, W), -np.inf)
    for n in range(1, N):
        delta = logI[n] - ref
        thr = np.where(delta > 0, cp, cn)
        n_cross = np.floor(np.abs(delta) / thr).astype(np.int64)
        ys, xs = np.nonzero(n_cross)
        if len(ys) == 0:
            continue
        counts = n_cross[ys, xs]
        pol = np.sign(delta[ys, xs])
        step = thr[ys, xs] * pol  # signed level increment per crossing
        t0, t1 = timestamps[n - 1], timestamps[n]
        L0, L1 = logI[n - 1][ys, xs], logI[n][ys, xs]
        denom = np.where(L1 == L0, 1.0, L1 - L0)
        for k in range(1, counts.max() + 1):
            sel = counts >= k
            m = int(sel.sum())
            level = ref[ys[sel], xs[sel]] + k * step[sel]
            frac = np.where(
                (L1 == L0)[sel], 1.0, (level - L0[sel]) / denom[sel]
            )
            frac = np.clip(frac + rng.uniform(-0.01, 0.01, m), 0, 1)
            tk = t0 + frac * (t1 - t0)
            prev = last_t[ys[sel], xs[sel]]
            fire = np.isinf(prev) | (tk - prev > refractory_period)
            last_t[ys[sel][fire], xs[sel][fire]] = tk[fire]
            ts_l.append(tk[fire])
            xs_l.append(xs[sel][fire])
            ys_l.append(ys[sel][fire])
            ps_l.append(pol[sel][fire])
        ref = ref + n_cross * thr * np.sign(delta)
    if not xs_l or not len(np.concatenate(xs_l)):
        return (np.zeros(0),) * 4, np.zeros(N, np.int64)
    xs = np.concatenate(xs_l)
    ys = np.concatenate(ys_l)
    ts = np.concatenate(ts_l)
    ps = np.concatenate(ps_l)
    order = np.argsort(ts, kind="stable")
    xs, ys, ts, ps = xs[order], ys[order], ts[order], ps[order]
    frame_idx = np.searchsorted(ts, timestamps, side="left")
    return (xs, ys, ts, ps), frame_idx


def _synthesize(num_frames, H, W, fps, seed, real_exposure, down_scales):
    """(frames, timestamps, {prefix: ((xs, ys, ts, ps), frame_idx)},
    exposure end times or None): what both writers store."""
    frames = render_frames(num_frames, H, W, seed)
    timestamps = np.arange(num_frames, dtype=np.float64) / fps
    groups = {"ori": simulate_events(frames, timestamps, seed=seed)}
    for s in down_scales:
        if H % s or W % s:
            raise ValueError(f"H={H}, W={W} not divisible by down scale {s}")
        small = (
            frames.reshape(num_frames, H // s, s, W // s, s, 3)
            .mean((2, 4))
            .round()
            .astype(np.uint8)
        )
        groups[f"down{s}"] = simulate_events(small, timestamps, seed=seed + s)
    end = None
    if real_exposure is not None:
        duty, jitter = real_exposure
        rng = np.random.default_rng(seed + 7)
        eff = duty * (1 + rng.uniform(-jitter, jitter, num_frames))
        end = timestamps + eff * (1.0 / fps)
    return frames, timestamps, groups, end


def write_clip_npz(
    path: str,
    num_frames: int = 64,
    H: int = 64,
    W: int = 80,
    fps: float = 240.0,
    seed: int = 0,
    real_exposure: Optional[Tuple[float, float]] = None,
    down_scales: Tuple[int, ...] = (),
) -> int:
    """Write a synthetic clip; returns its number of ``ori`` events.

    Images are stored BGR (the synthetic-blur reader flips them to RGB).
    ``real_exposure=(duty, jitter)`` adds ``exposure_begin_t`` /
    ``exposure_end_t`` for the real-blur reader.  ``down_scales`` (e.g.
    (2, 4)) adds event groups simulated on block-mean-downsampled frames;
    H and W must be divisible by each scale.
    """
    frames, timestamps, groups, end = _synthesize(num_frames, H, W, fps, seed, real_exposure,
                                                  down_scales)
    arrays = {
        "format": np.array(FORMAT),
        "sensor_resolution": np.array([H, W], np.int64),
        "images": np.ascontiguousarray(frames[:, :, :, ::-1]),  # stored BGR
        "image_ts": timestamps,
    }
    for p, ((xs, ys, ts, ps), frame_idx) in groups.items():
        arrays[f"{p}_xs"] = xs.astype(np.int16)
        arrays[f"{p}_ys"] = ys.astype(np.int16)
        arrays[f"{p}_ts"] = ts.astype(np.float64)
        arrays[f"{p}_ps"] = ps.astype(np.int8)
        arrays[f"{p}_event_idx"] = frame_idx.astype(np.int64)
    if end is not None:
        arrays["exposure_begin_t"] = timestamps
        arrays["exposure_end_t"] = end
    np.savez(path, **arrays)
    return len(groups["ori"][0][0])


def write_clip_h5(
    path: str,
    num_frames: int = 64,
    H: int = 64,
    W: int = 80,
    fps: float = 240.0,
    seed: int = 0,
    real_exposure: Optional[Tuple[float, float]] = None,
    down_scales: Tuple[int, ...] = (),
) -> int:
    """:func:`write_clip_npz`'s clip as a schema H5 clip, as the JAX
    package's ``write_clip_h5`` writes it (contiguous datasets): file
    attributes ``sensor_resolution``, ``num_events``, ``num_imgs``; groups
    ``{p}_events/{xs,ys,ts,ps}``; ``ori_images/image{n:09d}`` (BGR) with
    ``timestamp``, ``{p}_event_idx`` and, for ``real_exposure``,
    ``exposure_begin_t`` / ``exposure_end_t``.  Returns its number of
    ``ori`` events."""
    frames, timestamps, groups, end = _synthesize(num_frames, H, W, fps, seed, real_exposure,
                                                  down_scales)
    with Writer(path) as f:
        f.attrs["sensor_resolution"] = np.array([H, W], np.int64)
        f.attrs["num_events"] = len(groups["ori"][0][0])
        f.attrs["num_imgs"] = num_frames
        for p, ((xs, ys, ts, ps), _) in groups.items():
            g = f.create_group(f"{p}_events")
            g.create_dataset("xs", data=xs.astype(np.int16))
            g.create_dataset("ys", data=ys.astype(np.int16))
            g.create_dataset("ts", data=ts.astype(np.float64))
            g.create_dataset("ps", data=ps.astype(np.int8))
        imgs = f.create_group("ori_images")
        for n in range(num_frames):
            d = imgs.create_dataset(f"image{n:09d}", data=frames[n, :, :, ::-1])  # store BGR
            d.attrs["timestamp"] = timestamps[n]
            for p, (_, frame_idx) in groups.items():
                d.attrs[f"{p}_event_idx"] = int(frame_idx[n])
            if end is not None:
                d.attrs["exposure_begin_t"] = timestamps[n]
                d.attrs["exposure_end_t"] = end[n]
    return len(groups["ori"][0][0])

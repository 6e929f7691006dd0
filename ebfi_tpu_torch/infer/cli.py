"""Inference CLI (port of ``ebfi_tpu/infer/cli.py``): the same flags, the
same output tree and result files.

    python -m ebfi_tpu_torch.infer --model_path CKPT --data_list LIST \
        --output_path OUT [flags of the JAX CLI] [--device cpu]

Each line of the datalist names a schema H5 clip (the reference's and the
JAX package's files, read without ``h5py``) or a clip in the
``ebfi_clip_npz/1`` container (``tools/h5_to_npz.py`` repacks H5 clips
into it), mixed as they come; ``--real_blur`` reads the exposures from
the H5 images' ``exposure_begin_t`` / ``exposure_end_t`` attributes.  The
checkpoint is a
port checkpoint (``tools/jax_ckpt_to_torch.py`` converts JAX ones) or a
reference-format ``.pth``.  Per clip it writes

    <output_path>/<clip file name>/img/{blurry_frame,event,gt_frame,restored_frame}/
    <output_path>/<clip file name>/inference.yml

and aggregates ``inference_all.yml`` / ``inference_all_step.yml`` with
per-metric, per-clip breakdowns, means and per-step PSNR lists.

``--lpips_weights``/``--alexnet_weights`` add an ``lpips`` column
(``ebfi_tpu_torch.losses.LPIPS``, on the engine's device) where a backbone
file is given; without one the backbone would be random features, so the
CLI warns and leaves the metric out, as the JAX CLI does.

The model runs in :class:`~ebfi_tpu_torch.infer.InferenceEngine` on the
card (``--device cuda``, the default; without a card it raises) or on the
CPU when asked (``--device cpu``).  The loop is a one-deep software
pipeline: frame i + 1 is dispatched to the device before frame i is
copied back and its metrics and PNG writes (on background threads) run.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..data.dataloader import EBFIDataLoader, read_datalist
from ..losses import LPIPS, load_lpips_params
from ..utils.logger import YamlResultLogger
from ..utils.metrics import MetricTracker, psnr_metric, ssim_metric
from ..utils.vis import save_event_cnt, save_frame


def default_dataloader_config() -> dict:
    """The inference config the flags override (the reference's hardcoded
    one)."""
    return {
        "batch_size": 1,
        "shuffle": False,
        "drop_last": False,
        "dataset": {
            "scale": 4,
            "ori_scale": "down4",
            "time_bins": 1,
            "interp_num": 16,
            "NumFramePerPeriod": 16,
            "NumFramePerBlurry": 9,
            "NumPeriodPerSeq": 2,
            "SlidingWindowSeq": 2,
            "NumPeriodPerLoad": 1,
            "SlidingWindowLoad": 1,
            "ExposureMethod": "Fixed",
            "ExposureTime": None,
            "DeblurPretrain": False,
            "data_augment": {
                "enabled": True,
                "augment": ["RandomCrop", "CenterCrop", "HorizontalFlip",
                            "VertivcalFlip", "Noise", "HotPixel"],
                "random_crop": {"enabled": False, "size": [128, 128]},
                "center_crop": {"enabled": False, "size": [128, 128]},
                "flip": {"enabled": False, "horizontal_prob": 0.5, "vertical_prob": 0.5},
                "noise": {"enabled": True, "noise_std": 1.0, "noise_fraction": 0.05},
                "hot_pixel": {"enabled": True, "hot_pixel_std": 2.0,
                              "hot_pixel_fraction": 0.001},
            },
        },
    }


def get_flags(argv=None):
    p = argparse.ArgumentParser(description="ebfi_tpu_torch inference")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--data_list", type=str, default=None,
                   help="a text file naming one clip per line: schema H5 clips (read without "
                        "h5py) or .npz clips, mixed as they come")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--scale", type=int, default=None)
    p.add_argument("--ori_scale", type=str, default=None)
    p.add_argument("--time_bins", type=int, default=None)
    p.add_argument("--interp_num", type=int, default=None)
    p.add_argument("--num_frame_per_period", type=int, default=None)
    p.add_argument("--num_frame_per_blurry", type=int, default=None)
    p.add_argument("--num_period_per_seq", type=int, default=None)
    p.add_argument("--sliding_window_seq", type=int, default=None)
    p.add_argument("--num_period_per_load", type=int, default=None)
    p.add_argument("--sliding_window_load", type=int, default=None)
    p.add_argument("--exposure_method", type=str, default=None)
    p.add_argument("--exposure_time", type=str, default=None)
    p.add_argument("--deblur_pretrain", default=False, action="store_true")
    p.add_argument("--noise_std", type=float, default=None)
    p.add_argument("--noise_enabled", default=True, action="store_false")
    p.add_argument("--center_crop_size", type=int, nargs="+", default=None)
    p.add_argument("--noise_rng", type=str, default="numpy", choices=["numpy", "torch"],
                   help="event-noise RNG: 'torch' draws the reference loader's noise "
                        "(torch.manual_seed), 'numpy' the JAX package's default")
    p.add_argument("--real_blur", default=False, action="store_true")
    p.add_argument("--workers", type=int, default=0,
                   help="worker PROCESSES (spawned) for the host fetch plane (clip read, "
                        "blur synthesis, event encoding); 0 = threads in this process")
    p.add_argument("--precision", type=str, default="f32", choices=["f32", "bf16"])
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="path to LPIPS linear-head .pth (optional)")
    p.add_argument("--alexnet_weights", type=str, default=None,
                   help="path to torchvision alexnet state_dict (optional)")
    return p.parse_args(argv)


def apply_flag_overrides(cfg: dict, flags) -> dict:
    ds = cfg["dataset"]
    simple = {
        "scale": "scale", "ori_scale": "ori_scale", "time_bins": "time_bins",
        "interp_num": "interp_num", "num_frame_per_period": "NumFramePerPeriod",
        "num_frame_per_blurry": "NumFramePerBlurry",
        "num_period_per_seq": "NumPeriodPerSeq",
        "sliding_window_seq": "SlidingWindowSeq",
        "num_period_per_load": "NumPeriodPerLoad",
        "sliding_window_load": "SlidingWindowLoad",
        "exposure_method": "ExposureMethod",
    }
    for flag, key in simple.items():
        v = getattr(flags, flag)
        if v is not None:
            ds[key] = v
    if flags.exposure_time is not None:
        ds["ExposureTime"] = (
            [int(x) for x in flags.exposure_time.strip("[]").split(",")]
            if isinstance(flags.exposure_time, str) else flags.exposure_time
        )
    ds["DeblurPretrain"] = flags.deblur_pretrain
    if flags.noise_std is not None:
        ds["data_augment"]["noise"].update(
            {"enabled": True, "noise_std": flags.noise_std, "noise_fraction": 0.05}
        )
    ds["data_augment"]["noise"]["enabled"] = flags.noise_enabled
    ds["data_augment"]["hot_pixel"]["enabled"] = flags.noise_enabled
    ds["data_augment"]["noise"]["rng"] = flags.noise_rng
    if flags.center_crop_size is not None:
        ds["data_augment"]["center_crop"].update(
            {"enabled": True, "size": list(flags.center_crop_size)}
        )
    return cfg


def load_model(model_path: Optional[str], precision: str = "f32", device: str = "cuda"):
    """(model, engine) from a port checkpoint or a reference ``.pth``; the
    architecture comes from the checkpoint's config."""
    if model_path is None:
        return None, None
    from ..utils.checkpoint import load_checkpoint
    from .engine import InferenceEngine

    model, _ = load_checkpoint(model_path)
    return model, InferenceEngine(model, precision=precision, device=device)


class _AsyncWriter:
    """PNG writes on background threads, so encoding overlaps the device;
    errors surface at drain().  The pool is shut down by drain() or close()."""

    def __init__(self, threads: int = 2):
        self._pool = cf.ThreadPoolExecutor(threads)
        self._futures = []

    def submit(self, fn, *args):
        self._futures.append(self._pool.submit(fn, *args))

    def drain(self):
        try:
            for f in self._futures:
                f.result()
        finally:
            self._futures.clear()
            self.close()

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


class _DeviceTimer:
    """Device time of one dispatch: CUDA events on the card, the host clock
    around the (synchronous) call on the CPU.  ``ms()`` after the result
    was copied back."""

    def __init__(self, device):
        import torch

        self._cuda = device.type == "cuda"
        if self._cuda:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self._cuda:
            self._events[1].record()
        else:
            self._ms = 1e3 * (time.perf_counter() - self._t0)
        return self

    def ms(self) -> float:
        return self._events[0].elapsed_time(self._events[1]) if self._cuda else self._ms


def infer_clip(
    dataloader_config: dict,
    data_path: str,
    engine,
    real_blur: bool,
    img_path: str,
    logger: YamlResultLogger,
    num_workers: int = 0,
    lpips: Optional[LPIPS] = None,
) -> Dict:
    """Per-clip loop: windows from the fetch plane, one engine call per
    blurry frame, metrics and PNGs of the previous frame while the device
    computes the next.  Returns the metrics and, under "timings", one dict
    per blurry frame: fetch_ms (host time waiting for its window, shared
    among the window's frames), device_ms, sync_ms (host waiting for its
    result), emit_ms (metrics and PNG submits), metrics_ms (the part of
    emit_ms in MSE, PSNR, SSIM and, with ``lpips``, LPIPS) and wall_ms
    (since the previous frame was emitted).  The PNG writes finish on background threads after the
    last frame's emit."""
    logger.log_dict(dataloader_config, "eval_datasetloader_config")
    loader = EBFIDataLoader(
        data_path,
        dataloader_config["dataset"],
        batch_size=dataloader_config.get("batch_size", 1),
        real_data=real_blur,
        num_workers=num_workers,
    )
    blurry_path = os.path.join(img_path, "blurry_frame")
    event_path = os.path.join(img_path, "event")
    gt_path = os.path.join(img_path, "gt_frame")
    restored_path = os.path.join(img_path, "restored_frame")
    for p in (blurry_path, event_path, gt_path, restored_path):
        os.makedirs(p, exist_ok=False)

    # a metric that is never computed would read as 0.0 in the result files
    track = MetricTracker(["mse", "psnr", "ssim"] + (["lpips"] if lpips is not None else []))
    psnr_steps: List[float] = []
    timings: List[dict] = []
    writer = _AsyncWriter()
    iF = -1
    last_emit = time.perf_counter()

    def emit(iL, finals_dev, timer, fetch_ms, num_i, blurry_l, event_l, latent_l):
        """Host-side output of one blurry frame: copy its result back (the
        next frame is already queued on the device), metrics, PNG submits."""
        nonlocal iF, last_emit
        t0 = time.perf_counter()
        finals = None if finals_dev is None else finals_dev.cpu().numpy()
        t1 = time.perf_counter()
        metrics_s = 0.0
        for i in range(num_i):
            iF += 1
            if finals is not None:
                pred = finals[i]  # (B, H, W, 3)
                if latent_l is not None:
                    tm = time.perf_counter()
                    gt = latent_l[:, i]
                    pred_chw = pred.transpose(0, 3, 1, 2)
                    gt_chw = gt.transpose(0, 3, 1, 2)
                    psnr_val = psnr_metric(pred_chw, gt_chw)
                    track.update("psnr", psnr_val)
                    track.update("mse", float(np.mean((pred - gt) ** 2)))
                    track.update("ssim", ssim_metric(pred_chw, gt_chw))
                    if lpips is not None:
                        track.update("lpips", lpips_value(lpips, np.clip(pred, 0, 1), gt))
                    psnr_steps.append(psnr_val)
                    metrics_s += time.perf_counter() - tm
                writer.submit(
                    save_frame,
                    (np.clip(pred[0], 0, 1) * 255).astype(np.uint8),
                    os.path.join(restored_path, f"{iF:09d}_{iL}.png"),
                )
            if latent_l is not None:
                writer.submit(
                    save_frame,
                    (latent_l[0, i] * 255).astype(np.uint8),
                    os.path.join(gt_path, f"{iF:09d}_{iL}.png"),
                )
        writer.submit(
            save_frame,
            (blurry_l * 255).astype(np.uint8),
            os.path.join(blurry_path, f"{iL:09d}.png"),
        )
        tb = event_l.shape[-1] // 2  # one polarity render per time bin
        for b in range(tb):
            writer.submit(
                save_event_cnt,
                np.ascontiguousarray(event_l[..., 2 * b : 2 * b + 2]),
                os.path.join(event_path, f"{iL}_TB{b:09d}.png"),
                "blue_red",
                False,
            )
        t2 = time.perf_counter()
        timings.append({
            "fetch_ms": fetch_ms,
            "device_ms": None if timer is None else timer.ms(),
            "sync_ms": 1e3 * (t1 - t0),
            "emit_ms": 1e3 * (t2 - t1),
            "metrics_ms": 1e3 * metrics_s,
            "wall_ms": 1e3 * (t2 - last_emit),
        })
        last_emit = t2

    windows = iter(loader)
    try:
        iL = -1
        prev = None  # emit arguments of the previously dispatched frame
        while True:
            t_fetch = time.perf_counter()
            window = next(windows, None)
            if window is None:
                break
            blurry = window["blurry"]       # (B, L, NumP, H, W, 3)
            events = window["events"]       # (B, L, H, W, 2TB)
            rel_ts = window["relative_ts"]  # (B, L, NumP, NumI)
            exposure = window["exposure"]   # (B, L, NumP, 1)
            latent = window.get("latent")
            L = blurry.shape[1]
            fetch_ms = 1e3 * (time.perf_counter() - t_fetch) / L
            for idx_l in range(L):
                iL += 1
                frame = blurry[:, idx_l, 0]
                event = events[:, idx_l]
                ts = rel_ts[:, idx_l, 0]  # (B, NumI)
                gt_ex = exposure[:, idx_l, 0]
                finals_dev = timer = None
                if engine is not None:
                    timer = _DeviceTimer(engine.device)
                    _, finals_dev = engine.interpolate(frame, event, ts, gt_ex, outputs="final")
                    timer.stop()
                if prev is not None:
                    emit(*prev)
                prev = (
                    iL, finals_dev, timer, fetch_ms, ts.shape[-1], blurry[0, idx_l, 0],
                    event[0], None if latent is None else latent[:, idx_l, 0],
                )
        if prev is not None:
            emit(*prev)
        writer.drain()
    finally:
        windows.close()
        writer.close()
    result = track.result()
    logger.log_dict(result, "evaluation results")
    logger.log_dict({"psnr": psnr_steps}, "evaluation step results")
    return {"result": result, "result_step": {"psnr": psnr_steps}, "timings": timings}


def lpips_value(lpips: LPIPS, pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean LPIPS of host images (B, H, W, 3) in [0, 1], computed on the
    module's device."""
    import torch

    device = lpips.shift.device
    with torch.no_grad():
        d = lpips(torch.from_numpy(np.ascontiguousarray(pred, np.float32)).to(device),
                  torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(device))
    return float(d.mean())


def load_lpips(flags) -> Optional[LPIPS]:
    """The LPIPS module the flags ask for, on the CPU; None without the
    flags, or with a warning when no backbone file is given: its values
    would not be comparable with published LPIPS numbers."""
    if not (flags.lpips_weights or flags.alexnet_weights):
        return None
    lpips = LPIPS(load_lpips_params(flags.lpips_weights, flags.alexnet_weights))
    if not lpips.comparable:
        logging.getLogger(__name__).warning(
            "LPIPS requested without --alexnet_weights: the backbone would be random features, "
            "so LPIPS is omitted from result files. Provide a torchvision alexnet state_dict "
            "to enable it."
        )
        return None
    return lpips


def main(argv=None) -> dict:
    """Run the CLI; returns what it wrote to ``inference_all.yml`` (the
    per-clip breakdown and the means), the per-step PSNR means, and the
    per-blurry-frame timings of every clip in order (see
    :func:`infer_clip`)."""
    import random

    # the reference seeds everything to 123 before inference; augmentation
    # draws per-item seeds from python `random`
    random.seed(123)
    np.random.seed(123)

    flags = get_flags(argv)
    lpips = load_lpips(flags)
    cfg = apply_flag_overrides(default_dataloader_config(), flags)
    os.makedirs(flags.output_path, exist_ok=True)
    if flags.precision == "f32":
        import torch

        # f32 means f32 products: cuDNN would run f32 convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model, engine = load_model(flags.model_path, precision=flags.precision, device=flags.device)
    if lpips is not None and engine is not None:
        lpips.to(engine.device)  # LPIPS runs where the model does
    data_list = read_datalist(flags.data_list)

    logger_all = YamlResultLogger(os.path.join(flags.output_path, "inference_all.yml"))
    logger_all.log_info(f"inference [{flags.model_path}] \n on {data_list}")
    logger_step = YamlResultLogger(os.path.join(flags.output_path, "inference_all_step.yml"))

    results = []
    for data_path in data_list:
        data_name = os.path.basename(data_path)
        root = os.path.join(flags.output_path, data_name)
        img_path = os.path.join(root, "img")
        os.makedirs(img_path, exist_ok=False)
        with YamlResultLogger(os.path.join(root, "inference.yml")) as logger:
            logger.log_info(f"inference [{flags.model_path}] on {data_path}")
            r = infer_clip(cfg, data_path, engine, flags.real_blur, img_path, logger,
                           num_workers=flags.workers, lpips=lpips)
        r["data_name"] = data_name
        results.append(r)

    # aggregate over clips
    breakdown = defaultdict(dict)
    means = defaultdict(list)
    step_breakdown = defaultdict(dict)
    step_means = defaultdict(list)
    for entry in results:
        name = entry.pop("data_name")
        for k, v in entry["result"].items():
            breakdown[k][name] = v
            means[k].append(v)
        for k, v in entry["result_step"].items():
            step_breakdown[k][name] = v
            step_means[k].append(v)
    means = {k: float(np.mean(v)) for k, v in means.items()}
    step_means_out = {}
    for k, series in step_means.items():
        if series:
            min_len = min(len(s) for s in series)
            step_means_out[k] = [float(np.mean([s[i] for s in series])) for i in range(min_len)]
    logger_all.log_dict(dict(breakdown), "breakdown results for each data")
    logger_all.log_dict(means, "mean results for the whole data")
    logger_all.flush()
    logger_step.log_dict(dict(step_breakdown), "breakdown results for each data")
    logger_step.log_dict(step_means_out, "mean results for the whole data (based on min length)")
    logger_step.flush()
    return {"breakdown": dict(breakdown), "means": means, "step_means": step_means_out,
            "timings": [t for r in results for t in r["timings"]]}

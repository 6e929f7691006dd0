"""Trainer: iteration and epoch loops, validation, early stop, checkpoint
cadence, logging (port of ``ebfi_tpu/train/trainer.py``).

A loaded window is flattened into per-timestamp batches (the (L, NumP,
NumI) loops, multi-period loads included).  Host-to-device copies overlap
the steps: :func:`device_prefetch` keeps the next windows' copies in
flight from pinned host memory (``non_blocking``), the counterpart of the
JAX package's ``device_prefetch``.  Losses stay on the device and are
read back only at the logging cadence.

Under data parallelism every rank runs this loop on its shard, in step
with the others: the logged train loss and the validation loss are
averaged over the ranks (each rank's loss is its share of the global
batch's, scaled as ``train_step`` says), so every rank logs the global
batch's loss and takes the same early-stop and best-checkpoint decisions;
checkpoints are written by rank 0 alone, the others waiting at a barrier
(``torch.save`` does not coordinate processes, unlike the JAX package's
Orbax); the TensorBoard writer, and with it the image logging, exists on
rank 0 alone.
"""
from __future__ import annotations

import collections
import logging
import math
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel import all_reduce_mean_, barrier, is_primary
from ..utils.metrics import MetricTracker
from .checkpoint import save_checkpoint
from .train_step import TrainState


def to_device(window: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host window on ``device``; to a CUDA device from pinned memory,
    asynchronously on the current stream."""
    if device.type == "cpu":
        return {k: torch.from_numpy(v) for k, v in window.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in window.items()}


def device_prefetch(iterator, device: torch.device, n_prefetch: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Windows moved to the device ``n_prefetch`` ahead of consumption."""
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for window in it:
        queue.append(to_device(window, device))
        if len(queue) > n_prefetch:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class Trainer:
    def __init__(self, config_parser, model, state: TrainState, train_step, eval_step,
                 train_loader, valid_loader=None, writer=None, model_name: str = "EVFIAutoEx",
                 use_gt_ex: bool = True, device="cpu"):
        self.cp = config_parser
        self.model = model
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.writer = writer
        self.model_name = model_name
        self.use_gt_ex = use_gt_ex
        self.device = torch.device(device)
        self.logger = logging.getLogger("trainer")

        tcfg = self.cp["trainer"]
        if tcfg.get("iteration_based_train", {}).get("enabled"):
            self.mode = "iteration_based_train"
        elif tcfg.get("epoch_based_train", {}).get("enabled"):
            self.mode = "epoch_based_train"
        else:
            raise ValueError("Incorrect training config!")
        mcfg = tcfg[self.mode]
        self.iterations = int(float(mcfg.get("iterations", 0)))
        self.epochs = int(mcfg.get("epochs", 0))
        self.save_period = int(mcfg.get("save_period", 1000))
        self.train_log_step = int(mcfg.get("train_log_step", 50))
        self.valid_step = int(mcfg.get("valid_step", 5000))
        self.do_validation = tcfg.get("do_validation", True) and valid_loader is not None

        vis_cfg = tcfg.get("vis", {})
        self.vis_enabled = bool(vis_cfg.get("enabled", False))
        self.vis_step = int(vis_cfg.get("train_img_writer_num", 20))

        monitor = tcfg.get("monitor", "off")
        if monitor == "off":
            self.mnt_mode = "off"
            self.mnt_best = 0.0
        else:
            self.mnt_mode, self.mnt_metric = monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"monitor mode {self.mnt_mode!r} is not min or max")
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
        self.early_stop = int(tcfg.get("early_stop", 10))
        self.not_improved = 0
        self._last_log = None

        self.train_metrics = MetricTracker(["train_loss"])
        self.valid_metrics = MetricTracker(["valid_loss"])

    # -------------------------------------------------------------- #

    def _batches_from_window(self, window: Dict[str, torch.Tensor]):
        """Per-timestamp training batches of a window: each period of a
        multi-period load contributes its own blurry frame, exposure duty
        and relative-timestamp row; the targets are the load's NumP * NumF
        latents."""
        blurry = window["blurry"]        # (B, L, NumP, H, W, 3)
        events = window["events"]        # (B, L, H, W, 2TB)
        rel_ts = window["relative_ts"]   # (B, L, NumP, NumP*NumF)
        exposure = window["exposure"]    # (B, L, NumP, 1)
        latent = window.get("latent")    # (B, L, NumP, NumF', H, W, 3) or None
        B, L, num_p = blurry.shape[:3]
        num_i = rel_ts.shape[-1]
        if latent is not None:
            lat_flat = latent.reshape(B, L, -1, *latent.shape[4:])
        for idx_l in range(L):
            for p in range(num_p):
                for i in range(num_i):
                    batch = {
                        "frame": blurry[:, idx_l, p],
                        "event": events[:, idx_l],
                        "t": rel_ts[:, idx_l, p, i : i + 1],
                        "target": lat_flat[:, idx_l, i] if latent is not None else None,
                    }
                    if self.use_gt_ex:
                        batch["gt_ex"] = exposure[:, idx_l, p]
                    yield {k: v for k, v in batch.items() if v is not None}

    def _windows(self, loader):
        return device_prefetch(iter(loader), self.device)

    # -------------------------------------------------------------- #

    def train(self):
        if self.mode == "iteration_based_train":
            self.iteration_based_training()
        else:
            self.epoch_based_training()

    def iteration_based_training(self):
        it = self.state.step
        epoch = 0
        stop = it >= self.iterations
        while not stop:
            self.train_loader.set_epoch(epoch)
            for window in self._windows(self.train_loader):
                for batch in self._batches_from_window(window):
                    self.state, metrics = self.train_step(self.state, batch)
                    it = self.state.step
                    stop = self._post_step(it, metrics, batch)
                    if stop or it >= self.iterations:
                        stop = True
                        break
                if stop:
                    break
            epoch += 1
        self.logger.info("Training completes!" if it >= self.iterations else "Early stop.")

    def epoch_based_training(self):
        for epoch in range(1, self.epochs + 1):
            self.train_loader.set_epoch(epoch)
            for window in self._windows(self.train_loader):
                for batch in self._batches_from_window(window):
                    self.state, metrics = self.train_step(self.state, batch)
                    self._log(self.state.step, metrics)
            val = self._valid() if self.do_validation else {}
            stop, best = self._eval_performance(val)
            self._save(self.state.step, best=best, tag=f"checkpoint-epoch{epoch}")
            if stop:
                break

    # -------------------------------------------------------------- #

    def _post_step(self, it: int, metrics, batch=None) -> bool:
        """Logging, validation and checkpoint cadence after an iteration.
        Returns whether to stop."""
        self._log(it, metrics)
        if (self.vis_enabled and self.writer is not None and batch is not None
                and it % self.vis_step == 0):
            self._log_images(it, batch)
        stop = False
        if self.do_validation and it % self.valid_step == 0 and it != 0:
            val = self._valid()
            for k, v in val.items():
                self.logger.info(f"    {k:25s}: {v}")
                if self.writer is not None:
                    self.writer.add_scalar(f"stamp_{k}", v, it)
            stop, best = self._eval_performance(val)
            if best:
                self._save(it, best=True)
        if it % self.save_period == 0 and it != 0:
            self._save(it)
        return stop

    def _rank_mean(self, values: Dict[str, float]) -> Dict[str, float]:
        """The values averaged over the data-parallel ranks (every rank
        calls this at the same point)."""
        if not values or not torch.distributed.is_initialized():
            return values
        t = torch.tensor(list(values.values()), dtype=torch.float64, device=self.device)
        all_reduce_mean_([t], range_name="ebfi::metric_allreduce")
        return dict(zip(values, t.tolist()))

    def _log(self, it: int, metrics):
        if it % self.train_log_step != 0:
            return
        loss = self._rank_mean({"train_loss": float(metrics["train_loss"])})["train_loss"]
        self.train_metrics.update("train_loss", loss)
        now = time.perf_counter()
        sps = None
        if self._last_log is not None and now > self._last_log[1]:
            sps = (it - self._last_log[0]) / (now - self._last_log[1])
        self._last_log = (it, now)
        if self.writer is not None:
            self.writer.add_scalar("train_loss", loss, it)
            if sps is not None:
                self.writer.add_scalar("steps_per_sec", sps, it)
        msg = f"Iteration: {it}/{self.iterations} train_loss: {loss:.4e}"
        if sps is not None:
            msg += f" steps/sec: {sps:.2f}"
        self.logger.info(msg)

    def _log_images(self, it: int, batch) -> None:
        """Image panels: events, blurry, sharp, GT."""
        from ..utils.vis import render_event_cnt

        with torch.no_grad():
            _, final = self.state.model(batch["frame"][:1], batch["event"][:1], batch["t"][:1],
                                        batch["gt_ex"][:1] if "gt_ex" in batch else None)
        ev = batch["event"][0].float().cpu().numpy()
        cnt = ev.reshape(*ev.shape[:2], -1, 2).sum(axis=2)  # (H, W, 2) per polarity
        to_u8 = lambda x: (np.clip(x.float().cpu().numpy(), 0, 1) * 255).astype("uint8")  # noqa: E731
        self.writer.add_image("train_HR_events", render_event_cnt(cnt), it, dataformats="HWC")
        self.writer.add_image("train_blurry_frame", to_u8(batch["frame"][0]), it, dataformats="HWC")
        self.writer.add_image("train_sharp_frame", to_u8(final[0]), it, dataformats="HWC")
        if "target" in batch:
            self.writer.add_image("train_gt_frame", to_u8(batch["target"][0]), it,
                                  dataformats="HWC")

    def _valid(self) -> Dict[str, float]:
        self.valid_metrics.reset()
        for window in self._windows(self.valid_loader):
            for batch in self._batches_from_window(window):
                m = self.eval_step(self.state.model, batch)
                self.valid_metrics.update("valid_loss", float(m["valid_loss"]))
        return self._rank_mean(self.valid_metrics.result())

    def _eval_performance(self, val_log: Dict[str, float]):
        """Monitor and early stop: (stop, improved)."""
        if self.mnt_mode == "off" or not val_log:
            return False, False
        value = val_log[self.mnt_metric]
        improved = value <= self.mnt_best if self.mnt_mode == "min" else value >= self.mnt_best
        if improved:
            self.mnt_best = value
            self.not_improved = 0
            return False, True
        self.not_improved += 1
        if self.not_improved > self.early_stop:
            self.logger.info(
                f"Validation performance didn't improve for {self.early_stop} stamps. "
                "Training stops."
            )
            return True, False
        return False, False

    def _save(self, it: int, best: bool = False, tag: Optional[str] = None):
        tag = tag or (f"model_best_until_iteration{it}" if best else f"checkpoint-iteration{it}")
        trainer_state = {"training_mode": self.mode, "iteration": it,
                         "monitor_best": float(self.mnt_best)}
        if is_primary():
            save_checkpoint(
                self.cp.save_dir, tag, self.state.model, self.state.updater.state_dict(), it,
                self.cp.config, trainer_state, model_name=self.model_name,
                optimizer_name=self.cp["optimizer"]["name"],
                scheduler_name=(self.cp.get("lr_scheduler") or {}).get("name"),
            )
            self.logger.info(f"Saving checkpoint: {tag}")
        barrier()

"""Training CLI (port of ``ebfi_tpu/train/cli.py``).

    python -m ebfi_tpu_torch.train -c configs/train_evfi.yml -id RUN \
        [-r CKPT] [--reset] [--device cpu]

Config -> loaders (train, valid) -> model (factory, the JAX training
init's distributions from the config's seed) -> optimizer (Adam + StepLR
with the lr_min gate, gradient accumulation, FrozenEX) -> train and eval
steps -> Trainer (iteration or epoch mode, early stop, checkpoints).  The
target follows the config's model name:

- EVFIAutoEx: the full model, Laplacian + census loss;
- ExposureDecision: the stage-1 pretrain, MSE against the recorded duty
  on the real-data loader.

It trains on the card (``--device cuda``, the default; without a card it
raises) or on the CPU when asked (``--device cpu``).  One device: data
parallelism (``parallel.data_parallel`` > 1) is not ported yet.
"""
from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch

from ..data.dataloader import EBFIDataLoader
from ..models import build_model, init_weights
from .checkpoint import resume as resume_checkpoint
from .config import ConfigParser
from .exposure_step import make_exposure_eval_step, make_exposure_train_step
from .exposure_trainer import ExposureTrainer
from .optim import build_optimizer
from .train_step import TrainState, check_loss_cfg, make_eval_step, make_train_step
from .trainer import Trainer


def init_seeds(seed: int = 0) -> None:
    """Python, numpy and torch's global seeds."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _make_loader(cfg: dict, real_data: bool, seed: int) -> EBFIDataLoader:
    return EBFIDataLoader(
        cfg["path_to_datalist_txt"],
        cfg["dataset"],
        batch_size=cfg.get("batch_size", 1),
        shuffle=cfg.get("shuffle", False),
        drop_last=cfg.get("drop_last", False),
        real_data=real_data,
        seed=seed,
        num_threads=cfg.get("num_workers", 2),
    )


def make_writer(log_dir: str):
    """TensorBoard writer, or None with a warning where the tensorboard
    package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logging.getLogger("trainer").warning("tensorboard unavailable; TB logging off")
        return None
    return SummaryWriter(log_dir)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ebfi_tpu_torch.train: no CUDA device is available; pass --device cpu to train "
            "on the CPU"
        )
    return device


def main(argv=None):
    cp = ConfigParser.from_args(argv)
    device = _device(cp.device)
    seed = cp.config.get("seed", 0)
    init_seeds(seed)
    logger = logging.getLogger("train")

    tcfg = cp["trainer"]
    dp = int((cp.config.get("parallel") or {}).get("data_parallel") or 1)
    if dp > 1:
        raise NotImplementedError(
            "parallel.data_parallel > 1 is not ported to ebfi_tpu_torch yet (ROADMAP.md, queue A, "
            "A4: DDP/NCCL); train on one device"
        )
    check_loss_cfg(tcfg.get("loss"))
    precision = tcfg.get("precision", "f32")
    if precision == "f32" and device.type == "cuda":
        # f32 means f32 products: cuDNN would run f32 convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model_cfg = cp["model"]
    margs = model_cfg.get("args") or {}
    model_name = model_cfg["name"]
    exposure_only = model_name == "ExposureDecision"
    model = init_weights(build_model(model_cfg), seed, scheme="train")
    logger.info(f"{model_name}: {sum(p.numel() for p in model.parameters()):,} parameters")

    pretrain_path = margs.get("PretrainedEXPath")
    load_pretrain = margs.get("LoadPretrainEX") or margs.get("LoadPretrain")
    if not exposure_only and load_pretrain and pretrain_path:
        ex = torch.load(pretrain_path, map_location="cpu", weights_only=True)["model_states"]
        model.exposure_decision.load_state_dict(ex, strict=True)
        logger.info("Loaded pretrained ExposureDecision!")
    model.to(device).train()

    train_loader = _make_loader(
        cp["train_dataloader"],
        real_data=exposure_only or cp["train_dataloader"].get("real_data", False), seed=seed,
    )
    valid_loader = _make_loader(
        cp["valid_dataloader"],
        real_data=exposure_only or cp["valid_dataloader"].get("real_data", False), seed=seed,
    ) if "valid_dataloader" in cp.config else None

    frozen_ex = bool(margs.get("FrozenEX", margs.get("frozen_ex", False)))
    updater, _ = build_optimizer(
        model, cp["optimizer"], cp.get("lr_scheduler"),
        lr_min=float(tcfg.get("lr_min", 0.0)),
        lr_change_rate=int(tcfg.get("iteration_based_train", {}).get("lr_change_rate", 1)),
        accumulate_steps=int(tcfg.get("accu_step", 1)),
        freeze_subtree="exposure_decision" if (frozen_ex and not exposure_only) else None,
    )
    state = TrainState(model, updater, 0)
    if cp.resume:
        restored = resume_checkpoint(cp.resume, model_name, cp["optimizer"]["name"],
                                     reset=cp.reset)
        model.load_state_dict(restored["model_states"], strict=True)
        if restored["opt_states"]:
            updater.load_state_dict(restored["opt_states"])
        state.step = int(restored["step"] or 0)
        logger.info(f"Resumed from {cp.resume} at step {state.step}")

    writer = make_writer(cp.log_dir) if tcfg.get("tensorboard", False) else None

    if exposure_only:
        fashion = margs.get("BlurryFashion", margs.get("blurry_fashion", "RGBLap"))
        trainer = ExposureTrainer(
            cp, model, state,
            make_exposure_train_step(fashion), make_exposure_eval_step(fashion),
            train_loader, valid_loader, writer=writer, device=device,
        )
    else:
        detail = margs.get("DetailEnabled", margs.get("detail_enabled", True))
        trainer = Trainer(
            cp, model, state,
            make_train_step(detail_enabled=bool(detail),
                            compute_dtype=torch.bfloat16 if precision == "bf16" else None,
                            loss_cfg=tcfg.get("loss")),
            make_eval_step(),
            train_loader, valid_loader, writer=writer, model_name=model_name,
            use_gt_ex=bool(margs.get("UseGTEx", True)), device=device,
        )
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

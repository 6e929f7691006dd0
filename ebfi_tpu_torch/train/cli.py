"""Training CLI (port of ``ebfi_tpu/train/cli.py``).

    python -m ebfi_tpu_torch.train -c configs/train_evfi.yml -id RUN \
        [-r CKPT] [--reset] [--device cpu]
    torchrun --standalone --nproc_per_node=N -m ebfi_tpu_torch.train \
        -c configs/train_evfi.yml -id RUN

Config -> loaders (train, valid; their datalists name schema H5 clips or
``.npz`` clips, mixed as they come) -> model (factory, the JAX training
init's distributions from the config's seed) -> optimizer (Adam + StepLR
with the lr_min gate, gradient accumulation, FrozenEX) -> train and eval
steps -> Trainer (iteration or epoch mode, early stop, checkpoints).  The
target follows the config's model name:

- EVFIAutoEx: the full model, Laplacian + census loss, plus the terms
  ``trainer.loss`` turns on: ``perceptual`` (LPIPS) and ``adversarial``
  (a discriminator stepped inside the train step, shaped by the random or
  center crop, else the dataset's GT resolution, initialised from
  ``seed + 1`` on the model's device and broadcast from rank 0; it is not
  in the checkpoints, as in the JAX package, so a resumed run starts it
  afresh);
- ExposureDecision: the stage-1 pretrain, MSE against the recorded duty
  on the real-data loader.

It trains on the card (``--device cuda``, the default; without a card it
raises) or on the CPU when asked (``--device cpu``).

Data parallelism, as the reference runs it: one process per card, started
by a launcher that sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
LOCAL_RANK (``torchrun``; see :mod:`ebfi_tpu_torch.parallel`).  Each
process trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``), loads ``batch_size // WORLD_SIZE`` items of every global batch
from its shard of the data, and the optimizer averages the gradients over
the processes at every update.  The processes draw their parameters from
the config's seed, and rank 0's (after the pretrained ExposureDecision
and a resume) are broadcast to the others; data augmentation is seeded
with ``seed + rank``, as the JAX package seeds each process.
``parallel.data_parallel``, where the config sets it, must equal the
launcher's world size.
"""
from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch

from ..data.dataloader import EBFIDataLoader
from ..models import build_model, init_weights
from ..parallel import broadcast_module_, local_device, local_shard_info, maybe_init_distributed
from .checkpoint import resume as resume_checkpoint
from .config import ConfigParser
from .exposure_step import make_exposure_eval_step, make_exposure_train_step
from .exposure_trainer import ExposureTrainer
from .optim import build_optimizer
from .train_step import (TrainState, build_adversarial, init_adv_state, make_eval_step,
                         make_train_step)
from .trainer import Trainer


def init_seeds(seed: int = 0) -> None:
    """Python, numpy and torch's global seeds."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _make_loader(cfg: dict, shard_index: int, num_shards: int, real_data: bool,
                 seed: int) -> EBFIDataLoader:
    # the config's batch_size is global: each process loads its
    # 1/num_shards of every batch
    batch_size = cfg.get("batch_size", 1)
    if batch_size % num_shards != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by the number of "
            f"data-loading processes ({num_shards}) — the global batch is "
            "assembled as num_shards equal per-process slices"
        )
    return EBFIDataLoader(
        cfg["path_to_datalist_txt"],
        cfg["dataset"],
        batch_size=batch_size // num_shards,
        shuffle=cfg.get("shuffle", False),
        drop_last=cfg.get("drop_last", False),
        shard_index=shard_index,
        num_shards=num_shards,
        real_data=real_data,
        seed=seed,
        num_threads=cfg.get("num_workers", 2),
        fast=cfg.get("fast", False),
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
    return local_device(name)


def _discriminator_hw(loader_cfg: dict, train_loader):
    """The discriminator's input size: the random or center crop where
    augmentation crops, else the dataset's GT resolution."""
    da = loader_cfg["dataset"].get("data_augment") or {}
    if da.get("enabled"):
        for k in ("random_crop", "center_crop"):
            sub = da.get(k) or {}
            if sub.get("enabled"):
                return tuple(int(v) for v in sub["size"])
    return tuple(train_loader.datasets[0].spec.gt_resolution)


def main(argv=None):
    cp = ConfigParser.from_args(argv, make_dirs=False)
    device = _device(cp.device)
    distributed = maybe_init_distributed(device=device)
    rank, world = local_shard_info()
    cp.setup(primary=rank == 0)
    seed = cp.config.get("seed", 0)
    init_seeds(seed + rank)
    logger = logging.getLogger("train")

    tcfg = cp["trainer"]
    dp = (cp.config.get("parallel") or {}).get("data_parallel")
    if dp is not None and int(dp) != world:
        raise ValueError(
            f"parallel.data_parallel is {dp}, but {world} process(es) were launched "
            f"(WORLD_SIZE {world}): start one process per data-parallel rank, e.g. torchrun "
            f"--nproc_per_node={dp}, or drop parallel.data_parallel"
        )
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
        cp["train_dataloader"], rank, world,
        real_data=exposure_only or cp["train_dataloader"].get("real_data", False), seed=seed,
    )
    valid_loader = _make_loader(
        cp["valid_dataloader"], rank, world,
        real_data=exposure_only or cp["valid_dataloader"].get("real_data", False), seed=seed,
    ) if "valid_dataloader" in cp.config else None
    if len(train_loader) == 0:  # the training loops would wait for a batch forever
        raise ValueError(
            f"the training data holds no batch for rank {rank} of {world}: "
            f"{len(train_loader.index)} items, {len(train_loader.index) // world} per rank, "
            f"{train_loader.batch_size} per batch (drop_last "
            f"{train_loader.drop_last})"
        )

    frozen_ex = bool(margs.get("FrozenEX", margs.get("frozen_ex", False)))
    updater, _ = build_optimizer(
        model, cp["optimizer"], cp.get("lr_scheduler"),
        lr_min=float(tcfg.get("lr_min", 0.0)),
        lr_change_rate=int(tcfg.get("iteration_based_train", {}).get("lr_change_rate", 1)),
        accumulate_steps=int(tcfg.get("accu_step", 1)),
        freeze_subtree="exposure_decision" if (frozen_ex and not exposure_only) else None,
        data_parallel=distributed,
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
    broadcast_module_(model)
    if distributed:
        logger.info(f"rank {rank} of {world} on {device}, "
                    f"{cp['train_dataloader'].get('batch_size', 1) // world} items per batch")

    writer = make_writer(cp.log_dir) if rank == 0 and tcfg.get("tensorboard", False) else None

    if exposure_only:
        fashion = margs.get("BlurryFashion", margs.get("blurry_fashion", "RGBLap"))
        trainer = ExposureTrainer(
            cp, model, state,
            make_exposure_train_step(fashion), make_exposure_eval_step(fashion),
            train_loader, valid_loader, writer=writer, device=device,
        )
    else:
        detail = margs.get("DetailEnabled", margs.get("detail_enabled", True))
        adv = build_adversarial(tcfg.get("loss"), world)
        if adv is not None:
            hw = _discriminator_hw(cp["train_dataloader"], train_loader)
            sample = torch.zeros((1, *hw, 3), device=device)
            state.adv_state = init_adv_state(adv, seed + 1, {"target": sample, "frame": sample})
            broadcast_module_(state.adv_state.disc)
            logger.info(f"Adversarial loss enabled: {adv.gan_type} on {hw[0]}x{hw[1]}"
                        + (" (the discriminator is not checkpointed: it starts afresh)"
                           if cp.resume else ""))
        trainer = Trainer(
            cp, model, state,
            make_train_step(detail_enabled=bool(detail),
                            compute_dtype=torch.bfloat16 if precision == "bf16" else None,
                            loss_cfg=tcfg.get("loss"), world=world),
            make_eval_step(world),
            train_loader, valid_loader, writer=writer, model_name=model_name,
            use_gt_ex=bool(margs.get("UseGTEx", True)), device=device,
        )
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

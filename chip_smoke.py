#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, nvcc and a
CUDA build of PyTorch.  Phases, each printing one line per step with the
seconds elapsed:

1. watchdog, card identity and precision settings;
2. build the CUDA kernels (cached by a hash of their sources);
3. every kernel against its plain PyTorch version on the card, f32 and
   bf16 (B2, B2p and B3 also at a ragged shape), then timed at the serving
   path's shapes beside its bound, the plain version's time and, for B2
   and B3, cuDNN's bf16 time for their bank conv alone (a yardstick: the
   port never calls it); then B3, B2 and B2p in f32 at the same shapes,
   the 3xTF32 tensor-core route (``csrc/mod_fac.cu``), which must take the
   ``wgmma_3xtf32`` route alone, checked against the plain version (cuDNN
   f32 without TF32, plain FAC) on three draws of inputs and timed beside
   its bound (3xTF32 on the tensor cores, three TF32 products per product
   at 495 TFLOP/s), the earlier CUDA-core bound at 67 TFLOP/s and cuDNN's
   f32 bank conv alone (TF32 off; a yardstick the port never calls);
4. the serving engine at 720x1280 with N = 16 timestamps and the shipped
   model's widths (random weights from a seed): (a) bf16 hoisted
   ``interpolate`` through kernel B2, (b) bf16 ``forward`` through B3,
   (c) f32 unhoisted ``interpolate`` through B1, (d) f32 hoisted
   ``interpolate`` (``fast_math=True``) through B2 on the 3xTF32 route;
   each path's launch counts are reset before it and checked after it,
   (a) and (b) must have taken the bf16 tensor-core route and (d) the
   3xTF32 one.  Then a profile of one steady request of (a): the top
   device kernels and their share of it.  Then correctness: (d) against
   (c) on the first request (f32 hoisted and fused against unhoisted),
   hoisted against unhoisted at 720p in bf16, and the card against the CPU
   on a small input in f32;
5. the inference CLI on the card: (a) ``ebfi_tpu_torch.infer.cli.main``
   serves a synthetic 720x1280 clip (2 blurry frames x 16 timestamps) in
   bf16 with the shipped model from a port checkpoint, through B2 alone;
   its restored frames are held against the engine called directly, and
   the host and device time of each blurry frame is printed; (c) a model
   with FrameBasech 8 in bf16 takes the unfused path (cuDNN bank conv and
   B1), card against CPU; (b) ``python -m ebfi_tpu_torch.infer`` in f32 on a
   64x96 clip, on the card and with ``--device cpu``, outputs compared;
   (d) the loader's host plane on (a)'s clip: every item with the native
   plane (C++, ``ebfi_tpu_torch/native``) and with the numpy plane, in
   turns over three passes, bit for bit, and each plane's host ms per
   blurry frame in each pass beside the CPU model;
6. training on the card: (a) ``ebfi_tpu_torch.train.cli.main`` trains the
   shipped model (``configs/train_evfi.yml`` with ';' overrides: a
   synthetic clip, 20 iterations, checkpoints and validation every 10)
   in f32 at batch 8 on 128x128 crops, through B1 (unfused Modification);
   it resumes from ``checkpoint-iteration10.pt`` to step 20, and its last
   checkpoint serves through ``ebfi_tpu_torch.infer.cli.load_model``;
   (b) the same in bf16 with FastVariants, through B3 on the tensor cores
   alone; each prints its steady ms per iteration and a profile of one
   step with the plain backward's share; (c) the gradients of B1, B3 (bf16
   and f32), B2 and B2p (bf16) at the training shapes against autograd through
   their plain versions, and a fused Modification's against the same
   module with the plain version's graph on B3's values; (d) one Adam
   step of a small model on the card against the CPU;
7. data-parallel training and LPIPS, the ranks started by
   ``python -m torch.distributed.run`` (each rank is this script with
   ``--dp-worker SPEC``; it writes its results to JSON files): (a) phase
   6's two trainings on one NCCL rank, with their ms per iteration beside
   phase 6's, the ``ebfi::grad_allreduce`` range's device time per update
   and B1/B3 launches by route; (b) two gloo ranks on the one card (NCCL
   refuses two ranks on one device): two Adam steps of the shipped model
   in f32 (B1) and bf16 (B3) against one process on the concatenated
   batches (the ranks bitwise equal), then the train CLI (rank 0 alone
   writes checkpoints, both log the same losses); (c) NCCL over every
   card, where the machine has more than one; (d) LPIPS: phase 5 (b)'s
   CLI runs carry ``--alexnet_weights`` (a random torchvision-layout
   backbone) and their ``lpips`` columns must agree, LPIPS's ms per 720p
   frame pair, and three bf16 steps with ``trainer.loss.perceptual``
   through ``-m ebfi_tpu_torch.train`` under the launcher;
8. the adversarial term, the flow losses and device event encoding: (a)
   phase 6's two trainings with ``trainer.loss.adversarial`` (STGAN,
   weight 0.01) in this process, then under the launcher on one NCCL
   rank: launches as in phase 6, the discriminator trained, ms per
   iteration beside phase 6's, and a profile of one step with the
   ``ebfi::adversarial`` and ``ebfi::disc_grad_allreduce`` ranges; (b)
   one STGAN step (batch 8, 128x128, f32) and one WGAN_GP discriminator
   step (the penalty's double backward) card against CPU; (c) two gloo
   ranks with STGAN on the one card against one process; (d)
   ``events_to_stack``, ``averaged_iwe``, EventWarping and
   BrightnessConstancy at 720x1280 with 200 000 events, card against CPU,
   with their ms on the card;
9. dataset generation and the op and block library: (a) one synthetic
   sequence of 9 frames at 720x1280, written as PNGs with all five row
   filters, through ``ebfi_tpu_torch.data.generate.main`` on the card
   with a random-weight SuperSloMo checkpoint whose flow UNet outputs a
   constant flow (|F| = 2.5, so 3 frames per pair; the UNet still runs in
   full): ms per flow pass and per arbitrary-time pass (CUDA events) beside
   their bounds, pairs/s and output frames/s, host seconds in the PNG
   decode, ``simulate_events`` and the write, peak memory; then one item of
   the written clip through ``NpzClipDataset``; (b) SuperSloMo's
   ``upsample_sequence`` and the generator at 64x96, card against CPU;
   (c) DCNv2's forward and gradients, PSROI pooling, every block of
   ``models/library.py`` and ConvLayer's BN (train and eval) and IN, card
   against CPU;
10. the exported programs, norm models and dataset options: (a) the
   engine's call exported by ``ebfi_tpu_torch/tools/export.py`` at
   720x1280 (the shipped model, random weights from the seed): N = 16 in
   bf16 (hoisted, B2 on ``wgmma_bf16``), N = 16 in f32 (unhoisted,
   multi_chunk 4, B1), one timestamp in bf16 (B3); each saved as ``.pt2``
   (its export seconds and size printed), the engine timed on phase 4's
   requests, then every program served by one fresh process that imports
   only ``ebfi_tpu_torch.ops`` (this script with ``--export-worker
   SPEC``): outputs within EXPORT_TOL of the engine's, the same launches,
   the kernel and route of the path alone, ms per request beside the
   engine's; (b) EVFIAutoEx with ``norm`` BN (running statistics drawn
   away from 0 and 1) and IN, ``dual_path`` False, N = 16 at 720p in f32
   and in bf16 with fast_math: B1 alone launches (Modification stays
   unfused), ms per request, card against CPU at 64x96; (c) three steps of
   ``train.cli.main`` on the shipped f32 config with
   ``train_dataloader.fast``, and with ``NeedNeighborGT`` on a config that
   rescales (GT at half the stored resolution), each against the same run
   without the option: equal losses step by step (cuDNN deterministic);
11. spatial parallelism (DP x SP): (a) B1's band mode at the serving shape
   (B=4, 360x640x64, K=5), f32 and bf16, cut into 2 bands of 180 rows with
   their 2 + 2 halo rows: each band against the plain version (TOL_REL)
   and against whole-image B1's rows, timed over both bands beside
   whole-image B1 on the same image; (b) three Adam steps of the shipped
   model (batch 8, 128x128 crops), f32 and bf16 FastVariants, through
   ``make_train_step(spatial=spatial_shardings(2))`` on two gloo ranks on
   the one card (this script with ``--dp-worker SPEC``), against the
   unsharded step in this process: losses within 1e-5 relative in f32
   (1e-2 in bf16), parameters within 2 * lr per step (the ranks bitwise
   equal), B1's band mode launched on every step and B1, B3 and B2 never;
   ms per iteration and each rank's peak memory beside the unsharded
   step's (two ranks sharing one card: not a speed figure); then the same
   with ``trainer.loss.adversarial`` (STGAN) and ``trainer.loss.perceptual``
   (LPIPS, random AlexNet), f32 and bf16: each step's train_loss,
   lpips_loss, g_loss and d_loss relative to the unsharded step's
   (SP_TERM_TOL; step 1's d_loss, before any discriminator update,
   SP_FIRST_STEP_TOL), the model's parameters and the discriminator's
   (within 2 * lr per step, at most SP_DISC_SHARE of them more than
   1e-3 * lr apart), and one profiled step's ``ebfi::adversarial`` range on rank 0
   and unsharded; then f32 with both terms on four gloo ranks (2 x 2: two
   data shards of 4 items, so the discriminator's BN statistics, its
   gradients' mean and the shards' items span the data axis), the mean
   of the ranks' metrics against the unsharded step's, as above;
12. a real recording's way in: (a) a DAVIS346-shaped recording (260x346,
   9 grey APS frames with per-frame exposures, over 10^6 events from
   ``data.synth.simulate_events``) from the seed, written as a ROS bag (bz2
   chunks) and as an events ``.npz`` with PNG frames; (b) both through
   ``python -m ebfi_tpu_torch.data.ingest`` (``bag``, the exposures by
   ``set-array``; ``events``), the clips equal array for array, host
   seconds and events/s; (c) the infer CLI with ``scripts/infer.sh``'s
   RealBlur-DAVIS flags (``--real_blur``, 256 timestamps per blurry
   frame) in f32 (B1) and bf16 (B2 on ``wgmma_bf16``): frames, wall
   seconds, frames/s, host and device ms per blurry frame, launches; (d)
   B1 and B2 against their plain versions at this path's shapes, and the
   card against the CPU on the first blurry frame at 16 timestamps; (e)
   the stack and cloud movies, their ms and bytes;
13. schema H5 clips without h5py (the port's HDF5 reader and writer): (a)
   phase 5's 33-frame 720x1280 clip written as npz and, through
   ``H5Packager`` with gzip, as H5, seconds and bytes of each; (b) items of
   ``H5ClipDataset`` (that clip, the CLI's config), ``H5ClipDatasetFast``
   (phase 6's clip, flips, crops, noise) and ``H5ClipDatasetReal`` (phase
   12's DAVIS346 recording with exposures) on the H5 clips against the same
   datasets on the npz clips, bit for bit, host ms per item (the H5
   route's chunk decoding apart); (c) the infer CLI in bf16 on the npz clip
   and on the H5 clip (cuDNN deterministic): restored PNGs byte for byte
   and means equal, B2 once per blurry frame, each run's host fetch ms per
   blurry frame; (d) 3 steps of phase 6's f32 training (B1) from an npz and
   from an H5 datalist, losses equal.

After the phases, a line gives the seconds each took ("seconds by
phase"), so a change in the script's time can be put down to a phase.
The line before the last is a JSON object with the kernels' numbers
(``launches_train``: B1's launches in run (a), validation forwards
included, and B3's in run (b); ``launches_dp_nccl``: the same in phase 7
(a); ``launches_adversarial``: the same in phase 8 (a)'s runs in this
process; ``launches_generate``: all kernels' launches in phase 9 (a)'s
generator run, 0: no FAC kernel is on that path; ``launches_export``: the
kernel's launches by phase 10 (a)'s exported programs; ``launches_norm``:
B1's in phase 10 (b), 0 for the others; ``f32_route``: B2, B2p and
B3's f32 numbers from phase 3, with their launches in phase 4 (d);
``launches_spatial``: each kernel's launches on rank 0 in each of phase
11 (b)'s runs; the row ``B1_fac_band``: B1's band mode, phase 11 (a)'s
f32 numbers, its launches those of phase 11 (b); ``launches_real``: each
kernel's launches in phase 12 (c)'s f32 and bf16 runs; ``launches_h5``: each
kernel's launches in phase 13 (c)'s H5 CLI run and (d)'s H5 training run); the
last line is ``{"ok": true,
"device": {...}}``.  Any failure raises and
the run exits non-zero; without a CUDA card it exits 2 and prints no
result.
"""
from __future__ import annotations

import contextlib
import faulthandler
import functools
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

WATCHDOG_S = 1100
SEED = 0
H, W, N = 720, 1280, 16  # one request: a 720p frame, its events, 16 timestamps
REQUESTS = 3
C, K = 64, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# f32 CUDA cores; bf16 and TF32 tensor cores (dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# kernel vs plain version: f32 sums reassociate (1152-deep dots); in bf16
# the plain version runs in f32 on the same bf16 inputs and the kernel's
# output (and B2's ff scratch) round to bf16, 2^-9 relative each
TOL_REL = {"float32": 2e-5, "bfloat16": 1e-2}
F32_DRAWS = 3  # inputs each f32 row of phase 3 is checked on at the serving shape
MODEL_CFG = {  # bench.py / configs/train_evfi.yml
    "name": "EVFIAutoEx",
    "args": {
        "FrameBasech": 64, "EventBasech": 64, "InterCH": 64, "TB": 16,
        "BlurryFashion": "RGBLap", "BLInch": 4, "step": 12, "DualPath": True,
        "residual": True, "DetailEnabled": True, "channels": [16, 24, 32, 64],
        "norm": None, "activation": "LeakyReLU",
    },
}
T0 = time.perf_counter()
LOG_PREFIX = ""  # a phase-7 rank's "[rank r/n] "


def log(msg: str) -> None:
    print(f"{LOG_PREFIX}[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------- kernels


def kernel_cases(torch, kern):
    """name -> the TPU kernel it replaces, its source, wrapper and plain
    version, an input maker, and the (B, N) of the check and of the
    serving path."""
    # drawn on the card: B1's bank at the serving shape is 1.5e9 values,
    # which numpy takes tens of seconds to draw on the host
    gen = torch.Generator("cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def fac_args(B, h, w, dt, n=1):
        return [randn(B, h, w, C).to(dt), randn(B, h, w, K * K * C).to(dt), K]

    def mod_args(B, h, w, dt, n=1):
        t = [randn(B * n, h, w, C), randn(B, h, w, C), randn(3, 3, 2 * C, K * K * C, scale=0.05)]
        return [a.to(dt) for a in t] + [randn(K * K * C, scale=0.1), K]

    return {
        "B1_fac": dict(
            replaces="ebfi_tpu/ops/pallas/fac.py:31 _fac_kernel",
            source="ebfi_tpu_torch/csrc/fac.cu", fn=kern.kernel_conv2d_cuda,
            plain=kern.fac_plain, args=fac_args, check=(4, 1), main=(4, 1, "float32"),
            shared=False,
        ),
        "B3_mod_fac": dict(
            replaces="ebfi_tpu/ops/pallas/mod_fac.py:51 _kernel",
            source="ebfi_tpu_torch/csrc/mod_fac_wgmma.cu", fn=kern.modification_fac_fused,
            plain=kern.mod_fac_plain, args=mod_args, check=(1, 1), main=(1, 1, "bfloat16"),
            ragged=(2, 1), shared=False,
        ),
        "B2_mod_fac_shared": dict(
            replaces="ebfi_tpu/ops/pallas/mod_fac.py:148 _kernel_shared",
            source="ebfi_tpu_torch/csrc/mod_fac_wgmma.cu", fn=kern.modification_fac_fused_shared,
            plain=kern.mod_fac_shared_plain, args=mod_args, check=(1, 4), main=(1, N, "bfloat16"),
            ragged=(2, 3), shared=True,
        ),
        # B2 with the rows2-packed store (PACKED=True): H must be even
        "B2p_mod_fac_shared_packed": dict(
            replaces="ebfi_tpu/ops/pallas/mod_fac.py:148 _kernel_shared (PACKED=True)",
            source="ebfi_tpu_torch/csrc/mod_fac_wgmma.cu",
            fn=functools.partial(kern.modification_fac_fused_shared, packed_rows2=True),
            plain=functools.partial(kern.mod_fac_shared_plain, packed_rows2=True),
            args=mod_args, check=(1, 4), main=(1, N, "bfloat16"), ragged=(2, 3),
            ragged_hw=(38, 70), shared=True, no_cudnn=True,
        ),
    }


def work(name: str, B: int, n: int, h: int, w: int, dtype: str):
    """(bytes each input read once and each output written once, flops)."""
    s = 4 if dtype == "float32" else 2
    pix = B * h * w
    if name == "B1_fac":
        return (2 * pix * C + pix * K * K * C) * s, 2 * K * K * C * pix
    weights = 9 * 2 * C * K * K * C * s + K * K * C * 4
    fac = 2 * K * K * C * pix * n
    if name == "B3_mod_fac":
        return 3 * pix * C * s + weights, 2 * pix * 9 * 2 * C * K * K * C + fac
    # B2: ev and out at B*n, ff at B; the ff half once per frame
    return (2 * n + 1) * pix * C * s + weights, 2 * pix * (n + 1) * 9 * C * K * K * C + fac


def plain_version(torch, cs, args):
    """The plain version in f32 on the kernel's inputs; B2's per frame in
    chunks of 4 timestamps, which bounds its f32 bank (at N = 16 whole it
    would be 16 x 360 x 640 x 1600 floats, 23.6 GB)."""
    f32 = [a.float() if torch.is_tensor(a) else a for a in args]
    if not cs["shared"]:
        return cs["plain"](*f32)
    ev, ff = f32[0], f32[1]
    n = ev.shape[0] // ff.shape[0]
    return torch.cat([cs["plain"](ev[b * n + i : b * n + min(i + 4, n)], ff[b : b + 1], *f32[2:])
                      for b in range(ff.shape[0]) for i in range(0, n, 4)])


def compare(torch, cs, args, label: str) -> float:
    """Kernel against its plain version evaluated in f32 on the same inputs
    (:func:`plain_version`); raises beyond the stated tolerance."""
    dname = str(args[0].dtype).split(".")[1]
    with torch.inference_mode():
        got = cs["fn"](*args).float()
        ref = plain_version(torch, cs, args)
        torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = TOL_REL[dname] * ref.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= tol
    log(f"check {label}: max_abs_err={err:.3e} tol={tol:.3e} "
        f"(plain version in f32 on the same inputs) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err


def bank_conv_cudnn_ms(torch, args, shared: bool) -> float:
    """cuDNN's time for the bank conv alone, in the inputs' dtype,
    channels-last: concat(ev, ff) -> K*K*C for B3; ev -> K*K*C per timestamp
    plus ff -> K*K*C per frame for B2.  No bias, activation or FAC, and the
    bank is written to device memory: a yardstick, not the same function."""
    import torch.nn.functional as F

    ev, ff, wk = args[0], args[1], args[2]
    w = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    nchw = lambda x: x.permute(0, 3, 1, 2)  # an NHWC tensor seen as channels-last NCHW
    if shared:
        we, wf = (w[:, h].contiguous(memory_format=torch.channels_last)
                  for h in (slice(0, C), slice(C, 2 * C)))
        fn = lambda: (F.conv2d(nchw(ev), we, padding=1), F.conv2d(nchw(ff), wf, padding=1))
    else:
        cat = torch.cat([ev, ff], dim=-1)
        fn = lambda: F.conv2d(nchw(cat), w, padding=1)
    return cuda_ms(fn, reps=3)


def phase_kernels(torch, kern):
    results = {}
    cases = kernel_cases(torch, kern)
    hc, wc = 64, 640  # full width; 64 rows bound the plain versions' banks
    for name, cs in cases.items():
        shapes = [(*cs["check"], hc, wc)]
        if "ragged" in cs:  # neither H, W nor N a multiple of the tensor-core tiles
            shapes.append((*cs["ragged"], *cs.get("ragged_hw", (37, 70))))
        for B, n, h, w in shapes:
            for dt in (torch.float32, torch.bfloat16):
                args = cs["args"](B, h, w, dt, n)
                compare(torch, cs, args, f"{name} {str(dt)[6:]} B={B} N={n} {h}x{w}")
                del args
        torch.cuda.empty_cache()

    for name, cs in cases.items():
        B, n, dname = cs["main"]
        dt = getattr(torch, dname)
        hm, wm = H // 2, W // 2
        args = cs["args"](B, hm, wm, dt, n)
        shape = f"B={B} N={n} {hm}x{wm}x{C} K={K}"
        err = compare(torch, cs, args, f"{name} {dname} {shape} (serving shape)")
        with torch.inference_mode():
            ms = cuda_ms(lambda: cs["fn"](*args), reps=5 if name == "B1_fac" else 3)
            plain_ms = cuda_ms(lambda: cs["plain"](*args), reps=2)
            cudnn_ms = (None if name == "B1_fac" or cs.get("no_cudnn")
                        else bank_conv_cudnn_ms(torch, args, cs["shared"]))
        nbytes, flops = work(name, B, n, hm, wm, dname)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
        results[name] = dict(
            max_abs_err=err, route="cuda", source=cs["source"], replaces=cs["replaces"],
            dtype=dname, shape=shape, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, bank_conv_cudnn_ms=cudnn_ms,
        )
        r = results[name]
        log(f"time {name} {dname} {r['shape']}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{nbytes / ms / 1e6:.0f} GB/s)"
            + ("" if cudnn_ms is None else f"; cuDNN bf16 bank conv alone {cudnn_ms:.3f} ms"))
        del args
        torch.cuda.empty_cache()
    phase_f32_route(torch, kern, cases, results)
    return results


def phase_f32_route(torch, kern, cases, results):
    """B3, B2 and B2p in f32 at the serving shapes: the 3xTF32 tensor-core
    route (``csrc/mod_fac.cu``), which serving path (d) launches (B2) and
    training reaches in a FastVariants run's f32 eval steps (B3).  Checked
    against the plain version on ``F32_DRAWS`` draws of inputs, timed
    beside its bound -- 3xTF32 on the tensor cores (three TF32 products per
    product at 495 TFLOP/s, or the bytes once), which ``bound_ms`` and
    ``share_of_bound`` hold -- the CUDA-core f32 bound at 67 TFLOP/s of the
    earlier route (``bound_cuda_cores_ms``, no share), the plain version's time
    (B2's in chunks of 4 timestamps, as the check runs it) and cuDNN's f32
    bank conv alone without TF32 (``library_ms``: a yardstick, not the same
    function, never called by the port); the launches must all take the
    ``wgmma_3xtf32`` route.  Adds ``f32_route`` to each result."""
    hm, wm = H // 2, W // 2
    for name in ("B3_mod_fac", "B2_mod_fac_shared", "B2p_mod_fac_shared_packed"):
        cs = cases[name]
        B, n, _ = cs["main"]
        args = cs["args"](B, hm, wm, torch.float32, n)
        shape = f"B={B} N={n} {hm}x{wm}x{C} K={K}"
        kern.reset_launch_counts()
        errs = [compare(torch, cs, args, f"{name} float32 {shape} (serving shape, 3xTF32 route)")]
        for draw in range(1, F32_DRAWS):  # the error on other inputs: fresh draws of the same sizes
            more = cs["args"](B, hm, wm, torch.float32, n)
            errs.append(compare(torch, cs, more, f"{name} float32 {shape} (serving shape, "
                                                  f"3xTF32 route, draw {draw + 1})"))
            del more
        err = max(errs)
        with torch.inference_mode():
            ms = cuda_ms(lambda: cs["fn"](*args), reps=3)
            plain_ms = cuda_ms(lambda: plain_version(torch, cs, args), reps=1)
            cudnn_ms = (None if cs.get("no_cudnn")
                        else bank_conv_cudnn_ms(torch, args, cs["shared"]))
        routes = kern.route_counts()["mod_fac_shared" if cs["shared"] else "mod_fac"]
        if routes["wgmma_3xtf32"] <= 0 or any(v for r, v in routes.items()
                                              if r != "wgmma_3xtf32"):
            raise AssertionError(f"{name} float32: launches took another route ({routes})")
        nbytes, flops = work(name, B, n, hm, wm, "float32")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_tc, t_simt = 3 * flops / PEAK_FLOPS["tf32"] * 1e3, flops / PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_tc)  # the route's own: 3xTF32 on the tensor cores
        results[name]["f32_route"] = dict(
            source="ebfi_tpu_torch/csrc/mod_fac.cu", route="wgmma_3xtf32", shape=shape, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_tc_ms=bound,
            bound_by="bytes" if t_bytes >= t_tc else "operations",
            bound_cuda_cores_ms=max(t_bytes, t_simt), library_ms=cudnn_ms, max_abs_err=err,
            max_abs_err_by_draw=errs, share_of_bound=bound / ms)
        log(f"time {name} float32 {shape} (3xTF32 route, wgmma_3xtf32): {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms{' (4 timestamps at a time)' if cs['shared'] else ''}; bound "
            f"{bound:.3f} ms as 3xTF32 at 495 TFLOP/s ({100 * bound / ms:.1f} % of it; the "
            f"CUDA cores' f32 bound at 67 TFLOP/s: {max(t_bytes, t_simt):.3f} ms); "
            f"{flops / ms / 1e9:.1f} TFLOP/s of f32 products"
            + ("" if cudnn_ms is None else
               f"; cuDNN f32 bank conv alone, TF32 off: {cudnn_ms:.3f} ms"))
        del args
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------- engine


def make_request(torch, rng, h=H, w=W, n=N):
    frame = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    event = np.abs(rng.standard_normal((1, h, w, 32), dtype=np.float32))
    ts = np.linspace(0, 1, n, dtype=np.float32)[None]
    return [torch.from_numpy(a).cuda() for a in (frame, event, ts)]


def serve(torch, kern, label, kernel_name, call, requests, frames_per_request, route=None):
    """Drive one engine path over the requests with launch counts zeroed
    just before and read just after; the kernel (and, where given, its
    route) must have been launched.  Returns (outputs, launches, launches
    by route)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    outs, times = [], []
    for req in requests:
        t0 = time.perf_counter()
        out = call(*req)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: non-finite output")
        outs.append(out)
    counts = kern.launch_counts()
    routes = kern.route_counts()
    if counts[kernel_name] <= 0:
        raise AssertionError(f"{label}: kernel {kernel_name} was never launched ({counts})")
    if route is not None and (routes[kernel_name][route] <= 0 or any(
            v for r, v in routes[kernel_name].items() if r != route)):
        raise AssertionError(f"{label}: {kernel_name} did not take route {route} alone ({routes})")
    steady = times[1:] or times
    ms = 1e3 * sum(steady) / len(steady)
    log(f"engine {label}: out {tuple(outs[0].shape)} finite; per request ms "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}; steady {ms:.1f} ms/request, "
        f"{frames_per_request / ms * 1e3:.2f} frames/s; launches {counts}; routes {routes}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return outs, counts, routes


def breakdown(torch, label, call, top=12, ranges=()):
    """Where one steady request's time goes: torch.profiler's device-side
    events (kernels, copies, memsets) summed by name, the top ones with
    their share of the request's wall time, and the device's idle share.
    Fails if the profiler records no device time.  ``ranges`` names
    ``record_function`` ranges whose device time is reported apart: their
    device-side span where the profiler records one, with the time of the
    kernels inside it, else the device time of the kernels launched under
    them (``key_averages``).  Returns {range: {"span_ms", "busy_ms",
    "launches"}} of the ranges it found (``span_ms`` and ``launches`` None
    without a span), and the step's {"wall_ms", "busy_ms", "launches"}
    under ``"step"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per, spans, kernels = {}, {}, []
    events = prof.events()
    # record_function ranges (the optimizer's, ours) also appear on the
    # device's timeline as spans; they are not kernels
    annotations = set(ranges) | {e.name for e in events if getattr(e, "is_user_annotation", False)}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name in annotations:
            spans.setdefault(e.name, []).append(e.time_range)
        elif e.device_type == DeviceType.CUDA:
            acc = per.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
            kernels.append(e.time_range)
    busy_ms = sum(v[0] for v in per.values())
    if busy_ms <= 0:
        raise AssertionError(f"breakdown {label}: torch.profiler recorded no device time")
    log(f"breakdown {label} (torch.profiler, one steady request): wall {wall_ms:.1f} ms "
        f"under the profiler, device busy {busy_ms:.1f} ms, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f} %; {len(per)} kernel names, "
        f"{sum(v[1] for v in per.values())} launches")
    for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / wall_ms:5.1f} % of the wall {n:5d} launches  "
            f"{name[:110]}")
    averages = {a.key: a for a in prof.key_averages()} if ranges else {}
    found = {}
    for r in ranges:
        if r in spans:
            span = sum(t.elapsed_us() for t in spans[r]) / 1e3
            within = [k for k in kernels
                      if any(t.start <= k.start and k.end <= t.end for t in spans[r])]
            inside = sum(k.elapsed_us() for k in within) / 1e3
            found[r] = {"span_ms": span, "busy_ms": inside, "launches": len(within)}
            log(f"  range {r}: {span:.3f} ms, {100 * span / wall_ms:.1f} % of the wall "
                f"(device-side span of the range, first kernel to last, gaps included); its "
                f"{len(within)} kernels busy {inside:.3f} ms of it")
        elif r in averages:
            a = averages[r]
            ms = getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0)) / 1e3
            found[r] = {"span_ms": None, "busy_ms": ms, "launches": None}
            log(f"  range {r}: {ms:.3f} ms, {100 * ms / wall_ms:.1f} % of the wall (device time "
                f"of the kernels under the range, key_averages)")
        else:
            log(f"  range {r}: not recorded")
    found["step"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                     "launches": sum(v[1] for v in per.values())}
    return found


def phase_engine(torch, kern):
    from ebfi_tpu_torch.infer import InferenceEngine
    from ebfi_tpu_torch.models import build_model, init_weights

    model = init_weights(build_model(MODEL_CFG), SEED)
    log(f"model built: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters "
        f"(random weights, seed {SEED})")
    rng = np.random.default_rng(SEED + 1)
    requests = [make_request(torch, rng) for _ in range(REQUESTS)]
    launches = {}

    bf16 = InferenceEngine(model, precision="bf16")  # fast_math: hoisted tail + fused Modification
    outs_a, counts, routes_a = serve(
        torch, kern, "(a) bf16 hoisted interpolate(outputs='final') N=16", "mod_fac_shared",
        lambda f, e, ts: bf16.interpolate(f, e, ts, outputs="final")[1], requests, N,
        route="wgmma_bf16",
    )
    packed = kern.modification_fac_fused_shared.launches_packed
    launches["B2_mod_fac_shared"] = counts["mod_fac_shared"] - packed
    launches["B2p_mod_fac_shared_packed"] = packed  # the engine has no rows2 consumer
    routes = {"B2_mod_fac_shared": routes_a["mod_fac_shared"]}
    breakdown(torch, "(a)", lambda: bf16.interpolate(*requests[-1], outputs="final")[1])
    _, counts, routes_b = serve(
        torch, kern, "(b) bf16 forward() one timestamp", "mod_fac",
        lambda f, e, ts: bf16.forward(f, e, ts[:, :1])[1], requests, 1, route="wgmma_bf16",
    )
    launches["B3_mod_fac"] = counts["mod_fac"]
    routes["B3_mod_fac"] = routes_b["mod_fac"]
    del bf16
    f32 = InferenceEngine(model, precision="f32", multi_chunk=4)
    outs_c, counts, _ = serve(
        torch, kern, "(c) f32 unhoisted interpolate(outputs='final') N=16, multi_chunk=4 "
        "(bounds the materialised f32 bank to 4x360x640x1600, 5.9 GB)", "fac",
        lambda f, e, ts: f32.interpolate(f, e, ts, outputs="final")[1], requests, N,
    )
    launches["B1_fac"] = counts["fac"]
    del f32
    torch.cuda.empty_cache()
    f32_fast = InferenceEngine(model, precision="f32", fast_math=True)
    outs_d, counts, routes_d = serve(
        torch, kern, "(d) f32 hoisted interpolate(outputs='final') N=16, fast_math=True "
        "(fused Modification through B2 on the 3xTF32 route)", "mod_fac_shared",
        lambda f, e, ts: f32_fast.interpolate(f, e, ts, outputs="final")[1], requests, N,
        route="wgmma_3xtf32",
    )
    if any(v for r, v in routes_d["mod_fac"].items() if r != "wgmma_3xtf32"):
        raise AssertionError(f"(d): B3 took another route than wgmma_3xtf32 ({routes_d})")
    packed = kern.modification_fac_fused_shared.launches_packed
    f32_launches = {"B2_mod_fac_shared": counts["mod_fac_shared"] - packed,
                    "B2p_mod_fac_shared_packed": packed, "B3_mod_fac": counts["mod_fac"]}
    del f32_fast
    # (d) against (c) on the first request: the same f32 model, hoisted with
    # B2's 3xTF32 bank conv and f32 ff scratch against unhoisted with cuDNN's
    # f32 bank conv (TF32 off) and B1; f32-grade products on both sides, so
    # the 64x96 card-vs-CPU check's 1e-3 holds here too
    diff = (outs_d[0] - outs_c[0]).abs()
    max_d, mean_d = diff.max().item(), diff.mean().item()
    ok = max_d <= 1e-3
    log(f"check (d) f32 hoisted+fused vs (c) f32 unhoisted, 720x1280 N=16: max_abs={max_d:.2e} "
        f"(tol 1e-3) mean_abs={mean_d:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the f32 hoisted (3xTF32) and unhoisted engines disagree")
    del outs_c, outs_d, diff
    torch.cuda.empty_cache()

    # hoisted (B2) against unhoisted (B1) on the first request, both bf16
    unhoisted = InferenceEngine(model, precision="bf16", fast_math=False, multi_chunk=4)
    ref = unhoisted.interpolate(*requests[0], outputs="final")[1]
    diff = (outs_a[0] - ref).abs()
    max_d, mean_d = diff.max().item(), diff.mean().item()
    ok = max_d <= 0.25 and mean_d <= 0.01
    log(f"check hoisted vs unhoisted bf16, 720x1280 N=16: max_abs={max_d:.4f} (tol 0.25) "
        f"mean_abs={mean_d:.5f} (tol 0.01) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("hoisted and unhoisted bf16 engines disagree")
    del unhoisted, ref, outs_a
    torch.cuda.empty_cache()

    # the card against the CPU (plain versions, CPU convolutions) in f32
    small = make_request(torch, np.random.default_rng(SEED + 2), 64, 96, 3)
    for fast in (False, True):
        gpu = InferenceEngine(model, precision="f32", fast_math=fast)
        cpu = InferenceEngine(model, precision="f32", fast_math=fast, device="cpu")
        kern.reset_launch_counts()
        got = gpu.interpolate(*small)[1].cpu()
        used = [k for k, v in kern.launch_counts().items() if v]
        want = cpu.interpolate(*[x.cpu() for x in small])[1]
        err = (got - want).abs().max().item()
        ok = err <= 1e-3 and bool(used)
        log(f"check card vs CPU f32, 64x96 N=3, fast_math={fast} (kernels {used}): "
            f"max_abs={err:.2e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card and the CPU disagree")
    return launches, routes, f32_launches


# ---------------------------------------------------------------------- CLI

CLI_FLAGS = [  # scripts/infer.sh's synthetic-data flags at the stored resolution
    "--scale", "1", "--ori_scale", "ori", "--time_bins", "16",
    "--num_frame_per_period", "16", "--num_frame_per_blurry", "3",
    "--num_period_per_seq", "2", "--sliding_window_seq", "2",
    "--num_period_per_load", "1", "--sliding_window_load", "1",
    "--exposure_method", "Fixed", "--noise_enabled",
]
CLIP_FRAMES = 33  # 2 periods of 16 frames: 2 blurry frames x 16 timestamps
SMALL_CFG = {  # FrameBasech 8: Modification cannot take the fused kernels
    "name": "EVFIAutoEx",
    "args": {"FrameBasech": 8, "EventBasech": 8, "InterCH": 8, "TB": 16, "step": 2,
             "channels": [4, 6, 8, 12]},
}


def run_cli(cli, kern, torch, ckpt, clip, out, extra=(), flags=CLI_FLAGS):
    """cli.main in this process with launch counts zeroed just before and
    read just after; returns (summary, wall s, launches, routes)."""
    datalist = out + ".txt"
    with open(datalist, "w") as f:
        f.write(clip + "\n")
    torch.cuda.synchronize()
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["--model_path", ckpt, "--data_list", datalist, "--output_path", out,
                        *flags, *extra])
    wall = time.perf_counter() - t0
    return summary, wall, kern.launch_counts(), kern.route_counts()


def restored_pngs(out, clip):
    d = os.path.join(out, os.path.basename(clip), "img", "restored_frame")
    return {n: os.path.join(d, n) for n in sorted(os.listdir(d))}


def compare_outputs(label, read_png, a, b, max_level, frac_over_1, psnr_tol):
    """Restored PNGs of two CLI runs (paths by name) and their mean PSNRs."""
    (pa, ma), (pb, mb) = a, b
    if sorted(pa) != sorted(pb) or not pa:
        raise AssertionError(f"{label}: restored frames differ in names")
    worst, over = 0, 0.0
    for n in pa:
        d = np.abs(read_png(pa[n]).astype(int) - read_png(pb[n]).astype(int))
        worst, over = max(worst, int(d.max())), max(over, float((d > 1).mean()))
    dpsnr = abs(ma["psnr"] - mb["psnr"])
    ok = worst <= max_level and over <= frac_over_1 and dpsnr <= psnr_tol
    log(f"check {label}: {len(pa)} restored frames, max level diff {worst} (tol {max_level}), "
        f"largest share of pixels off by > 1 level {over:.4f} (tol {frac_over_1}); PSNR "
        f"{ma['psnr']:.4f} vs {mb['psnr']:.4f} dB, diff {dpsnr:.4f} (tol {psnr_tol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: outputs disagree")


def read_means(path):
    """The 'mean results for the whole data' section of a result file the
    CLI wrote (its own YAML writer: one '"key": value' line per metric)."""
    means, inside = {}, False
    with open(path) as f:
        for line in f:
            if not line.startswith(" "):
                inside = line.strip() == '"mean results for the whole data":'
            elif inside:
                key, value = line.strip().split(": ")
                means[json.loads(key)] = float(value.replace(".nan", "nan").replace(".inf", "inf"))
    return means


@functools.cache
def host_cpu() -> str:
    """The host's CPU model, written beside every host time: /proc/cpuinfo's
    ``model name``, else ``lscpu``'s, else the vendor, family and model
    numbers; with the machine type and the CPUs this process may use."""
    import platform

    def known(v):
        return v if v and v.lower() not in ("unknown", "-") else None

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            fields = {k.strip(): v.strip() for k, v in
                      (ln.split(":", 1) for ln in f if ":" in ln)}
    except OSError:
        pass
    model = known(fields.get("model name"))
    if model is None and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = known(next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                            if ln.startswith("Model name")), None))
    if model is None:
        model = (f"model name not reported; {fields.get('vendor_id', '?')} family "
                 f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}")
    return f"{model} ({platform.machine()}), {len(os.sched_getaffinity(0))} CPUs"


HOST_PLANE_PASSES = 3  # 5 (d): passes over the clip, the planes in turn within each


def host_plane(clip, dataset_cfg):
    """5 (d): every window of the CLI's clip through the loader with the
    native host plane and with the numpy plane (the dataset module's
    ``native`` swapped for :mod:`ebfi_tpu_torch.data.encodings`), in turns
    over HOST_PLANE_PASSES passes (native, numpy, native, ...): every
    pass's items bit for bit equal to the first native pass's, and each
    plane's host ms per blurry frame in each pass, the whole fetch and its
    stacks, blurs and timestamp normalisation."""
    import types

    from ebfi_tpu_torch import native
    from ebfi_tpu_torch.data import clip_dataset, encodings

    planes = {"native": native, "numpy": types.SimpleNamespace(
        events_to_stack=lambda *a: encodings.item_layout(encodings.events_to_stack(*a)),
        blurry_mean=encodings.blurry_mean,
        normalize_ts=encodings.normalize_event_ts)}
    native.load_library()  # the build is not a fetch
    passes, ms = [], {name: [] for name in planes}
    try:
        for _ in range(HOST_PLANE_PASSES):
            for name, plane in planes.items():
                spent = {"events_to_stack": 0.0, "blurry_mean": 0.0, "normalize_ts": 0.0}

                def timed(fn_name, fn, spent=spent):
                    def call(*a, **k):
                        t0 = time.perf_counter()
                        try:
                            return fn(*a, **k)
                        finally:
                            spent[fn_name] += 1e3 * (time.perf_counter() - t0)
                    return call

                clip_dataset.native = types.SimpleNamespace(
                    **{k: timed(k, getattr(plane, k)) for k in spent})
                ds = clip_dataset.NpzClipDataset(clip, dataset_cfg)
                t0 = time.perf_counter()
                items = [ds.get(i, seed=SEED + i) for i in range(len(ds))]
                wall = 1e3 * (time.perf_counter() - t0)
                n_blurry = sum(int(np.prod(it["blurry"].shape[:2])) for it in items)
                ms[name].append({"fetch": wall / n_blurry,
                                 **{k: v / n_blurry for k, v in spent.items()}})
                passes.append(items)
    finally:
        clip_dataset.native = native
    same = all(len(p) == len(passes[0]) and all(a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(np.ascontiguousarray(a[k]).view(np.uint8),
                           np.ascontiguousarray(b[k]).view(np.uint8)) for k in a)
        for a, b in zip(passes[0], p)) for p in passes[1:])
    ok = same and len(passes[0]) > 0
    log(f"check cli (d) host plane: {len(passes[0])} items ({n_blurry} blurry frames) of "
        f"the {CLIP_FRAMES}-frame {H}x{W} clip, {HOST_PLANE_PASSES} passes of each plane in "
        f"turns, every pass bit for bit equal to the first native one {'ok' if ok else 'FAIL'}")
    for name, runs in ms.items():
        log(f"cli (d) host plane {name}, ms per blurry frame in each pass: whole fetch "
            + ", ".join(f"{m['fetch']:.1f}" for m in runs) + "; event stacks "
            + ", ".join(f"{m['events_to_stack']:.1f}" for m in runs) + "; blur synthesis "
            + ", ".join(f"{m['blurry_mean']:.1f}" for m in runs) + "; timestamp normalisation "
            + ", ".join(f"{m['normalize_ts']:.1f}" for m in runs) + f"; host {host_cpu()}")
    if not ok:
        raise AssertionError("cli (d): the native host plane differs from the numpy plane")
    return ms


def phase_cli(torch, kern):
    from ebfi_tpu_torch.data.dataloader import EBFIDataLoader
    from ebfi_tpu_torch.data.synth import write_clip_npz
    from ebfi_tpu_torch.infer import InferenceEngine, cli
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.utils.checkpoint import save_checkpoint
    from ebfi_tpu_torch.utils.vis import read_png

    tmp = tempfile.mkdtemp(prefix="ebfi_chip_smoke_")
    try:
        # ---- (a) the serving run: 720p, bf16, the shipped model
        clip = os.path.join(tmp, "clip720.npz")
        t0 = time.perf_counter()
        n_events = write_clip_npz(clip, num_frames=CLIP_FRAMES, H=H, W=W, seed=SEED)
        log(f"cli (a): wrote a {CLIP_FRAMES}-frame {H}x{W} synthetic clip, {n_events} events, "
            f"in {time.perf_counter() - t0:.1f} s")
        model = init_weights(build_model(MODEL_CFG), SEED)
        ckpt = os.path.join(tmp, "model.pt")
        save_checkpoint(ckpt, model, {"model": MODEL_CFG})
        out = os.path.join(tmp, "out720")
        torch.cuda.reset_peak_memory_stats()
        summary, wall, counts, routes = run_cli(cli, kern, torch, ckpt, clip, out,
                                                ["--precision", "bf16"])
        stats = summary["timings"]
        frames = restored_pngs(out, clip)
        n_blurry = len(stats)
        means = summary["means"]
        log(f"cli (a): {n_blurry} blurry frames, {len(frames)} restored frames in {wall:.2f} s "
            f"wall, {len(frames) / wall:.2f} restored frames/s end to end; launches {counts}; "
            f"routes {routes}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; means {means}")
        log(f"  host: {host_cpu()}; the fetch runs the native host plane")
        for i, st in enumerate(stats):
            log(f"  blurry frame {i}: host fetch {st['fetch_ms']:.1f} ms, device "
                f"{st['device_ms']:.1f} ms, host waiting for the result {st['sync_ms']:.1f} ms, "
                f"emit {st['emit_ms']:.1f} ms (of which MSE/PSNR/SSIM {st['metrics_ms']:.1f} ms, "
                f"the rest PNG submits), CLI wall {st['wall_ms']:.1f} ms")
        log(f"  after the last frame: {1e3 * wall - sum(st['wall_ms'] for st in stats):.1f} ms "
            "(the PNG writes draining, the result files, and the set-up before the first "
            "fetch: checkpoint load, engine build)")
        ok = (n_blurry == 2 and len(frames) == N * n_blurry
              and counts == {"fac": 0, "mod_fac": 0, "mod_fac_shared": n_blurry}
              and routes["mod_fac_shared"] == {"wgmma_bf16": n_blurry, "wgmma_3xtf32": 0}
              and kern.modification_fac_fused_shared.launches_packed == 0
              and all(np.isfinite(v) for v in means.values())
              and read_means(os.path.join(out, "inference_all.yml")) == means)
        log(f"check cli (a): B2 once per blurry frame on wgmma_bf16 alone, no B1 or B3, "
            f"{N * n_blurry} restored frames, finite metrics in inference_all.yml "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("cli (a): the serving run did not go as expected")

        # the same window through the engine, called directly
        random.seed(123)
        np.random.seed(123)
        cfg = cli.apply_flag_overrides(cli.default_dataloader_config(), cli.get_flags(
            ["--output_path", out, *CLI_FLAGS]))
        (window,) = list(EBFIDataLoader(clip, cfg["dataset"]))
        engine = InferenceEngine(model, precision="bf16")
        worst, iF = 0, -1
        for l in range(window["blurry"].shape[1]):
            finals = engine.interpolate(
                window["blurry"][:, l, 0], window["events"][:, l],
                window["relative_ts"][:, l, 0], window["exposure"][:, l, 0], outputs="final",
            )[1].cpu().numpy()
            for i in range(finals.shape[0]):
                iF += 1
                want = (np.clip(finals[i, 0], 0, 1) * 255).astype(np.uint8)
                got = read_png(frames[f"{iF:09d}_{l}.png"])
                worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
        ok = worst <= 1 and iF + 1 == len(frames)
        log(f"check cli (a) against InferenceEngine.interpolate on the same loader output: "
            f"{iF + 1} frames, max level diff {worst} (tol 1) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("cli (a): the CLI's frames differ from the engine's")
        del engine, window
        shutil.rmtree(out)
        host_plane(clip, cfg["dataset"])
        os.remove(clip)
        torch.cuda.empty_cache()

        # ---- (c) FrameBasech 8 in bf16: the unfused path (C1), card against CPU
        small = os.path.join(tmp, "clip64x96.npz")
        write_clip_npz(small, num_frames=CLIP_FRAMES, H=64, W=96, seed=SEED + 1)
        ckpt8 = os.path.join(tmp, "model8.pt")
        save_checkpoint(ckpt8, init_weights(build_model(SMALL_CFG), SEED), {"model": SMALL_CFG})
        runs = {}
        for dev in ("cuda", "cpu"):
            o = os.path.join(tmp, f"out8_{dev}")
            summary, wall, counts, routes = run_cli(
                cli, kern, torch, ckpt8, small, o, ["--precision", "bf16", "--device", dev])
            runs[dev] = (restored_pngs(o, small), summary["means"])
            if dev == "cuda":
                ok = counts["fac"] > 0 and counts["mod_fac"] == counts["mod_fac_shared"] == 0
                log(f"check cli (c) FrameBasech 8 bf16 on the card: launches {counts} (B1 "
                    f"only: the fused kernels take C = 64) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("cli (c): a FrameBasech-8 model took a fused kernel")
        # bf16 rounds at other places on the card (cuDNN) and the CPU
        compare_outputs("cli (c) card vs CPU, bf16, 64x96", read_png, runs["cuda"], runs["cpu"],
                        255, 0.02, 0.1)

        # ---- (b) the real entry point in f32, on the card and on the CPU,
        # with an LPIPS column (phase 7 (d)) from a random AlexNet backbone file
        alexnet = write_alexnet(os.path.join(tmp, "alexnet.pth"))
        runs = {}
        for dev in ("cuda", "cpu"):
            o = os.path.join(tmp, f"outm_{dev}")
            datalist = o + ".txt"
            with open(datalist, "w") as f:
                f.write(small + "\n")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "ebfi_tpu_torch.infer", "--model_path", ckpt,
                 "--data_list", datalist, "--output_path", o, *CLI_FLAGS,
                 "--precision", "f32", "--alexnet_weights", alexnet,
                 *(["--device", "cpu"] if dev == "cpu" else [])],
                capture_output=True, text=True, timeout=300,
            )
            log(f"cli (b) python -m ebfi_tpu_torch.infer --precision f32 --alexnet_weights on "
                f"{dev}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
            if proc.returncode != 0:
                raise AssertionError(f"cli (b) on {dev} failed:\n{proc.stderr[-4000:]}")
            runs[dev] = (restored_pngs(o, small), read_means(os.path.join(o, "inference_all.yml")))
        compare_outputs("cli (b) card vs CPU, f32, 64x96, the shipped model", read_png,
                        runs["cuda"], runs["cpu"], 1, 1.0, 0.01)
        lp = {dev: runs[dev][1].get("lpips") for dev in runs}
        ok = None not in lp.values() and abs(lp["cuda"] - lp["cpu"]) <= LPIPS_TOL
        log(f"check 7 (d) cli (b) lpips column, card vs CPU: {lp['cuda']!r} vs {lp['cpu']!r} "
            f"(tol {LPIPS_TOL} absolute) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("cli (b): the LPIPS columns of the card and the CPU disagree")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------- training

TRAIN_ITERS = 20  # each run of (a) and (b); checkpoints and validation every 10
TRAIN_CLIP = (65, 144, 176)  # 4 periods of 16 frames; larger than the 128x128 crops
GRAD_TOL_REL = {"float32": 1e-5, "bfloat16": 1e-2}  # Function vs autograd through the plain version
STEADY_STEPS = 8
SMALL_TRAIN_CFG = {  # (d): widths 64 where Modification needs them, small elsewhere
    "name": "EVFIAutoEx",
    "args": {"FrameBasech": 64, "EventBasech": 64, "InterCH": 16, "TB": 4, "step": 2,
             "BlurryFashion": "RGBLap", "BLInch": 4, "channels": [8, 8, 8, 8]},
}


def train_config(tmp, name, clip, extra):
    """configs/train_evfi.yml with ';' overrides, written where the CLI
    reads it: the clip 8 times in the train list (one batch of 8 windows),
    twice in the valid list (one batch of 2)."""
    from ebfi_tpu_torch.train.config import ConfigParser
    from ebfi_tpu_torch.utils.logger import dump_yaml

    lists = {}
    for split, n in (("train", 8), ("valid", 2)):
        lists[split] = os.path.join(tmp, f"{split}.txt")
        with open(lists[split], "w") as f:
            f.write((clip + "\n") * n)
    ov = {
        "trainer;output_path": os.path.join(tmp, "out"),
        "trainer;iteration_based_train;iterations": TRAIN_ITERS,
        "trainer;iteration_based_train;save_period": 10,
        "trainer;iteration_based_train;valid_step": 10,
        "trainer;iteration_based_train;train_log_step": 5,
        "trainer;tensorboard": False,
        "train_dataloader;path_to_datalist_txt": lists["train"],
        "valid_dataloader;path_to_datalist_txt": lists["valid"],
        **extra,
    }
    cp = ConfigParser.from_yaml("configs/train_evfi.yml", overrides=ov, make_dirs=False)
    path = os.path.join(tmp, f"{name}.yml")
    with open(path, "w") as f:
        f.write(dump_yaml(cp.config))
    return path


def step_batches(trainer, n):
    """The first n training batches of the trainer's loader, on its device."""
    window = next(trainer._windows(trainer.train_loader))
    return list(trainer._batches_from_window(window))[:n]


def steady_step_ms(torch, trainer, steps=STEADY_STEPS, batches=None):
    """ms per training iteration of the trainer's own step on batches of
    its loader (``batches``, else fetched), one warm-up, host clock around
    synchronised steps."""
    batches = batches or step_batches(trainer, steps + 1)
    trainer.train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps, batches[-1]


def train_run(torch, kern, label, train_cli, argv):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = kern.launch_counts(), kern.route_counts()
    log(f"train {label}: {' '.join(argv)}: step {trainer.state.step} in {wall:.1f} s wall "
        f"(model build, loader, validation and checkpoints included); launches {counts}; "
        f"routes {routes}; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return trainer, counts, routes, wall


def eval_forwards(trainer, validations):
    """Forward calls of the validations: batches of the valid loader times
    L x NumP x NumI per window (L loads of NumP periods, NumI = NumP x
    NumFramePerPeriod timestamps)."""
    ds = trainer.cp["valid_dataloader"]["dataset"]
    num_p = ds["NumPeriodPerLoad"]
    loads = (ds["NumPeriodPerSeq"] - num_p) // ds["SlidingWindowLoad"] + 1
    return validations * len(trainer.valid_loader) * loads * num_p * num_p * ds["NumFramePerPeriod"]


def phase_train(torch, kern):
    from ebfi_tpu_torch.data.synth import write_clip_npz
    from ebfi_tpu_torch.infer import cli as infer_cli
    from ebfi_tpu_torch.train import cli as train_cli

    tmp = tempfile.mkdtemp(prefix="ebfi_chip_train_")
    out = {}
    try:
        clip = os.path.join(tmp, "clip.npz")
        frames, h, w = TRAIN_CLIP
        write_clip_npz(clip, num_frames=frames, H=h, W=w, seed=SEED + 3)
        # ---- (a) f32, the shipped config: unfused Modification, B1 forward
        cfg_a = train_config(tmp, "f32", clip, {})
        trainer, counts, routes, wall = train_run(torch, kern, "(a) f32", train_cli,
                                                  ["-c", cfg_a, "-id", "f32"])
        save_dir = trainer.cp.save_dir
        names = sorted(os.listdir(save_dir))
        n_eval = eval_forwards(trainer, TRAIN_ITERS // 10)
        losses = trainer.train_metrics
        ok = (trainer.state.step == TRAIN_ITERS
              and counts == {"fac": TRAIN_ITERS + n_eval, "mod_fac": 0, "mod_fac_shared": 0}
              and {"checkpoint-iteration10.pt", "checkpoint-iteration20.pt"} <= set(names)
              and np.isfinite(losses.avg("train_loss")) and losses._counts["train_loss"] == 4)
        log(f"check train (a): {TRAIN_ITERS} steps, B1 once per step and per validation forward "
            f"({TRAIN_ITERS} + {n_eval}), no B2/B3, mean logged loss "
            f"{losses.avg('train_loss'):.4e} finite; checkpoints {names} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train (a): the f32 run did not go as expected")
        out["a_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["train_launches"] = {"B1_fac": counts["fac"]}  # steps and validation forwards
        final = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}

        # resume from step 10: steps 11..20, one validation at 20
        resumed, counts_r, _, _ = train_run(
            torch, kern, "(a) resume", train_cli,
            ["-c", cfg_a, "-id", "f32_resumed", "-r", os.path.join(save_dir, "checkpoint-iteration10.pt")])
        n_eval_r = eval_forwards(resumed, 1)
        ok = resumed.state.step == TRAIN_ITERS and counts_r["fac"] == TRAIN_ITERS - 10 + n_eval_r
        log(f"check train (a) resume from checkpoint-iteration10.pt: ended at step "
            f"{resumed.state.step}, {counts_r['fac'] - n_eval_r} steps taken (10 expected) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train (a): the resumed run did not continue from step 10")
        del resumed

        # the first run's last checkpoint, served by the infer CLI's loader
        model, engine = infer_cli.load_model(os.path.join(save_dir, "checkpoint-iteration20.pt"),
                                             precision="f32", device="cuda")
        same = all(torch.equal(final[k], v) for k, v in model.state_dict().items())
        rng = np.random.default_rng(SEED + 4)
        req = make_request(torch, rng, 64, 96, 4)
        served = engine.interpolate(*req, outputs="final")[1]
        ok = same and tuple(served.shape) == (4, 1, 64, 96, 3) and bool(torch.isfinite(served).all())
        log(f"check train (a) checkpoint-iteration20.pt through infer.cli.load_model: weights "
            f"equal to the trainer's {same}, interpolate -> {tuple(served.shape)} finite "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train (a): the checkpoint does not serve")
        del model, engine, served

        ms, batch = steady_step_ms(torch, trainer)
        out["a_ms"], out["a_wall"] = ms, wall
        log(f"train (a) f32 steady: {ms:.2f} ms/iteration, {8 * 1e3 / ms:.1f} samples/s "
            f"(batch 8, 128x128); peak {out['a_peak_gib']:.2f} GiB; {card_identity()}")
        breakdown(torch, "train (a) f32, one step", lambda: trainer.train_step(trainer.state, batch),
                  ranges=("ebfi::fac_backward_plain",))
        del trainer, batch
        torch.cuda.empty_cache()

        # ---- (b) bf16 with FastVariants: B3 on the tensor cores
        cfg_b = train_config(tmp, "bf16", clip, {
            "model;args;FastVariants": True, "trainer;precision": "bf16",
            # the eval step runs in f32, as the JAX package's, which would take B3's f32 route
            "trainer;do_validation": False,
        })
        trainer, counts, routes, wall = train_run(torch, kern, "(b) bf16 FastVariants", train_cli,
                                                  ["-c", cfg_b, "-id", "bf16"])
        out["b_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        losses = trainer.train_metrics
        ok = (trainer.state.step == TRAIN_ITERS
              and counts == {"fac": 0, "mod_fac": TRAIN_ITERS, "mod_fac_shared": 0}
              and routes["mod_fac"] == {"wgmma_bf16": TRAIN_ITERS, "wgmma_3xtf32": 0}
              and np.isfinite(losses.avg("train_loss")))
        log(f"check train (b): B3 once per step, all on wgmma_bf16, none on wgmma_3xtf32, no B1; "
            f"mean logged loss {losses.avg('train_loss'):.4e} finite {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train (b): the bf16 run did not go as expected")
        ms, batch = steady_step_ms(torch, trainer)
        out["b_ms"], out["b_wall"] = ms, wall
        log(f"train (b) bf16 steady: {ms:.2f} ms/iteration, {8 * 1e3 / ms:.1f} samples/s "
            f"(batch 8, 128x128); peak {out['b_peak_gib']:.2f} GiB; {card_identity()}")
        breakdown(torch, "train (b) bf16, one step", lambda: trainer.train_step(trainer.state, batch),
                  ranges=("ebfi::mod_fac_backward_plain",))
        out["train_launches"]["B3_mod_fac"] = counts["mod_fac"]
        del trainer, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bwd = phase_grad_checks(torch, kern)
    phase_train_card_vs_cpu(torch)
    log(f"train summary on {card_identity()}: (a) f32 {out['a_ms']:.2f} ms/iteration, "
        f"{8e3 / out['a_ms']:.1f} samples/s, peak {out['a_peak_gib']:.2f} GiB, run wall "
        f"{out['a_wall']:.1f} s; (b) bf16 {out['b_ms']:.2f} ms/iteration, "
        f"{8e3 / out['b_ms']:.1f} samples/s, peak {out['b_peak_gib']:.2f} GiB, run wall "
        f"{out['b_wall']:.1f} s; plain backward ms at the training shapes "
        f"{ {k: round(v, 3) for k, v in bwd.items()} }")
    return out


def grad_check(torch, label, fn, plain, args, diff_idx):
    """The wrapper on the card against its plain version on the same
    inputs: the forward against the plain version evaluated in f32 (as
    phase 3, TOL_REL), and the gradients of sum(out * r), r fixed, against
    autograd through the plain version in the working dtype (the
    Function's backward recomputes through the same ops, so only cuDNN's
    nondeterministic sums separate them: GRAD_TOL_REL, relative to each
    reference's max).  Raises beyond either.  Returns the backward's ms
    (CUDA events, one call after a warm-up)."""
    dname = str(args[0].dtype).split(".")[1]
    leaves = [a.detach().requires_grad_(i in diff_idx) if torch.is_tensor(a) else a
              for i, a in enumerate(args)]
    got = fn(*leaves)
    if got.grad_fn is None:
        raise AssertionError(f"grad {label}: the output has no grad_fn")
    with torch.no_grad():
        ref32 = plain(*[a.float() if torch.is_tensor(a) else a for a in leaves])
    fwd_err = (got.float() - ref32).abs().max().item()
    fwd_tol = TOL_REL[dname] * ref32.abs().max().item()
    r = torch.randn(got.shape, device=got.device,
                    generator=torch.Generator(got.device).manual_seed(SEED)).to(got.dtype)
    wanted = [leaves[i] for i in diff_idx]
    g_got = torch.autograd.grad(got, wanted, r, retain_graph=True)
    g_ref = torch.autograd.grad(plain(*leaves), wanted, r)
    errs = [(a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
            for a, b in zip(g_got, g_ref)]
    ok = fwd_err <= fwd_tol and all(e <= GRAD_TOL_REL[dname] for e in errs)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.autograd.grad(got, wanted, r, retain_graph=True)  # warm-up
    torch.cuda.synchronize()
    start.record()
    torch.autograd.grad(got, wanted, r)
    end.record()
    torch.cuda.synchronize()
    bwd_ms = start.elapsed_time(end)
    log(f"grad {label}: forward max_abs_err {fwd_err:.3e} (tol {fwd_tol:.3e}); gradients rel err "
        f"{', '.join(f'{e:.2e}' for e in errs)} (tol {GRAD_TOL_REL[dname]:.0e}); backward "
        f"(plain recompute) {bwd_ms:.3f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grad {label}: the Function disagrees with its plain version")
    return bwd_ms


def phase_grad_checks(torch, kern):
    """Gradients through B1, B3, B2 and B2p at the training shapes (batch
    8, 64x64 features, C = 64, K = 5)."""
    from ebfi_tpu_torch.models import Modification

    rng = np.random.default_rng(SEED + 5)
    Bt, ht, wt = 8, 64, 64

    def t(shape, dt, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to("cuda", dt)

    res = {}
    f32, bf16 = torch.float32, torch.bfloat16
    res["B1_f32_bwd_ms"] = grad_check(
        torch, f"B1 f32 B={Bt} {ht}x{wt}x{C} K={K}", kern.kernel_conv2d_cuda, kern.fac_plain,
        [t((Bt, ht, wt, C), f32), t((Bt, ht, wt, K * K * C), f32), K], (0, 1))
    for dt in (bf16, f32):
        dn = str(dt)[6:]
        res[f"B3_{dn}_bwd_ms"] = grad_check(
            torch, f"B3 {dn} B={Bt} {ht}x{wt}x{C} K={K}", kern.modification_fac_fused,
            kern.mod_fac_plain,
            [t((Bt, ht, wt, C), dt), t((Bt, ht, wt, C), dt), t((3, 3, 2 * C, K * K * C), dt, 0.05),
             t((K * K * C,), f32, 0.1), K], (0, 1, 2, 3))
    for packed in (False, True):
        name = "B2p" if packed else "B2"
        res[f"{name}_bf16_bwd_ms"] = grad_check(
            torch, f"{name} bf16 B=2 N=4 {ht}x{wt}x{C} K={K}",
            functools.partial(kern.modification_fac_fused_shared, packed_rows2=packed),
            functools.partial(kern.mod_fac_shared_plain, packed_rows2=packed),
            [t((Bt, ht, wt, C), bf16), t((2, ht, wt, C), bf16),
             t((3, 3, 2 * C, K * K * C), bf16, 0.05), t((K * K * C,), f32, 0.1), K], (0, 1, 2, 3))

    # a Modification module in f32 on its fused path (B3), against the same
    # computation with the plain version's graph carrying B3's values
    # (plain + (B3 - plain).detach()): the bank weight enters as the
    # permuted view of kernel_conv.conv.weight, whose gradient must arrive.
    # With equal forward values, the leaky ReLUs downstream take the same
    # slopes in both, so only cuDNN's sums separate the backwards
    torch.manual_seed(SEED)
    m = Modification(C, C, K, fused=True).cuda()
    ff, ev, r = t((Bt, ht, wt, C), f32), t((Bt, ht, wt, C), f32), t((Bt, ht, wt, C), f32)

    def plain_module(ff, ev):  # Modification.forward's fused full mode
        x, (wk, bk) = m.conv1(ev), m._bank_weights()
        e1 = kern.mod_fac_plain(x, ff, wk, bk, K)
        with torch.no_grad():
            e1_kernel = kern.modification_fac_fused(x, ff, wk, bk, K)
        e1 = m.conv3(e1 + (e1_kernel - e1).detach())
        return ff * e1 + m.conv2(e1)

    kern.reset_launch_counts()
    grads = []
    for fn in (m, plain_module):
        x = [ff.clone().requires_grad_(), ev.clone().requires_grad_()]
        m.zero_grad(set_to_none=True)
        (fn(*x) * r).sum().backward()
        grads.append([g.grad for g in x] + [p.grad for p in m.parameters()])
    counts = kern.launch_counts()
    errs = [((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(*grads)]
    ok = counts["mod_fac"] == 2 and grads[0][2] is not None and max(errs) <= 1e-5
    log(f"grad Modification f32 B={Bt} {ht}x{wt}, fused path (B3; launches {counts}, one per "
        f"side) against the plain version's graph on B3's values: the inputs' and the "
        f"{len(errs) - 2} parameters' gradients, largest relative L2 error {max(errs):.2e} "
        f"(tol 1e-5), kernel_conv.conv.weight's {errs[2]:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("grad Modification: the fused path's gradients disagree")
    return res


def phase_train_card_vs_cpu(torch):
    """(d) One train step of a small model in f32, on the card and on the
    CPU, from the same weights and batch."""
    import copy

    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.train import TrainState, build_optimizer, make_train_step

    lr = 1e-4
    rng = np.random.default_rng(SEED + 6)
    Bs, hs, ws, tb = 2, 32, 32, SMALL_TRAIN_CFG["args"]["TB"]
    batch = {
        "frame": rng.uniform(0, 1, (Bs, hs, ws, 3)), "event": rng.uniform(0, 2, (Bs, hs, ws, 2 * tb)),
        "t": rng.uniform(0, 1, (Bs, 1)), "target": rng.uniform(0, 1, (Bs, hs, ws, 3)),
    }
    base = init_weights(build_model(SMALL_TRAIN_CFG), SEED)
    res = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": lr}})
        grads = {}
        for n, p in model.named_parameters():
            p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().cpu()))
        step = make_train_step()
        b = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in batch.items()}
        _, metrics = step(TrainState(model, updater), b)
        res[dev] = (float(metrics["train_loss"]), grads,
                    {n: p.detach().cpu() for n, p in model.named_parameters()})
    (lg, gg, pg), (lc, gc, pc) = res["cuda"], res["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    g_err = max((gg[n] - gc[n]).abs().max().item() / max(gc[n].abs().max().item(), 1e-30)
                for n in gc)
    p_err = max((pg[n] - pc[n]).abs().max().item() for n in pc)
    ok = loss_rel <= 1e-4 and g_err <= 1e-3 and p_err <= 2 * lr * 1.001
    log(f"check train (d) one Adam step, card vs CPU, f32, {SMALL_TRAIN_CFG['args']} at "
        f"B={Bs} {hs}x{ws}: loss {lg:.6e} vs {lc:.6e} (rel {loss_rel:.1e}, tol 1e-4); gradients "
        f"max rel err {g_err:.1e} (tol 1e-3, relative to each tensor's max); parameters max abs "
        f"diff {p_err:.2e} (tol 2*lr = {2 * lr:.0e}: Adam's first update is lr*g/(|g|+eps), so "
        f"only a gradient whose sign differs can move a parameter apart) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train (d): the card and the CPU train step disagree")


# ---------------------------------------------------------------- data parallelism

LPIPS_TOL = 1e-4  # card vs CPU, f32 convolutions summed in another order
DP_TIMEOUT_S = 300  # each launch of ranks
DP_STEPS = 2  # (b): Adam updates on the concatenated batches
DP_BATCH, DP_HW = 4, 64  # (b): global batch of the step check, crops
DP_LR = 1e-4


def _range_text(r):
    span = "no span" if r["span_ms"] is None else f"span {r['span_ms']:.3f} ms"
    return f"{span}, device busy {r['busy_ms']:.3f} ms"


def write_alexnet(path, seed=SEED):
    """A random AlexNet ``features`` state dict in torchvision's layout, as
    ``--alexnet_weights`` reads it (no backbone ships with the repository)."""
    import torch

    from ebfi_tpu_torch.losses.lpips import ALEX_CONVS, ALEX_LAYER_IDS

    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for lid, (cout, k, _, _) in zip(ALEX_LAYER_IDS, ALEX_CONVS):
        std = (2.0 / (k * k * cin)) ** 0.5
        sd[f"features.{lid}.weight"] = torch.randn(cout, cin, k, k, generator=g) * std
        sd[f"features.{lid}.bias"] = torch.zeros(cout)
        cin = cout
    torch.save(sd, path)
    return path


def launch_ranks(label, nproc, args, timeout=DP_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone --nproc_per_node=nproc
    args`` from the repository root, its output passed through; the
    launcher and its ranks are killed at the timeout.  Raises unless it
    exits 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    log(f"{label}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        raise AssertionError(f"{label}: the ranks did not finish within {timeout} s")
    log(f"{label}: exit {rc} in {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"{label}: exit {rc}")


def dp_worker(spec_path: str) -> int:
    """One rank of a phase-7 launch (``chip_smoke.py --dp-worker SPEC``,
    started by ``torch.distributed.run``): joins the group on the card the
    spec names (``cuda:LOCAL_RANK`` without one), then (1) with
    ``step_check``, takes DP_STEPS Adam steps of the shipped model on its
    share of seeded global batches, through ``make_train_step``, and saves
    its parameters and losses; (2) runs ``ebfi_tpu_torch.train.cli.main``
    on each config of the spec, with launch counts zeroed before each run,
    then times its steady step and profiles one.  Writes its results to
    the spec's ``out`` (``%d`` = rank); (3) with ``spatial_check`` (phase
    11 (b)), takes SP_STEPS Adam steps of the shipped model through the
    spatial step on its band of the whole batches."""
    import logging

    import torch

    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.ops import cuda as kern
    from ebfi_tpu_torch.parallel import (broadcast_module_, local_device, local_shard_info,
                                         maybe_init_distributed)
    from ebfi_tpu_torch.train import (TrainState, build_adversarial, build_optimizer,
                                      init_adv_state, make_train_step)
    from ebfi_tpu_torch.train import cli as train_cli

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = local_device(spec.get("device", "cuda"))
    maybe_init_distributed(backend=spec.get("backend"), device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rank, world = local_shard_info()
    global LOG_PREFIX
    LOG_PREFIX = f"[rank {rank}/{world}] "
    res = {"rank": rank, "world": world}

    if spec.get("step_check"):
        batches = dict(np.load(spec["step_check"]["batches"]))
        for label, cfg, bf16, loss_cfg in spec["step_check"]["cases"]:
            model = init_weights(build_model(cfg), SEED, scheme="train").to(device)
            broadcast_module_(model)
            updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": DP_LR}},
                                         data_parallel=True)
            step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None, world=world,
                                   loss_cfg=loss_cfg)
            state, losses = TrainState(model, updater), []
            if loss_cfg:
                state.adv_state = adv_state(build_adversarial(loss_cfg, world), device,
                                            batches["frame_0"].shape[1:3])
                broadcast_module_(state.adv_state.disc)
            kern.reset_launch_counts()
            for i in range(DP_STEPS):
                n = DP_BATCH // world
                b = {k: torch.from_numpy(batches[f"{k}_{i}"][rank * n:(rank + 1) * n]).to(device)
                     for k in ("frame", "event", "t", "target")}
                state, m = step(state, b)
                losses.append(float(m["train_loss"]))
            res[label] = {"losses": losses, "launches": kern.launch_counts(),
                          "routes": kern.route_counts()}
            torch.save(trained_params(state), spec["out"] % rank + f".{label}.pt")
            del model, state, updater

    if spec.get("spatial_check"):
        res.update(spatial_worker(torch, kern, spec, device, sync))

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    for label, argv, steady in spec.get("runs", []):
        argv = [a % rank if "%d" in a else a for a in argv]  # one output path per rank
        lines = Lines()
        logging.getLogger("trainer").addHandler(lines)
        sync()
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
        logging.getLogger("trainer").removeHandler(lines)
        r = {"step": trainer.state.step, "wall": wall, "launches": kern.launch_counts(),
             "routes": kern.route_counts(), "save_dir": trainer.cp.save_dir,
             "valid": [ln.split(":")[-1].strip() for ln in lines.lines if "valid_loss" in ln],
             "train": [ln.split("train_loss: ")[1].split()[0] for ln in lines.lines
                       if "train_loss: " in ln],
             "batch": int(trainer.cp["train_dataloader"]["batch_size"]),
             "n_eval": eval_forwards(trainer, TRAIN_ITERS // 10) if trainer.do_validation else 0}
        if steady:
            # the all-reduce's share of the step, in turns within this
            # process (with, without, without, with): the host's speed
            # drifts between processes and calls
            updater, turns = trainer.state.updater, {True: [], False: []}
            batches = step_batches(trainer, STEADY_STEPS + 1)
            for on in (True, False, False, True):
                updater.data_parallel = on
                ms, batch = steady_step_ms(torch, trainer, batches=batches)
                turns[on].append(ms)
            r["ms"], r["ms_without_allreduce"] = (float(np.mean(turns[on])) for on in (True, False))
            r["ranges"] = breakdown(torch, f"{label}, one step", lambda: trainer.train_step(
                trainer.state, batch), ranges=tuple(spec.get("ranges", ("ebfi::grad_allreduce",))))
        res[label] = r
        del trainer
    with open(spec["out"] % rank, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def step_check_batches(path):
    rng = np.random.default_rng(SEED + 7)
    arrays = {}
    for i in range(DP_STEPS):
        b = {"frame": rng.uniform(0, 1, (DP_BATCH, DP_HW, DP_HW, 3)),
             "event": rng.uniform(0, 2, (DP_BATCH, DP_HW, DP_HW, 2 * MODEL_CFG["args"]["TB"])),
             "t": rng.uniform(0, 1, (DP_BATCH, 1)),
             "target": rng.uniform(0, 1, (DP_BATCH, DP_HW, DP_HW, 3))}
        arrays.update({f"{k}_{i}": v.astype(np.float32) for k, v in b.items()})
    np.savez(path, **arrays)
    return arrays


def dp_spec(tmp, name, **spec):
    path = os.path.join(tmp, f"{name}.json")
    spec["out"] = os.path.join(tmp, f"{name}.rank%d.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def rank_file(spec_path, rank):
    with open(spec_path) as f:
        return json.load(f)["out"] % rank


def read_ranks(spec_path, nproc):
    results = []
    for r in range(nproc):
        with open(rank_file(spec_path, r)) as f:
            results.append(json.load(f))
    return results


def adv_state(adv, device, hw):
    """A discriminator's state for (H, W) inputs on ``device``, from the
    CLI's seed (``seed + 1`` of the shipped config's 123)."""
    import torch

    from ebfi_tpu_torch.train import init_adv_state

    sample = torch.zeros((1, *hw, 3), device=device)
    return init_adv_state(adv, ADV_SEED, {"target": sample, "frame": sample})


def trained_params(state):
    """The model's parameters and, with the adversarial term, the
    discriminator's (``disc.`` names), on the CPU."""
    out = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    if state.adv_state is not None:
        out.update({"disc." + k: v.detach().cpu()
                    for k, v in state.adv_state.disc.state_dict().items()})
    return out


def check_ranks_as_one_process(torch, phase, spec, rb, batches, label, cfg, bf16, loss_cfg):
    """The ranks' parameters after DP_STEPS Adam steps on their shares of
    the batches, against one process on the whole batches: bitwise equal
    across the ranks, within 2 * lr per step of the process (the
    discriminator's Adamax updates too: lr 1e-3, so 2e-3 per step), the
    mean of the ranks' losses within 1e-4 relative (1e-2 in bf16), and the
    kernel launched on every step.  Raises otherwise."""
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.train import TrainState, build_adversarial, build_optimizer, make_train_step

    got = [torch.load(rank_file(spec, r) + f".{label}.pt", weights_only=True) for r in range(2)]
    same = all(torch.equal(got[0][k], got[1][k]) for k in got[0])
    model = init_weights(build_model(cfg), SEED, scheme="train").cuda()
    updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": DP_LR}})
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None, loss_cfg=loss_cfg)
    state, losses = TrainState(model, updater), []
    if loss_cfg:
        state.adv_state = adv_state(build_adversarial(loss_cfg), "cuda",
                                    batches["frame_0"].shape[1:3])
    for i in range(DP_STEPS):
        b = {k: torch.from_numpy(batches[f"{k}_{i}"]).cuda()
             for k in ("frame", "event", "t", "target")}
        state, m = step(state, b)
        losses.append(float(m["train_loss"]))
    want = trained_params(state)
    bound = {k: 2 * (1e-3 if k.startswith("disc.") else DP_LR) * DP_STEPS * 1.001 for k in want}
    p_err = {k: (got[0][k] - want[k]).abs().max().item() for k in want}
    worst = max(p_err, key=lambda k: p_err[k] / bound[k])
    rank_mean = np.mean([r[label]["losses"] for r in rb], axis=0)
    loss_rel = float(np.max(np.abs(rank_mean - losses) / np.abs(losses)))
    loss_tol = 1e-2 if bf16 else 1e-4
    kernel = "mod_fac" if bf16 else "fac"
    launched = all(r[label]["launches"][kernel] == DP_STEPS for r in rb)
    ok = (same and set(got[0]) == set(want) and p_err[worst] <= bound[worst]
          and loss_rel <= loss_tol and launched)
    log(f"check {phase} {label}: {DP_STEPS} Adam steps of the shipped model"
        f"{' with ' + str(loss_cfg) if loss_cfg else ''} on 2 gloo ranks ({DP_BATCH // 2} of "
        f"{DP_BATCH} {DP_HW}x{DP_HW} samples each, {kernel} launches per rank "
        f"{[r[label]['launches'][kernel] for r in rb]}) against one process on the whole "
        f"batches: ranks bitwise equal {same} ({len(want)} tensors); parameters max abs diff "
        f"{max(v for k, v in p_err.items() if not k.startswith('disc.')):.2e} (tol 2*lr*steps = "
        f"{2 * DP_LR * DP_STEPS:.0e})"
        + (f", discriminator {max(v for k, v in p_err.items() if k.startswith('disc.')):.2e} "
           f"(tol {2e-3 * DP_STEPS:.0e})" if loss_cfg else "")
        + f"; mean of the ranks' losses vs the process's: max rel {loss_rel:.1e} (tol "
        f"{loss_tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase} {label}: the ranks do not step as one process")


def phase_data_parallel(torch, kern, single):
    """Phase 7: training under ``torch.distributed`` and LPIPS on the card.
    ``single``: phase 6's numbers from this call."""
    from ebfi_tpu_torch.data.synth import write_clip_npz
    from ebfi_tpu_torch.losses import LPIPS, load_lpips_params
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.train import TrainState, build_optimizer, make_train_step

    tmp = tempfile.mkdtemp(prefix="ebfi_chip_dp_")
    out = {}
    try:
        clip = os.path.join(tmp, "clip.npz")
        frames, h, w = TRAIN_CLIP
        write_clip_npz(clip, num_frames=frames, H=h, W=w, seed=SEED + 3)
        worker = ["chip_smoke.py", "--dp-worker"]
        fast = {"model;args;FastVariants": True, "trainer;precision": "bf16",
                "trainer;do_validation": False}

        # ---- (a) NCCL, one rank: phase 6's two runs through the launcher
        cfg_a = train_config(tmp, "dp_f32", clip, {})
        cfg_b = train_config(tmp, "dp_bf16", clip, fast)
        spec = dp_spec(tmp, "a", runs=[
            ["f32", ["-c", cfg_a, "-id", "nccl_f32"], True],
            ["bf16", ["-c", cfg_b, "-id", "nccl_bf16"], True]])
        launch_ranks("train 7 (a) NCCL, 1 rank", 1, [*worker, spec])
        (ra,) = read_ranks(spec, 1)
        n_eval = ra["f32"]["n_eval"]  # B1 also runs in validation's forwards
        for label, want, route in (("f32", {"fac": TRAIN_ITERS + n_eval, "mod_fac": 0,
                                            "mod_fac_shared": 0}, None),
                                   ("bf16", {"fac": 0, "mod_fac": TRAIN_ITERS,
                                             "mod_fac_shared": 0}, "wgmma_bf16")):
            r = ra[label]
            ar = r["ranges"].get("ebfi::grad_allreduce")
            ok = (ra["world"] == 1 and r["step"] == TRAIN_ITERS and r["launches"] == want
                  and ar is not None
                  and (route is None or r["routes"]["mod_fac"] == {route: TRAIN_ITERS,
                                                                   "wgmma_3xtf32": 0}))
            ms1 = single[f"{'a' if label == 'f32' else 'b'}_ms"]
            log(f"check train 7 (a) {label} NCCL world 1: {r['step']} steps, launches "
                f"{r['launches']}, routes {r['routes']}; steady {r['ms']:.2f} ms/iteration, "
                f"{8e3 / r['ms']:.1f} samples/s; in turns in the same process without the "
                f"all-reduce {r['ms_without_allreduce']:.2f} ms/iteration (phase 6, one process, "
                f"no group: {ms1:.2f} ms/iteration, {8e3 / ms1:.1f} samples/s); "
                f"ebfi::grad_allreduce per update "
                f"(5 693 543 f32 gradients, 22.8 MB): "
                f"{'not recorded' if ar is None else _range_text(ar)}; {card_identity()} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train 7 (a) {label}: the NCCL run did not go as expected")
            out[f"a_{label}"] = {"ms": r["ms"], "ms_without": r["ms_without_allreduce"],
                                 "allreduce_ms": ar, "launches": r["launches"]}

        # ---- (b) two gloo ranks on the one card
        batches = step_check_batches(os.path.join(tmp, "batches.npz"))
        cases = [["f32", MODEL_CFG, False, None],
                 ["bf16", {**MODEL_CFG, "args": {**MODEL_CFG["args"], "FastVariants": True}},
                  True, None]]
        cfg_c = {}
        for rank in range(2):  # the same config but for its output path
            cfg_c[rank] = train_config(tmp, f"dp_gloo{rank}", clip, {
                "trainer;output_path": os.path.join(tmp, f"gloo_out{rank}"),
                "trainer;iteration_based_train;iterations": 4,
                "trainer;iteration_based_train;save_period": 2,
                "trainer;iteration_based_train;valid_step": 2,
                "trainer;iteration_based_train;train_log_step": 1})
        spec = dp_spec(tmp, "b", backend="gloo", device="cuda:0",
                       step_check={"batches": os.path.join(tmp, "batches.npz"), "cases": cases},
                       runs=[["cli", ["-c", os.path.join(tmp, "dp_gloo%d.yml"), "-id", "gloo",
                                      "--device", "cuda:0"], False]])
        launch_ranks("train 7 (b) gloo, 2 ranks on one card", 2, [*worker, spec])
        rb = read_ranks(spec, 2)
        for label, cfg, bf16, loss_cfg in cases:
            check_ranks_as_one_process(torch, "train 7 (b)", spec, rb, batches, label, cfg, bf16,
                                       loss_cfg)
        runs = [r["cli"] for r in rb]
        written = [sorted(os.listdir(r["save_dir"])) for r in runs]
        ok = (runs[0]["step"] == runs[1]["step"] == 4 and written[1] == []
              and {"checkpoint-iteration2.pt", "checkpoint-iteration4.pt"} <= set(written[0])
              and len(runs[0]["valid"]) == 2 and runs[0]["valid"] == runs[1]["valid"]
              and runs[0]["train"] == runs[1]["train"] and runs[0]["batch"] == 8)
        log(f"check train 7 (b) train CLI on 2 gloo ranks: steps {[r['step'] for r in runs]}, "
            f"rank 0 wrote {written[0]}, rank 1 wrote {written[1]}; valid_loss logged "
            f"{runs[0]['valid']} / {runs[1]['valid']}; train_loss logged equal "
            f"{runs[0]['train'] == runs[1]['train']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train 7 (b): the 2-rank CLI run did not go as expected")

        # ---- (c) NCCL over every card
        cards = torch.cuda.device_count()
        if cards > 1:
            many = os.path.join(tmp, "train_all.txt")  # one batch of 8 windows per card
            with open(many, "w") as f:
                f.write((clip + "\n") * 8 * cards)
            cfg_n = train_config(tmp, "dp_all", clip, {"train_dataloader;batch_size": 8 * cards,
                                                       "train_dataloader;path_to_datalist_txt": many})
            spec = dp_spec(tmp, "c", runs=[["f32", ["-c", cfg_n, "-id", "nccl_all"], True]])
            launch_ranks(f"train 7 (c) NCCL, {cards} ranks", cards, [*worker, spec])
            rc = read_ranks(spec, cards)
            ms = max(r["f32"]["ms"] for r in rc)
            log(f"train 7 (c) f32 on {cards} cards, 8 samples per card: {ms:.2f} ms/iteration, "
                f"{8 * cards * 1e3 / ms:.1f} samples/s summed over the cards (one card, phase 6: "
                f"{8e3 / single['a_ms']:.1f}); {card_identity()}")
        else:
            log("train 7 (c) NCCL over every card: not run, this machine has 1 card "
                "(torch.cuda.device_count() == 1)")

        # ---- (d) LPIPS: 720p on the card, and the perceptual term in training
        lp = LPIPS(load_lpips_params(backbone_path=write_alexnet(os.path.join(tmp, "a.pth"))))
        lp = lp.cuda()
        rng = np.random.default_rng(SEED + 8)
        pair = [torch.from_numpy(rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)).cuda()
                for _ in range(2)]
        with torch.no_grad():
            ms = cuda_ms(lambda: lp(*pair), reps=5)
        out["lpips_ms"] = ms
        log(f"LPIPS f32 on the card, one 720x1280 frame pair: {ms:.3f} ms (CUDA events, mean "
            f"of 5 after a warm-up); {card_identity()}")
        cfg_p = train_config(tmp, "perceptual", clip, {
            **fast, "trainer;iteration_based_train;iterations": 3,
            "trainer;iteration_based_train;save_period": 3,
            "trainer;iteration_based_train;train_log_step": 1,
            "trainer;loss;perceptual;enabled": True,
            "trainer;loss;perceptual;alexnet_weights": os.path.join(tmp, "a.pth")})
        launch_ranks("train 7 (d) bf16 FastVariants with trainer.loss.perceptual, "
                     "NCCL 1 rank", 1, ["-m", "ebfi_tpu_torch.train", "-c", cfg_p, "-id", "lp"])
        ckpt = os.path.join(tmp, "out", "models", "EVFIAutoEx", "lp", "checkpoint-iteration3.pt")
        ok = os.path.exists(ckpt)
        log(f"check train 7 (d) perceptual: 3 steps, {os.path.basename(ckpt)} written {ok} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train 7 (d): the perceptual run wrote no checkpoint")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"data-parallel summary on {card_identity()}: (a) NCCL 1 rank f32 "
        f"{out['a_f32']['ms']:.2f} ms/iteration ({out['a_f32']['ms_without']:.2f} without the "
        f"all-reduce, in turns), bf16 {out['a_bf16']['ms']:.2f} "
        f"({out['a_bf16']['ms_without']:.2f}) (phase 6: {single['a_ms']:.2f}, "
        f"{single['b_ms']:.2f}); grad all-reduce per update "
        f"f32 {_range_text(out['a_f32']['allreduce_ms'])}, bf16 "
        f"{_range_text(out['a_bf16']['allreduce_ms'])}; LPIPS {out['lpips_ms']:.3f} ms per "
        "720p pair")
    return {"B1_fac": out["a_f32"]["launches"]["fac"],
            "B3_mod_fac": out["a_bf16"]["launches"]["mod_fac"]}


# ---------------------------------------------------------------------- adversarial

ADV_LOSS = {"enabled": True, "gan_type": "STGAN", "weight": 0.01}
ADV_SEED = 124  # the train CLI's for the discriminator: the shipped config's seed 123, plus 1
ADV_RANGES = ("ebfi::adversarial", "ebfi::disc_grad_allreduce", "ebfi::grad_allreduce")
ADV_HW = 128  # the shipped crops
ADV_TOL = {"d_loss": 1e-4, "g_loss": 1e-3}  # g_loss after an Adamax update (see card_vs_cpu)
ENC_EVENTS, ENC_TB = 200_000, 16
ADV_OVERRIDES = {f"trainer;loss;adversarial;{k}": v for k, v in ADV_LOSS.items()}


def disc_moved(torch, disc, hw):
    """How many of the discriminator's tensors differ from its initial
    weights (the CLI's seed), and how many it has."""
    from ebfi_tpu_torch.losses.discriminator import build_discriminator, init_discriminator

    init = init_discriminator(build_discriminator(ADV_LOSS["gan_type"], hw),
                              torch.Generator().manual_seed(ADV_SEED)).state_dict()
    return sum(not torch.equal(v.cpu(), init[k]) for k, v in disc.state_dict().items()), len(init)


def _rel_close(label, got, want, rtol, atol=0.0):
    ok = abs(got - want) <= rtol * abs(want) + atol
    return ok, f"{label} {got:.6e} vs {want:.6e} (tol {rtol:.0e} rel{f' + {atol:.0e}' if atol else ''})"


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300)).item()


def adv_card_vs_cpu(torch):
    """(b) One train step with the STGAN term, f32, batch 8 at 128x128, on
    the card and on the CPU from the same weights and batch (the generator
    a small model whose Modification has the shipped widths, the
    discriminator at full size); then a WGAN_GP discriminator step with the
    same penalty weights on both: its double backward runs through cuDNN.
    The discriminator's first loss comes from equal weights (1e-4
    relative); its Adamax (WGAN_GP: Adam) updates are about lr * sign(g),
    so where a gradient is ~0 its sign may differ: parameters within
    2 * lr, at most 2 % of them further than 1e-6 apart; g_loss, of the
    updated discriminator, 1e-3 relative; the generator's gradients, which
    pass back through that discriminator, relative L2 1e-3 over all
    tensors and 1e-2 in the worst one (on an H100, 2.8e-3 of a
    tensor's largest gradient where 7.9e-5 of the discriminator's
    parameters had flipped)."""
    import copy

    from ebfi_tpu_torch.losses import AdversarialLoss
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.train import TrainState, build_adversarial, build_optimizer, make_train_step

    rng = np.random.default_rng(SEED + 9)
    Bs, hw, tb = 8, ADV_HW, SMALL_TRAIN_CFG["args"]["TB"]
    batch = {
        "frame": rng.uniform(0, 1, (Bs, hw, hw, 3)), "event": rng.uniform(0, 2, (Bs, hw, hw, 2 * tb)),
        "t": rng.uniform(0, 1, (Bs, 1)), "target": rng.uniform(0, 1, (Bs, hw, hw, 3)),
    }
    loss_cfg = {"adversarial": ADV_LOSS}
    base = init_weights(build_model(SMALL_TRAIN_CFG), SEED, scheme="train")
    res = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": 1e-4}})
        grads = {}
        for n, p in model.named_parameters():
            p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().cpu()))
        state = TrainState(model, updater,
                           adv_state=adv_state(build_adversarial(loss_cfg), dev, (hw, hw)))
        b = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, m = make_train_step(loss_cfg=loss_cfg)(state, b)
        m = {k: float(v) for k, v in m.items()}
        res[dev] = (m, grads, {k: v.detach().cpu() for k, v in
                               state.adv_state.disc.state_dict().items()}, time.perf_counter() - t0)
    (mg, gg, dg, sg), (mc, gc, dc, sc) = res["cuda"], res["cpu"]
    checks = [_rel_close("train_loss", mg["train_loss"], mc["train_loss"], 1e-4)]
    checks += [_rel_close(k, mg[k], mc[k], tol) for k, tol in ADV_TOL.items()]
    g_err = max(_rel_l2(gg[n], gc[n]) for n in gc)
    g_all = _rel_l2(torch.cat([gg[n].reshape(-1) for n in gc]),
                    torch.cat([gc[n].reshape(-1) for n in gc]))
    d_diff = torch.cat([(dg[k] - dc[k]).abs().reshape(-1) for k in dc])
    ok = (all(c[0] for c in checks) and g_all <= 1e-3 and g_err <= 1e-2
          and d_diff.max().item() <= 2e-3 * 1.001 and (d_diff > 1e-6).double().mean().item() <= 2e-2)
    log(f"check train 8 (b) one STGAN step, card vs CPU, f32, {SMALL_TRAIN_CFG['args']} at "
        f"B={Bs} {hw}x{hw}: {'; '.join(c[1] for c in checks)}; generator gradients rel L2 "
        f"{g_all:.1e} in all (tol 1e-3), {g_err:.1e} in the worst tensor (tol 1e-2); "
        f"discriminator parameters max abs "
        f"diff {d_diff.max().item():.2e} (tol 2*lr = 2e-3), share > 1e-6 apart "
        f"{(d_diff > 1e-6).double().mean().item():.2e} (tol 2e-2); the step took {sg:.2f} s on "
        f"the card (its first), {sc:.2f} s on the CPU {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train 8 (b): the card and the CPU STGAN step disagree")

    # WGAN_GP: the gradient penalty's double backward, same penalty weights
    adv = AdversarialLoss(hw, "WGAN_GP")
    fake, real = (torch.from_numpy(rng.uniform(0, 1, (Bs, hw, hw, 3)).astype(np.float32))
                  for _ in range(2))
    eps = torch.rand(fake.shape, generator=torch.Generator().manual_seed(SEED))
    res = {}
    for dev in ("cuda", "cpu"):
        state = adv.init(ADV_SEED, fake.to(dev), None)
        params = list(state.disc.parameters())
        d0 = adv.d_loss(state.disc, fake.to(dev), real.to(dev), None, eps.to(dev))
        d_grads = torch.cat([g.reshape(-1).cpu() for g in torch.autograd.grad(d0, params)])
        f = fake.to(dev).requires_grad_()
        state, g, d = adv.step(state, f, real.to(dev), eps=[eps.to(dev)])
        g.backward()
        res[dev] = (float(g), float(d), d_grads, f.grad.cpu(),
                    torch.cat([p.detach().cpu().reshape(-1) for p in params]))
        if dev == "cuda":
            args = (f.detach(), real.cuda())
            ms = cuda_ms(lambda: adv.step(state, *args, eps=[eps.cuda()]), reps=3)
    (gg, dg_, pgg, fg, pg), (gc, dc_, pgc, fc, pc) = res["cuda"], res["cpu"]
    checks = [_rel_close("d_loss", dg_, dc_, 1e-4, 1e-5), _rel_close("g_loss", gg, gc, 1e-3, 1e-5)]
    pg_err, f_err = _rel_l2(pgg, pgc), _rel_l2(fg, fc)
    p_diff = (pg - pc).abs()
    ok = (all(c[0] for c in checks) and pg_err <= 1e-2 and f_err <= 5e-2
          and p_diff.max().item() <= 2e-5 * 1.001)
    log(f"check train 8 (b) WGAN_GP step, card vs CPU, f32, B={Bs} {hw}x{hw}, the same penalty "
        f"weights: {'; '.join(c[1] for c in checks)}; the discriminator's gradients at its "
        f"initial weights (the penalty's double backward) rel L2 {pg_err:.1e} (tol 1e-2: "
        f"cuDNN's f32 algorithms, FFT-based among them, sum otherwise than the CPU's; 9.6e-4 "
        f"on an H100); after "
        f"its Adam update (about lr * sign(g)) parameters max abs diff {p_diff.max().item():.2e} "
        f"(tol 2*lr = 2e-5), and dg_loss/dfake through the updated discriminators rel L2 "
        f"{f_err:.1e} (tol 5e-2: leaky ReLUs near their kink take the other slope where the two "
        f"discriminators differ); one discriminator step on the card {ms:.3f} ms (CUDA events, "
        f"mean of 3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train 8 (b): the card and the CPU WGAN_GP step disagree")
    return ms


def flow_card_vs_cpu(torch):
    """(d) The device event encoder, EventWarping and BrightnessConstancy at
    720x1280 with 200 000 events, card against CPU; ms on the card."""
    from ebfi_tpu_torch.losses import BrightnessConstancy, EventWarping, averaged_iwe
    from ebfi_tpu_torch.ops import events_to_channels, events_to_stack

    rng = np.random.default_rng(SEED + 10)
    n = ENC_EVENTS
    xs = rng.integers(0, W, n).astype(np.float32)
    ys = rng.integers(0, H, n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    cpu_args = [torch.from_numpy(a) for a in (xs, ys, ts, ps)]
    gpu_args = [a.cuda() for a in cpu_args]
    want = events_to_stack(*cpu_args, ENC_TB, (H, W))
    got = events_to_stack(*gpu_args, ENC_TB, (H, W)).cpu()
    enc_ms = cuda_ms(lambda: events_to_stack(*gpu_args, ENC_TB, (H, W)), reps=10)
    ok = torch.equal(got, want) and want.sum().item() >= n
    log(f"check 8 (d) events_to_stack {n} events -> (2, {ENC_TB}, {H}, {W}), card vs CPU: equal "
        f"{torch.equal(got, want)} (exact: unit weights), {want.sum().item():.0f} counts; "
        f"{enc_ms:.3f} ms on the card (CUDA events, mean of 10) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("8 (d): events_to_stack differs between the card and the CPU")

    ev = torch.from_numpy(np.stack([ts, ys, xs, ps], axis=-1)[None])
    pol = torch.from_numpy(np.stack([ps > 0, ps < 0], axis=-1)[None].astype(np.float32))
    flow = torch.from_numpy((rng.standard_normal((1, H, W, 2)) * 2 / max(H, W)).astype(np.float32))
    img, prev = (torch.from_numpy(rng.uniform(0, 1, (1, H, W, 1)).astype(np.float32))
                 for _ in range(2))
    cnt = events_to_channels(*cpu_args[:2], cpu_args[3], (H, W)).permute(1, 2, 0)[None]
    warping, bc = EventWarping(), BrightnessConstancy((H, W))

    def warp_loss(f, e, p, *_):
        return warping([f], e, p, (H, W))

    def bc_loss(f, e, p, i, pv, c):
        return bc.generative_model(f, i, c, e, p) + bc.temporal_consistency(f, pv, i) \
            + bc.regularization(i)

    got, want = (averaged_iwe(flow.to(dev), ev.to(dev), pol.to(dev), (H, W)).cpu()
                 for dev in ("cuda", "cpu"))
    ok = torch.equal(got, want)
    log(f"check 8 (d) averaged_iwe at {H}x{W}, {n} events (distinct sources counted with "
        f"torch.unique), card vs CPU: equal {ok}, {int((got != want).sum())} pixels differ "
        f"(exact: f64 counts and quotients) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("8 (d): averaged_iwe differs between the card and the CPU")
    # f32 gradients through bilinear sampling jump where a sample lies within
    # rounding of a pixel (left against right difference), and an L1 term's
    # where its argument lies within rounding of 0: f32 lands on either
    # side on the card and on the CPU (on an H100: 4.2e-3 and 1.5e-3)
    grad_tol = {"EventWarping": 1e-4, "BrightnessConstancy": 5e-2}
    times = {}
    for name, fn in (("EventWarping", warp_loss), ("BrightnessConstancy", bc_loss)):
        res = {}
        for dev in ("cuda", "cpu"):
            leaves = [x.detach().to(dev).requires_grad_() for x in (flow, img)]
            args = (leaves[0], ev.to(dev), pol.to(dev), leaves[1], prev.to(dev), cnt.to(dev))
            value = fn(*args)
            value.backward()
            res[dev] = (float(value), [x.grad.cpu().clone() if x.grad is not None else None
                                       for x in leaves])
            if dev == "cuda":
                times[name] = cuda_ms(lambda: fn(*args).backward(), reps=3)
        (vg, gg), (vc, gc) = res["cuda"], res["cpu"]
        errs = [_rel_l2(a, b) for a, b in zip(gg, gc) if b is not None]
        ok = abs(vg - vc) <= 1e-4 * abs(vc) and max(errs) <= grad_tol[name]
        log(f"check 8 (d) {name} at {H}x{W}, {n} events, card vs CPU: value {vg:.6e} vs "
            f"{vc:.6e} (tol 1e-4 rel); gradients (flow{', image' if len(errs) > 1 else ''}) rel "
            f"L2 {', '.join(f'{e:.1e}' for e in errs)} (tol {grad_tol[name]:.0e}); forward + backward "
            f"{times[name]:.3f} ms on the card (CUDA events, mean of 3) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"8 (d): {name} differs between the card and the CPU")
    return {"events_to_stack_ms": enc_ms, **{f"{k}_ms": v for k, v in times.items()}}


def phase_adversarial(torch, kern, single):
    """Phase 8: the adversarial term (STGAN) in the train CLI, one process
    and one NCCL rank; card against CPU; two gloo ranks against one
    process; the flow losses and the event encoder at 720p.  ``single``:
    phase 6's numbers from this call.  Returns the launches of B1 (f32)
    and B3 (bf16) in (a)'s in-process runs."""
    from ebfi_tpu_torch.data.synth import write_clip_npz
    from ebfi_tpu_torch.train import cli as train_cli

    tmp = tempfile.mkdtemp(prefix="ebfi_chip_adv_")
    out = {}
    try:
        clip = os.path.join(tmp, "clip.npz")
        frames, h, w = TRAIN_CLIP
        write_clip_npz(clip, num_frames=frames, H=h, W=w, seed=SEED + 3)
        fast = {"model;args;FastVariants": True, "trainer;precision": "bf16",
                "trainer;do_validation": False}
        cfgs = {"f32": train_config(tmp, "adv_f32", clip, ADV_OVERRIDES),
                "bf16": train_config(tmp, "adv_bf16", clip, {**fast, **ADV_OVERRIDES})}

        def expected(label, n_eval):
            if label == "f32":
                return {"fac": TRAIN_ITERS + n_eval, "mod_fac": 0, "mod_fac_shared": 0}
            return {"fac": 0, "mod_fac": TRAIN_ITERS, "mod_fac_shared": 0}

        # ---- (a) the train CLI with trainer.loss.adversarial, in this process
        for label, cfg in cfgs.items():
            trainer, counts, routes, wall = train_run(torch, kern, f"8 (a) {label} STGAN",
                                                      train_cli, ["-c", cfg, "-id", f"adv_{label}"])
            n_eval = eval_forwards(trainer, TRAIN_ITERS // 10) if trainer.do_validation else 0
            m = trainer.train_metrics
            moved, total = disc_moved(torch, trainer.state.adv_state.disc, (ADV_HW, ADV_HW))
            finite = m._counts.get("g_loss", 0) > 0 and all(
                np.isfinite(m.avg(k)) for k in ("train_loss", "g_loss", "d_loss"))
            ok = (trainer.state.step == TRAIN_ITERS and counts == expected(label, n_eval)
                  and (label == "f32" or routes["mod_fac"] == {"wgmma_bf16": TRAIN_ITERS,
                                                                "wgmma_3xtf32": 0})
                  and moved == total and finite)
            log(f"check train 8 (a) {label} STGAN: {trainer.state.step} steps, launches {counts} "
                f"(as phase 6), routes {routes}; discriminator tensors moved {moved}/{total}; "
                f"mean logged train_loss {m.avg('train_loss'):.4e}, g_loss {m.avg('g_loss'):.4e}, "
                f"d_loss {m.avg('d_loss'):.4e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train 8 (a) {label}: the STGAN run did not go as expected")
            ms, batch = steady_step_ms(torch, trainer)
            ms6 = single["a_ms" if label == "f32" else "b_ms"]
            log(f"train 8 (a) {label} STGAN steady: {ms:.2f} ms/iteration, {8e3 / ms:.1f} "
                f"samples/s (phase 6 in this call: {ms6:.2f} ms/iteration, {8e3 / ms6:.1f} "
                f"samples/s; {100 * (ms / ms6 - 1):+.1f} %); {card_identity()}")
            r = breakdown(torch, f"train 8 (a) {label} STGAN, one step",
                          lambda: trainer.train_step(trainer.state, batch), ranges=ADV_RANGES)
            out[label] = {"ms": ms, "ms6": ms6, "launches": counts, "ranges": r}
            del trainer, batch
            torch.cuda.empty_cache()

        # ---- (a) the same under the launcher, one NCCL rank
        spec = dp_spec(tmp, "adv_nccl", ranges=list(ADV_RANGES), runs=[
            [label, ["-c", cfg, "-id", f"nccl_adv_{label}"], True] for label, cfg in cfgs.items()])
        launch_ranks("train 8 (a) STGAN, NCCL, 1 rank", 1, ["chip_smoke.py", "--dp-worker", spec])
        (ra,) = read_ranks(spec, 1)
        for label in cfgs:
            r = ra[label]
            ar = r["ranges"].get("ebfi::disc_grad_allreduce")
            ok = (ra["world"] == 1 and r["step"] == TRAIN_ITERS
                  and r["launches"] == expected(label, r["n_eval"]) and ar is not None)
            log(f"check train 8 (a) {label} STGAN, NCCL world 1: {r['step']} steps, launches "
                f"{r['launches']}; steady {r['ms']:.2f} ms/iteration, {8e3 / r['ms']:.1f} "
                f"samples/s ({r['ms_without_allreduce']:.2f} without the model's all-reduce, in "
                f"turns); ebfi::disc_grad_allreduce per step: "
                f"{'not recorded' if ar is None else _range_text(ar)}; {card_identity()} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train 8 (a) {label}: the NCCL STGAN run failed its checks")
            out[f"nccl_{label}"] = r

        # ---- (b) card against CPU
        out["wgan_gp_step_ms"] = adv_card_vs_cpu(torch)
        torch.cuda.empty_cache()

        # ---- (c) two gloo ranks with STGAN on the one card against one process
        batches = step_check_batches(os.path.join(tmp, "batches.npz"))
        case = ["stgan", MODEL_CFG, False, {"adversarial": ADV_LOSS}]
        spec = dp_spec(tmp, "adv_gloo", backend="gloo", device="cuda:0", step_check={
            "batches": os.path.join(tmp, "batches.npz"), "cases": [case]})
        launch_ranks("train 8 (c) STGAN, gloo, 2 ranks on one card", 2,
                     ["chip_smoke.py", "--dp-worker", spec])
        check_ranks_as_one_process(torch, "train 8 (c)", spec, read_ranks(spec, 2), batches, *case)

        # ---- (d) flow losses and the event encoder at 720p
        out.update(flow_card_vs_cpu(torch))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def share(label):
        r = out[label]["ranges"]
        adv, step = r.get("ebfi::adversarial"), r["step"]
        if adv is None or adv["launches"] is None:
            return "ebfi::adversarial not recorded"
        return (f"ebfi::adversarial {_range_text(adv)}, {adv['launches']} of the step's "
                f"{step['launches']} launches, {100 * adv['busy_ms'] / step['busy_ms']:.1f} % of "
                f"its {step['busy_ms']:.2f} ms device busy")

    log(f"adversarial summary on {card_identity()}: (a) f32 {out['f32']['ms']:.2f} ms/iteration "
        f"(phase 6 {out['f32']['ms6']:.2f}), bf16 {out['bf16']['ms']:.2f} (phase 6 "
        f"{out['bf16']['ms6']:.2f}); NCCL 1 rank f32 {out['nccl_f32']['ms']:.2f}, bf16 "
        f"{out['nccl_bf16']['ms']:.2f}; per step f32: {share('f32')}; bf16: {share('bf16')}; "
        f"(b) WGAN_GP discriminator step {out['wgan_gp_step_ms']:.3f} ms; (d) events_to_stack "
        f"{out['events_to_stack_ms']:.3f} ms, EventWarping {out['EventWarping_ms']:.3f} ms, "
        f"BrightnessConstancy {out['BrightnessConstancy_ms']:.3f} ms")
    return {"B1_fac": out["f32"]["launches"]["fac"], "B3_mod_fac": out["bf16"]["launches"]["mod_fac"]}


# ---------------------------------------------------------------- dataset generation

GEN_FRAMES = 9  # one 720p sequence: 8 pairs
GEN_FLOW = (1.5, 2.0)  # the flow UNet's constant output: |F| = 2.5, 3 frames per pair
GEN_DATASET = {  # the port's loader on the written clip: 2 periods of 8 frames
    "scale": 1, "ori_scale": "ori", "time_bins": 16, "NumFramePerPeriod": 8,
    "NumFramePerBlurry": 8, "NumPeriodPerSeq": 2, "SlidingWindowSeq": 1, "NumPeriodPerLoad": 1,
    "SlidingWindowLoad": 1, "ExposureMethod": "Custom", "ExposureTime": [3, 5, 7],
    "data_augment": {"enabled": False},
}
SLOMO_FLOW_BIAS = (3.5, -2.5, 1.5, -3.0)  # (b): random nets' sub-pixel flow raised to ~3-4 px
SLOMO_TOL = 5e-4  # (b) frames in [0, 1], card vs CPU: two ten-level UNets and four warps
LIB_TOL = 1e-4  # (c) forwards, relative to the largest magnitude: cuDNN's f32 sums vs the CPU's
DCN_GRAD_TOL = 5e-4  # (c) DCN gradients: the gathers' backward adds atomically on the card


def slomo_checkpoint(torch, path, seed, flow=None, flow_bias=None):
    """Random SuperSloMo weights from a seed (torch's Conv2d init), written
    in the published checkpoint's layout.  ``flow``: the flow UNet's conv3
    zeroed and its bias set so that both flows are this constant (the UNet
    still runs in full); ``flow_bias``: added to conv3's bias."""
    from ebfi_tpu_torch.models import superslomo as ss

    g = torch.Generator().manual_seed(seed)
    fnet, inet = ss.init_unet_(ss.SloMoUNet(6, 4), g), ss.init_unet_(ss.SloMoUNet(20, 5), g)
    with torch.no_grad():
        if flow is not None:
            fnet.conv3.weight.zero_()
            fnet.conv3.bias.copy_(torch.tensor(flow * 2))
        if flow_bias is not None:
            fnet.conv3.bias.add_(torch.tensor(flow_bias))
    ss.save_checkpoint(path, fnet.state_dict(), inet.state_dict())


def write_sequence(path, frames):
    """PNG frames with the five row filters in turn, row by row (what cv2
    and other writers choose among), so the reader decodes every filter."""
    from ebfi_tpu_torch.utils.vis import encode_png

    os.makedirs(path)
    for k, f in enumerate(frames):
        with open(os.path.join(path, f"{k:05d}.png"), "wb") as fh:
            fh.write(encode_png(f, np.arange(f.shape[0]) % 5))


def conv_flops(torch, net, run):
    """Multiply-adds x 2 of every Conv2d of ``net`` in ``run()``, counted
    from the shapes it sees."""
    total = [0]

    def hook(m, inp, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def generate_at_720p(torch, kern, tmp):
    """(a): timings of the two passes, then the generator end to end on
    the card; returns the launches of the kernels in its run."""
    from ebfi_tpu_torch.data import generate
    from ebfi_tpu_torch.data.clip_dataset import NpzClipDataset
    from ebfi_tpu_torch.data.synth import render_frames
    from ebfi_tpu_torch.models import superslomo as ss

    t0 = time.perf_counter()
    write_sequence(os.path.join(tmp, "in", "seq0"),
                   render_frames(GEN_FRAMES, H, W, seed=SEED, speed=3.0))
    ckpt = os.path.join(tmp, "SuperSloMo.ckpt")
    slomo_checkpoint(torch, ckpt, SEED, flow=GEN_FLOW)
    log(f"generate (a): {GEN_FRAMES} frames of {H}x{W} written as PNG (filters 0-4 by row) and a "
        f"random-weight checkpoint (seed {SEED}, flow fixed at {GEN_FLOW}) in "
        f"{time.perf_counter() - t0:.1f} s")

    slomo = ss.load_checkpoint(ckpt, "cuda")
    hp, wp = H + (-H) % 32, W + (-W) % 32
    g = torch.Generator(device="cuda").manual_seed(SEED)
    i0, i1 = (torch.rand(1, hp, wp, 3, generator=g, device="cuda") - 0.42 for _ in range(2))
    with torch.inference_mode():
        f01, f10 = slomo.flow(i0, i1)
        count = slomo.insert_count(f01, f10)
        flow_ms = cuda_ms(lambda: slomo.flow(i0, i1), reps=5)
        interp_ms = cuda_ms(lambda: slomo._interp_fn(i0, i1, f01, f10, 1 / 3), reps=5)
        flow_ops = conv_flops(torch, slomo.flow_net, lambda: slomo.flow(i0, i1))
        interp_ops = conv_flops(torch, slomo.interp_net,
                                lambda: slomo._interp_fn(i0, i1, f01, f10, 1 / 3))
    if count != 3:
        raise AssertionError(f"generate (a): insertion count {count}, 3 expected from |F| = 2.5")
    peak = PEAK_FLOPS["float32"]
    for what, ms, ops in (("flow", flow_ms, flow_ops), ("arbitrary-time", interp_ms, interp_ops)):
        log(f"time SuperSloMo {what} pass at {hp}x{wp} (f32, cuDNN, no TF32): {ms:.3f} ms; "
            f"{ops / 1e12:.3f} TFLOP of convolutions, bound {ops / peak * 1e3:.3f} ms at 67 TFLOP/s "
            f"({100 * ops / peak * 1e3 / ms:.1f} % of it; {ops / ms / 1e9:.1f} TFLOP/s)")
    del slomo, i0, i1, f01, f10
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    (rec,) = generate.main(["--input_dir", os.path.join(tmp, "in"), "--output_dir",
                            os.path.join(tmp, "out"), "--slomo_ckpt", ckpt, "--seed", str(SEED),
                            "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = kern.launch_counts()
    pairs = rec["frames_in"] - 1
    ok = rec["frames_out"] == 3 * pairs and rec["events"] > 0 and not any(launches.values())
    log(f"generate (a) python -m ebfi_tpu_torch.data.generate on the card: {rec['frames_in']} "
        f"frames -> {rec['frames_out']} ({3 * pairs} expected: {pairs} pairs x (I0 + 2)), "
        f"{rec['events']} events (Cp={rec['cp']:.3f}, Cn={rec['cn']:.3f}) in {wall:.2f} s; "
        f"upsampler {rec['upsample_s']:.3f} s: {pairs / rec['upsample_s']:.2f} pairs/s, "
        f"{rec['frames_out'] / rec['upsample_s']:.2f} output frames/s; host: PNG decode "
        f"{rec['read_s']:.3f} s, simulate_events {rec['simulate_s']:.3f} s, write "
        f"{rec['write_s']:.3f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {launches} "
        f"(none on this path) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generate (a): the generator did not run as expected")

    ds = NpzClipDataset(rec["path"], GEN_DATASET)
    item = ds.get(0, seed=SEED)
    shapes = {k: v.shape for k, v in item.items()}
    ok = (len(ds) > 0 and item["latent"].shape[-3:] == (H, W, 3)
          and item["events"].shape[-3:] == (H, W, 32)
          and all(np.isfinite(v).all() for v in item.values()) and item["events"].sum() > 0)
    log(f"generate (a) the written clip through NpzClipDataset: {len(ds)} items, item 0 {shapes}, "
        f"finite, {int(item['events'].sum())} events in its stack {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generate (a): the written clip does not load as training input")
    return launches


def generate_card_vs_cpu(torch, tmp):
    """(b): SuperSloMo and the generator at 64x96, card against CPU, with
    random weights whose flow is raised to a few pixels."""
    from ebfi_tpu_torch.data import generate
    from ebfi_tpu_torch.data.synth import render_frames
    from ebfi_tpu_torch.models import superslomo as ss

    ckpt = os.path.join(tmp, "small.ckpt")
    slomo_checkpoint(torch, ckpt, SEED + 1, flow_bias=SLOMO_FLOW_BIAS)
    frames = render_frames(3, 64, 96, seed=SEED + 1, speed=3.0)
    ts = np.arange(3) / 240.0
    card, cpu = ss.load_checkpoint(ckpt, "cuda"), ss.load_checkpoint(ckpt, "cpu")
    x = frames.astype(np.float32) / 255.0
    uc, tc = card.upsample_sequence(x, ts)
    up, tp = cpu.upsample_sequence(x, ts)
    err = float(np.abs(uc - up).max()) if uc.shape == up.shape else float("inf")
    ok = tc == tp and uc.shape == up.shape and len(tc) > 2 and err <= SLOMO_TOL
    log(f"check generate (b) upsample_sequence card vs CPU, 3 frames of 64x96: {len(tc)} and "
        f"{len(tp)} frames, times equal {tc == tp}, max abs {err:.2e} (tol {SLOMO_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generate (b): SuperSloMo on the card disagrees with the CPU")

    write_sequence(os.path.join(tmp, "small", "seq0"), frames)
    outs = {}
    for dev in ("cuda", "cpu"):
        (rec,) = generate.main(["--input_dir", os.path.join(tmp, "small"), "--output_dir",
                                os.path.join(tmp, f"small_{dev}"), "--slomo_ckpt", ckpt,
                                "--seed", str(SEED), "--contrast_min", "0.05",
                                "--contrast_max", "0.1", "--device", dev])
        outs[dev] = _npz(rec["path"])
    a, b = outs["cuda"], outs["cpu"]
    same_ts = np.array_equal(a["image_ts"], b["image_ts"])
    d = (np.abs(a["images"].astype(int) - b["images"].astype(int))
         if a["images"].shape == b["images"].shape else np.array([255]))
    frames_equal = not d.any()
    events = [k for k in a if k.split("_")[0] in ("ori", "down2", "down4", "down8")]
    if frames_equal:  # the same frames give the same events, bit for bit
        ev_ok = set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in events)
        ev_text = "events equal bit for bit"
    else:  # a frame value one level apart moves ESIM-lite's crossings
        ev_ok = abs(len(a["ori_ts"]) - len(b["ori_ts"])) <= 0.01 * len(b["ori_ts"])
        ev_text = f"events {len(a['ori_ts'])} vs {len(b['ori_ts'])} (within 1 %)"
    ok = same_ts and d.max() <= 1 and (d == 0).mean() >= 0.999 and ev_ok and len(b["ori_ts"]) > 0
    log(f"check generate (b) the generator card vs CPU (--device cuda / cpu), 64x96: timestamps "
        f"equal {same_ts}, uint8 frames max diff {int(d.max())} level, {100 * (d == 0).mean():.3f} "
        f"% equal (tol 1 level, 99.9 %), {ev_text} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generate (b): the generator's output differs between card and CPU")


def _rel_err(a, b):
    return float((a.detach().float().cpu() - b.detach().float()).abs().max()
                 / b.detach().float().abs().max().clamp_min(1e-12))


def library_card_vs_cpu(torch):
    """(c): DCN forward and gradients, PSROI pooling, every library block,
    ConvLayer's BN (train and eval) and IN, card against CPU."""
    import copy

    from ebfi_tpu_torch.models import library as lib
    from ebfi_tpu_torch.models.layers import ConvLayer
    from ebfi_tpu_torch.ops import dcn_modules
    from ebfi_tpu_torch.ops.dcn_v2 import dcn_v2_conv

    rng = np.random.default_rng(SEED + 9)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    B, Hs, Ws, Ci, Co, KK, dg = 2, 48, 64, 32, 32, 3, 4
    cpu = [f(B, Hs, Ws, Ci), 2.0 * f(B, Hs, Ws, dg * 2 * KK * KK),
           torch.from_numpy(rng.uniform(0, 1, (B, Hs, Ws, dg * KK * KK)).astype(np.float32)),
           0.1 * f(Co, Ci, KK, KK), f(Co)]
    cot = f(B, Hs, Ws, Co)
    results = {}
    for dev in ("cpu", "cuda"):
        ins = [t.detach().to(dev).requires_grad_() for t in cpu]  # a leaf on either device
        out = dcn_v2_conv(*ins, 1, 1, 1, dg)
        (out * cot.to(dev)).sum().backward()
        results[dev] = [out] + [t.grad for t in ins]
    errs = [_rel_err(c, r) for c, r in zip(results["cuda"], results["cpu"])]
    ok = errs[0] <= LIB_TOL and max(errs[1:]) <= DCN_GRAD_TOL
    log(f"check library (c) dcn_v2_conv B={B} {Hs}x{Ws}x{Ci}->{Co} K={KK} dg={dg} card vs CPU: "
        f"forward {errs[0]:.2e} (tol {LIB_TOL:.0e}), gradients x/offset/mask/weight/bias "
        f"{', '.join(f'{e:.2e}' for e in errs[1:])} (tol {DCN_GRAD_TOL:.0e}, relative to the "
        f"largest) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("library (c): DCNv2 on the card disagrees with the CPU")

    x = f(2, 24, 32, 3 * 2 * 2)
    rois = torch.tensor([[0, 1, 2, 20, 15], [1, -3, 4, 30, 22]], dtype=torch.float32)
    trans = f(2, 2, 2, 2)
    kw = dict(spatial_scale=0.5, pooled_size=4, output_dim=3, group_size=2, part_size=2,
              sample_per_part=2, trans_std=0.1)
    ref = dcn_modules.dcn_v2_psroi_pooling(x, rois, trans, **kw)
    got = dcn_modules.dcn_v2_psroi_pooling(x.cuda(), rois.cuda(), trans.cuda(), **kw)
    checks = {"dcn_v2_psroi_pooling": _rel_err(got, ref)}

    torch.manual_seed(SEED)
    img, seq = f(2, 32, 32, 16), f(2, 10, 16)
    blocks = {
        "ResidualBlock": (lib.ResidualBlock(16), img),
        "ResidualBlock BN": (lib.ResidualBlock(16, "LeakyReLU", "BN"), img),
        "ResidualBlock IN": (lib.ResidualBlock(16, norm="IN"), img),
        "TransposedConvLayer": (lib.TransposedConvLayer(16, 8), img),
        "UpsampleConvLayer": (lib.UpsampleConvLayer(16, 8), img),
        "SelfAttention": (lib.SelfAttention(16), seq),
        "MLP": (lib.MLP(16, 32, 4, 3), seq),
        "ConvLayer1D BN": (lib.ConvLayer1D(16, 8, 3, 1, 1, "ReLU", "BN"), seq),
        "UNet sum/transpose": (lib.UNet(16, 8, 2, 1, 2), img),
        "UNet concat/upsample": (lib.UNet(16, 8, 2, 2, 1, "concat", "upsample"), img),
        "DCN": (dcn_modules.DCN(16, 8), img),
        "ConvLayer IN": (ConvLayer(16, 8, 3, 1, 1, "LeakyReLU", "IN"), img),
    }
    with torch.no_grad():
        for name, (m, inp) in blocks.items():
            checks[name] = _rel_err(copy.deepcopy(m).cuda()(inp.cuda()), m(inp))
        for cell_t in (lib.ConvLSTMCell, lib.ConvGRUCell):
            cell = cell_t(16, 8)
            carry = cell_t.init_carry(2, 32, 32, 8, device="cpu")
            _, y = cell(carry, img)
            carry_c = cell_t.init_carry(2, 32, 32, 8, device="cuda")
            checks[cell_t.__name__] = _rel_err(copy.deepcopy(cell).cuda()(carry_c, img.cuda())[1], y)
        rec = lib.RecurrentConvLayer(16, 8)
        carry = lib.ConvLSTMCell.init_carry(2, 16, 16, 8, device="cpu")
        _, y = rec(carry, img)
        carry_c = lib.ConvLSTMCell.init_carry(2, 16, 16, 8, device="cuda")
        checks["RecurrentConvLayer"] = _rel_err(copy.deepcopy(rec).cuda()(carry_c, img.cuda())[1], y)
        # BN: train (batch statistics, running ones moved) then eval (running ones)
        bn = ConvLayer(16, 8, 3, 1, 1, "ReLU", "BN")
        bn_c = copy.deepcopy(bn).cuda()
        checks["ConvLayer BN train"] = _rel_err(bn_c(img.cuda(), train=True), bn(img, train=True))
        checks["ConvLayer BN running stats"] = max(
            _rel_err(getattr(bn_c.norm, k), getattr(bn.norm, k)) for k in ("running_mean", "running_var"))
        checks["ConvLayer BN eval"] = _rel_err(bn_c(img.cuda()), bn(img))
    bad = {k: v for k, v in checks.items() if not v <= LIB_TOL}
    log(f"check library (c) card vs CPU, forwards relative to the largest (tol {LIB_TOL:.0e}): "
        + ", ".join(f"{k} {v:.1e}" for k, v in checks.items()) + (" ok" if not bad else " FAIL"))
    if bad:
        raise AssertionError(f"library (c): the card disagrees with the CPU on {sorted(bad)}")


def phase_generate(torch, kern):
    """Phase 9: dataset generation at 720p on the card, card against CPU
    for SuperSloMo and the generator, and the op and block library.
    Returns the kernel launches of (a)'s generator run."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ebfi_chip_gen_")
    try:
        launches = generate_at_720p(torch, kern, tmp)
        torch.cuda.empty_cache()
        generate_card_vs_cpu(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    library_card_vs_cpu(torch)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------- export, norm models, data options

# (label, precision, num_t, the engine's multi_chunk, kernel, route): the
# f32 call unhoisted, multi_chunk 4 as phase 4 (c) (bounds its f32 bank)
EXPORT_CASES = (
    ("bf16 N=16", "bf16", N, 16, "mod_fac_shared", "wgmma_bf16"),
    ("f32 N=16", "f32", N, 4, "fac", None),
    ("bf16 num_t=1", "bf16", 1, 16, "mod_fac", "wgmma_bf16"),
)
EXPORT_TOL = 1e-6  # the program against the engine on the same requests, f32 outputs
DATA_ITERS = 3
SHORT_RUN = {  # train_config overrides: DATA_ITERS steps, each logged, no validation
    "trainer;iteration_based_train;iterations": DATA_ITERS,
    "trainer;iteration_based_train;train_log_step": 1,
    "trainer;iteration_based_train;save_period": 1000, "trainer;do_validation": False}
# phase 10 (c)'s clip: 128x128 crops of it, or all of it at half the size
# (80x96, whose sides the loss's 5-level Laplacian pyramid divides)
DATA_CLIP = (65, 160, 192)
KERNEL_OF = {"fac": "B1_fac", "mod_fac": "B3_mod_fac", "mod_fac_shared": "B2_mod_fac_shared"}
KERNEL_COUNTER = {"B1_fac": "fac", "B3_mod_fac": "mod_fac", "B2_mod_fac_shared": "mod_fac_shared",
                  "B2p_mod_fac_shared_packed": "mod_fac_shared"}


def export_requests(torch, num_t):
    """Phase 4's requests (same seed) at num_t timestamps, and gt_ex."""
    rng = np.random.default_rng(SEED + 1)
    return ([make_request(torch, rng, n=num_t) for _ in range(REQUESTS)],
            torch.zeros((1, 1), device="cuda"))


def export_worker(spec_path: str) -> int:
    """Serve exported programs in a process that imports nothing of the
    port but ``ebfi_tpu_torch.ops`` (``chip_smoke.py --export-worker
    SPEC``): for each program of the spec, REQUESTS requests with launch
    counts zeroed before and read after; saves the first request's
    outputs and writes times and counts."""
    import torch

    import ebfi_tpu_torch.ops  # noqa: F401 (registers the ebfi:: ops the programs call)
    from ebfi_tpu_torch.ops import cuda as kern

    with open(spec_path) as f:
        spec = json.load(f)
    # f32 convolutions, as the parent's engine (and the infer CLI in f32):
    # a program does not carry the TF32 switches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for case in spec["cases"]:
        program = torch.export.load(case["pt2"]).module()
        requests, gt_ex = export_requests(torch, case["num_t"])
        kern.reset_launch_counts()
        times, finite = [], True
        with torch.no_grad():
            for i, req in enumerate(requests):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sharps, finals = program(*req, gt_ex)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                finite = finite and bool(torch.isfinite(sharps).all()
                                         and torch.isfinite(finals).all())
                if i == 0:
                    torch.save({"sharps": sharps.cpu(), "finals": finals.cpu()}, case["outputs"])
        results.append({"times": times, "finite": finite, "launches": kern.launch_counts(),
                        "routes": kern.route_counts(),
                        "packed": kern.modification_fac_fused_shared.launches_packed})
        del program, requests, sharps, finals
        torch.cuda.empty_cache()
    with open(spec["result"], "w") as f:
        json.dump(results, f)
    return 0


def _only(counts, routes, kernel, route):
    """Whether ``kernel`` alone was launched, and, where given, on ``route``
    alone."""
    ok = counts[kernel] > 0 and all(v == 0 for k, v in counts.items() if k != kernel)
    if route is not None:
        ok = ok and routes[kernel][route] == counts[kernel]
    return ok


def phase_export(torch, kern, tmp):
    """(a): the engine's call exported (``tools/export.py``) and saved for
    each of EXPORT_CASES, the engine timed on the requests, then every
    program served by one fresh process, against the engine.  Returns the
    programs' launches per kernel."""
    from ebfi_tpu_torch.infer import InferenceEngine
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.tools.export import export_engine

    model = init_weights(build_model(MODEL_CFG), SEED)
    cases = []
    for label, precision, num_t, chunk, kernel, route in EXPORT_CASES:
        engine = InferenceEngine(model, precision=precision, multi_chunk=chunk)
        t0 = time.perf_counter()
        program = export_engine(engine, H, W, num_t)
        export_s = time.perf_counter() - t0
        pt2 = os.path.join(tmp, f"{precision}_{num_t}.pt2")
        torch.export.save(program, pt2)
        nodes = sorted({str(n.target) for n in program.graph.nodes if "ebfi." in str(n.target)})
        del program
        # the engine on the same requests: the reference outputs, ms per request
        requests, gt_ex = export_requests(torch, num_t)
        call = ((lambda f, e, ts: engine.interpolate(f, e, ts, gt_ex)) if num_t > 1
                else (lambda f, e, ts: engine.forward(f, e, ts, gt_ex)))
        kern.reset_launch_counts()
        times = []
        for i, req in enumerate(requests):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = call(*req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            if i == 0:
                ref = [o.cpu() for o in out]
            del out
        cases.append(dict(label=label, precision=precision, chunk=chunk, kernel=kernel,
                          route=route, export_s=export_s, nodes=nodes, times=times, ref=ref,
                          counts=kern.launch_counts(), pt2=pt2, num_t=num_t,
                          outputs=os.path.join(tmp, f"outputs_{precision}_{num_t}.pt")))
        del engine, requests
        torch.cuda.empty_cache()

    spec = {"cases": [{k: c[k] for k in ("pt2", "num_t", "outputs")} for c in cases],
            "result": os.path.join(tmp, "result.json")}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--export-worker",
                           spec_path], timeout=900)
    log(f"export (a): the serving process took {time.perf_counter() - t1:.1f} s wall for the "
        f"{len(cases)} programs")
    if proc.returncode != 0:
        raise AssertionError(f"export (a): the serving process exited {proc.returncode}")
    with open(spec["result"]) as f:
        results = json.load(f)
    launches = {name: 0 for name in (*KERNEL_OF.values(), "B2p_mod_fac_shared_packed")}
    ms = lambda ts: 1e3 * sum(ts[1:]) / len(ts[1:])  # noqa: E731
    for c, res in zip(cases, results):
        got = torch.load(c["outputs"])
        err = max((got["sharps"] - c["ref"][0]).abs().max().item(),
                  (got["finals"] - c["ref"][1]).abs().max().item())
        counts, routes = res["launches"], res["routes"]
        ok = (res["finite"] and err <= EXPORT_TOL and counts == c["counts"]
              and _only(counts, routes, c["kernel"], c["route"])
              and tuple(got["finals"].shape) == tuple(c["ref"][1].shape))
        log(f"export (a) {c['label']} ({c['precision']}, {H}x{W}, engine multi_chunk "
            f"{c['chunk']}): exported in {c['export_s']:.1f} s, "
            f"{os.path.getsize(c['pt2']) / 1e6:.1f} MB .pt2, ops {c['nodes']}; served by a fresh "
            f"process importing ebfi_tpu_torch.ops alone: steady {ms(res['times']):.1f} "
            f"ms/request against the engine's {ms(c['times']):.1f} (per request "
            f"{', '.join(f'{1e3 * t:.1f}' for t in res['times'])}); outputs "
            f"{tuple(got['finals'].shape)} max_abs={err:.2e} against the engine (tol "
            f"{EXPORT_TOL:.0e}); launches {counts} (engine {c['counts']}), routes {routes} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"export (a) {c['label']}: the exported program does not serve "
                                 "as the engine does")
        for k, n in counts.items():
            launches[KERNEL_OF[k]] += n
        launches["B2_mod_fac_shared"] -= res["packed"]
        launches["B2p_mod_fac_shared_packed"] += res["packed"]
    return launches


def norm_model(torch, norm):
    """The shipped widths with dual_path False and ``norm``, random weights
    from the seed, norm scales and shifts and BN's running statistics
    drawn away from their identity."""
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.models.layers import BatchNorm

    cfg = {"name": "EVFIAutoEx", "args": dict(MODEL_CFG["args"], DualPath=False, norm=norm)}
    model = init_weights(build_model(cfg), SEED)
    g = torch.Generator().manual_seed(SEED + 7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, torch.nn.GroupNorm)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(m.running_var.shape, generator=g))
    return model


def phase_norm_models(torch, kern):
    """(b): EVFIAutoEx with BN and IN (dual_path False) at 720p, N = 16,
    f32 and bf16 with fast_math: Modification stays unfused, so B1 alone
    launches; the card against the CPU at 64x96.  Returns B1's launches."""
    from ebfi_tpu_torch.infer import InferenceEngine

    rng = np.random.default_rng(SEED + 1)
    requests = [make_request(torch, rng) for _ in range(REQUESTS)]
    small = make_request(torch, np.random.default_rng(SEED + 2), 64, 96, 3)
    total = 0
    for norm in ("BN", "IN"):
        model = norm_model(torch, norm)
        for precision, chunk in (("f32", 4), ("bf16", 16)):
            engine = InferenceEngine(model, precision=precision, fast_math=precision == "bf16",
                                     multi_chunk=chunk)
            _, counts, _ = serve(
                torch, kern, f"(b) norm={norm} {precision} interpolate(outputs='final') N=16"
                + (", fast_math=True" if precision == "bf16" else f", multi_chunk {chunk}"),
                "fac", lambda f, e, ts: engine.interpolate(f, e, ts, outputs="final")[1],
                requests, N)
            if counts["mod_fac"] or counts["mod_fac_shared"]:
                raise AssertionError(f"(b) norm={norm} {precision}: B2/B3 launched ({counts})")
            total += counts["fac"]
            del engine
            torch.cuda.empty_cache()
        gpu = InferenceEngine(model, precision="f32")
        cpu = InferenceEngine(model, precision="f32", device="cpu")
        kern.reset_launch_counts()
        got = gpu.interpolate(*small)[1].cpu()
        counts = kern.launch_counts()
        want = cpu.interpolate(*[x.cpu() for x in small])[1]
        err = (got - want).abs().max().item()
        ok = err <= 1e-3 and _only(counts, {}, "fac", None)
        log(f"check (b) norm={norm} card vs CPU f32, 64x96 N=3 (launches {counts}): "
            f"max_abs={err:.2e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(b) norm={norm}: the card and the CPU disagree")
        del model, gpu, cpu
    del requests
    torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms (benchmark off) inside the block, so
    that two runs on equal inputs compute equal outputs."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@contextlib.contextmanager
def recorded_losses(train_cli):
    """``train_cli.make_train_step`` wrapped inside the block: every step's
    ``train_loss`` is appended to the list it yields."""
    make_step, losses = train_cli.make_train_step, []

    def recording(*a, **k):
        step = make_step(*a, **k)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["train_loss"]))
            return state, metrics

        return run

    train_cli.make_train_step = recording
    try:
        yield losses
    finally:
        train_cli.make_train_step = make_step


def phase_data_options(torch, kern, tmp):
    """(c): DATA_ITERS steps of the train CLI (the shipped f32 model,
    ``configs/train_evfi.yml``) with ``fast``, and with NeedNeighborGT on a
    config that rescales (GT at the stored half resolution), each against
    the same run without the option: equal losses, step by step, with
    cuDNN's deterministic algorithms."""
    from ebfi_tpu_torch.data.clip_dataset import NpzClipDatasetFast
    from ebfi_tpu_torch.data.synth import write_clip_npz
    from ebfi_tpu_torch.train import cli as train_cli

    clip = os.path.join(tmp, "clip.npz")
    frames, h, w = DATA_CLIP
    write_clip_npz(clip, num_frames=frames, H=h, W=w, seed=SEED + 3, down_scales=(2,))
    rescale = {"train_dataloader;dataset;scale": 1}  # ori_scale down2: GT at half the size
    runs = [("plain", {}), ("fast", {"train_dataloader;fast": True}), ("rescaled", rescale),
            ("rescaled_neighbor", {**rescale, "train_dataloader;dataset;NeedNeighborGT": True})]
    out = {}
    with deterministic_cudnn(torch), recorded_losses(train_cli) as losses:
        for name, extra in runs:
            cfg = train_config(tmp, name, clip, {**SHORT_RUN, **extra})
            losses.clear()
            trainer, counts, _, wall = train_run(torch, kern, f"(c) {name}", train_cli,
                                                 ["-c", cfg, "-id", name])
            ds = trainer.train_loader.datasets[0]
            item = ds.get(0, seed=0)
            out[name] = {"losses": list(losses), "wall": wall, "counts": counts,
                         "fast": isinstance(ds, NpzClipDatasetFast),
                         "shapes": {k: tuple(v.shape) for k, v in item.items()}}
            del trainer
    for name, ref in (("fast", "plain"), ("rescaled_neighbor", "rescaled")):
        a, b = out[name], out[ref]
        nei = a["shapes"].get("neighbor")
        ok = (len(a["losses"]) == DATA_ITERS and a["losses"] == b["losses"]
              and all(np.isfinite(a["losses"]))
              and a["counts"] == {"fac": DATA_ITERS, "mod_fac": 0, "mod_fac_shared": 0}
              and (a["fast"] if name == "fast" else
                   nei is not None and nei[-3:] == (h // 2, w // 2, 3)
                   and a["shapes"]["latent"][-3:] == (h // 2, w // 2, 3)))
        log(f"check (c) {name} against {ref}: losses {a['losses']} vs {b['losses']} (equal "
            f"required); launches {a['counts']}; item shapes {a['shapes']}; run wall "
            f"{a['wall']:.1f} vs {b['wall']:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(c) {name}: the run does not train as {ref} does")


def phase_serving_options(torch, kern):
    """Phase 10.  Returns {"export": launches per kernel, "norm": B1's}."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ebfi_chip_export_")
    try:
        export = phase_export(torch, kern, tmp)
        norm = phase_norm_models(torch, kern)
        phase_data_options(torch, kern, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return {"export": export, "norm": norm}


# ---------------------------------------------------------------------- spatial

SP_BATCH, SP_HW, SP_STEPS = 8, 128, 3  # (b): the shipped batch and crops, Adam steps
SP_BANDS = 2
SP_LOSS_TOL = {"f32": 1e-5, "bf16": 1e-2}  # as tests/test_torch_distributed.py holds DP
SP_TERMS = {"adversarial": ADV_LOSS, "perceptual": {"enabled": True, "weight": 0.1}}
SP_FAST_CFG = {**MODEL_CFG, "args": {**MODEL_CFG["args"], "FastVariants": True}}
SP_CASES = [["f32", MODEL_CFG, False, None], ["bf16", SP_FAST_CFG, True, None],
            ["f32_stgan_lpips", MODEL_CFG, False, SP_TERMS],
            ["bf16_stgan_lpips", SP_FAST_CFG, True, SP_TERMS]]
SP_GRIDS = {1: [c[0] for c in SP_CASES], 2: ["f32_stgan_lpips"]}  # data axis D -> cases
# each step's |spatial - unsharded| / |unsharded|, the spatial value the
# mean over the ranks.  With the terms, g_loss and d_loss follow Adamax
# updates, which move every parameter by about lr whatever its gradient's
# size, so a gradient within the card's noise of 0 (cuDNN's weight
# gradients add with atomics, differently in each process) moves it the
# other way, and d_loss falls to about 4e-4 by step 3: sound f32 runs read
# up to 2.3e-3 on d_loss and 7.0e-4 on g_loss, bf16 ones 1.04e-2 and
# 1.2e-3 (PERF.md, §6).  Step 1's d_loss comes before the
# discriminator's first update, the forward alone (sound runs: at most
# 1.8e-7 in f32, 0 in bf16), and is held to SP_FIRST_STEP_TOL
SP_TERM_TOL = {"f32": {"train_loss": 1e-5, "lpips_loss": 1e-5, "g_loss": 5e-3, "d_loss": 1e-2},
               "bf16": {"train_loss": 1e-2, "lpips_loss": 1e-3, "g_loss": 1e-2, "d_loss": 5e-2}}
SP_FIRST_STEP_TOL = {"f32": {"d_loss": 1e-5}, "bf16": {"d_loss": 1e-4}}
# the share of the discriminator's parameters more than 1e-3 * lr from the
# unsharded step's (Adamax, lr 1e-3: a parameter whose update took the
# other sign is up to 2 * lr per step apart; sound runs: at most 1.0e-2 in
# f32, 4.1e-2 in bf16)
SP_DISC_SHARE = {"f32": 5e-2, "bf16": 2e-1}
SP_RANGES = ("ebfi::adversarial",)


def band_parts(torch, x, bank, bands):
    """Each band of an image as B1's band mode takes it: its rows with
    their (K-1)/2 halo rows above and below, the edge row replicated at the
    image's own top and bottom (what ``halo_rows`` gives), and its rows of
    the bank."""
    from ebfi_tpu_torch.ops.kernel_conv2d import replicate_pad

    p, n = (K - 1) // 2, x.shape[1] // bands
    xp = replicate_pad(x, p, dims=(1,))
    return [(xp[:, j * n:(j + 1) * n + 2 * p].contiguous(), bank[:, j * n:(j + 1) * n].contiguous())
            for j in range(bands)]


def fac_band_work(B, h, w, bands, dtype):
    """(bytes, flops) of B1's band mode over every band of a B x h x w
    image: each band's rows with their halo and its bank read once, its
    output written once."""
    s = 4 if dtype == "float32" else 2
    n = h // bands
    per = (B * (n + K - 1) * w * C + B * n * w * K * K * C + B * n * w * C) * s
    return bands * per, 2 * K * K * C * B * h * w


def phase_fac_band(torch, kern):
    """11 (a): B1's band mode at the serving shape (B=4, 360x640x64, K=5),
    cut into SP_BANDS bands with their halos, in f32 and bf16: each band
    against the plain version in f32 on the same inputs (TOL_REL) and
    against whole-image B1's rows; then timed over every band beside
    whole-image B1 on the same image (CUDA events)."""
    # drawn on the card: the bank is 1.5e9 values, which numpy takes tens
    # of seconds to draw on the host
    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    B, hm, wm = 4, H // 2, W // 2
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        x = torch.randn((B, hm, wm, C), generator=gen, device="cuda").to(dt)
        bank = torch.randn((B, hm, wm, K * K * C), generator=gen, device="cuda").to(dt)
        parts = band_parts(torch, x, bank, SP_BANDS)
        n = hm // SP_BANDS
        err, tol, whole_diff = 0.0, 0.0, 0.0
        with torch.inference_mode():
            whole = kern.kernel_conv2d_cuda(x, bank, K)
            for j, (xr, bk) in enumerate(parts):
                got = kern.fac_band_cuda(xr, bk, K).float()
                ref = kern.fac_band_plain(xr.float(), bk.float(), K)
                err = max(err, (got - ref).abs().max().item())
                tol = max(tol, TOL_REL[dname] * ref.abs().max().item())
                whole_diff = max(whole_diff,
                                 (got - whole[:, j * n:(j + 1) * n].float()).abs().max().item())
                del ref
            torch.cuda.synchronize()
            ok = err <= tol and whole_diff <= tol
            log(f"check B1 band {dname} B={B} {hm}x{wm}x{C} K={K} in {SP_BANDS} bands of {n} rows "
                f"+ {K - 1} halo rows: max_abs_err={err:.3e} tol={tol:.3e} (plain version in f32 "
                f"on the same inputs); against whole-image B1's rows: max abs diff "
                f"{whole_diff:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"B1 band {dname}: the band mode disagrees")
            ms = cuda_ms(lambda: [kern.fac_band_cuda(xr, bk, K) for xr, bk in parts], reps=5)
            whole_ms = cuda_ms(lambda: kern.kernel_conv2d_cuda(x, bank, K), reps=5)
            plain_ms = cuda_ms(lambda: [kern.fac_band_plain(xr, bk, K) for xr, bk in parts],
                               reps=2)
        nbytes, flops = fac_band_work(B, hm, wm, SP_BANDS, dname)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
        out[dname] = dict(
            max_abs_err=err, whole_image_max_abs_diff=whole_diff, ms=ms, whole_image_ms=whole_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape=f"B={B} {SP_BANDS}x({n}+{K - 1})x{wm}x{C} K={K}")
        log(f"time B1 band {dname} {out[dname]['shape']}: {ms:.3f} ms for the {SP_BANDS} bands "
            f"(whole-image B1 on the same image {whole_ms:.3f} ms), plain {plain_ms:.3f} ms, "
            f"bound {out[dname]['bound_ms']:.3f} ms ({out[dname]['bound_by']}; "
            f"{nbytes / ms / 1e6:.0f} GB/s); {card_identity()}")
        del x, bank, parts, whole
        torch.cuda.empty_cache()
    return out


def spatial_batches(path):
    rng = np.random.default_rng(SEED + 12)
    arrays = {}
    for i in range(SP_STEPS):
        b = {"frame": rng.uniform(0, 1, (SP_BATCH, SP_HW, SP_HW, 3)),
             "event": rng.uniform(0, 2, (SP_BATCH, SP_HW, SP_HW, 2 * MODEL_CFG["args"]["TB"])),
             "t": rng.uniform(0, 1, (SP_BATCH, 1)),
             "target": rng.uniform(0, 1, (SP_BATCH, SP_HW, SP_HW, 3))}
        arrays.update({f"{k}_{i}": v.astype(np.float32) for k, v in b.items()})
    np.savez(path, **arrays)
    return arrays


def spatial_steps(torch, kern, device, sync, batches, cfg, bf16, spec=None, loss_cfg=None):
    """SP_STEPS Adam steps of ``cfg`` from the seed's training init,
    through the spatial step with ``spec`` on its data shard of the
    batches, or the unsharded step on the whole batches without one, with
    the terms of ``loss_cfg`` (the
    discriminator from the CLI's seed): losses (and the terms' metrics),
    ms per step (host clock around synchronised steps), peak memory,
    launches, and the trained parameters.  With the terms on the card, one
    more step under the profiler gives SP_RANGES' device spans (unsharded
    and on a 1 x S grid)."""
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.parallel import broadcast_module_
    from ebfi_tpu_torch.train import TrainState, build_adversarial, build_optimizer, make_train_step

    model = init_weights(build_model(cfg), SEED, scheme="train").to(device)
    if spec is not None:
        broadcast_module_(model)
    updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": DP_LR}}, spatial=spec)
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None, spatial=spec,
                           loss_cfg=loss_cfg)
    state, metrics, ms = TrainState(model, updater), {}, []
    if loss_cfg:
        axis = (1,) if spec is None else (spec.data, spec.data_index, spec.data_group)
        state.adv_state = adv_state(build_adversarial(loss_cfg, *axis), device,
                                    batches["frame_0"].shape[1:3])
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kern.reset_launch_counts()
    n = SP_BATCH // (1 if spec is None else spec.data)
    d = 0 if spec is None else spec.data_index
    for i in range(SP_STEPS):
        b = {k: torch.from_numpy(batches[f"{k}_{i}"][d * n:(d + 1) * n]).to(device)
             for k in ("frame", "event", "t", "target")}
        sync()
        t0 = time.perf_counter()
        state, m = step(state, b)
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    out = {"losses": metrics.pop("train_loss"), "metrics": metrics, "ms": ms, "peak_bytes": peak,
           "launches": {**kern.launch_counts(), **kern.band_launch_counts()},
           "routes": kern.route_counts()}
    trained = trained_params(state)
    # not on 2 x 2: four processes sharing the card under the profiler read
    # device spans longer than the step's wall (25 s against 2 s)
    if loss_cfg and device.type == "cuda" and (spec is None or spec.data == 1):
        where = "unsharded" if spec is None else f"rank {spec.band_index}"
        out["ranges"] = breakdown(torch, f"spatial 11 (b) {where}, one step with the terms",
                                  lambda: step(state, b), top=5, ranges=SP_RANGES)
    return out, trained


def spatial_worker(torch, kern, spec, device, sync):
    """11 (b) on one rank: the grid of ``spatial_check``'s model_parallel
    over the launch's ranks, then each case's steps; the trained
    parameters saved beside the spec's ``out``."""
    from ebfi_tpu_torch.parallel import local_shard_info, spatial_shardings

    sc = spec["spatial_check"]
    rank = local_shard_info()[0]
    batches = dict(np.load(sc["batches"]))
    sp = spatial_shardings(sc["model_parallel"])
    res = {"grid": [sp.data, sp.model, sp.data_index, sp.band_index]}
    for label, cfg, bf16, loss_cfg in sc["cases"]:
        r, trained = spatial_steps(torch, kern, device, sync, batches, cfg, bf16, sp, loss_cfg)
        res["sp_" + label] = r
        torch.save(trained, spec["out"] % rank + f".sp_{label}.pt")
        del trained
        torch.cuda.empty_cache()
    return res


def check_spatial_case(torch, spec, ranks, case, one, want):
    """One case of 11 (b): the ranks' results (``ranks``, read from
    ``spec``'s files) against the unsharded step's (``one``, its trained
    parameters ``want``).  Every rank's metrics are its data shard's, so
    their mean over the ranks is the whole batch's.  Logs the comparison
    and the run's ms and memory, raises on a disagreement, and returns the
    run's launches, ms and peak memory."""
    label, _, bf16, loss_cfg = case
    nproc = len(ranks)
    S = SP_BANDS
    grid = f"{nproc // S} x {S}"
    got = [torch.load(rank_file(spec, r) + f".sp_{label}.pt", weights_only=True)
           for r in range(nproc)]
    same = all(torch.equal(got[0][k], g[k]) for g in got[1:] for k in want)
    keys = {"model": [k for k in want if not k.startswith("disc.")],
            "disc": [k for k in want if k.startswith("disc.")]}
    diffs = {part: torch.cat([(got[0][k] - want[k]).abs().flatten() for k in ks])
             for part, ks in keys.items() if ks}
    lr = {"model": DP_LR, "disc": 1e-3}  # Adam; the discriminator's Adamax
    share = {part: (d > 1e-3 * lr[part]).float().mean().item() for part, d in diffs.items()}
    dname = "bf16" if bf16 else "f32"
    params_ok = (all(d.max().item() <= 2 * lr[part] * SP_STEPS * 1.001
                     for part, d in diffs.items())
                 and share.get("disc", 0.0) <= SP_DISC_SHARE[dname])
    rb = [r["sp_" + label] for r in ranks]
    tol = SP_TERM_TOL[dname] if loss_cfg else {"train_loss": SP_LOSS_TOL[dname]}
    series = {"train_loss": (np.mean([r["losses"] for r in rb], axis=0), one["losses"]),
              **{k: (np.mean([r["metrics"][k] for r in rb], axis=0), one["metrics"][k])
                 for k in one["metrics"]}}
    rel = {k: np.abs(a - np.array(b)) / np.abs(b) for k, (a, b) in series.items()}
    limit = {k: [SP_FIRST_STEP_TOL[dname].get(k, t)] + [t] * (SP_STEPS - 1)
             for k, t in tol.items()}
    ln = [r["launches"] for r in rb]
    group = [[d * S + m for m in range(S)] for d in range(nproc // S)]
    ok = (same and params_ok and set(rel) == set(tol)
          and all((rel[k] <= limit[k]).all() for k in tol)
          and all(rb[r]["losses"] == rb[g[0]]["losses"] and rb[r]["metrics"] == rb[g[0]]["metrics"]
                  for g in group for r in g)
          and all(n["fac_band"] > 0 and n["mod_fac"] == 0 and n["fac"] == 0
                  and n["mod_fac_shared"] == 0 for n in ln)
          and one["launches"]["fac_band"] == 0
          and [r["grid"] for r in ranks] == [[nproc // S, S, *divmod(r, S)] for r in range(nproc)])
    sp_ms = float(np.mean(rb[0]["ms"][1:]))
    one_ms = float(np.mean(one["ms"][1:]))
    terms = f" with {sorted(loss_cfg)}" if loss_cfg else ""
    log(f"check spatial 11 (b) {label} on {grid}: {SP_STEPS} Adam steps (lr {DP_LR:g}) of the "
        f"shipped model{terms}, batch {SP_BATCH} at {SP_HW}x{SP_HW}, on {nproc} gloo ranks "
        f"({nproc // S} data shards of {SP_BATCH * S // nproc} items, {S} bands of "
        f"{SP_HW // S} rows) against the unsharded step on the card: "
        + "; ".join(f"{k} {[float(x) for x in a]} vs {b} (each step's relative difference "
                    f"{[float(f'{x:.2e}') for x in rel[k]]}, tol {limit[k]})"
                    for k, (a, b) in series.items())
        + "; parameters max abs diff " + ", ".join(
            f"{part} {d.max().item():.2e} (tol 2*lr*steps = {2 * lr[part] * SP_STEPS:.0e}; "
            f"{share[part]:.2e} of them more than 1e-3*lr apart"
            + (f", tol {SP_DISC_SHARE[dname]:.0e}" if part == "disc" else "") + ")"
            for part, d in diffs.items())
        + f", ranks bitwise equal {same}; launches per rank {ln} (unsharded: "
        f"{one['launches']}) {'ok' if ok else 'FAIL'}")
    log(f"spatial 11 (b) {label} on {grid}: {sp_ms:.1f} ms/iteration on {nproc} gloo ranks "
        f"sharing the card (steps 2-{SP_STEPS}; halos and head gather through host "
        f"copies), peak memory per rank "
        f"{[round(r['peak_bytes'] / 2**20) for r in rb]} MiB; unsharded "
        f"{one_ms:.1f} ms/iteration, peak {one['peak_bytes'] / 2**20:.0f} MiB; "
        f"{card_identity()} ({nproc} ranks on one card: not a speed figure)")
    if loss_cfg and "ranges" in rb[0]:
        spans = {w: r.get("ranges", {}).get(SP_RANGES[0]) for w, r in
                 (("rank 0", rb[0]), ("unsharded", one))}
        log(f"spatial 11 (b) {label} on {grid}: {SP_RANGES[0]} per step, " + "; ".join(
            f"{w}: {'not recorded' if sp is None else _range_text(sp)}"
            for w, sp in spans.items()) + f"; {card_identity()}")
    if not ok:
        raise AssertionError(f"spatial 11 (b) {label} on {grid}: the spatial step disagrees")
    return {"ranks": ln, "unsharded": one["launches"], "ms": sp_ms, "unsharded_ms": one_ms,
            "peak_mib": [r["peak_bytes"] / 2**20 for r in rb],
            "unsharded_peak_mib": one["peak_bytes"] / 2**20}


def phase_spatial(torch, kern):
    """Phase 11: B1's band mode (a), then (b) the spatial step of the
    shipped model on gloo ranks on the one card (NCCL refuses two ranks on
    one device; the halos travel through host copies) against the
    unsharded step in this process: each grid of SP_GRIDS (1 x SP_BANDS,
    then 2 x SP_BANDS, where the discriminator's BN statistics and the
    data shards span two ranks) with its cases.  Returns the band row's
    numbers and the launches of each run (the 2 x 2 ones labelled so)."""
    t0 = time.perf_counter()
    band = phase_fac_band(torch, kern)
    tmp = tempfile.mkdtemp(prefix="ebfi_chip_sp_")
    runs, unsharded = {}, {}
    try:
        batches = spatial_batches(os.path.join(tmp, "batches.npz"))
        for D, labels in SP_GRIDS.items():
            cases = [c for c in SP_CASES if c[0] in labels]
            nproc = D * SP_BANDS
            spec = dp_spec(tmp, f"sp{D}", backend="gloo", device="cuda:0", spatial_check={
                "batches": os.path.join(tmp, "batches.npz"), "model_parallel": SP_BANDS,
                "cases": cases})
            launch_ranks(f"spatial 11 (b) gloo, {nproc} ranks ({D} x {SP_BANDS}) on one card",
                         nproc, ["chip_smoke.py", "--dp-worker", spec])
            ranks = read_ranks(spec, nproc)
            for case in cases:
                label, cfg, bf16, loss_cfg = case
                if label not in unsharded:
                    unsharded[label] = spatial_steps(torch, kern, torch.device("cuda"),
                                                     torch.cuda.synchronize, batches, cfg, bf16,
                                                     loss_cfg=loss_cfg)
                    torch.cuda.empty_cache()
                key = label if D == 1 else f"{label}_{D}x{SP_BANDS}"
                runs[key] = check_spatial_case(torch, spec, ranks, case, *unsharded[label])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return band, runs


# ---------------------------------------------------------------------- real recording

REC_HW = (260, 346)  # DAVIS346: APS frames and events at 260 x 346
REC_FRAMES = 9  # the last frame closes the 8th period: 8 blurry frames on the real-blur CLI
REC_PERIOD_NS = 40_000_000  # 25 APS frames/s
REC_EPOCH_NS = 1_600_000_000 * 10**9  # ROS time of the first frame
REC_PACKETS = 4  # event messages per frame interval
REC_SPEED, REC_THRESHOLD = 16.0, 0.15  # pattern shift per frame, contrast threshold: >= 1e6 events
REC_MIN_EVENTS = 10**6
REAL_INTERP = 256  # scripts/infer.sh's --interp_num
REAL_BLUR_FLAGS = [  # scripts/infer.sh's RealBlur-DAVIS recipe as written
    "--scale", "2", "--ori_scale", "down2", "--time_bins", "16", "--interp_num",
    str(REAL_INTERP), "--num_period_per_seq", "2", "--sliding_window_seq", "2",
    "--num_period_per_load", "1", "--sliding_window_load", "1", "--noise_enabled", "--real_blur",
]
REAL_CPU_TIMESTAMPS = 16  # (d): the card against the CPU on this many of the 256
REAL_MOVIE_WINDOWS = 4  # (e): the cloud movie's frame intervals


def synth_recording(tmp):
    """12 (a): a DAVIS346-shaped recording from the seed, grey APS frames of
    a moving pattern with per-frame exposures and the events
    ``data.synth.simulate_events`` fires over them, written two ways: a
    ROS bag (``/dvs/image_raw`` mono8, ``/dvs/events`` in REC_PACKETS
    messages per frame interval, bz2 chunks) and an events ``.npz`` (x, y,
    t, p) with PNG frames, a timestamp file and an exposure file (``begin
    end`` per frame, the bag route's zeroed time base)."""
    from ebfi_tpu_torch.data import rosbag as rb
    from ebfi_tpu_torch.data.synth import render_frames, simulate_events
    from ebfi_tpu_torch.utils.vis import save_frame

    h, w = REC_HW
    rng = np.random.default_rng(SEED + 12)
    rgb = render_frames(REC_FRAMES, h, w, seed=SEED + 12, speed=REC_SPEED)
    grey = np.round(rgb.astype(np.float64).mean(-1)).astype(np.uint8)
    rel = np.arange(REC_FRAMES) * (REC_PERIOD_NS / 1e9)
    (xs, ys, ts, ps), _ = simulate_events(grey[..., None], rel, REC_THRESHOLD, seed=SEED + 12)
    ev_ns = REC_EPOCH_NS + np.round(ts * 1e9).astype(np.int64)
    img_ns = REC_EPOCH_NS + np.arange(REC_FRAMES, dtype=np.int64) * REC_PERIOD_NS
    secs, nsecs = ev_ns // 10**9, ev_ns % 10**9
    stamp = lambda ns: rb.Time(int(ns // 10**9), int(ns % 10**9))
    # the times as the bag route reads them (zero_timestamps: from the first frame)
    first = rb.timestamp_float(stamp(img_ns[0]))
    ev_t = secs.astype(np.float64) + nsecs.astype(np.float64) / float(1e9) - first
    img_t = np.array([rb.timestamp_float(stamp(n)) - first for n in img_ns])
    duty = rng.uniform(0.3, 0.7, REC_FRAMES)
    exposure = np.stack([img_t, img_t + duty * (REC_PERIOD_NS / 1e9)], axis=1)

    messages = [(0, int(n), "/dvs/image_raw", rb.Image.from_array(
        rb.Header(i, stamp(n), "davis"), grey[i], "mono8")) for i, n in enumerate(img_ns)]
    edges = REC_EPOCH_NS + np.arange(1, (REC_FRAMES - 1) * REC_PACKETS) * (
        REC_PERIOD_NS // REC_PACKETS)
    for k, (a, b) in enumerate(zip(np.r_[0, np.searchsorted(ev_ns, edges)],
                                   np.r_[np.searchsorted(ev_ns, edges), len(ev_ns)])):
        if b > a:
            msg = rb.EventArray.from_arrays(rb.Header(k, stamp(ev_ns[a]), "davis"), h, w,
                                            xs[a:b], ys[a:b], secs[a:b], nsecs[a:b], ps[a:b] > 0)
            messages.append((1, int(ev_ns[b - 1]), "/dvs/events", msg))
    messages.sort(key=lambda m: (m[1], m[0]))  # by record time; a frame before events at a tie
    paths = {k: os.path.join(tmp, v) for k, v in (
        ("bag", "davis346.bag"), ("events", "events.npz"), ("frames", "frames"),
        ("timestamps", "timestamps.txt"), ("exposures", "exposures.txt"))}
    rb.write_bag(paths["bag"], [(topic, m, stamp(t)) for _, t, topic, m in messages],
                 compression="bz2")
    np.savez(paths["events"], x=xs.astype(np.uint16), y=ys.astype(np.uint16), t=ev_t,
             p=(ps > 0).astype(np.uint8))
    os.makedirs(paths["frames"])
    for i in range(REC_FRAMES):
        save_frame(grey[i], os.path.join(paths["frames"], f"{i:06d}.png"))
    np.savetxt(paths["timestamps"], img_t)
    np.savetxt(paths["exposures"], exposure)
    return paths, {"events": len(xs), "frames": grey, "ev": (xs, ys, ev_t, ps), "img_t": img_t}


def real_blur_loader_window(clip, cli):
    """The first window of the real-blur CLI's loader on the clip."""
    from ebfi_tpu_torch.data.dataloader import EBFIDataLoader

    random.seed(123)
    np.random.seed(123)
    cfg = cli.apply_flag_overrides(cli.default_dataloader_config(), cli.get_flags(
        ["--output_path", "unused", *REAL_BLUR_FLAGS]))
    loader = EBFIDataLoader(clip, cfg["dataset"], real_data=True)
    windows = iter(loader)
    try:
        return next(windows)
    finally:
        windows.close()


def phase_real_recording(torch, kern):
    """Phase 12: a real-recording's way in, the real-blur CLI and the
    renderers.  (a) :func:`synth_recording`; (b) both ingest routes of
    ``python -m ebfi_tpu_torch.data.ingest`` (``bag`` with
    ``--zero_timestamps``, the exposures through ``set-array``; ``events``
    with ``--exposures``), equal clips array for array, host seconds and
    events/s; (c) the infer CLI with ``scripts/infer.sh``'s RealBlur-DAVIS
    flags in f32 (unhoisted: B1) and bf16 (hoisted: B2 on wgmma_bf16),
    blurry frames x 256 restored frames, no GT frame, wall seconds, frames/s
    and host and device ms per blurry frame, launches by kernel and route
    (counts zeroed just before each run); (d) B1 and B2 against their plain
    versions at this path's shapes (TOL_REL), the card against the CPU on
    the first blurry frame at 16 of its 256 timestamps (f32, 1e-3 as phase
    4); (e) the stack movie of the first window's bins and the cloud movie
    of the first frame intervals with the APS frames beneath, their ms and
    bytes.  Returns the launches of (c)'s runs."""
    from ebfi_tpu_torch.data import ingest
    from ebfi_tpu_torch.infer import InferenceEngine, cli
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.utils.checkpoint import save_checkpoint
    from ebfi_tpu_torch.utils.vis import save_event_cloud_movie, save_event_stack_movie

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ebfi_chip_real_")
    out = {}
    try:
        # ---- (a) the recording
        t0 = time.perf_counter()
        paths, rec = synth_recording(tmp)
        h, w = REC_HW
        log(f"real (a): synthetic DAVIS346 recording {h}x{w}: {REC_FRAMES} grey APS frames at "
            f"{1e9 / REC_PERIOD_NS:.0f} frames/s with exposures, {rec['events']} events "
            f"(simulate_events, threshold {REC_THRESHOLD}); bag "
            f"{os.path.getsize(paths['bag']) / 2**20:.1f} MiB (bz2 chunks), events npz "
            f"{os.path.getsize(paths['events']) / 2**20:.1f} MiB, in "
            f"{time.perf_counter() - t0:.1f} s")
        if rec["events"] < REC_MIN_EVENTS:
            raise AssertionError(f"real (a): {rec['events']} events, fewer than {REC_MIN_EVENTS}")

        # ---- (b) both ingest routes
        clips = {"bag": os.path.join(tmp, "clips", "davis346.npz"),
                 "events": os.path.join(tmp, "clips_events", "davis346.npz")}
        t0 = time.perf_counter()
        ingest.main(["bag", paths["bag"], "--output_dir", os.path.dirname(clips["bag"]),
                     "--image_topic", "/dvs/image_raw", "--zero_timestamps"])
        for name, col in (("exposure_begin_t", "0"), ("exposure_end_t", "1")):
            ingest.main(["set-array", "--clip", clips["bag"], "--name", name, "--values",
                         paths["exposures"], "--column", col])
        seconds = {"bag": time.perf_counter() - t0}
        os.makedirs(os.path.dirname(clips["events"]))
        t0 = time.perf_counter()
        ingest.main(["events", "--events", paths["events"], "--frames_dir", paths["frames"],
                     "--timestamps", paths["timestamps"], "--exposures", paths["exposures"],
                     "--output", clips["events"]])
        seconds["events"] = time.perf_counter() - t0
        with np.load(clips["bag"]) as a, np.load(clips["events"]) as b:
            names = sorted(a.files)
            same = names == sorted(b.files) and all(
                a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                and a[k].tobytes() == b[k].tobytes() for k in names)
            n_ori = len(a["ori_ts"])
        for route, sec in seconds.items():
            log(f"real (b) ingest {route}: {sec:.2f} s host, {n_ori / sec:.0f} events/s; host "
                f"{host_cpu()}")
        ok = same and n_ori == rec["events"] and "exposure_begin_t" in names
        log(f"check real (b): the bag route (exposures through set-array) and the events route "
            f"give equal clips, array for array ({len(names)} arrays, {n_ori} events) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("real (b): the two ingest routes disagree")
        clip = clips["bag"]

        # ---- (c) the real-blur CLI, f32 and bf16
        model = init_weights(build_model(MODEL_CFG), SEED)
        ckpt = os.path.join(tmp, "model.pt")
        save_checkpoint(ckpt, model, {"model": MODEL_CFG})
        expect = {"f32": ("fac", None), "bf16": ("mod_fac_shared", "wgmma_bf16")}
        for precision, (kernel, route) in expect.items():
            o = os.path.join(tmp, f"out_{precision}")
            torch.cuda.reset_peak_memory_stats()
            summary, wall, counts, routes = run_cli(cli, kern, torch, ckpt, clip, o,
                                                    ["--precision", precision],
                                                    flags=REAL_BLUR_FLAGS)
            band = kern.band_launch_counts()
            stats = summary["timings"]
            img = os.path.join(o, os.path.basename(clip), "img")
            n_restored = len(os.listdir(os.path.join(img, "restored_frame")))
            n_gt = len(os.listdir(os.path.join(img, "gt_frame")))
            n_blurry = len(stats)
            others = {k: v for k, v in counts.items() if k != kernel}
            ok = (n_blurry == REC_FRAMES - 1 and n_restored == n_blurry * REAL_INTERP
                  and n_gt == 0 and counts[kernel] > 0 and not any(others.values())
                  and not any(band.values())
                  and (route is None or (routes[kernel][route] == counts[kernel])))
            mean = lambda key: sum(st[key] for st in stats) / n_blurry
            log(f"real (c) CLI {precision}: {n_blurry} blurry frames, {n_restored} restored frames "
                f"in {wall:.2f} s wall, {n_restored / wall:.2f} restored frames/s end to end; per "
                f"blurry frame: host fetch {mean('fetch_ms'):.1f} ms, device "
                f"{mean('device_ms'):.1f} ms, host waiting {mean('sync_ms'):.1f} ms, emit "
                f"{mean('emit_ms'):.1f} ms, CLI wall {mean('wall_ms'):.1f} ms; launches {counts}; "
                f"routes {routes}; max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host {host_cpu()}")
            log(f"check real (c) {precision}: {REAL_INTERP} restored frames per blurry frame, no "
                f"GT frame, {kernel}{'' if route is None else ' on ' + route} launched and no "
                f"other FAC kernel {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"real (c): the {precision} real-blur CLI run did not go as "
                                     "expected")
            packed = kern.modification_fac_fused_shared.launches_packed
            out[precision] = {"B1_fac": counts["fac"], "B3_mod_fac": counts["mod_fac"],
                              "B2_mod_fac_shared": counts["mod_fac_shared"] - packed,
                              "B2p_mod_fac_shared_packed": packed, "B1_fac_band": band["fac_band"]}
            shutil.rmtree(o)
        torch.cuda.empty_cache()

        # ---- (d) the kernels at this path's shapes, the card against the CPU
        window = real_blur_loader_window(clip, cli)
        hp, wp = (-(-s // 8) * 8 for s in window["blurry"].shape[3:5])  # the engine's padding
        cases = kernel_cases(torch, kern)
        for name, (B, n, dt) in (("B1_fac", (16, 1, torch.float32)),
                                 ("B2_mod_fac_shared", (1, 16, torch.bfloat16))):
            args = cases[name]["args"](B, hp, wp, dt, n)
            compare(torch, cases[name], args, f"real (d) {name} {str(dt)[6:]} B={B} N={n} "
                                              f"{hp}x{wp}x{C} K={K} (the real-blur path's shape)")
            del args
        torch.cuda.empty_cache()
        frame, event = window["blurry"][:, 0, 0], window["events"][:, 0]
        ts = window["relative_ts"][:, 0, 0][:, :: REAL_INTERP // REAL_CPU_TIMESTAMPS]
        gt_ex = window["exposure"][:, 0, 0]
        got = InferenceEngine(model, precision="f32").interpolate(
            frame, event, ts, gt_ex, outputs="final")[1].cpu()
        want = InferenceEngine(model, precision="f32", device="cpu").interpolate(
            frame, event, ts, gt_ex, outputs="final")[1]
        err = (got - want).abs().max().item()
        ok = err <= 1e-3 and bool(torch.isfinite(got).all())
        log(f"check real (d) card vs CPU f32, first blurry frame {tuple(frame.shape[1:3])}, "
            f"{ts.shape[1]} of its {REAL_INTERP} timestamps: max_abs={err:.2e} (tol 1e-3) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("real (d): the card and the CPU disagree")

        # ---- (e) the renderers
        t0 = time.perf_counter()
        stack_gif = os.path.join(tmp, "stack.gif")
        save_event_stack_movie(window["events"][0], stack_gif)
        stack_ms = 1e3 * (time.perf_counter() - t0)
        xs, ys, ev_t, ps = rec["ev"]
        cuts = np.searchsorted(ev_t, rec["img_t"][: REAL_MOVIE_WINDOWS + 1])
        windows = [(xs[a:b], ys[a:b], ev_t[a:b], ps[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
        t0 = time.perf_counter()
        cloud_gif = os.path.join(tmp, "cloud.gif")
        save_event_cloud_movie(windows, cloud_gif, frames_panel=rec["frames"][:REAL_MOVIE_WINDOWS])
        cloud_ms = 1e3 * (time.perf_counter() - t0)
        sizes = {p: os.path.getsize(p) for p in (stack_gif, cloud_gif)}
        log(f"real (e) stack movie ({window['events'].shape[-1] // 2 * window['events'].shape[1]}"
            f" frames) {stack_ms:.0f} ms, {sizes[stack_gif]} bytes; cloud movie "
            f"({len(windows)} windows of {min(len(w[0]) for w in windows)}+ events, at most 20000 "
            f"points each) {cloud_ms:.0f} ms, {sizes[cloud_gif]} bytes; host {host_cpu()}")
        if not all(n > 0 for n in sizes.values()):
            raise AssertionError("real (e): a movie is empty")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.perf_counter() - t_phase
    log(f"phase 12 took {took:.1f} s")
    return out


# ---------------------------------------------------------------------- H5 clips

H5_ITEM_SEEDS = (SEED, SEED + 17)  # 13 (b): each item at these seeds


def package_as_h5(npz, h5):
    """An npz clip's frames, timestamps, events and exposures written again
    as a schema H5 clip through ``H5Packager`` (gzip, h5py's chunk shapes):
    the event groups are the npz's (each ``down{s}`` the ori events'
    coordinates divided by s, as both packagers write them)."""
    from ebfi_tpu_torch.data.clip_dataset import open_clip
    from ebfi_tpu_torch.data.packager import SCALES, H5Packager

    c = open_clip(npz)
    scales = tuple(p for p in SCALES if f"{p}_xs" in c)
    pk = H5Packager(h5, compression="gzip")
    pk.set_metadata(tuple(int(v) for v in c["sensor_resolution"]))
    for i in range(c["images"].shape[0]):
        exposure = (c["exposure_begin_t"][i], c["exposure_end_t"][i]) \
            if "exposure_begin_t" in c else None
        pk.package_image(np.asarray(c["images"][i]), c["image_ts"][i], exposure)
    pk.package_events(*(np.asarray(c[f"ori_{a}"]) for a in ("xs", "ys", "ts", "ps")), scales)
    pk.h5.attrs["num_events"] = len(c["ori_xs"])
    pk.add_event_indices(scales)
    pk.close()


def same_items(label, a, b):
    """Items of two datasets, every array bit for bit (dtype, shape, bytes)."""
    ok = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.ascontiguousarray(a[k]).tobytes() == np.ascontiguousarray(b[k]).tobytes()
        for k in a)
    if not ok:
        bad = [k for k in a if k not in b or not np.array_equal(a[k], b[k])]
        raise AssertionError(f"h5 (b) {label}: the H5 item differs from the npz item in {bad}")


def compare_datasets(label, cls, h5, npz, cfg, seeds):
    """13 (b): every item of ``cls`` on the H5 clip against the npz clip at
    each seed, bit for bit, and the host ms per item on each route, the H5
    route's time in chunk decoding (its read, inflate and filters) apart."""
    from ebfi_tpu_torch.data import hdf5

    decode, decoding = hdf5.Dataset._decode, [0.0]

    def timed_decode(self, k):
        t0 = time.perf_counter()
        try:
            return decode(self, k)
        finally:
            decoding[0] += time.perf_counter() - t0

    t0 = time.perf_counter()
    ds_npz = cls(npz, cfg)
    t_npz = time.perf_counter() - t0
    hdf5.Dataset._decode = timed_decode
    try:
        t0 = time.perf_counter()
        ds_h5 = cls(h5, cfg)
        t_h5 = time.perf_counter() - t0
        if len(ds_h5) != len(ds_npz) or not len(ds_h5):
            raise AssertionError(f"h5 (b) {label}: {len(ds_h5)} items against {len(ds_npz)}")
        n = 0
        for seed in seeds:
            for i in range(len(ds_h5)):
                t0 = time.perf_counter()
                a = ds_h5.get(i, seed=seed + i)
                t_h5 += time.perf_counter() - t0
                t0 = time.perf_counter()
                b = ds_npz.get(i, seed=seed + i)
                t_npz += time.perf_counter() - t0
                same_items(f"{label} item {i} seed {seed + i}", a, b)
                n += 1
    finally:
        hdf5.Dataset._decode = decode
    log(f"check h5 (b) {label}: {n} items ({len(ds_h5)} x {len(seeds)} seeds), every array bit "
        f"for bit equal to the npz clip's ok; host ms per item (build included) H5 "
        f"{1e3 * t_h5 / n:.1f} (of which chunk decoding {1e3 * decoding[0] / n:.1f}), npz "
        f"{1e3 * t_npz / n:.1f}; host {host_cpu()}")


def row_launches(kern, counts):
    """Each row of the kernels line's launches in the run whose counts
    ``counts`` are, read just after it: B2's without its packed launches,
    B2p's and B1's band mode's from their own counters."""
    packed = kern.modification_fac_fused_shared.launches_packed
    return {"B1_fac": counts["fac"], "B3_mod_fac": counts["mod_fac"],
            "B2_mod_fac_shared": counts["mod_fac_shared"] - packed,
            "B2p_mod_fac_shared_packed": packed,
            "B1_fac_band": kern.band_launch_counts()["fac_band"]}


def h5_cli_runs(torch, kern, cli, ckpt, clips):
    """13 (c): the infer CLI in bf16 on the npz clip, then on the H5 clip;
    returns the H5 run's launches by row of the kernels line."""
    runs = {}
    for kind in ("npz", "h5"):
        o = clips[kind] + ".out"
        summary, wall, counts, routes = run_cli(cli, kern, torch, ckpt, clips[kind], o,
                                                ["--precision", "bf16"])
        rows = row_launches(kern, counts)
        stats = summary["timings"]
        pngs = restored_pngs(o, clips[kind])
        runs[kind] = {"pngs": {n: open(p, "rb").read() for n, p in pngs.items()},
                      "means": summary["means"], "rows": rows,
                      "fetch": [st["fetch_ms"] for st in stats]}
        ok = (len(stats) == 2 and len(pngs) == 2 * N
              and rows == {"B1_fac": 0, "B3_mod_fac": 0, "B2_mod_fac_shared": 2,
                           "B2p_mod_fac_shared_packed": 0, "B1_fac_band": 0}
              and routes["mod_fac_shared"] == {"wgmma_bf16": 2, "wgmma_3xtf32": 0})
        log(f"h5 (c) CLI bf16 on the {kind} clip: {len(stats)} blurry frames, {len(pngs)} "
            f"restored frames in {wall:.2f} s wall; host fetch ms per blurry frame "
            + ", ".join(f"{v:.1f}" for v in runs[kind]["fetch"])
            + f" (mean {sum(runs[kind]['fetch']) / len(stats):.1f}); device ms "
            + ", ".join(f"{st['device_ms']:.1f}" for st in stats)
            + f"; launches {rows}; routes {routes}; host {host_cpu()}")
        if not ok:
            raise AssertionError(f"h5 (c): the CLI run on the {kind} clip did not go as expected")
        shutil.rmtree(o)
    a, b = runs["h5"], runs["npz"]
    ok = a["pngs"] == b["pngs"] and a["means"] == b["means"]
    log(f"check h5 (c): the H5 run's {len(a['pngs'])} restored PNGs byte for byte and its "
        f"means {a['means']} equal to the npz run's {b['means']}; B2 launches "
        f"{a['rows']['B2_mod_fac_shared']} (H5) and {b['rows']['B2_mod_fac_shared']} (npz) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("h5 (c): the CLI's outputs on the H5 clip differ from the npz's")
    return a["rows"]


def h5_train_runs(torch, kern, tmp, clips):
    """13 (d): DATA_ITERS steps of phase 6's f32 training from an npz and
    from an H5 datalist; returns the H5 run's launches by row of the kernels
    line."""
    from ebfi_tpu_torch.train import cli as train_cli

    trained = {}
    with recorded_losses(train_cli) as losses:
        for kind in ("npz", "h5"):
            cfg = train_config(tmp, f"h5_{kind}", clips[kind], SHORT_RUN)
            losses.clear()
            trainer, counts, _, wall = train_run(torch, kern, f"h5 (d) {kind}", train_cli,
                                                 ["-c", cfg, "-id", f"h5_{kind}"])
            trained[kind] = {"losses": list(losses), "rows": row_launches(kern, counts),
                             "wall": wall}
            del trainer
    a, b = trained["h5"], trained["npz"]
    ok = (len(a["losses"]) == DATA_ITERS and a["losses"] == b["losses"]
          and all(np.isfinite(a["losses"]))
          and a["rows"] == b["rows"] == {"B1_fac": DATA_ITERS, "B3_mod_fac": 0,
                                         "B2_mod_fac_shared": 0, "B2p_mod_fac_shared_packed": 0,
                                         "B1_fac_band": 0})
    log(f"check h5 (d) f32 training from the H5 datalist: losses {a['losses']} vs the npz "
        f"datalist's {b['losses']} (equal required); launches {a['rows']} (B1 once per "
        f"step); run wall {a['wall']:.1f} vs {b['wall']:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("h5 (d): training from the H5 clip differs from the npz clip")
    return a["rows"]


def phase_h5_clips(torch, kern):
    """Phase 13: schema H5 clips on the card machine, read and written by the
    port's own HDF5 code (no h5py).  (a) phase 5's 33-frame 720x1280 clip
    written as npz (``write_clip_npz``, the synthesis included) and again
    as H5 through ``H5Packager`` with gzip, seconds and bytes of each; (b)
    items of the H5 datasets against the same datasets on the npz clip, bit
    for bit: ``H5ClipDataset`` on (a)'s clip with the CLI's config (noise
    on) at two seeds, ``H5ClipDatasetFast`` on phase 6's 65-frame 144x176
    clip with flips, crops and noise at three seeds, ``H5ClipDatasetReal``
    on phase 12's DAVIS346 recording (ingested from its events npz, then
    packaged as H5 with its exposures) with the RealBlur-DAVIS config; (c)
    the infer CLI in bf16 on (a)'s clip as npz, then as H5 (2 blurry frames
    x 16 timestamps, the shipped model, cuDNN deterministic): restored PNGs
    byte for byte and means equal, B2 once per blurry frame on wgmma_bf16
    in each run, each run's host fetch ms per blurry frame; (d) 3 steps of
    phase 6's f32 training (batch 8, 128x128, B1) from an npz and from an
    H5 datalist: equal losses, B1's launches.  Returns the launches of (c)'s
    and (d)'s H5 runs."""
    from ebfi_tpu_torch.data import ingest
    from ebfi_tpu_torch.data.clip_dataset import (H5ClipDataset, H5ClipDatasetFast,
                                                  H5ClipDatasetReal)
    from ebfi_tpu_torch.data.hdf5 import File
    from ebfi_tpu_torch.data.synth import write_clip_npz
    from ebfi_tpu_torch.infer import cli
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ebfi_chip_h5_")
    out = {}
    try:
        # ---- (a) phase 5's clip, npz and H5
        clips = {"npz": os.path.join(tmp, "clip720.npz"), "h5": os.path.join(tmp, "clip720.h5")}
        t0 = time.perf_counter()
        n_events = write_clip_npz(clips["npz"], num_frames=CLIP_FRAMES, H=H, W=W, seed=SEED)
        t_npz = time.perf_counter() - t0
        t0 = time.perf_counter()
        package_as_h5(clips["npz"], clips["h5"])
        t_h5 = time.perf_counter() - t0
        f = File(clips["h5"])
        frame, xs = f["ori_images/image000000000"], f["ori_events/xs"]
        log(f"h5 (a): phase 5's {CLIP_FRAMES}-frame {H}x{W} clip, {n_events} events: npz "
            f"(synthesis and np.savez) {t_npz:.1f} s, {os.path.getsize(clips['npz'])} bytes; H5 "
            f"through H5Packager (gzip 4, from the npz's arrays) {t_h5:.1f} s, "
            f"{os.path.getsize(clips['h5'])} bytes; frame chunks {frame.chunks} "
            f"({frame.n_chunks} a frame), xs chunks {xs.chunks} ({xs.n_chunks}); host {host_cpu()}")

        # ---- (b) items, H5 against npz
        cfg = cli.apply_flag_overrides(cli.default_dataloader_config(), cli.get_flags(
            ["--output_path", "unused", *CLI_FLAGS]))["dataset"]
        compare_datasets(f"H5ClipDataset {H}x{W}, the CLI's config", H5ClipDataset,
                         clips["h5"], clips["npz"], cfg, H5_ITEM_SEEDS)
        small = {"npz": os.path.join(tmp, "train.npz"), "h5": os.path.join(tmp, "train.h5")}
        frames, h, w = TRAIN_CLIP
        write_clip_npz(small["npz"], num_frames=frames, H=h, W=w, seed=SEED + 3)
        package_as_h5(small["npz"], small["h5"])
        fast_cfg = json.loads(json.dumps(cfg))
        aug = fast_cfg["data_augment"]
        aug["flip"]["enabled"] = aug["random_crop"]["enabled"] = True
        aug["random_crop"]["size"] = [128, 128]
        compare_datasets(f"H5ClipDatasetFast {h}x{w}, flips, crops and noise",
                         H5ClipDatasetFast, small["h5"], small["npz"], fast_cfg,
                         (SEED, SEED + 1, SEED + 2))
        paths, rec = synth_recording(tmp)
        real = {"npz": os.path.join(tmp, "davis346.npz"), "h5": os.path.join(tmp, "davis346.h5")}
        ingest.main(["events", "--events", paths["events"], "--frames_dir", paths["frames"],
                     "--timestamps", paths["timestamps"], "--exposures", paths["exposures"],
                     "--output", real["npz"]])
        t0 = time.perf_counter()
        package_as_h5(real["npz"], real["h5"])
        groups = [k for k in File(real["h5"]).keys() if k.endswith("_events")]
        log(f"h5 (b) the DAVIS346 recording ({rec['events']} events, event groups {groups}, "
            f"exposures) packaged as H5 in {time.perf_counter() - t0:.1f} s, "
            f"{os.path.getsize(real['h5'])} bytes")
        real_cfg = cli.apply_flag_overrides(cli.default_dataloader_config(), cli.get_flags(
            ["--output_path", "unused", *REAL_BLUR_FLAGS]))["dataset"]
        compare_datasets("H5ClipDatasetReal DAVIS346, the RealBlur-DAVIS config",
                         H5ClipDatasetReal, real["h5"], real["npz"], real_cfg, H5_ITEM_SEEDS)

        # ---- (c) the infer CLI, bf16, npz then H5; (d) 3 f32 training steps
        model = init_weights(build_model(MODEL_CFG), SEED)
        ckpt = os.path.join(tmp, "model.pt")
        save_checkpoint(ckpt, model, {"model": MODEL_CFG})
        del model
        with deterministic_cudnn(torch):
            out["cli_bf16"] = h5_cli_runs(torch, kern, cli, ckpt, clips)
            torch.cuda.empty_cache()
            out["train_f32"] = h5_train_runs(torch, kern, tmp, small)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------- main


def ptxas_summary(build_log: str):
    """One line per compiled kernel from nvcc's -Xptxas=-v log: registers,
    and spills where there are any."""
    name, spill = None, ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], ""
        elif "spill stores" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes"):
            spill = "; " + ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            # _ZN<n>_GLOBAL__N__<hash>_<file>_cu_<8 hex><len><kernel>...: keep <kernel>...
            short = name.split("_cu_")[-1][8:].lstrip("0123456789") if "_cu_" in name else name
            yield f"{short[:60]}: {ln.split('Used')[1].strip()}{spill}"
            name = None


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of a phase-7 launch
        return dp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--export-worker"]:  # phase 10 (a)'s serving process
        return export_worker(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from ebfi_tpu_torch.ops import cuda as kern
        from ebfi_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    identity = card_identity()
    log(f"card: {identity}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"watchdog {WATCHDOG_S} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("f32 convolutions and matmuls without TF32 (cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32})")

    path, seconds, build_log = build.build()
    log(f"build: {path.name} {'built in %.1f s' % seconds if seconds else 'cached'}")
    for line in ptxas_summary(build_log):
        log(f"  {line}")
    build.load_library()
    seconds = {"1-2": round(time.perf_counter() - T0, 1)}

    def timed(phase, fn, *args):
        """fn(*args), its seconds kept under ``phase`` for the closing line."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()  # room for the next phase (and phase 7's ranks)
        return out

    results = timed("3", phase_kernels, torch, kern)
    launches, routes, f32_launches = timed("4", phase_engine, torch, kern)
    for name, n in f32_launches.items():
        results[name]["f32_route"]["launches"] = n
    timed("5", phase_cli, torch, kern)
    single = timed("6", phase_train, torch, kern)
    train_launches = single["train_launches"]
    dp_launches = timed("7", phase_data_parallel, torch, kern, single)
    adv_launches = timed("8", phase_adversarial, torch, kern, single)
    gen_launches = timed("9", phase_generate, torch, kern)
    serving = timed("10", phase_serving_options, torch, kern)
    band, spatial = timed("11", phase_spatial, torch, kern)
    real = timed("12", phase_real_recording, torch, kern)
    h5 = timed("13", phase_h5_clips, torch, kern)
    log(f"seconds by phase {json.dumps(seconds)}; whole script "
        f"{time.perf_counter() - T0:.1f} s of the watchdog's {WATCHDOG_S}")
    sp_launches = {label: r["ranks"][0] for label, r in spatial.items()}  # rank 0's, per run
    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bank_conv_cudnn_ms": r["bank_conv_cudnn_ms"],
            "launches_by_route": routes.get(name), "dtype": r["dtype"], "shape": r["shape"],
            "launches_train": train_launches.get(name),
            "launches_dp_nccl": dp_launches.get(name),
            "launches_adversarial": adv_launches.get(name),
            "launches_generate": sum(gen_launches.values()),
            "launches_export": serving["export"][name],
            "launches_norm": serving["norm"] if name == "B1_fac" else 0,
            "f32_route": r.get("f32_route"),
            "launches_spatial": {label: n[KERNEL_COUNTER[name]]
                                 for label, n in sp_launches.items()},
            "launches_real": {precision: n[name] for precision, n in real.items()},
            "launches_h5": {run: n[name] for run, n in h5.items()},
        })
    b = band["float32"]
    kernels.append({
        "name": "B1_fac_band", "route": "cuda", "source": "ebfi_tpu_torch/csrc/fac.cu",
        "replaces": "ebfi_tpu/ops/pallas/fac.py:31 _fac_kernel (a band of rows, spatial "
                    "parallelism)",
        "launches": sum(n["fac_band"] for n in sp_launches.values()),
        "max_abs_err": b["max_abs_err"], "ms": b["ms"], "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
        "dtype": "float32", "shape": b["shape"], "whole_image_ms": b["whole_image_ms"],
        "whole_image_max_abs_diff": b["whole_image_max_abs_diff"], "bfloat16": band["bfloat16"],
        "launches_spatial": {label: n["fac_band"] for label, n in sp_launches.items()},
        "launches_real": {precision: n["B1_fac_band"] for precision, n in real.items()},
        "launches_h5": {run: n["B1_fac_band"] for run, n in h5.items()},
    })
    faulthandler.cancel_dump_traceback_later()
    print(identity, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   port never calls it);
4. the serving engine at 720x1280 with N = 16 timestamps and the shipped
   model's widths (random weights from a seed): (a) bf16 hoisted
   ``interpolate`` through kernel B2, (b) bf16 ``forward`` through B3,
   (c) f32 unhoisted ``interpolate`` through B1; each path's launch counts
   are reset before it and checked after it, and (a) and (b) must have
   taken the bf16 tensor-core route.  Then a profile of one steady
   request of (a): the top device kernels and their share of it.  Then
   correctness: hoisted against unhoisted at 720p in bf16, and the card
   against the CPU on a small input in f32;
5. the inference CLI on the card: (a) ``ebfi_tpu_torch.infer.cli.main``
   serves a synthetic 720x1280 clip (2 blurry frames x 16 timestamps) in
   bf16 with the shipped model from a port checkpoint, through B2 alone;
   its restored frames are held against the engine called directly, and
   the host and device time of each blurry frame is printed; (c) a model
   with FrameBasech 8 in bf16 takes the unfused path (cuDNN bank conv and
   B1), card against CPU; (b) ``python -m ebfi_tpu_torch.infer`` in f32 on a
   64x96 clip, on the card and with ``--device cpu``, outputs compared.

The line before the last is a JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
the run exits non-zero; without a CUDA card it exits 2 and prints no
result.
"""
from __future__ import annotations

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

WATCHDOG_S = 600
SEED = 0
H, W, N = 720, 1280, 16  # one request: a 720p frame, its events, 16 timestamps
REQUESTS = 3
C, K = 64, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 tensor cores
# kernel vs plain version: f32 sums reassociate (1152-deep dots); in bf16
# the plain version runs in f32 on the same bf16 inputs and the kernel's
# output (and B2's ff scratch) round to bf16, 2^-9 relative each
TOL_REL = {"float32": 2e-5, "bfloat16": 1e-2}
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


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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
    rng = np.random.default_rng(SEED)

    def fac_args(B, h, w, dt, n=1):
        x = rng.standard_normal((B, h, w, C), dtype=np.float32)
        bank = rng.standard_normal((B, h, w, K * K * C), dtype=np.float32)
        return [torch.from_numpy(a).to("cuda", dt) for a in (x, bank)] + [K]

    def mod_args(B, h, w, dt, n=1):
        ev = rng.standard_normal((B * n, h, w, C), dtype=np.float32)
        ff = rng.standard_normal((B, h, w, C), dtype=np.float32)
        wk = 0.05 * rng.standard_normal((3, 3, 2 * C, K * K * C), dtype=np.float32)
        bk = 0.1 * rng.standard_normal((K * K * C,), dtype=np.float32)
        t = [torch.from_numpy(a).to("cuda", dt) for a in (ev, ff, wk)]
        return t + [torch.from_numpy(bk).cuda(), K]

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


def compare(torch, cs, args, label: str) -> float:
    """Kernel against its plain version evaluated in f32 on the same inputs
    (B2's per frame in chunks of 4 timestamps, which bounds the plain
    version's f32 bank); raises beyond the stated tolerance."""
    dname = str(args[0].dtype).split(".")[1]
    with torch.inference_mode():
        got = cs["fn"](*args).float()
        f32 = [a.float() if torch.is_tensor(a) else a for a in args]
        if cs["shared"]:  # frame by frame, its timestamps four at a time
            ev, ff = f32[0], f32[1]
            n = ev.shape[0] // ff.shape[0]
            ref = torch.cat([cs["plain"](ev[b * n + i : b * n + min(i + 4, n)], ff[b : b + 1],
                                         *f32[2:])
                             for b in range(ff.shape[0]) for i in range(0, n, 4)])
        else:
            ref = cs["plain"](*f32)
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
    return results


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


def breakdown(torch, label, call, top=12):
    """Where one steady request's time goes: torch.profiler's device-side
    events (kernels, copies, memsets) summed by name, the top ones with
    their share of the request's wall time, and the device's idle share.
    Fails if the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = per.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy_ms = sum(v[0] for v in per.values())
    if busy_ms <= 0:
        raise AssertionError(f"breakdown {label}: torch.profiler recorded no device time")
    log(f"breakdown {label} (torch.profiler, one steady request): wall {wall_ms:.1f} ms "
        f"under the profiler, device busy {busy_ms:.1f} ms, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f} %; {len(per)} kernel names, "
        f"{sum(v[1] for v in per.values())} launches")
    for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / wall_ms:5.1f} % of request {n:5d} launches  "
            f"{name[:110]}")


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
    _, counts, _ = serve(
        torch, kern, "(c) f32 unhoisted interpolate(outputs='final') N=16, multi_chunk=4 "
        "(bounds the materialised f32 bank to 4x360x640x1600, 5.9 GB)", "fac",
        lambda f, e, ts: f32.interpolate(f, e, ts, outputs="final")[1], requests, N,
    )
    launches["B1_fac"] = counts["fac"]
    del f32
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
    return launches, routes


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


def run_cli(cli, kern, torch, ckpt, clip, out, extra=()):
    """cli.main in this process with launch counts zeroed just before and
    read just after; returns (summary, wall s, launches, routes)."""
    datalist = out + ".txt"
    with open(datalist, "w") as f:
        f.write(clip + "\n")
    torch.cuda.synchronize()
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["--model_path", ckpt, "--data_list", datalist, "--output_path", out,
                        *CLI_FLAGS, *extra])
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
              and routes["mod_fac_shared"] == {"wgmma_bf16": n_blurry, "simt_f32": 0}
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

        # ---- (b) the real entry point in f32, on the card and on the CPU
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
                 "--precision", "f32", *(["--device", "cpu"] if dev == "cpu" else [])],
                capture_output=True, text=True, timeout=300,
            )
            log(f"cli (b) python -m ebfi_tpu_torch.infer --precision f32 on {dev}: exit "
                f"{proc.returncode} in {time.perf_counter() - t0:.1f} s")
            if proc.returncode != 0:
                raise AssertionError(f"cli (b) on {dev} failed:\n{proc.stderr[-4000:]}")
            runs[dev] = (restored_pngs(o, small), read_means(os.path.join(o, "inference_all.yml")))
        compare_outputs("cli (b) card vs CPU, f32, 64x96, the shipped model", read_png,
                        runs["cuda"], runs["cpu"], 1, 1.0, 0.01)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    results = phase_kernels(torch, kern)
    launches, routes = phase_engine(torch, kern)
    phase_cli(torch, kern)
    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bank_conv_cudnn_ms": r["bank_conv_cudnn_ms"],
            "launches_by_route": routes.get(name), "dtype": r["dtype"], "shape": r["shape"],
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

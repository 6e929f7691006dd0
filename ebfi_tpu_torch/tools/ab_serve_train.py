"""Time the serving path and the training steps of several checkouts of
the repository in one call on the card, for an A/B comparison.

    python3 -m ebfi_tpu_torch.tools.ab_serve_train DIR [DIR ...]

Runs each DIR in turn (list a checkout twice, e.g. ``parent change
change parent``, to see the spread), in a process of its own whose
working directory is DIR, with DIR's own ``chip_smoke.py`` helpers and
package, so each checkout builds and times its own code:

- ``serve_ms``: ``chip_smoke.py`` phase 4 (a), the shipped model in bf16,
  ``interpolate(outputs="final")`` at 720x1280 and N = 16, steady ms per
  request (SERVE_REQUESTS requests, the first one left out);
- ``train_f32_ms`` and ``train_bf16_ms``: phase 6 (a) and (b), the train
  CLI on the shipped config (batch 8, 128x128 crops) in f32 and in bf16
  with FastVariants, steady ms per iteration (``chip_smoke.steady_step_ms``).

Prints one JSON line per run, with the card's name and power limit.
TF32 is off, as in ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SERVE_REQUESTS = 6

WORKER = r"""
import json, os, shutil, sys, tempfile, time
import numpy as np
import torch
import chip_smoke as c
from ebfi_tpu_torch.infer import InferenceEngine
from ebfi_tpu_torch.models import build_model, init_weights
from ebfi_tpu_torch.ops.cuda import build
from ebfi_tpu_torch.data.synth import write_clip_npz
from ebfi_tpu_torch.train import cli as train_cli

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
build.build()
build.load_library()
out = {"dir": os.getcwd(), "card": c.card_identity()}

model = init_weights(build_model(c.MODEL_CFG), c.SEED)
engine = InferenceEngine(model, precision="bf16")
rng = np.random.default_rng(c.SEED + 1)
requests = [c.make_request(torch, rng) for _ in range(int(sys.argv[1]))]
times = []
for req in requests:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.interpolate(*req, outputs="final")
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
out["serve_ms"] = sum(times[1:]) / len(times[1:])
out["serve_ms_each"] = times
del engine, requests
torch.cuda.empty_cache()

tmp = tempfile.mkdtemp(prefix="ebfi_ab_")
try:
    clip = os.path.join(tmp, "clip.npz")
    frames, h, w = c.TRAIN_CLIP
    write_clip_npz(clip, num_frames=frames, H=h, W=w, seed=c.SEED + 3)
    short = {"trainer;iteration_based_train;iterations": 2, "trainer;do_validation": False,
             "trainer;iteration_based_train;save_period": 1000}
    for key, extra in (("train_f32_ms", {}),
                       ("train_bf16_ms", {"model;args;FastVariants": True,
                                          "trainer;precision": "bf16"})):
        cfg = c.train_config(tmp, key, clip, {**short, **extra})
        trainer = train_cli.main(["-c", cfg, "-id", key])
        out[key] = c.steady_step_ms(torch, trainer)[0]
        del trainer
        torch.cuda.empty_cache()
finally:
    shutil.rmtree(tmp, ignore_errors=True)
print("AB " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    dirs = (sys.argv[1:] if argv is None else argv)
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    for d in dirs:
        d = os.path.abspath(d)
        env = dict(os.environ, PYTHONPATH=d)
        proc = subprocess.run([sys.executable, "-c", WORKER, str(SERVE_REQUESTS)], cwd=d,
                              env=env, capture_output=True, text=True, timeout=1200)
        lines = [ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"{d}: exited {proc.returncode}")
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

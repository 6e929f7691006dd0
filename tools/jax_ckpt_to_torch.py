"""Convert a JAX package checkpoint (Orbax, as ``python -m ebfi_tpu.train``
writes it) into a checkpoint of the PyTorch port
(``ebfi_tpu_torch.utils.checkpoint``): the flax parameters go through
``ebfi_tpu_torch.models.params_from_jax`` into the port's module, built
from the checkpoint's own model config and loaded with strict=True.

Runs on a CPU machine that has both packages (JAX, Orbax, PyYAML, torch).

Usage:
  python tools/jax_ckpt_to_torch.py --jax_ckpt out/models/.../checkpoint-iteration100000 \
      --output model.pt
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(jax_ckpt: str, output: str) -> None:
    import jax

    from ebfi_tpu.train.checkpoint import restore_checkpoint
    from ebfi_tpu_torch.models import build_model, params_from_jax
    from ebfi_tpu_torch.utils.checkpoint import save_checkpoint

    restored = restore_checkpoint(jax_ckpt)
    config = restored["meta"]["config"]
    params = jax.tree.map(np.asarray, restored["model_states"])
    model = build_model(config["model"])
    model.load_state_dict(params_from_jax(params), strict=True)
    save_checkpoint(output, model, config)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax_ckpt", required=True, help="Orbax checkpoint directory")
    ap.add_argument("--output", required=True, help="port checkpoint file to write")
    flags = ap.parse_args(argv)
    convert(flags.jax_ckpt, flags.output)
    print(f"{flags.jax_ckpt} -> {flags.output}")


if __name__ == "__main__":
    main()

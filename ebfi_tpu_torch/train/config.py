"""Config system (port of ``ebfi_tpu/train/config.py``).

Loads a YAML config with :mod:`ebfi_tpu_torch.utils.yaml_lite` (the port
does not depend on PyYAML), applies overrides addressed by ``"a;b;c"`` key
paths, creates ``<output_path>/models/<experiment>/<run id>`` and
``<output_path>/logs/<experiment>/<run id>``, snapshots the resolved
config as ``config.yml`` in the log directory (``utils/logger.py``'s
``dump_yaml``), and sets up logging.
"""
from __future__ import annotations

import argparse
import os
from functools import reduce
from typing import Any, Dict, Optional

from ..utils.logger import dump_yaml, setup_logging
from ..utils.yaml_lite import load_file


class ConfigParser:
    def __init__(self, config: Dict[str, Any], run_id: Optional[str] = None,
                 resume: Optional[str] = None, make_dirs: bool = True):
        self.config = config
        self.resume = resume
        self.reset = False
        self.device = "cuda"
        self.run_id = run_id or "default"
        output = config.get("trainer", {}).get("output_path", "out")
        exper = config.get("experiment", "exp")
        self.save_dir = os.path.join(output, "models", exper, self.run_id)
        self.log_dir = os.path.join(output, "logs", exper, self.run_id)
        if make_dirs:
            os.makedirs(self.save_dir, exist_ok=True)
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, "config.yml"), "w") as f:
                f.write(dump_yaml(config))
            setup_logging(self.log_dir)

    @classmethod
    def from_yaml(cls, path: str, run_id=None, resume=None, overrides=None, make_dirs=True):
        config = load_file(path)
        for target, value in (overrides or {}).items():
            set_by_path(config, target, value)
        return cls(config, run_id=run_id, resume=resume, make_dirs=make_dirs)

    @classmethod
    def from_args(cls, argv=None, extra_options=()):
        """CLI: -c/--config, -id/--runid, -r/--resume, --reset, --device,
        plus registered override flags with ';'-separated target paths."""
        p = argparse.ArgumentParser(description="ebfi_tpu_torch trainer")
        p.add_argument("-c", "--config", required=True)
        p.add_argument("-id", "--runid", default=None)
        p.add_argument("-r", "--resume", default=None)
        p.add_argument("--reset", action="store_true")
        p.add_argument("--device", default="cuda",
                       help="'cuda' (the default; raises without a card) or 'cpu'")
        for flags, typ, target in extra_options:
            p.add_argument(*flags, default=None, type=typ, dest=_dest(flags))
        args = p.parse_args(argv)
        overrides = {}
        for flags, typ, target in extra_options:
            v = getattr(args, _dest(flags))
            if v is not None:
                overrides[target] = v
        parser = cls.from_yaml(args.config, run_id=args.runid, resume=args.resume,
                               overrides=overrides)
        parser.reset = args.reset
        parser.device = args.device
        return parser

    def __getitem__(self, key: str):
        return self.config[key]

    def get(self, key: str, default=None):
        return self.config.get(key, default)


def _dest(flags):
    return flags[-1].lstrip("-").replace("-", "_")


def set_by_path(tree: dict, path: str, value) -> None:
    keys = path.split(";")
    parent = reduce(lambda d, k: d.setdefault(k, {}), keys[:-1], tree)
    parent[keys[-1]] = value

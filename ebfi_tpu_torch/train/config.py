"""Config system (port of ``ebfi_tpu/train/config.py``).

Loads a YAML config with :mod:`ebfi_tpu_torch.utils.yaml_lite` (the port
does not depend on PyYAML), applies overrides addressed by ``"a;b;c"`` key
paths, creates ``<output_path>/models/<experiment>/<run id>`` and
``<output_path>/logs/<experiment>/<run id>``, snapshots the resolved
config as ``config.yml`` in the log directory (``utils/logger.py``'s
``dump_yaml``), and sets up logging (:meth:`ConfigParser.setup`).  Under
data parallelism only the primary process writes the snapshot and the
log file; the others log to the console.
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
            self.setup()

    def setup(self, primary: bool = True) -> None:
        """The run's directories, and, from the primary process, the
        ``config.yml`` snapshot and the log file."""
        os.makedirs(self.save_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        if primary:
            with open(os.path.join(self.log_dir, "config.yml"), "w") as f:
                f.write(dump_yaml(self.config))
        setup_logging(self.log_dir if primary else None)

    @classmethod
    def from_yaml(cls, path: str, run_id=None, resume=None, overrides=None, make_dirs=True):
        config = load_file(path)
        for target, value in (overrides or {}).items():
            set_by_path(config, target, value)
        return cls(config, run_id=run_id, resume=resume, make_dirs=make_dirs)

    @classmethod
    def from_args(cls, argv=None, extra_options=(), make_dirs=True):
        """CLI: -c/--config, -id/--runid, -r/--resume, --reset, --device,
        plus registered override flags with ';'-separated target paths."""
        p = argparse.ArgumentParser(description="ebfi_tpu_torch trainer")
        p.add_argument("-c", "--config", required=True,
                       help="the YAML config; its datalists (path_to_datalist_txt) name "
                            "schema H5 clips or .npz clips, one per line, mixed as they come")
        p.add_argument("-id", "--runid", default=None)
        p.add_argument("-r", "--resume", default=None)
        p.add_argument("--reset", action="store_true")
        p.add_argument("--device", default="cuda",
                       help="'cuda' (the default: the card of LOCAL_RANK under a launcher, "
                            "else card 0; raises without a card), 'cuda:N' or 'cpu'")
        for flags, typ, target in extra_options:
            p.add_argument(*flags, default=None, type=typ, dest=_dest(flags))
        args = p.parse_args(argv)
        overrides = {}
        for flags, typ, target in extra_options:
            v = getattr(args, _dest(flags))
            if v is not None:
                overrides[target] = v
        parser = cls.from_yaml(args.config, run_id=args.runid, resume=args.resume,
                               overrides=overrides, make_dirs=make_dirs)
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

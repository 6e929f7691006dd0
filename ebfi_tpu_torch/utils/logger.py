"""YAML result files of the inference CLI (port of
``ebfi_tpu/utils/logger.py``'s ``YamlResultLogger``) with a small YAML
writer of its own: the serving machine has no YAML library.

The writer covers what the CLI logs: nested dicts, lists, str, int, float,
bool and None (numpy scalars become Python ones).  Strings are written
double-quoted with escapes; floats always carry a dot before an exponent
(``1.0e-05``: YAML 1.1 readers such as PyYAML read ``1e-05`` as a string),
and NaN and infinities are ``.nan``, ``.inf`` and ``-.inf``.  Containers
inside lists are written in flow style.
"""
from __future__ import annotations

import json
import math
import os
import re

import numpy as np

# characters a YAML reader does not take raw inside a double-quoted scalar
_NONPRINTABLE = re.compile("[^\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")


def _quote(s: str) -> str:
    out = json.dumps(s, ensure_ascii=False)
    return _NONPRINTABLE.sub(lambda m: f"\\u{ord(m.group()):04x}", out)


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:
            mant, exp = r.split("e")
            r = f"{mant}.0e{exp}"
        return r
    if isinstance(v, str):
        return _quote(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_quote(str(k))}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _block(v, indent: int, lines: list) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = f"{pad}{_quote(str(k))}:"
            if isinstance(x, (dict, list)) and x:
                lines.append(key)
                _block(x, indent + 2, lines)
            else:
                lines.append(f"{key} {_flow(x)}")
    else:  # a non-empty list
        for x in v:
            lines.append(f"{pad}- {_flow(x)}")


def dump_yaml(data: dict) -> str:
    """A block-style YAML document of a dict."""
    data = _to_plain(data)
    if not data:
        return "{}\n"
    lines: list = []
    _block(data, 0, lines)
    return "\n".join(lines) + "\n"


class YamlResultLogger:
    """Accumulate info strings and named dicts; flush to a YAML file."""

    def __init__(self, path: str):
        self.path = path
        self._data: dict = {}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log_info(self, info: str) -> None:
        self._data.setdefault("info", []).append(info)

    def log_dict(self, d: dict, name: str) -> None:
        self._data[name] = _to_plain(d)

    def flush(self) -> None:
        with open(self.path, "w") as f:
            f.write(dump_yaml(self._data))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


def _to_plain(obj):
    """numpy scalars and 0-d arrays to Python scalars, tuples to lists."""
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, (np.generic, np.ndarray)) and np.ndim(obj) == 0:
        return obj.item()
    return obj

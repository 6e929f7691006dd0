"""Wall-clock and device timers with an exit summary (port of
``ebfi_tpu/utils/timers.py``).

Each timer appends its seconds to a per-name list of this process;
:func:`timing_report` summarises them, and the summary is printed at
exit.  :class:`DeviceTimer` times device work with CUDA events recorded on
the current stream, so it counts what the card ran between entry and
exit, and waits for it; on the CPU (no card, or ``device="cpu"``) it times
the host, where the work is synchronous.
"""
from __future__ import annotations

import atexit
import time
from collections import defaultdict
from typing import Dict, List

_timers: Dict[str, List[float]] = defaultdict(list)


class Timer:
    """``with Timer("name"): ...`` -> host seconds under "name"."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _timers[self.name].append(time.perf_counter() - self.t0)


class DeviceTimer:
    """``with DeviceTimer("name"): ...`` -> seconds of the device work
    issued inside, measured by CUDA events on ``device``'s current stream
    (``"cuda"`` by default, where a card is available), or of the host
    for ``"cpu"``."""

    def __init__(self, name: str, device=None):
        import torch

        self.name = name
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)

    def __enter__(self):
        import torch

        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            start, end = self._events
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - self.t0
        _timers[self.name].append(seconds)


def timing_report() -> Dict[str, Dict[str, float]]:
    """{name: {"mean_s", "total_s", "count"}} of every timer that ran."""
    return {
        name: {"mean_s": sum(vals) / len(vals), "total_s": sum(vals), "count": len(vals)}
        for name, vals in _timers.items()
        if vals
    }


def _print_report():  # pragma: no cover
    rep = timing_report()
    if rep:
        print("== timing summary ==")
        for name, s in rep.items():
            print(f"  {name}: mean {s['mean_s'] * 1e3:.2f} ms over {s['count']} calls")


atexit.register(_print_report)

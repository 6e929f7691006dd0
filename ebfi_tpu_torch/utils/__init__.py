"""Logging, metrics, timers and small helpers (port of
``ebfi_tpu/utils``)."""
from .logger import YamlResultLogger, setup_logging
from .metrics import MetricTracker
from .misc import inf_loop, normalize_event_tensor, param_count, to_uint8_image
from .timers import DeviceTimer, Timer, timing_report

__all__ = [
    "setup_logging",
    "YamlResultLogger",
    "MetricTracker",
    "Timer",
    "DeviceTimer",
    "timing_report",
    "normalize_event_tensor",
    "to_uint8_image",
    "inf_loop",
    "param_count",
]

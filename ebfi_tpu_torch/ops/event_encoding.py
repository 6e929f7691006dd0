"""Device-side event rasterizers (port of ``ebfi_tpu/ops/event_encoding.py``).

Each encoder is a scatter-add over flat indices, on whatever device its
inputs lie, with padded inputs and a count ``n_valid`` of valid events
(a prefix), so that shapes stay fixed.  Semantics, as in the JAX package:

- ``events_to_stack``: per-polarity temporal bins, each event adding
  ``p * p`` (a count of 1 for unit polarities) to the positive or the
  negative channel.  Bins are CLOSED on both sides: an event exactly on a
  shared edge lands in both neighbours.  The edges are computed in f32 in
  the JAX op order, ``t0 + delta * b`` with ``delta = (t1 - t0 + 1e-6) /
  B``, so the result equals ``ebfi_tpu.ops.events_to_stack`` bit for bit
  where the weights are integers.  (The host encoder,
  ``ebfi_tpu_torch/data/encodings.py``, computes its edges in f64: an
  event within about one f32 ulp of an edge may fall in the other bin
  there.)
- out-of-range pixels are dropped; a stream of at most 3 valid events, or
  whose valid timestamps sum to 0, gives zeros.

A dropped event is scattered as a 0.0 at index 0, which adds nothing:
the accumulation stays free of data-dependent shapes and host syncs.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Count = Union[int, torch.Tensor, None]


def _n_valid(n_valid: Count, n: int, device) -> torch.Tensor:
    if n_valid is None:
        n_valid = n
    return torch.as_tensor(n_valid, device=device).to(torch.int64)


def _pixels(xs, ys, W: int, H: int):
    """Integer pixel coordinates (truncated as the JAX ``astype`` does)
    and their in-image mask."""
    xi = xs.to(torch.float32).to(torch.int64)
    yi = ys.to(torch.float32).to(torch.int64)
    return xi, yi, (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)


def _nonzero_stream(ts: torch.Tensor, valid: torch.Tensor, n_valid: torch.Tensor):
    """The degenerate-stream guard: more than 3 valid events whose
    timestamps do not sum to 0."""
    return (torch.where(valid, ts, 0.0).sum() != 0.0) & (n_valid > 3)


def _scatter_add_(out: torch.Tensor, flat: torch.Tensor, w: torch.Tensor, keep: torch.Tensor):
    """out[flat] += w where keep, in event order as the JAX scatter."""
    return out.index_add_(0, torch.where(keep, flat, 0), torch.where(keep, w, 0.0))


def events_to_stack(xs, ys, ts, ps, num_bins: int, sensor_size: Tuple[int, int],
                    n_valid: Count = None) -> torch.Tensor:
    """(N,) coordinates, timestamps (ascending over the valid prefix) and
    polarities -> (2, num_bins, H, W) f32: [positive, negative]."""
    H, W = sensor_size
    N = ts.shape[0]
    device = ts.device
    n_valid = _n_valid(n_valid, N, device)
    valid = torch.arange(N, device=device) < n_valid
    ts = ts.to(torch.float32)
    ps = ps.to(torch.float32)
    xi, yi, in_range = _pixels(xs, ys, W, H)

    t0 = ts[0]
    t1 = ts[(n_valid - 1).clamp(min=0)]
    dt = t1 - t0 + torch.tensor(1e-6, dtype=torch.float32, device=device)
    delta = dt / torch.tensor(float(num_bins), dtype=torch.float32, device=device)
    tstart = t0 + delta * torch.arange(num_bins, dtype=torch.float32, device=device)
    tend = tstart + delta
    # the last bin with tstart <= t, the first with tend >= t
    b1 = (ts[:, None] >= tstart[None, :]).sum(dim=1) - 1
    b0 = (ts[:, None] > tend[None, :]).sum(dim=1)

    keep = valid & in_range
    pol = (ps < 0).to(torch.int64)  # 0: positive channel, 1: negative
    w = ps * ps
    b1c = b1.clamp(0, num_bins - 1)
    b0c = b0.clamp(0, num_bins - 1)
    keep1 = keep & (b1 >= 0) & (ts <= tend[b1c])
    keep0 = keep & (b0 < b1) & (b0 <= num_bins - 1) & (ts >= tstart[b0c])

    out = torch.zeros(2 * num_bins * H * W, dtype=torch.float32, device=device)
    for bins, k in ((b1c, keep1), (b0c, keep0)):
        _scatter_add_(out, ((pol * num_bins + bins) * H + yi) * W + xi, w, k)
    out = out.reshape(2, num_bins, H, W)
    return torch.where(_nonzero_stream(ts, valid, n_valid), out, torch.zeros_like(out))


def events_to_channels(xs, ys, ps, sensor_size: Tuple[int, int],
                       n_valid: Count = None) -> torch.Tensor:
    """Two-channel polarity image, (2, H, W) f32: channel 0 sums ``p * p``
    of the positive events, channel 1 of the negative ones."""
    H, W = sensor_size
    N = ps.shape[0]
    n_valid = _n_valid(n_valid, N, ps.device)
    valid = torch.arange(N, device=ps.device) < n_valid
    xi, yi, in_range = _pixels(xs, ys, W, H)
    ps = ps.to(torch.float32)
    pol = (ps < 0).to(torch.int64)
    out = torch.zeros(2 * H * W, dtype=torch.float32, device=ps.device)
    return _scatter_add_(out, (pol * H + yi) * W + xi, ps * ps, valid & in_range).reshape(2, H, W)


def events_to_mask(xs, ys, ps, sensor_size: Tuple[int, int]) -> torch.Tensor:
    """Activity mask, (H, W) f32: ``|p|`` of the LAST event at each pixel
    (the JAX scatter-set applies its updates in order).  The last event is
    found as the largest event index per pixel, which any device computes
    the same way."""
    H, W = sensor_size
    N = ps.shape[0]
    xi, yi, keep = _pixels(xs, ys, W, H)
    flat = torch.where(keep, yi * W + xi, H * W)  # the dropped events go to a spare slot
    last = torch.full((H * W + 1,), -1, dtype=torch.int64, device=ps.device)
    last.scatter_reduce_(0, flat, torch.arange(N, device=ps.device), "amax")
    last = last[: H * W]
    vals = ps.to(torch.float32).abs()[last.clamp(min=0)]
    return torch.where(last >= 0, vals, 0.0).reshape(H, W)


def events_polarity_mask(ps: torch.Tensor) -> torch.Tensor:
    """(N,) polarities -> (N, 2): [p where p > 0, -p where p < 0]."""
    ps = ps.to(torch.float32)
    return torch.stack([torch.where(ps > 0, ps, 0.0), torch.where(ps < 0, -ps, 0.0)], dim=1)


def get_hot_event_mask(event_rate: torch.Tensor, idx: int, max_px: int = 100,
                       min_obvs: int = 5, max_rate: float = 0.8) -> torch.Tensor:
    """Hot-pixel mask: zeros at the up to ``max_px`` highest-rate pixels
    whose rate exceeds ``max_rate``, once more than ``min_obvs``
    observations have accumulated; ones elsewhere."""
    if idx <= min_obvs:
        return torch.ones_like(event_rate)
    flat = event_rate.reshape(-1)
    top_vals, top_idx = torch.topk(flat, min(max_px, flat.shape[0]))
    mask = torch.ones_like(flat)
    mask.scatter_reduce_(0, top_idx, torch.where(top_vals > max_rate, 0.0, 1.0).to(flat.dtype),
                         "amin")
    return mask.reshape(event_rate.shape)


def events_to_voxel(xs, ys, ts, ps, num_bins: int, sensor_size: Tuple[int, int],
                    n_valid: Count = None) -> torch.Tensor:
    """Temporally bilinear signed voxel grid, (num_bins, H, W) f32: each
    event adds ``p * max(0, 1 - |t_n - b|)`` to bin b, with ``t_n = (t -
    t0) / (t1 - t0 + 1e-6) * (num_bins - 1)``."""
    H, W = sensor_size
    N = ts.shape[0]
    device = ts.device
    n_valid = _n_valid(n_valid, N, device)
    valid = torch.arange(N, device=device) < n_valid
    ts = ts.to(torch.float32)
    ps = ps.to(torch.float32)
    xi, yi, in_range = _pixels(xs, ys, W, H)

    t0 = ts[0]
    t1 = ts[(n_valid - 1).clamp(min=0)]
    dt = t1 - t0 + 1e-6
    t_norm = (ts - t0) / dt * (num_bins - 1)
    keep = valid & in_range
    base = yi * W + xi
    out = torch.zeros(num_bins * H * W, dtype=torch.float32, device=device)
    for bi in range(num_bins):
        wgt = (1.0 - (t_norm - bi).abs()).clamp(min=0.0) * ps
        _scatter_add_(out, bi * H * W + base, wgt, keep)
    out = out.reshape(num_bins, H, W)
    return torch.where(_nonzero_stream(ts, valid, n_valid), out, torch.zeros_like(out))

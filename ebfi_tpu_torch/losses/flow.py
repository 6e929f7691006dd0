"""Contrast-maximisation flow losses and the image of warped events (port
of ``ebfi_tpu/losses/flow.py``).

- :func:`get_interpolation` / :func:`interpolate_iwe`: events warped along
  a flow field to a reference time and scattered bilinearly (or rounded)
  into an image.
- :class:`EventWarping`: per-polarity average-timestamp contrast loss,
  forward and backward warping, plus Charbonnier flow smoothing.
- :func:`deblur_events`: the image of flow-compensated events at tref 1.
- :func:`averaged_iwe`: the per-pixel warped-event count divided by the
  number of distinct source pixels that land there.  The JAX package
  counts them on the host with ``np.unique``; here they are counted on
  the events' device (one ``torch.unique`` over (batch, polarity, source,
  destination) keys), in f64 as there, and the result is detached.

Event lists are (B, N, 4) = (ts, y, x, p); flow is NHWC (B, H, W, 2) with
channels (x, y).  Scatter indices are flat pixel indices held in floats
as in the JAX package, exact below 2^24 pixels.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _purge_unfeasible(idx: torch.Tensor, res) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the warped locations outside the image."""
    mask = ((idx[..., 0:1] >= 0) & (idx[..., 0:1] < res[0])
            & (idx[..., 1:2] >= 0) & (idx[..., 1:2] < res[1])).to(idx.dtype)
    return idx * mask, mask


def get_interpolation(events, event_flow, tref, res, flow_scaling, round_idx=False):
    """Warped (y, x) scatter indices and their weights.

    events: (B, N, 4); event_flow: (B, N, 2) as (y, x).  Returns (flat
    indices (B, 4N or N, 1), weights (B, 4N or N, 1))."""
    warped = events[:, :, 1:3] + (tref - events[:, :, 0:1]) * event_flow * flow_scaling
    if round_idx:
        idx, mask = _purge_unfeasible(torch.round(warped), res)
        weights = torch.ones_like(idx[..., :1]) * mask
    else:
        ty = torch.floor(warped[:, :, 0:1])
        lx = torch.floor(warped[:, :, 1:2])
        by, rx = ty + 1, lx + 1
        corners = torch.cat([torch.cat([ty, lx], 2), torch.cat([ty, rx], 2),
                             torch.cat([by, lx], 2), torch.cat([by, rx], 2)], dim=1)
        warped4 = torch.cat([warped] * 4, dim=1)
        # maximum, not clamp: at a tie its gradient splits in two, as JAX's
        w = torch.maximum(1.0 - (warped4 - corners).abs(), torch.zeros_like(warped4))
        idx, mask = _purge_unfeasible(corners, res)
        weights = torch.prod(w, dim=-1, keepdim=True) * mask
    flat = (idx[:, :, 0] * res[1] + idx[:, :, 1])[..., None]
    return flat, weights


def interpolate_iwe(flat_idx, weights, res, polarity_mask=None):
    """Scatter the weights into a (B, H, W, 1) image."""
    if polarity_mask is not None:
        weights = weights * polarity_mask
    B = flat_idx.shape[0]
    out = torch.zeros((B, res[0] * res[1]), dtype=weights.dtype, device=weights.device)
    out = out.scatter_add(1, flat_idx[..., 0].to(torch.int64), weights[..., 0])
    return out.reshape(B, res[0], res[1], 1)


def _event_flow_lookup(flow, events, res):
    """Each event's flow vector, as (y, x)."""
    flat = (events[:, :, 1] * res[1] + events[:, :, 2]).to(torch.int64)
    ff = flow.reshape(flow.shape[0], -1, 2)
    fx = torch.gather(ff[..., 0], 1, flat)
    fy = torch.gather(ff[..., 1], 1, flat)
    return torch.stack([fy, fx], dim=2)


class EventWarping:
    """``loss = EventWarping(w)(flow_list, event_list, pol_mask, (H, W))``."""

    def __init__(self, flow_regul_weight: float = 1.0):
        self.weight = flow_regul_weight

    def __call__(self, flow_list, event_list, pol_mask, resolution) -> torch.Tensor:
        res = resolution
        flow_scaling = max(res)
        pol4 = torch.cat([pol_mask] * 4, dim=1)
        ts4 = torch.cat([event_list[:, :, 0:1]] * 4, dim=1)
        total = 0.0
        for flow in flow_list:
            ev_flow = _event_flow_lookup(flow, event_list, res)
            loss = 0.0
            for tref, ts_w in ((1.0, ts4), (0.0, 1.0 - ts4)):
                idx, w = get_interpolation(event_list, ev_flow, tref, res, flow_scaling)
                for p in range(2):
                    pm = pol4[:, :, p:p + 1]
                    iwe = interpolate_iwe(idx, w, res, pm)
                    iwe_ts = interpolate_iwe(idx, w * ts_w, res, pm)
                    avg_ts = iwe_ts / (iwe + 1e-9)
                    loss = loss + torch.sum(avg_ts ** 2)
            dx = torch.sqrt((flow[:, :-1, :, :] - flow[:, 1:, :, :]) ** 2 + 1e-6)
            dy = torch.sqrt((flow[:, :, :-1, :] - flow[:, :, 1:, :]) ** 2 + 1e-6)
            total = total + loss + self.weight * (dx.sum() + dy.sum())
        return total


def deblur_events(flow, event_list, res, flow_scaling=128, round_idx=True, polarity_mask=None):
    """The image of flow-compensated events at tref 1, (B, H, W, 1)."""
    ev_flow = _event_flow_lookup(flow, event_list, res)
    idx, w = get_interpolation(event_list, ev_flow, 1.0, res, flow_scaling, round_idx)
    if not round_idx and polarity_mask is not None:
        polarity_mask = torch.cat([polarity_mask] * 4, dim=1)
    return interpolate_iwe(idx, w, res, polarity_mask)


@torch.no_grad()
def averaged_iwe(flow, event_list, pol_mask, res) -> torch.Tensor:
    """Per-pixel, per-polarity AVERAGE warped-event count, (B, 2, H, W)
    f32, detached: the rounded warped count divided by the number of
    distinct source pixels of the feasible events that reach the pixel."""
    B, N = event_list.shape[:2]
    device = event_list.device
    npx = res[0] * res[1]
    idx_src = (event_list[:, :, 1] * res[1] + event_list[:, :, 2]).to(torch.int64)
    ev_flow = _event_flow_lookup(flow, event_list, res)
    fw_idx, fw_w = get_interpolation(event_list, ev_flow, 1.0, res, max(res), round_idx=True)
    fw_idx = fw_idx[..., 0].to(torch.int64)
    fw_w = fw_w[..., 0].to(torch.float64)

    # (b, p) planes of the flat output; each event counts in the planes of
    # the polarities its mask selects
    plane = (torch.arange(B, device=device)[:, None, None] * 2
             + torch.arange(2, device=device)[None, None, :])          # (B, 1, 2)
    pm = pol_mask > 0                                                  # (B, N, 2)
    dest = (plane * npx + fw_idx[:, :, None]).expand(B, N, 2)
    img = torch.zeros(B * 2 * npx, dtype=torch.float64, device=device)
    img.index_add_(0, torch.where(pm, dest, 0).reshape(-1),
                   torch.where(pm, fw_w[:, :, None], 0.0).reshape(-1))

    feasible = pm & (fw_w[:, :, None] > 0)
    keys = ((plane * npx + idx_src[:, :, None]) * npx + fw_idx[:, :, None]).expand(B, N, 2)
    uniq = torch.unique(keys[feasible])
    contrib = torch.zeros(B * 2 * npx, dtype=torch.float64, device=device)
    contrib.index_add_(0, (uniq // (npx * npx)) * npx + uniq % npx,
                       torch.ones_like(uniq, dtype=torch.float64))
    img = torch.where(contrib > 0, img / contrib.clamp(min=1.0), img)
    return img.to(torch.float32).reshape(B, 2, res[0], res[1])

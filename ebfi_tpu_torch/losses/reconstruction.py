"""Self-supervised photometric-constancy reconstruction loss (port of
``ebfi_tpu/losses/reconstruction.py``): ``BrightnessConstancy``'s three
terms,

1. ``generative_model``: L2 between the predicted brightness increment
   (warped image gradients . flow) and the event increment of the
   averaged image of warped events;
2. ``temporal_consistency``: L1 warping error between consecutive
   reconstructions;
3. ``regularization``: forward-difference total variation.

The event increment comes from :func:`~.flow.averaged_iwe`, which the JAX
package computes on the host from the flow's values: a constant for
autograd there, detached here.

Images are NHWC (B, H, W, 1); flow (B, H, W, 2) with channels (x, y).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.warp import grid_sample, sobel_gradients
from .flow import averaged_iwe


class BrightnessConstancy:
    def __init__(self, resolution: Tuple[int, int], regul_weights: Sequence[float] = (0.1, 1.0)):
        self.res = resolution
        self.flow_scaling = max(resolution)
        self.weights = regul_weights
        H, W = resolution
        self.grid_y = torch.arange(H, dtype=torch.float32)[None, :, None, None].expand(1, H, W, 1)
        self.grid_x = torch.arange(W, dtype=torch.float32)[None, None, :, None].expand(1, H, W, 1)

    def _warp_grid(self, flow):
        H, W = self.res
        wy = self.grid_y.to(flow.device) - flow[..., 1:2] * self.flow_scaling
        wx = self.grid_x.to(flow.device) - flow[..., 0:1] * self.flow_scaling
        return torch.cat([2.0 * wx / (W - 1) - 1.0, 2.0 * wy / (H - 1) - 1.0], dim=-1)

    def generative_model(self, flow, img, event_cnt, event_list, pol_mask):
        flow_mask = (event_cnt.sum(dim=-1, keepdim=True) > 0).to(flow.dtype)
        flow = flow * flow_mask
        grid = self._warp_grid(flow)
        gradx, grady = sobel_gradients(img)
        wx, wy = grid_sample(gradx, grid), grid_sample(grady, grid)
        pred_delta = (wx * flow[..., 0:1] + wy * flow[..., 1:2]) * self.flow_scaling
        avg = averaged_iwe(flow.detach(), event_list, pol_mask, self.res)
        event_delta = (avg[:, 0] - avg[:, 1])[..., None]
        err = event_delta + pred_delta
        return torch.sum(torch.sum(err.reshape(err.shape[0], -1) ** 2, dim=1))

    def temporal_consistency(self, flow, prev_img, img):
        warped_prev = grid_sample(prev_img, self._warp_grid(flow))
        return self.weights[1] * torch.sum(torch.abs(img - warped_prev))

    def regularization(self, img):
        dx = torch.abs(img[:, :-1] - img[:, 1:]).sum()
        dy = torch.abs(img[:, :, :-1] - img[:, :, 1:]).sum()
        return self.weights[0] * (dx + dy)

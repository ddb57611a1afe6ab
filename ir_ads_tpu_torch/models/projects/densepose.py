"""DensePose's chart head and losses: counterpart of
ir_ads_tpu/models/projects/densepose.py (detectron2 projects/DensePose:
DensePoseV1ConvXHead, DensePoseChartPredictor, DensePoseChartLoss).

The losses gather the charts bilinearly at a static set of P points an
instance, invalid points masked.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import Conv, ConvTranspose


class DensePoseChartHead(nn.Module):
    """``num_stacked_convs`` 3x3 convs (``body_conv_fcnN``) and four 4x4
    stride-2 deconvs: (R, H, W, C) -> NHWC charts at twice the resolution,
    coarse_segm (2 channels), fine_segm, u and v (num_patches + 1 each)."""

    def __init__(self, in_channels: int, hidden_dim: int = 512, num_stacked_convs: int = 8,
                 num_coarse_segm: int = 2, num_patches: int = 24):
        super().__init__()
        self.n = num_stacked_convs
        cin = in_channels
        for i in range(num_stacked_convs):
            setattr(self, f"body_conv_fcn{i + 1}", Conv(cin, hidden_dim, 3, padding=1))
            cin = hidden_dim
        c = num_patches + 1
        self.ann_index_lowres = ConvTranspose(cin, num_coarse_segm, 4, 2)
        self.index_uv_lowres = ConvTranspose(cin, c, 4, 2)
        self.u_lowres = ConvTranspose(cin, c, 4, 2)
        self.v_lowres = ConvTranspose(cin, c, 4, 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        for i in range(self.n):
            x = F.relu(getattr(self, f"body_conv_fcn{i + 1}")(x))
        return {"coarse_segm": self.ann_index_lowres(x), "fine_segm": self.index_uv_lowres(x),
                "u": self.u_lowres(x), "v": self.v_lowres(x)}


def _bilinear_at_points(chart: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Charts (R, H, W, C) at normalised (R, P, 2) (x, y) in [0, 1]^2, corner
    pixels at 0 and 1: (R, P, C)."""
    r, h, w, c = chart.shape
    x = pts[..., 0] * (w - 1)
    y = pts[..., 1] * (h - 1)
    x0 = torch.floor(x).long().clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    bidx = torch.arange(r, device=chart.device)[:, None]
    return (chart[bidx, y0, x0] * (1 - fy) * (1 - fx) + chart[bidx, y0, x1] * (1 - fy) * fx
            + chart[bidx, y1, x0] * fy * (1 - fx) + chart[bidx, y1, x1] * fy * fx)


def densepose_losses(outputs: Dict[str, torch.Tensor], point_coords: torch.Tensor,
                     part_labels: torch.Tensor, u_targets: torch.Tensor,
                     v_targets: torch.Tensor, coarse_targets: torch.Tensor,
                     valid: torch.Tensor, *, w_segm: float = 2.0, w_part: float = 0.3,
                     w_points: float = 0.1) -> Dict[str, torch.Tensor]:
    """DensePoseChartLoss on static point sets: point_coords (R, P, 2) in
    [0, 1]^2, part_labels (R, P) in 0..24 (0 background), u / v targets
    (R, P), coarse_targets (R, Hc, Wc), valid (R, P)."""
    fine = _bilinear_at_points(outputs["fine_segm"].float(), point_coords)
    uu = _bilinear_at_points(outputs["u"].float(), point_coords)
    vv = _bilinear_at_points(outputs["v"].float(), point_coords)
    parts = part_labels.long()[..., None]

    vmask = valid.float()
    n = vmask.sum().clamp(min=1.0)
    ce = -torch.gather(F.log_softmax(fine, -1), -1, parts)[..., 0]
    loss_part = (ce * vmask).sum() / n

    # U and V: smooth L1 at the points with a body part, on that part's channel
    has_part = vmask * (part_labels > 0)
    npts = has_part.sum().clamp(min=1.0)
    up = torch.gather(uu, -1, parts)[..., 0]
    vp = torch.gather(vv, -1, parts)[..., 0]

    def smooth_l1(p, t):
        d = (p - t).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)

    loss_u = (smooth_l1(up, u_targets) * has_part).sum() / npts
    loss_v = (smooth_l1(vp, v_targets) * has_part).sum() / npts

    logp = F.log_softmax(outputs["coarse_segm"].float(), -1)
    loss_segm = (-torch.gather(logp, -1, coarse_targets.long()[..., None])[..., 0]).mean()
    return {"loss_densepose_I": w_part * loss_part, "loss_densepose_U": w_points * loss_u,
            "loss_densepose_V": w_points * loss_v, "loss_densepose_S": w_segm * loss_segm}

"""PointRend: the point head, the coarse mask head and adaptive subdivision.
Counterpart of ir_ads_tpu/models/projects/point_rend.py (detectron2
projects/PointRend: StandardPointHead, ConvFCHead, calculate_uncertainty,
point_sample and the uncertain-point samplers, PointRendMaskHead).

Static shapes as in the reference: every step works on a fixed R x P
block; a subdivision step writes its points into the upsampled mask by a
scatter.  The training-time sampler takes its uniform draws as tensors
(``point_draws`` makes them from a ``torch.Generator``), so that a caller
can give it the reference's draws.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.transformer import top_k
from ir_ads_tpu_torch.ops.grid_sample import grid_sample
from ir_ads_tpu_torch.ops.layers import Conv, Dense, resize_bilinear

Draws = Tuple[torch.Tensor, torch.Tensor]


def point_sample(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """detectron2's point_sample: bilinear at normalised [0, 1] (x, y),
    align_corners=False.  feats (N, H, W, C), coords (N, P, 2) -> (N, P, C)."""
    return grid_sample(feats, coords[:, :, None, :] * 2.0 - 1.0)[:, :, 0, :]


def calculate_uncertainty(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """-|logit of the given class|: logits (N, P, C) or (N, P, 1), classes
    (N,) -> (N, P)."""
    if logits.shape[-1] == 1:
        sel = logits[..., 0]
    else:
        sel = torch.gather(logits, -1, classes.long()[:, None, None].expand(
            -1, logits.shape[1], 1))[..., 0]
    return -sel.abs()


def get_uncertain_point_coords_on_grid(uncertainty: torch.Tensor, num_points: int
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_points`` most uncertain cells of (N, H, W): (indices (N, P)
    into H*W, cell-centre coords (N, P, 2))."""
    n, h, w = uncertainty.shape
    idx = top_k(uncertainty.reshape(n, h * w), min(num_points, h * w))[1]
    x = (idx % w).float()
    y = (idx // w).float()
    return idx, torch.stack([(x + 0.5) / w, (y + 0.5) / h], -1)


def point_draws(generator: torch.Generator, n: int, num_points: int,
                oversample_ratio: float, importance_sample_ratio: float) -> Draws:
    """The uniform draws of ``get_uncertain_point_coords_with_randomness``:
    the candidates (n, num_points * oversample_ratio, 2) and the random rest
    (n, num_points - the uncertain ones, 2), on the generator's device."""
    n_unc = int(importance_sample_ratio * num_points)
    dev = generator.device
    return (torch.rand((n, int(num_points * oversample_ratio), 2), generator=generator,
                       device=dev),
            torch.rand((n, num_points - n_unc, 2), generator=generator, device=dev))


def get_uncertain_point_coords_with_randomness(
    logits: torch.Tensor,  # (N, H, W, C) coarse logits
    classes: torch.Tensor,  # (N,)
    num_points: int,
    oversample_ratio: float,
    importance_sample_ratio: float,
    draws: Draws,
) -> torch.Tensor:
    """Training-time points: the most uncertain of the oversampled
    candidates, then uniform ones; ``draws`` as ``point_draws`` makes them."""
    coords, rand = draws
    unc = calculate_uncertainty(point_sample(logits.float(), coords), classes)
    n_unc = int(importance_sample_ratio * num_points)
    top = top_k(unc, n_unc)[1]
    certain = torch.gather(coords, 1, top[..., None].expand(-1, -1, 2))
    return torch.cat([certain, rand], 1)


def _kaiming(layer):
    nn.init.kaiming_normal_(layer.weight, mode="fan_out", nonlinearity="relu")
    return layer


class StandardPointHead(nn.Module):
    """An MLP over each point's fine features, the coarse prediction
    concatenated to every layer's input: (N, P, Cf), (N, P, classes) ->
    (N, P, classes or 1)."""

    def __init__(self, fine_channels: int, num_classes: int, fc_dim: int = 256,
                 num_fc: int = 3, coarse_pred_each_layer: bool = True,
                 cls_agnostic: bool = False):
        super().__init__()
        self.num_fc, self.each = num_fc, coarse_pred_each_layer
        cin = fine_channels + num_classes
        for k in range(num_fc):
            setattr(self, f"fc{k + 1}", _kaiming(Dense(cin, fc_dim)))
            cin = fc_dim + (num_classes if coarse_pred_each_layer else 0)
        self.predictor = Dense(cin, 1 if cls_agnostic else num_classes)
        nn.init.normal_(self.predictor.weight, std=0.001)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        dtype = self.predictor.weight.dtype  # the compute dtype, as flax's Dense casts
        coarse = coarse.to(dtype)
        x = torch.cat([fine.to(dtype), coarse], -1)
        for k in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{k + 1}")(x))
            if self.each:
                x = torch.cat([x, coarse], -1)
        return self.predictor(x)


class ConvFCHead(nn.Module):
    """The coarse mask head: 1x1 channel reduction (where the input is wider
    than ``conv_dim``), 2x2 stride-2 conv, FCs, then (R, side, side,
    classes).  ``in_side`` is the pooled input's side."""

    def __init__(self, in_channels: int, num_classes: int, in_side: int = 14,
                 conv_dim: int = 256, fc_dims: Sequence[int] = (1024, 1024),
                 output_side: int = 7):
        super().__init__()
        self.num_classes, self.output_side, self.n_fc = num_classes, output_side, len(fc_dims)
        self.reduce = in_channels > conv_dim
        if self.reduce:
            self.reduce_channel_dim_conv = _kaiming(Conv(in_channels, conv_dim, 1))
        self.reduce_spatial_dim_conv = _kaiming(
            Conv(conv_dim if self.reduce else in_channels, conv_dim, 2, 2))
        cin = conv_dim * (in_side // 2) ** 2
        for k, d in enumerate(fc_dims):
            setattr(self, f"fc{k + 1}", Dense(cin, d))
            nn.init.xavier_uniform_(getattr(self, f"fc{k + 1}").weight)
            cin = d
        self.prediction = Dense(cin, num_classes * output_side ** 2)
        nn.init.normal_(self.prediction.weight, std=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduce:
            x = F.relu(self.reduce_channel_dim_conv(x))
        x = F.relu(self.reduce_spatial_dim_conv(x)).reshape(x.shape[0], -1)
        for k in range(self.n_fc):
            x = F.relu(getattr(self, f"fc{k + 1}")(x))
        s = self.output_side
        return self.prediction(x).reshape(-1, s, s, self.num_classes)


def point_coords_wrt_image(boxes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """ROI-relative [0, 1] (x, y) -> image coordinates; boxes (R, 4) xyxy,
    coords (R, P, 2)."""
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    return torch.stack([x1 + coords[..., 0] * (x2 - x1), y1 + coords[..., 1] * (y2 - y1)], -1)


def sample_fine_features(features: torch.Tensor, feature_scale: float,
                         batch_idx: torch.Tensor, image_coords: torch.Tensor) -> torch.Tensor:
    """point_sample_fine_grained_features on one level: features (B, Hf, Wf,
    C), each ROI's image index, its image-space (R, P, 2) points -> (R, P, C),
    sampled where each ROI's image lies (no per-ROI copy of the map)."""
    b, hf, wf, c = features.shape
    norm = torch.stack([image_coords[..., 0] * feature_scale / wf,
                        image_coords[..., 1] * feature_scale / hf], -1)
    grid = norm[:, :, None, :] * 2.0 - 1.0
    return grid_sample(features, grid, batch_idx=batch_idx)[:, :, 0, :]


class PointRendMaskHead(nn.Module):
    """The coarse ConvFCHead (``coarse_head``) and the StandardPointHead
    (``point_head``), with adaptive subdivision at inference.

    Training: ``coarse`` then ``point_logits`` at points from
    ``get_uncertain_point_coords_with_randomness``; ``forward`` does both.
    Eval: ``subdivision_inference``."""

    def __init__(self, num_classes: int, in_channels: int = 256, fine_channels: int = 256,
                 in_side: int = 14, coarse_side: int = 7, subdivision_steps: int = 3,
                 subdivision_num_points: int = 784, init_resolution: int = 7):
        super().__init__()
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.init_resolution = init_resolution
        self.coarse_head = ConvFCHead(in_channels, num_classes, in_side,
                                      output_side=coarse_side)
        self.point_head = StandardPointHead(fine_channels, num_classes)

    def forward(self, pooled: torch.Tensor, fine: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        return self.point_logits(fine, self.coarse(pooled), coords)

    def coarse(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.coarse_head(pooled)

    def point_logits(self, fine: torch.Tensor, coarse_mask: torch.Tensor,
                     coords: torch.Tensor) -> torch.Tensor:
        """fine (R, P, Cf), coarse_mask (R, S, S, C), coords (R, P, 2)."""
        return self.point_head(fine, point_sample(coarse_mask.float(), coords))

    def subdivision_inference(self, fine_fn: Callable[[torch.Tensor], torch.Tensor],
                              coarse_mask: torch.Tensor,
                              pred_classes: torch.Tensor) -> torch.Tensor:
        """From a regular ``init_resolution`` grid, upsample 2x and re-predict
        the most uncertain cells, ``subdivision_steps`` times.  ``fine_fn``
        maps ROI-relative (R, P, 2) points to (R, P, Cf) features.  Returns
        (R, S_out, S_out, C) mask logits in f32."""
        r = coarse_mask.shape[0]
        res = self.init_resolution
        xs = (torch.arange(res, dtype=torch.float32, device=coarse_mask.device) + 0.5) / res
        gx, gy = torch.meshgrid(xs, xs, indexing="xy")
        grid0 = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)[None].expand(r, res * res, 2)
        pts = self.point_logits(fine_fn(grid0), coarse_mask, grid0)
        c = pts.shape[-1]
        mask = pts.float().reshape(r, res, res, c)
        for _ in range(self.subdivision_steps):
            h, w = mask.shape[1] * 2, mask.shape[2] * 2
            mask = resize_bilinear(mask, (h, w))
            unc = calculate_uncertainty(mask.reshape(r, h * w, c), pred_classes)
            idx, coords = get_uncertain_point_coords_on_grid(unc.reshape(r, h, w),
                                                             self.subdivision_num_points)
            pts = self.point_logits(fine_fn(coords), coarse_mask, coords).float()
            flat = mask.reshape(r, h * w, c).scatter(1, idx[..., None].expand(-1, -1, c), pts)
            mask = flat.reshape(r, h, w, c)
        return mask

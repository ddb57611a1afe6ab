"""Mask R-CNN family ROI heads: counterpart of
ir_ads_tpu/detection/roi_heads.py (detectron2's MaskRCNNConvUpsampleHead,
mask_rcnn_loss / mask_rcnn_inference, KRCNNConvDeconvUpsampleHead,
keypoints_to_heatmap, keypoint_rcnn_loss, heatmaps_to_keypoints and
paste_masks_in_image).

Static shapes as in the reference: R proposals per image, slots that are
not foreground carried with weight 0.  ``heatmaps_to_keypoints`` keeps the
reference's documented divergence from detectron2: the argmax is taken on
the S x S heatmap and mapped to image coordinates with the Heckbert
half-pixel rule, without detectron2's per-ROI bicubic resize.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.rotated_boxes import roi_align
from ir_ads_tpu_torch.ops.layers import Conv, ConvTranspose, resize_bilinear


class MaskHead(nn.Module):
    """4 x (3x3 conv + ReLU) -> 2x2 stride-2 deconv + ReLU -> 1x1 class-
    specific predictor: (R, S, S, C) -> (R, 2S, 2S, num_classes)."""

    def __init__(self, in_channels: int, num_classes: int, conv_dim: int = 256,
                 num_conv: int = 4):
        super().__init__()
        self.num_conv = num_conv
        for i in range(num_conv):
            setattr(self, f"mask_fcn{i + 1}",
                    Conv(in_channels if i == 0 else conv_dim, conv_dim, 3, padding=1))
        self.deconv = ConvTranspose(conv_dim if num_conv else in_channels, conv_dim, 2)
        self.predictor = Conv(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


def crop_and_resize_masks(
    gt_masks: torch.Tensor,  # (M, H, W) bitmasks at image resolution
    boxes: torch.Tensor,  # (R, 4) xyxy image coordinates
    matched_idx: torch.Tensor,  # (R,) GT index per proposal
    mask_size: int,
) -> torch.Tensor:
    """BitMasks.crop_and_resize: each proposal's matched GT mask cropped by
    the proposal and resampled to (S, S); (R, S, S) in [0, 1].  The
    reference pools every GT mask for every proposal and keeps the matched
    one; here each proposal samples its matched mask alone (the masks as a
    batch of one-channel maps, the match as the batch index)."""
    rois = torch.cat([matched_idx.float()[:, None], boxes.float()], -1)
    return roi_align(gt_masks.float()[..., None], rois, (mask_size, mask_size), 1.0)[..., 0]


def mask_rcnn_loss(
    mask_logits: torch.Tensor,  # (R, S, S, num_classes)
    gt_classes: torch.Tensor,  # (R,) foreground class per proposal
    mask_targets: torch.Tensor,  # (R, S, S) in [0, 1]
    fg_weight: torch.Tensor,  # (R,) 1 for foreground proposals, else 0
) -> torch.Tensor:
    """Per-pixel BCE on the matched class's channel, averaged over the
    pixels of foreground proposals."""
    logits = torch.gather(mask_logits.float(), -1,
                          gt_classes.long()[:, None, None, None].expand(
                              *mask_logits.shape[:3], 1))[..., 0]
    tgt = (mask_targets > 0.5).float()
    per_pix = logits.clamp(min=0) - logits * tgt + torch.log1p(torch.exp(-logits.abs()))
    per_roi = per_pix.mean((1, 2))
    return (per_roi * fg_weight).sum() / fg_weight.sum().clamp(min=1.0)


def mask_rcnn_inference(mask_logits: torch.Tensor, pred_classes: torch.Tensor) -> torch.Tensor:
    """Sigmoid of the predicted class's channel: (R, S, S)."""
    sel = torch.gather(mask_logits, -1, pred_classes.long()[:, None, None, None].expand(
        *mask_logits.shape[:3], 1))[..., 0]
    return torch.sigmoid(sel.float())


def paste_masks_in_image(
    masks: torch.Tensor,  # (R, S, S) probabilities
    boxes: torch.Tensor,  # (R, 4) xyxy image coordinates
    image_size: Tuple[int, int],
    threshold: float = 0.5,
) -> torch.Tensor:
    """Each S x S ROI mask pasted into the image by bilinear sampling at the
    pixel centres (align_corners=False): (R, H, W) bool."""
    h, w = image_size
    r, s, _ = masks.shape
    dev = masks.device
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    img_x = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    img_y = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    gx = (img_x[None] - x1[:, None]) / (x2 - x1).clamp(min=1e-6)[:, None] * 2 - 1
    gy = (img_y[None] - y1[:, None]) / (y2 - y1).clamp(min=1e-6)[:, None] * 2 - 1
    fx = (gx + 1.0) * s / 2.0 - 0.5
    fy = (gy + 1.0) * s / 2.0 - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx1, wy1 = fx - x0, fy - y0
    iy0 = y0.clamp(0, s - 1).long()  # (R, H)
    iy1 = (y0 + 1).clamp(0, s - 1).long()
    ix0 = x0.clamp(0, s - 1).long()  # (R, W)
    ix1 = (x0 + 1).clamp(0, s - 1).long()
    rows = torch.arange(r, device=dev)[:, None, None]

    def at(yi, xi):
        return masks[rows, yi[:, :, None], xi[:, None, :]].float()

    top = at(iy0, ix0) * (1 - wx1[:, None, :]) + at(iy0, ix1) * wx1[:, None, :]
    bot = at(iy1, ix0) * (1 - wx1[:, None, :]) + at(iy1, ix1) * wx1[:, None, :]
    out = top * (1 - wy1[:, :, None]) + bot * wy1[:, :, None]
    valid = ((fy >= -1.0) & (fy <= s))[:, :, None] & ((fx >= -1.0) & (fx <= s))[:, None, :]
    return torch.where(valid, out, torch.zeros_like(out)) > threshold


class KeypointHead(nn.Module):
    """8 x (3x3 conv 512 + ReLU) -> 4x4 stride-2 deconv -> 2x bilinear
    upsample, in f32: (R, S, S, C) -> (R, 4S, 4S, K)."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_dims: Sequence[int] = (512,) * 8):
        super().__init__()
        self.n_conv = len(conv_dims)
        cin = in_channels
        for i, d in enumerate(conv_dims, 1):
            setattr(self, f"conv_fcn{i}", Conv(cin, d, 3, padding=1))
            cin = d
        self.score_lowres = ConvTranspose(cin, num_keypoints, 4, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n_conv + 1):
            x = F.relu(getattr(self, f"conv_fcn{i}")(x))
        x = self.score_lowres(x).float()
        return resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))


def keypoints_to_heatmap(
    keypoints: torch.Tensor,  # (R, K, 3) (x, y, visibility)
    rois: torch.Tensor,  # (R, 4) xyxy
    heatmap_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 structures/keypoints.py's rule (Heckbert): the flat
    heatmap index of each keypoint and whether it is a valid target."""
    x1, y1, x2, y2 = rois.unbind(-1)
    scale_x = heatmap_size / (x2 - x1).clamp(min=1e-6)
    scale_y = heatmap_size / (y2 - y1).clamp(min=1e-6)
    x, y = keypoints[..., 0], keypoints[..., 1]
    xi = torch.floor((x - x1[:, None]) * scale_x[:, None]).long()
    yi = torch.floor((y - y1[:, None]) * scale_y[:, None]).long()
    xi = torch.where(x == x2[:, None], heatmap_size - 1, xi)
    yi = torch.where(y == y2[:, None], heatmap_size - 1, yi)
    valid_loc = (xi >= 0) & (yi >= 0) & (xi < heatmap_size) & (yi < heatmap_size)
    valid = (valid_loc & (keypoints[..., 2] > 0)).long()
    return (yi * heatmap_size + xi) * valid, valid


def keypoint_rcnn_loss(
    keypoint_logits: torch.Tensor,  # (R, S, S, K)
    gt_keypoints: torch.Tensor,  # (R, K, 3)
    rois: torch.Tensor,  # (R, 4)
    fg_weight: torch.Tensor,  # (R,)
    normalizer=None,
) -> torch.Tensor:
    """Softmax cross entropy over the S*S positions for each visible
    keypoint of a foreground proposal."""
    r, s, _, k = keypoint_logits.shape
    targets, valid = keypoints_to_heatmap(gt_keypoints, rois, s)
    valid = valid.float() * fg_weight[:, None]
    logits = keypoint_logits.float().permute(0, 3, 1, 2).reshape(r * k, s * s)
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, targets.reshape(r * k, 1))[:, 0] * valid.reshape(r * k)
    denom = normalizer if normalizer is not None else valid.sum().clamp(min=1.0)
    return ce.sum() / denom


def heatmaps_to_keypoints(keypoint_logits: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """(R, K, 4) of (x, y, logit, score): the argmax on the S x S heatmap
    mapped into the ROI (module docstring)."""
    r, s, _, k = keypoint_logits.shape
    flat = keypoint_logits.float().permute(0, 3, 1, 2).reshape(r, k, s * s)
    max_logit, pos = flat.max(-1)
    score = torch.gather(torch.softmax(flat, -1), -1, pos[..., None])[..., 0]
    xi = (pos % s).float()
    yi = (pos // s).float()
    x1, y1, x2, y2 = rois.float().unbind(-1)
    wpr = (x2 - x1).clamp(min=1.0)
    hpr = (y2 - y1).clamp(min=1.0)
    x = x1[:, None] + (xi + 0.5) * wpr[:, None] / s
    y = y1[:, None] + (yi + 0.5) * hpr[:, None] / s
    return torch.stack([x, y, max_logit, score], -1)

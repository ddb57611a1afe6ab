"""Panoptic-DeepLab heads and panoptic post-processing: counterpart of
ir_ads_tpu/models/projects/panoptic_deeplab.py (detectron2
projects/Panoptic-DeepLab: PanopticDeepLabSemSegHead,
PanopticDeepLabInsEmbedHead, post_processing.py).

The post-processing has the reference's static shapes: a fixed top-k of
centres with a validity mask (ties to the lower pixel, as
``jax.lax.top_k``), each pixel given its nearest valid centre, a majority
class vote a instance (exact integer counts here, where the reference
multiplies one-hot matrices) and a per-class renumbering of the instances.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.transformer import top_k as _top_k
from ir_ads_tpu_torch.models.projects.deeplab import (
    DeepLabV3PlusHead, _predictor, add_conv_bn, conv_bn_relu, deeplab_ce_loss)
from ir_ads_tpu_torch.ops.layers import resize_bilinear


class PanopticDeepLabSemSegHead(nn.Module):
    """DeepLabV3+ decoder, two 3x3 conv + BN + ReLU, a 1x1 predictor;
    upsampled by ``common_stride`` in eval mode."""

    def __init__(self, in_channels: Sequence[int], num_classes: int, head_channels: int = 256,
                 project_channels: Sequence[int] = (32, 64),
                 decoder_channels: Sequence[int] = (256, 256, 256), common_stride: int = 4,
                 use_depthwise_separable_conv: bool = False):
        super().__init__()
        self.common_stride = common_stride
        self.decoder = DeepLabV3PlusHead(
            in_channels, None, project_channels, decoder_channels,
            use_depthwise_separable_conv=use_depthwise_separable_conv)
        d = decoder_channels[0]
        add_conv_bn(self, "head_a", d, d, 3)
        add_conv_bn(self, "head_b", d, head_channels, 3)
        self.predictor = _predictor(head_channels, num_classes)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.decoder(features, generator)
        y = self.predictor(conv_bn_relu(self, "head_b", conv_bn_relu(self, "head_a", y)))
        if not self.training:
            y = resize_bilinear(y, (y.shape[1] * self.common_stride,
                                    y.shape[2] * self.common_stride))
        return y


class PanopticDeepLabInsEmbedHead(nn.Module):
    """The instance branch: a DeepLabV3+ decoder, then a centre heatmap (1
    channel) and an offset head (2 channels, (dy, dx) to the centre); in
    eval mode both upsampled by ``common_stride``, the offsets scaled by
    it."""

    def __init__(self, in_channels: Sequence[int], head_channels: int = 32,
                 project_channels: Sequence[int] = (32, 64),
                 decoder_channels: Sequence[int] = (128, 128, 128), common_stride: int = 4):
        super().__init__()
        self.common_stride = common_stride
        self.decoder = DeepLabV3PlusHead(in_channels, None, project_channels, decoder_channels)
        d = decoder_channels[0]
        for branch in ("center", "offset"):
            add_conv_bn(self, f"{branch}_a", d, d, 3)
            add_conv_bn(self, f"{branch}_b", d, head_channels, 3)
        self.center_predictor = _predictor(head_channels, 1)
        self.offset_predictor = _predictor(head_channels, 2)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.decoder(features, generator)
        center = self.center_predictor(
            conv_bn_relu(self, "center_b", conv_bn_relu(self, "center_a", y)))
        offset = self.offset_predictor(
            conv_bn_relu(self, "offset_b", conv_bn_relu(self, "offset_a", y)))
        if not self.training:
            size = (center.shape[1] * self.common_stride, center.shape[2] * self.common_stride)
            center = resize_bilinear(center, size)
            offset = resize_bilinear(offset, size) * float(self.common_stride)
        return center, offset


def panoptic_deeplab_losses(
    sem_logits, center_pred, offset_pred, sem_target, center_target, offset_target, *,
    sem_weights=None, center_weights=None, offset_weights=None, ignore_label: int = 255,
    loss_top_k: float = 0.2, sem_weight: float = 1.0, center_weight: float = 200.0,
    offset_weight: float = 0.01,
) -> dict:
    """Semantic DeepLabCE, weighted centre MSE and weighted offset L1, each
    weighted sum divided by the sum of its weights (0 where they sum to 0)."""
    losses = {"loss_sem_seg": sem_weight * deeplab_ce_loss(
        sem_logits, sem_target, ignore_label, loss_top_k, sem_weights)}
    cw = torch.ones_like(center_target) if center_weights is None else center_weights
    mse = (center_pred[..., 0].float() - center_target) ** 2 * cw
    cw_sum = cw.sum()
    losses["loss_center"] = center_weight * torch.where(
        cw_sum > 0, mse.sum() / cw_sum.clamp(min=1e-12), torch.zeros_like(cw_sum))
    ow = torch.ones_like(offset_target[..., 0]) if offset_weights is None else offset_weights
    l1 = (offset_pred.float() - offset_target).abs().sum(-1) * ow
    ow_sum = ow.sum()
    losses["loss_offset"] = offset_weight * torch.where(
        ow_sum > 0, l1.sum() / ow_sum.clamp(min=1e-12), torch.zeros_like(ow_sum))
    return losses


def find_instance_center(center_heatmap: torch.Tensor, threshold: float = 0.1,
                         nms_kernel: int = 7, top_k: int = 200
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centres = local maxima of the (H, W) heatmap above ``threshold``:
    ((top_k, 2) (y, x), (top_k,) valid)."""
    h, w = center_heatmap.shape
    x = torch.where(center_heatmap > threshold, center_heatmap,
                    torch.full_like(center_heatmap, -1.0))
    pad = (nms_kernel - 1) // 2
    pooled = F.max_pool2d(x[None, None], nms_kernel, 1, pad)[0, 0]
    x = torch.where(x == pooled, x, torch.full_like(x, -1.0))
    scores, idx = _top_k(x.reshape(-1), top_k)
    return torch.stack([idx // w, idx % w], -1), scores > 0


def group_pixels(centers: torch.Tensor, valid: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Each pixel's id (1..K) of its nearest regressed valid centre;
    offsets (H, W, 2) as (dy, dx)."""
    h, w, _ = offsets.shape
    yy, xx = torch.meshgrid(torch.arange(h, device=offsets.device),
                            torch.arange(w, device=offsets.device), indexing="ij")
    cy, cx = yy.float() + offsets[..., 0], xx.float() + offsets[..., 1]
    c = centers.float()[:, :, None, None]
    d2 = (cy[None] - c[:, 0]) ** 2 + (cx[None] - c[:, 1]) ** 2  # (K, H, W)
    d2 = torch.where(valid[:, None, None], d2, torch.full_like(d2, float("inf")))
    return d2.argmin(0) + 1


def merge_semantic_and_instance(
    sem_seg: torch.Tensor, ins_seg: torch.Tensor, thing_seg: torch.Tensor, num_classes: int,
    num_instances: int, thing_mask_per_class: torch.Tensor, label_divisor: int = 1000,
    stuff_area: int = 2048, void_label: int = -1,
) -> torch.Tensor:
    """An instance's class is the majority class of its thing pixels; it is
    numbered 1.. within its class in instance order; stuff classes fill the
    pixels no instance holds where their area reaches ``stuff_area``."""
    sem = sem_seg.long()
    is_thing = (ins_seg > 0) & (thing_seg > 0)
    ins_eff = torch.where(is_thing, ins_seg, torch.zeros_like(ins_seg)).long()
    hist = torch.bincount((ins_eff * num_classes + sem).reshape(-1),
                          minlength=(num_instances + 1) * num_classes)
    counts = hist.reshape(num_instances + 1, num_classes)[1:]  # id 0 is stuff
    inst_class = counts.argmax(-1)
    inst_alive = counts.sum(-1) > 0
    same = (inst_class[:, None] == inst_class[None]) & inst_alive[None]
    lower = torch.ones(num_instances, num_instances, dtype=torch.bool,
                       device=sem.device).tril(-1)
    new_ids = (same & lower).sum(-1) + 1
    pan_thing = inst_class * label_divisor + new_ids
    slot = (ins_eff - 1).clamp(min=0)
    pan = torch.where(is_thing & inst_alive[slot], pan_thing[slot],
                      torch.full_like(sem, void_label))
    stuff_pix = ~is_thing
    areas = torch.bincount(torch.where(stuff_pix, sem, num_classes).reshape(-1),
                           minlength=num_classes + 1)[:num_classes]
    stuff_ok = ~thing_mask_per_class.bool() & (areas >= stuff_area)
    return torch.where(stuff_pix & stuff_ok[sem], sem * label_divisor, pan)


def get_panoptic_segmentation(
    sem_seg: torch.Tensor, center_heatmap: torch.Tensor, offsets: torch.Tensor,
    thing_mask_per_class: torch.Tensor, *, label_divisor: int = 1000, stuff_area: int = 2048,
    void_label: int = -1, threshold: float = 0.1, nms_kernel: int = 7, top_k: int = 200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The panoptic fusion: sem_seg (H, W) class ids, center_heatmap (H, W),
    offsets (H, W, 2) = (dy, dx), thing_mask_per_class (C,) bool ->
    (panoptic (H, W), centres (top_k, 2))."""
    num_classes = thing_mask_per_class.shape[0]
    thing_seg = thing_mask_per_class.long()[sem_seg.long()]
    centers, valid = find_instance_center(center_heatmap, threshold, nms_kernel, top_k)
    ins = group_pixels(centers, valid, offsets)
    ins = torch.where(valid.any(), ins * thing_seg, torch.zeros_like(ins))
    pan = merge_semantic_and_instance(sem_seg, ins, thing_seg, num_classes, top_k,
                                      thing_mask_per_class, label_divisor, stuff_area,
                                      void_label)
    return pan, centers

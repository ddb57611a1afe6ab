"""DeepLabV3 / DeepLabV3+ semantic-segmentation heads and the hard-pixel-
mining cross entropy: counterpart of ir_ads_tpu/models/projects/deeplab.py
(detectron2 projects/DeepLab: DeepLabV3Head, DeepLabV3PlusHead, DeepLabCE).

NHWC; each conv + BatchNorm + ReLU is ``{name}_conv`` and ``{name}_bn`` as
the flax module names them.  The ASPP's image-pooling branch is a global
mean, and the hard-pixel mining a top-k over every pixel's loss, as in the
reference.  The dropouts draw their masks from ``generator`` in train mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import BatchNorm, Conv, dropout, resize_bilinear


def add_conv_bn(module: nn.Module, name: str, cin: int, cout: int, kernel: int,
                dilation: int = 1) -> None:
    """Register ``{name}_conv`` (bias-free, padded to keep the size) and
    ``{name}_bn`` on ``module``."""
    pad = dilation * (kernel - 1) // 2
    setattr(module, f"{name}_conv", Conv(cin, cout, kernel, padding=pad, bias=False,
                                         dilation=dilation))
    setattr(module, f"{name}_bn", BatchNorm(cout))


def conv_bn_relu(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.relu(getattr(module, f"{name}_bn")(getattr(module, f"{name}_conv")(x)))


def _predictor(cin: int, num_classes: int) -> Conv:
    conv = Conv(cin, num_classes, 1)
    nn.init.normal_(conv.weight, std=0.001)
    return conv


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 conv, three dilated 3x3 convs and
    image pooling, concatenated and projected by a 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 dilations: Sequence[int] = (6, 12, 18), dropout: float = 0.1):
        super().__init__()
        self.n_dil, self.drop = len(dilations), dropout
        add_conv_bn(self, "b0", in_channels, out_channels, 1)
        for i, d in enumerate(dilations):
            add_conv_bn(self, f"b{i + 1}", in_channels, out_channels, 3, d)
        add_conv_bn(self, "pool", in_channels, out_channels, 1)
        add_conv_bn(self, "project", out_channels * (len(dilations) + 2), out_channels, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        branches = [conv_bn_relu(self, f"b{i}", x) for i in range(self.n_dil + 1)]
        pooled = conv_bn_relu(self, "pool", x.mean((1, 2), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        y = conv_bn_relu(self, "project", torch.cat(branches, -1))
        return dropout(y, self.drop, self.training, generator)


def deeplab_ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    top_k_percent_pixels: float = 1.0,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hard-pixel-mining cross entropy (DeepLabCE): logits (B, H, W, C),
    labels (B, H, W).  Below 1.0 only the top-k % largest pixel losses count
    (divided by k); else the sum over every pixel, ignored ones included in
    the count, as the reference's mean."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    pix = -torch.gather(logp, -1, safe[..., None])[..., 0]
    pix = torch.where(valid, pix, torch.zeros_like(pix))
    if weights is not None:
        pix = pix * weights
    flat = pix.reshape(-1)
    if top_k_percent_pixels >= 1.0:
        return flat.sum() / flat.shape[0]
    k = max(int(top_k_percent_pixels * flat.shape[0]), 1)
    return torch.topk(flat, k).values.sum() / k


class DeepLabV3Head(nn.Module):
    """ASPP on the deepest feature, a 1x1 predictor, upsampled by
    ``common_stride`` in eval mode."""

    def __init__(self, in_channels: int, num_classes: int, aspp_channels: int = 256,
                 dilations: Sequence[int] = (6, 12, 18), common_stride: int = 16,
                 dropout: float = 0.1):
        super().__init__()
        self.common_stride = common_stride
        self.aspp = ASPP(in_channels, aspp_channels, dilations, dropout)
        self.predictor = _predictor(aspp_channels, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.predictor(self.aspp(x, generator))
        if not self.training:
            y = resize_bilinear(y, (y.shape[1] * self.common_stride,
                                    y.shape[2] * self.common_stride))
        return y


class DeepLabV3PlusHead(nn.Module):
    """Encoder-decoder head: ASPP on the deepest of ``features`` (shallow to
    deep), each shallower level projected by a 1x1 conv and fused top-down
    by two 3x3 convs (or a 5x5 depthwise-separable pair).  ``num_classes``
    None gives the decoder alone (Panoptic-DeepLab's)."""

    def __init__(self, in_channels: Sequence[int], num_classes: Optional[int] = None,
                 project_channels: Sequence[int] = (48,),
                 decoder_channels: Sequence[int] = (256, 256),
                 dilations: Sequence[int] = (6, 12, 18), common_stride: int = 4,
                 dropout: float = 0.1, use_depthwise_separable_conv: bool = False):
        super().__init__()
        if len(project_channels) != len(in_channels) - 1 or len(decoder_channels) != len(
                in_channels):
            raise ValueError("DeepLabV3PlusHead: one projection a level but the deepest, "
                             "one decoder width a level")
        self.n, self.num_classes, self.common_stride = len(in_channels), num_classes, common_stride
        self.dw = use_depthwise_separable_conv
        self.aspp = ASPP(in_channels[-1], decoder_channels[-1], dilations, dropout)
        y_ch = decoder_channels[-1]
        for idx in range(self.n - 2, -1, -1):
            add_conv_bn(self, f"project_{idx}", in_channels[idx], project_channels[idx], 1)
            mid = project_channels[idx] + y_ch
            if self.dw:
                setattr(self, f"fuse_{idx}_dw", Conv(mid, mid, 5, padding=2, groups=mid,
                                                     bias=False))
                setattr(self, f"fuse_{idx}_dwbn", BatchNorm(mid))
                add_conv_bn(self, f"fuse_{idx}_pw", mid, decoder_channels[idx], 1)
            else:
                add_conv_bn(self, f"fuse_{idx}_a", mid, decoder_channels[idx], 3)
                add_conv_bn(self, f"fuse_{idx}_b", decoder_channels[idx],
                            decoder_channels[idx], 3)
            y_ch = decoder_channels[idx]
        if num_classes is not None:
            self.predictor = _predictor(y_ch, num_classes)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.aspp(features[-1], generator)
        for idx in range(self.n - 2, -1, -1):
            proj = conv_bn_relu(self, f"project_{idx}", features[idx])
            y = torch.cat([proj, resize_bilinear(y, proj.shape[1:3])], -1)
            if self.dw:
                y = F.relu(getattr(self, f"fuse_{idx}_dwbn")(getattr(self, f"fuse_{idx}_dw")(y)))
                y = conv_bn_relu(self, f"fuse_{idx}_pw", y)
            else:
                y = conv_bn_relu(self, f"fuse_{idx}_b", conv_bn_relu(self, f"fuse_{idx}_a", y))
        if self.num_classes is not None:
            y = self.predictor(y)
            if not self.training:
                y = resize_bilinear(y, (y.shape[1] * self.common_stride,
                                        y.shape[2] * self.common_stride))
        return y

"""Deviation loss and the anomaly score network: counterpart of
ir_ads_tpu/anomaly/deviation.py.

``deviation_loss`` takes the reference's 5000 N(0, 1) samples as a tensor
(``ref``) where the JAX function draws them from a key; without them it uses
the exact constants (mean 0, std 1).  Its std is the population one
(``correction=0``, as ``jnp.std``).

``AnomalyScoreNet``: a ResNet trunk (``features``, trainable BatchNorm:
batch statistics in train mode, running ones in eval mode), global average
pooling and a linear score head.  ``forward`` returns (score (B,),
pooled (B, C)).  With a ``generator`` its weights are drawn as flax
initialises the JAX module (convolutions and the head from lecun_normal:
a normal of std sqrt(1 / fan_in) truncated at two of its std and rescaled
to keep that variance; biases 0, BatchNorm scale 1), not from the same
draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ir_ads_tpu_torch.models.backbones.resnet import ResNet, resnet_feature_dim
from ir_ads_tpu_torch.ops.layers import linear

LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def deviation_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                   confidence_margin: float = 5.0,
                   ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y_pred: (B,) anomaly scores; y_true: (B,) in {0 inlier, 1 outlier};
    ``ref``: the reference's N(0, 1) samples, or None for (0, 1) exactly."""
    dev = y_pred if ref is None else (y_pred - ref.mean()) / ref.std(correction=0)
    inlier = dev.abs()
    outlier = torch.clamp(confidence_margin - dev, min=0.0)
    y = y_true.to(torch.float32)
    return torch.mean((1 - y) * inlier + y * outlier)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: variance 1 / fan_in, truncated at two std."""
    std = math.sqrt(1.0 / fan_in) / LECUN_TRUNC
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class AnomalyScoreNet(nn.Module):
    """Feature trunk + linear deviation score head; backbone in
    {resnet18, resnet50}."""

    def __init__(self, backbone: str = "resnet18",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = ResNet(backbone, out_features=("res5",), frozen_bn=False)
        self.score_head = nn.Linear(resnet_feature_dim(backbone), 1)
        if generator is not None:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, m.weight[0].numel(), generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) normalised images -> (score (B,), pooled (B, C))."""
        pooled = self.features(x)["res5"].mean(dim=(1, 2))  # GAP
        return linear(pooled, self.score_head)[..., 0], pooled

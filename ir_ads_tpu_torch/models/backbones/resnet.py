"""ResNet backbone family, NHWC in and out: counterpart of
ir_ads_tpu/models/backbones/resnet.py.

Parameter names are detectron2's (``stem.conv1``, ``res2.0.conv1`` ...,
``shortcut``), every BatchNorm folded under its convolution as ``.norm``.
``frozen_bn=True`` (the detection stack's) makes it a ``FrozenBatchNorm2d``,
its four tensors buffers: an affine map with the running statistics.
``frozen_bn=False`` (the anomaly stack's trunk) makes it an
``ops.layers.FlaxBatchNorm2d`` with eps 1e-5 and flax's momentum 0.9
(torch's 0.1): trainable weight and bias, batch statistics in train mode,
the running ones in eval mode.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import FlaxBatchNorm2d, batch_norm_eval

BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_eval(x, self.running_mean, self.running_var, self.weight,
                               self.bias, BN_EPS)


class ConvNorm(nn.Conv2d):
    """A bias-free convolution followed by its BatchNorm (``.norm``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 frozen_bn: bool = True):
        super().__init__(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.norm = (FrozenBatchNorm2d(cout) if frozen_bn
                     else FlaxBatchNorm2d(cout, eps=BN_EPS, momentum=0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, frozen_bn: bool = True):
        super().__init__()
        self.conv1 = ConvNorm(cin, features, 3, stride, frozen_bn)
        self.conv2 = ConvNorm(features, features, 3, frozen_bn=frozen_bn)
        if stride != 1 or cin != features:
            self.shortcut = ConvNorm(cin, features, 1, stride, frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(h + (self.shortcut(x) if hasattr(self, "shortcut") else x))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, frozen_bn: bool = True):
        super().__init__()
        self.conv1 = ConvNorm(cin, features, 1, frozen_bn=frozen_bn)
        self.conv2 = ConvNorm(features, features, 3, stride, frozen_bn)
        self.conv3 = ConvNorm(features, 4 * features, 1, frozen_bn=frozen_bn)
        if stride != 1 or cin != 4 * features:
            self.shortcut = ConvNorm(cin, 4 * features, 1, stride, frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(h + (self.shortcut(x) if hasattr(self, "shortcut") else x))


ARCHS = {
    # name: (block, layers, widths)
    "resnet18": (BasicBlock, (2, 2, 2, 2), (64, 128, 256, 512)),
    "resnet34": (BasicBlock, (3, 4, 6, 3), (64, 128, 256, 512)),
    "resnet50": (Bottleneck, (3, 4, 6, 3), (64, 128, 256, 512)),
    "resnet101": (Bottleneck, (3, 4, 23, 3), (64, 128, 256, 512)),
}


class _Stem(nn.Module):
    def __init__(self, frozen_bn: bool = True):
        super().__init__()
        self.conv1 = ConvNorm(3, 64, 7, 2, frozen_bn)


class ResNet(nn.Module):
    """(B, H, W, 3) -> {res2 .. res5: (B, h, w, C)} for ``out_features``."""

    def __init__(self, arch: str = "resnet50",
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 frozen_bn: bool = True):
        super().__init__()
        block, layers, widths = ARCHS[arch]
        self.out_features = tuple(out_features)
        self.stem = _Stem(frozen_bn)
        cin = 64
        for i, (n_blocks, width) in enumerate(zip(layers, widths)):
            blocks = []
            for j in range(n_blocks):
                blocks.append(block(cin, width, (1 if i == 0 else 2) if j == 0 else 1,
                                    frozen_bn))
                cin = width * block.expansion
            setattr(self, f"res{i + 2}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC map: channels-last
        h = F.max_pool2d(F.relu(self.stem.conv1(h)), 3, 2, 1)
        outs = {}
        for name in ("res2", "res3", "res4", "res5"):
            h = getattr(self, name)(h)
            if name in self.out_features:
                outs[name] = h.permute(0, 2, 3, 1)
        return outs


def resnet_feature_dim(arch: str) -> int:
    block, _, widths = ARCHS[arch]
    return widths[-1] * block.expansion

"""TridentNet: one weight applied at several dilations.  Counterpart of
ir_ads_tpu/models/projects/tridentnet.py (detectron2 projects/TridentNet:
TridentConv, TridentBottleneckBlock).

Every conv and norm of a ``TridentBottleneck`` is shared across the
branches; only the 3x3's dilation differs.  In eval mode with
``test_branch_idx`` >= 0 one branch runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import Conv, GroupNormNHWC, cast, with_bias


class TridentConv(nn.Module):
    """One (k, k, in, out) weight (``weight``, held as flax holds it),
    applied to branch i's NHWC map at ``dilations[i]``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilations: Sequence[int] = (1, 2, 3),
                 test_branch_idx: int = -1, use_bias: bool = False):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.dilations, self.test_branch_idx = tuple(dilations), test_branch_idx
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, in_channels,
                                               out_channels))
        nn.init.kaiming_uniform_(self.weight)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def num_branch(self) -> int:
        return len(self.dilations) if self.training or self.test_branch_idx == -1 else 1

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(inputs) != self.num_branch():
            raise ValueError(f"TridentConv: {len(inputs)} inputs for {self.num_branch()} "
                             "branches")
        dilations = (self.dilations if self.num_branch() > 1
                     else (self.dilations[self.test_branch_idx],))
        k = self.kernel_size
        outs = []
        for x, d in zip(inputs, dilations):
            pad = d * (k - 1) // 2
            y = F.conv2d(x.permute(0, 3, 1, 2), cast(self.weight, x).permute(3, 2, 0, 1), None,
                         self.stride, pad, d)
            outs.append(with_bias(y, cast(self.bias, x), dim=1).permute(0, 2, 3, 1))
        return outs


def _groups(ch: int) -> int:
    return 32 if ch % 32 == 0 else ch


class TridentBottleneck(nn.Module):
    """The ResNet bottleneck with a TridentConv 3x3, GroupNorm after each
    conv, a projection shortcut where the width changes; a list of branch
    maps in and out, or with ``concat_output`` the branches stacked on the
    batch axis."""

    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int,
                 dilations: Sequence[int] = (1, 2, 3), test_branch_idx: int = -1,
                 concat_output: bool = False):
        super().__init__()
        self.concat_output = concat_output
        self.conv1 = Conv(in_channels, bottleneck_channels, 1, bias=False)
        self.gn1 = GroupNormNHWC(bottleneck_channels, _groups(bottleneck_channels))
        self.conv2 = TridentConv(bottleneck_channels, bottleneck_channels, 3,
                                 dilations=dilations, test_branch_idx=test_branch_idx)
        self.gn2 = GroupNormNHWC(bottleneck_channels, _groups(bottleneck_channels))
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, bias=False)
        self.gn3 = GroupNormNHWC(out_channels, _groups(out_channels))
        self.shortcut: Optional[Conv] = (Conv(in_channels, out_channels, 1, bias=False)
                                         if in_channels != out_channels else None)

    def forward(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs] * self.conv2.num_branch()
        mids = self.conv2([F.relu(self.gn1(self.conv1(x))) for x in inputs])
        outs = []
        for x, h in zip(inputs, mids):
            h = self.gn3(self.conv3(F.relu(self.gn2(h))))
            outs.append(F.relu((self.shortcut(x) if self.shortcut is not None else x) + h))
        return torch.cat(outs, 0) if self.concat_output else outs

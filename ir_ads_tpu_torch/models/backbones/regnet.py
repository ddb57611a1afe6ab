"""RegNet-X/Y backbone: counterpart of ir_ads_tpu/models/backbones/regnet.py
(reference detectron2/modeling/backbone/regnet.py).

The quantised-linear width schedule, X-blocks (grouped bottleneck) with the
Y variant's squeeze-excitation, NHWC in and out.  Each BatchNorm is the
JAX ``BNorm``: ``frozen_bn=True`` an affine map with running statistics
(``resnet.FrozenBatchNorm2d``), ``frozen_bn=False`` flax's BatchNorm
(``ops.layers.BatchNorm``: batch statistics in train mode).  Attribute
names are the flax modules' (``a``, ``a_bn.BatchNorm_0``, ...).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.models.backbones.resnet import BN_EPS, FrozenBatchNorm2d
from ir_ads_tpu_torch.ops.layers import BatchNorm, Conv


def regnet_widths(w_0: int, w_a: float, w_m: float, depth: int,
                  q: int = 8) -> Tuple[List[int], List[int]]:
    """Per-stage (widths, depths) from the RegNet parameterisation."""
    ks = np.round(np.log((w_0 + w_a * np.arange(depth)) / w_0) / np.log(w_m))
    widths = (np.round(w_0 * np.power(w_m, ks) / q) * q).astype(int)
    stage_widths: List[int] = []
    stage_depths: List[int] = []
    for w in widths:
        if not stage_widths or stage_widths[-1] != w:
            stage_widths.append(int(w))
            stage_depths.append(1)
        else:
            stage_depths[-1] += 1
    return stage_widths, stage_depths


def adjust_widths_groups(widths: Sequence[int],
                         group_width: int) -> Tuple[List[int], List[int]]:
    """Widths divisible by their (possibly reduced) group widths (d2's
    adjust_ws_gs_comp)."""
    gs = [min(group_width, w) for w in widths]
    ws = [int(round(w / g) * g) for w, g in zip(widths, gs)]
    return ws, gs


class _NHWCFrozen(FrozenBatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BNorm(nn.Module):
    """The JAX ``BNorm``: its flax BatchNorm as ``BatchNorm_0``."""

    def __init__(self, channels: int, frozen: bool = True):
        super().__init__()
        self.BatchNorm_0 = _NHWCFrozen(channels) if frozen else BatchNorm(channels, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class XBlock(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, group_width: int,
                 se_ratio: float = 0.0, frozen_bn: bool = True):
        super().__init__()
        groups = max(width // group_width, 1)
        self.a = Conv(cin, width, 1, bias=False)
        self.a_bn = BNorm(width, frozen_bn)
        self.b = Conv(width, width, 3, stride, padding=1, groups=groups, bias=False)
        self.b_bn = BNorm(width, frozen_bn)
        self.se = se_ratio > 0
        if self.se:
            se_w = max(int(cin * se_ratio), 1)
            self.se_fc1 = Conv(width, se_w, 1)
            self.se_fc2 = Conv(se_w, width, 1)
        self.c = Conv(width, width, 1, bias=False)
        self.c_bn = BNorm(width, frozen_bn)
        if stride != 1 or cin != width:
            self.proj = Conv(cin, width, 1, stride, padding="same", bias=False)
            self.proj_bn = BNorm(width, frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.a_bn(self.a(x)))
        h = F.relu(self.b_bn(self.b(h)))
        if self.se:
            s = F.relu(self.se_fc1(h.mean((1, 2), keepdim=True)))
            h = h * torch.sigmoid(self.se_fc2(s))
        h = self.c_bn(self.c(h))
        identity = self.proj_bn(self.proj(x)) if hasattr(self, "proj") else x
        return F.relu(h + identity)


REGNET_PARAMS = {
    # name: (w_0, w_a, w_m, depth, group_width, se_ratio)
    "regnetx_400mf": (24, 24.48, 2.54, 22, 16, 0.0),
    "regnetx_1.6gf": (80, 34.01, 2.25, 18, 24, 0.0),
    "regnetx_4gf": (96, 38.65, 2.43, 23, 40, 0.0),
    "regnety_400mf": (48, 27.89, 2.09, 16, 8, 0.25),
    "regnety_4gf": (96, 31.41, 2.24, 22, 64, 0.25),
}


class RegNet(nn.Module):
    """(B, H, W, in_chans) -> {res2 .. res5} for ``out_features``."""

    def __init__(self, variant: str = "regnetx_400mf", frozen_bn: bool = True,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 in_chans: int = 3, depths: Sequence[int] = ()):
        """``depths``, when given, cuts each stage to that many blocks (a
        smaller test of the full widths)."""
        super().__init__()
        w0, wa, wm, d, gw, se = REGNET_PARAMS[variant]
        widths, stage_depths = regnet_widths(w0, wa, wm, d)
        assert len(widths) == 4, (widths, stage_depths)
        widths, gws = adjust_widths_groups(widths, gw)
        self.stage_depths = list(depths) or stage_depths
        self.out_features = tuple(out_features)
        self.stem = Conv(in_chans, 32, 3, 2, padding=1, bias=False)
        self.stem_bn = BNorm(32, frozen_bn)
        cin = 32
        for i, (w, n_blocks) in enumerate(zip(widths, self.stage_depths)):
            for j in range(n_blocks):
                setattr(self, f"s{i + 1}_b{j}",
                        XBlock(cin, w, 2 if j == 0 else 1, gws[i], se, frozen_bn))
                cin = w
        self.widths = widths

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem(x)))
        outs = {}
        for i, n_blocks in enumerate(self.stage_depths):
            for j in range(n_blocks):
                x = getattr(self, f"s{i + 1}_b{j}")(x)
            name = f"res{i + 2}"
            if name in self.out_features:
                outs[name] = x
        return outs

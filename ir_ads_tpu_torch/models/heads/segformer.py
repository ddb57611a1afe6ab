"""SegFormer all-MLP decode head, NHWC, with the fuse conv folded into the
per-level projections exactly as ir_ads_tpu/models/heads/segformer.py does:

    fuse(concat_i(resize(proj_i(f_i)))) == sum_i resize((W_fuse_i W_ci)(f_i))

Each level's projection and its block of the 1x1 fuse conv are composed (in
f32) into one matrix applied at the level's own resolution.  Parameter names
are the reference's (linear_c{k}.proj, linear_fuse.conv, linear_fuse.bn,
linear_pred).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import resize_bilinear


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class _Fuse(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)


class SegFormerHead(nn.Module):
    def __init__(self, in_dims: Sequence[int], embed_dim: int = 256,
                 num_classes: int = 19):
        super().__init__()
        self.num_levels = len(in_dims)
        for i, d in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", _Proj(d, embed_dim))
        self.linear_fuse = _Fuse(self.num_levels * embed_dim, embed_dim)
        self.linear_pred = nn.Conv2d(embed_dim, num_classes, 1)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        h, w = features[0].shape[1:3]
        nl = self.num_levels
        e = self.linear_fuse.conv.out_channels
        fuse = self.linear_fuse.conv.weight.flatten(1).float()  # (e, nl*e)
        acc = None
        for i, feat in enumerate(features):
            proj = getattr(self, f"linear_c{i + 1}").proj
            # the reference concatenates the levels reversed (c4..c1)
            blk = fuse[:, (nl - 1 - i) * e:(nl - i) * e]
            wc = (blk @ proj.weight.float()).to(feat.dtype)
            bc = (blk @ proj.bias.float()).to(feat.dtype)
            y = F.linear(feat, wc, bc)
            if i > 0:
                y = resize_bilinear(y, (h, w), align_corners=False)
            acc = y if acc is None else acc + y
        bn = self.linear_fuse.bn
        x = F.batch_norm(acc.permute(0, 3, 1, 2), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        x = torch.relu(x)
        return self.linear_pred(x).permute(0, 2, 3, 1)

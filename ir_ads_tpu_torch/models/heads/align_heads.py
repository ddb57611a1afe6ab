"""Alignment-based decode heads: counterpart of
ir_ads_tpu/models/heads/align_heads.py (SFNet's flow-aligned FPN, FaPN's
deformable feature alignment, Lawin's large-window attention pyramid).

Flow warps ride ``ops.grid_sample.grid_sample`` and FaPN's alignment
``detection.deform_conv.deform_conv2d``; Lawin's windows are ``F.unfold``'s,
in torch's channel-major tap order.  Interface, names and train mode as in
extra_heads.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.deform_conv import deform_conv2d
from ir_ads_tpu_torch.models.heads.extra_heads import PPM, ConvModule, _classify
from ir_ads_tpu_torch.ops.grid_sample import grid_sample
from ir_ads_tpu_torch.ops.layers import (
    BatchNorm, Conv, Dense, LayerNorm, avg_pool, cast, max_pool, resize_bilinear,
)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x (B, H, W, C) by a pixel flow (B, H, W, 2) as (dx, dy),
    normalised by (W, H) (reference AlignedModule.flow_warp)."""
    b, h, w, _ = flow.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy], -1)[None]
    norm = torch.tensor([w, h], dtype=torch.float32, device=x.device)
    return grid_sample(x, base + flow / norm, align_corners=False)


class AlignedModule(nn.Module):
    """SFNet flow alignment (sfnet.py:8-33): the upsampled high-level map
    warped by a flow predicted from both levels."""

    def __init__(self, cin_low: int, cin_high: int, channel: int):
        super().__init__()
        self.down_l = Conv(cin_low, channel, 1, bias=False)
        self.down_h = Conv(cin_high, channel, 1, bias=False)
        self.flow_make = Conv(2 * channel, 2, 3, padding=1, bias=False)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        size = low.shape[1:3]
        low_p = self.down_l(low)
        high_p = resize_bilinear(self.down_h(high), size, align_corners=True)
        flow = self.flow_make(torch.cat([high_p, low_p], -1))
        high_up = resize_bilinear(high, size, align_corners=True)
        return flow_warp(high_up, flow.float())


class SFHead(nn.Module):
    """SFNet head (sfnet.py:36-71)."""

    def __init__(self, in_dims: Sequence[int], channel: int = 256, num_classes: int = 19,
                 drop: float = 0.1):
        super().__init__()
        n = len(in_dims)
        self.ppm = PPM(in_dims[-1], channel)
        for i in range(n - 1):
            setattr(self, f"fpn_in_{i}", ConvModule(in_dims[i], channel, 1))
            setattr(self, f"align_{i}", AlignedModule(channel, channel, channel // 2))
            setattr(self, f"fpn_out_{i}", ConvModule(channel, channel, 3))
        self.bottleneck = ConvModule(n * channel, channel, 3)
        self.conv_seg = Conv(channel, num_classes, 1)
        self.drop = drop

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f = self.ppm(features[-1])
        fpn = [f]
        for i in reversed(range(len(features) - 1)):
            lateral = getattr(self, f"fpn_in_{i}")(features[i])
            f = lateral + getattr(self, f"align_{i}")(lateral, f)
            fpn.append(getattr(self, f"fpn_out_{i}")(f))
        fpn.reverse()
        size = fpn[0].shape[1:3]
        fpn = [fpn[0]] + [resize_bilinear(p, size, align_corners=True) for p in fpn[1:]]
        out = self.bottleneck(torch.cat(fpn, -1))
        return _classify(self, out, self.conv_seg, generator)


class FAM(nn.Module):
    """FaPN feature alignment (fapn.py:28-56): the FSM lateral, then the
    upsampled coarse map aligned by a modulated deformable 3x3 conv whose
    offsets and mask come from both.  ``dcn_kernel`` is held in flax's
    (3, 3, C, C) layout, which ``deform_conv2d`` takes."""

    def __init__(self, cin: int, channel: int):
        super().__init__()
        self.fsm_atten = Conv(cin, cin, 1, bias=False)
        self.fsm_conv = Conv(cin, channel, 1, bias=False)
        self.offset_conv = Conv(2 * channel, channel, 1, bias=False)
        self.offset_mask = Conv(channel, 3 * 9, 3, padding=1)
        nn.init.zeros_(self.offset_mask.weight)  # the reference's _init_offset
        nn.init.zeros_(self.offset_mask.bias)
        he_std = (2.0 / (9 * channel)) ** 0.5  # flax's he_normal, fan_in 3 * 3 * C
        self.dcn_kernel = nn.Parameter(torch.randn(3, 3, channel, channel) * he_std)

    def forward(self, feat_l: torch.Tensor, feat_s: torch.Tensor) -> torch.Tensor:
        atten = self.fsm_atten(feat_l.mean((1, 2), keepdim=True))
        feat_arm = self.fsm_conv(feat_l + feat_l * torch.sigmoid(atten))
        feat_up = resize_bilinear(feat_s, feat_l.shape[1:3], align_corners=False)
        guide = self.offset_conv(torch.cat([feat_arm, feat_up * 2], -1))
        o1, o2, mask = self.offset_mask(guide).chunk(3, -1)
        offsets = torch.stack([o1, o2], -1).reshape(*o1.shape[:-1], 18)
        aligned = deform_conv2d(feat_up, cast(self.dcn_kernel, feat_up), offsets,
                                torch.sigmoid(mask))
        return F.relu(aligned) + feat_arm


class FaPNHead(nn.Module):
    """FaPN head (fapn.py:59-81)."""

    def __init__(self, in_dims: Sequence[int], channel: int = 128, num_classes: int = 19,
                 drop: float = 0.1):
        super().__init__()
        dims = list(in_dims)[::-1]
        self.align_0 = ConvModule(dims[0], channel, 1)
        for i, d in enumerate(dims[1:]):
            setattr(self, f"fam_{i}", FAM(d, channel))
            setattr(self, f"output_{i}", ConvModule(channel, channel, 3))
        self.conv_seg = Conv(channel, num_classes, 1)
        self.drop = drop

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = list(features)[::-1]
        out = self.align_0(feats[0])
        for i, f in enumerate(feats[1:]):
            out = getattr(self, f"output_{i}")(getattr(self, f"fam_{i}")(f, out))
        return _classify(self, out, self.conv_seg, generator)


def _unfold(x: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    """torch ``F.unfold`` on an NHWC map -> (B, nh, nw, C*kernel*kernel),
    channel-major (c * k*k + tap)."""
    b, h, w, _ = x.shape
    nh = (h + 2 * pad - kernel) // stride + 1
    nw = (w + 2 * pad - kernel) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=pad, stride=stride)
    return cols.transpose(1, 2).reshape(b, nh, nw, -1)


class LawinAttn(nn.Module):
    """Large-window non-local attention (lawin.py:53-104): per-head token
    mixing of the context, then attention of the query window over it, the
    products in f32 cast back to the input's dtype, the softmax in f32."""

    def __init__(self, channels: int, head: int = 4, patch_sq: int = 64, reduction: int = 2):
        super().__init__()
        inter = max(channels // reduction, 1)
        self.head, self.inter = head, inter
        for i in range(head):
            setattr(self, f"position_mixing_{i}", Dense(patch_sq, patch_sq))
        self.g = Dense(channels, inter)
        self.phi = Dense(channels, inter)
        self.theta = Dense(channels, inter)
        self.conv_out = Conv(inter, channels, 1, bias=False)
        self.out_bn = BatchNorm(channels)

    def forward(self, query: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        n, qh, qw, c = query.shape
        cph = c // self.head
        ctx = context.reshape(n, -1, c)
        mixed = [getattr(self, f"position_mixing_{i}")(
            ctx[..., i * cph:(i + 1) * cph].transpose(1, 2)).transpose(1, 2)
            for i in range(self.head)]
        ctx = ctx + torch.cat(mixed, -1)
        hd = self.inter // self.head

        def heads(t):
            return t.reshape(n, -1, self.head, hd).transpose(1, 2)

        th = heads(self.theta(query.reshape(n, -1, c)))
        ph, gh = heads(self.phi(ctx)), heads(self.g(ctx))
        attn = torch.softmax((th.float() @ ph.float().transpose(-1, -2)) / hd ** 0.5, -1)
        y = (attn.to(gh.dtype).float() @ gh.float()).to(query.dtype)
        y = y.transpose(1, 2).reshape(n, qh, qw, self.inter)
        return query + self.out_bn(self.conv_out(y))


class LawinHead(nn.Module):
    """Lawin head (lawin.py:119-183): MLP fuse of levels 1-3, the short
    path, image pool and three large-window attentions (context ratios 8,
    4, 2) at level 1, then the low-level fusion with level 0.  Level 1's
    height and width must be multiples of ``patch``: below that the JAX
    head crops the query windows and fails to concatenate them with the
    uncropped paths, and this one raises ``ValueError``."""

    def __init__(self, in_dims: Sequence[int], embed_dim: int = 512, num_classes: int = 19,
                 patch: int = 8, drop: float = 0.1):
        super().__init__()
        self.linear_c2 = Dense(in_dims[1], embed_dim)
        for i, d in enumerate(in_dims[2:]):
            setattr(self, f"linear_c{i + 3}", Dense(d, embed_dim))
        self.linear_fuse = ConvModule((len(in_dims) - 1) * embed_dim, embed_dim, 1)
        self.short_path = ConvModule(embed_dim, embed_dim, 1)
        self.image_pool = ConvModule(embed_dim, embed_dim, 1)
        for r in (8, 4, 2):
            setattr(self, f"ds_norm_{r}", LayerNorm(embed_dim, eps=1e-5))
            setattr(self, f"lawin_{r}", LawinAttn(embed_dim, patch_sq=patch * patch))
        self.cat = ConvModule(5 * embed_dim, embed_dim, 1)
        self.linear_c1 = Dense(in_dims[0], 48)
        self.low_level_fuse = ConvModule(embed_dim + 48, embed_dim, 1)
        self.linear_pred = Conv(embed_dim, num_classes, 1)
        self.embed_dim, self.patch, self.drop = embed_dim, patch, drop

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = features[0].shape[0]
        h, w = features[1].shape[1:3]
        p, e = self.patch, self.embed_dim
        if h % p or w % p:
            raise ValueError(f"LawinHead: level 1 is {h}x{w}, not a multiple of patch {p} "
                             "on both sides (the reference's window concatenation fails)")
        outs = [self.linear_c2(features[1])]
        for i, feat in enumerate(features[2:]):
            outs.append(resize_bilinear(getattr(self, f"linear_c{i + 3}")(feat), (h, w),
                                        align_corners=False))
        feat = self.linear_fuse(torch.cat(outs[::-1], -1))
        short = self.short_path(feat)
        pool = self.image_pool(feat.mean((1, 2), keepdim=True)).expand_as(short)
        nh, nw = h // p, w // p
        query = feat.reshape(b, nh, p, nw, p, e).permute(0, 1, 3, 2, 4, 5).reshape(-1, p, p, e)
        lawin_outs = []
        for r in (8, 4, 2):
            pad = int((r - 1) / 2 * p)
            ctxp = _unfold(feat, p * r, p, pad).reshape(b * nh * nw, e, r * p, r * p)
            ctxp = ctxp.permute(0, 2, 3, 1)
            ctx = 0.5 * (max_pool(ctxp, r, r) + avg_pool(ctxp, r, r))
            ctx = getattr(self, f"ds_norm_{r}")(ctx)
            out = getattr(self, f"lawin_{r}")(query, ctx)
            out = out.reshape(b, nh, nw, p, p, -1).permute(0, 1, 3, 2, 4, 5)
            lawin_outs.append(out.reshape(b, nh * p, nw * p, -1))
        output = self.cat(torch.cat([short, pool] + lawin_outs, -1))
        c1 = self.linear_c1(features[0])
        output = resize_bilinear(output, features[0].shape[1:3], align_corners=False)
        fused = self.low_level_fuse(torch.cat([output, c1], -1))
        return _classify(self, fused, self.linear_pred, generator)

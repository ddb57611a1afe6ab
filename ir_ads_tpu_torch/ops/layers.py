"""Core layers of the Swin backbone, NHWC throughout (the JAX package's
layout), with the reference checkpoint's parameter names.

Counterpart of ir_ads_tpu/ops/layers.py.  LayerNorms use eps 1e-5; GELU is
the tanh approximation (flax ``nn.gelu``'s default), not torch's erf default.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def cast(p: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    """A parameter in the dtype of the activation that meets it.  The
    trainer keeps f32 master parameters and computes in bf16, as flax does
    (``promote_dtype``); the predictor's parameters are cast once, so this
    is a no-op there."""
    return p if p is None or p.dtype == like.dtype else p.to(like.dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, cast(norm.weight, x),
                        cast(norm.bias, x), 1e-5)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, cast(lin.weight, x), cast(lin.bias, x))


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on an NCHW map, its parameters cast at use."""
    return F.conv2d(x, cast(conv.weight, x), cast(conv.bias, x), conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on channels-last x, as a linear map."""
    return F.linear(x, cast(conv.weight.flatten(1), x), cast(conv.bias, x))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on the leading (batch) axis: a dropped sample's
    branch is zero, a kept one's is scaled by 1 / keep."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout drawn from an explicit generator."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train mode is flax's: statistics in f32 with the
    fast variance E[x^2] - E[x]^2, and running statistics updated with the
    BIASED batch variance (torch uses the unbiased one).  flax momentum 0.9
    is ``momentum=0.1`` here.  Eval mode is torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[None, :, None, None]) * scale[None, :, None, None]
        return (y + self.bias.float()[None, :, None, None]).to(x.dtype)


class FFN(nn.Module):
    """Two-layer MLP with residual (mmcv FFN names: ``layers.0.0`` and
    ``layers.1``); the Swin block tail kernel computes the same function."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Sequential(nn.Linear(dim, hidden)), nn.Linear(hidden, dim)]
        )

    def forward(self, x: torch.Tensor, identity: torch.Tensor,
                drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """identity + drop_path(fc2(gelu(fc1 x))): the JAX ``Mlp`` with
        ``add_identity`` (its ``drop_rate`` is 0 in every recipe)."""
        h = linear(gelu(linear(x, self.layers[0][0])), self.layers[1])
        return identity + drop_path(h, drop_path_rate, self.training, generator)


def adaptive_pad(
    x: torch.Tensor, kernel_size: Sequence[int], stride: Sequence[int]
) -> torch.Tensor:
    """Corner padding of an NHWC map so the filter covers it fully."""
    h, w = x.shape[1], x.shape[2]
    (kh, kw), (sh, sw) = kernel_size, stride
    pad_h = max((-(-h // sh) - 1) * sh + kh - h, 0)
    pad_w = max((-(-w // sw) - 1) * sw + kw - w, 0)
    if pad_h == 0 and pad_w == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_w, 0, pad_h))


class PatchEmbed(nn.Module):
    """Conv patch embedding (kernel == stride) as patchify + matmul, then
    LayerNorm.  Input (B, H, W, 3), output (B, H/p, W/p, E)."""

    def __init__(self, embed_dim: int, patch_size: int = 4, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.projection = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = adaptive_pad(x, (p, p), (p, p))
        b, h, w, c = x.shape
        xp = (
            x.reshape(b, h // p, p, w // p, p, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // p, w // p, p * p * c)
        )
        wk = self.projection.weight.permute(0, 2, 3, 1).reshape(-1, p * p * c)
        return layer_norm(F.linear(xp, cast(wk, xp), cast(self.projection.bias, xp)), self.norm)


class PatchMerging(nn.Module):
    """2x2 patch merging in torch-unfold channel order (c * 4 + ky * 2 + kx):
    LayerNorm over 4C, then a bias-free reduction to ``out_dim``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_dim, eps=1e-5)
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = adaptive_pad(x, (2, 2), (2, 2))
        b, hp, wp, c = x.shape
        x = (
            x.reshape(b, hp // 2, 2, wp // 2, 2, c)
            .permute(0, 1, 3, 5, 2, 4)
            .reshape(b, hp // 2, wp // 2, 4 * c)
        )
        return linear(layer_norm(x, self.norm), self.reduction)


def resize_bilinear(
    x: torch.Tensor, size: Sequence[int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor, torch ``F.interpolate`` semantics."""
    nh, nw = int(size[0]), int(size[1])
    if (nh, nw) == tuple(x.shape[1:3]):
        return x
    if align_corners:
        return _resize_align_corners(x, nh, nw)
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
        align_corners=False,
    )
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _axis_weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``_axis_weights`` copied to ``device`` once per size pair."""
    return torch.from_numpy(_axis_weights(n_in, n_out)).to(device)


def _axis_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_in, n_out) interpolation matrix for align_corners=True."""
    if n_in == 1 or n_out == 1:
        pos = np.zeros(n_out)
    else:
        pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = pos - lo
    mat = np.zeros((n_in, n_out), dtype=np.float32)
    mat[lo, np.arange(n_out)] += 1.0 - frac
    mat[hi, np.arange(n_out)] += frac
    return mat


def _resize_align_corners(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """align_corners=True bilinear resize as two small products, in f32."""
    wy = _axis_weights_on(x.shape[1], nh, x.device)
    wx = _axis_weights_on(x.shape[2], nw, x.device)
    xf = torch.einsum("bhwc,hH->bHwc", x.float(), wy)
    xf = torch.einsum("bHwc,wW->bHWc", xf, wx)
    return xf.to(x.dtype)

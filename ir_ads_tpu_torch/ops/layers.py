"""Core layers of the Swin backbone, NHWC throughout (the JAX package's
layout), with the reference checkpoint's parameter names.

Counterpart of ir_ads_tpu/ops/layers.py.  LayerNorms use eps 1e-5; GELU is
the tanh approximation (flax ``nn.gelu``'s default), not torch's erf default.

Normalisations compute as flax's ``_normalize`` does whatever the activation
dtype: statistics, scale, bias (and a BatchNorm's running statistics) in f32,
one rounding of the result to the input's dtype.  Their parameters stay f32
when the rest of a model is cast to bf16 (``serve.cast_model_``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.patch_embed import patch_embed, patchify_flat


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def cast(p: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    """A parameter in the dtype of the activation that meets it.  The
    trainer keeps f32 master parameters and computes in bf16, as flax does
    (``promote_dtype``); the predictor's parameters are cast once, so this
    is a no-op there."""
    return p if p is None or p.dtype == like.dtype else p.to(like.dtype)


def up(t: torch.Tensor) -> torch.Tensor:
    """f32, or f64 for f64 tensors: the dtype a normalisation computes in."""
    return t if t.dtype == torch.float64 else t.float()


@functools.lru_cache(maxsize=None)
def q_scale(scale: float, dtype: torch.dtype) -> float:
    """The attention scale as the reference multiplies q by it: JAX casts
    the Python scalar of ``(q * scale).astype(q.dtype)`` to q's dtype first,
    so in bf16 the scale is rounded to bf16 (8 ** -0.5 -> 0.353515625);
    f32 keeps it.  Every forward attention kernel and its plain version
    takes the scale through here; the backward kernels keep the exact one,
    as the reference's do.  Cached: a wrapper asks at every launch, and a
    tensor costs microseconds of host time, as much as a small kernel."""
    return float(torch.tensor(scale, dtype=dtype))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax's LayerNorm: in f32 with f32 scale and bias, rounded once."""
    return F.layer_norm(up(x), norm.normalized_shape, up(norm.weight), up(norm.bias),
                        norm.eps).to(x.dtype)


def batch_norm_eval(x: torch.Tensor, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """A BatchNorm with running statistics on an NCHW map, as flax's: in f32
    with f32 statistics and affine, rounded once.  A bf16 map goes in as it
    is: PyTorch's batch norm takes f32 parameters beside a bf16 input and
    computes in f32 (no f32 copy of the map, unlike LayerNorm and GroupNorm,
    whose CUDA kernels want one dtype)."""
    return F.batch_norm(x, up(mean), up(var), up(weight), up(bias), False, 0.0, eps)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that computes as ``layer_norm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` on NCHW that computes as flax's: in f32, rounded once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(up(x), self.num_groups, up(self.weight), up(self.bias),
                            self.eps).to(x.dtype)


def with_bias(y: torch.Tensor, bias: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """``y + bias`` as flax's ``nn.Dense`` and ``nn.Conv`` add it: to the
    product ``y`` already rounded to its dtype, then rounded again (``y =
    dot(x, k); y += b``), where ``F.linear(x, w, b)`` rounds once.  In bf16
    the two part in about 30 % of the outputs by an ulp; in f32 only by f32
    rounding.  ``dim``: y's channel axis.

    Every bias-carrying product of the port whose reference is a flax layer
    adds its bias here: ``linear``, ``pointwise`` and ``conv2d`` (the Swin
    module path's qkv and proj, the FFN, the adapters, MPG, the DSCF's
    projections, fuse_q and offset convolutions, SegFormer's linear_pred),
    ``PatchEmbed``'s xla path (``xp @ wk2 + bias``), SegFormer's composed
    projections (``feat @ wc + bc``) and the detector's dense layers, q/k/v
    projections and convolutions.  Sites whose reference rounds once keep
    one rounding: the plain versions of the kernels whose Pallas kernels add
    the bias in f32 before their one rounding (K1's qkv and proj, K2, K5,
    K10-K15, K19), and the int8 products and ``PatchEmbed``'s xla2, which
    round the product themselves before their bias, as their references
    do."""
    if bias is None:
        return y
    trailing = y.ndim - 1 - dim % y.ndim  # axes after the channel axis
    return y + bias.reshape(-1, *[1] * trailing)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` as flax's ``nn.Dense`` computes it (``with_bias``), its
    parameters cast at use."""
    return with_bias(F.linear(x, cast(lin.weight, x)), cast(lin.bias, x))


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on an NCHW map as flax's ``nn.Conv`` computes it
    (``with_bias``), its parameters cast at use."""
    y = F.conv2d(x, cast(conv.weight, x), None, conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return with_bias(y, cast(conv.bias, x), dim=1)


def pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on channels-last x, as a linear map (``with_bias``)."""
    return with_bias(F.linear(x, cast(conv.weight.flatten(1), x)), cast(conv.bias, x))


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
    is ``momentum=0.1`` here.  Eval mode is ``batch_norm_eval``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm_eval(x, self.running_mean, self.running_var, self.weight,
                                   self.bias, self.eps)
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
                generator: Optional[torch.Generator] = None,
                drop_rate: float = 0.0) -> torch.Tensor:
        """identity + drop_path(drop(fc2(drop(gelu(fc1 x))))): the JAX ``Mlp``
        with ``add_identity``; ``drop_rate``'s dropout after the activation
        and after fc2, in train mode."""
        on = self.training and drop_rate > 0.0
        h = dropout(gelu(linear(x, self.layers[0][0])), drop_rate, on, generator)
        h = dropout(linear(h, self.layers[1]), drop_rate, on, generator)
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


PATCH_EMBED = ("xla", "xla2", "pallas")


class PatchEmbed(nn.Module):
    """Conv patch embedding (kernel == stride) as patchify + matmul, then
    LayerNorm.  Input (B, H, W, c) or flat (B, H, W*c) rows, output (B, H/p,
    W/p, E).  Both layouts are padded at the bottom and right to whole
    patches and patchified in the order (p_row, x_in_patch, c), which the
    same reshaped conv weight serves, so flat input gives NHWC's output bit
    for bit under ``impl="xla"``.  ``impl`` chooses the flat path, as
    ``IR_ADS_PATCH_EMBED`` does the reference's: ``"xla"`` one product,
    ``"xla2"`` one product per patch row summed in f32, ``"pallas"`` K19
    (ops/patch_embed.py, which rounds the LayerNorm's parameters to the
    compute dtype as the Pallas kernel does).  The reference reaches its
    kernel on flat input only: ``"pallas"`` on NHWC input raises."""

    def __init__(self, embed_dim: int, patch_size: int = 4, in_chans: int = 3,
                 impl: str = "xla"):
        super().__init__()
        if impl not in PATCH_EMBED:
            raise NotImplementedError(
                f"patch_embed={impl!r}: the port implements only {PATCH_EMBED!r}")
        self.patch_size, self.in_chans, self.impl = patch_size, in_chans, impl
        self.projection = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, c = self.patch_size, self.in_chans
        impl = self.impl
        if x.ndim == 4:  # NHWC: its rows are the flat layout's, and always "xla"
            if impl == "pallas":
                raise ValueError("PatchEmbed(impl='pallas') takes flat (B, H, W*c) input: "
                                 "the reference runs its kernel on flat input only")
            x, impl = x.flatten(2), "xla"
        pad_h, pad_w = -x.shape[1] % p, -(x.shape[2] // c) % p
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w * c, 0, pad_h))
        wk = self.projection.weight.permute(0, 2, 3, 1).reshape(-1, p * p * c)
        if impl == "pallas":
            return patch_embed(x, wk.t(), self.projection.bias, self.norm.weight,
                               self.norm.bias, p, c, self.norm.eps)
        if impl == "xla2":
            return layer_norm(self._row_sums(x, wk), self.norm)
        xp = patchify_flat(x, p, c)
        y = with_bias(F.linear(xp, cast(wk, xp)), cast(self.projection.bias, xp))
        return layer_norm(y, self.norm)

    def _row_sums(self, x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
        """The reference's xla2: for each of the p patch rows a strided
        slice of the flat rows times its p*c columns of the weight, summed
        in f32, rounded, plus the rounded bias, rounded again."""
        p, c = self.patch_size, self.in_chans
        b, h, wc = x.shape
        wk3 = up(cast(wk, x)).reshape(-1, p, p * c)
        y = sum(up(x[:, r::p].reshape(b, h // p, wc // (p * c), p * c)) @ wk3[:, r].t()
                for r in range(p))
        return (up(y.to(x.dtype)) + up(cast(self.projection.bias, x))).to(x.dtype)


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

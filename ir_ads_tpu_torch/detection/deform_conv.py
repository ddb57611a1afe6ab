"""Deformable convolution v1/v2 and the DCNv3 sampling core: counterpart of
ir_ads_tpu/detection/deform_conv.py.

Both sample with ``ops.grid_sample.grid_sample`` (bilinear, zeros outside
the map, corners summed in f32) at per-output offsets, normalised with
align_corners=True over ``max(size - 1, 1)``.  ``deform_conv2d`` then takes
the k*k*C_in patch times the (k*k*C_in, C_out) weight as one product, in
f32, rounded once to the input's dtype; ``dcn_v3_core`` puts its groups on
the batch axis and weighs its k taps by the mask in f32.  The JAX package
computes both in XLA, outside any Pallas kernel, so they are tensor ops
here on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from ir_ads_tpu_torch.ops.grid_sample import grid_sample


def _taps(n: int, stride: int, pad: int, kernel: int, device) -> torch.Tensor:
    """(n, k) base sampling positions along one axis: output i, tap t ->
    i * stride - pad + t."""
    return ((torch.arange(n, device=device) * stride - pad).float()[:, None]
            + torch.arange(kernel, dtype=torch.float32, device=device)[None])


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor, offsets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: Optional[int] = None) -> torch.Tensor:
    """x (B, H, W, Cin); weight (kh, kw, Cin, Cout), flax's layout; offsets
    (B, Ho, Wo, kh*kw*2) as (dy, dx) per tap; mask (B, Ho, Wo, kh*kw), the
    DCNv2 modulation.  ``padding`` defaults to k // 2.  Returns (B, Ho, Wo,
    Cout) in x's dtype."""
    b, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    pad = kh // 2 if padding is None else padding
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    k = kh * kw
    ty = _taps(ho, stride, pad, kh, x.device)  # (ho, kh)
    tx = _taps(wo, stride, pad, kw, x.device)  # (wo, kw)
    base_y = ty[:, None, :, None].expand(ho, wo, kh, kw).reshape(ho, wo, k)
    base_x = tx[None, :, None, :].expand(ho, wo, kh, kw).reshape(ho, wo, k)
    off = offsets.float().reshape(b, ho, wo, k, 2)
    ny = (base_y + off[..., 0]) / max(h - 1, 1) * 2 - 1
    nx = (base_x + off[..., 1]) / max(w - 1, 1) * 2 - 1
    grid = torch.stack([nx, ny], -1).reshape(b, ho * wo, k, 2)
    sampled = grid_sample(x, grid, align_corners=True).reshape(b, ho, wo, k, cin)
    if mask is not None:
        sampled = sampled * mask[..., None].to(sampled.dtype)
    patches = sampled.reshape(b, ho, wo, k * cin)
    out = patches.float() @ weight.reshape(k * cin, cout).float()
    return out.to(x.dtype)


def dcn_v3_core(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                kernel: int = 3, groups: int = 4) -> torch.Tensor:
    """DCNv3's grouped deformable aggregation without a weight (InternImage
    projects before and after).  x (B, H, W, C); offsets (B, H, W,
    groups*k*2) as (dy, dx) per tap; mask (B, H, W, groups*k), softmaxed
    over k by the caller.  Returns (B, H, W, C) in x's dtype."""
    b, h, w, c = x.shape
    gc = c // groups
    k = kernel * kernel
    pad = kernel // 2
    ty = _taps(h, 1, pad, kernel, x.device)
    tx = _taps(w, 1, pad, kernel, x.device)
    base_y = ty[:, None, :, None].expand(h, w, kernel, kernel).reshape(h, w, 1, k)
    base_x = tx[None, :, None, :].expand(h, w, kernel, kernel).reshape(h, w, 1, k)
    off = offsets.float().reshape(b, h, w, groups, k, 2)
    ny = (base_y + off[..., 0]) / max(h - 1, 1) * 2 - 1
    nx = (base_x + off[..., 1]) / max(w - 1, 1) * 2 - 1
    xg = x.reshape(b, h, w, groups, gc).permute(0, 3, 1, 2, 4).reshape(b * groups, h, w, gc)
    grid = torch.stack([nx, ny], -1).permute(0, 3, 1, 2, 4, 5).reshape(b * groups, h * w, k, 2)
    sampled = grid_sample(xg, grid, align_corners=True)  # (B*g, HW, k, gc)
    m = mask.reshape(b, h, w, groups, k).permute(0, 3, 1, 2, 4).reshape(b * groups, h * w, k)
    out = torch.einsum("nqkc,nqk->nqc", sampled.float(), m.float())
    out = out.reshape(b, groups, h, w, gc).permute(0, 2, 3, 1, 4)
    return out.reshape(b, h, w, c).to(x.dtype)

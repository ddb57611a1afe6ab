"""Bilinear sampling for the deformable cross-modal fusion (DSCF).

Counterpart of ir_ads_tpu/ops/grid_sample.py: ``grid_sample_matmul`` is
``F.grid_sample(mode='bilinear', padding_mode='zeros')`` written as two
separable hat-weight contractions, exact for the few hundred sample points a
DSCF level draws from a feature map.
"""

from __future__ import annotations

import torch


def grid_sample_matmul(
    img: torch.Tensor, grid: torch.Tensor, align_corners: bool = True
) -> torch.Tensor:
    """img (B, H, W, C); grid (B, Hg, Wg, 2) as (x, y) in [-1, 1].
    Returns (B, Hg, Wg, C) in ``img.dtype``."""
    b, h, w, c = img.shape
    _, hg_out, wg_out, _ = grid.shape
    gx = grid[..., 0].float().reshape(b, -1)
    gy = grid[..., 1].float().reshape(b, -1)
    if align_corners:
        ix = (gx + 1.0) * 0.5 * (w - 1)
        iy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((gx + 1.0) * w - 1.0) * 0.5
        iy = ((gy + 1.0) * h - 1.0) * 0.5
    ar_w = torch.arange(w, dtype=torch.float32, device=img.device)
    ar_h = torch.arange(h, dtype=torch.float32, device=img.device)
    wx = torch.clamp(1.0 - (ix[..., None] - ar_w).abs(), min=0.0)  # (B, n, W)
    wy = torch.clamp(1.0 - (iy[..., None] - ar_h).abs(), min=0.0)  # (B, n, H)
    wdt = img.dtype
    t = torch.einsum("bnw,bhwc->bnhc", wx.to(wdt), img)
    out = torch.einsum("bnh,bnhc->bnc", wy.to(wdt), t)
    return out.reshape(b, hg_out, wg_out, c).to(img.dtype)


def make_ref_grid(
    h: int, w: int, batch: int, centered: bool = True, device=None
) -> torch.Tensor:
    """Reference grid of normalized (y, x) coordinates, (B, H, W, 2)."""
    hd = float(max(h - 1, 1))
    wd = float(max(w - 1, 1))
    off = 0.5 if centered else 0.0
    ys = (torch.arange(h, dtype=torch.float32, device=device) + off) / hd * 2.0 - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=device) + off) / wd * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ref = torch.stack([gy, gx], dim=-1)
    return ref[None].expand(batch, h, w, 2)

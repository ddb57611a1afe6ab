"""Window geometry and plain window attention for Swin W-MSA / SW-MSA:
partition and reverse, the relative-position index and bias gather, the
shift-region ids and the dense shift mask, and ``window_attention``, the
module path's attention (the JAX package's XLA path).

Counterpart of ir_ads_tpu/ops/window_attention.py and
``pallas_swin.shift_region_ids``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ir_ads_tpu_torch.ops.layers import q_scale


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWh * nWw, ws*ws, C); H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition: (B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) index into the (2wh-1)(2ww-1) bias table (reference
    double_step_seq construction plus flip)."""
    seq = (
        np.arange(0, (2 * ww - 1) * wh, 2 * ww - 1)[:, None]
        + np.arange(0, ww, 1)[None, :]
    ).reshape(1, -1)
    idx = seq + seq.T
    return idx[:, ::-1].copy()


def gather_rel_pos_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(heads, N, N) f32 bias from the ((2ws-1)^2, heads) table and the
    (N, N) ``relative_position_index`` on the table's device."""
    n = index.shape[0]
    bias = table.float()[index.reshape(-1)].reshape(n, n, -1)
    return bias.permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def shift_region_ids(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Per-token shift-region ids, (nW, ws*ws) int32: two tokens of a window
    may attend to each other iff their ids match."""
    img = np.zeros((hp, wp), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    img = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    return img.reshape(-1, ws * ws)


@functools.lru_cache(maxsize=None)
def shift_region_ids_on(hp: int, wp: int, ws: int, shift: int,
                        device: torch.device) -> torch.Tensor:
    """``shift_region_ids`` as an int32 tensor, copied to ``device`` once per
    geometry so a forward pass enqueues no host-to-device copy for it."""
    return torch.from_numpy(shift_region_ids(hp, wp, ws, shift)).to(device)


@functools.lru_cache(maxsize=None)
def shift_window_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA attention mask, (nW, ws*ws, ws*ws) f32: 0 between tokens of
    one shift region, -100 across regions (the reference's constant)."""
    wins = shift_region_ids(hp, wp, ws, shift)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def shift_window_mask_on(hp: int, wp: int, ws: int, shift: int,
                         device: torch.device) -> torch.Tensor:
    """``shift_window_mask`` copied to ``device`` once per geometry."""
    return torch.from_numpy(shift_window_mask(hp, wp, ws, shift)).to(device)


def _up(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.float()


def window_attention(
    q: torch.Tensor,      # (B*nW, heads, N, d)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,   # (heads, N, N)
    mask: Optional[torch.Tensor],  # (nW, N, N) additive, or None
    scale: float,
) -> torch.Tensor:
    """Windowed attention with the reference's rounding points: ``q *
    scale`` in q's dtype (rounded in bf16), scores summed in f32, bias and
    mask added in f32, f32 softmax, probabilities cast to v's dtype, P.V
    summed in f32 and rounded once.  Returns (B*nW, heads, N, d)."""
    bn, nh, n, _ = q.shape
    attn = _up(q * q_scale(scale, q.dtype)) @ _up(k).transpose(-1, -2)
    attn = attn + _up(bias)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bn // nw, nw, nh, n, n)
                + _up(mask)[None, :, None]).reshape(bn, nh, n, n)
    p = torch.softmax(attn, dim=-1).to(v.dtype)
    return (_up(p) @ _up(v)).to(v.dtype)

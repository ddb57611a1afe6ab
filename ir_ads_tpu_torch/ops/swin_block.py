"""K1: the Swin attention half-block, y = x + proj(W-MSA(qkv(LN1 x))), on
the padded, cyclically rolled (B, Hp, Wp, C) map.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v4 (launched by
``pallas_window_block``; twin ``_block_reference``).  The CUDA source is
csrc/swin_block.cu; its header states the bound and the design.  Weights are
in torch Linear layout (out, in).  As on the TPU, the LN and projection
parameters are rounded to the compute dtype and the rel-pos bias stays f32.

``window_block`` launches the kernel for CUDA tensors and runs
``window_block_reference``, the plain version, only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr,
)
from ir_ads_tpu_torch.ops.window_attention import window_partition, window_reverse

KERNEL = CudaKernel(
    "swin_block", "swin_window_block", [VOIDP] * 12 + [INT] * 9 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_swin.py:1003",
)


def pad_mask(hp: int, wp: int, h_real: int, w_real: int, shift: int,
             device) -> torch.Tensor:
    """(Hp, Wp) bool: True where the rolled map holds padding."""
    row = torch.arange(hp, device=device)[:, None]
    col = torch.arange(wp, device=device)[None, :]
    return ((row + shift) % hp >= h_real) | ((col + shift) % wp >= w_real)


def window_block_reference(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region, scale, heads, ws,
    h_real, w_real, shift, eps=1e-5,
):
    """Plain PyTorch version, with the TPU kernel's rounding points."""
    cdt = x.dtype
    b, hp, wp, c = x.shape
    xf = x.float()
    xn = F.layer_norm(xf, (c,), ln_w.float(), ln_b.float(), eps)
    if h_real != hp or w_real != wp:
        xn = xn.masked_fill(
            pad_mask(hp, wp, h_real, w_real, shift, x.device)[None, :, :, None],
            0.0,
        )
    xn = xn.to(cdt).float()
    qkv = (xn @ wqkv.float().t() + bqkv.float()).to(cdt)
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    out = att.float() @ wproj.float().t() + bproj.float()
    return (xf + out).to(cdt)


def window_attention_reference(qkv, bias, region, scale, heads, ws):
    """W-MSA of a (B, Hp, Wp, 3C) qkv map in the compute dtype, as the TPU
    kernels round it: (q * scale) rounded, f32 scores + f32 bias, -1e9 at
    pairs of different shift regions, f32 softmax, probabilities rounded,
    P.V summed in f32 and rounded once.  Returns (B, Hp, Wp, C)."""
    cdt = qkv.dtype
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, ws * ws
    d = c // heads
    wins = window_partition(qkv, ws)  # (B*nW, N, 3C)
    bn = wins.shape[0]
    heads_of = lambda t: t.reshape(bn, n, heads, d).transpose(1, 2)  # noqa: E731
    q, k, v = (heads_of(wins[..., i * c:(i + 1) * c]) for i in range(3))
    s = (q.float() * scale).to(cdt).float() @ k.float().transpose(-1, -2)
    s = s + bias.float()[None]
    if region is not None:
        neq = region[:, :, None] != region[:, None, :]  # (nW, N, N)
        nw = neq.shape[0]
        s = (s.reshape(bn // nw, nw, heads, n, n)
             - 1e9 * neq[None, :, None].float()).reshape(bn, heads, n, n)
    p = torch.softmax(s, dim=-1).to(cdt)
    o = (p.float() @ v.float()).to(cdt)
    return window_reverse(o.transpose(1, 2).reshape(bn, n, c), ws, hp, wp)


def window_block(
    x: torch.Tensor,        # (B, Hp, Wp, C) rolled, padded map
    ln_w: torch.Tensor,     # (C,)
    ln_b: torch.Tensor,     # (C,)
    wqkv: torch.Tensor,     # (3C, C)
    bqkv: torch.Tensor,     # (3C,)
    wproj: torch.Tensor,    # (C, C)
    bproj: torch.Tensor,    # (C,)
    bias: torch.Tensor,     # (heads, N, N)
    region: Optional[torch.Tensor],  # (nW, N) int32, or None when unshifted
    scale: float,
    heads: int,
    ws: int,
    h_real: Optional[int] = None,
    w_real: Optional[int] = None,
    shift: int = 0,
    eps: float = 1e-5,
) -> torch.Tensor:
    b, hp, wp, c = x.shape
    h_real = hp if h_real is None else h_real
    w_real = wp if w_real is None else w_real
    cdt = x.dtype
    ln_w, ln_b, wqkv, bqkv, wproj, bproj = (
        t.to(cdt).contiguous() for t in (ln_w, ln_b, wqkv, bqkv, wproj, bproj)
    )
    bias = bias.float().contiguous()
    if x.device.type == "cpu":
        return window_block_reference(
            x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region, scale,
            heads, ws, h_real, w_real, shift, eps,
        )
    x = x.contiguous()
    check_cuda("window_block", x, ln_w, ln_b, wqkv, bqkv, wproj, bproj)
    check_cuda("window_block", bias, dtype=torch.float32)
    n, d = ws * ws, c // heads
    if n % 16 or d % 16 or c % 64 or hp % ws or wp % ws:
        raise ValueError(f"window_block: unsupported shape C={c} heads={heads} ws={ws}")
    if region is not None:
        region = region.to(device=x.device, dtype=torch.int32).contiguous()
    qkv = torch.empty((b, hp, wp, 3 * c), dtype=cdt, device=x.device)
    att = torch.empty((b, hp, wp, c), dtype=cdt, device=x.device)
    y = torch.empty_like(x)
    KERNEL.call(
        ptr(x), ptr(ln_w), ptr(ln_b), ptr(wqkv), ptr(bqkv), ptr(wproj),
        ptr(bproj), ptr(bias), ptr(region) if region is not None else None,
        ptr(qkv), ptr(att), ptr(y), b, hp, wp, c, heads, ws, h_real, w_real,
        shift, float(scale), float(eps),
    )
    return y

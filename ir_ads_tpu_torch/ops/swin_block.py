"""K1: the Swin attention half-block, y = x + proj(W-MSA(qkv(LN1 x))), on
the padded, cyclically rolled (B, Hp, Wp, C) map.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v4 (launched by
``pallas_window_block``; twin ``_block_reference``).  The CUDA source is
csrc/swin_block.cu; its header states the bound and the design: four
launches (LN1; the qkv and proj products on csrc/gemm_mma.cuh with the
fused form's expressions as epilogues; the window attention between them on
csrc/window_mma.cuh's tensor-core head kernel where ``tensor_core_design``
holds, else on its first design, by shape alone).  The wrapper allocates
the intermediates.  Weights are in torch Linear layout (out, in).  As on the TPU, the LN and projection
parameters are rounded to the compute dtype and the rel-pos bias stays f32.

``window_block`` launches the kernel for CUDA tensors and runs
``window_block_reference``, the plain version, only for CPU tensors.  It is
differentiable: its backward (``window_block_backward``, the counterpart of
``pallas_swin._block_bwd_manual``) saves the inputs only, recomputes LN1 and
qkv, hands everything of size N x N to K7 (ops/window_attn_bwd.py) and
leaves the projection and LN gradients to PyTorch products.  Which optional
pieces K7 computes follows ``needs_input_grad``: a frozen ``wproj`` skips
``ow``, a frozen ``bias`` skips ``dbias``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up,
)
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.window_attn_bwd import window_attention_bwd
from ir_ads_tpu_torch.ops.window_attention import window_partition, window_reverse
from ir_ads_tpu_torch.ops.window_attention_qkv import tensor_core_design
# W-MSA of a (B, Hp, Wp, 3C) qkv map as the TPU kernels round it: K15's plain
# version, K12's on the map's windows; K1's, K5's, K10's and K14's plain
# versions attend through it
from ir_ads_tpu_torch.ops.window_attention_map import (
    window_attention_map_reference as window_attention_reference,
)

KERNEL = CudaKernel(
    "swin_block", "swin_window_block", [VOIDP] * 13 + [INT] * 10 + [FLOAT] * 2,
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
    xf = up(x)
    xn = F.layer_norm(xf, (c,), up(ln_w), up(ln_b), eps)
    if h_real != hp or w_real != wp:
        xn = xn.masked_fill(
            pad_mask(hp, wp, h_real, w_real, shift, x.device)[None, :, :, None],
            0.0,
        )
    xn = up(xn.to(cdt))
    qkv = (xn @ up(wqkv).t() + up(bqkv)).to(cdt)
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    out = up(att) @ up(wproj).t() + up(bproj)
    return (xf + out).to(cdt)


def _forward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region, scale,
             heads, ws, h_real, w_real, shift, eps):
    """K1 on CUDA tensors, its plain version on CPU tensors; parameters in
    any float dtype are rounded to x's."""
    b, hp, wp, c = x.shape
    cdt = x.dtype
    ln_w, ln_b, wqkv, bqkv, wproj, bproj = (
        t.to(cdt).contiguous() for t in (ln_w, ln_b, wqkv, bqkv, wproj, bproj)
    )
    bias = up(bias).contiguous()
    if x.device.type == "cpu":
        return window_block_reference(
            x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region, scale,
            heads, ws, h_real, w_real, shift, eps,
        )
    x = x.contiguous()
    check_cuda("window_block", x, ln_w, ln_b, wqkv, bqkv, wproj, bproj)
    check_cuda("window_block", bias, dtype=torch.float32)
    n, d = ws * ws, c // heads
    mma = c % heads == 0 and tensor_core_design(cdt, n, d)
    # the attention's first design takes WMMA tiles of 16 tokens and
    # channels; its tensor-core design and the GEMMs' pieces, 16-byte rows
    if not (mma or (n % 16 == 0 and d % 16 == 0)) or c % 8 or hp % ws or wp % ws:
        raise ValueError(f"window_block: unsupported shape C={c} heads={heads} ws={ws}")
    if region is not None:
        region = region.to(device=x.device, dtype=torch.int32).contiguous()
    xn = torch.empty_like(x)
    qkv = torch.empty((b, hp, wp, 3 * c), dtype=cdt, device=x.device)
    att = torch.empty((b, hp, wp, c), dtype=cdt, device=x.device)
    y = torch.empty_like(x)
    KERNEL.call(
        ptr(x), ptr(ln_w), ptr(ln_b), ptr(wqkv), ptr(bqkv), ptr(wproj),
        ptr(bproj), ptr(bias), ptr(region) if region is not None else None,
        ptr(xn), ptr(qkv), ptr(att), ptr(y), b, hp, wp, c, heads, ws, h_real, w_real,
        shift, int(mma), q_scale(scale, cdt), float(eps),
    )
    return y


def window_block_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region,
                          g, scale, heads, ws, h_real, w_real, shift, eps,
                          needs=(True,) * 8):
    """Gradients of ``window_block`` for the cotangent ``g`` of its output,
    in the order (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias); an entry
    is None where ``needs`` is False.  Everything N x N is K7's; the LN1 and
    qkv recompute, the projections' products and the LN backward are PyTorch
    calls in the compute dtype (f32 accumulation inside the product, one
    rounding of its result), as the TPU version leaves them to XLA."""
    cdt = x.dtype
    b, hp, wp, c = x.shape
    n_x, n_lw, n_lb, n_wq, n_bq, n_wp, n_bp, n_bias = needs
    lw, lb, wq, bq, wpj = (t.to(cdt) for t in (ln_w, ln_b, wqkv, bqkv, wproj))

    # recompute LN1, the pad mask and qkv
    xf = up(x)
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    xn = xhat * up(lw) + up(lb)
    padm = None
    if h_real != hp or w_real != wp:
        padm = pad_mask(hp, wp, h_real, w_real, shift, x.device)[None, :, :, None]
        xn = xn.masked_fill(padm, 0.0)
    xn = xn.to(cdt)
    qkvw = window_partition(F.linear(xn, wq, bq), ws)  # (B*nW, N, 3C)

    # out-projection and residual
    g = g.to(cdt)
    dow = window_partition(g @ wpj, ws)
    dqkvw, oww, dbias = window_attention_bwd(
        qkvw, dow, up(bias), region, scale, heads, want_ow=n_wp, want_dbias=n_bias)
    g2 = g.reshape(-1, c)
    d_bproj = up(g2).sum(dim=0).to(bproj.dtype) if n_bp else None
    d_wproj = None
    if n_wp:
        att = window_reverse(oww, ws, hp, wp).reshape(-1, c)
        d_wproj = (g2.t() @ att).to(wproj.dtype)
    d_bias = dbias.to(bias.dtype) if n_bias else None

    # qkv projection
    dqkv = window_reverse(dqkvw, ws, hp, wp)  # (B, Hp, Wp, 3C)
    dq2 = dqkv.reshape(-1, 3 * c)
    d_bqkv = up(dq2).sum(dim=0).to(bqkv.dtype) if n_bq else None
    d_wqkv = (dq2.t() @ xn.reshape(-1, c)).to(wqkv.dtype) if n_wq else None
    dxn = up(dqkv @ wq)
    if padm is not None:
        dxn = dxn.masked_fill(padm, 0.0)

    # LN1
    d_lw = (dxn * xhat).sum(dim=(0, 1, 2)).to(ln_w.dtype) if n_lw else None
    d_lb = dxn.sum(dim=(0, 1, 2)).to(ln_b.dtype) if n_lb else None
    dx = None
    if n_x:
        dxh = dxn * up(lw)
        m1 = dxh.mean(dim=-1, keepdim=True)
        m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
        dx = (up(g) + inv * (dxh - m1 - xhat * m2)).to(cdt)
    return dx, d_lw, d_lb, d_wqkv, d_bqkv, d_wproj, d_bproj, d_bias


class _WindowBlock(torch.autograd.Function):
    """K1 forward, ``window_block_backward`` (K7) backward; saves inputs only."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region,
                scale, heads, ws, h_real, w_real, shift, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region)
        ctx.static = (scale, heads, ws, h_real, w_real, shift, eps)
        return _forward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region,
                        scale, heads, ws, h_real, w_real, shift, eps)

    @staticmethod
    def backward(ctx, g):
        grads = window_block_backward(
            *ctx.saved_tensors, g, *ctx.static, needs=ctx.needs_input_grad[:8])
        return (*grads, *(None,) * 8)


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
    hp, wp = x.shape[1:3]
    h_real = hp if h_real is None else h_real
    w_real = wp if w_real is None else w_real
    return _WindowBlock.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                              region, scale, heads, ws, h_real, w_real, shift, eps)

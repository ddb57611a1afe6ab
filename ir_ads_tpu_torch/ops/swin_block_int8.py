"""K10: the w8a8 Swin attention half-block, y = x + proj_w8a8(W-MSA(
qkv_w8a8(LN1 x))), on the padded, cyclically rolled (B, Hp, Wp, C) map.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v4_int8 (launched by
``pallas_window_block`` under ``IR_ADS_INT8``).  The CUDA source is
csrc/swin_block_int8.cu; its header states the bound and the design: five
launches (LN1 with the per-row s8 of its output, the qkv product, K1's
attention, the per-row s8 of the attention output, the proj product), the
s8 products on csrc/igemm.cuh's TMA and wgmma GEMM with the fused rows'
expressions as epilogues: their bits.  The
qkv and proj weights arrive quantized per output channel
(``ops.int8.quantize_weight`` of the float weights, (out, in) layout: s8 and
an f32 scale each); LN and bias parameters are rounded to the compute dtype
and the rel-pos bias stays f32, as on the TPU.

``window_block_int8`` launches the kernel for CUDA tensors and runs
``window_block_int8_reference``, the plain version, only for CPU tensors.
It has no backward and raises when an input requires a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, forbid_grad, ptr, up,
)
from ir_ads_tpu_torch.ops.int8 import int8_linear, layer_norm_rows
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.swin_block import pad_mask, window_attention_reference
from ir_ads_tpu_torch.ops.window_attention_qkv import tensor_core_design

KERNEL = CudaKernel(
    "swin_block_int8", "swin_window_block_int8",
    [VOIDP] * 18 + [INT] * 10 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_swin.py:1108",
)


def window_block_int8_reference(
    x, ln_w, ln_b, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj, bias, region,
    scale, heads, ws, h_real, w_real, shift, eps=1e-5,
):
    """Plain PyTorch version, with the TPU kernel's rounding points: LN1
    zeroed at padding and rounded to the compute dtype, per-row s8 of it,
    qkv rounded, K1's attention, per-row s8 of its output, the residual
    added in f32 and rounded once."""
    cdt = x.dtype
    b, hp, wp, c = x.shape
    xf = up(x)
    xn = layer_norm_rows(xf, up(ln_w), up(ln_b), eps)
    if h_real != hp or w_real != wp:
        xn = xn.masked_fill(
            pad_mask(hp, wp, h_real, w_real, shift, x.device)[None, :, :, None], 0.0)
    xn = up(xn.to(cdt))
    qkv = (int8_linear(xn, wqkv_q, sqkv, floor_first=True) + up(bqkv)).to(cdt)
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    out = int8_linear(up(att), wproj_q, sproj, floor_first=True) + up(bproj)
    return (xf + out).to(cdt)


def window_block_int8(
    x: torch.Tensor,        # (B, Hp, Wp, C) rolled, padded map
    ln_w: torch.Tensor,     # (C,)
    ln_b: torch.Tensor,     # (C,)
    wqkv_q: torch.Tensor,   # (3C, C) s8
    sqkv: torch.Tensor,     # (3C,) f32
    bqkv: torch.Tensor,     # (3C,)
    wproj_q: torch.Tensor,  # (C, C) s8
    sproj: torch.Tensor,    # (C,) f32
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
    forbid_grad("window_block_int8", x, ln_w, ln_b, bqkv, bproj, bias)
    b, hp, wp, c = x.shape
    h_real = hp if h_real is None else h_real
    w_real = wp if w_real is None else w_real
    cdt = x.dtype
    ln_w, ln_b, bqkv, bproj = (t.to(cdt).contiguous() for t in (ln_w, ln_b, bqkv, bproj))
    wqkv_q, wproj_q = wqkv_q.contiguous(), wproj_q.contiguous()
    sqkv, sproj = sqkv.float().contiguous(), sproj.float().contiguous()
    bias = up(bias).contiguous()
    if x.device.type == "cpu":
        return window_block_int8_reference(
            x, ln_w, ln_b, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj, bias, region,
            scale, heads, ws, h_real, w_real, shift, eps)
    x = x.contiguous()
    check_cuda("window_block_int8", x, ln_w, ln_b, bqkv, bproj)
    check_cuda("window_block_int8", wqkv_q, wproj_q, dtype=torch.int8)
    check_cuda("window_block_int8", sqkv, sproj, bias, dtype=torch.float32)
    n, d = ws * ws, c // heads
    mma = c % heads == 0 and tensor_core_design(cdt, n, d)
    # TMA's row strides are multiples of 16 bytes
    if not (mma or (n % 16 == 0 and d % 16 == 0)) or c % 16 or hp % ws or wp % ws:
        raise ValueError(f"window_block_int8: unsupported shape C={c} heads={heads} ws={ws}")
    if region is not None:
        region = region.to(device=x.device, dtype=torch.int32).contiguous()
    t = b * hp * wp
    empty = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    # xq, sx, qkv, the attention output, its s8 rows and scales
    scratch = (empty(t, c, dtype=torch.int8), empty(t), empty(t, 3 * c, dtype=cdt),
               empty(t, c, dtype=cdt), empty(t, c, dtype=torch.int8), empty(t))
    y = torch.empty_like(x)
    KERNEL.call(
        ptr(x), ptr(ln_w), ptr(ln_b), ptr(wqkv_q), ptr(sqkv), ptr(bqkv), ptr(wproj_q),
        ptr(sproj), ptr(bproj), ptr(bias), ptr(region) if region is not None else None,
        *(ptr(s) for s in scratch), ptr(y), b, hp, wp, c, heads, ws, h_real, w_real, shift,
        int(mma), q_scale(scale, cdt), float(eps),
    )
    return y

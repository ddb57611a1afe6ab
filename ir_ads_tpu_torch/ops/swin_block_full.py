"""K14: the Swin attention half-block on the REAL (B, H, W, C) map,
y = round(x + proj(W-MSA(qkv(LN1 x)))), with the window padding, the cyclic
shift and the crop inside the kernel.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v5 (launched by
``pallas_window_block_full``; twin ``_block_full_reference``).  The CUDA
source is csrc/swin_block_full.cu; its header states the bound and the
design: K1's four launches (LN1; the qkv and proj GEMMs on
csrc/gemm_mma.cuh; the window attention between them) on the real map's
rows, the pad, the roll and the crop in the attention's indices.  The
wrapper allocates the intermediates.  Weights are in torch Linear layout
(out, in); as on the TPU, the LN and projection parameters are rounded to
the compute dtype and the rel-pos bias stays f32.

``window_block_full`` launches the kernel for CUDA tensors and runs
``window_block_full_reference``, the plain version (the twin: LN1 before
the zero padding, so a padded position's qkv is the bias row), only for CPU
tensors.  It is an eval kernel: it raises when an input requires a gradient
(the JAX package's train mode runs pallas4 in its place, as the port's
``train`` dispatch does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, forbid_grad, ptr, up,
)
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.swin_block import window_attention_reference
from ir_ads_tpu_torch.ops.window_attention_qkv import tensor_core_design

KERNEL = CudaKernel(
    "swin_block_full", "swin_block_full", [VOIDP] * 13 + [INT] * 8 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_swin.py:1415",
)


def window_block_full_reference(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region, scale, heads, ws,
    shift=0, eps=1e-5,
):
    """Plain PyTorch version, ``_block_full_reference``: LN1 on the real
    map, zero padding, roll, qkv, W-MSA, un-roll, crop, proj, residual."""
    cdt = x.dtype
    b, h, w, c = x.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    xf = up(x)
    xn = F.layer_norm(xf, (c,), up(ln_w), up(ln_b), eps).to(cdt)
    xn = F.pad(xn, (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        xn = torch.roll(xn, shifts=(-shift, -shift), dims=(1, 2))
    qkv = (up(xn) @ up(wqkv).t() + up(bqkv)).to(cdt)
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    if shift:
        att = torch.roll(att, shifts=(shift, shift), dims=(1, 2))
    out = up(att[:, :h, :w]) @ up(wproj).t() + up(bproj)
    return (xf + out).to(cdt)


def window_block_full(
    x: torch.Tensor,        # (B, H, W, C) real map
    ln_w: torch.Tensor,     # (C,)
    ln_b: torch.Tensor,     # (C,)
    wqkv: torch.Tensor,     # (3C, C)
    bqkv: torch.Tensor,     # (3C,)
    wproj: torch.Tensor,    # (C, C)
    bproj: torch.Tensor,    # (C,)
    bias: torch.Tensor,     # (heads, N, N)
    region: Optional[torch.Tensor],  # (nW, N) int32 of the padded map, or None when unshifted
    scale: float,
    heads: int,
    ws: int,
    shift: int = 0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Returns y on the real map, in x's dtype."""
    forbid_grad("window_block_full", x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias)
    cdt = x.dtype
    ln_w, ln_b, wqkv, bqkv, wproj, bproj = (
        t.to(cdt).contiguous() for t in (ln_w, ln_b, wqkv, bqkv, wproj, bproj))
    bias = up(bias).contiguous()
    if x.device.type == "cpu":
        return window_block_full_reference(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                                           region, scale, heads, ws, shift, eps)
    x = x.contiguous()
    check_cuda("window_block_full", x, ln_w, ln_b, wqkv, bqkv, wproj, bproj)
    check_cuda("window_block_full", bias, dtype=torch.float32)
    b, h, w, c = x.shape
    n, d = ws * ws, c // heads
    mma = c % heads == 0 and tensor_core_design(cdt, n, d)
    # K1's shapes: the attention's first design takes WMMA tiles of 16
    # tokens and channels; its tensor-core design and the GEMMs' pieces,
    # 16-byte rows
    if not (mma or (n % 16 == 0 and d % 16 == 0)) or c % 8:
        raise ValueError(f"window_block_full: unsupported shape C={c} heads={heads} ws={ws}")
    if region is not None:
        region = region.to(device=x.device, dtype=torch.int32).contiguous()
    if mma and ptr(bqkv) % 16:  # the padding's q, k and v are read from it
        bqkv = bqkv.clone()
    # LN1's output, qkv and the attention output over the real rows
    scratch = (torch.empty_like(x), torch.empty((b * h * w, 3 * c), dtype=cdt, device=x.device),
               torch.empty_like(x))
    y = torch.empty_like(x)
    KERNEL.call(
        ptr(x), ptr(ln_w), ptr(ln_b), ptr(wqkv), ptr(bqkv), ptr(wproj), ptr(bproj),
        ptr(bias), ptr(region) if region is not None else None, *(ptr(t) for t in scratch),
        ptr(y),
        b, h, w, c, heads, ws, shift, int(mma), q_scale(scale, cdt), float(eps),
    )
    return y

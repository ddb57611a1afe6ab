"""K13: the banded whole Swin block on the padded, rolled (B, Hp, Wp, C)
map,

    y   = round(x + proj(W-MSA(qkv(LN1 x))))
    out = round(y + FFN(LN2 y) + 0.5 * Adapter(y)),

the tail on every position, in rolled coordinates: K1 then K2 without the
un-roll and the crop between them.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v7 (launched by
``pallas_window_block_v7``; twin ``_block_v7_reference``).  The CUDA source
is csrc/swin_block_v7.cu; its header states the bound and the design: K1's
four launches, then K2's five on the block's y (the products on
csrc/gemm_mma.cuh, the adapter's batched over the streams).  The wrapper
allocates the intermediates.  Parameters are K1's plus K2's, in torch Linear layout (out, in), rounded to
the compute dtype as on the TPU; the rel-pos bias stays f32.  Adapter
weights may carry a leading stream axis (S, ...): image b then uses stream
b // (B / S).  The pad, the roll, the un-roll and the crop are the caller's.

``window_block_v7`` launches the kernel for CUDA tensors and runs
``window_block_v7_reference``, the plain version (the twin: K1's plain
version, then K2's on its rounded output), only for CPU tensors.  It is an
eval kernel: it raises when an input requires a gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ir_ads_tpu_torch.ops.block_tail import block_tail_reference
from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, forbid_grad, ptr,
)
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.swin_block import window_block_reference
from ir_ads_tpu_torch.ops.window_attention_qkv import tensor_core_design

KERNEL = CudaKernel(
    "swin_block_v7", "swin_block_v7", [VOIDP] * 27 + [INT] * 13 + [FLOAT] * 3,
    replaces="ir_ads_tpu/ops/pallas_swin.py:2179",
)


def window_block_v7_reference(
    x, attn_params, tail_params, region, scale, heads, ws, h_real, w_real, shift=0,
    eps=1e-5, adapter_scale=0.5,
):
    """Plain PyTorch version, ``_block_v7_reference``: K1's plain version,
    then K2's per stream, both on the rolled, padded map."""
    y = window_block_reference(x, *attn_params, region, scale, heads, ws, h_real, w_real,
                               shift, eps)
    b, hp, wp, c = y.shape
    aw1 = tail_params[6]
    if aw1.ndim == 3:  # per-stream stacked adapters
        per = b // aw1.shape[0]
        out = torch.cat([
            block_tail_reference(y[i * per:(i + 1) * per].reshape(-1, c), *tail_params[:6],
                                 *(t[i] for t in tail_params[6:]), eps=eps,
                                 adapter_scale=adapter_scale)
            for i in range(aw1.shape[0])
        ])
    else:
        out = block_tail_reference(y.reshape(-1, c), *tail_params, eps=eps,
                                   adapter_scale=adapter_scale)
    return out.reshape(b, hp, wp, c)


def window_block_v7(
    x: torch.Tensor,              # (B, Hp, Wp, C) rolled, padded map
    attn_params: Sequence[torch.Tensor],  # ln_w, ln_b, wqkv (3C,C), bqkv, wproj (C,C), bproj, bias (heads,N,N)
    tail_params: Sequence[torch.Tensor],  # ln2_w, ln2_b, w1 (4C,C), b1, w2 (C,4C), b2, aw1 ([S,]Ca,C), ab1, aw2 ([S,]C,Ca), ab2
    region: Optional[torch.Tensor],  # (nW, N) int32, or None when unshifted
    scale: float,
    heads: int,
    ws: int,
    h_real: Optional[int] = None,
    w_real: Optional[int] = None,
    shift: int = 0,
    eps: float = 1e-5,
    adapter_scale: float = 0.5,
) -> torch.Tensor:
    """Returns the block's output on the rolled, padded map, in x's dtype."""
    forbid_grad("window_block_v7", x, *attn_params, *tail_params)
    cdt = x.dtype
    b, hp, wp, c = x.shape
    h_real = hp if h_real is None else h_real
    w_real = wp if w_real is None else w_real
    attn = tuple(t.to(cdt).contiguous() for t in attn_params[:6])
    attn += (attn_params[6].float().contiguous(),)
    tail = tuple(t.to(cdt).contiguous() for t in tail_params)
    if x.device.type == "cpu":
        return window_block_v7_reference(x, attn, tail, region, scale, heads, ws, h_real,
                                         w_real, shift, eps, adapter_scale)
    x = x.contiguous()
    check_cuda("window_block_v7", x, *attn[:6], *tail)
    check_cuda("window_block_v7", attn[6], dtype=torch.float32)
    n, d = ws * ws, c // heads
    hidden = tail[2].shape[0]
    aw1 = tail[6]
    streams = aw1.shape[0] if aw1.ndim == 3 else 1
    ca = aw1.shape[-2]
    mma = c % heads == 0 and tensor_core_design(cdt, n, d)
    # K1's shapes (the attention's first design: WMMA tiles of 16 tokens
    # and channels; its tensor-core design and the GEMMs' pieces: 16-byte
    # rows) and K2's (the GEMMs' epilogues write output pairs)
    if (not (mma or (n % 16 == 0 and d % 16 == 0)) or c % 8 or hidden % 2 or ca % 2
            or hp % ws or wp % ws or b % streams):
        raise ValueError(
            f"window_block_v7: unsupported shape C={c} heads={heads} ws={ws} "
            f"hidden={hidden} Ca={ca} B={b} streams={streams}")
    if region is not None:
        region = region.to(device=x.device, dtype=torch.int32).contiguous()
    empty = lambda width, dtype=cdt: torch.empty(  # noqa: E731
        (b * hp * wp, width), dtype=dtype, device=x.device)
    # LN1's (then LN2's) output, qkv, the attention output, y, the adapter's
    # hidden and f32 output (the W2 GEMM's init), the FFN hidden
    scratch = (empty(c), empty(3 * c), empty(c), empty(c), empty(ca),
               empty(c, torch.float32), empty(hidden))
    out = torch.empty_like(x)
    KERNEL.call(
        ptr(x), *(ptr(t) for t in attn), ptr(region) if region is not None else None,
        *(ptr(t) for t in tail), *(ptr(t) for t in scratch), ptr(out),
        b, hp, wp, c, heads, ws, h_real, w_real, shift, hidden, ca, streams, int(mma),
        q_scale(scale, cdt), float(eps), float(adapter_scale),
    )
    return out

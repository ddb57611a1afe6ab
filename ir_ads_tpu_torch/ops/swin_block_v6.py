"""K5: the whole Swin block on the real (B, H, W, C) map,

    y   = x + proj(W-MSA(qkv(LN1 x)))     (f32, never rounded)
    out = y + FFN(LN2 y) + 0.5 * Adapter(round(y)),

with the window padding, the cyclic shift and the crop inside the kernel.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v6 (launched by
``pallas_window_block_v6``).  The CUDA source is csrc/swin_block_v6.cu; its
header states the bound and the design: nine launches, the six products on
csrc/gemm_mma.cuh's pipelined GEMM with each step's arithmetic as its
epilogue, the attention on csrc/window_mma.cuh's tensor-core head kernel
where ``tensor_core_design`` holds, else on its first design, by shape
alone.  The wrapper allocates their intermediates on x's device.
Parameters are K1's plus K2's, in torch Linear layout (out, in), rounded to
the compute dtype as on the TPU; the rel-pos bias stays f32.  Adapter weights may carry a leading stream axis
(S, ...): sample b then uses stream b // (B / S).

The plain version follows the TPU kernel, not its XLA twin
``_block_v6_reference``: the twin rounds the attention-half residual y to
the compute dtype between the halves, the kernel does not.

``window_block_v6`` launches the kernel for CUDA tensors and runs
``window_block_v6_reference``, the plain version, only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, forbid_grad, ptr,
)
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.swin_block import window_attention_reference
from ir_ads_tpu_torch.ops.window_attention_qkv import tensor_core_design

KERNEL = CudaKernel(
    "swin_block_v6", "swin_block_v6", [VOIDP] * 28 + [INT] * 11 + [FLOAT] * 3,
    replaces="ir_ads_tpu/ops/pallas_swin.py:1505",
)


def _adapter(y, aw1, ab1, aw2, ab2):
    """relu(y Wa1^T + ab1) rounded to the compute dtype, then Wa2, in f32."""
    a = torch.relu(y.float() @ aw1.float().t() + ab1.float()).to(y.dtype)
    return a.float() @ aw2.float().t() + ab2.float()


def real_map_attention_reference(qkv, bqkv, bias, region, scale, heads, ws, shift=0):
    """W-MSA of the real map's qkv (B, H, W, 3C) in the windows of the
    padded map rolled by ``shift``: the padding holds the qkv of a zero LN
    output, the bias row; pad, roll, attend, un-roll, crop."""
    b, h, w, c3 = qkv.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    brow = bqkv.to(qkv.dtype)
    qkv = torch.cat([qkv, brow.expand(b, h, wp - w, c3)], dim=2)
    qkv = torch.cat([qkv, brow.expand(b, hp - h, wp, c3)], dim=1)
    if shift:
        qkv = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    if shift:
        att = torch.roll(att, shifts=(shift, shift), dims=(1, 2))
    return att[:, :h, :w]


def window_block_v6_reference(
    x, attn_params, tail_params, region, scale, heads, ws, shift=0, eps=1e-5,
    adapter_scale=0.5,
):
    """Plain PyTorch version, with the TPU kernel's rounding points."""
    ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias = attn_params
    g2, be2, w1, b1, w2, b2, aw1, ab1, aw2, ab2 = tail_params
    cdt = x.dtype
    b, h, w, c = x.shape
    xf = x.float()
    xn = F.layer_norm(xf, (c,), ln_w.float(), ln_b.float(), eps).to(cdt)
    qkv = (xn.float() @ wqkv.float().t() + bqkv.float()).to(cdt)
    att = real_map_attention_reference(qkv, bqkv, bias, region, scale, heads, ws, shift)
    y = xf + (att.float() @ wproj.float().t() + bproj.float())
    yn = F.layer_norm(y, (c,), g2.float(), be2.float(), eps).to(cdt)
    hid = F.gelu(yn.float() @ w1.float().t() + b1.float(), approximate="tanh")
    ffn = hid.to(cdt).float() @ w2.float().t() + b2.float()
    yr = y.to(cdt)
    if aw1.ndim == 3:  # per-stream stacked adapters
        per = b // aw1.shape[0]
        a = torch.cat([
            _adapter(yr[i * per:(i + 1) * per], aw1[i], ab1[i], aw2[i], ab2[i])
            for i in range(aw1.shape[0])
        ])
    else:
        a = _adapter(yr, aw1, ab1, aw2, ab2)
    return (y + ffn + adapter_scale * a).to(cdt)


def window_block_v6(
    x: torch.Tensor,              # (B, H, W, C) real map
    attn_params: Sequence[torch.Tensor],  # ln_w, ln_b, wqkv (3C,C), bqkv, wproj (C,C), bproj, bias (heads,N,N)
    tail_params: Sequence[torch.Tensor],  # ln2_w, ln2_b, w1 (4C,C), b1, w2 (C,4C), b2, aw1 ([S,]Ca,C), ab1, aw2 ([S,]C,Ca), ab2
    region: Optional[torch.Tensor],  # (nW, N) int32 of the padded map, or None when unshifted
    scale: float,
    heads: int,
    ws: int,
    shift: int = 0,
    eps: float = 1e-5,
    adapter_scale: float = 0.5,
) -> torch.Tensor:
    forbid_grad("window_block_v6", x, *attn_params, *tail_params)
    cdt = x.dtype
    attn = tuple(t.to(cdt).contiguous() for t in attn_params[:6])
    attn += (attn_params[6].float().contiguous(),)
    tail = tuple(t.to(cdt).contiguous() for t in tail_params)
    if x.device.type == "cpu":
        return window_block_v6_reference(x, attn, tail, region, scale, heads, ws,
                                         shift, eps, adapter_scale)
    x = x.contiguous()
    check_cuda("window_block_v6", x, *attn[:6], *tail)
    check_cuda("window_block_v6", attn[6], dtype=torch.float32)
    b, h, w, c = x.shape
    n, d = ws * ws, c // heads
    hidden = tail[2].shape[0]
    aw1 = tail[6]
    streams = aw1.shape[0] if aw1.ndim == 3 else 1
    ca = aw1.shape[-2]
    mma = c % heads == 0 and tensor_core_design(cdt, n, d)
    # the attention's first design takes WMMA tiles of 16 tokens and
    # channels, its tensor-core design 16-byte rows; the GEMM's epilogues
    # write output pairs
    if (not (mma or (n % 16 == 0 and d % 16 == 0)) or c % 8 or hidden % 2 or ca % 2
            or b % streams):
        raise ValueError(
            f"window_block_v6: unsupported shape C={c} heads={heads} ws={ws} "
            f"hidden={hidden} Ca={ca} B={b} streams={streams}")
    if region is not None:
        region = region.to(device=x.device, dtype=torch.int32).contiguous()
    if mma and ptr(attn[3]) % 16:  # the padding's q, k and v are read from it
        attn = attn[:3] + (attn[3].clone(),) + attn[4:]
    rows = b * h * w
    empty = lambda width, dtype=cdt: torch.empty(  # noqa: E731
        (rows, width), dtype=dtype, device=x.device)
    # LN1's (then LN2's) output, qkv, the attention output, y in f32 and
    # bf16, the adapter's hidden and f32 output, the FFN hidden
    scratch = (empty(c), empty(3 * c), empty(c), empty(c, torch.float32), empty(c),
               empty(ca), empty(c, torch.float32), empty(hidden))
    out = torch.empty_like(x)
    KERNEL.call(
        ptr(x), *(ptr(t) for t in attn), ptr(region) if region is not None else None,
        *(ptr(t) for t in tail), *(ptr(t) for t in scratch), ptr(out),
        b, h, w, c, heads, ws, shift, hidden, ca, streams, int(mma),
        q_scale(scale, cdt), float(eps), float(adapter_scale),
    )
    return out

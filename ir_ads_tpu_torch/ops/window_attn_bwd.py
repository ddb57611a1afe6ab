"""K7: the backward of Swin window attention on windowed tensors: from the
recomputed qkv (BN, N, 3C) and the cotangent of the attention output
(BN, N, C) to dqkv, the recomputed attention output ``ow`` (for the
out-projection's weight gradient) and the rel-pos bias gradient ``dbias``
(heads, N, N) f32, summed over all windows.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_bwd_kernel (launched by
``pallas_window_attention_bwd``).  The CUDA source is
csrc/window_attn_bwd.cu; its header states the rounding points, the bound
and the two designs, which the wrapper chooses by shape alone
(``tensor_core_design``): d = C / heads of 32 and N = 144 (every Swin-B
stage) run on the tensor cores, other shapes the first design.  The
backward does not round ``q * scale`` as the forward does, so in bf16 its
recomputed probabilities are not bit-equal to the forward's; the port
follows the backward kernel.

``window_attention_bwd`` launches the kernel for CUDA tensors and runs
``window_attention_bwd_reference``, the plain version (the explicit
formula, not autograd of the forward), only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up,
)

KERNEL = CudaKernel(
    "window_attn_bwd", "window_attn_bwd", [VOIDP] * 7 + [INT] * 6 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_swin.py:2518",
)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
MMA_HEAD_DIM, MMA_TOKENS = 32, 144  # the tensor-core design's d and N


def tensor_core_design(n: int, d: int) -> bool:
    """Whether K7 takes its tensor-core design for N tokens of d channels a
    head; otherwise its first design."""
    return d == MMA_HEAD_DIM and n == MMA_TOKENS

Grads = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def window_attention_bwd_reference(qkvw, dow, bias, region, scale, heads,
                                   want_ow=True, want_dbias=True) -> Grads:
    """Plain PyTorch version, with the TPU kernel's rounding points."""
    cdt = qkvw.dtype
    bn, n, c3 = qkvw.shape
    c = c3 // 3
    d = c // heads
    heads_of = lambda t: up(t.reshape(bn, n, heads, d).transpose(1, 2))  # noqa: E731
    merge = lambda t: t.transpose(1, 2).reshape(bn, n, c)  # noqa: E731
    q, k, v = (heads_of(qkvw[..., i * c:(i + 1) * c]) for i in range(3))
    do = heads_of(dow)
    s = (q @ k.transpose(-1, -2)) * scale + up(bias)[None]
    if region is not None:
        nw = region.shape[0]
        neq = region[:, :, None] != region[:, None, :]  # (nW, N, N)
        mask = torch.where(neq, -1e9, 0.0).to(s.dtype)
        s = (s.reshape(bn // nw, nw, heads, n, n) + mask[None, :, None]).reshape(
            bn, heads, n, n)
    p = torch.softmax(s, dim=-1)
    pc = up(p.to(cdt))
    ow = merge(pc @ v).to(cdt) if want_ow else None
    dv = pc.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=0).to(bias.dtype) if want_dbias else None
    dsc = up((ds * scale).to(cdt))
    dq = dsc @ k
    dk = dsc.transpose(-1, -2) @ q
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(cdt)
    return dqkv, ow, dbias


def window_attention_bwd(
    qkvw: torch.Tensor,   # (B*nW, N, 3C) windowed qkv, recomputed
    dow: torch.Tensor,    # (B*nW, N, C) cotangent of the attention output
    bias: torch.Tensor,   # (heads, N, N) f32
    region: Optional[torch.Tensor],  # (nW, N) int32, or None when unshifted
    scale: float,
    heads: int,
    want_ow: bool = True,
    want_dbias: bool = True,
) -> Grads:
    """Returns (dqkv (B*nW, N, 3C), ow (B*nW, N, C) or None, dbias
    (heads, N, N) f32 or None).  ``want_ow`` / ``want_dbias`` False skip the
    output and its arithmetic."""
    bn, n, c3 = qkvw.shape
    c = c3 // 3
    if dow.shape != (bn, n, c) or bias.shape != (heads, n, n):
        raise ValueError(f"window_attention_bwd: shapes {qkvw.shape} {dow.shape} {bias.shape}")
    if qkvw.device.type == "cpu":
        return window_attention_bwd_reference(
            qkvw, dow, bias, region, scale, heads, want_ow, want_dbias)
    qkvw, dow = qkvw.contiguous(), dow.contiguous()
    bias = bias.float().contiguous()
    check_cuda("window_attention_bwd", qkvw, dow)
    check_cuda("window_attention_bwd", bias, dtype=torch.float32)
    d = c // heads
    tensor_cores = tensor_core_design(n, d)
    smem = 4 * n * (d + 8) * 2 + 2 * n * (n + 4) * 4 + 8 * 16 * 20 * 4 + 384
    if not tensor_cores and (n % 16 or d % 16 or c % 8 or smem > SMEM_LIMIT):
        raise ValueError(f"window_attention_bwd: unsupported shape N={n} C={c} heads={heads}")
    nw = bn
    if region is not None:
        region = region.to(device=qkvw.device, dtype=torch.int32).contiguous()
        nw = region.shape[0]
    dqkv = torch.empty_like(qkvw)
    ow = torch.empty_like(dow) if want_ow else None
    dbias = torch.zeros_like(bias) if want_dbias else None
    opt = lambda t: ptr(t) if t is not None else None  # noqa: E731
    KERNEL.call(ptr(qkvw), ptr(dow), ptr(bias), opt(region), ptr(dqkv), opt(ow),
                opt(dbias), bn, nw, n, c, heads, int(tensor_cores), float(scale))
    return dqkv, ow, dbias

"""K11: the w8a8 Swin block tail, out = x + FFN_w8a8(LN2 x) + 0.5 *
Adapter(x), on (N, C) token rows.

Replaces ir_ads_tpu/ops/pallas_mlp.py:_tail_kernel_int8 (launched by
``fused_block_tail_pallas`` under ``IR_ADS_INT8``).  The CUDA source is
csrc/block_tail_int8.cu; its header states the bound and the design.  The
FFN weights arrive quantized per output channel (``ops.int8.quantize_weight``
of the float weights, in (out, in) layout: s8 and an f32 scale each); the
other parameters are rounded to the compute dtype, as on the TPU.

``block_tail_int8`` launches the kernel for CUDA tensors and runs
``block_tail_int8_reference``, the plain version, only for CPU tensors.  It
has no backward and raises when an input requires a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, forbid_grad, ptr,
)
from ir_ads_tpu_torch.ops.int8 import int8_linear, layer_norm_rows

KERNEL = CudaKernel(
    "block_tail_int8", "block_tail_int8", [VOIDP] * 14 + [INT] * 4 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_mlp.py:75",
)


def block_tail_int8_reference(
    x, ln_w, ln_b, w1_q, s1, b1, w2_q, s2, b2, aw1, ab1, aw2, ab2, eps=1e-5,
    adapter_scale=0.5,
):
    """Plain PyTorch version, with the TPU kernel's rounding points: LN2
    rounded to the compute dtype, per-row s8 of it, the f32 GELU hidden NOT
    rounded and quantized over its whole row, the adapter in the compute
    dtype."""
    cdt = x.dtype
    xf = x.float()
    xn = layer_norm_rows(xf, ln_w.float(), ln_b.float(), eps)
    xn = xn.to(cdt).float()
    h = F.gelu(int8_linear(xn, w1_q, s1, floor_first=True) + b1.float(),
               approximate="tanh")
    ffn = int8_linear(h, w2_q, s2, floor_first=True) + b2.float()
    a = torch.relu(xf @ aw1.float().t() + ab1.float()).to(cdt).float()
    a = a @ aw2.float().t() + ab2.float()
    return (xf + ffn + adapter_scale * a).to(cdt)


def block_tail_int8(
    x: torch.Tensor,     # (N, C)
    ln_w: torch.Tensor,  # (C,)
    ln_b: torch.Tensor,
    w1_q: torch.Tensor,  # (H, C) s8
    s1: torch.Tensor,    # (H,) f32
    b1: torch.Tensor,
    w2_q: torch.Tensor,  # (C, H) s8
    s2: torch.Tensor,    # (C,) f32
    b2: torch.Tensor,
    aw1: torch.Tensor,   # (Ca, C)
    ab1: torch.Tensor,
    aw2: torch.Tensor,   # (C, Ca)
    ab2: torch.Tensor,
    eps: float = 1e-5,
    adapter_scale: float = 0.5,
) -> torch.Tensor:
    forbid_grad("block_tail_int8", x, ln_w, ln_b, b1, b2, aw1, ab1, aw2, ab2)
    cdt = x.dtype
    ln_w, ln_b, b1, b2, aw1, ab1, aw2, ab2 = (
        t.to(cdt).contiguous() for t in (ln_w, ln_b, b1, b2, aw1, ab1, aw2, ab2))
    w1_q, w2_q = w1_q.contiguous(), w2_q.contiguous()
    s1, s2 = s1.float().contiguous(), s2.float().contiguous()
    args = (ln_w, ln_b, w1_q, s1, b1, w2_q, s2, b2, aw1, ab1, aw2, ab2)
    if x.device.type == "cpu":
        return block_tail_int8_reference(x, *args, eps=eps, adapter_scale=adapter_scale)
    x = x.contiguous()
    check_cuda("block_tail_int8", x, ln_w, ln_b, b1, b2, aw1, ab1, aw2, ab2)
    check_cuda("block_tail_int8", w1_q, w2_q, dtype=torch.int8)
    check_cuda("block_tail_int8", s1, s2, dtype=torch.float32)
    n, c = x.shape
    hidden, ca = w1_q.shape[0], aw1.shape[0]
    if c % 64 or hidden % 64 or ca > 64 or 32768 // hidden < 1:
        raise ValueError(f"block_tail_int8: unsupported widths C={c} H={hidden} Ca={ca}")
    out = torch.empty_like(x)
    KERNEL.call(
        ptr(x), *(ptr(t) for t in args), ptr(out), n, c, hidden, ca,
        float(eps), float(adapter_scale),
    )
    return out

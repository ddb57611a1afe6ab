"""K11: the w8a8 Swin block tail, out = x + FFN_w8a8(LN2 x) + 0.5 *
Adapter(x), on (N, C) token rows.

Replaces ir_ads_tpu/ops/pallas_mlp.py:_tail_kernel_int8 (launched by
``fused_block_tail_pallas`` under ``IR_ADS_INT8``).  The CUDA source is
csrc/block_tail_int8.cu; its header states the bound and the design: six
launches (LN2 with the per-row s8 of its output, the adapter's two bf16
products on csrc/gemm_mma.cuh, the W1 product twice, for the row max of the
f32 hidden and then its s8 codes, and the W2 product), the s8 products on
csrc/igemm.cuh's TMA and wgmma GEMM, with the fused form's expressions as
epilogues: its bits.  The wrapper allocates the intermediates (the s8
hidden, N x 4C, is the largest).  The FFN weights arrive quantized per
output channel (``ops.int8.quantize_weight`` of the float weights, in (out,
in) layout: s8 and an f32 scale each); the other parameters are rounded to
the compute dtype, as on the TPU.

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
    "block_tail_int8", "block_tail_int8", [VOIDP] * 21 + [INT] * 4 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_mlp.py:75",
)
# Two entries of the same source for chip_smoke.py's checks: the W1 passes
# with the f32 hidden written out, and the s8 GEMM's raw s32 output.
HIDDEN = CudaKernel(
    "block_tail_int8_hidden", "block_tail_int8_hidden", [VOIDP] * 12 + [INT] * 3 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_mlp.py:75", unit="block_tail_int8",
)
IGEMM = CudaKernel(
    "igemm_s32", "igemm_s32", [VOIDP] * 3 + [INT] * 4,
    replaces="ir_ads_tpu/ops/pallas_mlp.py:75", unit="block_tail_int8",
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
    # TMA's row strides are multiples of 16 bytes; the epilogues write pairs
    if c % 16 or hidden % 16 or ca % 2:
        raise ValueError(f"block_tail_int8: unsupported widths C={c} H={hidden} Ca={ca}")
    empty = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    # xq, sx, the row max of |hidden|, the adapter's hidden and f32 output,
    # the s8 hidden and its scales
    scratch = (empty(n, c, dtype=torch.int8), empty(n), empty(n), empty(n, ca, dtype=cdt),
               empty(n, c), empty(n, hidden, dtype=torch.int8), empty(n))
    out = torch.empty_like(x)
    KERNEL.call(
        ptr(x), *(ptr(t) for t in args), *(ptr(t) for t in scratch), ptr(out), n, c, hidden,
        ca, float(eps), float(adapter_scale),
    )
    return out


def block_tail_int8_hidden(x, ln_w, ln_b, w1_q, s1, b1, eps=1e-5):
    """The W1 passes of ``block_tail_int8`` on the card, for their check:
    (xq, sx, rowmax, hq, sh, h), h the f32 hidden written out by the helper
    both passes compute it with.  Not counted as a launch of K11."""
    cdt = x.dtype
    ln_w, ln_b, b1 = (t.to(cdt).contiguous() for t in (ln_w, ln_b, b1))
    x, w1_q, s1 = x.contiguous(), w1_q.contiguous(), s1.float().contiguous()
    check_cuda("block_tail_int8_hidden", x, ln_w, ln_b, b1)
    check_cuda("block_tail_int8_hidden", w1_q, dtype=torch.int8)
    n, c = x.shape
    hidden = w1_q.shape[0]
    new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    outs = (new(n, c, dtype=torch.int8), new(n), new(n), new(n, hidden, dtype=torch.int8),
            new(n), new(n, hidden))
    HIDDEN.call(ptr(x), ptr(ln_w), ptr(ln_b), ptr(w1_q), ptr(s1), ptr(b1),
                *(ptr(t) for t in outs), n, c, hidden, float(eps))
    return outs


def igemm_s32(a: torch.Tensor, w: torch.Tensor, k: int = 0) -> torch.Tensor:
    """The s8 GEMM's raw output on the card: a (M, K) s8 . w (N, K)^T ->
    (M, N) int32.  ``k`` < K takes only the first k of the depth (a planted
    fault).  Not counted as a launch of K11."""
    check_cuda("igemm_s32", a, w, dtype=torch.int8)
    m, kk = a.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    IGEMM.call(ptr(a), ptr(w), ptr(out), m, n, k or kk, kk)
    return out


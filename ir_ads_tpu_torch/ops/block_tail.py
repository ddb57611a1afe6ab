"""K2: the Swin block tail, out = x + FFN(LN2 x) + 0.5 * Adapter(x), on
(N, C) token rows.

Replaces ir_ads_tpu/ops/pallas_mlp.py:_tail_kernel (launched by
``fused_block_tail_pallas``; twin ``block_tail_reference``).  The CUDA source
is csrc/block_tail.cu; its header states the bound and the design: five
launches (the adapter's two products, LN2, the FFN's two products), the
products on csrc/gemm_mma.cuh with the fused form's expressions as
epilogues, in its order.  The wrapper allocates the intermediates (the FFN
hidden, N x 4C bf16, is the largest).  Weights are in torch Linear layout
(out, in) and, as on the TPU, every parameter is rounded to the compute
dtype before use.

``block_tail`` launches the kernel for CUDA tensors and runs
``block_tail_reference``, the plain version, only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, forbid_grad, ptr,
)

KERNEL = CudaKernel(
    "block_tail", "block_tail", [VOIDP] * 16 + [INT] * 4 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_mlp.py:35",
)


def block_tail_reference(
    x, ln_w, ln_b, w1, b1, w2, b2, aw1, ab1, aw2, ab2, eps=1e-5,
    adapter_scale=0.5,
):
    """Plain PyTorch version, with the TPU kernel's rounding points."""
    cdt = x.dtype
    xf = x.float()
    xn = F.layer_norm(xf, (x.shape[-1],), ln_w.float(), ln_b.float(), eps)
    xn = xn.to(cdt).float()
    h = F.gelu(xn @ w1.float().t() + b1.float(), approximate="tanh")
    h = h.to(cdt).float()
    ffn = h @ w2.float().t() + b2.float()
    a = torch.relu(xf @ aw1.float().t() + ab1.float()).to(cdt).float()
    a = a @ aw2.float().t() + ab2.float()
    return (xf + ffn + adapter_scale * a).to(cdt)


def block_tail(
    x: torch.Tensor,     # (N, C)
    ln_w: torch.Tensor,  # (C,)
    ln_b: torch.Tensor,
    w1: torch.Tensor,    # (H, C)
    b1: torch.Tensor,
    w2: torch.Tensor,    # (C, H)
    b2: torch.Tensor,
    aw1: torch.Tensor,   # (Ca, C)
    ab1: torch.Tensor,
    aw2: torch.Tensor,   # (C, Ca)
    ab2: torch.Tensor,
    eps: float = 1e-5,
    adapter_scale: float = 0.5,
) -> torch.Tensor:
    forbid_grad("block_tail", x, ln_w, ln_b, w1, b1, w2, b2, aw1, ab1, aw2, ab2)
    cdt = x.dtype
    params = tuple(
        t.to(cdt).contiguous()
        for t in (ln_w, ln_b, w1, b1, w2, b2, aw1, ab1, aw2, ab2)
    )
    if x.device.type == "cpu":
        return block_tail_reference(x, *params, eps=eps,
                                    adapter_scale=adapter_scale)
    x = x.contiguous()
    check_cuda("block_tail", x, *params)
    n, c = x.shape
    hidden, ca = params[2].shape[0], params[6].shape[0]
    # the GEMMs' epilogues write output pairs
    if c % 2 or hidden % 2 or ca % 2:
        raise ValueError(f"block_tail: unsupported widths C={c} H={hidden} Ca={ca}")
    empty = lambda width, dtype=cdt: torch.empty(  # noqa: E731
        (n, width), dtype=dtype, device=x.device)
    # the adapter's hidden and f32 output (the W2 GEMM's init), LN2's
    # output, the FFN hidden
    scratch = (empty(ca), empty(c, torch.float32), empty(c), empty(hidden))
    out = torch.empty_like(x)
    KERNEL.call(
        ptr(x), *(ptr(t) for t in params), *(ptr(t) for t in scratch), ptr(out),
        n, c, hidden, ca, float(eps), float(adapter_scale),
    )
    return out

"""K3: the DSCF continuous relative-position bias in the rows layout
(BG, hg, h, M, w): a bilinear sample of the learned table at the
displacement between every query pixel and every deformable key.

Replaces ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_rows_kernel (launched by
``dscf_rpe_bias_rows_pallas``; twin ``dscf_rpe_bias_rows_reference``).  The
CUDA source is csrc/dscf_rpe.cu; its header states the bound and the design.
BG = B * G is group-minor: row bg uses table group bg % G.

``rpe_bias_rows`` launches the kernel for CUDA tensors and runs
``rpe_bias_rows_reference``, the plain version (the twin's hat-weight
products, in f32), only for CPU tensors.  The kernel computes in f32 and
rounds once to bf16 on store; against the f32 twin it agrees to bf16
rounding (relative 2^-8) on top of the twin tests' 1e-5.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import INT, VOIDP, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "dscf_rpe", "dscf_rpe_rows", [VOIDP] * 3 + [INT] * 8,
    replaces="ir_ads_tpu/ops/pallas_dscf_rpe.py:182",
)


def rpe_bias_f32(pos, table, h, w, order):
    """The bias in f32 by separable hat-weight products, with the output
    axes in ``order`` over (b, e, m, h, w) = (BG, hg, M, h, w)."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    dev = pos.device
    ay = (s1 - 1.0) / (2.0 * (h - 1.0))
    ax = (s2 - 1.0) / (2.0 * (w - 1.0))
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)  # noqa: E731
    pos = pos.float()
    by = (0.5 - 0.5 * pos[..., 0]) * 0.5 * (s1 - 1.0)  # (BG, M)
    bx = (0.5 - 0.5 * pos[..., 1]) * 0.5 * (s2 - 1.0)
    iy = ay * ar(h)[None, None, :] + by[..., None]  # (BG, M, h)
    ix = ax * ar(w)[None, None, :] + bx[..., None]  # (BG, M, w)
    wy = torch.clamp(1.0 - (iy[..., None] - ar(s1)).abs(), min=0.0)  # (BG,M,h,S1)
    wx = torch.clamp(1.0 - (ix[..., None] - ar(s2)).abs(), min=0.0)  # (BG,M,w,S2)
    tb = table.float()[torch.arange(bg, device=dev) % g]  # (BG, hg, S1, S2)
    u = torch.einsum("best,bmwt->bmesw", tb, wx)
    return torch.einsum(f"bmhs,bmesw->{order}", wy, u)


def rpe_bias_rows_reference(pos, table, h, w, out_dtype):
    """Plain PyTorch version: separable hat-weight products in f32."""
    return rpe_bias_f32(pos, table, h, w, "behmw").to(out_dtype)  # (BG, hg, h, M, w)


def rpe_bias_rows(
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Returns the bias (BG, hg, h, M, w) in ``out_dtype``."""
    if h < 2 or w < 2:
        raise ValueError(f"rpe_bias_rows: query plane {h}x{w} needs h, w >= 2")
    pos = pos.float().contiguous()
    table = table.float().contiguous()
    if pos.device.type == "cpu":
        return rpe_bias_rows_reference(pos, table, h, w, out_dtype)
    check_cuda("rpe_bias_rows", pos, table, dtype=torch.float32)
    if out_dtype != torch.bfloat16:
        raise ValueError("rpe_bias_rows: the CUDA kernel stores bf16")
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    out = torch.empty((bg, hg, h, m, w), dtype=out_dtype, device=pos.device)
    KERNEL.call(ptr(pos), ptr(table), ptr(out), bg, g, hg, h, m, w, s1, s2)
    return out

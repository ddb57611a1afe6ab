"""K6: the DSCF continuous relative-position bias in the packed layout
(BG, hg, M, h*w), with the query plane flat and minor.  It is K3's function
(ops/dscf_rpe.py) in another layout; the level-3 einsum attention adds it to
its (B, heads, h*w, M) scores.

Replaces ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_packed_kernel (launched by
``dscf_rpe_bias_packed_pallas``; twin ``dscf_rpe_bias_packed_reference``).
The CUDA entry point ``dscf_rpe_packed`` lives in csrc/dscf_rpe.cu beside
K3's and K18's and runs their kernel template in K3's rounding and K18's
layout; the header states the bound and the design.  BG = B * G is group-minor: row bg uses table group bg % G.

``rpe_bias_packed`` launches the kernel for CUDA tensors and runs
``rpe_bias_packed_reference``, the plain version, only for CPU tensors: in
bf16 K3's ``rpe_bias_bf16`` (the TPU kernel's rounding points, which the
CUDA kernel computes bit for bit), in f32 the twin's hat-weight products.
``rpe_bias_packed`` is differentiable in
``pos`` and ``table`` through ``dscf_rpe.RpeBias`` (a recompute through
``rpe_bias_f32`` under autograd), recorded only where a gradient is wanted.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.dscf_rpe import (
    check_plane, rpe_bias_bf16, rpe_bias_f32, slopes, with_grad,
)

KERNEL = CudaKernel(
    "dscf_rpe_packed", "dscf_rpe_packed", [VOIDP] * 3 + [INT] * 8 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_dscf_rpe.py:317", unit="dscf_rpe",
)


def rpe_bias_packed_reference(pos, table, h, w, out_dtype):
    """Plain PyTorch version: the TPU kernel's bf16 rounding points when it
    stores bf16, else the hat-weight products in f32."""
    build = rpe_bias_bf16 if out_dtype == torch.bfloat16 else rpe_bias_f32
    bias = build(pos, table, h, w, "bemhw")  # (BG, hg, M, h, w)
    return bias.flatten(3).to(out_dtype)


def _packed_forward(pos, table, h, w, out_dtype):
    pos, table = pos.contiguous(), table.contiguous()
    if pos.device.type == "cpu":
        return rpe_bias_packed_reference(pos, table, h, w, out_dtype)
    check_cuda("rpe_bias_packed", pos, table, dtype=torch.float32)
    if out_dtype != torch.bfloat16:
        raise ValueError("rpe_bias_packed: the CUDA kernel stores bf16")
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    check_plane("rpe_bias_packed", s1, s2, h, bf16_pairs=True)
    out = torch.empty((bg, hg, m, h * w), dtype=out_dtype, device=pos.device)
    KERNEL.call(ptr(pos), ptr(table), ptr(out), bg, g, hg, h, m, w, s1, s2,
                *slopes(s1, s2, h, w))
    return out


def rpe_bias_packed(
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Returns the bias (BG, hg, M, h*w) in ``out_dtype``."""
    if h < 2 or w < 2:
        raise ValueError(f"rpe_bias_packed: query plane {h}x{w} needs h, w >= 2")
    return with_grad(pos, table, h, w, out_dtype, "bemhw", _packed_forward)

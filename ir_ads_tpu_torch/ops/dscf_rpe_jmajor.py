"""K18: the DSCF continuous relative-position bias in the j-major layout
(BG, hg, M, h, w), in the f32 form of the pallas2 DSCF's bias kernel.

Replaces ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_kernel (launched by
``dscf_rpe_bias_pallas``; twin ``dscf_rpe_bias_reference``), which the
reference's DAttentionMM runs under ``pallas2`` before transposing the bias
into ``_dscf_kernel``'s packed layout (K17, ops/dscf_attention.py).  The
CUDA entry point ``dscf_rpe_jmajor`` lives in csrc/dscf_rpe.cu beside K3's
and K6's; the header states the bound and the design.  BG = B * G is
group-minor: row bg uses table group bg % G.

The function is K3's and K6's sample with other rounding points:
``_rpe_kernel`` computes its hat weights in the f32 order
``(ay*r + by) - s`` and keeps them, the table and the partial product u in
f32 whatever it stores; the output is rounded once.  That is the twin's
form, ``dscf_rpe.rpe_bias_f32``, so the plain version
``rpe_bias_jmajor_reference`` is ``rpe_bias_f32`` in the ``bemhw`` order,
rounded once (not K3's ``rpe_bias_bf16``).  The CUDA kernel computes it in
the 2 x 2-tap form; where an f32 dot fuses a multiply-add, an output near a
bf16 rounding boundary can land one bf16 ulp away.

``rpe_bias_jmajor`` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors.  It is differentiable in ``pos`` and
``table`` through ``dscf_rpe.RpeBias`` (a recompute through
``rpe_bias_f32`` under autograd), as ``_rpe_bwd`` recomputes through the
twin.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.dscf_rpe import RpeBias, hat_slopes, rpe_bias_f32

KERNEL = CudaKernel(
    "dscf_rpe_jmajor", "dscf_rpe_jmajor", [VOIDP] * 3 + [INT] * 8 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_dscf_rpe.py:75", unit="dscf_rpe",
)


def rpe_bias_jmajor_reference(pos, table, h, w, out_dtype):
    """Plain PyTorch version: the twin's f32 hat-weight products, rounded
    once to ``out_dtype``."""
    return rpe_bias_f32(pos, table, h, w, "bemhw").to(out_dtype)  # (BG, hg, M, h, w)


def _jmajor_forward(pos, table, h, w, out_dtype):
    pos, table = pos.contiguous(), table.contiguous()
    if pos.device.type == "cpu":
        return rpe_bias_jmajor_reference(pos, table, h, w, out_dtype)
    check_cuda("rpe_bias_jmajor", pos, table, dtype=torch.float32)
    if out_dtype != torch.bfloat16:
        raise ValueError("rpe_bias_jmajor: the CUDA kernel stores bf16")
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    out = torch.empty((bg, hg, m, h, w), dtype=out_dtype, device=pos.device)
    KERNEL.call(ptr(pos), ptr(table), ptr(out), bg, g, hg, h, m, w, s1, s2,
                *hat_slopes(s1, s2, h, w))
    return out


def rpe_bias_jmajor(
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Returns the bias (BG, hg, M, h, w) in ``out_dtype``."""
    if h < 2 or w < 2:
        raise ValueError(f"rpe_bias_jmajor: query plane {h}x{w} needs h, w >= 2")
    return RpeBias.apply(pos.float(), table.float(), h, w, out_dtype, "bemhw",
                         _jmajor_forward)

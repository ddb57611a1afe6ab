"""K8: the backward of DSCF deformable attention in the rows layout: from
q, k, v, the K3 bias and the output cotangent to dq, dk, dv and dbias, each
in the layout the forward read (dbias leaves in the rows layout and feeds
the bias kernel's backward with no transpose).

Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_rows_bwd_kernel (launched by
``pallas_dscf_rows_bwd``).  The CUDA source is csrc/dscf_rows_bwd.cu; its
header states the rounding points, the bound and the design (the four
products on the tensor cores, key-major, 64-pixel tiles).  As in K7, the
backward does not round ``q * scale``; keys past M have probability 0 and
get zero dk, dv.  The kernel takes heads of 8 channels (every Swin-B DSCF
level) or 12 (every Swin-L level), image rows of whole 8-pixel n-tiles (w
% 8 == 0: 160, 80, 40 and 20 at the four DSCF levels of a 480x640 tile) and
up to MAX_KEYS[hc] keys (K, V and the block's dK, dV sums live in shared
memory).

``dscf_rows_bwd`` launches the kernel for CUDA tensors and runs
``dscf_rows_bwd_reference``, the plain version (the explicit formula), only
for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up,
)

KERNEL = CudaKernel(
    "dscf_rows_bwd", "dscf_rows_bwd", [VOIDP] * 9 + [INT] * 6 + [FLOAT, INT],
    replaces="ir_ads_tpu/ops/pallas_dscf.py:681",
)
HEAD_CHANNELS = 8  # K16's and K17's channels per head (every Swin-B DSCF level)
ROWS_HEAD_CHANNELS = (8, 12)  # K4's and K8's: Swin-B's and Swin-L's
# of the 227 KB of shared memory a block may take: 96 bytes a key and 14 KB
# besides at 8 channels, 160 bytes and 20 KB at 12 (keys in steps of 16)
MAX_KEYS = {8: 2272, 12: 1312}

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def dscf_rows_bwd_reference(q, k, v, bias, dout, scale, hg) -> Grads:
    """Plain PyTorch version, with the TPU kernel's rounding points.
    Returns (dq in q's dtype, dk, dv, dbias in the accumulation dtype)."""
    bg, hw, gc = q.shape
    mp = k.shape[1]
    _, _, h, m, w = bias.shape
    hc = gc // hg
    cdt = q.dtype
    heads_of = lambda t, n: up(t.reshape(bg, n, hg, hc).transpose(1, 2))  # noqa: E731
    qh, doh = heads_of(q, hw), heads_of(dout, hw)  # (BG, hg, HW, hc)
    kh, vh = heads_of(k[:, :m], m), heads_of(v[:, :m], m)  # (BG, hg, M, hc)
    bh = up(bias).permute(0, 1, 2, 4, 3).reshape(bg, hg, hw, m)
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * scale + bh, dim=-1)
    pc = up(p.to(cdt))
    dv = pc.transpose(-1, -2) @ doh  # (BG, hg, M, hc)
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.reshape(bg, hg, h, w, m).permute(0, 1, 2, 4, 3).contiguous()
    dsc = up((ds * scale).to(cdt))
    dq = (dsc @ kh).transpose(1, 2).reshape(bg, hw, gc).to(cdt)
    dk = dsc.transpose(-1, -2) @ qh
    keys = lambda t: F.pad(t.transpose(1, 2).reshape(bg, m, gc), (0, 0, 0, mp - m))  # noqa: E731
    return dq, keys(dk), keys(dv), dbias


def dscf_rows_bwd(
    q: torch.Tensor,     # (BG, h*w, GC)
    k: torch.Tensor,     # (BG, Mp, GC)
    v: torch.Tensor,     # (BG, Mp, GC)
    bias: torch.Tensor,  # (BG, hg, h, M, w)
    dout: torch.Tensor,  # (BG, h*w, GC) cotangent of the attention output
    scale: float,
    hg: int,
) -> Grads:
    """Returns (dq (BG, h*w, GC) in q's dtype, dk and dv (BG, Mp, GC) f32,
    dbias (BG, hg, h, M, w) f32)."""
    bg, hw, gc = q.shape
    mp = k.shape[1]
    _, _, h, m, w = bias.shape
    if hw != h * w or m > mp or dout.shape != q.shape:
        raise ValueError(f"dscf_rows_bwd: shapes {q.shape} {k.shape} {bias.shape} {dout.shape}")
    if q.device.type == "cpu":
        return dscf_rows_bwd_reference(q, k, v, bias, dout, scale, hg)
    q, k, v, bias, dout = (t.contiguous() for t in (q, k, v, bias, dout))
    check_cuda("dscf_rows_bwd", q, k, v, bias, dout)
    hc = gc // hg
    if gc != hg * hc or hc not in ROWS_HEAD_CHANNELS or w % 8 or m > MAX_KEYS[hc]:
        raise ValueError(f"dscf_rows_bwd: needs {ROWS_HEAD_CHANNELS} channels per head, "
                         f"w % 8 == 0 and at most MAX_KEYS[hc] keys ({MAX_KEYS}); got "
                         f"{q.shape} {bias.shape} with {hg} heads")
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    KERNEL.call(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(dout), ptr(dq), ptr(dk),
                ptr(dv), ptr(dbias), bg, hg, h, w, m, mp, float(scale), hc)
    return dq, dk, dv, dbias

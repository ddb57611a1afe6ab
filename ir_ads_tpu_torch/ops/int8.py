"""w8a8 dynamic quantization for the ``r4i8`` eval dispatch: weights
symmetric per output channel, activations symmetric per row (per tensor for
the 3x3 convolution), s8 x s8 products accumulated exactly in int32.

Counterpart of ir_ads_tpu/ops/int8.py (``quantized_matmul``,
``quantized_conv``, ``QuantConv``, ``QuantDense``) and of
``pallas_mlp.quantize_weight``, with weights in torch layout: a linear's
(out, in), a convolution's (out, in, kh, kw); output channel o's scale is
taken over everything else.  Two orders of the scale's floor appear in the
reference and both are kept, since they differ for an all-but-zero row:
``max(max|w|, 1e-12) / 127`` (``floor_first``: ``quantize_weight`` and the
kernels' activation rows) and ``max(max|w| / 127, 1e-12)``
(``quantized_matmul``'s weights and activations, ``quantized_conv``'s
weights).  Values are rounded half to even (``torch.round``, as
``jnp.round``), by true division by the scale.

The s8 products that the JAX package leaves to XLA (the DSCF projections and
the fuse convolution, the heads' composed projections) are ``torch._int_mm``
here, on the card and on the CPU; the Swin half-block and tail run theirs in
their kernels (ops/swin_block_int8.py, ops/block_tail_int8.py).  No int8
product is emulated in f32: K * 127^2 passes 2^24 once K > 1040.

A module of an int8 dispatch keeps its quantized weights as non-persistent
buffers named ``int8_*`` (the state_dict keeps the reference's names) and
makes them in ``quantize_int8_(dtype)``; ``quantize_int8_(model, dtype)``
below calls every such module.  Quantize after the float weights are loaded
and before the model is cast to its compute dtype: the reference quantizes
its f32 parameters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

QMAX = 127.0
FLOOR = 1e-12
PREFIX = "int8_"  # buffer names of the quantized weights


def _scale(amax: torch.Tensor, floor_first: bool) -> torch.Tensor:
    if floor_first:
        return torch.clamp(amax, min=FLOOR) / QMAX
    return torch.clamp(amax / QMAX, min=FLOOR)


def _round(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -QMAX, QMAX).to(torch.int8)


def quantize_weight(w: torch.Tensor, floor_first: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_q s8 of w's shape, scale (out,) f32), per output channel (dim 0)."""
    wf = w.float()
    s = _scale(wf.abs().flatten(1).amax(dim=1), floor_first)
    return _round(wf / s.reshape(-1, *(1,) * (w.ndim - 1))), s


def quantize_rows(x: torch.Tensor, floor_first: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_q s8, scale (..., 1) f32), one scale per row of the last axis."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=-1, keepdim=True), floor_first)
    return _round(xf / s), s


def layer_norm_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in the order the int8 kernels compute it
    (mean, centred variance, rsqrt, then scale and shift), in x's dtype: an
    ulp of difference here can flip an s8 code downstream."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps) * w + b


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) s8 @ w (N, K)^T s8 -> (M, N) int32 by ``torch._int_mm``.  On
    the card its shape rules (M > 16, K and N multiples of 8) are met by
    zero padding, which adds nothing to the sums."""
    m, k = a.shape
    n = w.shape[0]
    if a.is_cuda:
        mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        if (mp, kp) != (m, k):
            a = F.pad(a, (0, kp - k, 0, mp - m))
        if (np_, kp) != (n, k):
            w = F.pad(w, (0, kp - k, 0, np_ - n))
        return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]
    return torch._int_mm(a.contiguous(), w.contiguous().t())


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                floor_first: bool = False) -> torch.Tensor:
    """x (..., K) float @ a pre-quantized (N, K) weight -> (..., N) f32:
    per-row activation scale, int32 sums, ``(acc * s_x) * s_w``."""
    xq, sx = quantize_rows(x, floor_first)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), w_q)
    return (acc.float().reshape(*x.shape[:-1], -1) * sx) * s_w.float()


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``ir_ads_tpu.ops.int8.quantized_matmul`` with w in (N, K) layout."""
    return int8_linear(x, *quantize_weight(w, floor_first=False))


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
              padding: int) -> torch.Tensor:
    """Stride-1 convolution of an NHWC map by a pre-quantized (N, Cin, kh,
    kw) weight -> (B, H', W', N) f32, with ONE activation scale over the
    whole tensor (a per-pixel scale cannot factor out of a tap sum): the
    batch's tiles share it, as in the reference.  The product is im2col
    (taps in (kh, kw, Cin) order) + ``int_mm``."""
    b, h, w, c = x.shape
    n, _, kh, kw = w_q.shape
    xf = x.float()
    s_x = torch.clamp(xf.abs().amax(), min=FLOOR) / QMAX
    xq = _round(xf / s_x)
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    ho, wo = xq.shape[1] - kh + 1, xq.shape[2] - kw + 1
    cols = torch.cat([xq[:, i:i + ho, j:j + wo] for i in range(kh) for j in range(kw)],
                     dim=-1)
    acc = int_mm(cols.reshape(-1, kh * kw * c),
                 w_q.permute(0, 2, 3, 1).reshape(n, kh * kw * c))
    return (acc.float().reshape(b, ho, wo, n) * s_x) * s_w.float()


def quantized_conv(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """``ir_ads_tpu.ops.int8.quantized_conv`` with w in (N, Cin, kh, kw)."""
    return int8_conv(x, *quantize_weight(w, floor_first=False), padding)


def set_int8_weight(module: nn.Module, name: str, w: torch.Tensor,
                    floor_first: bool = True) -> None:
    """Quantize w into the non-persistent buffers ``int8_<name>`` (s8) and
    ``int8_<name>_scale`` (f32) of ``module``."""
    q, s = quantize_weight(w.detach(), floor_first)
    module.register_buffer(PREFIX + name, q.to(w.device), persistent=False)
    module.register_buffer(PREFIX + name + "_scale", s.to(w.device), persistent=False)


def int8_weight(module: nn.Module, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The buffers ``set_int8_weight`` made; raises if they were not made."""
    q = getattr(module, PREFIX + name, None)
    if q is None:
        raise RuntimeError(
            f"{type(module).__name__}: its int8 weights are not made; call "
            "ops.int8.quantize_int8_(model) after the float weights are loaded")
    return q, getattr(module, PREFIX + name + "_scale")


def quantize_int8_(model: nn.Module, dtype: Optional[torch.dtype] = None) -> int:
    """Quantize every int8 site of ``model`` from its current float weights
    (``dtype``: the compute dtype, which the heads round their composed
    projection to first, as the reference does; None keeps f32).  Returns
    the number of modules quantized."""
    mods = [m for m in model.modules() if getattr(m, "int8", False)]
    with torch.no_grad():
        for m in mods:
            m.quantize_int8_(dtype)
    return len(mods)

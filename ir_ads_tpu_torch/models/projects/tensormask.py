"""SwapAlign2Nat, TensorMask's native op, as indexing: counterpart of
ir_ads_tpu/models/projects/tensormask.py (detectron2 projects/TensorMask
SwapAlign2Nat_cuda.cu and layers/swap_align2nat.py).

Mask predictions in the aligned form (N, H, W, V*U), V == U, go to the
natural form (N, ceil(H/l), ceil(W/l), (l V) * (l U)): each output is the
quadrilinear interpolation of the input at

    y' = y*l + v - l V/2 + 0.5        v' = (v + 0.5)/l - 0.5
    x' = x*l + u - l U/2 + 0.5        u' = (u + 0.5)/l - 0.5

with ``pad_val`` outside the tensor (-6: sigmoid(-6) is about 0, no mask).
Autograd through the gathers gives the reference's hand-written backward.
"""

from __future__ import annotations

import torch
from torch import nn


def swap_align2nat(x: torch.Tensor, lambda_val: int, pad_val: float = -6.0) -> torch.Tensor:
    """x (N, H, W, V*U) with V == U -> (N, ceil(H/l), ceil(W/l), (lV)*(lU))."""
    if lambda_val < 1:
        raise ValueError("lambda should be greater or equal to 1")
    n, hin, win, c = x.shape
    vin = int(round(c ** 0.5))
    uin = c // vin
    if vin * uin != c or vin != uin:
        raise ValueError("#channels must be a square number")
    lam = float(lambda_val)
    vout, uout = lambda_val * vin, lambda_val * uin
    hout, wout = -(-hin // lambda_val), -(-win // lambda_val)
    xr = x.float().reshape(n, hin, win, vin, uin)
    dev = x.device
    vg, ug, yg, wg = torch.meshgrid(
        *(torch.arange(k, dtype=torch.float32, device=dev) for k in (vout, uout, hout, wout)),
        indexing="ij")
    oy = yg * lam + vg - vout / 2.0 + 0.5
    ox = wg * lam + ug - uout / 2.0 + 0.5
    ov = (vg + 0.5) / lam - 0.5
    ou = (ug + 0.5) / lam - 0.5
    yf, xf, vf, uf = (torch.floor(t) for t in (oy, ox, ov, ou))
    ywc, xwc, vwc, uwc = oy - yf, ox - xf, ov - vf, ou - uf
    yf, xf, vf, uf = (t.long() for t in (yf, xf, vf, uf))

    out = torch.zeros((n, vout, uout, hout, wout), dtype=torch.float32, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            for dv in (0, 1):
                for du in (0, 1):
                    wgt = ((ywc if dy else 1.0 - ywc) * (xwc if dx else 1.0 - xwc)
                           * (vwc if dv else 1.0 - vwc) * (uwc if du else 1.0 - uwc))
                    yi, xi, vi, ui = yf + dy, xf + dx, vf + dv, uf + du
                    inb = ((yi >= 0) & (yi < hin) & (xi >= 0) & (xi < win)
                           & (vi >= 0) & (vi < vin) & (ui >= 0) & (ui < uin))
                    vals = xr[:, yi.clamp(0, hin - 1), xi.clamp(0, win - 1),
                              vi.clamp(0, vin - 1), ui.clamp(0, uin - 1)]
                    out = out + wgt[None] * torch.where(inb[None], vals,
                                                        torch.full_like(vals, pad_val))
    return out.permute(0, 3, 4, 1, 2).reshape(n, hout, wout, vout * uout).to(x.dtype)


class SwapAlign2Nat(nn.Module):
    """Module form of ``swap_align2nat`` (swap_align2nat.py)."""

    def __init__(self, lambda_val: int, pad_val: float = -6.0):
        super().__init__()
        if lambda_val < 1:
            raise ValueError("lambda should be greater or equal to 1")
        self.lambda_val, self.pad_val = lambda_val, pad_val

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swap_align2nat(x, self.lambda_val, self.pad_val)

    def extra_repr(self) -> str:
        return f"lambda_val={self.lambda_val}, pad_val={self.pad_val}"

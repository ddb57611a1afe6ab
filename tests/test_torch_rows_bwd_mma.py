"""The order in which K8 sums on the tensor cores (csrc/dscf_rows_bwd.cu),
against the JAX package's rows backward kernel, interpreted, on the CPU in
bf16.

``_dscf_rows_bwd_kernel`` (ir_ads_tpu/ops/pallas_dscf.py) computes the
key-major scores sT = k.q^T in f32, s = sT * scale + bias, P = exp(s - max)
/ den, dV = bf16(P)^T dO, dP = v.dO, dS = P (dP - sum dP P), dbias = dS, and
dq, dK from bf16(dS * scale).  On the card K8 takes 64-pixel tiles of a
(bg, head) plane with four warps that split the keys by 16-key m-tiles
(warp w: m-tiles w, w + 4, ...).  ``mma_order`` below is its order in plain
torch (torch's f32 product of 8 channels, or of one 16-deep step, stands
for the tensor cores' own sum, which is not known):

  * pass 1: lane row g of warp w sees keys 16 m + g and 16 m + g + 8 of its
    m-tiles m in that order and keeps max, den and sum e dP online, one exp
    a key; the 8 lane rows meet by a xor butterfly (g ^ 1, g ^ 2, g ^ 4),
    the warps in warp order;
  * P = e / den, a true division; dS = P (dP - acc / den);
  * dV and dK: over each tile's 64 pixels in four 16-pixel steps, then
    tile after tile; dq: over each warp's m-tiles in order, 16 keys a step,
    then the warps in order, rounded once.

It must meet chip_smoke.py's ``check_rows_bwd`` bars against the
interpreted kernel (atol a share of each output's rms: dq 0.05, dk and dv
0.01, dbias 1e-3; rtol 2e-2, 2e-2, 2e-2, 1e-3), with M < Mp among the
cases and planes that end inside a tile, and the planted fault (dbias
scaled by the attention scale) must fail them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_dscf import pallas_dscf_rows_bwd

BF16 = torch.bfloat16
WARPS, TILE, HC = 4, 64, 8
FLT_MAX = float(torch.finfo(torch.float32).max)
# chip_smoke.py's check_rows_bwd: (atol as a share of rms, rtol) per output
BARS = {"dq": (0.05, 2e-2), "dk": (0.01, 2e-2), "dv": (0.01, 2e-2), "dbias": (1e-3, 1e-3)}


def fma(a, b, c):
    """f32 a * b + c rounded once (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def online_add(st, s, dp):
    """``Stats::add``: one more key against the larger of the two maxima."""
    mx, den, acc = st
    hi = torch.maximum(mx, s)
    ex = torch.exp(torch.minimum(mx, s) - hi)
    up = s > mx
    den = torch.where(up, fma(den, ex, torch.ones_like(ex)), den + ex)
    acc = torch.where(up, fma(acc, ex, dp), fma(ex, dp, acc))
    return hi, den, acc


def merge(a, b):
    """``Stats::merge``: a's statistics with b's."""
    (m1, d1, a1), (m2, d2, a2) = a, b
    hi = torch.maximum(m1, m2)
    f1, f2 = torch.exp(m1 - hi), torch.exp(m2 - hi)
    return hi, fma(d1, f1, d2 * f2), fma(a1, f1, a2 * f2)


def mma_order(q, k, v, bias, dout, scale, hg):
    """K8's function in its order of sums; the arguments and results of
    ``dscf_rows_bwd_reference``."""
    bg, hw, gc = q.shape
    mp = k.shape[1]
    _, _, h, m, w = bias.shape
    mt = -(-m // 16)
    steps = -(-mt // WARPS)            # m-tiles a warp
    keys = 16 * WARPS * steps          # padded with -inf scores and zero rows
    hwp = -(-hw // TILE) * TILE        # pixels padded to whole tiles, q = dO = 0

    def heads(t, n, rows):
        t = t.float().reshape(bg, n, hg, HC).transpose(1, 2)
        return F.pad(t, (0, 0, 0, rows - n))

    qh, doh = heads(q, hw, hwp), heads(dout, hw, hwp)
    kh, vh = heads(k[:, :m], m, keys), heads(v[:, :m], m, keys)
    bh = bias.float().permute(0, 1, 2, 4, 3).reshape(bg, hg, hw, m)
    bh = F.pad(F.pad(bh, (0, keys - m), value=float("-inf")), (0, 0, 0, hwp - hw))
    s = (qh @ kh.transpose(-1, -2)) * scale + bh          # (BG, hg, HWp, keys)
    dp = doh @ vh.transpose(-1, -2)

    # pass 1: key 16 (w + 4 j) + 8 r + g is lane row g of warp w, step (j, r)
    lanes = lambda t: t.reshape(*t.shape[:-1], steps, WARPS, 2, 8)  # noqa: E731
    sl, dl = lanes(s), lanes(dp)
    shape = sl.shape[:-4] + (WARPS, 8)
    st = (torch.full(shape, -FLT_MAX), torch.zeros(shape), torch.zeros(shape))
    for j in range(steps):
        for r in range(2):
            st = online_add(st, sl[..., j, :, r, :], dl[..., j, :, r, :])
    for bit in (1, 2, 4):  # lane row g takes g ^ bit's statistics
        partner = [g ^ bit for g in range(8)]
        st = merge(st, tuple(x[..., partner] for x in st))
    st = tuple(x[..., 0] for x in st)   # lane row 0's, per warp
    tot = tuple(x[..., 0] for x in st)
    for wp in range(1, WARPS):
        tot = merge(tot, tuple(x[..., wp] for x in st))
    mx, den, acc = (x[..., None] for x in tot)

    p = torch.exp(s - mx) / den
    ds = p * (dp - acc / den)
    pc, dsc = p.to(BF16).float(), (ds * scale).to(BF16).float()

    # dV, dK: 16-pixel steps of a tile, then tile after tile
    def over_pixels(a, b):  # a (.., HWp, keys), b (.., HWp, 8) -> (.., keys, 8)
        at = a.transpose(-1, -2).reshape(*a.shape[:-2], keys, hwp // TILE, 4, 16)
        bt = b.reshape(*b.shape[:-2], hwp // TILE, 4, 16, HC)
        out = torch.zeros(*a.shape[:-2], keys, HC)
        for tile in range(hwp // TILE):
            part = torch.zeros_like(out)
            for step in range(4):
                part = part + at[..., tile, step, :] @ bt[..., tile, step, :, :]
            out = out + part
        return out

    dv, dk = over_pixels(pc, doh), over_pixels(dsc, qh)
    # dq: a warp's m-tiles in order, 16 keys a step, then the warps in order
    dq = torch.zeros(*qh.shape)
    for wp in range(WARPS):
        part = torch.zeros_like(dq)
        for j in range(steps):
            ks = slice(16 * (wp + WARPS * j), 16 * (wp + WARPS * j) + 16)
            part = part + dsc[..., ks] @ kh[..., ks, :]
        dq = dq + part

    dbias = ds[..., :hw, :m].reshape(bg, hg, h, w, m).permute(0, 1, 2, 4, 3).contiguous()
    back = lambda t, n: t[:, :, :n].transpose(1, 2).reshape(bg, n, gc)  # noqa: E731
    keys_out = lambda t: F.pad(back(t, m), (0, 0, 0, mp - m))  # noqa: E731
    return back(dq, hw).to(q.dtype), keys_out(dk), keys_out(dv), dbias


def _inputs(seed, bg, hg, h, w, m, mp):
    rng = np.random.RandomState(seed)
    q = rng.randn(bg, h * w, hg * HC).astype(np.float32)
    k = rng.randn(bg, mp, hg * HC).astype(np.float32)
    v = rng.randn(bg, mp, hg * HC).astype(np.float32)
    k[:, m:], v[:, m:] = 3.0, 5.0  # padded keys must not be seen
    bias = rng.randn(bg, hg, h, m, w).astype(np.float32)
    dout = rng.randn(bg, h * w, hg * HC).astype(np.float32)
    return q, k, v, bias, dout


def _within_bars(got, want):
    """Each output against check_rows_bwd's bar; returns the failing names."""
    failing = []
    for name, a, b in zip(BARS, got, want):
        atol, rtol = BARS[name]
        a, b = a.float(), b.float()
        tol = atol * float(b.pow(2).mean().sqrt()) + rtol * b.abs()
        if not bool(((a - b).abs() <= tol).all()):
            failing.append(name)
    return failing


# (bg, hg, h, w, M, Mp): M < Mp on a plane that ends inside its second
# tile; M = Mp = 600, the served key count (38 m-tiles, 10 steps a warp);
# a plane of three whole tiles at 24 keys (warps 2 and 3 idle)
CASES = [(2, 2, 5, 16, 40, 48), (1, 2, 4, 24, 600, 600), (2, 2, 8, 24, 24, 24)]


@pytest.mark.parametrize("bg,hg,h,w,m,mp", CASES)
def test_kernel_order_meets_the_card_bars_against_pallas(bg, hg, h, w, m, mp):
    q, k, v, bias, dout = _inputs(40 + m, bg, hg, h, w, m, mp)
    scale = 8 ** -0.5
    want = pallas_dscf_rows_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, bias, dout)),
                                scale, hg, interpret=True)
    want = [torch.from_numpy(np.array(t, np.float32)) for t in want]
    got = mma_order(*(torch.from_numpy(a).to(BF16) for a in (q, k, v, bias, dout)), scale, hg)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert got[0].dtype == BF16 and all(t.dtype == torch.float32 for t in got[1:])
    assert float(got[1][:, m:].abs().sum() + got[2][:, m:].abs().sum()) == 0.0
    assert _within_bars(got, want) == []
    faulted = (*got[:3], got[3] * scale)
    assert _within_bars(faulted, want) == ["dbias"]
    share = float((got[0].float() != want[0]).float().mean())
    print(f"M = {m}, plane {h}x{w}: dq parts from the kernel on {share:.4f} of its outputs")

"""The order in which K7 sums on the tensor cores (csrc/window_attn_bwd.cu),
against the JAX package's window-attention backward kernel, interpreted, on
the CPU in bf16.

``_attn_bwd_kernel`` (ir_ads_tpu/ops/pallas_swin.py) computes s = q.k^T *
scale + bias (-1e9 where the region ids differ), P = e / sum e, pc =
bf16(P), ow = pc.V, dV = pc^T.dO, dP = dO.V^T, dS = P (dP - rowsum(dP P)),
dbias = sum over windows of dS, and dQ, dK from bf16(dS * scale).  On the
card a warp owns 16 query rows in the rows pass and 16 key rows in the keys
pass.  ``mma_order`` below is its order in plain torch (torch's f32 product
of one 16-deep step stands for the tensor cores' own sum, which is not
known):

  * the scores and dP: two 16-deep steps of d = 32, from zero;
  * sum e and rowsum(dP P): lane t of a quad holds columns 8 n + 2 t and 8 n
    + 2 t + 1 of each 8-key n-tile n; sum e adds each pair, n after n, and
    rowsum(dP P) fuses each product into its sum (an FMA); the quad meets
    by xor 1, then xor 2;
  * P = e / sum, a true division; dS = P (dP - rowsum);
  * ow and dQ over the keys in 16-key steps, dV and dK over the queries in
    16-query steps (the keys pass recomputes the scores, P and dS with the
    rows pass's statistics: the same values), each rounded once;
  * dbias: the windows' dS summed in f32 (on the card, in a block's order
    and across blocks by atomics: its only run-to-run difference).

It must meet chip_smoke.py's ``check_window_attn_bwd`` bars against the
interpreted kernel (dqkv and ow: atol 0.05 of the output's rms, rtol 2e-2;
dbias: 1e-3 / 1e-3), shifted with the region mask and not, with ow and
dbias wanted and not, and the planted fault (the region mask dropped) must
fail them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops.pallas_swin import pallas_window_attention_bwd, shift_region_ids

BF16 = torch.bfloat16
# chip_smoke.py's check_window_attn_bwd: (atol as a share of rms, rtol)
BARS = {"dqkv": (0.05, 2e-2), "ow": (0.05, 2e-2), "dbias": (1e-3, 1e-3)}


def fma(a, b, c):
    """f32 a * b + c rounded once (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def steps(a, b):
    """a (.., M, K) @ b (.., K, N) in f32, 16-deep steps of K in order."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 16):
        out = out + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def quad(lanes):
    """A quad's four lane values (last axis) after the xor-1, xor-2 sums."""
    return (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])


def mma_order(qkvw, dow, bias, region, scale, heads, want_ow=True, want_dbias=True):
    """K7's function in its order of sums; the arguments and results of
    ``window_attention_bwd_reference``."""
    bn, n, c3 = qkvw.shape
    c = c3 // 3
    d = c // heads
    nt = n // 8

    def heads_of(t):
        return t.float().reshape(bn, n, heads, d).transpose(1, 2)

    q, k, v = (heads_of(qkvw[..., i * c:(i + 1) * c]) for i in range(3))
    do = heads_of(dow)
    s = steps(q, k.transpose(-1, -2)) * scale + bias.float()[None]
    if region is not None:
        nw = region.shape[0]
        neq = (region[:, :, None] != region[:, None, :]).repeat(bn // nw, 1, 1)
        s = torch.where(neq[:, None], s + (-1e9), s)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    # lane t: the pairs (8 n + 2 t, 8 n + 2 t + 1), n after n
    pairs = e.reshape(*e.shape[:-1], nt, 4, 2)
    lanes = torch.zeros(*e.shape[:-1], 4)
    for j in range(nt):
        lanes = lanes + (pairs[..., j, :, 0] + pairs[..., j, :, 1])
    p = e / quad(lanes)[..., None]
    dp = steps(do, v.transpose(-1, -2))
    pp, dpp = p.reshape(*pairs.shape), dp.reshape(*pairs.shape)
    lanes = torch.zeros_like(lanes)
    for j in range(nt):
        lanes = fma(dpp[..., j, :, 0], pp[..., j, :, 0], lanes)
        lanes = fma(dpp[..., j, :, 1], pp[..., j, :, 1], lanes)
    ds = p * (dp - quad(lanes)[..., None])
    pc, dsc = p.to(BF16).float(), (ds * scale).to(BF16).float()

    def merge(t):
        return t.transpose(1, 2).reshape(bn, n, c)

    dq = steps(dsc, k)                                    # over keys
    dk = steps(dsc.transpose(-1, -2), q)                  # over queries
    dv = steps(pc.transpose(-1, -2), do)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], -1).to(qkvw.dtype)
    ow = merge(steps(pc, v)).to(qkvw.dtype) if want_ow else None
    dbias = None
    if want_dbias:
        dbias = torch.zeros(heads, n, n)
        for w in range(bn):
            dbias = dbias + ds[w]
    return dqkv, ow, dbias


def _within_bars(got, want):
    """Each output against check_window_attn_bwd's bar; returns the failing
    names."""
    failing = []
    for name, a, b in zip(BARS, got, want):
        if b is None:
            continue
        atol, rtol = BARS[name]
        a, b = a.float(), b.float()
        tol = atol * float(b.pow(2).mean().sqrt()) + rtol * b.abs()
        if not bool(((a - b).abs() <= tol).all()):
            failing.append(name)
    return failing


def _inputs(seed, bn, n, c, heads):
    rng = np.random.RandomState(seed)
    return (rng.randn(bn, n, 3 * c).astype(np.float32),
            rng.randn(bn, n, c).astype(np.float32),
            rng.randn(heads, n, n).astype(np.float32))


# K7's tensor-core shape: d = 32, N = 144 (12 x 12 windows); C = 64, 2
# heads, two images of a 24 x 24 map (8 windows)
WS, C, HEADS, IMAGES, HP = 12, 64, 2, 2, 24


@pytest.mark.parametrize("shift,want_ow,want_dbias",
                         [(0, True, True), (6, True, True), (6, False, False), (6, True, False)])
def test_kernel_order_meets_the_card_bars_against_pallas(shift, want_ow, want_dbias):
    n, nw = WS * WS, (HP // WS) ** 2
    bn = IMAGES * nw
    qkvw, dow, bias = _inputs(70 + shift, bn, n, C, HEADS)
    region = shift_region_ids(HP, HP, WS, shift) if shift else None
    scale = (C // HEADS) ** -0.5
    want = pallas_window_attention_bwd(
        jnp.asarray(qkvw, jnp.bfloat16), jnp.asarray(dow, jnp.bfloat16), jnp.asarray(bias),
        None if region is None else jnp.asarray(region), scale, HEADS, interpret=True,
        want_ow=want_ow, want_dbias=want_dbias)
    want = [None if t is None else torch.from_numpy(np.array(t, np.float32)) for t in want]
    treg = None if region is None else torch.from_numpy(np.asarray(region))
    args = (torch.from_numpy(qkvw).to(BF16), torch.from_numpy(dow).to(BF16),
            torch.from_numpy(bias))
    got = mma_order(*args, treg, scale, HEADS, want_ow, want_dbias)
    assert [t is None for t in got] == [t is None for t in want]
    assert got[0].dtype == BF16 and got[0].shape == (bn, n, 3 * C)
    assert _within_bars(got, want) == []
    if shift:  # the planted fault: the region mask left out
        faulted = mma_order(*args, None, scale, HEADS, want_ow, want_dbias)
        assert "dqkv" in _within_bars(faulted, want)
    share = float((got[0].float() != want[0]).float().mean())
    print(f"shift {shift}: dqkv from the kernel on {share:.4f} of its outputs")

"""K5's launch sequence (csrc/swin_block_v6.cu) in plain torch, on the CPU:
the order of its sums, and its bars against the JAX package's
``_attn_kernel_v6``, interpreted, and the port's plain version.

K5 runs LN1, a GEMM with Wqkv, the window attention, then the GEMMs with
Wproj, the adapter's two weights, W1 and W2 (csrc/gemm_mma.cuh), LN2
between them.  Each product is one f32 accumulator per output taking the
16-deep steps of k in ascending order from its init (0, or for W2 the
adapter's f32 output), the steps past K rounded up to 16 not taken.
``gemm`` below models that: one step is the exact sum of 16 products of
bf16 values rounded to f32 (stand-in for the tensor cores' own sum),
added to the accumulator.

First, the single W2 GEMM over the whole hidden from its init gives the
same bits as the fused form's order (the hidden made and consumed 64
columns at a time, each chunk's products added to the output's f32 sum,
tile_gemm with accumulate), and the W1 GEMM the same as its 64-column
chunks: the orders are one order.  Second, the sequence meets K5's bars
(chip_smoke.py's ``check_window_block_v6``: atol 3e-2, rtol 2e-2, the
branch out - x within 1e-2) against the interpreted kernel and the plain
version, on a map whose windows are padded and shifted, a row count no
tile divides, and adapters stacked over two streams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_swin import pallas_window_block_v6
from ir_ads_tpu_torch.ops.swin_block import window_attention_reference
from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6_reference
from ir_ads_tpu_torch.ops.window_attention import shift_region_ids

BF16 = torch.bfloat16
CHUNK = 64  # the fused form's hidden columns a step


def gemm(a, w, init=None):
    """init + a w^T (a (M, K), w (N, K) bf16) in 16-deep steps of k."""
    k16 = -(-a.shape[-1] // 16) * 16
    a64 = F.pad(a.double(), (0, k16 - a.shape[-1]))
    w64 = F.pad(w.double(), (0, k16 - w.shape[-1]))
    acc = torch.zeros(a.shape[0], w.shape[0]) if init is None else init.clone()
    for k0 in range(0, k16, 16):
        acc = acc + (a64[:, k0:k0 + 16] @ w64[:, k0:k0 + 16].t()).float()
    return acc


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def ffn_fused_order(yn, w1, b1, w2, init):
    """The fused form: 64 hidden columns at a time, each chunk's W2
    products added to the f32 output tile 16 deep at a time."""
    acc = init.clone()
    for j0 in range(0, w1.shape[0], CHUNK):
        hid = gelu_tanh(gemm(yn, w1[j0:j0 + CHUNK]) + b1[j0:j0 + CHUNK].float()).to(BF16)
        for kk in range(0, CHUNK, 16):
            acc = acc + (hid[:, kk:kk + 16].double()
                         @ w2[:, j0 + kk:j0 + kk + 16].double().t()).float()
    return acc


def ffn_gemm_order(yn, w1, b1, w2, init):
    """The launch sequence: the W1 GEMM's epilogue, then one W2 GEMM."""
    hid = gelu_tanh(gemm(yn, w1) + b1.float()).to(BF16)
    return gemm(hid, w2, init)


def sequence(x, attn, tail, region, scale, heads, ws, shift, eps=1e-5, adapter_scale=0.5):
    """K5's nine launches; the arguments and result of
    ``window_block_v6_reference`` (bf16)."""
    ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias = attn
    g2, be2, w1, b1, w2, b2, aw1, ab1, aw2, ab2 = tail
    b, h, w, c = x.shape
    rows = x.reshape(-1, c)
    xn = F.layer_norm(rows.float(), (c,), ln_w.float(), ln_b.float(), eps).to(BF16)
    qkv = (gemm(xn, wqkv) + bqkv.float()).to(BF16).reshape(b, h, w, 3 * c)
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    qkv = torch.cat([qkv, bqkv.expand(b, h, wp - w, 3 * c)], dim=2)
    qkv = torch.cat([qkv, bqkv.expand(b, hp - h, wp, 3 * c)], dim=1)
    if shift:
        qkv = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    if shift:
        att = torch.roll(att, shifts=(shift, shift), dims=(1, 2))
    att = att[:, :h, :w].reshape(-1, c)
    y = rows.float() + (gemm(att, wproj) + bproj.float())
    yb = y.to(BF16)
    streams = aw1.shape[0] if aw1.ndim == 3 else 1
    stack = (lambda t: t) if aw1.ndim == 3 else (lambda t: t[None])  # noqa: E731
    per = y.shape[0] // streams
    init = torch.cat([
        adapter_scale * (gemm(torch.relu(gemm(yb[s * per:(s + 1) * per], stack(aw1)[s])
                                          + stack(ab1)[s].float()).to(BF16), stack(aw2)[s])
                         + stack(ab2)[s].float()) + b2.float()
        for s in range(streams)])
    yn = F.layer_norm(y, (c,), g2.float(), be2.float(), eps).to(BF16)
    out = y + ffn_gemm_order(yn, w1, b1, w2, init)
    return out.to(BF16).reshape(b, h, w, c)


def _case(seed, b, h, w, c, heads, ws, shift, streams):
    """bf16 inputs in the port's layout (Linear weights (out, in)) and the
    JAX kernel's (Dense kernels (in, out)), from one numpy seed."""
    rng = np.random.RandomState(seed)
    hidden, ca, n = 4 * c, c // 16, ws * ws
    lead = (streams,) if streams > 1 else ()
    r = lambda *s, std=1.0, mean=0.0: (rng.randn(*s) * std + mean).astype(np.float32)  # noqa: E731
    x = r(b, h, w, c)
    attn = [r(c, std=0.05, mean=1.0), r(c, std=0.05), r(3 * c, c, std=c ** -0.5),
            r(3 * c, std=0.02), r(c, c, std=c ** -0.5), r(c, std=0.02), r(heads, n, n)]
    tail = [r(c, std=0.05, mean=1.0), r(c, std=0.05), r(hidden, c, std=c ** -0.5),
            r(hidden, std=0.02), r(c, hidden, std=hidden ** -0.5), r(c, std=0.02),
            r(*lead, ca, c, std=c ** -0.5), r(*lead, ca, std=0.02),
            r(*lead, c, ca, std=ca ** -0.5), r(*lead, c, std=0.02)]
    bf = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    tx = bf(x)
    ta = [bf(a) for a in attn[:6]] + [torch.from_numpy(attn[6])]
    tt = [bf(a) for a in tail]
    jt = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    tr = lambda t: jnp.swapaxes(jt(t), -1, -2)  # noqa: E731
    ja = [jt(ta[0]), jt(ta[1]), tr(ta[2]), jt(ta[3]), tr(ta[4]), jt(ta[5]), jnp.asarray(attn[6])]
    jtail = [tr(t) if i in (2, 4, 6, 8) else jt(t) for i, t in enumerate(tt)]
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    return tx, ta, tt, jt(tx), ja, jtail, region, (c // heads) ** -0.5


def _bars(got, want, x):
    """chip_smoke.py's hold for K5: element by element, and on the branch."""
    g, wt = got.float(), want.float()
    elem = bool(((g - wt).abs() <= 3e-2 + 2e-2 * wt.abs()).all())
    rel = float((g - wt).norm() / (wt - x.float()).norm())
    return elem and rel <= 1e-2, rel


def test_one_w2_gemm_from_its_init_is_the_fused_chunk_order():
    rng = np.random.RandomState(3)
    m, c, hidden = 37, 64, 256
    bf = lambda *s, std=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * std).astype(np.float32)).to(BF16)
    yn, w1, b1 = bf(m, c), bf(hidden, c, std=c ** -0.5), bf(hidden, std=0.02)
    w2 = bf(c, hidden, std=hidden ** -0.5)
    init = torch.from_numpy(rng.randn(m, c).astype(np.float32))
    fused = ffn_fused_order(yn, w1, b1, w2, init)
    assert torch.equal(ffn_gemm_order(yn, w1, b1, w2, init), fused)
    # the chunks are one order with the whole GEMM, not just close to it:
    # starting W2's sum from zero and adding init after moves bits
    moved = ffn_gemm_order(yn, w1, b1, w2, torch.zeros_like(init)) + init
    assert not torch.equal(moved, fused)


# (B, H, W, C, heads, ws, shift, streams): padded and shifted windows over
# B H W = 280 rows (no 64- or 128-row tile divides it); stacked adapters
CASES = [(4, 7, 10, 64, 2, 4, 2, 1), (4, 8, 8, 64, 2, 4, 0, 1), (4, 7, 10, 64, 2, 4, 2, 2)]


@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,streams", CASES)
def test_sequence_meets_the_card_bars(b, h, w, c, heads, ws, shift, streams):
    tx, ta, tt, jx, ja, jtail, region, scale = _case(
        50 + shift + streams, b, h, w, c, heads, ws, shift, streams)
    treg = None if region is None else torch.from_numpy(np.asarray(region))
    got = sequence(tx, ta, tt, treg, scale, heads, ws, shift)
    plain = window_block_v6_reference(tx, ta, tt, treg, scale, heads, ws, shift)
    kernel = torch.from_numpy(np.array(pallas_window_block_v6(
        jx, ja, jtail, None if region is None else jnp.asarray(region), scale, heads, ws,
        shift=shift, interpret=True), np.float32))
    assert got.shape == tx.shape and got.dtype == BF16
    for want in (kernel, plain):
        ok, rel = _bars(got, want, tx)
        assert ok, rel
    # the bars see the adapter: the sequence without it fails them
    dropped = sequence(tx, ta, tt, treg, scale, heads, ws, shift, adapter_scale=0.0)
    assert not _bars(dropped, plain, tx)[0]

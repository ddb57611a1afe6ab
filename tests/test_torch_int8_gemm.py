"""K11's and K10's launch sequences on the s8 GEMM (csrc/igemm.cuh) in plain
torch, on the CPU: what the sequences change (whole-map products in
tiles, the row max of K11's f32 hidden taken by atomicMax on its int bits
over the W1 tiles, the hidden computed again for its codes) keeps the
fused rows' function bit for bit, and the sequences meet test_torch_int8's
bars against the JAX package's Pallas kernels, interpreted.

The GEMM is modelled as the kernel runs it: a tile of BM x 128 outputs
(BM 128 where the grid has at least one such tile an SM of 132, else 64),
operands zero past M, N and K (TMA's fill), sums over 128-deep k-slices in
int64 (the s32 sums are exact).  K11 runs six launches: LN2 with the
per-row s8 of its output, the adapter's two bf16 products, the W1 product
for the row max of |hidden| (each tile's max over its columns, combined by
an integer max of the bits), the W1 product again for the codes, and the
W2 product with out = (x + ffn) + 0.5 a.  K10 runs five: LN1 with the
padding zeroed and the per-row s8, the qkv product, the attention, the
per-row s8 of its output, the proj product with y = x + proj.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_mlp import fused_block_tail_pallas
from ir_ads_tpu.ops.pallas_swin import pallas_window_block, shift_region_ids
from ir_ads_tpu_torch.ops import int8 as tint8
from ir_ads_tpu_torch.ops.block_tail_int8 import block_tail_int8_reference
from ir_ads_tpu_torch.ops.swin_block import pad_mask, window_attention_reference
from ir_ads_tpu_torch.ops.swin_block_int8 import window_block_int8_reference

SMS = 132  # an H100's
TILE_N, TILE_K = 128, 128
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# test_torch_int8.py's bars against the interpreted Pallas kernels
BARS = {"f32": dict(rel=1e-5, atol=1e-5, rtol=1e-5),
        "bf16": dict(rel=8e-3, atol=2e-2, rtol=2.0 ** -6)}


def tile_rows(m, n):
    """The GEMM's BM: 128 where the output has a 128 x 128 tile an SM."""
    return 128 if -(-m // 128) * -(-n // TILE_N) >= SMS else 64


def igemm(a, w):
    """a (M, K) s8 . w (N, K)^T s8 -> (M, N) int32, by the kernel's tiles
    and k-slices, zeros past the edges."""
    m, k = a.shape
    n = w.shape[0]
    bm = tile_rows(m, n)
    mp, np_, kp = -(-m // bm) * bm, -(-n // TILE_N) * TILE_N, -(-k // TILE_K) * TILE_K
    a64 = F.pad(a.long(), (0, kp - k, 0, mp - m))
    w64 = F.pad(w.long(), (0, kp - k, 0, np_ - n))
    out = torch.empty(mp, np_, dtype=torch.long)
    for m0 in range(0, mp, bm):
        for n0 in range(0, np_, TILE_N):
            acc = torch.zeros(bm, TILE_N, dtype=torch.long)
            for k0 in range(0, kp, TILE_K):
                acc += a64[m0:m0 + bm, k0:k0 + TILE_K] @ w64[n0:n0 + TILE_N, k0:k0 + TILE_K].t()
            out[m0:m0 + bm, n0:n0 + TILE_N] = acc
    assert out.abs().max() < 2 ** 31
    return out[:m, :n].int()


def dequant(acc, s_row, s_col, b):
    """(acc * s_row) * s_col + b in f32, each step rounded."""
    return (acc.float() * s_row) * s_col.float() + b.float()


def row_max_by_bits(h, width=TILE_N):
    """The max pass: each tile's max(0, max |h|) over its columns, combined
    over the tiles by an integer max of the non-negative floats' bits, from
    0 (the LN2 launch zeroes the buffer)."""
    best = torch.zeros(h.shape[0], dtype=torch.int32)
    for n0 in range(0, h.shape[1], width):
        part = torch.clamp(h[:, n0:n0 + width].abs().amax(dim=1), min=0.0)
        best = torch.maximum(best, part.view(torch.int32))
    return best.view(torch.float32)


def k11_sequence(x, ln_w, ln_b, w1_q, s1, b1, w2_q, s2, b2, aw1, ab1, aw2, ab2, eps=1e-5,
                 adapter_scale=0.5, chunk_max=False):
    """K11's six launches on the arguments of ``block_tail_int8_reference``.
    ``chunk_max`` plants the fault: the row max over the first 64 columns."""
    cdt = x.dtype
    xf = x.float()
    xn = tint8.layer_norm_rows(xf, ln_w.float(), ln_b.float(), eps).to(cdt)
    xq, sx = tint8.quantize_rows(xn, floor_first=True)
    ah = torch.relu(xf @ aw1.float().t() + ab1.float()).to(cdt).float()
    a = ah @ aw2.float().t() + ab2.float()
    hidden = lambda: F.gelu(dequant(igemm(xq, w1_q), sx, s1, b1), approximate="tanh")  # noqa: E731
    h = hidden()
    rowmax = row_max_by_bits(h[:, :64] if chunk_max else h)
    sh = torch.clamp(rowmax, min=1e-12)[:, None] / 127.0
    hq = torch.clamp(torch.round(hidden() / sh), -127, 127).to(torch.int8)
    ffn = dequant(igemm(hq, w2_q), sh, s2, b2)
    return ((xf + ffn) + adapter_scale * a).to(cdt)


def k10_sequence(x, ln_w, ln_b, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj, bias, region,
                 scale, heads, ws, h_real, w_real, shift, eps=1e-5):
    """K10's five launches on the arguments of ``window_block_int8_reference``."""
    cdt = x.dtype
    b, hp, wp, c = x.shape
    xf = x.float().reshape(-1, c)
    xn = tint8.layer_norm_rows(xf, ln_w.float(), ln_b.float(), eps)
    pad = pad_mask(hp, wp, h_real, w_real, shift, x.device).reshape(1, -1).expand(b, -1)
    xq, sx = tint8.quantize_rows(xn.masked_fill(pad.reshape(-1, 1), 0.0).to(cdt),
                                 floor_first=True)
    qkv = dequant(igemm(xq, wqkv_q), sx, sqkv, bqkv).to(cdt).reshape(b, hp, wp, 3 * c)
    att = window_attention_reference(qkv, bias, region, scale, heads, ws)
    aq, sa = tint8.quantize_rows(att.float().reshape(-1, c), floor_first=True)
    y = xf + dequant(igemm(aq, wproj_q), sa, sproj, bproj)
    return y.to(cdt).reshape(x.shape)


def _lin(rng, fan_in, *shape):
    return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _bars(got, want, base, dt):
    """test_torch_int8.py's bars: on the branch got - base relative in norm,
    and element by element."""
    bar = BARS[dt]
    g, w, x = (np.asarray(t.float(), dtype=np.float32) for t in (got, want, base))
    rel = np.linalg.norm(g - w) / np.linalg.norm(w - x)
    worst = float((np.abs(g - w) / (bar["atol"] + bar["rtol"] * np.abs(w))).max())
    return rel <= bar["rel"] and worst <= 1.0, rel


def tail_int8_op_by_op(x, p, jdt, eps=1e-5, adapter_scale=0.5):
    """``_tail_kernel_int8``'s body, one jnp operation at a time (no Pallas,
    no fusion), on the wrapper's quantized weights."""
    from ir_ads_tpu.ops.pallas_mlp import quantize_weight

    f32 = jnp.float32
    v = lambda name: jnp.asarray(p[name], jdt).astype(f32)  # noqa: E731
    dot = lambda a, b, t: jnp.matmul(a, b, preferred_element_type=t)  # noqa: E731
    xf = jnp.asarray(x, jdt).astype(f32)
    xc = xf - jnp.mean(xf, axis=1, keepdims=True)
    xn = xc * (1.0 / jnp.sqrt(jnp.mean(xc * xc, axis=1, keepdims=True) + eps))
    xn = (xn * v("ln_scale") + v("ln_bias")).astype(jdt).astype(f32)
    sx = jnp.maximum(jnp.max(jnp.abs(xn), axis=1, keepdims=True), 1e-12) / 127.0
    (w1q, s1), (w2q, s2) = (quantize_weight(jnp.asarray(p[w])) for w in ("w1", "w2"))
    h = dot(jnp.round(xn / sx).astype(jnp.int8), w1q, jnp.int32).astype(f32) * sx * s1
    h = jax.nn.gelu(h + v("b1"), approximate=True)
    sh = jnp.maximum(jnp.max(jnp.abs(h), axis=1, keepdims=True), 1e-12) / 127.0
    ffn = dot(jnp.round(h / sh).astype(jnp.int8), w2q, jnp.int32).astype(f32) * sh * s2
    ffn = ffn + v("b2")
    a = dot(xf.astype(jdt), jnp.asarray(p["aw1"], jdt), f32) + v("ab1")
    a = dot(jnp.maximum(a, 0.0).astype(jdt), jnp.asarray(p["aw2"], jdt), f32) + v("ab2")
    return np.asarray((xf + ffn + adapter_scale * a).astype(jdt).astype(f32))


@pytest.mark.parametrize("m,n,k", [(300, 256, 128), (300, 128, 512), (70, 384, 96),
                                   (19200, 16, 32)])
def test_igemm_tiles_are_int_mm(m, n, k):
    """The model's tiles, slices and zero fill sum to torch._int_mm's
    integers, with 64- and 128-row tiles and ragged M, N and K."""
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    assert torch.equal(igemm(a, w), tint8.int_mm(a, w))


def test_wgmma_fragment_covers_the_tile():
    """igemm.cuh's epilogue reads accumulator i of lane l of warp v as row
    16 v + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2 of
    the warpgroup's 64 x 128 tile: each output exactly once."""
    seen = np.zeros((64, 128), dtype=int)
    for v in range(4):
        for lane in range(32):
            for i in range(64):
                seen[16 * v + lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4)
                     + i % 2] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("values", ["mixed", "zeros", "subnormal", "tiny_and_large"])
def test_row_max_by_int_bits_is_amax(values):
    """The max pass's atomicMax on the int bits equals amax |h| bit for bit,
    zeros and subnormals included; the planted fault (one 64-column chunk)
    does not."""
    rng = np.random.RandomState(3)
    h = rng.randn(40, 512).astype(np.float32)
    if values == "zeros":
        h[::2] = 0.0
        h[1::2, 5:] = -0.0
    elif values == "subnormal":
        h = h * np.float32(1e-39)  # every value below 2^-126
        h[3] = np.float32(1e-45) * np.sign(h[3])  # the smallest subnormal
    elif values == "tiny_and_large":
        h[:, ::3] *= np.float32(1e-42)
        h[:, 400:] *= np.float32(1e30)
    t = torch.from_numpy(h)
    want = t.abs().amax(dim=1)
    got = row_max_by_bits(t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if values != "zeros":
        assert not torch.equal(row_max_by_bits(t[:, :64]), want)


def _k11_case(seed, rows, c, tdt):
    rng = np.random.RandomState(seed)
    hidden, ca = 4 * c, c // 16
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    p = dict(ln_scale=1.0 + r(c), ln_bias=r(c), w1=_lin(rng, c, c, hidden), b1=r(hidden),
             w2=_lin(rng, hidden, hidden, c), b2=r(c), aw1=_lin(rng, c, c, ca), ab1=r(ca),
             aw2=_lin(rng, ca, ca, c), ab2=r(c))
    x = rng.randn(rows, c).astype(np.float32)
    # the wrapper's arguments: parameters rounded to the compute dtype, the
    # FFN weights quantized per output channel in (out, in) layout
    args = (_t(p["ln_scale"], tdt), _t(p["ln_bias"], tdt),
            *tint8.quantize_weight(_t(p["w1"].T)), _t(p["b1"], tdt),
            *tint8.quantize_weight(_t(p["w2"].T)), _t(p["b2"], tdt),
            _t(p["aw1"].T, tdt), _t(p["ab1"], tdt), _t(p["aw2"].T, tdt), _t(p["ab2"], tdt))
    return x, p, _t(x, tdt), args


# 300 rows: a multiple of no 64- or 128-row tile
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("c", [128, 256])
def test_k11_sequence_keeps_the_bits(dt, c):
    _, tdt = DTYPES[dt]
    _, _, xt, args = _k11_case(c, 300, c, tdt)
    want = block_tail_int8_reference(xt, *args)
    assert torch.equal(k11_sequence(xt, *args), want)
    # the planted fault: the hidden's scale from one 64-column chunk
    assert not torch.equal(k11_sequence(xt, *args, chunk_max=True), want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("c", [128, 256])
def test_k11_sequence_meets_the_bars_of_the_pallas_kernel(monkeypatch, dt, c):
    jdt, tdt = DTYPES[dt]
    x, p, xt, args = _k11_case(c + 1, 300, c, tdt)
    monkeypatch.setenv("IR_ADS_INT8", "1")
    want = _t(fused_block_tail_pallas(jnp.asarray(x, jdt), *map(jnp.asarray, p.values()),
                                      interpret=True))
    got = k11_sequence(xt, *args)
    assert got.dtype == tdt and got.shape == xt.shape
    # The interpreted kernel runs its body as one XLA computation, whose
    # fused GELU can round the f32 hidden otherwise than the same jnp
    # operations one at a time; a row max an ulp away then moves every code
    # of the row (at C = 256 in bf16: 9 of 300 rows, outputs 2e-2 apart).
    # The element bar holds on the rows where the interpreted kernel meets
    # it against its own body run op by op, the norm bar on all rows.
    bar = BARS[dt]
    ops = tail_int8_op_by_op(x, p, jdt)
    same = (np.abs(want.numpy() - ops) <= bar["atol"] + bar["rtol"] * np.abs(ops)).all(axis=1)
    assert same.mean() >= 0.95, same.mean()
    ok, rel = _bars(got[same], want[same], xt[same], dt)
    assert ok and _bars(got, want, xt, dt)[1] <= BARS[dt]["rel"], rel
    ok, rel = _bars(k11_sequence(xt, *args, chunk_max=True), want, xt, dt)
    assert not ok, rel


# (Hp, Wp, h_real, w_real, shift): shifted with padding, and unshifted
# with padding on a map whose rows are a multiple of no tile
K10_CASES = [(8, 8, 7, 6, 2), (8, 12, 5, 10, 0)]


def _k10_case(seed, hp, wp, shift, tdt, c=64, heads=2, ws=4):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    p = [1.0 + r(c), r(c), _lin(rng, c, c, 3 * c), r(3 * c), _lin(rng, c, c, c), r(c),
         rng.randn(heads, ws * ws, ws * ws).astype(np.float32)]
    x = rng.randn(3, hp, wp, c).astype(np.float32)
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    g, b, wqkv, bqkv, wproj, bproj, bias = p
    args = (_t(g, tdt), _t(b, tdt), *tint8.quantize_weight(_t(wqkv.T)), _t(bqkv, tdt),
            *tint8.quantize_weight(_t(wproj.T)), _t(bproj, tdt), _t(bias),
            None if region is None else torch.from_numpy(region), (c // heads) ** -0.5,
            heads, ws)
    return x, p, region, _t(x, tdt), args


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hp,wp,h_real,w_real,shift", K10_CASES)
def test_k10_sequence_keeps_the_bits(dt, hp, wp, h_real, w_real, shift):
    _, tdt = DTYPES[dt]
    *_, xt, args = _k10_case(hp * wp, hp, wp, shift, tdt)
    want = window_block_int8_reference(xt, *args, h_real, w_real, shift)
    assert torch.equal(k10_sequence(xt, *args, h_real, w_real, shift), want)
    # the padding mask is seen: without it the sequence moves
    assert not torch.equal(k10_sequence(xt, *args, hp, wp, shift), want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hp,wp,h_real,w_real,shift", K10_CASES)
def test_k10_sequence_meets_the_bars_of_the_pallas_kernel(monkeypatch, dt, hp, wp, h_real,
                                                          w_real, shift):
    jdt, tdt = DTYPES[dt]
    x, p, region, xt, args = _k10_case(hp * wp + 1, hp, wp, shift, tdt)
    monkeypatch.setenv("IR_ADS_INT8", "1")
    scale, heads, ws = args[-3:]
    want = _t(pallas_window_block(
        jnp.asarray(x, jdt), *map(jnp.asarray, p),
        None if region is None else jnp.asarray(region), scale, heads, ws,
        h_real=h_real, w_real=w_real, shift=shift, interpret=True))
    got = k10_sequence(xt, *args, h_real, w_real, shift)
    assert got.dtype == tdt and got.shape == xt.shape
    ok, rel = _bars(got, want, xt, dt)
    assert ok, rel

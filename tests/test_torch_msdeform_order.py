"""K9's order of work (csrc/msdeform.cu) written out in torch, on the CPU.

The kernel sums each output channel as one f32 chain of fused multiply-adds
from +0: sample-major (level, point), then corner, every corner added, those
of weight 0 too (a corner outside its level reads its clamped row and adds
it times 0; an attention weight of exactly 0 zeroes all four).  The first
design took the same chain but skipped every zero weight.  Adding v * 0 to a
sum that started at +0 leaves its bits as they were for finite v, so the two
designs give the same output bit for bit on finite inputs: the premise held
here, on random locations (part of the corners outside), samples wholly
outside every level, attention weights of exactly 0, and sums that cancel to
zero.  The ordered chain is also held to tests/test_torch_det_msdeform.py's
bars against the interpreted Pallas kernel, in f32 and bf16.

The chain is ``ops.msdeform.ordered_sums`` (``ms_deform_attn_ordered``
rounds it once).  The corners are ``ops.msdeform.corner_tables``: the kernel's per-sample
arithmetic (the pixel coordinate and the corner weight rounded as separate
f32 operations, the attention weight times the corner weight one f32
product).  A fused multiply-add is emulated exactly: the product of a bf16
or f32 value and an f32 weight is exact in f64, the f64 sum with the
accumulator is rounded to odd (its error, from TwoSum, decides the last
bit), and that rounds to f32 as one rounding of the exact sum would.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops.pallas_msdeform import ms_deform_attn_pallas
from ir_ads_tpu_torch.ops import msdeform

SHAPE_SETS = [  # tests/test_torch_det_msdeform.py's
    (((12, 16), (6, 8), (3, 4)), 2, 4, 8, 37, 3),
    (((16, 20), (8, 10), (4, 5), (2, 3)), 1, 8, 32, 100, 4),
    (((13, 19), (7, 10), (4, 5), (2, 3)), 2, 8, 16, 203, 4),
]


fma_f32 = msdeform.fma_f32


@pytest.fixture(autouse=True)
def one_thread():
    """The chains are hundreds of small f64 operations: one thread, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ordered(value, shapes, loc, att, skip_zero=False):
    """K9's chain per channel (``ops.msdeform.ordered_sums``): the f32
    accumulators (B, Lq, H, D) and the output (B, Lq, H*D) in the value
    dtype.  ``skip_zero``: the first design's chain, which took no corner
    of weight 0."""
    acc = msdeform.ordered_sums(value, shapes, loc, att, skip_zero)
    return acc, acc.to(value.dtype).reshape(acc.shape[0], acc.shape[1], -1)


def _data(seed, shapes, bs, heads, d, lq, points, kind="random"):
    """Locations in [-0.1, 1.1] (part of the corners outside), attention
    weights normalised per (query, head); ``kind``:
      outside  a quarter of the samples wholly outside every level;
      zeros    a quarter of the attention weights exactly 0;
      cancel   query 0, every head: two samples on pixel centres of level 0
               whose rows are opposite, weight 0.25 each (products exact),
               the rest outside, so its channels sum to exactly 0."""
    rng = np.random.RandomState(seed)
    n_value = sum(h * w for h, w in shapes)
    value = rng.randn(bs, n_value, heads, d).astype(np.float32)
    loc = rng.rand(bs, lq, heads, len(shapes), points, 2).astype(np.float32) * 1.2 - 0.1
    w = rng.rand(bs, lq, heads, len(shapes), points).astype(np.float32)
    w /= w.reshape(bs, lq, heads, -1).sum(-1)[..., None, None]
    if kind == "outside":
        far = rng.rand(bs, lq, heads, len(shapes), points) < 0.25
        loc[far] = rng.choice([-2.0, 3.0], size=(int(far.sum()), 2))
    elif kind == "zeros":
        w[rng.rand(*w.shape) < 0.25] = 0.0
    elif kind == "cancel":
        h0, w0 = shapes[0]
        value[:, w0 + 1] = -value[:, 0]  # pixel (1, 1) of level 0 against (0, 0)
        loc[:, 0] = -2.0
        loc[:, 0, :, 0, 0] = [0.5 / w0, 0.5 / h0]
        loc[:, 0, :, 0, 1] = [1.5 / w0, 1.5 / h0]
        w[:, 0] = 0.0
        w[:, 0, :, 0, :2] = 0.25
    return value, loc, w


def test_fma_emulation_rounds_once():
    """(1 + 2^-15)(1 - 2^-15) + (2^24 + 2) = 2^24 + 3 - 2^-30: one rounding
    gives 2^24 + 2; rounding to f64 first lands on the tie 2^24 + 3, which
    then rounds to even, 2^24 + 4."""
    v, w = torch.tensor([1 + 2 ** -15]), torch.tensor([1 - 2 ** -15])
    acc = torch.tensor([2.0 ** 24 + 2])
    assert float(fma_f32(v, w, acc)) == 2 ** 24 + 2
    assert float((v.double() * w.double() + acc.double()).float()) == 2 ** 24 + 4
    a, b, c = (torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
               for _ in range(3))
    got = fma_f32(a, b, c)  # within half an ulp of the exact value
    exact = a.double() * b.double() + c.double()
    assert bool(((got.double() - exact).abs()
                 <= torch.nextafter(got, torch.full_like(got, np.inf)).double()
                 - got.double()).all())


@pytest.mark.parametrize("kind", ["random", "outside", "zeros", "cancel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,bs,heads,d,lq,points", SHAPE_SETS)
def test_every_corner_chain_is_the_skipping_chain_bit_for_bit(
        shapes, bs, heads, d, lq, points, dtype, kind):
    value, loc, w = _data(1, shapes, bs, heads, d, lq, points, kind)
    args = (torch.from_numpy(value).to(dtype), shapes, torch.from_numpy(loc),
            torch.from_numpy(w).to(dtype))
    acc, out = ordered(*args)
    acc_skip, out_skip = ordered(*args, skip_zero=True)
    zero_corners = sum(int((t == 0).sum()) for t in msdeform.corner_tables(*args[1:])[1])
    assert zero_corners > 0  # the premise is exercised
    assert torch.equal(acc.view(torch.int32), acc_skip.view(torch.int32))
    assert torch.equal(out.float().view(torch.int32), out_skip.float().view(torch.int32))
    if kind == "cancel":  # exactly +0, not -0
        assert not bool(acc[:, 0].view(torch.int32).any())


@pytest.mark.parametrize("shapes,bs,heads,d,lq,points", SHAPE_SETS)
def test_ordered_chain_matches_the_pallas_kernel_f32(shapes, bs, heads, d, lq, points):
    value, loc, w = _data(0, shapes, bs, heads, d, lq, points)
    want = ms_deform_attn_pallas(jnp.asarray(value), shapes, jnp.asarray(loc),
                                 jnp.asarray(w), True)
    got = msdeform.ms_deform_attn_ordered(torch.from_numpy(value), shapes,
                                          torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes,bs,heads,d,lq,points", SHAPE_SETS[1:])
def test_ordered_chain_matches_the_pallas_kernel_bf16(shapes, bs, heads, d, lq, points):
    """tests/test_torch_det_msdeform.py's bf16 bars: within one ulp, nearly
    every element bit-equal."""
    value, loc, w = _data(1, shapes, bs, heads, d, lq, points)
    vb = jnp.asarray(value).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(ms_deform_attn_pallas(vb, shapes, jnp.asarray(loc), wb, True)
                      .astype(jnp.float32))
    got = msdeform.ms_deform_attn_ordered(torch.from_numpy(value).bfloat16(), shapes,
                                          torch.from_numpy(loc),
                                          torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)
    assert (got == want).mean() > 0.99


def test_odd_head_dim_on_the_cpu_takes_the_plain_version():
    """The kernel reads channel pairs and refuses an odd head_dim on the
    card; CPU tensors take the plain version whatever the width."""
    shapes = ((4, 5), (2, 3))
    value, loc, w = (torch.from_numpy(a) for a in _data(2, shapes, 1, 2, 3, 7, 2))
    got = msdeform.ms_deform_attn(value, shapes, loc, w)
    assert torch.equal(got, msdeform.ms_deform_attn_plain(value, shapes, loc, w))
    assert msdeform.KERNEL.launches == 0

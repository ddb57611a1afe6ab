"""The plain PyTorch versions of the port's six kernels against the JAX
Pallas kernels they replace (run in interpret mode) and against the
kernels' XLA twins, on the CPU, in f32 and in bf16.

Inputs come from numpy with a fixed seed and go through both frameworks.
Tolerances are those of the JAX package's own kernel tests
(tests/test_pallas_swin_v4.py, test_pallas_swin_v5.py, test_pallas_mlp.py,
test_dscf_rows.py, test_pallas_dscf_rpe.py):
the same function in f32, differing only in summation order.  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops.pallas_dscf import dscf_rows_reference, pallas_dscf_attention_rows
from ir_ads_tpu.ops.pallas_dscf_rpe import (
    dscf_rpe_bias_packed_pallas, dscf_rpe_bias_packed_reference,
    dscf_rpe_bias_rows_pallas, dscf_rpe_bias_rows_reference,
)
from ir_ads_tpu.ops.pallas_mlp import block_tail_reference, fused_block_tail_pallas
from ir_ads_tpu.ops.pallas_swin import (
    _block_reference, _block_v6_reference, pallas_window_block,
    pallas_window_block_v6, shift_region_ids as jax_region_ids,
)
from ir_ads_tpu_torch.ops.block_tail import block_tail
from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_attention
from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_rows
from ir_ads_tpu_torch.ops.dscf_rpe_packed import rpe_bias_packed
from ir_ads_tpu_torch.ops.swin_block import window_block
from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6
from ir_ads_tpu_torch.ops.window_attention import shift_region_ids


def _rand(rng, *shape, std=1.0, mean=0.0):
    return (rng.randn(*shape) * std + mean).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "h_real,w_real,shift", [(8, 12, 0), (8, 12, 2), (7, 10, 2)]
)
def test_window_block_matches_v4_kernel_and_twin(h_real, w_real, shift):
    ws, c, heads, b = 4, 32, 2, 2
    hp, wp = -(-h_real // ws) * ws, -(-w_real // ws) * ws
    rng = np.random.RandomState(0)
    x = _rand(rng, b, hp, wp, c)
    ln_w, ln_b = _rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05)
    wqkv, bqkv = _rand(rng, c, 3 * c, std=0.05), _rand(rng, 3 * c, std=0.05)
    wproj, bproj = _rand(rng, c, c, std=0.05), _rand(rng, c, std=0.05)
    bias = _rand(rng, heads, ws * ws, ws * ws, std=0.05)
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    if shift:
        np.testing.assert_array_equal(region, jax_region_ids(hp, wp, ws, shift))
    scale = (c // heads) ** -0.5
    jargs = [jnp.asarray(a) for a in (ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias)]
    jreg = None if region is None else jnp.asarray(region)
    geo = dict(h_real=h_real, w_real=w_real, shift=shift)
    want_kernel = pallas_window_block(
        jnp.asarray(x), *jargs, jreg, scale, heads, ws, interpret=True, **geo)
    want_twin = _block_reference(jnp.asarray(x), *jargs, jreg, scale, heads, ws, **geo)
    got = window_block(
        _t(x), _t(ln_w), _t(ln_b), _t(wqkv.T), _t(bqkv), _t(wproj.T), _t(bproj),
        _t(bias), None if region is None else _t(region), scale, heads, ws, **geo,
    ).numpy()
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n,c,hidden,ca", [(96, 128, 512, 8), (130, 64, 256, 4)])
def test_block_tail_matches_tail_kernel_and_twin(n, c, hidden, ca):
    rng = np.random.RandomState(1)
    x = _rand(rng, n, c)
    p = [
        _rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
        _rand(rng, c, hidden, std=0.05), _rand(rng, hidden, std=0.05),
        _rand(rng, hidden, c, std=0.05), _rand(rng, c, std=0.05),
        _rand(rng, c, ca, std=0.05), _rand(rng, ca, std=0.05),
        _rand(rng, ca, c, std=0.05), _rand(rng, c, std=0.05),
    ]
    jp = [jnp.asarray(a) for a in p]
    want_kernel = fused_block_tail_pallas(jnp.asarray(x), *jp, interpret=True)
    want_twin = block_tail_reference(jnp.asarray(x), *jp)
    # the port takes Linear weights as (out, in)
    tp = [_t(a.T) if a.ndim == 2 else _t(a) for a in p]
    got = block_tail(_t(x), *tp).numpy()
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,g,hg", [(16, 16, 1, 2), (12, 16, 2, 2)])
def test_rpe_rows_matches_rows_kernel_and_twin(h, w, g, hg):
    b, m, s1, s2 = 2, 8, 23, 31
    rng = np.random.RandomState(2)
    pos = rng.uniform(-1.0, 1.0, (b * g, m, 2)).astype(np.float32)
    table = _rand(rng, g, hg, s1, s2)
    want_kernel = dscf_rpe_bias_rows_pallas(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.float32,
        j_chunk=4, interpret=True,
    )
    want_twin = dscf_rpe_bias_rows_reference(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.float32)
    got = rpe_bias_rows(_t(pos), _t(table), h, w, torch.float32).numpy()
    assert got.shape == (b * g, hg, h, m, w)
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,mp", [(16, 16), (12, 16)])
def test_rows_attention_matches_rows_kernels_and_twin(m, mp, packed):
    bg, h, w, gc, hg = 2, 8, 16, 16, 2
    rng = np.random.RandomState(3)
    q = _rand(rng, bg, h * w, gc)
    k = _rand(rng, bg, mp, gc)
    v = _rand(rng, bg, mp, gc)
    k[:, m:], v[:, m:] = 3.0, 5.0  # padded keys are ignored whatever they hold
    bias = _rand(rng, bg, hg, h, m, w)
    j = [jnp.asarray(a) for a in (q, k, v, bias)]
    want_kernel = pallas_dscf_attention_rows(
        *j, 0.25, hg, interpret=True, packed=packed)
    want_twin = dscf_rows_reference(*j, 0.25, hg)
    got = dscf_rows_attention(_t(q), _t(k), _t(v), _t(bias), 0.25, hg, packed).numpy()
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


# bf16: the production dtype.  The Pallas kernels run in interpret mode with
# bf16 inputs and outputs; the plain versions must round at the same points.
# Weights are drawn ~ N(0, 1/fan_in) so that a residual kernel's branch is as
# large as x, and the bars are stated in bf16 ulps of the reference value.


def _bf16(a):
    """(jax bf16, torch bf16) of the same rounded values."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16))


def _ulps(got, want):
    """|got - want| in units of the bf16 spacing at |want| (8 bits)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    return np.abs(got - want) / spacing


def _branch_rel(got, want, x):
    want = np.asarray(want, np.float32)
    return (np.linalg.norm(got.float().numpy() - want)
            / np.linalg.norm(want - np.asarray(x, np.float32)))


def test_window_block_bf16_matches_v4_kernel():
    h_real, w_real, shift, ws, c, heads, b = 7, 10, 2, 4, 32, 2, 2
    hp, wp = 8, 12
    rng = np.random.RandomState(4)
    x = _rand(rng, b, hp, wp, c)
    p = [_rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
         _rand(rng, c, 3 * c, std=c ** -0.5), _rand(rng, 3 * c, std=0.02),
         _rand(rng, c, c, std=c ** -0.5), _rand(rng, c, std=0.02)]
    bias = _rand(rng, heads, ws * ws, ws * ws)
    region = shift_region_ids(hp, wp, ws, shift)
    scale = (c // heads) ** -0.5
    geo = dict(h_real=h_real, w_real=w_real, shift=shift)
    (jx, tx), jp_tp = _bf16(x), [_bf16(a) for a in p]
    want = pallas_window_block(
        jx, *[j for j, _ in jp_tp], jnp.asarray(bias), jnp.asarray(region),
        scale, heads, ws, interpret=True, **geo)
    tp = [t.t() if t.ndim == 2 else t for _, t in jp_tp]
    got = window_block(tx, *tp, _t(bias), _t(region), scale, heads, ws, **geo)
    assert got.dtype == torch.bfloat16
    # the same rounding points in f32 sums of another order: an output may
    # flip by one ulp; the branch y - x agrees to 1e-3 of its size
    assert _ulps(got, want).max() <= 1.0
    assert _branch_rel(got, want, np.asarray(jx, np.float32)) <= 1e-3


def test_block_tail_bf16_matches_tail_kernel():
    n, c, hidden, ca = 96, 128, 512, 8
    rng = np.random.RandomState(5)
    x = _rand(rng, n, c)
    p = [_rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
         _rand(rng, c, hidden, std=c ** -0.5), _rand(rng, hidden, std=0.02),
         _rand(rng, hidden, c, std=hidden ** -0.5), _rand(rng, c, std=0.02),
         _rand(rng, c, ca, std=c ** -0.5), _rand(rng, ca, std=0.02),
         _rand(rng, ca, c, std=ca ** -0.5), _rand(rng, c, std=0.02)]
    (jx, tx), jp_tp = _bf16(x), [_bf16(a) for a in p]
    want = fused_block_tail_pallas(jx, *[j for j, _ in jp_tp], interpret=True)
    got = block_tail(tx, *[t.t() if t.ndim == 2 else t for _, t in jp_tp])
    assert got.dtype == torch.bfloat16
    assert _ulps(got, want).max() <= 1.0
    assert _branch_rel(got, want, np.asarray(jx, np.float32)) <= 1e-3


def test_rpe_rows_bf16_matches_rows_kernel():
    h, w, g, hg, b, m, s1, s2 = 12, 16, 2, 2, 2, 8, 23, 31
    rng = np.random.RandomState(6)
    pos = rng.uniform(-1.0, 1.0, (b * g, m, 2)).astype(np.float32)
    table = _rand(rng, g, hg, s1, s2, std=0.5)
    want = np.asarray(dscf_rpe_bias_rows_pallas(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.bfloat16,
        j_chunk=4, interpret=True), np.float32)
    got = rpe_bias_rows(_t(pos), _t(table), h, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # In bf16 the TPU kernel rounds the table, both hat weights (computed as
    # (ay*r - s) + by in f32) and the partial product u to bf16 before its
    # f32 sums; the plain version rounds at the same points.  Each sum has
    # at most two non-zero terms, each an exact bf16 x bf16 product, so no
    # summation order can part them: bit-equal.
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
def test_rows_attention_bf16_matches_rows_kernels(packed):
    bg, h, w, gc, hg, m, mp = 2, 8, 16, 16, 2, 12, 16
    rng = np.random.RandomState(7)
    (jq, tq), (jk, tk), (jv, tv), (jb, tb) = (
        _bf16(a) for a in (_rand(rng, bg, h * w, gc), _rand(rng, bg, mp, gc),
                           _rand(rng, bg, mp, gc), _rand(rng, bg, hg, h, m, w)))
    want = pallas_dscf_attention_rows(jq, jk, jv, jb, 0.25, hg, interpret=True,
                                      packed=packed)
    got = dscf_rows_attention(tq, tk, tv, tb, 0.25, hg, packed)
    assert got.dtype == torch.bfloat16
    # each form rounds where its Pallas kernel does (packed: normalise, round
    # the probabilities, P.V; unpacked: round exp(s - max), P.V, divide), so
    # only f32 summation order parts them: one bf16 ulp at the most
    assert _ulps(got, want).max() <= 1.0


@pytest.mark.parametrize("fn", [rpe_bias_rows, rpe_bias_packed])
def test_cpu_wrappers_reject_planes_the_formula_divides_by(fn):
    with pytest.raises(ValueError):
        fn(torch.zeros(1, 8, 2), torch.zeros(1, 2, 5, 5), 1, 4, torch.float32)


# K5 (whole block, v6) and K6 (packed rpe bias).


def _v6_case(rng, b, h, w, c, heads, ws, shift, streams, std):
    """numpy inputs of one v6 block in the JAX layouts (Dense kernels (in,
    out)); ``std(fan_in)`` is the weights' spread."""
    hidden, ca, n = 4 * c, c // 8, ws * ws
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    lead = (streams,) if streams > 1 else ()
    x = _rand(rng, b, h, w, c)
    attn = [_rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
            _rand(rng, c, 3 * c, std=std(c)), _rand(rng, 3 * c, std=0.02),
            _rand(rng, c, c, std=std(c)), _rand(rng, c, std=0.02),
            _rand(rng, heads, n, n)]
    tail = [_rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
            _rand(rng, c, hidden, std=std(c)), _rand(rng, hidden, std=0.02),
            _rand(rng, hidden, c, std=std(hidden)), _rand(rng, c, std=0.02),
            _rand(rng, *lead, c, ca, std=std(c)), _rand(rng, *lead, ca, std=0.02),
            _rand(rng, *lead, ca, c, std=std(ca)), _rand(rng, *lead, c, std=0.02)]
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    return x, attn, tail, region, (c // heads) ** -0.5


def _torch_v6(attn, tail):
    """The port's parameter layout: Linear weights (out, in), the rel-pos
    bias as it is."""
    tw = lambda a: torch.tensor(a).transpose(-1, -2)  # noqa: E731
    ta = [tw(a) if i in (2, 4) else torch.tensor(a) for i, a in enumerate(attn)]
    tt = [tw(a) if i in (2, 4, 6, 8) else torch.tensor(a) for i, a in enumerate(tail)]
    return ta, tt


@pytest.mark.parametrize(
    "h,w,shift,streams", [(8, 8, 0, 1), (7, 6, 2, 1), (7, 10, 2, 2)]
)
def test_window_block_v6_matches_v6_kernel_and_twin(h, w, shift, streams):
    ws, c, heads, b = 4, 32, 2, 4
    rng = np.random.RandomState(20)
    x, attn, tail, region, scale = _v6_case(
        rng, b, h, w, c, heads, ws, shift, streams, lambda f: 0.05)
    j = lambda a: [jnp.asarray(t) for t in a]  # noqa: E731
    jreg = None if region is None else jnp.asarray(region)
    want_kernel = pallas_window_block_v6(
        jnp.asarray(x), j(attn), j(tail), jreg, scale, heads, ws, shift=shift,
        interpret=True)
    want_twin = _block_v6_reference(
        jnp.asarray(x), j(attn), j(tail), jreg, scale, heads, ws, shift=shift)
    ta, tt = _torch_v6(attn, tail)
    got = window_block_v6(_t(x), ta, tt, None if region is None else _t(region),
                          scale, heads, ws, shift).numpy()
    # in f32 the twin's rounding of y between the halves does nothing: the
    # bar of tests/test_pallas_swin_v5.py for kernel against twin
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("streams", [1, 2])
def test_window_block_v6_bf16_matches_v6_kernel(streams):
    h, w, shift, ws, c, heads, b = 7, 10, 2, 4, 32, 2, 4
    rng = np.random.RandomState(21)
    x, attn, tail, region, scale = _v6_case(
        rng, b, h, w, c, heads, ws, shift, streams, lambda f: f ** -0.5)
    bf = lambda a: [jnp.asarray(t, jnp.bfloat16) for t in a]  # noqa: E731
    ja, jt = bf(attn[:6]) + [jnp.asarray(attn[6])], bf(tail)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = pallas_window_block_v6(jx, ja, jt, jnp.asarray(region), scale, heads,
                                  ws, shift=shift, interpret=True)
    ta, tt = _torch_v6([np.asarray(a, np.float32) for a in ja],
                       [np.asarray(a, np.float32) for a in jt])
    ta = [t.to(torch.bfloat16) for t in ta[:6]] + [ta[6]]
    tt = [t.to(torch.bfloat16) for t in tt]
    got = window_block_v6(torch.as_tensor(np.asarray(jx, np.float32)).to(torch.bfloat16),
                          ta, tt, _t(region), scale, heads, ws, shift)
    assert got.dtype == torch.bfloat16
    # the kernel keeps y = x + attention in f32 and rounds the output once; a
    # plain version that rounded y between the halves differs by several
    # ulps wherever the tail cancels y.  Same rounding points, f32 sums of
    # another order: an output may flip by one ulp
    assert _ulps(got, want).max() <= 1.0
    assert _branch_rel(got, want, np.asarray(jx, np.float32)) <= 1e-3


@pytest.mark.parametrize("h,w,g,hg", [(15, 20, 2, 2), (6, 8, 1, 2)])
def test_rpe_packed_matches_packed_kernel_and_twin(h, w, g, hg):
    b, m, s1, s2 = 2, 16, 23, 31
    rng = np.random.RandomState(22)
    pos = rng.uniform(-1.0, 1.0, (b * g, m, 2)).astype(np.float32)
    table = _rand(rng, g, hg, s1, s2)
    want_kernel = dscf_rpe_bias_packed_pallas(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.float32,
        j_chunk=8, interpret=True)
    want_twin = dscf_rpe_bias_packed_reference(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.float32)
    got = rpe_bias_packed(_t(pos), _t(table), h, w, torch.float32).numpy()
    assert got.shape == (b * g, hg, m, h * w)
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rpe_packed_bf16_matches_packed_kernel():
    h, w, g, hg, b, m, s1, s2 = 15, 20, 2, 2, 2, 16, 23, 31
    rng = np.random.RandomState(23)
    pos = rng.uniform(-1.0, 1.0, (b * g, m, 2)).astype(np.float32)
    table = _rand(rng, g, hg, s1, s2, std=0.5)
    want = np.asarray(dscf_rpe_bias_packed_pallas(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.bfloat16,
        interpret=True), np.float32)
    got = rpe_bias_packed(_t(pos), _t(table), h, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # as for K3: the same bf16 rounding points as the TPU kernel, sums of at
    # most two exact products: bit-equal
    np.testing.assert_array_equal(got.float().numpy(), want)

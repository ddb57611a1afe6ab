"""The plain versions of the port's opt-in Swin block kernels against the
JAX Pallas kernels they replace (interpret mode) and their XLA twins, on
the CPU, in f32 and in bf16:

  * K15 (``window_attention_map``, Pallas ``_attn_kernel_v3``): the cases of
    tests/test_pallas_swin.py (shifted and not, a banded grid), its
    gradient against ``jax.vjp`` of ``fused_window_attention_map``;
  * K14 (``window_block_full``, ``_attn_kernel_v5``): the cases of
    tests/test_pallas_swin_v5.py (aligned, shifted, padded and shifted, the
    packed-head widths);
  * K13 (``window_block_v7``, ``_attn_kernel_v7``): the 6x7 map of
    tests/test_pallas_swin_v7.py with window 4, shifted and not, with
    adapters stacked per stream.

f32: the JAX tests' bar (2e-5), the same function summed in another order.
bf16: each plain version is also held, bit for bit, against the
composition of the port's plain versions that the card holds its kernel
against (K15: partition, K12, reverse; K14: pad and roll, K1, un-roll and
crop; K13: K1, un-roll and crop, K2); against the Pallas kernels, which
round at the same points and sum in f32 in another order, K15 at K12's bar
(tests/test_torch_module_path.py) and K14 and K13 at stated bars in bf16
ulps at the map's scale (a block output that cancels to near zero makes an
ulp of the value itself meaningless).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ir_ads_tpu.ops.pallas_swin as pallas_swin
from ir_ads_tpu.ops.pallas_swin import shift_region_ids
from ir_ads_tpu_torch.models.backbones.swin import pad_and_roll, unroll_and_crop
from ir_ads_tpu_torch.ops import swin_block_full as k14
from ir_ads_tpu_torch.ops import swin_block_v7 as k13
from ir_ads_tpu_torch.ops import window_attention_map as k15
from ir_ads_tpu_torch.ops.block_tail import block_tail_reference
from ir_ads_tpu_torch.ops.swin_block import window_block_reference
from ir_ads_tpu_torch.ops.window_attention import window_partition, window_reverse
from ir_ads_tpu_torch.ops.window_attention_qkv import window_attention_qkv_reference

BF16 = torch.bfloat16


def _rand(rng, *shape, std=1.0, mean=0.0):
    return (rng.randn(*shape) * std + mean).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


def _scaled_err(got, want):
    """max |got - want| / max(|want|, rms want): an error at the map's scale,
    which a bf16 output that cancels to near zero does not blow up."""
    got, want = _np(got), _np(want)
    scale = np.maximum(np.abs(want), np.sqrt((want ** 2).mean()))
    return float((np.abs(got - want) / scale).max())


def _rel(got, want, base=0.0):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - _np(base)))


# ---------------------------------------------------------------------------
# K15: attention on the qkv map
# ---------------------------------------------------------------------------

# (images, hp, wp, ws, c, heads, shifted, rows_per_step): test_pallas_swin.py's
# cases, the last on a grid of one window row a step
V3_CASES = [(2, 8, 12, 4, 16, 2, False, None), (2, 8, 12, 4, 16, 2, True, None),
            (1, 12, 8, 4, 8, 2, True, 1)]


def _map_inputs(seed, b, hp, wp, ws, c, heads, shifted):
    rng = np.random.RandomState(seed)
    n = ws * ws
    qkv = rng.randn(b, hp, wp, 3 * c).astype(np.float32)
    bias = rng.randn(heads, n, n).astype(np.float32)
    region = shift_region_ids(hp, wp, ws, ws // 2) if shifted else None
    return qkv, bias, region


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", V3_CASES)
def test_k15_plain_version_matches_pallas_v3_and_its_twin(case, dtype):
    b, hp, wp, ws, c, heads, shifted, rows = case
    qkv, bias, region = _map_inputs(7, b, hp, wp, ws, c, heads, shifted)
    scale = (c // heads) ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jnp.asarray(qkv, jdt)
    jr = None if region is None else jnp.asarray(region)
    kernel = pallas_swin.pallas_window_attention_map(
        jq, jnp.asarray(bias), jr, scale, heads, ws, rows_per_step=rows, interpret=True)
    twin = pallas_swin._map_reference(jq, jnp.asarray(bias), jr, scale, heads, ws)
    tq, tb = _t(qkv, tdt), _t(bias)
    tr = None if region is None else torch.from_numpy(region)
    got = k15.window_attention_map(tq, tb, tr, scale, heads, ws)
    assert got.dtype == tdt and got.shape == (b, hp, wp, c)
    # the composition the card holds K15 against: partition, K12, reverse
    composed = window_reverse(window_attention_qkv_reference(
        window_partition(tq, ws), tb, tr, scale, heads), ws, hp, wp)
    np.testing.assert_array_equal(_np(got), _np(composed))
    if dtype == "float32":
        for want in (kernel, twin):
            np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)
    else:
        # K12's bar: the same rounding points (q * scale, probabilities,
        # output), f32 sums of another order, so a rounding may flip by one
        # bf16 ulp (2^-8 relative) inside and on the output
        for want in (kernel, twin):
            np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
        assert np.abs(_np(got) - _np(twin)).mean() < 1e-3
    assert k15.KERNEL.launches == 0


@pytest.fixture
def interpret_v3(monkeypatch):
    """The Pallas v3 wrapper reads no environment: interpret it by hand."""
    orig = pallas_swin.pallas_window_attention_map
    monkeypatch.setattr(pallas_swin, "pallas_window_attention_map",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("shifted", [False, True])
def test_k15_gradient_matches_jax_vjp(interpret_v3, shifted):
    b, hp, wp, ws, c, heads = 1, 8, 8, 4, 8, 2
    qkv, bias, region = _map_inputs(9, b, hp, wp, ws, c, heads, shifted)
    g = np.random.RandomState(10).randn(b, hp, wp, c).astype(np.float32)
    jr = None if region is None else jnp.asarray(region)
    out, vjp = jax.vjp(
        lambda a, bb: pallas_swin.fused_window_attention_map(a, bb, jr, 0.25, heads, ws),
        jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    got = k15.window_attention_map(tq, tb, None if region is None else torch.from_numpy(region),
                                   0.25, heads, ws)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_dqkv), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_dbias), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# K14: the whole-map half-block
# ---------------------------------------------------------------------------

def _attn_params(rng, c, heads, ws, std):
    """LN1, qkv, proj (JAX Dense layout, (in, out)) and the rel-pos bias."""
    n = ws * ws
    return [_rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
            _rand(rng, c, 3 * c, std=std(c)), _rand(rng, 3 * c, std=0.02),
            _rand(rng, c, c, std=std(c)), _rand(rng, c, std=0.02),
            _rand(rng, heads, n, n)]


def _torch_params(params, dtype, linear_at, f32_at=()):
    """The port's layout: Linear weights (out, in) at ``linear_at``, the rest
    as they are; in ``dtype`` but at ``f32_at`` (the rel-pos bias)."""
    out = []
    for i, a in enumerate(params):
        t = _t(a)
        if i in linear_at:
            t = t.transpose(-1, -2).contiguous()
        out.append(t if i in f32_at else t.to(dtype))
    return out


# (h, w, shift, heads, c): test_pallas_swin_v5.py's cases
V5_CASES = [(8, 8, 0, 2, 32), (8, 8, 2, 2, 32), (7, 6, 2, 2, 32), (8, 8, 2, 4, 128),
            (7, 10, 2, 8, 256)]


def _v5_case(seed, h, w, shift, heads, c, std, b=2, ws=4):
    rng = np.random.RandomState(seed)
    params = _attn_params(rng, c, heads, ws, std)
    x = _rand(rng, b, h, w, c)
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    return x, params, region, (c // heads) ** -0.5


@pytest.mark.parametrize("h,w,shift,heads,c", V5_CASES)
def test_k14_plain_version_matches_pallas_v5_and_its_twin(h, w, shift, heads, c):
    ws = 4
    x, params, region, scale = _v5_case(11, h, w, shift, heads, c, lambda f: 0.05)
    jp = [jnp.asarray(a) for a in params]
    jr = None if region is None else jnp.asarray(region)
    kernel = pallas_swin.pallas_window_block_full(
        jnp.asarray(x), *jp, jr, scale, heads, ws, shift=shift, interpret=True)
    twin = pallas_swin._block_full_reference(jnp.asarray(x), *jp, jr, scale, heads, ws,
                                             shift=shift)
    got = k14.window_block_full(
        _t(x), *_torch_params(params, torch.float32, (2, 4), (6,)),
        None if region is None else torch.from_numpy(region), scale, heads, ws, shift)
    assert got.shape == x.shape
    for want in (kernel, twin):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    assert k14.KERNEL.launches == 0


@pytest.mark.parametrize("h,w,shift,heads,c", [V5_CASES[2], V5_CASES[4]])
def test_k14_bf16_matches_pallas_v5_and_is_k1_on_the_padded_map(h, w, shift, heads, c):
    ws = 4
    x, params, region, scale = _v5_case(12, h, w, shift, heads, c, lambda f: f ** -0.5)
    jx = jnp.asarray(x, jnp.bfloat16)
    jp = [jnp.asarray(a, jnp.bfloat16) for a in params[:6]] + [jnp.asarray(params[6])]
    want = pallas_swin.pallas_window_block_full(
        jx, *jp, jnp.asarray(region), scale, heads, ws, shift=shift, interpret=True)
    tx = _t(x, BF16)
    tp = _torch_params(params, BF16, (2, 4), (6,))
    tr = torch.from_numpy(region)
    got = k14.window_block_full(tx, *tp, tr, scale, heads, ws, shift)
    assert got.dtype == BF16
    # the composition the card holds K14 against: pad and roll, K1 (LN1
    # zeroed at padding), un-roll and crop
    composed = unroll_and_crop(window_block_reference(
        pad_and_roll(tx, ws, shift), *tp, tr, scale, heads, ws, h, w, shift), h, w, shift)
    np.testing.assert_array_equal(_np(got), _np(composed))
    # against the Pallas kernel: the same rounding points, f32 sums of
    # another order (LN statistics, products), so a rounding of qkv, of the
    # probabilities or of the output may flip; at C = 256 an output moves by
    # up to one bf16 ulp at the map's scale (measured: 2.0 x 2^-8 of
    # max(|y|, rms y), the branch y - x 3.05e-3 apart; at C = 32 bit-equal)
    assert _scaled_err(got, want) <= 2.0 ** -7
    assert _rel(got, want, jx) <= 5e-3


# ---------------------------------------------------------------------------
# K13: the banded whole block
# ---------------------------------------------------------------------------

def _tail_params(rng, c, streams, std):
    """LN2, FFN and adapter (JAX layout), the adapter stacked per stream."""
    hidden, ca = 4 * c, c // 8
    lead = (streams,) if streams > 1 else ()
    return [_rand(rng, c, std=0.05, mean=1.0), _rand(rng, c, std=0.05),
            _rand(rng, c, hidden, std=std(c)), _rand(rng, hidden, std=0.02),
            _rand(rng, hidden, c, std=std(hidden)), _rand(rng, c, std=0.02),
            _rand(rng, *lead, c, ca, std=std(c)), _rand(rng, *lead, ca, std=0.02),
            _rand(rng, *lead, ca, c, std=std(ca)), _rand(rng, *lead, c, std=0.02)]


def _v7_case(seed, h, w, shift, streams, std, c=32, heads=4, ws=4):
    """The 6x7 map of test_pallas_swin_v7.py, padded and rolled as the
    block hands it to the kernel."""
    rng = np.random.RandomState(seed)
    b = 2 * streams
    x = _rand(rng, b, h, w, c)
    attn = _attn_params(rng, c, heads, ws, std)
    tail = _tail_params(rng, c, streams, std)
    xm = pad_and_roll(torch.from_numpy(x), ws, shift).numpy()
    hp, wp = xm.shape[1:3]
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    return xm, attn, tail, region, (c // heads) ** -0.5


V7_CASES = [(6, 7, 0, 1), (6, 7, 2, 1), (6, 7, 2, 2)]


@pytest.mark.parametrize("h,w,shift,streams", V7_CASES)
def test_k13_plain_version_matches_pallas_v7_and_its_twin(h, w, shift, streams):
    ws, heads = 4, 4
    xm, attn, tail, region, scale = _v7_case(13, h, w, shift, streams, lambda f: 0.05)
    j = lambda a: [jnp.asarray(t) for t in a]  # noqa: E731
    jr = None if region is None else jnp.asarray(region)
    kernel = pallas_swin.pallas_window_block_v7(
        jnp.asarray(xm), j(attn), j(tail), jr, scale, heads, ws, h_real=h, w_real=w,
        shift=shift, interpret=True)
    twin = pallas_swin._block_v7_reference(jnp.asarray(xm), j(attn), j(tail), jr, scale, heads,
                                           ws, h, w, shift=shift)
    got = k13.window_block_v7(
        _t(xm), _torch_params(attn, torch.float32, (2, 4), (6,)),
        _torch_params(tail, torch.float32, (2, 4, 6, 8)),
        None if region is None else torch.from_numpy(region), scale, heads, ws, h, w, shift)
    assert got.shape == xm.shape
    for want in (kernel, twin):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    assert k13.KERNEL.launches == 0


@pytest.mark.parametrize("h,w,shift,streams", V7_CASES[1:])
def test_k13_bf16_matches_pallas_v7_and_is_k1_then_k2(h, w, shift, streams):
    ws, heads = 4, 4
    xm, attn, tail, region, scale = _v7_case(14, h, w, shift, streams, lambda f: f ** -0.5)
    jx = jnp.asarray(xm, jnp.bfloat16)
    ja = [jnp.asarray(a, jnp.bfloat16) for a in attn[:6]] + [jnp.asarray(attn[6])]
    jt = [jnp.asarray(a, jnp.bfloat16) for a in tail]
    want = pallas_swin.pallas_window_block_v7(
        jx, ja, jt, jnp.asarray(region), scale, heads, ws, h_real=h, w_real=w, shift=shift,
        interpret=True)
    tx = _t(xm, BF16)
    ta = _torch_params(attn, BF16, (2, 4), (6,))
    tt = _torch_params(tail, BF16, (2, 4, 6, 8))
    tr = torch.from_numpy(region)
    got = k13.window_block_v7(tx, ta, tt, tr, scale, heads, ws, h, w, shift)
    assert got.dtype == BF16
    # the composition the card holds K13 against: K1, un-roll and crop, then
    # K2 per stream, equal at every real position
    y = unroll_and_crop(window_block_reference(tx, *ta, tr, scale, heads, ws, h, w, shift),
                        h, w, shift)
    per, c = y.shape[0] // streams, y.shape[-1]
    composed = torch.cat([
        block_tail_reference(y[i * per:(i + 1) * per].reshape(-1, c), *tt[:6],
                             *(t[i] if streams > 1 else t for t in tt[6:]))
        for i in range(streams)]).reshape(y.shape)
    np.testing.assert_array_equal(_np(unroll_and_crop(got, h, w, shift)), _np(composed))
    # against the Pallas kernel: K14's bar on y (one ulp at the map's
    # scale), which the tail carries on, and one more flip on the output
    # (measured: 3.26 and 3.70 x 2^-8 of max(|out|, rms out); what the block
    # adds to x 2.15e-3 apart)
    assert _scaled_err(got, want) <= 2.0 ** -6
    assert _rel(got, want, jx) <= 5e-3


def test_k13_and_k14_are_eval_kernels_and_k15_takes_gradients():
    """K13 and K14 have no backward: they raise when an input requires a
    gradient, as the JAX package's train mode runs pallas4 in their place;
    K15's backward is its plain version's vjp."""
    ws, heads, h, w = 4, 4, 6, 7
    xm, attn, tail, region, scale = _v7_case(15, h, w, 2, 1, lambda f: 0.05)
    ta = _torch_params(attn, torch.float32, (2, 4), (6,))
    tt = _torch_params(tail, torch.float32, (2, 4, 6, 8))
    tr = torch.from_numpy(region)
    with pytest.raises(RuntimeError, match="eval-only"):
        k13.window_block_v7(_t(xm).requires_grad_(), ta, tt, tr, scale, heads, ws, h, w, 2)
    x = _t(unroll_and_crop(torch.from_numpy(xm), h, w, 2))
    with pytest.raises(RuntimeError, match="eval-only"):
        k14.window_block_full(x, *ta[:6], ta[6].requires_grad_(), tr, scale, heads, ws, 2)
    with torch.no_grad():  # what the eval dispatches run under
        assert k13.window_block_v7(_t(xm), ta, tt, tr, scale, heads, ws, h, w, 2).shape == xm.shape
    qkv = torch.randn(1, 8, 8, 3 * 8, requires_grad=True)
    k15.window_attention_map(qkv, torch.zeros(2, 16, 16), None, 0.25, 2, ws).sum().backward()
    assert qkv.grad is not None and qkv.grad.shape == qkv.shape

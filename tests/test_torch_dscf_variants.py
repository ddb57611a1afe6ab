"""The port's opt-in DSCF variants against the JAX package, on the CPU:

  * K18's plain version (``rpe_bias_jmajor``) against ``dscf_rpe_bias_pallas``
    (``_rpe_kernel``, interpreted) and its twin, f32 at the JAX test's
    1e-5, bf16 at the bar stated below;
  * K17's plain version (``dscf_attention``) against
    ``pallas_dscf_attention`` (``_dscf_kernel``) and the twin
    ``dscf_reference``, f32 at 1e-5, with query tiles that pad the queries,
    and bf16;
  * K16's plain version (``dscf_fused_attention``) against
    ``pallas_dscf_attention_fused`` (``_dscf_fused_kernel``), f32 and bf16,
    and the ``ValueError`` of a plane with no row band;
  * the gradients of the three wrappers against ``jax.vjp`` of
    ``dscf_rpe_bias``, ``dscf_attention`` and ``dscf_attention_fused``, f32;
  * ``DAttentionMM`` under pallas4, pallas and pallas2 against the JAX module
    with the same ``attn_impl``, f32, at n = 2 x 4 offsets a field (2n % 8
    == 0) and n = 2 x 3 (pallas4 then takes the einsum branch; pallas and
    pallas2 pad the keys to 128);
  * the tiny CMNeXt sliding-window slice under ``dscf_pallas4``,
    ``dscf_pallas`` and ``dscf_pallas2`` against JAX with the environment
    each stands for, f32, atol 2e-3 / rtol 1e-3, at 64x128 frames, where the
    DSCF planes are 16x32, 8x16, 4x8 and 2x4 (every level has a row band
    for the fused kernel) and n = 2 x 4 at every level.

The Pallas kernels run in interpret mode (``IR_ADS_PALLAS_INTERPRET=1``,
which pallas_dscf and pallas_dscf_rpe read at each call).  In bf16 the scale
is 0.25, exact in bf16: at 8 ** -0.5 the reference rounds the scale to bf16
first and the port does not (tests/test_torch_rows_forms.py, ROADMAP.md
Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.ops.pallas_dscf import (
    NEG_INF, dscf_attention as jax_dscf_attention, dscf_attention_fused as jax_fused,
    dscf_reference, pallas_dscf_attention, pallas_dscf_attention_fused,
)
from ir_ads_tpu.ops.pallas_dscf_rpe import (
    dscf_rpe_bias as jax_rpe_bias, dscf_rpe_bias_pallas, dscf_rpe_bias_reference,
)
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops.dscf_attention import dscf_attention
from ir_ads_tpu_torch.ops.dscf_fused import band_rows, dscf_fused_attention
from ir_ads_tpu_torch.ops.dscf_rpe_jmajor import rpe_bias_jmajor
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables
from test_torch_slice_r5 import R5_ENV

BF16 = torch.bfloat16
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bf16(a):
    """(jax bf16, torch bf16) of the same rounded values."""
    return jnp.asarray(a, jnp.bfloat16), _t(a).to(BF16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------
# K18: the j-major rpe bias, _rpe_kernel's f32 form
# --------------------------------------------------------------------------

def _rpe_inputs(seed, b, g, hg, m, s1, s2, std=1.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1.0, 1.0, (b * g, m, 2)).astype(np.float32)
    return pos, (std * rng.randn(g, hg, s1, s2)).astype(np.float32)


@pytest.mark.parametrize("h,w,g,hg", [(24, 32, 1, 2), (12, 16, 2, 2)])
def test_rpe_jmajor_matches_rpe_kernel_and_twin(h, w, g, hg):
    pos, table = _rpe_inputs(90, 2, g, hg, 8, 23, 31)
    want_kernel = dscf_rpe_bias_pallas(jnp.asarray(pos), jnp.asarray(table), h, w,
                                       out_dtype=jnp.float32, j_chunk=4, interpret=True)
    want_twin = dscf_rpe_bias_reference(jnp.asarray(pos), jnp.asarray(table), h, w,
                                        out_dtype=jnp.float32)
    got = rpe_bias_jmajor(_t(pos), _t(table), h, w, torch.float32).numpy()
    assert got.shape == (2 * g, hg, 8, h, w)
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("h,w,g,hg", [(24, 32, 1, 2), (12, 16, 2, 2)])
def test_rpe_jmajor_bf16_matches_rpe_kernel(h, w, g, hg):
    """``_rpe_kernel`` keeps its hat weights, the table and u in f32 and
    rounds once; so does the plain version.  The two sum two f32 products
    at a time, each side possibly with a fused multiply-add, so an output
    near a bf16 rounding boundary may land one bf16 ulp away: the bar is
    one ulp and at most 1 % of the outputs.  K3's form (bf16 hat weights,
    table and u) must fail it."""
    from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_bf16

    pos, table = _rpe_inputs(91, 2, g, hg, 8, 23, 31, std=0.5)
    want = _np(dscf_rpe_bias_pallas(jnp.asarray(pos), jnp.asarray(table), h, w,
                                    out_dtype=jnp.bfloat16, j_chunk=4, interpret=True))
    got = rpe_bias_jmajor(_t(pos), _t(table), h, w, BF16)
    assert got.dtype == BF16
    got = got.float().numpy()
    k3 = rpe_bias_bf16(_t(pos), _t(table), h, w, "bemhw").to(BF16).float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    share, share_k3 = float((got != want).mean()), float((k3 != want).mean())
    print(f"{share:.5f} of outputs differ; in K3's form {share_k3:.5f}")
    assert (np.abs(got - want) <= spacing).all()
    assert share <= 0.01 < share_k3


# --------------------------------------------------------------------------
# K17: attention over the packed bias
# --------------------------------------------------------------------------

def _packed_inputs(seed, bg=4, hw=100, m=24, mp=128, hg=2, hc=8):
    """tests/test_pallas_dscf.py's data: keys zero past m, their bias -1e9."""
    rng = np.random.RandomState(seed)
    gc = hg * hc
    q = rng.randn(bg, hw, gc).astype(np.float32)
    k, v = (np.pad(rng.randn(bg, m, gc), ((0, 0), (0, mp - m), (0, 0))).astype(np.float32)
            for _ in range(2))
    bias = rng.randn(bg, hw, hg, mp)
    bias[..., m:] = NEG_INF
    return q, k, v, bias.reshape(bg, hw, hg * mp).astype(np.float32)


@pytest.mark.parametrize("hw,tile", [(100, 512), (37, 16)])
def test_attention_matches_dscf_kernel_and_twin(hw, tile):
    q, k, v, bias = _packed_inputs(92, hw=hw)
    j = [jnp.asarray(a) for a in (q, k, v, bias)]
    want_kernel = pallas_dscf_attention(*j, 0.35, 2, query_tile=tile, interpret=True)
    want_twin = dscf_reference(*j, 0.35, 2)
    got = dscf_attention(*(_t(a) for a in (q, k, v, bias)), 0.35, 2).numpy()
    assert got.shape == q.shape
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_attention_bf16_matches_dscf_kernel():
    """Normalise, round the probabilities, P.V: the kernel's rounding points,
    bit for bit.  With the padded columns' bias 0 in place of -1e9 (the
    planted fault of chip_smoke.py) the zero keys take a share of every
    softmax and the outputs move."""
    q, k, v, bias = _packed_inputs(93, hw=64, m=40)
    (jq, tq), (jk, tk), (jv, tv), (jb, tb) = (_bf16(a) for a in (q, k, v, bias))
    want = _np(pallas_dscf_attention(jq, jk, jv, jb, 0.25, 2, interpret=True))
    got = dscf_attention(tq, tk, tv, tb, 0.25, 2)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)
    bad = tb.reshape(4, 64, 2, 128).clone()
    bad[..., 40:] = 0.0
    moved = dscf_attention(tq, tk, tv, bad.reshape(tb.shape), 0.25, 2).float().numpy()
    assert float((moved != want).mean()) > 0.5


# --------------------------------------------------------------------------
# K16: the fused attention
# --------------------------------------------------------------------------

def _fused_inputs(seed, bg=2, g=1, h=8, w=16, hg=2, m=48, s1=15, s2=31, table_std=3.0):
    rng = np.random.RandomState(seed)
    gc = hg * 8
    q = rng.randn(bg, h * w, gc).astype(np.float32)
    k, v = (rng.randn(bg, m, gc).astype(np.float32) for _ in range(2))
    pos = rng.uniform(-1.0, 1.0, (bg, m, 2)).astype(np.float32)
    table = (table_std * rng.randn(g, hg, s1, s2)).astype(np.float32)
    return q, k, v, pos, table


@pytest.mark.parametrize("bg,g,h,w", [(2, 1, 8, 16), (4, 2, 4, 8)])
def test_fused_matches_fused_kernel_f32(bg, g, h, w):
    q, k, v, pos, table = _fused_inputs(94, bg=bg, g=g, h=h, w=w)
    want = pallas_dscf_attention_fused(*(jnp.asarray(a) for a in (q, k, v, pos, table)),
                                       h, w, 0.35, 2, store_dtype=jnp.float32,
                                       interpret=True)
    got = dscf_fused_attention(*(_t(a) for a in (q, k, v, pos, table)), h, w, 0.35, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_fused_bf16_matches_fused_kernel():
    """K3's rounding of the bias, then K4's unpacked form: the fused
    kernel's rounding points, bit for bit (the interpreted fused kernel is
    itself bit-equal to the rows bias kernel followed by the unpacked rows
    kernel here)."""
    q, k, v, pos, table = _fused_inputs(95)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(a) for a in (q, k, v))
    want = _np(pallas_dscf_attention_fused(jq, jk, jv, jnp.asarray(pos), jnp.asarray(table),
                                           8, 16, 0.25, 2, store_dtype=jnp.bfloat16,
                                           interpret=True))
    got = dscf_fused_attention(tq, tk, tv, _t(pos), _t(table), 8, 16, 0.25, 2)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("h,w", [(4, 7), (15, 20)])
def test_fused_has_the_reference_band_domain(h, w):
    """No divisor ``rows`` of h makes rows * w a multiple of 8: the reference
    raises, and so does the port, on every device."""
    from ir_ads_tpu.ops.pallas_dscf import _pick_band_rows

    with pytest.raises(ValueError):
        _pick_band_rows(h, w, 16, 2)
    with pytest.raises(ValueError):
        band_rows(h, w, 16, 2)
    q, k, v, pos, table = _fused_inputs(96, h=h, w=w, m=16)
    with pytest.raises(ValueError):
        dscf_fused_attention(*(_t(a) for a in (q, k, v, pos, table)), h, w, 0.35, 2)
    for hh, ww in [(16, 32), (8, 16), (4, 8), (2, 4), (120, 160), (30, 40)]:
        assert band_rows(hh, ww, 600, 2) == _pick_band_rows(hh, ww, 600, 2)


# --------------------------------------------------------------------------
# gradients, f32
# --------------------------------------------------------------------------

def _vjp_check(port_fn, jax_fn, args, names, seed, **tol):
    outs = jax_fn(*(jnp.asarray(a) for a in args))
    g = np.random.RandomState(seed).randn(*outs.shape).astype(np.float32)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_() for a in args]
    port_fn(*leaves).backward(_t(g))
    for name, leaf, want in zip(names, leaves, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), err_msg=name, **tol)


def test_gradients_match_jax_vjp(interpret):
    """tests/test_pallas_dscf.py's gradient bar, 1e-4."""
    pos, table = _rpe_inputs(97, 2, 1, 2, 8, 23, 31)
    _vjp_check(lambda p, t: rpe_bias_jmajor(p, t, 12, 16, torch.float32),
               lambda p, t: jax_rpe_bias(p, t, 12, 16, jnp.float32),
               (pos, table), ("pos", "table"), 98, atol=1e-4, rtol=1e-4)
    q, k, v, bias = _packed_inputs(99, bg=2, hw=20)
    _vjp_check(lambda *a: dscf_attention(*a, 0.35, 2),
               lambda *a: jax_dscf_attention(*a, 0.35, 2),
               (q, k, v, bias), ("q", "k", "v", "bias"), 100, atol=1e-4, rtol=1e-4)
    q, k, v, pos, table = _fused_inputs(101, h=4, w=8, m=16, table_std=1.0)
    _vjp_check(lambda *a: dscf_fused_attention(*a, 4, 8, 0.35, 2),
               lambda *a: jax_fused(*a, 4, 8, 0.35, 2, jnp.float32),
               (q, k, v, pos, table), ("q", "k", "v", "pos", "table"), 102,
               atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# DAttentionMM and the tiny slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["pallas4", "pallas", "pallas2"])
@pytest.mark.parametrize("h,w", [(8, 16), (8, 12)])
def test_dattention_variant_matches_jax(interpret, monkeypatch, attn_impl, h, w):
    """8x16 at stride 4: n = 2 x 4, every variant's own branch; 8x12: n = 2 x
    3, 2n = 12, where pallas4 takes the einsum branch (its bias from
    ``IR_ADS_DSCF_RPE3=pallas`` and the port's K6) and pallas and pallas2
    pad the 12 keys to 128."""
    monkeypatch.setenv("IR_ADS_DSCF_RPE3", "pallas")
    rng = np.random.RandomState(103)
    x, y = (rng.randn(2, h, w, 32).astype(np.float32) for _ in range(2))
    mod = jswin.DAttentionMM(dim=32, n_heads=4, n_groups=2, stride=4, attn_impl=attn_impl)
    v = random_variables(mod, 104, jnp.asarray(x), jnp.asarray(y))
    v["params"]["rpe_table"] = v["params"]["rpe_table"] * 20
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(y), False)
    port = tswin.DAttentionMM(32, 4, 2, 4, attn_impl=attn_impl, rpe3="pallas").eval()
    port.load_state_dict(from_flax(v), strict=True)
    n = (h // 4) * (w // 4)
    assert port.branch(n) == (attn_impl if attn_impl != "pallas4" or 2 * n % 8 == 0
                              else "xla")
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)


H, W = 64, 128  # DSCF planes 16x32 ... 2x4, n = 2 x 4 at every level

DSCF_ENV = {  # the JAX package's environment each dispatch stands for: r5's
    "dscf_pallas4": {**R5_ENV, "IR_ADS_DSCF_ATTN": "pallas4,pallas4,pallas4,xla"},
    "dscf_pallas": {**R5_ENV, "IR_ADS_DSCF_ATTN": "pallas"},
    "dscf_pallas2": {**R5_ENV, "IR_ADS_DSCF_ATTN": "pallas2"},
}


def _jax_model():
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                     backbone_kwargs=dict(TINY, drop_path_rate=0.0),
                     head_dims=(32, 16), mmst_mask=False, upsample_logits=False)


@pytest.fixture(scope="module")
def slice_inputs():
    """Frames and weights, shared by the dispatches: the parameter tree is
    the same under every ``attn_impl``, so one set of weights loads with
    ``strict=True`` under each."""
    rng = np.random.RandomState(105)
    rgb, dte = (rng.randn(2, H, W, 3).astype(np.float32) for _ in range(2))
    return rgb, dte, random_variables(_jax_model(), 106, jnp.asarray(rgb), jnp.asarray(dte))


@pytest.mark.parametrize("dispatch", ["dscf_pallas4", "dscf_pallas", "dscf_pallas2"])
def test_sliding_window_slice_matches_jax_dscf_variant(monkeypatch, slice_inputs, dispatch):
    for k, val in DSCF_ENV[dispatch].items():
        monkeypatch.setenv(k, val)
    rgb, dte, v = slice_inputs
    model = _jax_model()
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    want = np.asarray(jax_sliding(fwd, (H, W), (H, W), 5, overlap=1.0 / 3.0, flip=True,
                                  fuse=True)(jnp.asarray(rgb), jnp.asarray(dte)))

    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False, dispatch=dispatch).eval()
    port.load_state_dict(from_flax(v), strict=True)
    assert [s.blocks[0].attn_impl for s in port.backbone.stages] == list(tswin.R5_BLOCKS)
    dscf = [m.deform_atten for m in port.backbone.DeformMPGBlocks]
    assert [d.branch(8) for d in dscf] == list(tswin.DISPATCH[dispatch][1])
    predict = make_sliding_window_fn(lambda r, d: port(r, d)[0], (H, W), (H, W), 5)
    with torch.no_grad():
        got = predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)

"""The Swin module path and K12 against the JAX package, on the CPU.

  * ``shift_window_mask`` and ``window_attention`` against
    ir_ads_tpu.ops.window_attention, f32.
  * K12's plain version (``window_attention_qkv_reference``) against the
    Pallas v2 kernel in interpret mode and against its XLA twin
    ``_qkv_reference``, f32 and bf16, the cases of tests/test_pallas_swin.py
    (shifted, unshifted) and window counts the Pallas wrapper pads to its
    chunk; its gradient against ``jax.vjp`` of ``fused_window_attention_qkv``.
  * The Swin block's module path (LN1, ShiftWindowMSA, residual, the fused
    tail) under ``pallas`` and ``xla`` against the JAX block, and the tiny
    CMNeXt sliding-window slice under the bench's r2, r1 and xla sets
    against JAX with ``IR_ADS_SWIN_ATTN``, ``IR_ADS_DSCF_ATTN``,
    ``IR_ADS_FFN=fused`` and ``IR_ADS_PALLAS_INTERPRET=1`` set as the bench
    and tests/test_torch_slice_r5.py set them; f32, atol 2e-3 / rtol 1e-3.
    The frames are 64x112, where every DSCF level has n = 8 offsets a field
    (2n % 8 == 0), so r2's rows path (K3 + K4) meets JAX's pallas3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ir_ads_tpu.ops.pallas_swin as pallas_swin
from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.ops.window_attention import shift_window_mask as jax_shift_window_mask
from ir_ads_tpu.ops.window_attention import window_attention as jax_window_attention
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import window_attention as twa
from ir_ads_tpu_torch.ops.window_attention_qkv import KERNEL, window_attention_qkv
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables

H, W = 64, 112  # n = 2 x 4 at every DSCF level


@pytest.fixture
def interpret_v2(monkeypatch):
    """The Pallas v2 wrapper reads no environment: interpret it by hand."""
    orig = pallas_swin.pallas_window_attention_qkv
    monkeypatch.setattr(pallas_swin, "pallas_window_attention_qkv",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("hp,wp,ws,shift", [(8, 12, 4, 2), (24, 36, 12, 6), (12, 12, 4, 0)])
def test_shift_mask_and_window_attention_match_jax(hp, wp, ws, shift):
    rng = np.random.RandomState(30)
    heads, d, b = 2, 8, 2
    n, nw = ws * ws, (hp // ws) * (wp // ws)
    q, k, v = (rng.randn(b * nw, heads, n, d).astype(np.float32) for _ in range(3))
    bias = rng.randn(heads, n, n).astype(np.float32)
    mask = None
    if shift:
        mask = twa.shift_window_mask(hp, wp, ws, shift)
        np.testing.assert_array_equal(mask, jax_shift_window_mask(hp, wp, ws, shift))
    want = jax_window_attention(*(jnp.asarray(t) for t in (q, k, v, bias)),
                                None if mask is None else jnp.asarray(mask), 0.3)
    got = twa.window_attention(*(torch.from_numpy(t) for t in (q, k, v, bias)),
                               None if mask is None else torch.from_numpy(mask), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# (images, ws, heads, d, hp, wp, shifted): test_pallas_swin.py's two cases,
# then window counts the Pallas wrapper pads to its chunk (18 and 10
# windows of 16 tokens, chunk 24 and 16)
QKV_CASES = [(3, 4, 2, 8, 8, 12, True), (10, 4, 3, 8, 4, 4, False),
             (3, 4, 2, 16, 8, 12, True), (5, 4, 2, 16, 8, 8, False)]


def _qkv_inputs(seed, images, ws, heads, d, hp, wp, shifted):
    rng = np.random.RandomState(seed)
    n, c = ws * ws, heads * d
    nw = (hp // ws) * (wp // ws)
    qkv = rng.randn(images * nw, n, 3 * c).astype(np.float32)
    bias = rng.randn(heads, n, n).astype(np.float32)
    region = pallas_swin.shift_region_ids(hp, wp, ws, ws // 2) if shifted else None
    return qkv, bias, region


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QKV_CASES)
def test_k12_plain_version_matches_pallas_v2_and_its_twin(case, dtype):
    qkv, bias, region = _qkv_inputs(31, *case)
    heads, scale = case[2], case[3] ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jr = jnp.asarray(qkv, jdt), None if region is None else jnp.asarray(region)
    kernel = pallas_swin.pallas_window_attention_qkv(jq, jnp.asarray(bias), jr, scale,
                                                     heads, interpret=True)
    twin = pallas_swin._qkv_reference(jq, jnp.asarray(bias), jr, scale, heads)
    got = window_attention_qkv(torch.from_numpy(qkv).to(tdt), torch.from_numpy(bias),
                               None if region is None else torch.from_numpy(region),
                               scale, heads)
    assert got.dtype == tdt and got.shape == (qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)
    got = got.float().numpy()
    if dtype == "float32":
        for want in (kernel, twin):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    else:
        # the same rounding points (q * scale, probabilities, output); the
        # f32 sums run in another order, so a rounding may flip by one bf16
        # ulp (2^-8 relative) inside and on the output
        for want in (kernel, twin):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-2,
                                       rtol=2e-2)
        assert np.abs(got - np.asarray(twin, np.float32)).mean() < 1e-3
    assert KERNEL.launches == 0


@pytest.mark.parametrize("case", QKV_CASES[::2])
def test_k12_gradient_matches_jax_vjp(interpret_v2, case):
    qkv, bias, region = _qkv_inputs(32, *case)
    heads, scale = case[2], case[3] ** -0.5
    g = np.random.RandomState(33).randn(*qkv.shape[:2], qkv.shape[2] // 3).astype(np.float32)
    jr = jnp.asarray(region) if region is not None else jnp.zeros((1, qkv.shape[1]), jnp.int32)
    out, vjp = jax.vjp(
        lambda a, b: pallas_swin.fused_window_attention_qkv(a, b, jr, scale, heads),
        jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    got = window_attention_qkv(tq, tb, None if region is None else torch.from_numpy(region),
                               scale, heads)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_dqkv), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_dbias), atol=1e-4, rtol=1e-4)


def test_k12_plain_version_is_k1s_attention():
    """K1's, K5's and K10's plain versions attend through K12's on their
    windows: the same function as the twin they replace, on a map."""
    from ir_ads_tpu_torch.ops.swin_block import window_attention_reference

    qkv, bias, region = _qkv_inputs(34, 2, 4, 2, 16, 8, 12, True)
    qkv_map = twa.window_reverse(torch.from_numpy(qkv), 4, 8, 12)
    got = window_attention_reference(qkv_map, torch.from_numpy(bias),
                                     torch.from_numpy(region), 0.25, 2, 4)
    want = pallas_swin._qkv_reference(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(region),
                                      0.25, 2)
    np.testing.assert_allclose(twa.window_partition(got, 4).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


BLOCK_CASES = [(8, 8, False, "rgb"), (8, 8, True, "dte"), (7, 10, True, "rgb")]


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("h,w,shifted,sub_mode", BLOCK_CASES)
def test_module_path_block_matches_jax(interpret_v2, monkeypatch, attn_impl, h, w, shifted,
                                       sub_mode):
    monkeypatch.setenv("IR_ADS_SWIN_ATTN", attn_impl)
    monkeypatch.setenv("IR_ADS_FFN", "fused")
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    x = np.random.RandomState(35).randn(2, h, w, 32).astype(np.float32)
    blk = jswin.SwinBlockAdapter(dim=32, num_heads=2, ffn_dim=128, window_size=4,
                                 shift=shifted)
    v = random_variables(blk, 36, jnp.asarray(x), sub_mode, True)
    want = blk.apply(v, jnp.asarray(x), sub_mode, True)
    port = tswin.SwinBlockAdapter(32, 2, 128, 4, shift=shifted, attn_impl=attn_impl)
    missing, unexpected = port.load_state_dict(from_flax(v), strict=False)
    other = "MLP_DTE_Adapter" if sub_mode == "rgb" else "MLP_RGB_Adapter"
    assert not unexpected and all(k.startswith(other) for k in missing)
    with torch.no_grad():
        got = port(torch.from_numpy(x), sub_mode).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-5)


BENCH_SETS = {  # bench.py's sets; it leaves IR_ADS_FFN unset (fused on its chip)
    "r2": {"IR_ADS_SWIN_ATTN": "pallas", "IR_ADS_DSCF_ATTN": "pallas3"},
    "r1": {"IR_ADS_SWIN_ATTN": "pallas", "IR_ADS_DSCF_ATTN": "xla"},
    "xla": {"IR_ADS_SWIN_ATTN": "xla", "IR_ADS_DSCF_ATTN": "xla"},
}


@pytest.mark.parametrize("dispatch", ["r2", "r1", "xla"])
def test_sliding_window_slice_matches_jax_module_path(interpret_v2, monkeypatch, dispatch):
    for k, v in {**BENCH_SETS[dispatch], "IR_ADS_FFN": "fused",
                 "IR_ADS_PALLAS_INTERPRET": "1"}.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(37)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    model = JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                      backbone_kwargs=dict(TINY, drop_path_rate=0.0),
                      head_dims=(32, 16), mmst_mask=False, upsample_logits=False)
    v = random_variables(model, 38, jnp.asarray(rgb), jnp.asarray(dte))
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    want = np.asarray(jax_sliding(fwd, (H, W), (H, W), 5, overlap=1.0 / 3.0, flip=True,
                                  fuse=True)(jnp.asarray(rgb), jnp.asarray(dte)))

    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False, dispatch=dispatch).eval()
    port.load_state_dict(from_flax(v), strict=True)
    dscf = [m.deform_atten for m in port.backbone.DeformMPGBlocks]
    assert [d.rows_path(8) for d in dscf] == [dispatch == "r2"] * 4
    predict = make_sliding_window_fn(lambda r, d: port(r, d)[0], (H, W), (H, W), 5)
    with torch.no_grad():
        got = predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)

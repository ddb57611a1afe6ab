"""The flat-input path: (B, H, W*3) rows, the bench's feed, through the port's
``PatchEmbed``, K19's plain version, the sliding window, the tiny CMNeXt and
the predictor, against the JAX package on the CPU.

  * ``PatchEmbed`` on flat rows is its NHWC output bit for bit, padded and
    not (tests/test_flat_input.py:17-27), in f32 and bf16.
  * ``xla2`` (one product per patch row, summed in f32) is the reference's
    ``xla2`` and ``xla`` bit for bit in bf16, and the port's ``xla`` to f32
    rounding in f32; the port's ``xla`` (its NHWC path, the bias added to
    the rounded product as flax adds it) is the reference's ``xla`` bit for
    bit in bf16.
  * K19's plain version against ``pallas_patch_embed`` (interpret mode) in
    bf16 with LayerNorm parameters away from 1 and 0, which the kernel
    rounds to bf16 and the XLA form keeps f32; the XLA form misses.
  * K19's gradient against ``jax.vjp`` of ``fused_patch_embed`` in f32.
  * The tiny CMNeXt slice on flat frames with ``patch_embed="pallas"``
    against JAX's with ``IR_ADS_PATCH_EMBED=pallas`` under the r5 kernel
    set, atol 2e-3 / rtol 1e-3 (tests/test_swin_parity.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.ops import pallas_patch
from ir_ads_tpu.ops.layers import PatchEmbed as JaxPatchEmbed
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import patch_embed as k19
from ir_ads_tpu_torch.ops.cuda_lib import up
from ir_ads_tpu_torch.ops.layers import PATCH_EMBED, PatchEmbed
from ir_ads_tpu_torch.serve import SemSegPredictor
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables
from test_torch_slice_r5 import R5_ENV

BF16 = torch.bfloat16
XLA_FORM_SHARE = 0.2  # of K19's outputs the XLA form (f32 LayerNorm parameters) moves


def _patch_params(rng, e, bias_std=0.02):
    """A flax PatchEmbed tree: conv kernel (4, 4, 3, E), bias, LN scale
    around 1 and bias around 0."""
    return {"params": {
        "proj": {"kernel": (rng.randn(4, 4, 3, e) / 7).astype(np.float32),
                 "bias": (bias_std * rng.randn(e)).astype(np.float32)},
        "norm": {"scale": (1.0 + 0.05 * rng.randn(e)).astype(np.float32),
                 "bias": (0.02 * rng.randn(e)).astype(np.float32)}}}


def _port_patch_embed(v, impl, dtype):
    e = v["params"]["proj"]["bias"].shape[0]
    pe = PatchEmbed(e, impl=impl)
    with torch.no_grad():
        pe.projection.weight.copy_(torch.from_numpy(
            v["params"]["proj"]["kernel"].transpose(3, 2, 0, 1).copy()))
        pe.projection.bias.copy_(torch.from_numpy(v["params"]["proj"]["bias"]))
        pe.norm.weight.copy_(torch.from_numpy(v["params"]["norm"]["scale"]))
        pe.norm.bias.copy_(torch.from_numpy(v["params"]["norm"]["bias"]))
    pe.projection.to(dtype)  # the norm stays f32, as serve.cast_model_ keeps it
    return pe.eval()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("h,w", [(16, 24), (14, 22)])  # no pad, pad
def test_patch_embed_flat_matches_nhwc(h, w, dtype):
    rng = np.random.RandomState(40)
    pe = _port_patch_embed(_patch_params(rng, 32), "xla", dtype)
    x = torch.from_numpy(rng.randn(2, h, w, 3).astype(np.float32)).to(dtype)
    with torch.no_grad():
        want, got = pe(x), pe(x.reshape(2, h, w * 3))
    assert got.shape == (2, -(-h // 4), -(-w // 4), 32) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla2_is_the_reference_xla2(monkeypatch, dtype):
    rng = np.random.RandomState(41)
    v = _patch_params(rng, 32)
    x = rng.randn(2, 16, 24 * 3).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    want = {}
    for impl in ("xla", "xla2"):
        monkeypatch.setenv("IR_ADS_PATCH_EMBED", impl)
        want[impl] = np.asarray(JaxPatchEmbed(32, dtype=jdt).apply(v, jx), np.float32)
    with torch.no_grad():
        got = _port_patch_embed(v, "xla2", tdt)(tx)
        xla = _port_patch_embed(v, "xla", tdt)(tx).float().numpy()
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(want["xla2"], want["xla"])
        np.testing.assert_array_equal(got, want["xla2"])
        # the bias added to the rounded product, as flax (ops.layers.with_bias)
        np.testing.assert_array_equal(xla, want["xla"])
    else:
        for other in (want["xla2"], want["xla"], xla):
            np.testing.assert_allclose(got, other, atol=1e-6, rtol=1e-6)


def _k19_inputs(seed, bias_std):
    rng = np.random.RandomState(seed)
    v = _patch_params(rng, 128, bias_std)["params"]
    x = rng.randn(2, 16, 24 * 3).astype(np.float32)
    wk2 = v["proj"]["kernel"].reshape(48, 128)
    return x, wk2, v["proj"]["bias"], v["norm"]["scale"], v["norm"]["bias"]


def _without_the_rounding_after_the_bias(x, wk2, bias, g, b):
    """K19's plain version with the bias added in f32 to the rounded
    product and not rounded again: what XLA's CPU compiler makes of the
    interpreted kernel, which keeps the fused sum in f32."""
    cdt = x.dtype
    y = up((up(k19.patchify_flat(x, 4, 3)) @ up(wk2)).to(cdt)) + up(bias.to(cdt))
    yc = y - y.mean(dim=-1, keepdim=True)
    yn = yc * torch.rsqrt((yc * yc).mean(dim=-1, keepdim=True) + 1e-5)
    return (yn * up(g.to(cdt)) + up(b.to(cdt))).to(cdt)


@pytest.mark.parametrize("bias_std", [0.0, 0.02])
def test_k19_plain_version_matches_the_pallas_kernel_bf16(bias_std):
    """Zero projection bias (flax's initialisation): bit-equal to the
    interpreted kernel.  A non-zero bias: the interpreted kernel skips the
    rounding of (rounded product + bias), which the kernel's source and the
    port make; the two then differ in about 30 % of the outputs by an ulp,
    and the port without that one rounding is the interpreted kernel bit for
    bit.  The XLA form (the LayerNorm's scale and bias in f32) misses."""
    x, wk2, bias, g, b = _k19_inputs(42, bias_std)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk2, jnp.bfloat16)
    want = np.asarray(pallas_patch.pallas_patch_embed(
        jx, jw, *(jnp.asarray(a) for a in (bias, g, b)), 4, 3, interpret=True), np.float32)
    args = (torch.from_numpy(x).to(BF16), torch.from_numpy(wk2).to(BF16),
            *(torch.from_numpy(a) for a in (bias, g, b)))
    got = k19.patch_embed(*args, 4, 3)
    assert got.dtype == BF16 and got.shape == (2, 4, 6, 128)
    got = got.float().numpy()
    xla_form = k19.patch_embed_reference(*args, 4, 3, round_ln=False).float().numpy()
    share, xla_share = float((got != want).mean()), float((xla_form != want).mean())
    print(f"bias std {bias_std}: differing outputs {share:.4f}, the XLA form's {xla_share:.4f}")
    if bias_std == 0.0:
        assert share == 0.0
    else:
        fused = _without_the_rounding_after_the_bias(*args).float().numpy()
        np.testing.assert_array_equal(fused, want)
        assert 0.0 < share < XLA_FORM_SHARE * 2
    assert xla_share > XLA_FORM_SHARE
    assert k19.KERNEL.launches == 0


def test_k19_gradient_matches_jax_vjp(monkeypatch):
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    x, wk2, bias, g, b = _k19_inputs(43, 0.02)
    cot = np.random.RandomState(44).randn(2, 4, 6, 128).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: pallas_patch.fused_patch_embed(*a, 4, 3),
                       *(jnp.asarray(a) for a in (x, wk2, bias, g, b)))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wk2, bias, g, b)]
    got = k19.patch_embed(*leaves, 4, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(cot))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tile", [(32, 32), (48, 64)])
def test_sliding_window_on_flat_rows_matches_jax(tile):
    """A linear stand-in for the model through both wrappers on flat rows:
    tile offsets and padding scaled by the channel factor, the flip of
    W-groups of 3."""
    h, w, k = 48, 64, 3
    rng = np.random.RandomState(45)
    mix = rng.randn(6, k).astype(np.float32)
    rgb, dte = (rng.randn(2, h, w * 3).astype(np.float32) for _ in range(2))

    def jfwd(r, d):
        x = jnp.concatenate([t.reshape(*t.shape[:2], -1, 3) for t in (r, d)], -1)
        return x[:, ::4, ::4] @ mix

    def tfwd(r, d):
        x = torch.cat([t.reshape(*t.shape[:2], -1, 3) for t in (r, d)], -1)
        return x[:, ::4, ::4] @ torch.from_numpy(mix)

    want = jax_sliding(jfwd, (h, w), tile, k, overlap=1 / 3, flip=True, fuse=True)(
        jnp.asarray(rgb), jnp.asarray(dte))
    got = make_sliding_window_fn(tfwd, (h, w), tile, k)(
        torch.from_numpy(rgb), torch.from_numpy(dte))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    nhwc = make_sliding_window_fn(lambda r, d: torch.cat([r, d], -1)[:, ::4, ::4]
                                  @ torch.from_numpy(mix), (h, w), tile, k)(
        torch.from_numpy(rgb).reshape(2, h, w, 3), torch.from_numpy(dte).reshape(2, h, w, 3))
    assert torch.equal(got, nhwc)


H, W = 64, 112  # as tests/test_torch_slice_r5.py: the rows DSCF at every level


@pytest.fixture(scope="module")
def tiny_model():
    rng = np.random.RandomState(46)
    rgb, dte = (rng.randn(2, H, W, 3).astype(np.float32) for _ in range(2))
    model = JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                      backbone_kwargs=dict(TINY, drop_path_rate=0.0),
                      head_dims=(32, 16), mmst_mask=False, upsample_logits=False)
    v = random_variables(model, 47, jnp.asarray(rgb), jnp.asarray(dte))
    return model, v, rgb, dte


def test_cmnext_flat_slice_with_the_patch_kernel_matches_jax(monkeypatch, tiny_model):
    for key, val in {**R5_ENV, "IR_ADS_PATCH_EMBED": "pallas"}.items():
        monkeypatch.setenv(key, val)
    model, v, rgb, dte = tiny_model
    flat = [a.reshape(2, H, W * 3) for a in (rgb, dte)]
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    want = np.asarray(jax_sliding(fwd, (H, W), (H, W), 5, overlap=1.0 / 3.0, flip=True,
                                  fuse=True)(*(jnp.asarray(a) for a in flat)))
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False, patch_embed="pallas").eval()
    assert {port.backbone.patch_embed.impl, port.backbone.extra_patch_embed.impl} == {"pallas"}
    port.load_state_dict(from_flax(v))
    predict = make_sliding_window_fn(lambda r, d: port(r, d)[0], (H, W), (H, W), 5)
    with torch.no_grad():
        got = predict(*(torch.from_numpy(a) for a in flat)).numpy()
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    assert k19.KERNEL.launches == 0


@pytest.mark.parametrize("impl", PATCH_EMBED)
def test_flax_weights_load_strictly_under_every_patch_embed(tiny_model, impl):
    _, v, _, _ = tiny_model
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16), patch_embed=impl)
    port.load_state_dict(from_flax(v), strict=True)


def test_predictor_serves_flat_frames():
    kw = dict(device="cpu", dtype=torch.float32, num_classes=5, image_size=(64, 80),
              backbone_kwargs=dict(TINY, depths=(1, 1, 1, 1)), head_dims=(32, 16))
    with pytest.raises(ValueError, match="flat_input"):
        SemSegPredictor(**kw, patch_embed="pallas")
    with pytest.raises(NotImplementedError):
        SemSegPredictor(**kw, flat_input=True, patch_embed="auto")
    with pytest.raises(ValueError, match="flat"):
        PatchEmbed(16, impl="pallas")(torch.zeros(1, 8, 8, 3))
    rng = np.random.RandomState(48)
    rgb, dep = (rng.randint(0, 256, (2, 64, 80, 3)).astype(np.uint8) for _ in range(2))
    nhwc, flat = SemSegPredictor(**kw), SemSegPredictor(**kw, flat_input=True)
    r, _ = flat.normalize(rgb, dep)
    assert r.shape == (2, 64, 240)
    want, got = nhwc(rgb, dep), flat(rgb, dep)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kernel = SemSegPredictor(**kw, flat_input=True, patch_embed="pallas")(rgb, dep)[0]
    assert kernel.shape == (2, 64, 80, 5)
    np.testing.assert_allclose(kernel.numpy(), want[0].numpy(), atol=1e-4, rtol=1e-4)

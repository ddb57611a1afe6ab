"""The port's opt-in Swin block variants against the JAX package, on the CPU:

  * ``SwinBlockAdapter`` under ``pallas7`` (K13), ``pallas5`` (K14, then K2)
    and ``pallas_map`` (the module path with K15, then K2) against the JAX
    block with ``IR_ADS_SWIN_ATTN`` set to the same, ``IR_ADS_FFN=fused`` and
    ``IR_ADS_PALLAS_INTERPRET=1``, aligned and padded maps, shifted and not;
  * the tiny CMNeXt sliding-window slice under the ``v7_01``, ``v5`` and
    ``map`` dispatches against JAX with the environment each stands for
    (``dev/sweep_env.py``'s v7_01 on r5; r4 with pallas5; r2 with
    pallas_map), f32, atol 2e-3 / rtol 1e-3, as
    tests/test_torch_module_path.py holds r2.  The frames are 64x112, where
    every DSCF level has n = 8 offsets a field, so the rows path (K3 + K4)
    runs on both sides.

The Pallas v3 wrapper reads no environment and is interpreted by a
monkeypatch, as tests/test_torch_module_path.py does for v2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ir_ads_tpu.ops.pallas_swin as pallas_swin
from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables

H, W = 64, 112  # n = 2 x 4 at every DSCF level


@pytest.fixture
def interpret_v3(monkeypatch):
    """The Pallas v3 wrapper reads no environment: interpret it by hand."""
    orig = pallas_swin.pallas_window_attention_map
    monkeypatch.setattr(pallas_swin, "pallas_window_attention_map",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


BLOCK_CASES = [(8, 8, False, "rgb"), (8, 8, True, "dte"), (7, 10, True, "rgb")]


@pytest.mark.parametrize("attn_impl", ["pallas7", "pallas5", "pallas_map"])
@pytest.mark.parametrize("h,w,shifted,sub_mode", BLOCK_CASES)
def test_block_variant_matches_jax(interpret_v3, monkeypatch, attn_impl, h, w, shifted,
                                   sub_mode):
    monkeypatch.setenv("IR_ADS_SWIN_ATTN", attn_impl)
    monkeypatch.setenv("IR_ADS_FFN", "fused")
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    x = np.random.RandomState(40).randn(2, h, w, 32).astype(np.float32)
    blk = jswin.SwinBlockAdapter(dim=32, num_heads=2, ffn_dim=128, window_size=4,
                                 shift=shifted)
    v = random_variables(blk, 41, jnp.asarray(x), sub_mode, True)
    want = blk.apply(v, jnp.asarray(x), sub_mode, True)
    port = tswin.SwinBlockAdapter(32, 2, 128, 4, shift=shifted, attn_impl=attn_impl)
    missing, unexpected = port.load_state_dict(from_flax(v), strict=False)
    other = "MLP_DTE_Adapter" if sub_mode == "rgb" else "MLP_RGB_Adapter"
    assert not unexpected and all(k.startswith(other) for k in missing)
    with torch.no_grad():
        got = port(torch.from_numpy(x), sub_mode).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-5)


VARIANT_ENV = {  # the JAX package's environment each dispatch stands for
    "v7_01": {"IR_ADS_SWIN_ATTN": "pallas7,pallas7,pallas6,pallas6",
              "IR_ADS_DSCF_ATTN": "pallas3,pallas3,pallas3,xla", "IR_ADS_DSCF_RPE3": "pallas"},
    "v5": {"IR_ADS_SWIN_ATTN": "pallas5", "IR_ADS_DSCF_ATTN": "pallas3",
           "IR_ADS_DSCF_RPE3": "pallas"},
    "map": {"IR_ADS_SWIN_ATTN": "pallas_map", "IR_ADS_DSCF_ATTN": "pallas3"},
}


def _jax_model():
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                     backbone_kwargs=dict(TINY, drop_path_rate=0.0),
                     head_dims=(32, 16), mmst_mask=False, upsample_logits=False)


@pytest.fixture(scope="module")
def slice_inputs():
    """Frames and weights, shared by the dispatches: the parameter tree is
    the same under every kernel configuration."""
    rng = np.random.RandomState(42)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    return rgb, dte, random_variables(_jax_model(), 43, jnp.asarray(rgb), jnp.asarray(dte))


@pytest.mark.parametrize("dispatch", ["v7_01", "v5", "map"])
def test_sliding_window_slice_matches_jax_block_variant(interpret_v3, monkeypatch, slice_inputs,
                                                        dispatch):
    for k, v in {**VARIANT_ENV[dispatch], "IR_ADS_FFN": "fused",
                 "IR_ADS_PALLAS_INTERPRET": "1"}.items():
        monkeypatch.setenv(k, v)
    rgb, dte, v = slice_inputs
    model = _jax_model()
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    want = np.asarray(jax_sliding(fwd, (H, W), (H, W), 5, overlap=1.0 / 3.0, flip=True,
                                  fuse=True)(jnp.asarray(rgb), jnp.asarray(dte)))

    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False, dispatch=dispatch).eval()
    port.load_state_dict(from_flax(v), strict=True)
    blocks = [s.blocks[0].attn_impl for s in port.backbone.stages]
    assert blocks == list(tswin.DISPATCH[dispatch][0])
    dscf = [m.deform_atten for m in port.backbone.DeformMPGBlocks]
    assert [d.rows_path(8) for d in dscf] == [a == "pallas3" for a in tswin.DISPATCH[dispatch][1]]
    predict = make_sliding_window_fn(lambda r, d: port(r, d)[0], (H, W), (H, W), 5)
    with torch.no_grad():
        got = predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)

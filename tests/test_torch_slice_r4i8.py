"""The tiny CMNeXt sliding-window slice under the w8a8 ``r4i8`` dispatch on
both sides: the JAX package under its bench's r4i8 environment
(bench.py:144-155: v4 half-block and fused tail everywhere, rows DSCF at
every level, packed attention layout, IR_ADS_INT8=1), its Pallas kernels in
interpret mode, against the port's ``dispatch="r4i8"``, which runs K10's
and K11's plain versions and the ``ops.int8`` products on the CPU, from
weights that ``from_flax`` carried over and ``quantize_int8_`` quantized.

f32 on both sides.  The bar is the r5 slice's (atol 2e-3 / rtol 1e-3) and
a second one that a float model cannot pass: the port's distance from JAX
r4i8 must be at least 10x smaller than JAX r4i8's distance from JAX's float
r4 on the same weights and frames (measured: 1.8e-2 against 2.2e-1 in norm;
w8a8 is chaotic in depth, since a code flipped by an f32 ulp in one block
moves the next block's per-row scales, so the distance grows block by
block where the float slice ends 3.3e-6 from JAX).
"""

import jax.numpy as jnp
import numpy as np
import torch

from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.ops.pallas_mlp import quantize_weight as jax_quantize_weight
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops.int8 import PREFIX, quantize_int8_
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import H, TINY, W, random_variables

R4I8_ENV = {
    "IR_ADS_SWIN_ATTN": "pallas4",
    "IR_ADS_DSCF_ATTN": "pallas3",
    "IR_ADS_FFN": "fused",
    "IR_ADS_SWIN_PACKED": "1",
    "IR_ADS_INT8": "1",
    "IR_ADS_PALLAS_INTERPRET": "1",
}


def _jax_model():
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                     backbone_kwargs=dict(TINY, drop_path_rate=0.0), head_dims=(32, 16),
                     mmst_mask=False, upsample_logits=False)


def _port_r4i8(variables):
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False, dispatch="r4i8").eval()
    port.load_state_dict(from_flax(variables), strict=True)
    assert quantize_int8_(port) == sum(TINY["depths"]) + 4 + 3  # blocks, DSCF levels, heads
    return port


def test_from_flax_carries_an_int8_model_and_quantizes_as_the_reference(monkeypatch):
    """QuantDense / QuantConv keep nn.Dense / nn.Conv's parameter trees, so
    an int8 model's variables load strictly; the s8 buffers are not in the
    state_dict and are the reference's codes of the f32 weights."""
    for k, v in R4I8_ENV.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(20)
    rgb = jnp.asarray(rng.randn(1, H, W, 3).astype(np.float32))
    v = random_variables(_jax_model(), 21, rgb, rgb)
    port = _port_r4i8(v)
    assert not any(PREFIX in k for k in port.state_dict())
    p = v["params"]["backbone"]
    blk = port.backbone.stages[0].blocks[0]
    jblk = p["stages_0"]["blocks_0"]
    for name, kernel in (("qkv", jblk["attn"]["w_msa"]["qkv"]["kernel"]),
                         ("fc2", jblk["ffn"]["Dense_1"]["kernel"])):
        q, s = jax_quantize_weight(jnp.asarray(kernel))
        np.testing.assert_array_equal(getattr(blk, PREFIX + name).numpy(), np.asarray(q).T)
        np.testing.assert_array_equal(getattr(blk, PREFIX + name + "_scale").numpy(),
                                      np.asarray(s)[0])
    dm = port.backbone.DeformMPGBlocks[1].deform_atten
    jk = np.asarray(p["deform_mpg_1"]["deform_atten"]["proj_k"]["kernel"])[0, 0]  # (in, out)
    s = np.maximum(np.abs(jk).max(axis=0) / np.float32(127.0), np.float32(1e-12))
    np.testing.assert_array_equal(getattr(dm, PREFIX + "proj_k_scale").numpy(), s)
    assert getattr(dm, PREFIX + "fuse_q").shape == dm.fuse_q.conv[0].weight.shape


def _logits(forward, rgb, dte, framework):
    if framework == "jax":
        return np.asarray(jax_sliding(forward, (H, W), (H, W), 5, overlap=1.0 / 3.0,
                                      flip=True, fuse=True)(jnp.asarray(rgb), jnp.asarray(dte)))
    predict = make_sliding_window_fn(forward, (H, W), (H, W), 5)
    with torch.no_grad():
        return predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()


def test_sliding_window_slice_matches_jax_r4i8(monkeypatch):
    for k, v in R4I8_ENV.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(22)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    model = _jax_model()
    v = random_variables(model, 23, jnp.asarray(rgb), jnp.asarray(dte))
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    want = _logits(fwd, rgb, dte, "jax")
    monkeypatch.setenv("IR_ADS_INT8", "0")
    floated = _logits(fwd, rgb, dte, "jax")  # the same model, JAX's float r4

    port = _port_r4i8(v)
    got = _logits(lambda r, d: port(r, d)[0], rgb, dte, "torch")
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    dist, int8_vs_float = np.linalg.norm(got - want), np.linalg.norm(want - floated)
    print(f"|port - jax r4i8| {dist:.3e}, |jax r4i8 - jax r4| {int8_vs_float:.3e}")
    assert 10 * dist <= int8_vs_float

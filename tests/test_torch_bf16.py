"""The port in bf16 against the JAX package's ``dtype=jnp.bfloat16`` models,
on the CPU, and the DSCF dispatch's 2n % 8 guard.

flax computes LayerNorm, BatchNorm and GroupNorm in f32 with f32 scale,
bias and statistics and rounds once (``flax.linen.normalization.
_normalize``), and the SegFormer head composes its per-level projection with
the fuse conv from f32 parameters before one cast.  The port keeps those
parameters f32 (``serve.cast_model_``) and computes as flax does
(``ops.layers``).  BN running means are drawn around +-3, as trained ones
can be, where rounding them to bf16 moves the output most.  Measured on this
file's inputs, the tiny CMNeXt under r5 at 64x112 lies 5.390e-3 from JAX
bf16 (jitted) with every parameter rounded (the earlier rule), 3.180e-3
with flax's rule (bar 4.2e-3) and 1.355e-3 once every flax Dense and Conv
site also adds its bias to the rounded product (``ops.layers.with_bias``);
from JAX f32, 4.523e-3, 2.290e-3 and 2.482e-3, where JAX bf16 lies 2.662e-3
from it (bar 1.25x that).  The detector's test is
tests/test_torch_det_bf16.py.

The DSCF guard: JAX runs its rows kernels (pallas3) only where the 2n
deformable keys are a multiple of 8 and takes the einsum branch with its
XLA-form bias elsewhere; so does the port.  On identical bf16 q, k, v and
offsets the port's einsum branch is bit-equal to JAX's, with the XLA-form
bias and with the packed kernel's (K6's plain version, which rounds the hat
weights, the table and the partial product as the Pallas kernel does),
while the rows path differs by about 2.8e-3 (4.0e-3 while K3 summed the
bias in f32 and rounded once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu_torch.detection.dino import DINODetector
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import layers
from ir_ads_tpu_torch.serve import cast_model_
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_det_model import TINY as DET_TINY
from test_torch_model import TINY, random_variables
from test_torch_slice_r5 import R5_ENV

BF16 = torch.bfloat16


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _means_at_3(variables, seed):
    """BN running means drawn around +-3."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.choice([-3.0, 3.0], a.shape) + 0.5 * rng.randn(*a.shape)).astype(
            np.float32) if p[-1].key == "mean" else a, variables)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("norm", ["layer", "batch", "group"])
def test_normalisations_round_once_as_flax(norm):
    rng = np.random.RandomState(70)
    x = _bf16_np(rng.randn(2, 6, 5, 64) * 2 + 1).copy()
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    mean = (3 * rng.randn(64)).astype(np.float32)
    var = (0.5 + rng.rand(64)).astype(np.float32)
    params = {"scale": scale, "bias": bias}
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)
    if norm == "layer":
        want = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply({"params": params}, jx)
        mod = nn_mod = torch.nn.LayerNorm(64, eps=1e-5)
        got_fn = lambda: layers.layer_norm(tx, mod)  # noqa: E731
    elif norm == "batch":
        want = nn.BatchNorm(use_running_average=True, epsilon=1e-5, dtype=jnp.bfloat16).apply(
            {"params": params, "batch_stats": {"mean": mean, "var": var}}, jx)
        nn_mod = layers.FlaxBatchNorm2d(64, eps=1e-5).eval()
        nn_mod.running_mean.copy_(torch.from_numpy(mean))
        nn_mod.running_var.copy_(torch.from_numpy(var))
        got_fn = lambda: nn_mod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # noqa: E731
    else:
        want = nn.GroupNorm(num_groups=32, epsilon=1e-6, dtype=jnp.bfloat16).apply(
            {"params": params}, jx)
        nn_mod = layers.GroupNorm(32, 64, eps=1e-6)
        got_fn = lambda: nn_mod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # noqa: E731
    with torch.no_grad():
        nn_mod.weight.copy_(torch.from_numpy(scale))
        nn_mod.bias.copy_(torch.from_numpy(bias))
        got = got_fn()
    assert got.dtype == BF16
    # one rounding of the same f32 value: equal but where the f32 values sit
    # an ulp apart across a bf16 rounding boundary
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert (diff > 0).mean() < 0.01 and diff.max() <= 2 ** -7 * np.abs(want).max()


def test_cast_model_keeps_what_flax_keeps_in_f32():
    model = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16))
    cast_model_(model, BF16)
    bb, head = model.backbone, model.decode_head
    f32 = {"norm": bb.stages[0].blocks[0].norm1.weight,
           "bn stats": bb.DeformMPGBlocks[0].deform_atten.fuse_q.conv[1].running_mean,
           "head proj": head.linear_c2.proj.weight, "head fuse": head.linear_fuse.conv.weight,
           "head bn": head.linear_fuse.bn.bias,
           "bias table": bb.stages[0].blocks[0].attn.w_msa.relative_position_bias_table,
           "rpe table": bb.DeformMPGBlocks[0].deform_atten.rpe_table}
    rounded = {"qkv": bb.stages[0].blocks[0].attn.w_msa.qkv.weight,
               "pred": head.linear_pred.weight, "tfts": bb.MPGBlocks[0].tfts_gamma_rgb,
               "deform weight": bb.DeformMPGBlocks[0].deform_atten.deform_weight}
    assert {k: t.dtype for k, t in f32.items()} == dict.fromkeys(f32, torch.float32)
    assert {k: t.dtype for k, t in rounded.items()} == dict.fromkeys(rounded, BF16)
    det = DINODetector(**DET_TINY)
    cast_model_(det, BF16)
    assert det.backbone.stem.conv1.norm.running_mean.dtype == torch.float32
    assert det.neck.convs[0].gn.weight.dtype == torch.float32
    assert det.transformer.enc_output_norm.weight.dtype == torch.float32
    assert det.pixel_mean.dtype == torch.float32
    assert det.class_embed[0].weight.dtype == BF16
    assert det.transformer.level_embeds.dtype == BF16


def test_cmnext_bf16_matches_jax_bf16_r5(monkeypatch):
    for k, v in R5_ENV.items():
        monkeypatch.setenv(k, v)
    h, w = 64, 112
    rng = np.random.RandomState(50)
    rgb, dte = (rng.randn(2, h, w, 3).astype(np.float32) for _ in range(2))
    kw = dict(backbone="SwinTransformer-B", num_classes=5, head_dims=(32, 16),
              backbone_kwargs=dict(TINY, drop_path_rate=0.0), mmst_mask=False,
              upsample_logits=False)
    m32, m16 = JaxCMNeXt(**kw), JaxCMNeXt(**kw, dtype=jnp.bfloat16)
    v = _means_at_3(random_variables(m32, 51, jnp.asarray(rgb), jnp.asarray(dte)), 52)
    want32, want16 = (
        jax.jit(lambda vv, a, b, m=m: m.apply(vv, a, b, train=False)[0])(
            v, jnp.asarray(rgb, dt), jnp.asarray(dte, dt))
        for m, dt in ((m32, jnp.float32), (m16, jnp.bfloat16)))
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False).eval()
    port.load_state_dict(from_flax(v))
    cast_model_(port, BF16)
    with torch.no_grad():
        got = port(torch.from_numpy(rgb).to(BF16), torch.from_numpy(dte).to(BF16))[0]
    assert got.dtype == BF16
    got = got.float().numpy()
    print(f"port vs JAX bf16 {_rel(got, want16):.3e}, vs JAX f32 {_rel(got, want32):.3e}; "
          f"JAX bf16 vs f32 {_rel(want16, want32):.3e}")
    assert _rel(got, want16) <= 4.2e-3
    assert _rel(got, want32) <= 1.25 * _rel(want16, want32)


@pytest.mark.parametrize("rpe3", ["xla", "pallas"])
def test_dscf_takes_the_einsum_branch_where_2n_is_not_a_multiple_of_8(monkeypatch, rpe3):
    """8x12 at stride 4: n = 2 x 3 offsets a field, 2n = 12.  JAX's pallas3
    falls back to its einsum branch with the bias from ``IR_ADS_DSCF_RPE3``;
    the port's pallas3 does the same, f32."""
    monkeypatch.setenv("IR_ADS_DSCF_RPE3", rpe3)
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(62)
    x, y = (rng.randn(2, 8, 12, 32).astype(np.float32) for _ in range(2))
    mod = jswin.DAttentionMM(dim=32, n_heads=4, n_groups=2, stride=4, attn_impl="pallas3")
    v = random_variables(mod, 63, jnp.asarray(x), jnp.asarray(y))
    v["params"]["rpe_table"] = v["params"]["rpe_table"] * 20
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(y), False)
    port = tswin.DAttentionMM(32, 4, 2, 4, rpe3=rpe3).eval()
    port.load_state_dict(from_flax(v))
    assert port.attn_impl == "pallas3" and not port.rows_path(6) and port.rows_path(8)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)


def _dscf_cores(monkeypatch, rpe3):
    """bf16, n = 6: the attention core (what enters proj_out) on identical
    q, k, v and offsets, forced into both modules, with the einsum branch's
    bias in the XLA form (``rpe3="xla"``) or from the packed kernel (JAX's
    Pallas kernel in interpret mode, the port's K6 plain version).  Returns
    JAX's core and the port's as a function of whether it takes the rows
    path."""
    monkeypatch.setenv("IR_ADS_DSCF_RPE3", rpe3)
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(60)
    b, h, w, c, g = 2, 8, 12, 32, 2
    x, y = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    kw = dict(dim=c, n_heads=4, n_groups=g, stride=4, attn_impl="pallas3")
    v = random_variables(jswin.DAttentionMM(**kw), 61, jnp.asarray(x), jnp.asarray(y))
    v["params"]["rpe_table"] = v["params"]["rpe_table"] * 20
    n = 2 * 3
    forced = {"proj_q": _bf16_np(rng.randn(b, h, w, c)),
              "proj_k": _bf16_np(rng.randn(b, 2 * n, c)),
              "proj_v": _bf16_np(rng.randn(b, 2 * n, c)),
              "conv_offset_x": _bf16_np(0.3 * rng.randn(b * g, 2, 3, 2)),
              "conv_offset_y": _bf16_np(0.3 * rng.randn(b * g, 2, 3, 2))}
    core = {}

    def interceptor(next_fun, args, kwargs, context):
        name = context.module.name
        if context.method_name == "__call__" and name == "proj_out":
            core["jax"] = np.asarray(args[0], np.float32)
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and name in forced:
            assert out.shape == forced[name].shape, name
            return jnp.asarray(forced[name], out.dtype)
        return out

    with nn.intercept_methods(interceptor):
        jswin.DAttentionMM(**kw, dtype=jnp.bfloat16).apply(
            v, jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), False)

    class Fixed(torch.nn.Module):
        def __init__(self, a):
            super().__init__()
            self.a = torch.from_numpy(a).to(BF16).permute(0, 3, 1, 2)

        def forward(self, t):
            return self.a

    def port_core(rows):
        port = tswin.DAttentionMM(32, 4, 2, 4, rpe3=rpe3).eval()
        port.load_state_dict(from_flax(v))
        cast_model_(port, BF16)
        pointwise = port._pointwise
        port._pointwise = lambda name, conv, t: (  # noqa: E731
            torch.from_numpy(forced[name]).to(BF16) if name in forced else pointwise(name, conv, t))
        port.conv_offset_x = Fixed(forced["conv_offset_x"])
        port.conv_offset_y = Fixed(forced["conv_offset_y"])
        assert not port.rows_path(n) and port.bias_kernel(h, w) == (rpe3 == "pallas")
        port.rows_path = lambda n: rows
        seen = {}
        monkeypatch.setattr(tswin, "pointwise", lambda conv, t: (
            seen.setdefault("core", t.float().numpy()) if conv is port.proj_out else None,
            layers.pointwise(conv, t))[1])
        with torch.no_grad():
            port(torch.from_numpy(x).to(BF16), torch.from_numpy(y).to(BF16))
        return seen["core"]

    return core["jax"], port_core


def test_dscf_einsum_branch_is_jax_bf16_and_the_rows_path_is_not(monkeypatch):
    """The port's einsum branch with the XLA-form bias is JAX's bit for bit;
    the rows path (K3 + K4, which the port ran here before the guard)
    computes the bias in another layout and attends online, so it differs."""
    want, port_core = _dscf_cores(monkeypatch, "xla")
    np.testing.assert_array_equal(port_core(rows=False), want)
    rows = _rel(port_core(rows=True), want)
    print(f"the rows path against JAX's einsum branch: {rows:.3e}")
    assert rows > 1e-3


def test_dscf_einsum_branch_with_the_packed_bias_is_jax_bf16(monkeypatch):
    """``IR_ADS_DSCF_RPE3=pallas`` and ``rpe3="pallas"``: the bias from the
    packed kernel (JAX's ``_rpe_packed_kernel`` interpreted, the port's K6
    plain version), then the same einsum attention: bit for bit."""
    want, port_core = _dscf_cores(monkeypatch, "pallas")
    np.testing.assert_array_equal(port_core(rows=False), want)

"""Where the port adds a bias in bf16, bit for bit against the JAX module it
mirrors, on the CPU.

flax's ``nn.Dense`` and ``nn.Conv`` round the product to the compute dtype
and then add the bias (``y = dot(x, k); y += b``): two roundings, which
``ops.layers.with_bias`` reproduces.  One case per site that goes through
it, each with non-zero biases and numpy-seeded inputs and weights: the
port's helper or module against the flax layer or JAX module, in bf16,
with no output apart.  A form that adds the bias before its one rounding
(``F.linear(x, w, b)``) parts from every one of these in a share of the
outputs, which the failure message gives.

One case holds a site that rightly keeps one rounding: K1's plain version,
whose Pallas kernel adds the qkv and proj biases in f32 before rounding,
against the interpreted v4 kernel, with the attention made exact (the
region bias makes each window's softmax one-hot, the out projection is the
identity, LayerNorm's scale 0 makes its output its bias), so the two
meet bit for bit and a second rounding in either projection would show.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import dino as jdino
from ir_ads_tpu.detection import transformer as jtr
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.heads.segformer import SegFormerHead as JaxSegFormerHead
from ir_ads_tpu.ops.layers import PatchEmbed as JaxPatchEmbed
from ir_ads_tpu.ops.pallas_swin import pallas_window_block
from ir_ads_tpu_torch.detection import dino
from ir_ads_tpu_torch.detection import transformer as tr
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.heads.segformer import SegFormerHead
from ir_ads_tpu_torch.ops.layers import FlaxBatchNorm2d, PatchEmbed, conv2d, linear, pointwise
from ir_ads_tpu_torch.ops.swin_block import window_block
from ir_ads_tpu_torch.serve import cast_model_
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_det_modules import _load
from test_torch_model import random_variables

BF16 = torch.bfloat16


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(a):
    """(jax bf16, torch bf16) of the same rounded values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _bf16_model(mod):
    """``mod`` in bf16 as the predictors cast it (normalisations stay f32)."""
    cast_model_(mod, BF16)
    return mod


def _params(variables):
    return {k: np.asarray(v) for k, v in variables["params"].items()}


def _dense_layer(kernel, bias):
    lin = torch.nn.Linear(*kernel.shape)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
    return lin


def _conv_layer(kernel, bias, **kw):
    kh, kw_, cin_g, cout = kernel.shape
    conv = torch.nn.Conv2d(cin_g * kw.get("groups", 1), cout, (kh, kw_), **kw)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
    return conv


def _flax_layer(jmod, x, seed):
    """A flax layer's output on bf16 x and its (kernel, bias) as numpy."""
    jx, _ = _pair(x)
    variables = random_variables(jmod, seed, jx)
    p = _params(variables)
    return jmod.apply(variables, jx), p["kernel"], p["bias"]


def case_linear():
    """ops.layers.linear: the Swin module path's qkv and proj, the FFN, the
    adapters, MPG and the DSCF's D_fc / U_fc, as nn.Dense."""
    x = _x(60, 4, 9, 32)
    want, k, b = _flax_layer(fnn.Dense(48, dtype=jnp.bfloat16), x, 60)
    return linear(_pair(x)[1], _dense_layer(k, b)), want


def case_pointwise():
    """ops.layers.pointwise: DAttentionMM's 1x1 convolutions (proj_q,
    sample_weight, proj_k, proj_v, proj_out), as nn.Conv((1, 1))."""
    x = _x(61, 2, 5, 7, 32)
    want, k, b = _flax_layer(fnn.Conv(24, (1, 1), dtype=jnp.bfloat16), x, 61)
    return pointwise(_conv_layer(k, b), _pair(x)[1]), want


def case_conv_3x3():
    """ops.layers.conv2d, 3x3: DAttentionMM's fuse_q conv."""
    x = _x(62, 2, 6, 8, 16)
    want, k, b = _flax_layer(fnn.Conv(8, (3, 3), padding=1, dtype=jnp.bfloat16), x, 62)
    got = conv2d(_pair(x)[1].permute(0, 3, 1, 2), _conv_layer(k, b, padding=1))
    return got.permute(0, 2, 3, 1), want


def case_conv_depthwise():
    """ops.layers.conv2d, depthwise and strided: the DSCF offset heads'
    ``dw`` conv."""
    x = _x(63, 2, 10, 12, 8)
    jmod = fnn.Conv(8, (5, 5), strides=(2, 2), padding=2, feature_group_count=8,
                    dtype=jnp.bfloat16)
    want, k, b = _flax_layer(jmod, x, 63)
    conv = _conv_layer(k, b, stride=2, padding=2, groups=8)
    return conv2d(_pair(x)[1].permute(0, 3, 1, 2), conv).permute(0, 2, 3, 1), want


def case_patch_embed():
    """PatchEmbed's xla path (``xp @ wk2 + bias`` in the reference), NHWC."""
    x = _x(64, 2, 16, 24, 3)
    jx, tx = _pair(x)
    jmod = JaxPatchEmbed(32, dtype=jnp.bfloat16)
    variables = random_variables(jmod, 64, jx)
    pe = PatchEmbed(32)
    pe.load_state_dict({k.replace("proj.", "projection."): v
                        for k, v in from_flax(variables).items()})
    return pe(tx), jmod.apply(variables, jx)


def case_adapter():
    """The Swin block's adapter (D_fc1, relu, D_fc2) in its module form."""
    x = _x(65, 2, 5, 6, 64)
    jx, tx = _pair(x)
    jmod = jswin.Adapter(skip_connect=False, drop=0.0, dtype=jnp.bfloat16)
    variables = random_variables(jmod, 65, jx)
    port = tswin.Adapter(64)
    port.load_state_dict(from_flax(variables))
    return port(tx), jmod.apply(variables, jx)


def case_mpg():
    """MPGBlock: D_fc1, D_fc2, P_fc2, U_fc1 and the TFTS affine."""
    xr, xd = _x(66, 2, 4, 5, 64), _x(67, 2, 4, 5, 64)
    (jr, tr_), (jd, td) = _pair(xr), _pair(xd)
    jmod = jswin.MPGBlock(dtype=jnp.bfloat16)
    variables = random_variables(jmod, 66, jr, jd)
    port = tswin.MPGBlock(64)
    port.load_state_dict(from_flax(variables))
    return torch.cat(port(tr_, td), -1), jnp.concatenate(jmod.apply(variables, jr, jd), -1)


def case_segformer():
    """SegFormerHead on one level: the composed projection (``feat @ wc +
    bc``), BatchNorm, relu and linear_pred (nn.Conv)."""
    x = _x(68, 2, 6, 8, 32)
    jx, tx = _pair(x)
    jmod = JaxSegFormerHead(embed_dim=32, num_classes=5, dtype=jnp.bfloat16)
    variables = random_variables(jmod, 68, [jx])
    head = SegFormerHead([32], 32, 5).eval()
    sd = from_flax({c: {"decode_head": v} for c, v in variables.items()})
    head.load_state_dict({k[len("decode_head."):]: v for k, v in sd.items()})
    return head([tx]), jmod.apply(variables, [jx])


def case_det_mlp():
    """The detector's ``dense`` (msdeform_attn.dense), through its MLP."""
    x = _x(69, 2, 7, 64)
    jx, tx = _pair(x)
    jmod = jtr.MLP(64, 48, 3, dtype=jnp.bfloat16)
    variables = random_variables(jmod, 69, jx)
    mod = _bf16_model(_load(tr.MLP(64, 64, 48, 3), variables, ("transformer", "bbox_embed_0")))
    return mod(tx), jmod.apply(variables, jx)


def case_det_attention():
    """The detector's MultiheadAttention: its q / k / v projections and
    out_proj; one query and one key, so the softmax is exactly 1."""
    x = _x(70, 3, 1, 64)
    jx, tx = _pair(x)
    jmod = jtr.MultiheadAttention(64, 8, dtype=jnp.bfloat16)
    variables = random_variables(jmod, 70, jx)
    mod = _bf16_model(_load(tr.MultiheadAttention(64, 8), variables,
                            ("transformer", "decoder_0", "self_attn")))
    return mod(tx), jmod.apply(variables, jx)


def case_det_channel_mapper():
    """The detector's ChannelMapper: a 1x1 conv and a stride-2 3x3 conv,
    each followed by GroupNorm."""
    x = _x(71, 1, 8, 10, 48)
    jx, tx = _pair(x)
    jmod = jdino.ChannelMapper(out_channels=32, num_outs=2, dtype=jnp.bfloat16)
    variables = random_variables(jmod, 71, [jx])
    mod = _bf16_model(_load(dino.ChannelMapper([48], 32, 2), variables, ("neck",)))
    got, want = mod([tx]), jmod.apply(variables, [jx])
    return torch.cat([g.flatten() for g in got]), jnp.concatenate([w.reshape(-1) for w in want])


class _FlaxSegMap(fnn.Module):
    """The reference detector's seg map (jdino.DINODetector, seg_map_*)."""

    @fnn.compact
    def __call__(self, seg):
        c = seg.shape[-1]
        m = fnn.Conv(2 * c, (3, 3), padding=1, dtype=jnp.bfloat16, name="seg_map_conv1")(seg)
        m = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                          dtype=jnp.bfloat16, name="seg_map_bn")(m)
        return fnn.Conv(c, (3, 3), padding=1, dtype=jnp.bfloat16,
                        name="seg_map_conv2")(fnn.relu(m))


def case_det_seg_map():
    """The detector's fused-FPN seg map: conv, BatchNorm, relu, conv."""
    x = _x(72, 1, 6, 8, 16)
    jx, tx = _pair(x)
    jmod = _FlaxSegMap()
    variables = random_variables(jmod, 72, jx)
    p, st = variables["params"], variables["batch_stats"]["seg_map_bn"]
    c1 = _conv_layer(np.asarray(p["seg_map_conv1"]["kernel"]),
                     np.asarray(p["seg_map_conv1"]["bias"]), padding=1)
    c2 = _conv_layer(np.asarray(p["seg_map_conv2"]["kernel"]),
                     np.asarray(p["seg_map_conv2"]["bias"]), padding=1)
    bn = FlaxBatchNorm2d(32, eps=1e-5).eval()
    with torch.no_grad():
        for name, arr in (("weight", p["seg_map_bn"]["scale"]), ("bias", p["seg_map_bn"]["bias"]),
                          ("running_mean", st["mean"]), ("running_var", st["var"])):
            getattr(bn, name).copy_(torch.from_numpy(np.asarray(arr)))
    m = _bf16_model(torch.nn.Sequential(c1, bn, torch.nn.ReLU(), c2))
    got = dino.seg_map(m, tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return got, jmod.apply(variables, jx)


def case_k1_keeps_one_rounding():
    """K1's plain version against the interpreted v4 kernel: the kernel adds
    the qkv and proj biases in f32 before one rounding, and so does the port
    (``swin_block.window_block_reference``).  The window attention is made
    exact: each token's region bias is 0 on itself and -1e4 elsewhere (a
    one-hot softmax: the output is v), the out projection is the identity,
    and LayerNorm's scale 0 leaves its bias."""
    ws, c, heads, b, hp, wp = 4, 32, 2, 2, 8, 8
    rng = np.random.RandomState(73)
    x = rng.randn(b, hp, wp, c).astype(np.float32)
    p = [np.zeros(c, np.float32), rng.randn(c).astype(np.float32),
         (rng.randn(c, 3 * c) * c ** -0.5).astype(np.float32),
         (0.5 * rng.randn(3 * c)).astype(np.float32),
         np.eye(c, dtype=np.float32), (0.5 * rng.randn(c)).astype(np.float32)]
    n = ws * ws
    bias = np.where(np.eye(n, dtype=bool), 0.0, -1e4).astype(np.float32)
    bias = np.broadcast_to(bias, (heads, n, n)).copy()
    scale = (c // heads) ** -0.5
    jx, tx = _pair(x)
    jp_tp = [_pair(a) for a in p]
    want = pallas_window_block(jx, *[j for j, _ in jp_tp], jnp.asarray(bias), None, scale,
                               heads, ws, interpret=True, h_real=hp, w_real=wp, shift=0)
    tp = [t.t() if t.ndim == 2 else t for _, t in jp_tp]
    got = window_block(tx, *tp, torch.from_numpy(bias), None, scale, heads, ws,
                       h_real=hp, w_real=wp, shift=0)
    return got, want


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("site", sorted(CASES))
def test_bias_is_added_where_the_reference_adds_it(site):
    with torch.no_grad():
        got, want = CASES[site]()
    assert got.dtype == BF16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    differ = float((got != want).mean())
    assert differ == 0.0, f"{site}: {differ:.4f} of the outputs apart from JAX"

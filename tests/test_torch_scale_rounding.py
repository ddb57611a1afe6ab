"""The attention scale rounded to bf16 as the reference rounds it, on the CPU
in bf16, at 32 channels a head (Swin-B's at every stage, the detector's
256 / 8).

JAX multiplies a bf16 ``q`` by a Python float as ``(q * scale)``: the weakly
typed scalar is cast to bf16 first, so 32 ** -0.5 = 0.17678 becomes
0.17676, and 2.5 % of the products ``bf16(q * scale)`` land one ulp away
from ``bf16(q * f32(scale))``.  The port takes every forward attention's
scale through ``ops.layers.q_scale`` (K1, K5, K10, K12-K17, the module
path's ``window_attention`` and the detector's ``MultiheadAttention``).  At
16 channels a head (scale 0.25, exact in bf16; the tiny test configs) the
two forms agree, which is why the earlier tests could not see it.

Each case holds the port's plain version against the JAX function: K12's
and the module path's bit for bit; K1's (qkv and projection products
around the attention) and the detector's (JAX's einsums) to a share of
differing outputs under ``SUM_ORDER_SHARE``, since an f32 sum of another
order can flip a bf16 rounding.  The parent's form (the f32 scale:
``q_scale`` replaced by the identity) must miss by over ``PARENT_SHARE``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ir_ads_tpu.detection import transformer as jtr
from ir_ads_tpu.ops import pallas_swin
from ir_ads_tpu.ops.window_attention import window_attention as jax_window_attention
from ir_ads_tpu_torch.detection import transformer as tr
from ir_ads_tpu_torch.ops import swin_block, window_attention, window_attention_map
from ir_ads_tpu_torch.ops import window_attention_qkv
from ir_ads_tpu_torch.serve import cast_model_
from test_torch_det_modules import _load
from test_torch_model import random_variables

BF16 = torch.bfloat16
SUM_ORDER_SHARE = 0.005  # measured: 0.0011 (K1), 0.0007 (the detector)
PARENT_SHARE = 0.05  # the f32-scale form: 8-11 % of the outputs differ
WS, HEADS, D, HP, WP, IMAGES = 4, 2, 32, 8, 12, 2  # 32 channels a head
SCALE = D ** -0.5


def _bf16(a):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(np.ascontiguousarray(a)).to(BF16))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _k12(rng):
    n, c, nw = WS * WS, HEADS * D, (HP // WS) * (WP // WS)
    qkv = rng.randn(IMAGES * nw, n, 3 * c).astype(np.float32)
    bias = rng.randn(HEADS, n, n).astype(np.float32)
    region = pallas_swin.shift_region_ids(HP, WP, WS, WS // 2)
    jq, tq = _bf16(qkv)
    want = pallas_swin.pallas_window_attention_qkv(jq, jnp.asarray(bias), jnp.asarray(region),
                                                   SCALE, HEADS, interpret=True)
    return want, lambda: window_attention_qkv.window_attention_qkv_reference(
        tq, _t(bias), _t(region), SCALE, HEADS)


def _k1(rng):
    c, h_real, w_real, shift = HEADS * D, 7, 10, 2
    x = rng.randn(IMAGES, HP, WP, c).astype(np.float32)
    p = [1.0 + 0.05 * rng.randn(c), 0.05 * rng.randn(c), rng.randn(c, 3 * c) * c ** -0.5,
         0.02 * rng.randn(3 * c), rng.randn(c, c) * c ** -0.5, 0.02 * rng.randn(c)]
    bias = rng.randn(HEADS, WS * WS, WS * WS).astype(np.float32)
    region = pallas_swin.shift_region_ids(HP, WP, WS, shift)
    geo = dict(h_real=h_real, w_real=w_real, shift=shift)
    (jx, tx), pairs = _bf16(x), [_bf16(a.astype(np.float32)) for a in p]
    want = pallas_swin.pallas_window_block(jx, *[j for j, _ in pairs], jnp.asarray(bias),
                                           jnp.asarray(region), SCALE, HEADS, WS,
                                           interpret=True, **geo)
    tp = [t.t() if t.ndim == 2 else t for _, t in pairs]
    return want, lambda: swin_block.window_block_reference(
        tx, *tp, _t(bias), _t(region), SCALE, HEADS, WS, **geo)


def _module_path(rng):
    n, nw = WS * WS, (HP // WS) * (WP // WS)
    q, k, v = (rng.randn(IMAGES * nw, HEADS, n, D).astype(np.float32) for _ in range(3))
    bias = rng.randn(HEADS, n, n).astype(np.float32)
    mask = window_attention.shift_window_mask(HP, WP, WS, WS // 2)
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = jax_window_attention(jq, jk, jv, jnp.asarray(bias), jnp.asarray(mask), SCALE)
    return want, lambda: window_attention.window_attention(tq, tk, tv, _t(bias), _t(mask),
                                                           SCALE)


def _detector_attention(rng):
    """The attention core of ``MultiheadAttention`` (what enters out_proj),
    embed 64, 2 heads of 32, 64 tokens.  The projections are the identity
    with zero bias, so that both sides' q, k and v are the same bf16 values
    (flax's Dense rounds the product and then the bias sum, PyTorch's linear
    once)."""
    x, qpos = ((0.5 * rng.randn(2, 64, 64)).astype(np.float32) for _ in range(2))
    jmod = jtr.MultiheadAttention(64, HEADS, dtype=jnp.bfloat16)
    shapes = random_variables(jmod, 25, jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.eye(a.shape[0], dtype=np.float32) if path[-1].key == "kernel"
                         else np.zeros_like(a)), shapes)
    core = {}

    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and context.module.name == "out_proj":
            core["jax"] = np.asarray(args[0], np.float32)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(intercept):
        jmod.apply(variables, jnp.asarray(x, jnp.bfloat16),
                   query_pos=jnp.asarray(qpos, jnp.bfloat16))
    mod = _load(tr.MultiheadAttention(64, HEADS), variables,
                ("transformer", "decoder_0", "self_attn"))
    cast_model_(mod, BF16)

    def port_core():
        seen = {}
        dense = tr.dense
        tr.dense = lambda t, lin: (seen.setdefault("core", t), dense(t, lin))[1]
        try:
            with torch.no_grad():
                mod(_t(x).to(BF16), query_pos=_t(qpos).to(BF16))
        finally:
            tr.dense = dense
        return seen["core"]

    return core["jax"], port_core


# case: (inputs and the two sides, the share of outputs that may differ)
CASES = {"k12": (_k12, 0.0), "k1": (_k1, SUM_ORDER_SHARE), "module_path": (_module_path, 0.0),
         "detector_attention": (_detector_attention, SUM_ORDER_SHARE)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_attention_scales_q_by_the_bf16_scale(case, monkeypatch):
    make, bar = CASES[case]
    want, run = make(np.random.RandomState(90))
    want = np.asarray(want, np.float32)
    got = run()
    assert got.dtype == BF16
    share = float((got.float().numpy() != want).mean())
    # the parent's form: the f32 scale everywhere
    for mod in (window_attention, window_attention_qkv, window_attention_map, swin_block, tr):
        monkeypatch.setattr(mod, "q_scale", lambda scale, dtype: float(scale))
    parent = float((run().float().numpy() != want).mean())
    print(f"{case}: differing outputs {share:.4f}, with the f32 scale {parent:.4f}")
    assert share <= bar
    assert parent > PARENT_SHARE


def test_q_scale_rounds_to_the_dtype():
    from ir_ads_tpu_torch.ops.layers import q_scale

    assert q_scale(32 ** -0.5, torch.bfloat16) == 0.1767578125
    assert q_scale(8 ** -0.5, torch.bfloat16) == 0.353515625
    assert q_scale(0.25, torch.bfloat16) == 0.25
    assert q_scale(32 ** -0.5, torch.float32) == float(np.float32(32 ** -0.5))
    assert float(jnp.asarray(1.0, jnp.bfloat16) * 32 ** -0.5) == 0.1767578125

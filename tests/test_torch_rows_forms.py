"""K4's two rounding forms against the JAX package's two rows kernels, on the
CPU in bf16.

The reference has two Pallas rows kernels (ir_ads_tpu/ops/pallas_dscf.py):
``_dscf_rows_kernel_packed`` normalises the probabilities, rounds them to
bf16 and multiplies with V; ``_dscf_rows_kernel`` rounds the unnormalised
``exp(s - max)``, sums P.V in f32 and divides after.  Its DAttentionMM takes
the packed one at levels 0-2 and the unpacked one at level 3
(``IR_ADS_DSCF_PACKED="1,1,1,0"``).  The two forms put about 40 % of the
bf16 outputs an ulp apart.

Each form of the port is its kernel's bit for bit, and the other form puts
over ``SHARE`` of the outputs an ulp away, at a scale exact in bf16 (0.25)
and at the model's, 8 ** -0.5 (8 channels a head): the reference multiplies
bf16 q by the scale rounded to bf16 (JAX casts a Python scalar to the
array's dtype), and so does the port (``ops.layers.q_scale``).  With the f32
scale 2.7 % of the rounded products ``bf16(q * scale)`` differ and about 6 %
of the outputs.

The inputs are those of a DSCF level: bg 2, an 8x16 plane, 2 heads of 8
channels, 48 keys, the bias from the interpreted rpe rows kernel on a table
of std 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.ops.pallas_dscf import pallas_dscf_attention_rows
from ir_ads_tpu.ops.pallas_dscf_rpe import dscf_rpe_bias_rows_pallas
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.ops import layers
from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_attention
from ir_ads_tpu_torch.serve import cast_model_
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import random_variables

SHARE = 0.15  # of outputs that may differ by one bf16 ulp; the wrong form: ~0.40
BF16 = torch.bfloat16


def _bf16_pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


@pytest.fixture(scope="module")
def rows_inputs():
    rng = np.random.RandomState(70)
    bg, h, w, hg, hc, m = 2, 8, 16, 2, 8, 48
    q, k, v = (rng.randn(bg, n, hg * hc).astype(np.float32) for n in (h * w, m, m))
    pos = rng.uniform(-1.0, 1.0, (bg, m, 2)).astype(np.float32)
    table = (3.0 * rng.randn(1, hg, 15, 31)).astype(np.float32)
    jb = dscf_rpe_bias_rows_pallas(jnp.asarray(pos), jnp.asarray(table), h, w,
                                   out_dtype=jnp.bfloat16, interpret=True)
    tb = torch.from_numpy(np.asarray(jb.astype(jnp.float32))).to(BF16)
    return [_bf16_pair(a) for a in (q, k, v)] + [(jb, tb)], hg


@pytest.mark.parametrize("scale", [0.25, 8 ** -0.5])
@pytest.mark.parametrize("packed", [True, False])
def test_rows_attention_bf16_rounds_as_the_kernel_of_its_form(rows_inputs, packed, scale):
    pairs, hg = rows_inputs
    jax_in, port_in = zip(*pairs)
    want = np.asarray(pallas_dscf_attention_rows(*jax_in, scale, hg, interpret=True,
                                                 packed=packed), np.float32)
    shares = {}
    for form in (packed, not packed):
        got = dscf_rows_attention(*port_in, scale, hg, form)
        assert got.dtype == BF16
        got = got.float().numpy()
        shares[form] = float((got != want).mean())
    print(f"packed={packed} scale {scale:.4f}: differing outputs, this form "
          f"{shares[packed]:.4f}, the other {shares[not packed]:.4f}")
    assert shares[packed] == 0.0
    assert SHARE < shares[not packed]


def test_dscf_level3_pallas3_bf16_rounds_as_jax(monkeypatch):
    """``DAttentionMM(level=3, attn_impl="pallas3")`` in bf16 against JAX's
    with ``IR_ADS_DSCF_ATTN=pallas3`` (interpreted), on identical q, k, v and
    offsets forced into both modules (n = 2 x 4): the attention core, what
    enters proj_out.  JAX runs the unpacked rows kernel at level 3; the port
    must too, bit for bit, and its packed form must fail."""
    monkeypatch.setenv("IR_ADS_DSCF_ATTN", "pallas3")
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(71)
    b, h, w, c, g = 2, 8, 16, 32, 2
    x, y = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    kw = dict(dim=c, n_heads=4, n_groups=g, stride=4, level=3, attn_impl="auto")
    v = random_variables(jswin.DAttentionMM(**kw), 72, jnp.asarray(x), jnp.asarray(y))
    v["params"]["rpe_table"] = v["params"]["rpe_table"] * 60
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    n = 2 * 4
    forced = {"proj_q": bf(rng.randn(b, h, w, c)), "proj_k": bf(rng.randn(b, 2 * n, c)),
              "proj_v": bf(rng.randn(b, 2 * n, c)),
              "conv_offset_x": bf(0.3 * rng.randn(b * g, 2, 4, 2)),
              "conv_offset_y": bf(0.3 * rng.randn(b * g, 2, 4, 2))}
    core = {}

    def interceptor(next_fun, args, kwargs, context):
        name = context.module.name
        if context.method_name == "__call__" and name == "proj_out":
            core["jax"] = np.asarray(args[0], np.float32)
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and name in forced:
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

    def port_core(level):
        port = tswin.DAttentionMM(c, 4, g, 4, level=level, attn_impl="pallas3").eval()
        port.load_state_dict(from_flax(v))
        cast_model_(port, BF16)
        pointwise = port._pointwise
        port._pointwise = lambda name, conv, t: (  # noqa: E731
            torch.from_numpy(forced[name]).to(BF16) if name in forced else pointwise(name, conv, t))
        port.conv_offset_x = Fixed(forced["conv_offset_x"])
        port.conv_offset_y = Fixed(forced["conv_offset_y"])
        assert port.rows_path(n)
        seen = {}
        monkeypatch.setattr(tswin, "pointwise", lambda conv, t: (
            seen.setdefault("core", t.float().numpy()) if conv is port.proj_out else None,
            layers.pointwise(conv, t))[1])
        with torch.no_grad():
            port(torch.from_numpy(x).to(BF16), torch.from_numpy(y).to(BF16))
        return seen["core"]

    want = core["jax"]
    # the level sets the form: level 3 unpacked, a level below it packed
    got, packed = port_core(3), port_core(2)
    share, share_packed = float((got != want).mean()), float((packed != want).mean())
    print(f"level 3 core: {share:.4f} of outputs differ; in the packed form {share_packed:.4f}")
    assert share == 0.0
    assert SHARE < share_packed

"""The DSCF variants at every head width, on the CPU, against the JAX
package:

  * K17's plain version (``dscf_attention``) and K16's (``dscf_fused_
    attention``) at 12, 10, 5 and 4 channels a head against the interpreted
    ``pallas_dscf_attention`` (``_dscf_kernel``) and
    ``pallas_dscf_attention_fused`` (``_dscf_fused_kernel``): bf16 bit for
    bit at the model's scale hc ** -0.5 (the rounding points are the
    kernels', and at these sizes the f32 sums agree), f32 at 2e-5;
  * the widths K17 (all five) and K16 (8 and 12) are built for, and the
    check of ``dscf_heads.head_channels`` the wrappers make;
  * the tiny Swin-L (``test_torch_swin_l.TINY_L``: DSCF heads of 12
    channels at every level) under dscf_pallas4, dscf_pallas and
    dscf_pallas2 against JAX's model under the matching
    ``IR_ADS_DSCF_ATTN`` (and ``IR_ADS_DSCF_RPE3=pallas``, which
    dscf_pallas4's level 3 reads), f32, atol 2e-3 / rtol 1e-3, at 64x128
    frames: the DSCF planes are 16x32 ... 2x4, each with a row band for
    the fused kernel (64x112's 4x7 plane has none, in JAX too), n = 2 x 4
    offsets a field at every level, one frame pair, the weights
    ``fill_variables``' (DSCF deform weights near 1, so that levels 0-2
    reach the logits at full weight).  JAX's Swin blocks take its default
    XLA attention, the port's dscf_* dispatches r5's blocks (K1 and K5's
    plain versions): the same function in f32, and one JAX compile without
    the interpreted block kernels costs half as much.

CMNeXt-B0 (the MiT's 4, 4, 5, 4 channels a head) under dscf_pallas and
dscf_pallas2 is held against JAX in tests/test_torch_legacy_dispatch.py.

About a minute in one process, three JAX compiles of the tiny Swin-L; the
port in one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops.pallas_dscf import (
    NEG_INF, pallas_dscf_attention, pallas_dscf_attention_fused,
)
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import dscf_heads
from ir_ads_tpu_torch.ops.dscf_attention import dscf_attention
from ir_ads_tpu_torch.ops.dscf_fused import dscf_fused_attention
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from test_torch_mit import fill_variables
from test_torch_swin_l import TINY_L, _jax_model

BF16 = torch.bfloat16
WIDTHS = (12, 10, 5, 4)
INTERPRET = {"IR_ADS_PALLAS_INTERPRET": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _compare(got, want, dtype):
    """bf16 bit for bit, f32 at 2e-5."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        assert got.dtype == BF16
        assert int((got.float().numpy() != want).sum()) == 0
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


# --------------------------------------------------------------------------
# K17 and K16 at the other widths
# --------------------------------------------------------------------------

def _packed_inputs(seed, hc, bg=2, hw=40, m=24, mp=128, hg=2):
    """Keys zero past m, their bias -1e9 (the DAttentionMM layout)."""
    rng = np.random.RandomState(seed)
    gc = hg * hc
    q = rng.randn(bg, hw, gc).astype(np.float32)
    k, v = (np.pad(rng.randn(bg, m, gc), ((0, 0), (0, mp - m), (0, 0))).astype(np.float32)
            for _ in range(2))
    bias = 2.0 * rng.randn(bg, hw, hg, mp)
    bias[..., m:] = NEG_INF
    return q, k, v, bias.reshape(bg, hw, hg * mp).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc", WIDTHS)
def test_attention_at_head_width_matches_dscf_kernel(hc, dtype):
    arrays = _packed_inputs(110 + hc, hc)
    scale = hc ** -0.5
    want = pallas_dscf_attention(*(jnp.asarray(a, dtype) for a in arrays), scale, 2,
                                 interpret=True)
    got = dscf_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays),
                         scale, 2)
    assert got.shape == arrays[0].shape
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc", WIDTHS)
def test_fused_at_head_width_matches_fused_kernel(hc, dtype):
    """A 4x16 plane (one band of 4 rows), 24 keys, 2 groups of 2 heads,
    one image."""
    rng = np.random.RandomState(120 + hc)
    bg, g, h, w, hg, m = 2, 2, 4, 16, 2, 24
    q, k, v = (rng.randn(bg, n, hg * hc).astype(np.float32) for n in (h * w, m, m))
    pos = rng.uniform(-1.0, 1.0, (bg, m, 2)).astype(np.float32)
    table = (2.0 * rng.randn(g, hg, 2 * h - 1, 2 * w - 1)).astype(np.float32)
    scale = hc ** -0.5
    want = pallas_dscf_attention_fused(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(pos), jnp.asarray(table),
        h, w, scale, hg, store_dtype=getattr(jnp, dtype), interpret=True)
    got = dscf_fused_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                 for a in (q, k, v)), torch.from_numpy(pos),
                               torch.from_numpy(table), h, w, scale, hg)
    assert got.shape == q.shape
    _compare(got, want, dtype)


def test_k16_and_k17_head_widths():
    """The widths K17 and K16 are built for (K4's and K8's:
    tests/test_torch_legacy_dispatch.py), and the check every CUDA wrapper
    makes before its launch."""
    assert dscf_heads.HEAD_CHANNELS["dscf_attention"] == (4, 5, 8, 10, 12)
    assert dscf_heads.HEAD_CHANNELS["dscf_fused"] == (8, 12)
    assert dscf_heads.head_channels("dscf_attention", 20, 2) == 10
    assert dscf_heads.head_channels("dscf_fused", 24, 2) == 12
    for kernel, gc, hg in (("dscf_fused", 20, 2), ("dscf_attention", 12, 2),
                           ("dscf_rows", 13, 2), ("dscf_rows_bwd", 8, 2)):
        with pytest.raises(ValueError, match=kernel):
            dscf_heads.head_channels(kernel, gc, hg)


# --------------------------------------------------------------------------
# the tiny Swin-L under the DSCF variants
# --------------------------------------------------------------------------

H, W = 64, 128  # DSCF planes 16x32 ... 2x4, n = 2 x 4 at every level
# JAX's model compiled at XLA's backend optimisation level 0: the same f32
# function (XLA's CPU backend uses no fast math at any level; the logits
# move by about 1e-6 of their size), in two thirds of the compile time
QUICK_COMPILE = {"xla_backend_optimization_level": 0}
SWIN_L_ENV = {  # the JAX environment each dispatch stands for, its DSCF part
    "dscf_pallas4": {"IR_ADS_DSCF_ATTN": "pallas4,pallas4,pallas4,xla",
                     "IR_ADS_DSCF_RPE3": "pallas"},
    "dscf_pallas": {"IR_ADS_DSCF_ATTN": "pallas"},
    "dscf_pallas2": {"IR_ADS_DSCF_ATTN": "pallas2"},
}


def _port_swin_l(dispatch="r5"):
    return CMNeXt("SwinTransformer-L", num_classes=5, backbone_kwargs=TINY_L,
                  head_dims=(32, 16), upsample_logits=False, dispatch=dispatch).eval()


@pytest.fixture(scope="module")
def swin_l():
    """JAX's tiny Swin-L, one frame pair, and ``fill_variables``' values
    (unit-scale DSCF deform weights, so that levels 0-2 reach the logits
    at full weight) in the shapes of the port's tree carried to flax's
    (``to_flax``, held leaf for leaf against JAX's tree by
    tests/test_torch_swin_l.py): no JAX trace for the shapes."""
    rng = np.random.RandomState(130)
    rgb, dte = (rng.randn(1, H, W, 3).astype(np.float32) for _ in range(2))
    variables = fill_variables(to_flax(_port_swin_l().state_dict()), 131)
    return _jax_model(upsample_logits=False), variables, rgb, dte


@pytest.mark.parametrize("dispatch", list(SWIN_L_ENV))
def test_tiny_swin_l_matches_jax_dscf_variant(swin_l, dispatch):
    model, v, rgb, dte = swin_l
    with pytest.MonkeyPatch.context() as mp:
        for key, val in {**INTERPRET, **SWIN_L_ENV[dispatch]}.items():
            mp.setenv(key, val)
        args = (v, jnp.asarray(rgb), jnp.asarray(dte))
        fwd = jax.jit(lambda vv, a, b: model.apply(vv, a, b, train=False)[0]).lower(*args)
        want = np.asarray(fwd.compile(compiler_options=QUICK_COMPILE)(*args))
    port = _port_swin_l(dispatch)
    port.load_state_dict(from_flax(v), strict=True)
    dscf = [m.deform_atten for m in port.backbone.DeformMPGBlocks]
    assert [d.proj_q.out_channels // d.n_heads for d in dscf] == [12] * 4
    branches = {"dscf_pallas4": ["pallas4"] * 3 + ["xla"], "dscf_pallas": ["pallas"] * 4,
                "dscf_pallas2": ["pallas2"] * 4}[dispatch]
    assert [d.branch(8) for d in dscf] == branches
    with torch.no_grad():
        got = port(torch.from_numpy(rgb), torch.from_numpy(dte))[0].numpy()
    assert got.shape == want.shape == (1, H // 4, W // 4, 5) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)

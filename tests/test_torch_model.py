"""The port's modules and the whole slice against the JAX package, on the
CPU in f32, with weights carried across by utils/jax_params.from_flax.

Parameters are drawn with numpy from a fixed seed into the flax tree's
shapes (jax.eval_shape of ``init``; no flax initializer runs), so the
adapters, BN statistics and combiner weights are all non-trivial.

  * SwinBlockAdapter: the JAX block under the pallas4 + fused-tail kernels
    and under the pallas6 whole-block kernel (interpret mode) against the
    port's block, which runs the plain versions of K1 and K2, or K5, on the
    CPU.
  * DAttentionMM / DeformMPGBlock: the JAX pallas3 branch (rows kernels in
    interpret mode) against the port's; at level 3 the JAX einsum branch,
    with its bias from the packed rpe kernel or from XLA, against the
    port's, whose bias is K6's plain version.
  * CMNeXt end to end: the JAX sliding-window predictor (tile = image,
    overlap 1/3, flip, low-res logits) against the port's, atol 2e-3 and
    rtol 1e-3 as tests/test_swin_parity.py.  JAX runs its CPU default there,
    the XLA window path, which masks shifted windows with -100 where the
    kernels (and the port) use -1e9; exp(-100) is below f32 resolution next
    to the unmasked terms, so the bar is unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ir_ads_tpu.ops.pallas_dscf as pallas_dscf
import ir_ads_tpu.ops.pallas_dscf_rpe as pallas_rpe
from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.utils.jax_params import from_flax

TINY = dict(embed_dim=16, depths=(1, 4, 1, 1), num_heads=(1, 2, 4, 8),
            window_size=4)


def random_variables(module, seed, *args):
    """numpy-seeded values in the shapes of ``module.init``'s tree."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "var":
            v = 0.5 + rng.rand(*leaf.shape)
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, tree)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX under the bench r4 kernel set, Pallas kernels interpreted."""
    monkeypatch.setenv("IR_ADS_SWIN_ATTN", "pallas4")
    monkeypatch.setenv("IR_ADS_FFN", "fused")
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    orig_attn = pallas_dscf.pallas_dscf_attention_rows
    monkeypatch.setattr(
        pallas_dscf, "pallas_dscf_attention_rows",
        lambda *a, **kw: orig_attn(*a, **{**kw, "interpret": True}))
    orig_rpe = pallas_rpe.dscf_rpe_bias_rows_pallas
    monkeypatch.setattr(
        pallas_rpe, "dscf_rpe_bias_rows_pallas",
        lambda *a, **kw: orig_rpe(*a, **{**kw, "interpret": True}))


BLOCK_CASES = [(8, 8, False, "rgb"), (8, 8, True, "dte"), (7, 10, True, "rgb")]


def _port_block_matches_jax(h, w, shifted, sub_mode, attn_impl):
    x = np.random.RandomState(4).randn(2, h, w, 32).astype(np.float32)
    blk = jswin.SwinBlockAdapter(dim=32, num_heads=2, ffn_dim=128,
                                 window_size=4, shift=shifted)
    v = random_variables(blk, 5, jnp.asarray(x), sub_mode, True)
    want = blk.apply(v, jnp.asarray(x), sub_mode, True)
    port = tswin.SwinBlockAdapter(32, 2, 128, 4, shift=shifted, attn_impl=attn_impl)
    missing, unexpected = port.load_state_dict(from_flax(v), strict=False)
    other = "MLP_DTE_Adapter" if sub_mode == "rgb" else "MLP_RGB_Adapter"
    assert not unexpected and all(k.startswith(other) for k in missing)
    with torch.no_grad():
        got = port(torch.from_numpy(x), sub_mode).numpy()
    np.testing.assert_allclose(got, _np(want), atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,shifted,sub_mode", BLOCK_CASES)
def test_swin_block_matches_jax_pallas4_block(pallas_interpret, h, w, shifted, sub_mode):
    _port_block_matches_jax(h, w, shifted, sub_mode, "pallas4")


@pytest.mark.parametrize("h,w,shifted,sub_mode", BLOCK_CASES)
def test_swin_block_matches_jax_pallas6_block(pallas_interpret, monkeypatch, h, w,
                                              shifted, sub_mode):
    monkeypatch.setenv("IR_ADS_SWIN_ATTN", "pallas6")
    _port_block_matches_jax(h, w, shifted, sub_mode, "pallas6")


def test_flax_tree_is_the_same_under_every_swin_kernel(pallas_interpret, monkeypatch):
    """The JAX block declares the same parameters under pallas4 and pallas6,
    so one from_flax serves both dispatches of the port."""
    x = jnp.zeros((2, 8, 8, 32))
    blk = jswin.SwinBlockAdapter(dim=32, num_heads=2, ffn_dim=128,
                                 window_size=4, shift=True)
    trees = {}
    for impl in ("pallas4", "pallas6"):
        monkeypatch.setenv("IR_ADS_SWIN_ATTN", impl)
        shapes = jax.eval_shape(
            lambda: blk.init({"params": jax.random.PRNGKey(0)}, x, "rgb", True))
        trees[impl] = jax.tree_util.tree_map(lambda a: a.shape, shapes)
    assert trees["pallas4"] == trees["pallas6"]
    sd = from_flax(random_variables(blk, 5, x, "rgb", True))
    for impl in ("pallas4", "pallas6"):
        port = tswin.SwinBlockAdapter(32, 2, 128, 4, shift=True, attn_impl=impl)
        missing, unexpected = port.load_state_dict(sd, strict=False)
        assert not unexpected and all(k.startswith("MLP_DTE") for k in missing)


def test_dattention_matches_jax_pallas3(pallas_interpret):
    rng = np.random.RandomState(6)
    x, y = (rng.randn(2, 16, 16, 32).astype(np.float32) for _ in range(2))
    mod = jswin.DAttentionMM(dim=32, n_heads=4, n_groups=2, stride=4,
                             attn_impl="pallas3")
    v = random_variables(mod, 7, jnp.asarray(x), jnp.asarray(y))
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(y), False)
    port = tswin.DAttentionMM(32, 4, 2, 4).eval()
    port.load_state_dict(from_flax(v))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("rpe3", ["pallas", "xla"])
def test_dattention_level3_matches_jax_einsum_branch(pallas_interpret, monkeypatch, rpe3):
    """Level 3 of r5: JAX's einsum ("xla") branch, its bias from the packed
    Pallas kernel (IR_ADS_DSCF_RPE3=pallas) or from XLA (the TPU default),
    against the port's, whose bias is K6's plain version."""
    monkeypatch.setenv("IR_ADS_DSCF_RPE3", rpe3)
    rng = np.random.RandomState(16)
    x, y = (rng.randn(2, 6, 8, 32).astype(np.float32) for _ in range(2))
    mod = jswin.DAttentionMM(dim=32, n_heads=4, n_groups=2, stride=1, level=3,
                             attn_impl="xla")
    v = random_variables(mod, 17, jnp.asarray(x), jnp.asarray(y))
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(y), False)
    port = tswin.DAttentionMM(32, 4, 2, 1, level=3, attn_impl="xla").eval()
    port.load_state_dict(from_flax(v))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=2e-4, rtol=2e-4)


def test_deform_mpg_block_matches_jax_pallas3(pallas_interpret):
    rng = np.random.RandomState(8)
    a, b = (rng.randn(2, 12, 12, 64).astype(np.float32) for _ in range(2))
    mod = jswin.DeformMPGBlock(dim=64, stride=2, n_groups=2, n_heads=4,
                               level=1, attn_impl="pallas3")
    v = random_variables(mod, 9, jnp.asarray(a), jnp.asarray(b))
    want = mod.apply(v, jnp.asarray(a), jnp.asarray(b), False)
    port = tswin.DeformMPGBlock(64, 2, 2, 4, level=1).eval()
    port.load_state_dict(from_flax(v))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=2e-4, rtol=2e-4)


H, W = 64, 80


@pytest.fixture(scope="module")
def tiny_slice():
    """One JAX CMNeXt (TINY, depth-4 stage) predictor run, shared."""
    rng = np.random.RandomState(10)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    model = JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                      backbone_kwargs=dict(TINY, drop_path_rate=0.0),
                      head_dims=(32, 16), mmst_mask=False, upsample_logits=False)
    v = random_variables(model, 11, jnp.asarray(rgb), jnp.asarray(dte))
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    predict = jax_sliding(fwd, (H, W), (H, W), 5, overlap=1.0 / 3.0,
                          flip=True, fuse=True)
    want = _np(predict(jnp.asarray(rgb), jnp.asarray(dte)))
    return v, rgb, dte, want


def test_from_flax_loads_strictly_and_unstacks_pairs(tiny_slice):
    v = tiny_slice[0]
    sd = from_flax(v)
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16))
    port.load_state_dict(sd, strict=True)
    pairs = v["params"]["backbone"]["stages_1"]["pairs"]
    for blk, slot, p in ((0, "block0", 0), (3, "block1", 1), (2, "block0", 1)):
        np.testing.assert_array_equal(
            sd[f"backbone.stages.1.blocks.{blk}.ffn.layers.1.weight"].numpy(),
            pairs[slot]["ffn"]["Dense_1"]["kernel"][p].T,
        )


def test_sliding_window_slice_matches_jax(tiny_slice):
    v, rgb, dte, want = tiny_slice
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False).eval()
    port.load_state_dict(from_flax(v))
    predict = make_sliding_window_fn(lambda r, d: port(r, d)[0], (H, W), (H, W), 5)
    with torch.no_grad():
        got = predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)

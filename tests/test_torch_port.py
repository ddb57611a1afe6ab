"""Ground rules of the PyTorch port: no JAX inside it, the GPU by default,
the r5 kernel dispatch by default, r4, r4i8, train, r2, r1, xla, v7_01, v5,
map, dscf_pallas4, dscf_pallas and dscf_pallas2 on request (nothing else), the
sliding-window wrapper's overlap arithmetic against the JAX one."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import (
    block_tail, block_tail_int8, dscf_attention, dscf_fused, dscf_rows, dscf_rows_bwd, dscf_rpe,
    dscf_rpe_jmajor, dscf_rpe_packed, msdeform, patch_embed, swin_block, swin_block_full,
    swin_block_int8, swin_block_v6, swin_block_v7, window_attention_map, window_attention_qkv,
    window_attention_v1, window_attn_bwd,
)
from ir_ads_tpu_torch.serve import IMAGENET_MEAN, IMAGENET_STD, SemSegPredictor

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ir_ads_tpu")


def _port_sources():
    scripts = ("chip_smoke.py", "profile_port.py", "grad_noise.py")
    return sorted((ROOT / "ir_ads_tpu_torch").rglob("*.py")) + [ROOT / n for n in scripts]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_predictor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SemSegPredictor()


SMALL = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
             window_size=4)


def _dispatch(model):
    bb = model.backbone
    return ([s.blocks[0].attn_impl for s in bb.stages],
            [m.deform_atten.attn_impl for m in bb.DeformMPGBlocks])


def test_only_the_r5_and_r4_dispatches_are_accepted():
    r5 = (["pallas4", "pallas4", "pallas6", "pallas6"],
          ["pallas3", "pallas3", "pallas3", "xla"])
    assert tswin.DISPATCH["r5"] == tuple(tuple(x) for x in r5) + ("fused", False, "pallas")
    assert tswin.DISPATCH["train"] == (
        ("pallas4",) * 4, ("pallas3", "pallas3", "pallas3", "xla"), "module", False, "pallas")
    assert tswin.DISPATCH["r4i8"] == tswin.DISPATCH["r4"][:3] + (True, "pallas")
    # bench.py's r2, r1 and xla sets: no IR_ADS_FFN (fused on its chip),
    # IR_ADS_DSCF_RPE3 left at auto (the XLA form)
    assert tswin.DISPATCH["r2"] == (("pallas",) * 4, ("pallas3",) * 4, "fused", False, "xla")
    assert tswin.DISPATCH["r1"] == (("pallas",) * 4, ("xla",) * 4, "fused", False, "xla")
    assert tswin.DISPATCH["xla"] == (("xla",) * 4, ("xla",) * 4, "fused", False, "xla")
    # the opt-in block variants: r5 with pallas7 at stages 0-1, r4 with
    # pallas5, r2 with pallas_map
    assert tswin.DISPATCH["v7_01"] == (("pallas7",) * 2 + ("pallas6",) * 2,) + tswin.DISPATCH[
        "r5"][1:]
    assert tswin.DISPATCH["v5"] == (("pallas5",) * 4,) + tswin.DISPATCH["r4"][1:]
    assert tswin.DISPATCH["map"] == (("pallas_map",) * 4,) + tswin.DISPATCH["r2"][1:]
    # the opt-in DSCF variants: r5's blocks, pallas4 (level 3 r5's einsum),
    # pallas or pallas2 at every level
    for name, dscf in [("dscf_pallas4", ("pallas4",) * 3 + ("xla",)),
                       ("dscf_pallas", ("pallas",) * 4), ("dscf_pallas2", ("pallas2",) * 4)]:
        assert tswin.DISPATCH[name] == (tswin.DISPATCH["r5"][0], dscf) + tswin.DISPATCH[
            "r5"][2:]
        model = CMNeXt(num_classes=5, backbone_kwargs=SMALL, dispatch=name)
        assert _dispatch(model) == (r5[0], list(dscf))
    assert set(tswin.DISPATCH) == {"r5", "r4", "r4i8", "train", "r2", "r1", "xla", "v7_01",
                                   "v5", "map", "dscf_pallas4", "dscf_pallas", "dscf_pallas2"}
    for name in ("r2", "r1", "xla"):
        model = CMNeXt(num_classes=5, backbone_kwargs=SMALL, dispatch=name)
        assert _dispatch(model) == tuple(list(x) for x in tswin.DISPATCH[name][:2])
        assert {m.deform_atten.rpe3 for m in model.backbone.DeformMPGBlocks} == {"xla"}
    train = CMNeXt(num_classes=5, backbone_kwargs=SMALL, dispatch="train")
    assert _dispatch(train) == (["pallas4"] * 4, r5[1])
    assert {b.ffn_impl for s in train.backbone.stages for b in s.blocks} == {"module"}
    assert _dispatch(CMNeXt(num_classes=5, backbone_kwargs=SMALL)) == r5
    assert _dispatch(CMNeXt(num_classes=5, backbone_kwargs=SMALL, dispatch="r4")) == (
        ["pallas4"] * 4, ["pallas3"] * 4)
    r4i8 = CMNeXt(num_classes=5, backbone_kwargs=SMALL, dispatch="r4i8")
    assert _dispatch(r4i8) == (["pallas4"] * 4, ["pallas3"] * 4)
    assert all(m.int8 for m in r4i8.modules() if hasattr(m, "int8"))
    with pytest.raises(NotImplementedError):  # int8 is r4's kernels, not r5's
        tswin.SwinTransformer(**SMALL, int8=True)
    with pytest.raises(NotImplementedError):  # nor the train tail's
        tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, ffn_impl="module", int8=True)
    tswin.SwinTransformer(**SMALL, attn_impl=("pallas4",) * 4, dscf_attn=("pallas3",) * 4)
    with pytest.raises(NotImplementedError):
        CMNeXt(num_classes=5, backbone_kwargs=SMALL, dispatch="r3")
    for attn, dscf in [(("pallas6",) * 4, ("pallas3",) * 4),
                       (("pallas4",) * 4, ("pallas3", "pallas3", "pallas3", "xla")),
                       (("pallas4", "pallas4", "pallas6"), ("pallas3",) * 3 + ("xla",)),
                       (("xla",) * 4, ("pallas3",) * 4),
                       (("pallas",) * 4, ("pallas3",) * 3 + ("xla",))]:
        with pytest.raises(NotImplementedError):
            tswin.SwinTransformer(**SMALL, attn_impl=attn, dscf_attn=dscf)
    with pytest.raises(NotImplementedError):
        tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, attn_impl="auto")
    for impl in ("pallas5", "pallas7"):  # eval kernels: not with the train tail
        with pytest.raises(NotImplementedError):
            tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, attn_impl=impl,
                                   ffn_impl="module")
    with pytest.raises(NotImplementedError):  # int8 is r4's kernels, not v7's
        tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, attn_impl="pallas7", int8=True)
    with pytest.raises(NotImplementedError):  # the bench's xla set keeps r5's bias kernel
        tswin.SwinTransformer(**SMALL, attn_impl=("xla",) * 4, dscf_attn=("xla",) * 4)
    for impl in ("pallas", "xla"):  # the module attention path is eval-only
        with pytest.raises(NotImplementedError):
            tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, attn_impl=impl,
                                   ffn_impl="module")
    with pytest.raises(NotImplementedError):
        tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, ffn_impl="xla")
    with pytest.raises(NotImplementedError):  # K5 is the whole block
        tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False, attn_impl="pallas6",
                               ffn_impl="module")
    with pytest.raises(NotImplementedError):  # the train tail only with its dispatch
        tswin.SwinTransformer(**SMALL, ffn_impl="module")
    for impl in ("pallas3", "pallas4", "pallas", "pallas2", "xla"):
        assert tswin.DAttentionMM(32, 4, 2, 4, attn_impl=impl).attn_impl == impl
    with pytest.raises(NotImplementedError):  # the port reads no environment
        tswin.DAttentionMM(32, 4, 2, 4, attn_impl="auto")
    with pytest.raises(NotImplementedError):
        tswin.DAttentionMM(32, 4, 2, 4, rpe3="auto")
    # both streams in one stage call (the JAX package's sub-mode "dual")
    assert tswin.SwinTransformer(**SMALL, dual_batch=True).dual_batch
    with pytest.raises(NotImplementedError):  # a stream the block has no adapter for
        tswin.SwinBlockAdapter(32, 2, 128, 4, shift=False)(torch.zeros(1, 4, 4, 32), "depth")


def test_pallas6_block_takes_the_real_map_with_no_pad_roll_or_crop():
    """K5 gets the block's real input map; the padding, the cyclic shift and
    the crop are the kernel's."""
    import inspect

    src = inspect.getsource(tswin.SwinBlockAdapter.forward)
    branch = src[src.index('if self.attn_impl == "pallas6"'):src.index("MODULE_ATTN")]
    for banned in ("F.pad", "torch.roll", "[:, :h", "contiguous"):
        assert banned not in branch
    blk = tswin.SwinBlockAdapter(32, 2, 128, 4, shift=True, attn_impl="pallas6")
    seen = {}
    orig = tswin.window_block_v6

    def spy(x, *a, **kw):
        seen["shape"] = tuple(x.shape)
        return orig(x, *a, **kw)

    tswin.window_block_v6 = spy
    try:
        with torch.no_grad():
            out = blk(torch.randn(2, 7, 10, 32), "rgb")
    finally:
        tswin.window_block_v6 = orig
    assert seen["shape"] == (2, 7, 10, 32) and out.shape == (2, 7, 10, 32)


def test_every_kernel_targets_hopper_and_names_its_tpu_kernel():
    mods = (swin_block, block_tail, dscf_rpe, dscf_rows, swin_block_v6, dscf_rpe_packed,
            window_attn_bwd, dscf_rows_bwd, msdeform, swin_block_int8, block_tail_int8,
            window_attention_qkv, swin_block_v7, swin_block_full, window_attention_map,
            dscf_fused, dscf_attention, dscf_rpe_jmajor, patch_embed, window_attention_v1)
    assert len({m.KERNEL.name for m in mods}) == 20
    assert len({m.KERNEL.replaces for m in mods}) == 20
    for mod in mods:
        k = mod.KERNEL
        assert k.source.exists()
        assert f'extern "C" int {k.fn}(' in k.source.read_text()
        assert k.replaces.startswith("ir_ads_tpu/ops/pallas_")
        assert k.launches == 0  # nothing launched on the CPU
        src = (ROOT / k.replaces.split(":")[0]).read_text().splitlines()
        assert src[int(k.replaces.split(":")[1]) - 1].startswith("def _")


@pytest.mark.parametrize("tile", [(32, 32), (48, 64)])
def test_sliding_window_matches_jax_wrapper(tile):
    """A linear stand-in for the model (tiles -> H/4 logits) through both
    wrappers: tile extraction, flip ensemble, low-res upsample, overlap-add."""
    h, w, k = 48, 64, 3
    rng = np.random.RandomState(12)
    mix = rng.randn(6, k).astype(np.float32)
    rgb = rng.randn(2, h, w, 3).astype(np.float32)
    dte = rng.randn(2, h, w, 3).astype(np.float32)

    def jfwd(r, d):
        x = jnp.concatenate([r, d], -1)[:, ::4, ::4]
        return x @ mix

    def tfwd(r, d):
        return torch.cat([r, d], -1)[:, ::4, ::4] @ torch.from_numpy(mix)

    want = jax_sliding(jfwd, (h, w), tile, k, overlap=1 / 3, flip=True, fuse=True)(
        jnp.asarray(rgb), jnp.asarray(dte))
    got = make_sliding_window_fn(tfwd, (h, w), tile, k)(
        torch.from_numpy(rgb), torch.from_numpy(dte))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_predictor_on_cpu_normalizes_like_infer_mm():
    pred = SemSegPredictor(
        device="cpu", dtype=torch.float32, num_classes=5, image_size=(64, 80),
        backbone_kwargs=dict(embed_dim=16, depths=(1, 2, 1, 1),
                             num_heads=(1, 2, 4, 8), window_size=4),
        head_dims=(32, 16),
    )
    rng = np.random.RandomState(13)
    rgb = rng.randint(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    dep = rng.randint(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    r, d = pred.normalize(rgb, dep)
    np.testing.assert_allclose(
        r.numpy(), (rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), dep / 255.0, atol=1e-6)
    logits, labels = pred(rgb, dep)
    assert logits.shape == (2, 64, 80, 5) and labels.shape == (2, 64, 80)
    assert torch.isfinite(logits).all()
    assert torch.equal(labels, logits.argmax(-1))


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(align_corners):
    from ir_ads_tpu.ops.layers import resize_bilinear as jax_resize
    from ir_ads_tpu_torch.ops.layers import resize_bilinear

    x = np.random.RandomState(14).randn(2, 8, 12, 5).astype(np.float32)
    want = jax_resize(jnp.asarray(x), (32, 48), align_corners=align_corners)
    got = resize_bilinear(torch.from_numpy(x), (32, 48), align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_ffn_and_adapter_match_jax_modules():
    """Mlp (tanh GELU, residual) and the no-skip Adapter, weights carried
    across by from_flax."""
    import jax

    from ir_ads_tpu.models.backbones.swin import Adapter as JaxAdapter
    from ir_ads_tpu.ops.layers import Mlp
    from ir_ads_tpu_torch.ops.layers import FFN
    from ir_ads_tpu_torch.utils.jax_params import from_flax

    def load(port, name, params):
        sd = from_flax({"params": {name: params}})
        port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
        return port

    rng = np.random.RandomState(15)
    x = rng.randn(4, 5, 32).astype(np.float32)
    mlp = Mlp(hidden_dim=128)
    vm = mlp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ffn = load(FFN(32, 128), "ffn", vm["params"])
    ad = JaxAdapter(skip_connect=False)
    va = jax.tree.map(lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32),
                      ad.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    adapter = load(tswin.Adapter(32), "adapter_rgb", va["params"])
    with torch.no_grad():
        got_ffn = ffn(torch.from_numpy(x), torch.from_numpy(x)).numpy()
        got_ad = adapter(torch.from_numpy(x)).numpy()
    for got, want in ((got_ffn, mlp.apply(vm, jnp.asarray(x))),
                      (got_ad, ad.apply(va, jnp.asarray(x)))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)

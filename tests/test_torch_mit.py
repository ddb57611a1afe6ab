"""The legacy CMNeXt (MiT dual stream: ``models/backbones/mit.py``) against
the JAX package, on the CPU, with weights carried across by
utils/jax_params.from_flax.

Weights are drawn with numpy into the flax tree's shapes (jax.eval_shape of
``init``: no flax initializer runs) with every kernel ~ N(0, 1/fan_in), the
rpe tables ~ N(0, 1) and the DSCF combiner weights around 1
(``legacy_variables``), so that every branch, the DSCF's attention and its
rpe bias included, moves the logits.

  * Each module against its flax module, f32, atol 2e-5: SRAttention at
    sr 8 (on a map of whole 8x8 cells and on one that takes flax's SAME
    padding) and sr 1, MixFFN, CEBlock on both streams, AddMPGBlock, and
    the level-3 DSCF at MiT stage 2's 10 channels a head, whose einsum
    branch takes K6's plain version (JAX: the packed Pallas kernel in
    interpret mode) or the XLA-form bias.
  * CMNeXt-B0's logits at 64x64 against JAX's jitted apply, f32, atol 2e-3
    / rtol 1e-3 (tests/test_swin_parity.py's bar): under ``R5_ENV`` (every
    stage's plane is at most 2048 pixels, so each stage's bias is K6's)
    and under the XLA-form bias.
  * bf16 against JAX's ``dtype=bfloat16`` model (jitted), as
    tests/test_torch_bf16.py states its bars.  Measured on this file's
    inputs: the port lies 2.984e-2 from JAX bf16 and 3.185e-2 from JAX f32,
    where JAX bf16 lies 2.794e-2 from JAX f32.  These are ten times the Swin
    model's distances: the MiT's DSCF runs at every stage with unit deform
    weight, and its bf16 offset heads move the sampling positions (on the
    stage-2 DSCF module alone JAX's own jitted and eager bf16 lie 2.45e-2
    apart, the port 1.89e-2 from the eager one).  Bars: 1.25x JAX bf16's own
    distance from f32, for both.
  * ``from_flax`` -> ``to_flax`` leaf for leaf; CMNeXt-B5's parameter shapes
    on the meta device against ``jax.eval_shape``'s, no compute.
  * ``SemSegPredictor(device="cpu")`` and ``val_mm`` on a Synthetic config
    naming CMNeXt-B0 against a direct forward; what the legacy models
    refuse.

One JAX compile a configuration (about 8 s each), the port in one thread:
about 50 s in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ir_ads_tpu.models import build_model as jax_build_model
from ir_ads_tpu.models.backbones import mit as jmit
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu_torch import train_mm, val_mm
from ir_ads_tpu_torch.data.augmentations import (
    IMAGENET_MEAN, IMAGENET_STD, get_val_augmentation,
)
from ir_ads_tpu_torch.data.datasets import Synthetic
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models import CMNeXtLegacy, build_model
from ir_ads_tpu_torch.models.backbones import mit as tmit
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.ops.layers import resize_bilinear
from ir_ads_tpu_torch.serve import SemSegPredictor
from ir_ads_tpu_torch.train import SemSegTrainer
from ir_ads_tpu_torch.training.metrics import Metrics
from ir_ads_tpu_torch.utils.config import DEFAULTS, _merge
from ir_ads_tpu_torch.utils.jax_params import _port_name, from_flax, to_flax
from test_torch_slice_r5 import R5_ENV

H = W = 64
CLASSES = 5
ATOL, RTOL = 2e-3, 1e-3
XLA_ENV = {**R5_ENV, "IR_ADS_DSCF_RPE3": "xla"}


def legacy_variables(module, seed, *args):
    """numpy-seeded values in the shapes of ``module.init``'s tree: kernels
    ~ N(0, 1/fan_in), the rpe tables ~ N(0, 1), the DSCF's deform and
    identity weights 1 + 0.02 N(0, 1), scales 1 + 0.05 N(0, 1), variances in
    [0.5, 1.5), other leaves 0.05 N(0, 1)."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args))
    return fill_variables(shapes, seed)


def fill_variables(shapes, seed):
    """``legacy_variables``'s values in the shapes of the tree ``shapes``."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "rpe_table":
            v = rng.randn(*leaf.shape)
        elif name in ("deform_weight", "identity_weight"):
            v = 1.0 + 0.02 * rng.randn(*leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "var":
            v = 0.5 + rng.rand(*leaf.shape)
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def carried(port, variables, prefix=""):
    """``port`` in eval mode with the flax ``variables`` (under the flax
    module ``prefix``) carried across by ``from_flax``."""
    sd = {k[len(prefix):]: v for k, v in from_flax(variables).items() if k.startswith(prefix)}
    port.load_state_dict(sd)
    return port.eval()


def frames(seed, b=2, h=H, w=W):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, w, 3).astype(np.float32) for _ in range(2))


def shapes_of(jax_model, port_model):
    """(the port names and torch shapes of ``jax.eval_shape`` of the JAX
    model's init, those of the port model's state_dict on the meta device):
    no compute and no allocation on either side."""
    x = jnp.zeros((1, 32, 32, 3))
    tree = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)}, x, x))
    want = {}
    for coll in tree.values():
        for path, leaf in jax.tree_util.tree_flatten_with_path(coll)[0]:
            keys = tuple(p.key for p in path)
            shape = tuple(leaf.shape)
            if keys[-1] == "kernel":
                shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], *shape[:2])
            want[_port_name(keys)] = shape
    got = {k: tuple(v.shape) for k, v in port_model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    return want, got


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setenv(mp, env):
    for k, v in env.items():
        mp.setenv(k, v)


def _jitted_logits(model, v, rgb, dte, env, dtype=jnp.float32):
    """The JAX model's fused logits, jitted and traced under ``env`` (read
    at trace time)."""
    with pytest.MonkeyPatch.context() as mp:
        _setenv(mp, env)
        fn = jax.jit(lambda vv, a, b: model.apply(vv, a, b)[0])
        return np.asarray(fn(v, jnp.asarray(rgb, dtype), jnp.asarray(dte, dtype)),
                          np.float32)


@pytest.fixture(scope="module")
def b0():
    """CMNeXt-B0 (JAX) with its weights, two 64x64 frames and the JAX
    logits under r5 and under the XLA-form bias."""
    rgb, dte = frames(30)
    model = jax_build_model("CMNeXt", "CMNeXt-B0", num_classes=CLASSES)
    v = legacy_variables(model, 31, jnp.asarray(rgb), jnp.asarray(dte))
    return dict(model=model, v=v, rgb=rgb, dte=dte,
                r5=_jitted_logits(model, v, rgb, dte, R5_ENV),
                xla=_jitted_logits(model, v, rgb, dte, XLA_ENV))


def _port_logits(v, rgb, dte, backbone="CMNeXt-B0", dispatch="r5", dtype=None):
    port = build_model("CMNeXt", backbone, CLASSES, dtype, dispatch=dispatch,
                       state_dict=from_flax(v))
    cast = (lambda a: torch.from_numpy(a).to(dtype)) if dtype else torch.from_numpy
    with torch.no_grad():
        return port(cast(rgb), cast(dte))[0].float().numpy()


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sr,h,w", [(8, 16, 24), (8, 12, 20), (1, 6, 7)])
def test_sr_attention_matches_flax(sr, h, w):
    """At sr 8 on 12x20 flax pads 2 rows and 2 columns on each side (SAME)."""
    x = np.random.RandomState(sr + h).randn(2, h, w, 64).astype(np.float32)
    jm = jmit.SRAttention(64, 2, sr)
    v = legacy_variables(jm, 1, jnp.asarray(x))
    port = carried(tmit.SRAttention(64, 2, sr), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=2e-5,
                               rtol=0)


def test_mix_ffn_matches_flax():
    x = np.random.RandomState(2).randn(2, 6, 9, 32).astype(np.float32)
    jm = jmit.MixFFN(128)
    v = legacy_variables(jm, 3, jnp.asarray(x))
    port = carried(tmit.MixFFN(32, 128), v)
    assert port.dwconv.groups == 128
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=2e-5,
                               rtol=0)


class _Streams(nn.Module):
    """One CEBlock run on both streams, as MiTDualStream runs it: the block
    weights shared, an adapter a stream."""

    @nn.compact
    def __call__(self, x, y):
        blk = jmit.CEBlock(dim=64, num_heads=2, sr_ratio=4, name="blk")
        return blk(x, "rgb"), blk(y, "dte")


def test_ce_block_on_both_streams_matches_flax():
    x, y = (np.random.RandomState(s).randn(2, 8, 12, 64).astype(np.float32) for s in (4, 5))
    jm = _Streams()
    v = legacy_variables(jm, 6, jnp.asarray(x), jnp.asarray(y))
    port = carried(tmit.CEBlock(64, 2, 4), v, "blk.")
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = (port(torch.from_numpy(x), "rgb"), port(torch.from_numpy(y), "dte"))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5, rtol=0)
    # the streams differ by their adapters only
    with torch.no_grad():
        assert not torch.equal(port(torch.from_numpy(x), "rgb"), port(torch.from_numpy(x), "dte"))


def test_add_mpg_block_matches_flax():
    a, b = (np.random.RandomState(s).randn(2, 5, 7, 64).astype(np.float32) for s in (7, 8))
    jm = jmit.AddMPGBlock()
    v = legacy_variables(jm, 9, jnp.asarray(a), jnp.asarray(b))
    port = carried(tmit.AddMPGBlock(64), v)
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(a), jnp.asarray(b))),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("rpe3", ["pallas", "xla"])
def test_level3_dscf_at_ten_channels_a_head_matches_flax(monkeypatch, rpe3):
    """MiT stage 2 of CMNeXt-B2: 320 channels, ratio 0.25 (80 in the DSCF),
    8 heads of 10 channels in 4 groups, offset stride 2; an 8x10 plane, n =
    4 x 5 offsets a field.  JAX's level 3 takes the einsum branch
    (``IR_ADS_DSCF_ATTN``'s last entry), its bias from the packed Pallas
    kernel (interpreted) or XLA; the port's from K6's plain version or the
    XLA form."""
    _setenv(monkeypatch, R5_ENV if rpe3 == "pallas" else XLA_ENV)
    x, y = (np.random.RandomState(s).randn(2, 8, 10, 320).astype(np.float32) for s in (10, 11))
    jm = jswin.DeformMPGBlock(dim=320, stride=2, n_groups=4, n_heads=8, level=3, ratio=0.25)
    v = legacy_variables(jm, 12, jnp.asarray(x), jnp.asarray(y))
    port = carried(tswin.DeformMPGBlock(320, 2, 4, 8, level=3, ratio=0.25, attn_impl="xla",
                                        rpe3=rpe3), v)
    da = port.deform_atten
    assert da.branch(20) == "xla" and da.bias_kernel(8, 10) == (rpe3 == "pallas")
    assert da.proj_q.out_channels // da.n_heads == 10
    assert float(da.deform_weight.detach().mean()) == pytest.approx(1.0, abs=0.01)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(y))),
                               atol=2e-5, rtol=0)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

def test_mit_dual_stream_layout():
    mit = CMNeXtLegacy("CMNeXt-B0", CLASSES).backbone
    dscf = [m.deform_atten for m in mit.DeformMPGBlocks]
    assert [d.level for d in dscf] == [3] * 4 and {d.attn_impl for d in dscf} == {"xla"}
    assert [d.n_heads for d in dscf] == [2, 4, 8, 16] and [d.n_groups for d in dscf] == [
        1, 2, 4, 8]
    assert [m.D_fc1.out_features for m in mit.DeformMPGBlocks] == [8, 16, 40, 64]
    # 480x640: stages 2-3 (30x40, 15x20) take K6, stages 0-1 the XLA form
    assert [d.bias_kernel(120 >> i, 160 >> i) for i, d in enumerate(dscf)] == [
        False, False, True, True]
    assert {d.rpe3 for d in (m.deform_atten for m in CMNeXtLegacy(
        "CMNeXt-B0", CLASSES, "xla").backbone.DeformMPGBlocks)} == {"xla"}


@pytest.mark.parametrize("dispatch", ["r5", "xla"])
def test_cmnext_b0_matches_jax(b0, dispatch):
    got = _port_logits(b0["v"], b0["rgb"], b0["dte"], dispatch=dispatch)
    want = b0["r5" if dispatch == "r5" else "xla"]
    assert got.shape == (2, H, W, CLASSES) and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cmnext_b0_bf16_matches_jax_bf16(b0):
    bf16_model = jax_build_model("CMNeXt", "CMNeXt-B0", num_classes=CLASSES,
                                 dtype=jnp.bfloat16)
    want16 = _jitted_logits(bf16_model, b0["v"], b0["rgb"], b0["dte"], R5_ENV, jnp.bfloat16)
    got = _port_logits(b0["v"], b0["rgb"], b0["dte"], dtype=torch.bfloat16)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    print(f"port vs JAX bf16 {rel(got, want16):.3e}, vs JAX f32 {rel(got, b0['r5']):.3e}; "
          f"JAX bf16 vs f32 {rel(want16, b0['r5']):.3e}")
    assert rel(got, want16) <= 1.25 * rel(want16, b0["r5"])
    assert rel(got, b0["r5"]) <= 1.25 * rel(want16, b0["r5"])


def test_weights_round_trip_leaf_for_leaf(b0):
    v = b0["v"]
    sd = from_flax(v)
    back = to_flax(sd)
    flat = lambda t: {tuple(p.key for p in path): leaf  # noqa: E731
                      for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    for coll in ("params", "batch_stats"):
        want, got = flat(v[coll]), flat(back[coll])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    port = CMNeXtLegacy("CMNeXt-B0", CLASSES)
    port.load_state_dict(sd)  # every name, both ways
    assert set(from_flax(to_flax(port.state_dict()))) == set(port.state_dict())


def test_b5_parameter_shapes_match_jax():
    with torch.device("meta"):
        port = CMNeXtLegacy("CMNeXt-B5", 40)
    want, got = shapes_of(jax_build_model("CMNeXt", "CMNeXt-B5", num_classes=40), port)
    assert got == want
    assert sum(1 for k in got if k.startswith("backbone.block3_") and k.endswith(
        "attn.q.weight")) == 40


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

# the val split's size: at MSF scale 0.5 its stage-3 plane is 2x2 (a
# 1-pixel plane has no rpe grid: the bias functions raise there)
EH = EW = 128


def _cfg(backbone, msf=False):
    return _merge(DEFAULTS, {
        "MODEL": {"BACKBONE": backbone},
        "DATASET": {"NAME": "Synthetic", "ROOT": "",
                    "KWARGS": {"image_size": [EH, EW], "num_classes": CLASSES, "length": 2}},
        "TRAIN": {"AMP": False},
        "EVAL": {"MODEL_PATH": "", "IMAGE_SIZE": [EH, EW], "BATCH_SIZE": 2,
                 "MSF": {"ENABLE": msf, "FLIP": True, "SCALES": [0.5, 1.0]}},
    })


@pytest.mark.parametrize("backbone", ["CMNeXt-B0", "CMX-B0"])
def test_predictor_serves_a_legacy_model(backbone):
    pred = SemSegPredictor(device="cpu", dtype=torch.float32, seed=3, num_classes=CLASSES,
                           image_size=(H, W), backbone=backbone)
    assert isinstance(pred.model, CMNeXtLegacy) and not pred.model.upsample_logits
    g = np.random.RandomState(13)
    rgb, dep = (g.randint(0, 256, (2, H, W, 3)).astype(np.uint8) for _ in range(2))
    logits, labels = pred(rgb, dep)
    model = build_model("CMNeXt", backbone, CLASSES, seed=3, upsample_logits=False)
    predict = make_sliding_window_fn(model.forward_fused, (H, W), (H, W), CLASSES)
    with torch.no_grad():
        want = predict(*pred.normalize(rgb, dep))
    assert torch.equal(logits, want) and torch.equal(labels, want.argmax(-1))


@pytest.mark.parametrize("msf", [False, True], ids=["single-scale", "msf"])
def test_val_mm_evaluates_cmnext_b0(msf):
    """val_mm on a config naming CMNeXt-B0: its mIoU is the one of the same
    model's forward, run here directly over the val split."""
    from ir_ads_tpu_torch.evaluation.semseg_eval import make_forward_fn, msf_logits

    result = val_mm.main(_cfg("CMNeXt-B0", msf), device="cpu", seed=4)
    assert result["mode"] == ("msf" if msf else "single-scale")
    model = build_model("CMNeXt", "CMNeXt-B0", CLASSES, seed=4, upsample_logits=False)
    forward = make_forward_fn(model)
    ds = Synthetic("", "val", get_val_augmentation([EH, EW]), ["img", "depth"], length=2,
                   image_size=(EH, EW), num_classes=CLASSES)
    metrics = Metrics(CLASSES, 255)
    samples = [ds[i] for i in range(2)]
    rgb = torch.from_numpy(np.stack([s["img"] for s, _ in samples]))
    dte = torch.from_numpy(np.stack([s["depth"] for s, _ in samples]))
    label = torch.from_numpy(np.stack([lbl for _, lbl in samples]))
    if msf:
        probs = msf_logits(forward, rgb, dte, (0.5, 1.0))
    else:
        probs = torch.softmax(resize_bilinear(forward(rgb, dte), (EH, EW)).float(), dim=-1)
    metrics.update(probs.argmax(-1), label)
    assert result["miou"] == metrics.compute_iou()[1]


def test_infer_mm_predicts_with_cmnext_b0():
    """infer_mm's SemSeg on a config naming CMNeXt-B0: the colour image of
    the labels of the model's own forward, at the input's size."""
    from ir_ads_tpu_torch import infer_mm

    seg = infer_mm.SemSeg(_cfg("CMNeXt-B0"), device="cpu", seed=5)
    assert isinstance(seg.model, CMNeXtLegacy)
    rgb = np.random.RandomState(14).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    color, _ = seg.predict_array(rgb)
    assert color.shape == (50, 70, 3)
    x = np.random.RandomState(15).rand(EH, EW + 32, 3).astype(np.float32) * 255
    labels, _ = seg._labels(x, x)
    norm = (x / 255.0 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    with torch.no_grad():
        logits = seg.model.forward_fused(torch.from_numpy(norm.astype(np.float32))[None],
                                         torch.from_numpy(x / 255.0)[None].float())
    want = resize_bilinear(logits, (EH, EW + 32)).argmax(-1)[0].numpy()
    assert np.array_equal(labels, want)


def test_legacy_refusals(tmp_path):
    """What the legacy models refuse: the Swin options, flat frames, and
    train mode on a model built for an eval dispatch
    (tests/test_torch_legacy_train.py trains them under the train
    dispatch).  The DSCF variants dscf_pallas and dscf_pallas2 build, K17
    at every stage (tests/test_torch_legacy_dispatch.py holds them against
    JAX)."""
    for dispatch in ("dscf_pallas", "dscf_pallas2"):
        model = build_model("CMNeXt", "CMNeXt-B0", CLASSES, dispatch=dispatch)
        assert {m.deform_atten.attn_impl for m in model.backbone.DeformMPGBlocks} == {
            dispatch[len("dscf_"):]}
    with pytest.raises(ValueError, match="flat_input"):
        SemSegPredictor(device="cpu", backbone="CMNeXt-B0", flat_input=True)
    with pytest.raises(ValueError, match="patch_embed"):
        build_model("CMNeXt", "CMNeXt-B0", CLASSES, patch_embed="pallas")
    for key in ("dual_batch", "use_remat"):
        with pytest.raises(ValueError, match=key):
            build_model("CMNeXt", "CMNeXt-B0", CLASSES, backbone_kwargs={key: True})
    with pytest.raises(ValueError, match="head_dims"):
        SemSegPredictor(device="cpu", backbone="CMNeXt-B0", head_dims=(512, 256))
    cfg = _merge(_cfg("CMNeXt-B0"), {"SAVE_DIR": str(tmp_path),
                                     "MODEL": {"BACKBONE_KWARGS": {"use_remat": True}}})
    with pytest.raises(ValueError, match="use_remat"):
        train_mm.main(cfg, device="cpu")
    with pytest.raises(ValueError, match="head_dims"):
        SemSegTrainer(device="cpu", backbone="CMNeXt-B0", head_dims=(512, 256))
    model = build_model("CMNeXt", "CMNeXt-B0", CLASSES)
    with pytest.raises(NotImplementedError, match="dispatch='train'"):
        model.train()
    assert not model.training
    assert build_model("CMNeXt", "CMNeXt-B0", CLASSES, dispatch="train").train().training
    with pytest.raises(ValueError, match="flat"):
        model.forward_fused(torch.zeros(1, H, W * 3), torch.zeros(1, H, W * 3))

"""The detection stack's modules against the JAX package, one by one, on the
CPU in f32: the same numpy-seeded inputs and weights (carried across by
utils/jax_params.dino_from_flax) through the JAX function or flax module and
its counterpart in ir_ads_tpu_torch/detection/.  Tolerances: 1e-5 / 1e-6 for
elementwise functions; atol 2e-5 for single layers (f32 sums of another
order); atol 2e-3 / rtol 1e-3 for the deep ResNets, the whole-model bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import box_ops as jbox
from ir_ads_tpu.detection import dino as jdino
from ir_ads_tpu.detection import transformer as jtr
from ir_ads_tpu.models.backbones.resnet import ResNet as JaxResNet
from ir_ads_tpu_torch.detection import box_ops, dino
from ir_ads_tpu_torch.detection import transformer as tr
from ir_ads_tpu_torch.models.backbones.resnet import ARCHS, ResNet
from ir_ads_tpu_torch.utils.jax_params import dino_from_flax
from test_torch_model import random_variables

SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))
N_VALUE = sum(h * w for h, w in SHAPES)


def _boxes(rng, n):
    xy = rng.rand(n, 2).astype(np.float32) * 0.6
    wh = rng.rand(n, 2).astype(np.float32) * 0.4 + 0.01
    return np.concatenate([xy, xy + wh], -1)


def _load(module, variables, prefix):
    """The flax variables of one module, placed at ``prefix`` of the detector's
    tree (a tuple of flax names), through the bridge into ``module``."""
    def nest(tree):
        for name in reversed(prefix):
            tree = {name: tree}
        return tree

    sd = dino_from_flax({k: nest(v) for k, v in variables.items()})
    keys = list(module.state_dict())
    strip = len(next(iter(sd))) - max(
        len(k) for k in keys if next(iter(sd)).endswith(k))
    module.load_state_dict({name[strip:]: v for name, v in sd.items()})
    return module.eval()


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area",
                                "box_iou", "generalized_box_iou", "elementwise_giou",
                                "masks_to_boxes"])
def test_box_ops_match_jax(fn):
    rng = np.random.RandomState(20)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    if fn == "masks_to_boxes":
        masks = rng.rand(4, 9, 11) < 0.3
        masks[2] = False
        args = (masks,)
    elif fn in ("box_iou", "generalized_box_iou"):
        args = (a, b)
    elif fn == "elementwise_giou":
        args = (a, _boxes(rng, 7))
    else:
        args = (a,)
    want = getattr(jbox, fn)(*map(jnp.asarray, args))
    got = getattr(box_ops, fn)(*map(torch.from_numpy, args))
    if fn == "box_iou":
        want, got = jnp.stack(want), torch.stack(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_get_sine_pos_embed_matches_jax(k):
    pos = np.random.RandomState(21).rand(2, 9, k).astype(np.float32)
    want = jtr.get_sine_pos_embed(jnp.asarray(pos), 32)
    got = tr.get_sine_pos_embed(torch.from_numpy(pos), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("fn,args", [
    ("position_embedding_sine", (5, 7, 16)),
    ("make_encoder_reference_points", (SHAPES,)),
    ("make_output_proposals", (SHAPES,)),
])
def test_shape_constants_match_jax(fn, args):
    want, got = getattr(jtr, fn)(*args), getattr(tr, fn)(*args)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(g, w)


def test_inverse_sigmoid_matches_jax():
    x = np.concatenate([np.random.RandomState(22).rand(50), [0.0, 1.0, -0.2, 1.3, 5e-4]])
    x = x.astype(np.float32)
    want = jtr.inverse_sigmoid(jnp.asarray(x))
    np.testing.assert_allclose(tr.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)


def test_top_k_breaks_ties_like_jax():
    scores = np.asarray([[0.5, 2.0, 0.5, -np.inf, 2.0, 1.0, 0.5]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 5)
    got_v, got_i = tr.top_k(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("layers,out_dim", [(2, 64), (3, 4)])
def test_mlp_matches_flax(layers, out_dim):
    x = np.random.RandomState(23).randn(2, 7, 64).astype(np.float32)
    jmod = jtr.MLP(64, out_dim, layers)
    variables = random_variables(jmod, 23, jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    mod = _load(tr.MLP(64, 64, out_dim, layers), variables, ("transformer", "bbox_embed_0"))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_multihead_attention_matches_flax(masked):
    rng = np.random.RandomState(24)
    x = rng.randn(2, 11, 64).astype(np.float32)
    qpos = rng.randn(2, 11, 64).astype(np.float32)
    mask = rng.rand(11, 11) < 0.3 if masked else None
    if masked:
        mask[np.arange(11), np.arange(11)] = False
    jmod = jtr.MultiheadAttention(64, 8)
    variables = random_variables(jmod, 24, jnp.asarray(x))
    variables = jax.tree.map(lambda a: a * 4, variables)  # scores of order 1
    want = jmod.apply(variables, jnp.asarray(x), query_pos=jnp.asarray(qpos),
                      attn_mask=None if mask is None else jnp.asarray(mask))
    mod = _load(tr.MultiheadAttention(64, 8), variables,
                ("transformer", "decoder_0", "self_attn"))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), query_pos=torch.from_numpy(qpos),
                  attn_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def _layer_inputs(seed, lq, ref_dim):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, lq, 64).astype(np.float32)
    pos = rng.randn(2, lq, 64).astype(np.float32)
    ref = rng.rand(2, lq, 4, ref_dim).astype(np.float32)
    memory = rng.randn(2, N_VALUE, 64).astype(np.float32)
    return x, pos, ref, memory


def test_encoder_layer_matches_flax():
    x, pos, ref, _ = _layer_inputs(25, N_VALUE, 2)
    jmod = jtr.EncoderLayer(64, 8, 128, 4)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ref), SHAPES)
    variables = jax.tree.map(lambda a: a * 3, random_variables(jmod, 25, *args))
    want = jmod.apply(variables, *args)
    mod = _load(tr.EncoderLayer(64, 8, 128, 4), variables, ("transformer", "encoder_0"))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(ref), SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_decoder_layer_matches_flax(masked):
    x, pos, ref, memory = _layer_inputs(26, 13, 4)
    ref[..., 2:] *= 0.4
    mask = None
    if masked:
        mask = np.zeros((13, 13), bool)
        mask[:5, 5:] = True  # denoising queries do not see the matching ones
    jmod = jtr.DecoderLayer(64, 8, 128, 4)
    args = (jnp.asarray(x), jnp.asarray(memory), jnp.asarray(pos), jnp.asarray(ref), SHAPES)
    variables = jax.tree.map(lambda a: a * 3, random_variables(jmod, 26, *args))
    want = jmod.apply(variables, *args, None if mask is None else jnp.asarray(mask))
    mod = _load(tr.DecoderLayer(64, 8, 128, 4), variables, ("transformer", "decoder_0"))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(memory), torch.from_numpy(pos),
                  torch.from_numpy(ref), SHAPES,
                  None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_flax(arch):
    x = np.random.RandomState(27).randn(1, 64, 96, 3).astype(np.float32)
    jmod = JaxResNet(arch=arch, frozen_bn=True)
    variables = random_variables(jmod, 27, jnp.asarray(x))
    # conv weights ~ 1/fan_in keep the activations of order 1 through the depth
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: a / 0.05 / np.sqrt(np.prod(a.shape[:-1]))
        if path[-1].key == "kernel" else a, variables["params"])
    want = jmod.apply(variables, jnp.asarray(x))
    mod = _load(ResNet(arch), variables, ("backbone",))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert set(got) == set(want) == {"res2", "res3", "res4", "res5"}
    widths = [w * ARCHS[arch][0].expansion for w in ARCHS[arch][2]]
    for i, name in enumerate(("res2", "res3", "res4", "res5")):
        assert got[name].shape == (1, 16 >> i, 24 >> i, widths[i])
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=2e-3, rtol=1e-3)
        assert float(np.abs(np.asarray(want[name])).mean()) > 1e-3


@pytest.mark.parametrize("num_outs", [3, 4, 5])
def test_channel_mapper_matches_flax(num_outs):
    rng = np.random.RandomState(28)
    feats = [rng.randn(2, 8 >> i, 12 >> i, c).astype(np.float32)
             for i, c in enumerate((16, 32, 48))]
    jmod = jdino.ChannelMapper(64, num_outs)
    variables = random_variables(jmod, 28, [jnp.asarray(f) for f in feats])
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats])
    mod = _load(dino.ChannelMapper((16, 32, 48), 64, num_outs), variables, ("neck",))
    with torch.no_grad():
        got = mod([torch.from_numpy(f) for f in feats])
    assert len(got) == len(want) == num_outs
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("seed,iou_thresh", [(30, 0.7), (31, 0.5), (32, 0.3)])
def test_nms_topk_matches_jax(seed, iou_thresh):
    """Clustered boxes, so that suppression chains occur (a suppressed box
    must not suppress)."""
    rng = np.random.RandomState(seed)
    centres = rng.rand(2, 6, 2).astype(np.float32) * 0.6 + 0.2
    pick = rng.randint(0, 6, (2, 60))
    cxcy = np.take_along_axis(centres, pick[..., None], 1) + 0.03 * rng.randn(2, 60, 2)
    wh = 0.2 + 0.03 * rng.randn(2, 60, 2)
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    scores = rng.rand(2, 60).astype(np.float32)
    scores[:, 7] = scores[:, 3]  # a tie
    want = jdino.nms_topk(jnp.asarray(scores), jnp.asarray(boxes), 25, iou_thresh)
    got = dino.nms_topk(torch.from_numpy(scores), torch.from_numpy(boxes), 25, iou_thresh)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=0, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    assert 1 < int(got[2].sum()) < 50


def test_split_dn():
    t = torch.arange(2 * 3 * 7 * 4).reshape(2, 3, 7, 4)
    dn, match = dino.split_dn(t, 2)
    assert dn.shape == (2, 3, 2, 4) and match.shape == (2, 3, 5, 4)
    assert torch.equal(torch.cat([dn, match], 2), t)

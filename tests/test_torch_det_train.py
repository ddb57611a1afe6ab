"""DINO training on the port against the JAX package, on the CPU in f32.

The sizes are train_net ``--synthetic``'s (ResNet-18, embed 32, 1 + 1
layers, 20 queries, ``max_gt`` 4, dn 8) at 96x96.  PyTorch runs in one
thread.  Every random draw of the JAX side comes from a JAX key; the port
takes its draws as tensors, so the tests draw them from the same keys with
``jax.random`` and feed them in: the CDN flips, signs and parts
(``cdn.py``'s split of the key), the mask loss's point coordinates
(``point_sampled_mask_loss``'s split) and, for the whole step, the keys
``make_detection_train_step`` and ``detection_losses`` derive.  The
assignment is discontinuous, so the inputs are drawn with well-separated
matching costs (continuous random predictions, GT boxes apart).  Every
draw the file needs comes out of one jitted function (the ``jax_draws``
fixture), and every JAX reference is compiled with LLVM's cheap settings
(``FAST_COMPILE``: the same operations, no fast-math), which keeps the
file's XLA compiles short.
Tolerance: f32 atol 2e-3 / rtol 1e-3 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ir_ads_tpu.detection import cdn as jcdn
from ir_ads_tpu.detection import criterion as jcrit
from ir_ads_tpu.detection import dino as jdino
from ir_ads_tpu.detection import matcher as jmatch
from ir_ads_tpu.detection import train as jtrain
from ir_ads_tpu.ops.grid_sample import grid_sample as jgrid_sample
from ir_ads_tpu.ops.pallas_msdeform import ms_deform_attn_pallas
from ir_ads_tpu_torch.detection import cdn, criterion, matcher
from ir_ads_tpu_torch.detection.dino import DINODetector
from ir_ads_tpu_torch.detection.train import (
    DetTrainState, StepDraws, detection_losses, detection_optimizer, param_group,
)
from ir_ads_tpu_torch.ops import msdeform, msdeform_bwd
from ir_ads_tpu_torch.ops.grid_sample import grid_sample
from ir_ads_tpu_torch.utils.jax_params import dino_from_flax, dino_to_flax
from test_torch_model import random_variables

ATOL, RTOL = 2e-3, 1e-3
TINY = dict(num_classes=4, num_queries=20, embed_dim=32, num_encoder_layers=1,
            num_decoder_layers=1, backbone_arch="resnet18", dn_number=8, max_gt=4)
B, G, HW, MASK = 2, 4, 96, 32
N_GROUPS = cdn.cdn_groups(TINY["dn_number"], TINY["max_gt"])
STEP_RNG = 3407  # the whole step's key
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(f, **kw):
    return jax.jit(f, compiler_options=FAST_COMPILE, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _gt(seed=0):
    """Padded GT: boxes in separate cells of the image, labels, validity,
    masks of the boxes."""
    rs = np.random.RandomState(seed)
    cx = np.array([0.25, 0.75, 0.25, 0.75])[None] + rs.uniform(-0.05, 0.05, (B, G))
    cy = np.array([0.25, 0.25, 0.75, 0.75])[None] + rs.uniform(-0.05, 0.05, (B, G))
    wh = rs.uniform(0.15, 0.35, (B, G, 2))
    boxes = np.concatenate([np.stack([cx, cy], -1), wh], -1).astype(np.float32)
    labels = rs.randint(0, TINY["num_classes"], (B, G)).astype(np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    ys, xs = np.meshgrid((np.arange(MASK) + 0.5) / MASK, (np.arange(MASK) + 0.5) / MASK,
                         indexing="ij")
    masks = ((np.abs(xs[None, None] - boxes[..., 0, None, None]) < boxes[..., 2, None, None] / 2)
             & (np.abs(ys[None, None] - boxes[..., 1, None, None])
                < boxes[..., 3, None, None] / 2)).astype(np.float32)
    return labels, boxes, valid, masks * valid[..., None, None]


def _images(seed, n=B):
    return (np.random.RandomState(seed).rand(n, HW, HW, 3) * 255).astype(np.float32)


def _cdn_draws_jax(key, shape, num_classes=TINY["num_classes"]):
    """cdn.py's draws from ``key`` (its split at :58)."""
    k_label, k_sign, k_part = jax.random.split(key, 3)
    return dict(p=jax.random.uniform(k_label, shape),
                rand_label=jax.random.randint(k_label, shape, 0, num_classes),
                sign=jax.random.randint(k_sign, shape + (4,), 0, 2).astype(jnp.float32) * 2 - 1,
                part=jax.random.uniform(k_part, shape + (4,)))


def _point_draws_jax(key, n, num_points=12544, oversample=3.0, importance_ratio=0.75):
    """point_sampled_mask_loss's draws from ``key``."""
    n_random = num_points - int(importance_ratio * num_points)
    k1, k2 = jax.random.split(key)
    return (jax.random.uniform(k1, (n, int(num_points * oversample), 2)),
            jax.random.uniform(k2, (n, n_random, 2)))


def _layer_point_draws_jax(key, n_layers, num_points=12544):
    """``detection_losses``' draws: one split of ``key`` a prediction set."""
    out = []
    for _ in range(n_layers):
        key, sub = jax.random.split(key)
        out.append(_point_draws_jax(sub, B * G, num_points))
    return out


def _to_torch(tree):
    """JAX's draws as the port takes them (random labels as int64)."""
    if isinstance(tree, dict):
        out = {k: _t(v) for k, v in tree.items()}
        out["rand_label"] = out["rand_label"].long()
        return out
    if isinstance(tree, list):
        return [_to_torch(x) for x in tree]
    return tuple(_t(x) for x in tree)


@pytest.fixture(scope="module")
def jax_draws(flax_model):
    """Every JAX draw of the file, made in one compile: the CDN test's, the
    train forward's and the whole step's CDN draws (the step's from the key
    ``make_rng("cdn")`` gives the detector), the mask loss tests' points and
    the step's per-layer points."""
    model, variables, _ = flax_model
    shape = (B, N_GROUPS, 2, G)

    def make(variables):
        cdn_key = lambda key: _cdn_key(model, variables, key)  # noqa: E731
        step_cdn, step_loss = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(STEP_RNG), 0))
        return dict(
            cdn=_cdn_draws_jax(jax.random.PRNGKey(11), shape),
            forward=_cdn_draws_jax(cdn_key(jax.random.PRNGKey(7)), shape),
            set_criterion=_point_draws_jax(jax.random.PRNGKey(21), B * G),
            point_loss=_point_draws_jax(jax.random.PRNGKey(5), B * G, 500),
            losses=_layer_point_draws_jax(jax.random.PRNGKey(17), 2, 300),
            step=(_cdn_draws_jax(cdn_key(step_cdn), shape),
                  _layer_point_draws_jax(step_loss, TINY["num_decoder_layers"] + 1)))

    out = _jit(make)(variables)
    return {k: StepDraws(*(_to_torch(x) for x in v)) if k == "step" else _to_torch(v)
            for k, v in out.items()}


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


# --------------------------------------------------------------------------
# K9's backward, the gather grid_sample
# --------------------------------------------------------------------------

K9_CASES = [(((12, 16), (6, 8), (3, 4)), 2, 4, 8, 37, 3),
            (((8, 8), (4, 4), (2, 2), (1, 1)), 2, 8, 4, 23, 4)]


@pytest.mark.parametrize("shapes,bs,heads,d,lq,points", K9_CASES)
def test_k9_backward_plain_matches_jax_vjp(shapes, bs, heads, d, lq, points):
    """``ms_deform_attn_bwd_plain`` against ``jax.vjp`` of the interpreted
    Pallas K9 (whose ``_bwd`` is the XLA reference's vjp), locations in
    [-0.3, 1.3]: corners out of bounds on every side; and the wrapper's
    gradient on CPU tensors (autograd through ``MSDeformAttnFunction``) is
    the plain backward's."""
    rs = np.random.RandomState(3)
    s = sum(h * w for h, w in shapes)
    value = rs.randn(bs, s, heads, d).astype(np.float32)
    loc = (rs.rand(bs, lq, heads, len(shapes), points, 2) * 1.6 - 0.3).astype(np.float32)
    w = rs.rand(bs, lq, heads, len(shapes), points).astype(np.float32)
    g = rs.randn(bs, lq, heads * d).astype(np.float32)
    out = (loc < 0) | (loc > 1)
    assert out[..., 0].any() and out[..., 1].any()
    want = _jit(lambda v, l, a, c: jax.vjp(
        lambda *x: ms_deform_attn_pallas(x[0], shapes, x[1], x[2], True), v, l, a)[1](c))(
        *(jnp.asarray(x) for x in (value, loc, w, g)))
    got = msdeform_bwd.ms_deform_attn_bwd_plain(_t(value), shapes, _t(loc), _t(w), _t(g))
    for name, a, b in zip(("dvalue", "dlocations", "dweights"), got, want):
        _close(a.numpy(), b, name, atol=1e-4, rtol=1e-4)
    leaves = [_t(x).requires_grad_() for x in (value, loc, w)]
    msdeform.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).backward(_t(g))
    for leaf, ref in zip(leaves, got):
        assert torch.equal(leaf.grad, ref)
    assert msdeform_bwd.KERNEL.launches == 0


def test_gather_grid_sample_matches_jax():
    rs = np.random.RandomState(4)
    img = rs.randn(2, 9, 11, 3).astype(np.float32)
    grid = (rs.rand(2, 5, 7, 2) * 2.4 - 1.2).astype(np.float32)
    g = rs.randn(2, 5, 7, 3).astype(np.float32)
    for align in (True, False):
        f = lambda i, q: jgrid_sample(i, q, align_corners=align)  # noqa: E731
        want, (d_img, d_grid) = _jit(lambda i, q, c: (f(i, q), jax.vjp(f, i, q)[1](c)))(
            jnp.asarray(img), jnp.asarray(grid), jnp.asarray(g))
        ti, tg = _t(img).requires_grad_(), _t(grid).requires_grad_()
        got = grid_sample(ti, tg, align_corners=align)
        got.backward(_t(g))
        _close(got.detach().numpy(), want, f"forward align={align}", 1e-5, 1e-5)
        _close(ti.grad.numpy(), d_img, f"d img align={align}", 1e-5, 1e-5)
        _close(tg.grad.numpy(), d_grid, f"d grid align={align}", 1e-4, 1e-4)


# --------------------------------------------------------------------------
# CDN, matchers
# --------------------------------------------------------------------------

def test_cdn_mask_and_queries_match_jax(jax_draws):
    for args in ((4, 2, 20), (20, 5, 2000), (3, 1, 7)):
        assert np.array_equal(cdn.make_cdn_attn_mask(*args), jcdn.make_cdn_attn_mask(*args))
    labels, boxes, valid, _ = _gt(1)
    table = np.random.RandomState(5).randn(TINY["num_classes"], 32).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_q, want_r = _jit(lambda *a: jcdn.generate_cdn_queries(
        *a, key, N_GROUPS, num_classes=TINY["num_classes"]))(
        jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(table))
    got_q, got_r = cdn.generate_cdn_queries(_t(labels).long(), _t(boxes), _t(valid), _t(table),
                                            jax_draws["cdn"], N_GROUPS)
    _close(got_q.numpy(), want_q, "queries", 1e-6, 1e-6)
    _close(got_r.numpy(), want_r, "references", 1e-5, 1e-5)
    gen = torch.Generator().manual_seed(0)
    d = cdn.cdn_draws(gen, (B, N_GROUPS, 2, G), TINY["num_classes"])
    assert d["rand_label"].max() < TINY["num_classes"] and set(d["sign"].unique().tolist()) <= {-1.0, 1.0}


def _tie_free_cost(rs, b, q, g):
    return (rs.permutation(b * q * g).reshape(b, q, g) / (b * q * g)).astype(np.float32)


def test_matchers_match_jax():
    rs = np.random.RandomState(6)
    cost = _tie_free_cost(rs, 3, 30, 7)
    want_r, want_c = jmatch.hungarian_match(jnp.asarray(cost), impl="callback")
    got_r, got_c = matcher.hungarian_match(_t(cost), impl="scipy")
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(matcher.hungarian_match(_t(cost), impl="auto")[0], got_r)
    want_a = _jit(jmatch.auction_match)(jnp.asarray(cost))
    got_a, iters = matcher.auction_solve(_t(cost))
    assert np.array_equal(got_a.numpy(), np.asarray(want_a))
    assert len(iters) == 3 and 0 < max(iters) < 200
    # the consistency loss's shape, Q = Qt, with teacher slots not kept
    cost = _tie_free_cost(rs, 2, 48, 48)
    cost[:, :, 40:] = 1e8
    want_a = _jit(jmatch.auction_match)(jnp.asarray(cost))
    got_a = matcher.auction_match(_t(cost))
    assert np.array_equal(got_a.numpy(), np.asarray(want_a))
    assert np.array_equal(matcher.hungarian_match(_t(cost), "scipy")[0][:, :40].numpy(),
                          np.asarray(jmatch.hungarian_match(jnp.asarray(cost),
                                                            "callback")[0])[:, :40])
    with pytest.raises(ValueError):
        matcher.hungarian_match(_t(cost), "callback")


def test_match_cost_matches_jax():
    rs = np.random.RandomState(7)
    labels, boxes, valid, _ = _gt(2)
    logits = rs.randn(B, 20, TINY["num_classes"]).astype(np.float32)
    pboxes = rs.rand(B, 20, 4).astype(np.float32) * 0.5 + 0.1
    want = _jit(jmatch.match_cost)(
        *(jnp.asarray(x) for x in (logits, pboxes, labels, boxes, valid)))
    got = matcher.match_cost(_t(logits), _t(pboxes), _t(labels).long(), _t(boxes), _t(valid))
    valid_cols = np.broadcast_to(valid[:, None, :], got.shape)
    _close(got.numpy()[valid_cols], np.asarray(want)[valid_cols], "cost", 1e-5, 1e-5)
    assert np.all(got.numpy()[~valid_cols] == 1e8)


# --------------------------------------------------------------------------
# criterion
# --------------------------------------------------------------------------

def _predictions(seed, q, d_seg=16):
    rs = np.random.RandomState(seed)
    return dict(
        logits=rs.randn(B, q, TINY["num_classes"]).astype(np.float32),
        boxes=np.concatenate([rs.rand(B, q, 2) * 0.8 + 0.1, rs.rand(B, q, 2) * 0.3 + 0.1],
                             -1).astype(np.float32),
        embeds=rs.randn(B, q, d_seg).astype(np.float32),
        seg=rs.randn(B, 8 * 8, d_seg).astype(np.float32),
    )


def _torch_leaves(pred):
    return {k: _t(v).requires_grad_() for k, v in pred.items()}


def test_set_criterion_matches_jax(jax_draws):
    """Hungarian losses with the mask-embeds path and the point draws of
    JAX's key; values and gradients with respect to the predictions."""
    labels, boxes, valid, masks = _gt(3)
    pred = _predictions(8, 20)
    key = jax.random.PRNGKey(21)

    def jax_loss(p):
        out = jcrit.set_criterion(p["logits"], p["boxes"], jnp.asarray(labels),
                                  jnp.asarray(boxes), jnp.asarray(valid), gt_masks=jnp.asarray(masks),
                                  mask_key=key, mask_embeds=p["embeds"], seg_feat=p["seg"],
                                  seg_hw=(8, 8))
        return sum(out.values()), out

    (_, want), grads = _jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in pred.items()})
    leaves = _torch_leaves(pred)
    got = criterion.set_criterion(
        leaves["logits"], leaves["boxes"], _t(labels).long(), _t(boxes), _t(valid),
        gt_masks=_t(masks), mask_draws=jax_draws["set_criterion"],
        mask_embeds=leaves["embeds"], seg_feat=leaves["seg"], seg_hw=(8, 8))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].item(), want[k], k)
    sum(got.values()).backward()
    for k in pred:
        _close(leaves[k].grad.numpy(), grads[k], f"d {k}")


def test_point_sampled_mask_loss_matches_jax(jax_draws):
    _, _, valid, masks = _gt(4)
    pm = np.random.RandomState(9).randn(B, G, 16, 16).astype(np.float32)
    key = jax.random.PRNGKey(5)
    nb = jcrit.num_boxes_of(jnp.asarray(valid))

    def jax_loss(p):
        ce, dice = jcrit.point_sampled_mask_loss(p, jnp.asarray(masks), jnp.asarray(valid), nb,
                                                 key, num_points=500)
        return ce + 2 * dice, (ce, dice)

    (_, (ce, dice)), grad = _jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(pm))
    leaf = _t(pm).requires_grad_()
    got_ce, got_dice = criterion.point_sampled_mask_loss(
        leaf, _t(masks), _t(valid), criterion.num_boxes_of(_t(valid)),
        jax_draws["point_loss"], num_points=500)
    _close(got_ce.item(), ce, "ce")
    _close(got_dice.item(), dice, "dice")
    (got_ce + 2 * got_dice).backward()
    _close(leaf.grad.numpy(), grad, "d masks")
    draws = criterion.mask_point_draws(torch.Generator().manual_seed(0), 3, 500)
    assert draws[0].shape == (3, 1500, 2) and draws[1].shape == (3, 125, 2)


def test_dn_and_consistency_losses_match_jax():
    labels, boxes, valid, _ = _gt(5)
    n_dn = 2 * G * N_GROUPS
    pred = _predictions(10, n_dn)
    dn_in = {k: pred[k] for k in ("logits", "boxes")}

    def jax_dn(p):
        out = jcrit.dn_criterion(p["logits"], p["boxes"], jnp.asarray(labels), jnp.asarray(boxes),
                                 jnp.asarray(valid), N_GROUPS)
        return sum(out.values()), out

    (_, want), grads = _jit(jax.value_and_grad(jax_dn, has_aux=True))(
        {k: jnp.asarray(v) for k, v in dn_in.items()})
    leaves = _torch_leaves(dn_in)
    got = criterion.dn_criterion(leaves["logits"], leaves["boxes"], _t(labels).long(),
                                 _t(boxes), _t(valid), N_GROUPS)
    for k in want:
        _close(got[k].item(), want[k], k)
    sum(got.values()).backward()
    for k in dn_in:
        _close(leaves[k].grad.numpy(), grads[k], f"d {k}")

    rs = np.random.RandomState(11)
    sq = rs.randn(B, 24, 32).astype(np.float32)
    tq = rs.randn(B, 24, 32).astype(np.float32)
    sb = np.concatenate([rs.rand(B, 24, 2) * 0.8 + 0.1, rs.rand(B, 24, 2) * 0.3 + 0.1], -1)
    tb = np.concatenate([rs.rand(B, 24, 2) * 0.8 + 0.1, rs.rand(B, 24, 2) * 0.3 + 0.1], -1)
    sb, tb = sb.astype(np.float32), tb.astype(np.float32)
    tv = rs.rand(B, 24) > 0.4
    want, grad = _jit(jax.value_and_grad(lambda q: jcrit.consistency_loss(
        q, jnp.asarray(tq), jnp.asarray(tb), jnp.asarray(sb), jnp.asarray(tv))))(jnp.asarray(sq))
    leaf = _t(sq).requires_grad_()
    got = criterion.consistency_loss(leaf, _t(tq), _t(tb), _t(sb), _t(tv))
    _close(got.item(), want, "consistency")
    got.backward()
    _close(leaf.grad.numpy(), grad, "d student queries")


def test_detection_losses_match_jax(jax_draws):
    """The loop form over a decoder layer and the encoder stage, CDN part
    included, with JAX's per-layer keys."""
    labels, boxes, valid, masks = _gt(6)
    n_dn, q = 2 * G * N_GROUPS, 20
    rs = np.random.RandomState(12)
    outs = dict(
        pred_logits=rs.randn(1, B, n_dn + q, TINY["num_classes"]),
        pred_boxes=np.concatenate([rs.rand(1, B, n_dn + q, 2) * 0.8 + 0.1,
                                   rs.rand(1, B, n_dn + q, 2) * 0.3 + 0.1], -1),
        pred_mask_embeds=rs.randn(1, B, n_dn + q, 16),
        enc_logits=rs.randn(B, q, TINY["num_classes"]),
        enc_boxes=np.concatenate([rs.rand(B, q, 2) * 0.8 + 0.1, rs.rand(B, q, 2) * 0.3 + 0.1],
                                 -1),
        enc_mask_embed=rs.randn(B, q, 16),
        seg_feat=rs.randn(B, 64, 16))
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    static = dict(seg_hw=(8, 8), n_dn=n_dn, n_groups=N_GROUPS)
    key = jax.random.PRNGKey(17)

    def jax_loss(o):
        out = jtrain.detection_losses({**o, **static}, jnp.asarray(labels), jnp.asarray(boxes),
                                      jnp.asarray(valid), jnp.asarray(masks), key,
                                      mask_loss_points=300)
        return sum(out.values()), out

    (_, want), grads = _jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outs.items()})
    leaves = _torch_leaves(outs)
    got = detection_losses({**leaves, **static}, _t(labels).long(), _t(boxes), _t(valid),
                           _t(masks), jax_draws["losses"], mask_loss_points=300)
    assert set(got) == set(want)
    for name in want:
        _close(got[name].item(), want[name], name)
    sum(got.values()).backward()
    for name in outs:
        _close(leaves[name].grad.numpy(), grads[name], f"d {name}")


# --------------------------------------------------------------------------
# the model, the step, the weights
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_model():
    """The flax detector, numpy-seeded variables (kernels ~ N(0, 1/fan_in))
    and the port's detector carrying them."""
    model = jdino.DINODetector(**TINY)
    labels, boxes, valid, _ = _gt(0)
    args = (jnp.asarray(_images(1)), jnp.asarray(labels), jnp.asarray(boxes),
            jnp.asarray(valid), True)
    variables = random_variables(model, 41, *args)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (a / 0.05 / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        if path[-1].key == "kernel" else a, variables["params"])
    port = DINODetector(**TINY)
    port.load_state_dict(dino_from_flax(variables))
    return model, variables, port


def _cdn_key(model, variables, key):
    """The key ``make_rng("cdn")`` gives DINODetector's forward."""
    return model.apply(variables, method=lambda m: m.make_rng("cdn"), rngs={"cdn": key})


def test_train_forward_matches_flax(flax_model, jax_draws):
    model, variables, port = flax_model
    labels, boxes, valid, _ = _gt(0)
    img = _images(1)
    key = jax.random.PRNGKey(7)
    out, mut = _jit(lambda v, *a: model.apply(v, *a, train=True, rngs={"cdn": key},
                                              mutable=["batch_stats"]))(
        variables, jnp.asarray(img), jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid))
    draws = jax_draws["forward"]
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    try:
        got = port(_t(img), _t(labels).long(), _t(boxes), _t(valid), cdn_draws=draws)
        stats = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    finally:
        port.load_state_dict(sd)
        port.eval()
    assert set(got) == set(out)
    for k in ("n_dn", "n_groups", "seg_hw"):
        assert got[k] == out[k], k
    for k in out:
        if k not in ("n_dn", "n_groups", "seg_hw"):
            _close(got[k].detach().numpy(), out[k], k)
    want_stats = dino_from_flax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, mut["batch_stats"])})
    for k, v in want_stats.items():
        if "running" not in k:
            continue
        if k.startswith("mapping_fpn_features_for_seg"):
            _close(stats[k].numpy(), v.numpy(), k)
        else:  # the backbone's stay frozen
            assert torch.equal(stats[k], v), k


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _first_moments(opt_state):
    """optax's ``mu`` after the step, all groups merged, as a flax tree of
    numpy arrays (the masked-out leaves dropped)."""
    def merge(dst, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            elif not isinstance(v, optax.MaskedNode):
                dst[k] = np.asarray(v)

    out = {}
    for st in opt_state[1].inner_states.values():
        merge(out, st.inner_state[0].mu)
    return out


def test_whole_step_matches_jax(flax_model, jax_draws):
    """One f32 step with the EMA teacher against the jitted
    ``make_detection_train_step``: the losses; the clipped gradients (the
    first moments / 0.1) leaf by leaf, ||diff|| <= 1e-3 ||ref|| + 1e-8; the
    updated parameters at 1e-6 (a wrong update moves one by lr >= 2e-5)
    element by element where the gradient is clear of the leaf's noise
    floor (|mu| > 1e-2 max |mu| and > 1e-8: Adam's first step is about
    sign(g), so an
    element at the floor may flip); the EMA and the segmentation map's
    batch statistics."""
    model, variables, port = flax_model
    labels, boxes, valid, masks = _gt(0)
    strong, weak = _images(2), _images(3)
    rng = jax.random.PRNGKey(STEP_RNG)
    tx = jtrain.detection_optimizer(variables["params"])
    jstate = jtrain.DetTrainState.create(model.apply, variables["params"],
                                         variables["batch_stats"], tx)
    batch = (strong, weak, labels, boxes, valid, masks)
    new, metrics = _jit(jtrain.make_detection_train_step())(
        jstate, tuple(jnp.asarray(x) for x in batch), rng)

    state = DetTrainState.create(port, dtype=torch.float32)
    got = state.train_step([_t(strong), _t(weak), _t(labels).long(), _t(boxes), _t(valid),
                            _t(masks)], jax_draws["step"])
    assert set(got) == set(metrics)
    assert float(got["loss_consistency"]) > 0
    for k in metrics:
        _close(float(got[k]), metrics[k], k)

    want_params = dino_from_flax({"params": jax.tree.map(np.asarray, new.params)})
    want_ema = dino_from_flax({"params": jax.tree.map(np.asarray, new.ema_params)})
    want_mu = dino_from_flax({"params": _first_moments(new.opt_state)})
    assert set(want_mu) == set(state.params)
    for k, v in state.params.items():
        mu, mu_want = state.opt.state[v]["exp_avg"], want_mu[k]
        # a leaf whose exact gradient is 0 (a bias a softmax or a norm
        # cancels) carries rounding noise of order 1e-12
        assert float((mu - mu_want).norm()) <= 1e-3 * float(mu_want.norm()) + 1e-8, k
        live = (mu_want.abs() > max(1e-2 * float(mu_want.abs().max()), 1e-8)).numpy()
        _close(v.detach().numpy()[live], want_params[k].numpy()[live], f"update {k}", 1e-6,
               1e-6)
        _close(state.ema_params[k].numpy(), want_ema[k].numpy(), f"ema {k}", 1e-6, 1e-6)
    want_stats = dino_from_flax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, new.batch_stats)})
    for k, v in want_stats.items():
        if "running" in k:
            _close(state.stats[k].numpy(), v.numpy(), k)


def test_weights_round_trip_both_ways(flax_model, tmp_path):
    """``dino_to_flax(dino_from_flax(v)) == v``; the port's weights.msgpack
    read by JAX's ``load_weights`` and JAX's read by the port."""
    from ir_ads_tpu.utils.checkpoint import load_weights as jax_load, save_weights as jax_save
    from ir_ads_tpu_torch.utils.checkpoint import load_dino_weights, save_dino_weights

    _, variables, port = flax_model
    want = _flat(variables)
    back = _flat(dino_to_flax(dino_from_flax(variables)))
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) and back[k].dtype == want[k].dtype
               for k in want)
    save_dino_weights(str(tmp_path / "port.msgpack"), port.state_dict())
    template = jax.tree.map(np.zeros_like, variables)
    read = _flat(jax_load(str(tmp_path / "port.msgpack"), template))
    assert all(np.array_equal(read[k], want[k]) for k in want)
    jax_save(str(tmp_path / "jax.msgpack"), variables["params"], variables["batch_stats"])
    sd = load_dino_weights(str(tmp_path / "jax.msgpack"))
    ref = port.state_dict()
    assert set(sd) == set(ref)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_optimizer_and_ema_match_optax():
    """``detection_optimizer`` after ``clip_by_global_norm_`` against the
    JAX ``detection_optimizer`` (clip by the global norm, AdamW per group,
    decay on every leaf) over three steps, a gradient above the clip bound
    and one below, a leaf with a zero gradient; ``ema_update`` against the
    JAX one."""
    from ir_ads_tpu.detection.ema import ema_update as jax_ema
    from ir_ads_tpu_torch.detection.ema import ema_init, ema_update
    from ir_ads_tpu_torch.training.optim import clip_by_global_norm_

    rs = np.random.RandomState(13)
    params = {"backbone": {"res2": {"w": rs.randn(4, 3)}},
              "transformer": {"sampling_offsets": {"bias": rs.randn(6)}, "w": rs.randn(5)},
              "label_enc": rs.randn(2, 3)}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    names = {"backbone.res2.w": ("backbone", "res2", "w"),
             "transformer.sampling_offsets.bias": ("transformer", "sampling_offsets", "bias"),
             "transformer.w": ("transformer", "w"), "label_enc": ("label_enc",)}

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    tx = jtrain.detection_optimizer(params)
    opt_state, jp = tx.init(params), params
    tp = {k: _t(get(params, v)).requires_grad_() for k, v in names.items()}
    assert [param_group(k) for k in names] == ["backbone", "offsets", "rest", "rest"]
    opt = detection_optimizer(tp)
    update = _jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    for step, scale in enumerate((1.0, 1e-3, 0.5)):
        grads = jax.tree.map(lambda a: (scale * rs.randn(*a.shape)).astype(np.float32), params)
        grads["label_enc"] = np.zeros_like(params["label_enc"])
        jp, opt_state = update(grads, opt_state, jp)
        for k, v in names.items():
            tp[k].grad = _t(get(grads, v))
        clip_by_global_norm_(tp.values(), 0.1)
        opt.step()
        for k, v in names.items():
            _close(tp[k].detach().numpy(), get(jp, v), f"step {step} {k}", 1e-6, 1e-6)
    ema = ema_init(tp)
    got = ema_update(ema, {k: v.detach() + 1.0 for k, v in tp.items()}, 0.9)
    want = jax_ema({k: jnp.asarray(v.numpy()) for k, v in ema.items()},
                   {k: jnp.asarray(v.numpy() + 1.0) for k, v in ema.items()}, 0.9)
    for k in got:
        _close(got[k].numpy(), want[k], f"ema {k}", 1e-7, 1e-7)

"""The port's detectron2 projects (models/projects/{deeplab,panoptic_deeplab,
point_rend,pointsup,densepose,tridentnet,tensormask,precise_bn}.py) and the
vector quantizer (ops/quantize.py) against the JAX package's on the CPU in
f32 at tiny widths, weights carried by utils/jax_params.library_from_flax.

Train mode holds the batch statistics and their running updates (dropout at
1e-12 on both sides: every element kept).  The random draws of PointRend's
training sampler and of the quantizer's dead-code reassignment are made by
``jax.random`` as the JAX functions make them and given to the port as
tensors.  The panoptic fusion is held exactly (ids and centres)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models.projects import deeplab as jdl
from ir_ads_tpu.models.projects import densepose as jdp
from ir_ads_tpu.models.projects import panoptic_deeplab as jpd
from ir_ads_tpu.models.projects import point_rend as jpr
from ir_ads_tpu.models.projects import pointsup as jps
from ir_ads_tpu.models.projects import precise_bn as jpbn
from ir_ads_tpu.models.projects import tensormask as jtm
from ir_ads_tpu.models.projects import tridentnet as jtn
from ir_ads_tpu.ops import quantize as jq
from ir_ads_tpu_torch.models.projects import deeplab as tdl
from ir_ads_tpu_torch.models.projects import densepose as tdp
from ir_ads_tpu_torch.models.projects import panoptic_deeplab as tpd
from ir_ads_tpu_torch.models.projects import point_rend as tpr
from ir_ads_tpu_torch.models.projects import pointsup as tps
from ir_ads_tpu_torch.models.projects import precise_bn as tpbn
from ir_ads_tpu_torch.models.projects import tensormask as ttm
from ir_ads_tpu_torch.models.projects import tridentnet as ttn
from ir_ads_tpu_torch.ops import quantize as tq
from ir_ads_tpu_torch.utils.jax_params import library_from_flax
from tests.test_torch_heads import FAST_COMPILE, check_stats, close, port_of, run_jax
from tests.test_torch_meta_arch import random_variables

DROP = 1e-12
DIMS = (8, 12, 16)
SIZES = ((16, 20), (8, 10), (4, 5))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats(seed, b=2, dims=DIMS, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, c).astype(np.float32) for c, (h, w) in zip(dims, sizes)]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_deeplab_heads_match_jax(train):
    feats = _feats(0)
    v3 = jdl.DeepLabV3Head(num_classes=5, aspp_channels=16, dilations=(1, 2, 3), dropout=DROP)
    v3p = jdl.DeepLabV3PlusHead(num_classes=5, project_channels=(6, 8),
                                decoder_channels=(12, 12, 16), dilations=(1, 2, 3),
                                dropout=DROP)
    v3p_dw = jdl.DeepLabV3PlusHead(num_classes=5, project_channels=(6, 8),
                                   decoder_channels=(12, 12, 16), dilations=(1, 2, 3),
                                   dropout=DROP, use_depthwise_separable_conv=True)
    cases = [
        (v3, (feats[-1],), tdl.DeepLabV3Head(16, 5, 16, (1, 2, 3), dropout=DROP)),
        (v3p, (feats,), tdl.DeepLabV3PlusHead(DIMS, 5, (6, 8), (12, 12, 16), (1, 2, 3),
                                              dropout=DROP)),
        (v3p_dw, (feats,), tdl.DeepLabV3PlusHead(DIMS, 5, (6, 8), (12, 12, 16), (1, 2, 3),
                                                 dropout=DROP,
                                                 use_depthwise_separable_conv=True)),
    ]
    for i, (jm, args, port) in enumerate(cases):
        v = random_variables(jm, 1 + i, *args)
        want, upd = run_jax(jm, v, *args, train=train)
        port = port_of(port, v).train(train)
        targs = [_t(a) if isinstance(a, list) else torch.from_numpy(a) for a in args]
        with torch.no_grad():
            got = port(*targs, generator=torch.Generator().manual_seed(0))
        close(got, want)
        check_stats(port, upd)


def test_deeplab_ce_loss_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 9, 11, 5).astype(np.float32) * 2
    labels = rng.randint(0, 5, (2, 9, 11)).astype(np.int32)
    labels[rng.rand(2, 9, 11) < 0.2] = 255
    weights = rng.rand(2, 9, 11).astype(np.float32)
    for top, w in ((1.0, None), (0.2, None), (0.3, weights)):
        want = jdl.deeplab_ce_loss(logits, labels, 255, top, w)
        got = tdl.deeplab_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), 255, top,
                                  None if w is None else torch.from_numpy(w))
        close(got, want)


def test_panoptic_deeplab_heads_and_losses_match_jax():
    feats = _feats(3)
    sem = jpd.PanopticDeepLabSemSegHead(num_classes=5, head_channels=12,
                                        project_channels=(6, 8), decoder_channels=(12, 12, 16))
    ins = jpd.PanopticDeepLabInsEmbedHead(head_channels=8, project_channels=(6, 8),
                                          decoder_channels=(12, 12, 16))
    vs = random_variables(sem, 4, feats)
    vi = random_variables(ins, 5, feats)
    want_sem, _ = run_jax(sem, vs, feats)
    (want_c, want_o), _ = run_jax(ins, vi, feats)
    tsem = port_of(tpd.PanopticDeepLabSemSegHead(DIMS, 5, 12, (6, 8), (12, 12, 16)), vs).eval()
    tins = port_of(tpd.PanopticDeepLabInsEmbedHead(DIMS, 8, (6, 8), (12, 12, 16)), vi).eval()
    with torch.no_grad():
        got_sem = tsem(_t(feats))
        got_c, got_o = tins(_t(feats))
    for g, w in ((got_sem, want_sem), (got_c, want_c), (got_o, want_o)):
        close(g, w)

    rng = np.random.RandomState(6)
    h, w = want_sem.shape[1:3]
    sem_t = rng.randint(0, 5, (2, h, w)).astype(np.int32)
    sem_t[:, :3] = 255
    ctr_t = rng.rand(2, h, w).astype(np.float32)
    off_t = rng.randn(2, h, w, 2).astype(np.float32)
    sw = rng.rand(2, h, w).astype(np.float32)
    want = jpd.panoptic_deeplab_losses(want_sem, want_c, want_o, sem_t, ctr_t, off_t,
                                       sem_weights=sw, center_weights=sw)
    got = tpd.panoptic_deeplab_losses(got_sem, got_c, got_o, *_t([sem_t, ctr_t, off_t]),
                                      sem_weights=torch.from_numpy(sw),
                                      center_weights=torch.from_numpy(sw))
    for k in want:
        close(got[k], want[k])


def test_panoptic_segmentation_is_exact():
    """Centres as gaussian peaks (two of them one pixel apart, one below the
    threshold), offsets pointing to them with noise, stuff and thing classes."""
    h, w = 48, 64
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    peaks = [(10, 12, 0.9), (30, 40, 0.8), (30, 41, 0.7), (40, 8, 0.6), (5, 55, 0.05)]
    heat = sum(a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 18.0) for y, x, a in peaks)
    heat = (heat + 0.01 * rng.rand(h, w)).astype(np.float32)
    near = np.argmin([(yy - y) ** 2 + (xx - x) ** 2 for y, x, _ in peaks[:4]], 0)
    cy = np.array([p[0] for p in peaks[:4]], np.float32)[near]
    cx = np.array([p[1] for p in peaks[:4]], np.float32)[near]
    offsets = np.stack([cy - yy, cx - xx], -1) + rng.randn(h, w, 2).astype(np.float32)
    sem = rng.randint(0, 6, (h, w)).astype(np.int32)
    sem[:24] = np.where(rng.rand(24, w) < 0.8, 1, sem[:24])  # a large thing region
    sem[24:, :20] = 4  # a large stuff region
    thing = np.array([False, True, True, False, False, True])
    for kw in (dict(stuff_area=100, top_k=10), dict(stuff_area=100000, top_k=4)):
        want = jax.jit(lambda *a: jpd.get_panoptic_segmentation(*a, **kw),
                       compiler_options=FAST_COMPILE)(sem, heat, offsets, thing)
        got = tpd.get_panoptic_segmentation(torch.from_numpy(sem), torch.from_numpy(heat),
                                            torch.from_numpy(offsets), torch.from_numpy(thing),
                                            **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert len(np.unique(np.asarray(want[0]))) > 3


def test_point_rend_matches_jax():
    rng = np.random.RandomState(8)
    r, c, k = 5, 6, 3
    pooled = rng.randn(r, 8, 8, 12).astype(np.float32)
    fine_map = rng.randn(2, 20, 24, c).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 40, (r, 2)), rng.uniform(50, 90, (r, 2))],
                           -1).astype(np.float32)
    batch_idx = np.array([0, 1, 1, 0, 1], np.int32)
    classes = rng.randint(0, k, r).astype(np.int32)
    coords = rng.rand(r, 7, 2).astype(np.float32)
    fine = rng.randn(r, 7, c).astype(np.float32)

    head = jpr.PointRendMaskHead(num_classes=k, fine_channels=c, coarse_side=4,
                                 subdivision_steps=2, subdivision_num_points=20,
                                 init_resolution=4)
    v = random_variables(head, 9, pooled, fine, coords)
    port = port_of(tpr.PointRendMaskHead(k, in_channels=12, fine_channels=c, in_side=8,
                                         coarse_side=4, subdivision_steps=2,
                                         subdivision_num_points=20, init_resolution=4), v)
    want = jax.jit(head.apply, compiler_options=FAST_COMPILE)(v, pooled, fine, coords)
    close(port(*_t([pooled, fine, coords])), want)

    def jfine(cs):
        return jpr.sample_fine_features(fine_map, 0.25, batch_idx,
                                        jpr.point_coords_wrt_image(boxes, cs))

    def tfine(cs):
        return tpr.sample_fine_features(torch.from_numpy(fine_map), 0.25,
                                        torch.from_numpy(batch_idx).long(),
                                        tpr.point_coords_wrt_image(torch.from_numpy(boxes), cs))

    coarse = jax.jit(lambda v, p: head.apply(v, p, method=head.coarse),
                     compiler_options=FAST_COMPILE)(v, pooled)
    want = jax.jit(lambda v, cm, cl: head.apply(v, jfine, cm, cl,
                                                method=head.subdivision_inference),
                   compiler_options=FAST_COMPILE)(v, coarse, classes)
    with torch.no_grad():
        got = port.subdivision_inference(tfine, port.coarse(torch.from_numpy(pooled)),
                                         torch.from_numpy(classes))
    assert got.shape == (r, 16, 16, k)
    close(got, want)

    # the training sampler on jax.random's draws
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    n_unc = int(0.75 * 10)
    draws = (jax.random.uniform(k1, (r, 30, 2)), jax.random.uniform(k2, (r, 10 - n_unc, 2)))
    want = jax.jit(lambda *a: jpr.get_uncertain_point_coords_with_randomness(
        a[0], a[1], 10, 3.0, 0.75, a[2]), compiler_options=FAST_COMPILE)(coarse, classes, key)
    got = tpr.get_uncertain_point_coords_with_randomness(
        torch.from_numpy(np.array(coarse)), torch.from_numpy(classes), 10, 3.0, 0.75,
        tuple(torch.from_numpy(np.array(d)) for d in draws))
    close(got, want)


def test_pointsup_matches_jax():
    rng = np.random.RandomState(10)
    boxes = np.concatenate([rng.uniform(0, 20, (4, 2)), rng.uniform(30, 50, (4, 2))],
                           -1).astype(np.float32)
    pts = rng.uniform(-5, 55, (4, 9, 2)).astype(np.float32)
    labels = rng.randint(0, 2, (4, 9)).astype(np.float32)
    want_c, want_l = jax.jit(jps.annotation_points_to_labels,
                             compiler_options=FAST_COMPILE)(boxes, pts, labels)
    got_c, got_l = tps.annotation_points_to_labels(*_t([boxes, pts, labels]))
    close(got_c, want_c)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    logits = rng.randn(4, 14, 14).astype(np.float32) * 2
    close(tps.point_sup_mask_loss(torch.from_numpy(logits), got_c, got_l),
          jax.jit(jps.point_sup_mask_loss, compiler_options=FAST_COMPILE)(logits, want_c,
                                                                          want_l))


def test_densepose_matches_jax():
    rng = np.random.RandomState(11)
    x = rng.randn(3, 7, 7, 8).astype(np.float32)
    head = jdp.DensePoseChartHead(hidden_dim=16, num_stacked_convs=2)
    v = random_variables(head, 12, x)
    want = jax.jit(head.apply, compiler_options=FAST_COMPILE)(v, x)
    port = port_of(tdp.DensePoseChartHead(8, hidden_dim=16, num_stacked_convs=2), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        close(got[k], want[k])
    pts = rng.rand(3, 11, 2).astype(np.float32)
    parts = rng.randint(0, 25, (3, 11)).astype(np.int32)
    u, vv = rng.rand(2, 3, 11).astype(np.float32)
    coarse_t = rng.randint(0, 2, (3, 14, 14)).astype(np.int32)
    valid = rng.rand(3, 11) > 0.2
    want_l = jax.jit(jdp.densepose_losses, compiler_options=FAST_COMPILE)(
        want, pts, parts, u, vv, coarse_t, valid)
    got_l = tdp.densepose_losses(got, *_t([pts, parts, u, vv, coarse_t, valid]))
    for k in want_l:
        close(got_l[k], want_l[k])


def test_tridentnet_matches_jax():
    rng = np.random.RandomState(13)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    block = jtn.TridentBottleneck(bottleneck_channels=32, out_channels=24, test_branch_idx=1)
    v = random_variables(block, 14, x, train=True)
    port = port_of(ttn.TridentBottleneck(16, 32, 24, test_branch_idx=1), v)
    for train in (True, False):
        want = jax.jit(lambda v, x: block.apply(v, x, train=train),
                       compiler_options=FAST_COMPILE)(v, x)
        with torch.no_grad():
            got = port.train(train)(torch.from_numpy(x))
        assert len(got) == (3 if train else 1)
        for g, w in zip(got, want):
            close(g, w)
    conv = jtn.TridentConv(8, 3, dilations=(1, 3), use_bias=True)
    xs = [rng.randn(2, 7, 9, 16).astype(np.float32) for _ in range(2)]
    vc = random_variables(conv, 15, xs)
    want = jax.jit(conv.apply, compiler_options=FAST_COMPILE)(vc, xs)
    got = port_of(ttn.TridentConv(16, 8, 3, dilations=(1, 3), use_bias=True), vc)(_t(xs))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("lam", [1, 2, 3])
def test_swap_align2nat_matches_jax(lam):
    x = np.random.RandomState(16).randn(2, 5, 7, 9).astype(np.float32)
    want = jtm.swap_align2nat(jnp.asarray(x), lam, -6.0)
    got = ttm.SwapAlign2Nat(lam)(torch.from_numpy(x))
    close(got, want)


def test_precise_bn_matches_jax():
    aspp = jdl.ASPP(out_channels=8, dilations=(1, 2), dropout=0.0)
    batches = [np.random.RandomState(20 + i).randn(2, 6, 7, 5).astype(np.float32) * (1 + i)
               for i in range(3)]
    v = random_variables(aspp, 17, batches[0])

    def apply_fn(variables, x, train, mutable):
        return aspp.apply(variables, x, train=train, mutable=mutable)

    want = jpbn.recompute_bn_stats(apply_fn, v, [(b,) for b in batches], momentum=0.9,
                                   num_iters=2)
    port = port_of(tdl.ASPP(5, 8, (1, 2), dropout=0.0), v).eval()
    tpbn.recompute_bn_stats(port, [(torch.from_numpy(b),) for b in batches], num_iters=2)
    assert not port.training
    sd = port.state_dict()
    for name, t in library_from_flax({"batch_stats": want["batch_stats"]}).items():
        close(sd[name], t)
    assert not np.allclose(sd["b0_bn.running_var"].numpy(),
                           v["batch_stats"]["b0_bn"]["var"])


def vq_state_from_jax(state):
    """A JAX ``VQState`` (codebook, ema_count, ema_sum) as the port's, f32."""
    return tq.VQState(*(torch.from_numpy(np.array(a, dtype=np.float32)) for a in state))


def test_vector_quantizer_matches_jax():
    x = np.random.RandomState(18).randn(4, 6, 5).astype(np.float32)
    state = jq.vq_init(jax.random.PRNGKey(0), 16, 5)
    tstate = vq_state_from_jax(state)
    codes, quant = jax.jit(jq.vq_lookup, compiler_options=FAST_COMPILE)(state, x)
    update = jax.jit(jq.vq_update, compiler_options=FAST_COMPILE)
    got_codes, got_quant = tq.vq_lookup(tstate, torch.from_numpy(x))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    close(got_quant, quant)
    for step in range(3):
        key = jax.random.PRNGKey(100 + step)
        rand_idx = jax.random.randint(key, (16,), 0, 24)
        codes, quant, state = update(state, x, key)
        got_codes, got_quant, tstate = tq.vq_update(
            tstate, torch.from_numpy(x), torch.from_numpy(np.array(rand_idx)))
        np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
        close(got_quant, quant)
        for g, w in zip(tstate, state):
            close(g, w)
    assert (np.asarray(state.ema_count) == 1.0).any()  # dead codes were moved

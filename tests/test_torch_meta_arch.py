"""The port's detection meta-architectures (detection/meta_arch.py) against
the JAX package's on the CPU in f32: RetinaNet, FCOS, Mask R-CNN and
Keypoint R-CNN on a ResNet-18 with 32-channel FPNs at 64x64 and at 72x100,
where the FPN upsamples odd levels (3x4 -> 5x7 -> 9x13), weights carried by
utils/jax_params.library_from_flax (the ResNet by the detector's names).

Held: the FPN levels and every output before a selection (RetinaNet's and
FCOS's logits, deltas, boxes; the RPN's objectness and deltas); the R-CNN
ROI stage run on JAX's proposals (class logits, boxes, mask and keypoint
logits) and the losses on them, since after a top-k the two may take other
anchors at a tie; the port's own proposals against JAX's.  Bit for bit:
``resize_nearest`` against ``jax.image.resize(..., "nearest")`` (torch's
"nearest" takes other pixels at odd sizes) and ``match_anchors`` with a
padded GT slot, whose best anchor the reference writes as anchor 0, a
positive at IoU 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.detection import meta_arch as jma
from ir_ads_tpu.detection import matcher as jmatcher
from ir_ads_tpu_torch.detection import matcher as tmatcher
from ir_ads_tpu_torch.detection import meta_arch as tma
from tests.test_torch_heads import FAST_COMPILE, close, port_of

SIZES = ((64, 64), (72, 100))
MAX_GT = 3
TINY = dict(backbone_arch="resnet18", channels=32, max_gt=MAX_GT)
MODELS = {
    "retinanet": (jma.RetinaNet, tma.RetinaNet, dict(num_classes=4)),
    "fcos": (jma.FCOS, tma.FCOS, dict(num_classes=4)),
    "mask_rcnn": (jma.MaskRCNN, tma.MaskRCNN, dict(num_classes=3, num_proposals=8,
                                                   mask_pool=4)),
    "keypoint_rcnn": (jma.KeypointRCNN, tma.KeypointRCNN, dict(num_proposals=8,
                                                               mask_pool=4)),
}
RCNN_OUT = ("cls_logits", "boxes", "mask_logits", "keypoint_logits")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(size, b=2):
    return (np.random.RandomState(11).rand(b, *size, 3) * 2 - 1).astype(np.float32)


def _gt(size, num_classes, b=2):
    """Boxes round the image centre (so that some proposals match), one
    padded slot in the first image, masks inside the boxes, 17 keypoints."""
    rng = np.random.RandomState(12)
    h, w = size
    ctr = rng.uniform(0.3, 0.7, (b, MAX_GT, 2)) * [w, h]
    half = rng.uniform(0.15, 0.35, (b, MAX_GT, 2)) * [w, h]
    boxes = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    valid = np.ones((b, MAX_GT), bool)
    valid[0, -1] = False
    labels = rng.randint(0, num_classes, (b, MAX_GT)).astype(np.int32)
    yy, xx = np.mgrid[:h, :w]
    masks = ((xx >= boxes[..., 0, None, None]) & (xx <= boxes[..., 2, None, None])
             & (yy >= boxes[..., 1, None, None]) & (yy <= boxes[..., 3, None, None])
             & (rng.rand(b, MAX_GT, h, w) > 0.3))
    kx = rng.uniform(boxes[..., 0:1], boxes[..., 2:3], (b, MAX_GT, 17))
    ky = rng.uniform(boxes[..., 1:2], boxes[..., 3:4], (b, MAX_GT, 17))
    vis = (rng.rand(b, MAX_GT, 17) > 0.2) * 2.0
    kps = np.stack([kx, ky, vis], -1).astype(np.float32)
    return dict(gt_boxes=boxes, gt_labels=labels, gt_valid=valid, gt_masks=masks,
                gt_keypoints=kps)


def random_variables(module, seed, *args, **kw):
    """numpy-seeded values in the shapes of ``module.init``'s tree: every
    kernel N(0, 1/fan_in), so that activations stay O(1) through the trunk;
    scales (FCOS's ``scale_i`` too) near 1, variances in [0.5, 1.5), the
    rest 0.05 N(0, 1)."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kw))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name.startswith("scale"):
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "var":
            v = 0.5 + rng.rand(*leaf.shape)
        elif name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _jax_run(name, size):
    """(variables, outputs with losses, captured FPN and RPN outputs) of the
    JAX model in train mode on ``_images(size)`` and ``_gt``."""
    jcls, _, kw = MODELS[name]
    model = jcls(**TINY, **kw)
    images = _images(size)
    v = random_variables(model, 13, jnp.asarray(images))
    gt = _gt(size, kw.get("num_classes", 1))
    rcnn = name.endswith("rcnn")
    extra = dict(gt_masks=gt["gt_masks"], gt_keypoints=gt["gt_keypoints"]) if rcnn else {}

    def run(v, x, gb, gl, gv, *more):
        more = dict(zip(extra, more))
        return model.apply(v, x, gb, gl, gv, train=True, **more, capture_intermediates=(
            lambda m, _: m.name in ("fpn", "rpn_delta")), mutable=["intermediates"])

    out, inter = jax.jit(run, compiler_options=FAST_COMPILE)(
        v, images, gt["gt_boxes"], gt["gt_labels"], gt["gt_valid"], *extra.values())
    return v, jax.tree.map(np.array, out), jax.tree.map(np.array, inter["intermediates"])


def _port(name, variables):
    _, tcls, kw = MODELS[name]
    return port_of(tcls(**TINY, **kw), variables)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close_losses(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["retinanet", "fcos"])
def test_one_stage_detector_matches_jax(name, size):
    v, want, inter = _jax_run(name, size)
    model = _port(name, v).train()
    gt = _t({k: x for k, x in _gt(size, 4).items() if k in ("gt_boxes", "gt_labels", "gt_valid")})
    with torch.no_grad():
        got = model(torch.from_numpy(_images(size)), **gt)
    for lvl, (g, w) in enumerate(zip(got["levels"], inter["fpn"]["__call__"][0])):
        close(g, w)
    keys = ("logits", "deltas", "anchors", "boxes") if name == "retinanet" else (
        "logits", "boxes", "centerness")
    for k in keys:
        close(got[k], want[k])
    _close_losses(got["losses"], want["losses"])
    assert want["losses"]["loss_cls"] > 0


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["mask_rcnn", "keypoint_rcnn"])
def test_two_stage_detector_matches_jax(name, size):
    v, want, inter = _jax_run(name, size)
    model = _port(name, v).train()
    images = torch.from_numpy(_images(size))
    gt = _t(_gt(size, MODELS[name][2].get("num_classes", 1)))
    with torch.no_grad():
        rpn = model.rpn(images)
        for g, w in zip(rpn["levels"], inter["fpn"]["__call__"][0]):
            close(g, w)
        close(rpn["rpn_obj"], want["rpn_obj"])
        deltas = np.concatenate([d.reshape(2, -1, 4) for d in inter["rpn_delta"]["__call__"]], 1)
        close(rpn["rpn_deltas"], deltas)
        # the port's own selection, then the ROI stage and losses on JAX's proposals
        close(model.select_proposals(rpn["rpn_obj"], rpn["rpn_deltas"], rpn["anchors"]),
              want["proposals"])
        out = {**rpn, **model.roi_stage(rpn["levels"], torch.from_numpy(want["proposals"]))}
        losses = model.losses(out, gt["gt_boxes"], gt["gt_labels"], gt["gt_valid"],
                              gt["gt_masks"], gt["gt_keypoints"])
    for k in RCNN_OUT:
        if k in want:
            close(out[k], want[k])
    _close_losses(losses, want["losses"])
    assert set(want["losses"]) >= {"loss_rpn_obj", "loss_roi_cls"}
    assert ("loss_mask" if name == "mask_rcnn" else "loss_keypoint") in losses

    # and end to end: the forward's own proposals are JAX's here
    with torch.no_grad():
        full = model(images, **gt)
    _close_losses(full["losses"], want["losses"])


@pytest.mark.parametrize("src,dst", [((19, 32), (38, 63)), ((3, 4), (5, 7)), ((5, 7), (9, 13)),
                                     ((4, 4), (8, 8))])
def test_resize_nearest_is_jax_bit_for_bit(src, dst):
    x = np.random.RandomState(14).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), "nearest"))
    got = tma.resize_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, want)
    torch_nearest = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst,
                                  mode="nearest").permute(0, 2, 3, 1).numpy()
    assert (torch_nearest != want).any() == (dst[0] % src[0] != 0 or dst[1] % src[1] != 0)


def test_match_anchors_padded_slot_bit_for_bit():
    """One valid GT and two padded slots: the reference writes the padded
    slots' best anchor as anchor 0, positive at IoU 0 (2 positives); with
    the slots valid it has one."""
    anchors = np.asarray(jma.make_anchors(((4, 4),), (8,), (16,)))
    gt = np.array([[12, 12, 20, 20], [0, 0, 1, 1], [0, 0, 1, 1]], np.float32)
    for valid in ([True, False, False], [True, True, True], [False, False, False]):
        valid = np.array(valid)
        want = [np.asarray(t) for t in jma.match_anchors(anchors, gt, valid, 0.7, 0.3)]
        got = [t.numpy() for t in tma.match_anchors(
            torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(valid), 0.7, 0.3)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    valid = torch.tensor([True, False, False])
    _, label = tma.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gt), valid)
    assert int(label[0]) == 1 and int((label == 1).sum()) == 2


def test_anchor_codec_and_dynamic_k_match():
    rng = np.random.RandomState(15)
    anchors = np.asarray(jma.make_anchors(((3, 5), (2, 3)), (8, 16), (16, 32)))
    boxes = anchors + rng.uniform(-3, 3, anchors.shape).astype(np.float32)
    deltas = rng.randn(*anchors.shape).astype(np.float32)
    close(tma.encode_deltas(torch.from_numpy(anchors), torch.from_numpy(boxes)),
          jma.encode_deltas(anchors, boxes))
    close(tma.decode_deltas(torch.from_numpy(anchors), torch.from_numpy(deltas * 3)),
          jma.decode_deltas(anchors, deltas * 3))
    close(tma.smooth_l1(torch.from_numpy(deltas)), jma.smooth_l1(deltas))

    cost = rng.rand(2, 12, 4).astype(np.float32)
    ious = rng.rand(2, 12, 4).astype(np.float32)
    valid = np.array([[True, True, False, True], [True, False, False, False]])
    want = np.asarray(jmatcher.dynamic_k_match(cost, ious, valid, max_k=4))
    got = tmatcher.dynamic_k_match(torch.from_numpy(cost), torch.from_numpy(ious),
                                   torch.from_numpy(valid), max_k=4).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()

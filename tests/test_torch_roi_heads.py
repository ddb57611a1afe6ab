"""The port's ROI heads (detection/roi_heads.py) against the JAX package's on
the CPU in f32: the mask head and the keypoint head (4x4 stride-2 deconv,
flax's kernel flip and SAME crop, then 2x bilinear), weights carried by
utils/jax_params.library_from_flax; the GT mask crops, the mask and
keypoint losses, the mask inference and pasting, the keypoint heatmap
targets (keypoints on the ROI's far edge, outside it and invisible among
them) and the keypoint decoding (the argmax on the heatmap grid)."""

import jax
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import roi_heads as jrh
from ir_ads_tpu_torch.detection import roi_heads as trh
from tests.test_torch_heads import FAST_COMPILE, close, port_of, random_variables


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rois(seed, r, span=48.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, span * 0.6, (r, 2))
    wh = rng.uniform(4, span * 0.4, (r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_mask_head_matches_jax():
    x = np.random.RandomState(0).randn(6, 7, 7, 12).astype(np.float32)
    head = jrh.MaskHead(num_classes=3, conv_dim=16, num_conv=2)
    v = random_variables(head, 1, x)
    want = jax.jit(head.apply, compiler_options=FAST_COMPILE)(v, x)
    port = port_of(trh.MaskHead(12, 3, conv_dim=16, num_conv=2), v)
    got = port(torch.from_numpy(x))
    assert got.shape == (6, 14, 14, 3)
    close(got, want)


def test_keypoint_head_matches_jax():
    x = np.random.RandomState(2).randn(5, 6, 6, 8).astype(np.float32)
    head = jrh.KeypointHead(num_keypoints=4, conv_dims=(16, 16))
    v = random_variables(head, 3, x)
    want = jax.jit(head.apply, compiler_options=FAST_COMPILE)(v, x)
    port = port_of(trh.KeypointHead(8, 4, conv_dims=(16, 16)), v)
    got = port(torch.from_numpy(x))
    assert got.shape == (5, 24, 24, 4)
    close(got, want)


def test_mask_targets_loss_and_pasting():
    rng = np.random.RandomState(4)
    masks = rng.rand(3, 40, 48) > 0.5
    boxes = _rois(5, 10)
    matched = rng.randint(0, 3, 10).astype(np.int32)
    want = np.asarray(jax.jit(jrh.crop_and_resize_masks, static_argnums=3)(
        masks, boxes, matched, 14))
    got = trh.crop_and_resize_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                                    torch.from_numpy(matched).long(), 14)
    close(got, want)

    logits = rng.randn(10, 14, 14, 4).astype(np.float32) * 3
    classes = rng.randint(0, 4, 10).astype(np.int32)
    fg = (rng.rand(10) > 0.4).astype(np.float32)
    close(trh.mask_rcnn_loss(torch.from_numpy(logits), torch.from_numpy(classes), got,
                             torch.from_numpy(fg)),
          jrh.mask_rcnn_loss(logits, classes, want, fg))
    probs = trh.mask_rcnn_inference(torch.from_numpy(logits), torch.from_numpy(classes))
    close(probs, jrh.mask_rcnn_inference(logits, classes))

    pasted = trh.paste_masks_in_image(probs, torch.from_numpy(boxes), (40, 48)).numpy()
    ref = np.asarray(jax.jit(jrh.paste_masks_in_image, static_argnums=2)(
        probs.numpy(), boxes, (40, 48)))
    assert pasted.shape == (10, 40, 48) and 0 < ref.mean() < 1
    assert (pasted != ref).mean() < 1e-3  # a probability at 0.5 may round either way


def test_keypoint_targets_loss_and_decoding():
    rng = np.random.RandomState(6)
    rois = _rois(7, 8)
    x1, y1, x2, y2 = rois.T
    kx = rng.uniform(x1 - 4, x2 + 4, (5, 8)).T
    ky = rng.uniform(y1 - 4, y2 + 4, (5, 8)).T
    kx[:, 0], ky[:, 1] = x2, y2  # on the far edge: the last heatmap cell
    vis = (rng.rand(8, 5) > 0.2).astype(np.float32) * 2
    kps = np.stack([kx, ky, vis], -1).astype(np.float32)  # (R, K, 3)
    for got, want in zip(trh.keypoints_to_heatmap(torch.from_numpy(kps), torch.from_numpy(rois),
                                                  12),
                         jrh.keypoints_to_heatmap(kps, rois, 12)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    logits = rng.randn(8, 12, 12, 5).astype(np.float32) * 2
    fg = (rng.rand(8) > 0.3).astype(np.float32)
    close(trh.keypoint_rcnn_loss(torch.from_numpy(logits), torch.from_numpy(kps),
                                 torch.from_numpy(rois), torch.from_numpy(fg)),
          jrh.keypoint_rcnn_loss(logits, kps, rois, fg))
    close(trh.heatmaps_to_keypoints(torch.from_numpy(logits), torch.from_numpy(rois)),
          jrh.heatmaps_to_keypoints(logits, rois))

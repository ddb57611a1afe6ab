"""The port's rotated-box ops and ROI aligns (detection/rotated_boxes.py)
against the JAX package's on the CPU in f32: rotated IoU (overlapping,
nested, disjoint and touching pairs at many angles), greedy rotated NMS,
``roi_align`` (boxes reaching past the map, two images, aligned and not)
and ``roi_align_rotated``.  The port samples each ROI where its image lies,
without the reference's per-ROI copy of the map: the same function."""

import jax
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import rotated_boxes as jrb
from ir_ads_tpu_torch.detection import rotated_boxes as trb

ATOL, RTOL = 2e-3, 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rotated(seed, n, span=40.0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(0, span, n), rng.uniform(0, span, n),
                     rng.uniform(4, 20, n), rng.uniform(4, 20, n),
                     rng.uniform(-180, 180, n)], -1).astype(np.float32)


def test_box_iou_rotated_matches_jax():
    a = rotated(0, 12)
    b = rotated(1, 9)
    # a box with itself, nested, disjoint, and rotated by 90 degrees (equal IoU 1)
    b[0] = a[0]
    b[1] = a[1] * np.array([1, 1, 0.5, 0.5, 1], np.float32)
    b[2] = a[2] + np.array([500, 500, 0, 0, 0], np.float32)
    b[3] = a[3] + np.array([0, 0, 0, 0, 180], np.float32)
    want = np.asarray(jax.jit(jrb.box_iou_rotated)(a, b))
    got = trb.box_iou_rotated(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    assert got[0, 0] == pytest.approx(1.0, abs=1e-5) and got[2, 2] == 0.0
    assert 0.0 < want.mean() < 1.0  # overlaps of every kind among the pairs
    corners = trb.box_to_corners(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(corners, np.asarray(jrb.box_to_corners(a)), atol=1e-5)


def test_nms_rotated_matches_jax():
    boxes = rotated(2, 40, span=30.0)
    scores = np.random.RandomState(3).rand(40).astype(np.float32)
    for thr in (0.1, 0.5):
        want = np.asarray(jax.jit(jrb.nms_rotated, static_argnums=2)(boxes, scores, thr))
        got = trb.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(got)


def _features(seed, b=2, h=13, w=17, c=5):
    return np.random.RandomState(seed).randn(b, h, w, c).astype(np.float32)


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_matches_jax(aligned):
    feats = _features(4)
    rng = np.random.RandomState(5)
    xy = rng.uniform(-10, 60, (20, 2))
    wh = rng.uniform(1, 40, (20, 2))
    rois = np.concatenate([rng.randint(0, 2, (20, 1)), xy, xy + wh], -1).astype(np.float32)
    for size, scale in (((7, 7), 0.25), ((4, 6), 0.5)):
        want = np.asarray(jax.jit(lambda f, r: jrb.roi_align(
            f, r, size, spatial_scale=scale, aligned=aligned))(feats, rois))
        got = trb.roi_align(torch.from_numpy(feats), torch.from_numpy(rois), size,
                            spatial_scale=scale, aligned=aligned).numpy()
        assert got.shape == (20, *size, 5)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert np.abs(want).max() > 0.1


def test_roi_align_rotated_matches_jax():
    feats = _features(6)
    boxes = rotated(7, 15, span=60.0)
    rois = np.concatenate([np.random.RandomState(8).randint(0, 2, (15, 1)), boxes],
                          -1).astype(np.float32)
    want = np.asarray(jax.jit(lambda f, r: jrb.roi_align_rotated(
        f, r, (5, 5), spatial_scale=0.25))(feats, rois))
    got = trb.roi_align_rotated(torch.from_numpy(feats), torch.from_numpy(rois), (5, 5),
                                spatial_scale=0.25).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).max() > 0.1

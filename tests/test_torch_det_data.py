"""The detection data pipeline, the COCO evaluator and the training entry
point of the port against the JAX package, on the CPU.

``ViewSamplingMapper`` and ``detection_batches`` over a COCO set written to
``tmp_path`` (polygons, an RLE mask, a style twin) with the same seeded
``np.random.Generator`` on both sides must give the same samples bit for
bit; ``COCOEvaluator.summarize`` equals JAX's on random detections through
the native matcher and through the numpy one; ``python -m
ir_ads_tpu_torch.train_net --synthetic --max-iter 2 --device cpu`` ends,
and JAX's ``load_weights`` reads both weight files it writes.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import coco_eval as jeval
from ir_ads_tpu.detection import data as jdata
from ir_ads_tpu.detection import rle as jrle
from ir_ads_tpu_torch.detection import coco_eval, data, rle
from ir_ads_tpu_torch.train_net import make_synthetic_coco


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """The synthetic set at 80x96 px plus an RLE annotation on image 0 and
    a style twin of image 1."""
    root = tmp_path_factory.mktemp("coco")
    path, images = make_synthetic_coco(str(root), n_images=6, size=96, n_classes=3, seed=2)
    with open(path) as f:
        coco = json.load(f)
    m = np.zeros((96, 96), np.uint8)
    m[20:50, 30:70] = 1
    coco["annotations"].append({"id": 999, "image_id": 0, "category_id": 2,
                                "bbox": [30.0, 20.0, 40.0, 30.0], "area": 1200.0, "iscrowd": 0,
                                "segmentation": rle.encode_rle(m)})
    with open(path, "w") as f:
        json.dump(coco, f)
    style = root / "style"
    style.mkdir()
    from PIL import Image

    Image.fromarray((np.arange(96 * 96 * 3) % 251).astype(np.uint8).reshape(96, 96, 3)).save(
        style / "0001.png")
    return path, images, str(style)


def test_synthetic_coco_layout(tmp_path):
    """The synthetic set at train_net.py's defaults: 8 images of 96 px, the
    first image's annotation count its generator's second draw."""
    path, _ = make_synthetic_coco(str(tmp_path))
    with open(path) as f:
        coco = json.load(f)
    assert len(coco["images"]) == 8 and coco["images"][0]["width"] == 96
    rng = np.random.RandomState(0)
    rng.randint(0, 255, (96, 96, 3), dtype=np.uint8)
    n = rng.randint(1, 4)
    assert sum(a["image_id"] == 0 for a in coco["annotations"]) == n


def test_rle_matches_jax():
    rs = np.random.RandomState(0)
    m = (rs.rand(13, 17) > 0.6).astype(np.uint8)
    enc = rle.encode_rle(m)
    assert enc == jrle.encode_rle(m)
    assert np.array_equal(rle.decode_rle(enc), m)
    assert rle._decode_compressed_counts("52203") == jrle._decode_compressed_counts("52203")


@pytest.mark.parametrize("train", [True, False])
def test_mapper_and_batches_match_jax(coco_set, train):
    path, images, style = coco_set
    ours = data.CocoDetection(path, images, style_root=style)
    theirs = jdata.CocoDetection(path, images, style_root=style)
    assert ours.cat_to_contiguous == theirs.cat_to_contiguous and len(ours) == len(theirs)
    m_ours = data.ViewSamplingMapper(ours, (64, 80), max_gt=4, mask_size=(32, 32), train=train)
    m_theirs = jdata.ViewSamplingMapper(theirs, (64, 80), max_gt=4, mask_size=(32, 32),
                                        train=train)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in list(range(len(ours))) * 2:
        a, b = m_ours(i, r1), m_theirs(i, r2)
        for f in ("image", "weak_image", "boxes", "labels", "valid", "masks"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (i, f)
        assert (a.image_id, a.orig_size) == (b.image_id, b.orig_size)
    got = list(zip(range(2), data.detection_batches(m_ours, 2, seed=3)))
    want = list(zip(range(2), jdata.detection_batches(m_theirs, 2, seed=3)))
    for (_, x), (_, y) in zip(got, want):
        assert set(x) == set(y)
        assert all(np.array_equal(x[k], y[k]) for k in x)


def _random_detections(rs, evaluator_pair, n_images=6):
    for _ in range(n_images):
        n_gt, n_dt = rs.randint(1, 6), rs.randint(0, 40)
        gt = np.concatenate([rs.rand(n_gt, 2) * 300, rs.rand(n_gt, 2) * 150 + 5], 1)
        near = gt[rs.randint(0, n_gt, n_dt)] + rs.randn(n_dt, 4) * 8
        dt = np.abs(np.where(rs.rand(n_dt, 1) < 0.7, near,
                             np.concatenate([rs.rand(n_dt, 2) * 300, rs.rand(n_dt, 2) * 150 + 5],
                                            1)))
        scores, dl, gl = rs.rand(n_dt), rs.randint(0, 3, n_dt), rs.randint(0, 3, n_gt)
        crowd = rs.rand(n_gt) < 0.15
        for ev in evaluator_pair:
            ev.add_image(dt, scores, dl, gt, gl, gt_crowd=crowd)


@pytest.mark.parametrize("native", [True, False])
def test_coco_evaluator_matches_jax(native):
    ours = coco_eval.COCOEvaluator(native=native)
    theirs = jeval.COCOEvaluator()
    _random_detections(np.random.RandomState(7), (ours, theirs))
    got, want = ours.summarize(), theirs.summarize()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    assert 0 < got["AP50"] <= 1


def test_native_matching_equals_numpy():
    rs = np.random.RandomState(8)
    ious = rs.rand(12, 7)
    ignore, crowd = rs.rand(7) < 0.3, rs.rand(7) < 0.2
    order = np.argsort(ignore, kind="mergesort")
    ious, ignore, crowd = ious[:, order], ignore[order], crowd[order]
    got = coco_eval.match_image(ious, ignore, crowd)
    want = coco_eval.match_image_py(ious, ignore, crowd)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    dt, gt = rs.rand(5, 4) * 50, rs.rand(3, 4) * 50
    np.testing.assert_allclose(coco_eval.bbox_iou_xywh(dt, gt, crowd[:3]),
                               coco_eval.bbox_iou_xywh(dt, gt, crowd[:3], native=False),
                               rtol=1e-12, atol=1e-15)
    assert coco_eval.LIBRARY.exists()


def test_train_net_synthetic_on_cpu(tmp_path, caplog, monkeypatch):
    """The entry point end to end, run as ``python -m`` runs it (its
    ``__main__`` with that argv, in this process and one thread, as the
    tests run); JAX's ``load_weights`` reads both weight files into
    train_net.py's template (what its ``--resume`` does), and ``--resume``
    reads them back."""
    import runpy
    import warnings

    from ir_ads_tpu.detection.dino import DINODetector as JaxDINO
    from ir_ads_tpu.utils.checkpoint import load_weights

    out = tmp_path / "run"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["train_net", "--synthetic", "--max-iter", "2",
                                      "--device", "cpu", "--output", str(out)])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with warnings.catch_warnings():  # the module is imported already, by this file
            warnings.simplefilter("ignore", RuntimeWarning)
            runpy.run_module("ir_ads_tpu_torch.train_net", run_name="__main__", alter_sys=True)
    finally:
        torch.set_num_threads(n)
    log = (out / "train.log").read_text()
    assert "iter 2/2" in log and "eval: AP=" in log
    model = JaxDINO(num_classes=4, num_queries=20, embed_dim=32, num_encoder_layers=1,
                    num_decoder_layers=1, backbone_arch="resnet18", dn_number=8, max_gt=4)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "cdn": jax.random.PRNGKey(1)},
        jnp.zeros((1, 96, 96, 3)), jnp.zeros((1, 4), jnp.int32), jnp.full((1, 4, 4), 0.5),
        jnp.zeros((1, 4), bool), train=True))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    for name in ("weights.msgpack", "ema_weights.msgpack"):
        w = load_weights(str(out / name), {"params": template["params"],
                                           "batch_stats": template["batch_stats"]})
        leaves = jax.tree.leaves(w)
        assert len(leaves) == len(jax.tree.leaves(template)) and all(
            np.isfinite(np.asarray(x)).all() for x in leaves)
    from ir_ads_tpu_torch import train_net

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    caplog.set_level("INFO", logger="ir_ads_tpu_torch")
    try:
        stats = train_net.main(["--synthetic", "--max-iter", "0", "--device", "cpu",
                                "--output", str(tmp_path / "again"), "--resume", str(out)])
    finally:
        torch.set_num_threads(n)
    assert f"resumed weights from {out}" in caplog.text
    assert set(stats) >= {"AP", "AP50", "AR@100"}

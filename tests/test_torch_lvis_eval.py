"""The LVIS federated evaluator on the port (``detection.lvis_eval``)
against the JAX package's: tests/test_lvis_eval.py's cases, every summary
key on random detections over a synthesized LVIS-style set (40 images, 30
categories with rare / common / frequent frequencies, negative and
not-exhaustive category ids) within 1e-12, and ``train_net --evaluator
lvis`` on the CPU."""

import numpy as np
import pytest
import torch

from ir_ads_tpu.detection.lvis_eval import LVISEvaluator as JaxLVIS
from ir_ads_tpu_torch.detection.coco_eval import COCOEvaluator
from ir_ads_tpu_torch.detection.lvis_eval import LVISEvaluator

BOX = np.asarray([[10.0, 10.0, 20.0, 20.0]])  # xywh
LVIS_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@300")


def test_federated_unverified_image_not_false_positive():
    """A detection of a category neither annotated on an image nor in its
    ``neg_category_ids`` is dropped, where plain COCO counts it a false
    positive."""

    def feed(ev, lvis):
        ev.add_image(pred_boxes=BOX, pred_scores=np.asarray([0.9]),
                     pred_labels=np.asarray([2]), gt_boxes=BOX, gt_labels=np.asarray([2]))
        kw = dict(pred_boxes=BOX + 100, pred_scores=np.asarray([0.95]),
                  pred_labels=np.asarray([2]), gt_boxes=np.zeros((0, 4)),
                  gt_labels=np.zeros((0,), np.int64))
        if lvis:
            kw["neg_category_ids"] = ()
        ev.add_image(**kw)

    coco, lvis = COCOEvaluator(), LVISEvaluator()
    feed(coco, False)
    feed(lvis, True)
    assert lvis.summarize()["AP"] > 0.99
    assert coco.summarize()["AP"] < 0.99


def test_neg_category_makes_it_a_false_positive():
    ev = LVISEvaluator()
    ev.add_image(pred_boxes=BOX, pred_scores=np.asarray([0.9]), pred_labels=np.asarray([2]),
                 gt_boxes=BOX, gt_labels=np.asarray([2]))
    ev.add_image(pred_boxes=BOX + 100, pred_scores=np.asarray([0.95]),
                 pred_labels=np.asarray([2]), gt_boxes=np.zeros((0, 4)),
                 gt_labels=np.zeros((0,), np.int64), neg_category_ids=(2,))
    assert ev.summarize()["AP"] < 0.99


def test_not_exhaustive_ignores_unmatched():
    ev = LVISEvaluator()
    ev.add_image(pred_boxes=np.concatenate([BOX, BOX + 100]),
                 pred_scores=np.asarray([0.9, 0.95]), pred_labels=np.asarray([1, 1]),
                 gt_boxes=BOX, gt_labels=np.asarray([1]), not_exhaustive_category_ids=(1,))
    assert ev.summarize()["AP"] > 0.99


def test_frequency_buckets():
    ev = LVISEvaluator(category_frequencies={1: "r", 2: "f"})
    for cat, good in ((1, True), (2, False)):
        ev.add_image(pred_boxes=BOX if good else BOX + 50, pred_scores=np.asarray([0.9]),
                     pred_labels=np.asarray([cat]), gt_boxes=BOX, gt_labels=np.asarray([cat]))
    s = ev.summarize()
    assert s["APr"] > 0.99 and s["APf"] < 0.01


def _lvis_like_set(seed, n_images=40, n_cats=30, size=640.0):
    """Per image: GT boxes of 1-6 categories (small to large), detections
    jittered from them or random (some of categories absent from the
    image), a few negative ids, and some GT categories not exhaustive."""
    rng = np.random.RandomState(seed)
    images = []
    for _ in range(n_images):
        n_gt = rng.randint(1, 9)
        wh = np.exp(rng.uniform(np.log(8), np.log(300), (n_gt, 2)))
        xy = rng.uniform(0, size - wh)
        gt = np.concatenate([xy, wh], 1)
        gt_labels = rng.choice(np.arange(1, 7) if rng.rand() < 0.3 else np.arange(1, n_cats + 1),
                               n_gt)
        n_match = rng.randint(0, n_gt + 1)
        pick = rng.choice(n_gt, n_match)
        jitter = gt[pick] + rng.randn(n_match, 4) * np.maximum(gt[pick, 2:], 4).repeat(2, 1) * 0.1
        n_rand = rng.randint(0, 12)
        rwh = rng.uniform(5, 200, (n_rand, 2))
        rand = np.concatenate([rng.uniform(0, size - rwh), rwh], 1)
        pred = np.concatenate([jitter, rand]).astype(np.float64)
        pred[:, 2:] = np.maximum(pred[:, 2:], 1.0)
        labels = np.concatenate([gt_labels[pick], rng.randint(1, n_cats + 1, n_rand)])
        scores = rng.rand(len(pred))
        absent = np.setdiff1d(np.arange(1, n_cats + 1), gt_labels)
        neg = rng.choice(absent, rng.randint(0, 6), replace=False)
        present = np.unique(gt_labels)
        nel = present[rng.rand(len(present)) < 0.3]
        images.append(dict(pred_boxes=pred, pred_scores=scores, pred_labels=labels,
                           gt_boxes=gt, gt_labels=gt_labels, neg_category_ids=tuple(neg),
                           not_exhaustive_category_ids=tuple(nel)))
    freqs = {c: "rcf"[c % 3] for c in range(1, n_cats + 1)}
    return images, freqs


@pytest.mark.parametrize("seed", [0, 1])
def test_summary_matches_jax_on_a_synthesized_set(seed):
    images, freqs = _lvis_like_set(seed)
    got_ev, want_ev = LVISEvaluator(category_frequencies=freqs), JaxLVIS(
        category_frequencies=freqs)
    for kw in images:
        got_ev.add_image(**kw)
        want_ev.add_image(**kw)
    got, want = got_ev.summarize(), want_ev.summarize()
    assert set(got) == set(want) == set(LVIS_KEYS) | {"APr", "APc", "APf"}
    for k in want:
        assert np.isfinite(want[k]), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0, err_msg=k)
    # the federated rules move the numbers: plain COCO on the same set differs
    coco = COCOEvaluator(max_dets=(300,))
    for kw in images:
        coco.add_image(kw["pred_boxes"], kw["pred_scores"], kw["pred_labels"], kw["gt_boxes"],
                       kw["gt_labels"])
    assert abs(coco.summarize()["AP"] - got["AP"]) > 1e-3


def test_train_net_lvis_on_cpu(tmp_path, caplog):
    """``train_net --evaluator lvis --device cpu`` on the tiny synthetic COCO
    set (no step: the evaluation of the initial weights) returns the LVIS
    keys."""
    from ir_ads_tpu_torch import train_net
    from ir_ads_tpu_torch.utils.logging import get_logger

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    get_logger()  # set up first: caplog restores the level it finds, for later tests
    caplog.set_level("INFO", logger="ir_ads_tpu_torch")
    try:
        stats = train_net.main(["--synthetic", "--max-iter", "0", "--evaluator", "lvis",
                                "--device", "cpu", "--output", str(tmp_path / "run")])
    finally:
        torch.set_num_threads(n)
    assert set(stats) == set(LVIS_KEYS)
    assert all(np.isfinite(stats[k]) for k in ("AP", "AP50", "AP75", "APs", "AR@300"))
    assert "eval: AP=" in caplog.text and "AR@300=" in caplog.text

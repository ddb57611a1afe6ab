"""The port's detection demo (ir_ads_tpu_torch/demo/) and tracker
(detection/tracking.py) on the CPU: the trackers bit for bit against the
JAX package's on the same detections (births, matches across classes,
lost and dropped tracks); the async predictor's order (frames out in input
order whatever each takes, a preprocessing error raised); the demo's
post-processing against the JAX demo's (``nms_topk`` of the best sigmoid
class score, the top min(100, queries)); and ``demo.main`` on 3 tiny
synthetic frames with ``--device cpu --track hungarian``: each frame's
detections equal to the demo's model and post-processing run directly,
its tracks equal to a ``HungarianIOUTracker`` fed those detections.
Without CUDA the demo's default device raises."""

import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ir_ads_tpu.detection import dino as jdino
from ir_ads_tpu.detection import tracking as jtracking
from ir_ads_tpu_torch.demo import demo
from ir_ads_tpu_torch.demo.predictors import AsyncPredictor
from ir_ads_tpu_torch.detection import tracking as ttracking

TINY_FLAGS = ("--num-classes", "3", "--num-queries", "20", "--embed-dim", "32",
              "--enc-layers", "1", "--dec-layers", "1", "--backbone", "resnet18",
              "--image-size", "96", "--score-thresh", "0.3")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _detections(seed, frames=12):
    """Boxes drifting over frames, some appearing and vanishing, 2 classes."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 80, (6, 2))
    for t in range(frames):
        alive = rng.rand(6) > 0.25
        xy = base[alive] + t * 1.5 + rng.randn(alive.sum(), 2)
        wh = rng.uniform(10, 25, (alive.sum(), 2))
        yield (np.concatenate([xy, xy + wh], -1), rng.randint(0, 2, alive.sum()),
               rng.rand(alive.sum()))


@pytest.mark.parametrize("kind", ["iou", "hungarian"])
def test_trackers_match_jax_bit_for_bit(kind):
    for kw in (dict(), dict(iou_threshold=0.3, max_lost_frames=2, min_box_area=150.0,
                            track_same_class_only=False)):
        want, got = jtracking.TRACKERS[kind](**kw), ttracking.TRACKERS[kind](**kw)
        seen = set()
        for boxes, labels, scores in _detections(1):
            a, b = want.update(boxes, labels, scores), got.update(boxes, labels, scores)
            assert [(t.track_id, t.label, t.score, t.lost_frames, t.age) for t in a] == [
                (t.track_id, t.label, t.score, t.lost_frames, t.age) for t in b]
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.box, y.box)
            assert [t.track_id for t in want.tracks] == [t.track_id for t in got.tracks]
            seen |= {t.track_id for t in a}
        assert len(seen) > 6  # births beyond the first frame's


def test_async_predictor_keeps_the_order():
    delays = np.random.RandomState(2).rand(20) * 0.01

    def preprocess(i):
        time.sleep(delays[i])
        return i * 10

    out = list(AsyncPredictor(preprocess, lambda x: x + 1, lambda x: -x, max_in_flight=3,
                              queue_size=2)(range(20)))
    assert out == [(i, -(i * 10 + 1)) for i in range(20)]

    def broken(i):
        if i == 5:
            raise ValueError("bad frame")
        return i

    with pytest.raises(ValueError, match="bad frame"):
        list(AsyncPredictor(broken, lambda x: x, lambda x: x)(range(10)))


def test_postprocess_matches_the_jax_demo():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 150, 4).astype(np.float32) * 2
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, 150, 2)),
                            rng.uniform(0.05, 0.3, (2, 150, 2))], -1).astype(np.float32)
    scores = jax.nn.sigmoid(logits)
    want = jax.jit(lambda s, b: jdino.nms_topk(s, b, topk=100))(scores.max(-1), boxes)
    got = demo.postprocess({"pred_logits": torch.from_numpy(logits)[None],
                            "pred_boxes": torch.from_numpy(boxes)[None]}, 150)
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(scores.argmax(-1)))
    assert 0 < int(got[2].sum()) < got[2].numel()


def test_demo_main_on_synthetic_frames(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    for t in range(3):  # a bright rectangle moving right over noise
        img = (np.random.RandomState(t).rand(48, 64, 3) * 60).astype(np.uint8)
        img[10:30, 8 + 6 * t:30 + 6 * t] = (220, 180, 40)
        Image.fromarray(img).save(frames / f"f{t}.jpg")
    argv = ["--input", str(frames), "--output", str(tmp_path / "out"), "--device", "cpu",
            "--track", "hungarian", *TINY_FLAGS]
    results = demo.main(argv)
    assert [r["name"] for r in results] == ["f0.jpg", "f1.jpg", "f2.jpg"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "f0_det.png", "f1_det.png", "f2_det.png"]

    args = demo.parse_args(argv)
    infer = demo.make_infer(demo.build_model(args), args.num_queries)
    tracker = ttracking.HungarianIOUTracker()
    for r, t in zip(results, range(3)):
        img = np.asarray(Image.open(frames / f"f{t}.jpg").convert("RGB"))
        s, b, k, cls = (x[0].numpy() for x in infer(demo.load_image(img, 96)[None]))
        for got, want in zip((r["scores"], r["boxes"], r["keep"], r["classes"]), (s, b, k, cls)):
            np.testing.assert_array_equal(got, want)
        sel = k & (s > 0.3)
        tracks = tracker.update(b[sel], cls[: len(b)][sel], s[sel])
        assert [(i, lab, sc) for i, _, lab, sc in r["tracks"]] == [
            (x.track_id, x.label, x.score) for x in tracks]
        for (_, box, _, _), x in zip(r["tracks"], tracks):
            np.testing.assert_array_equal(box, x.box)
    assert results[0]["scores"].shape == (20,) and results[0]["classes"].shape == (20,)
    assert any(r["tracks"] for r in results)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            demo.main(["--input", str(frames), "--output", str(tmp_path / "o2"), *TINY_FLAGS])

"""The detection slice as a whole against the JAX package, on the CPU in f32:
a tiny vCLR DINO detector (ResNet-18, embed 64, 2 + 2 layers, 40 queries, 5
classes, one 96x128 image) with numpy-seeded weights carried across by
utils/jax_params.dino_from_flax, from both parameter layouts of the flax
transformer (unrolled and ``scan_layers``), and ``DetPredictor`` against
``train_net.evaluate_detector``'s ``_infer`` re-stated with the JAX functions.

The JAX side samples through its CPU default (``ms_deform_attn_xla``), the
port through K9's plain version: one function in f32.  What precedes the
top-k proposal selection (encoder memory, proposal scores) is held tightly
and the selected token indices must be EQUAL before anything after the
selection is compared, so that a failure reads as "selection differs".
Outputs: atol 2e-3 / rtol 1e-3, the whole-model bar of tests/test_swin_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import dino as jdino
from ir_ads_tpu.detection.transformer import make_output_proposals
from ir_ads_tpu.utils.torch_import import stack_decoder_layers, stack_encoder_layers
from ir_ads_tpu_torch.detection.dino import DINODetector
from ir_ads_tpu_torch.serve import DetPredictor
from ir_ads_tpu_torch.utils.jax_params import dino_from_flax
from test_torch_model import random_variables

TINY = dict(num_classes=5, num_queries=40, embed_dim=64, num_encoder_layers=2,
            num_decoder_layers=2, backbone_arch="resnet18")
H, W = 96, 128
SHAPES = ((12, 16), (6, 8), (3, 4), (2, 2))
EVAL_KEYS = ("pred_logits", "pred_boxes", "pred_rois", "pred_queries", "enc_logits",
             "enc_boxes", "enc_rois")
ATOL, RTOL = 2e-3, 1e-3


def _image():
    return (np.random.RandomState(40).rand(1, H, W, 3) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def flax_model():
    """The unrolled flax detector and its variables: every kernel ~ N(0,
    1/fan_in), the zero-initialised sampling projections included, so that
    activations keep their size through the depth and every query samples
    its own pattern."""
    model = jdino.DINODetector(**TINY)
    variables = random_variables(model, 41, jnp.asarray(_image()))
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: a / 0.05 / np.sqrt(np.prod(a.shape[:-1]))
        if path[-1].key == "kernel" else a, variables["params"])
    tr = variables["params"]["transformer"]
    for name in ("level_embeds", "tgt_embed"):
        tr[name] = tr[name] * 10  # embeddings of order 0.5
    return model, variables


@pytest.fixture(scope="module")
def port_model(flax_model):
    model = DINODetector(**TINY)
    model.load_state_dict(dino_from_flax(flax_model[1]))
    return model.eval()


def _assert_close(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def test_bridge_fills_every_key_and_leaves_none(flax_model):
    sd = dino_from_flax(flax_model[1])
    want = DINODetector(**TINY).state_dict()
    assert set(sd) == set(want)
    for name, t in want.items():
        assert tuple(sd[name].shape) == tuple(t.shape), name


@pytest.mark.parametrize("want_masks", [True, False])
def test_detector_matches_jax(flax_model, port_model, want_masks):
    model, variables = flax_model
    image = _image()
    want, state = model.apply(variables, jnp.asarray(image), train=False,
                              want_masks=want_masks, capture_intermediates=True,
                              mutable=["intermediates"])
    seen = {}
    hook = port_model.transformer.register_forward_hook(
        lambda mod, args, out: seen.update(out))
    with torch.no_grad():
        got = port_model(torch.from_numpy(image), want_masks=want_masks)
    hook.remove()
    # the detector returns the reference's eval dict and nothing besides
    # (n_dn and n_groups there are the denoising queries' bookkeeping)
    assert set(got) == set(want) - {"n_dn", "n_groups"}

    # before the selection: encoder memory and proposal scores, tightly
    inter = state["intermediates"]["transformer"]
    memory = inter[f"encoder_{TINY['num_encoder_layers'] - 1}"]["__call__"][0]
    enc_class = inter[f"class_embed_{TINY['num_decoder_layers']}"]["__call__"][0]
    valid = make_output_proposals(SHAPES)[1]
    scores = jnp.where(valid[None], enc_class.max(-1), -jnp.inf)
    np.testing.assert_allclose(seen["memory"].numpy(), np.asarray(memory), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(seen["enc_scores"].numpy(), np.asarray(scores), atol=1e-4,
                               rtol=1e-4)
    assert float(np.abs(np.asarray(memory)).mean()) > 0.1
    # the selection itself
    topk_idx = jax.lax.top_k(scores, TINY["num_queries"])[1]
    np.testing.assert_array_equal(seen["topk_idx"].numpy(), np.asarray(topk_idx),
                                  err_msg="the selected proposals differ")
    # after it
    keys = EVAL_KEYS + (("pred_masks", "enc_masks") if want_masks else ())
    assert ("pred_masks" in got) == ("pred_masks" in want) == want_masks
    for key in keys:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _assert_close(got[key], want[key], key)
    np.testing.assert_array_equal(got["pred_logits"][-1].argmax(-1).numpy(),
                                  np.asarray(want["pred_logits"][-1].argmax(-1)))


def test_detector_matches_jax_from_the_scan_layout(flax_model, port_model):
    """The same weights stacked as ``scan_layers=True`` holds them: the
    bridge must give the same state_dict, and the port must match the
    scanned flax detector."""
    variables = flax_model[1]
    tr = stack_decoder_layers(stack_encoder_layers(variables["params"]["transformer"]))
    assert "encoder_scan" in tr and "decoder_scan" in tr and "encoder_0" not in tr
    scanned = {"params": {**variables["params"], "transformer": tr},
               "batch_stats": variables["batch_stats"]}
    sd, want_sd = dino_from_flax(scanned), port_model.state_dict()
    assert set(sd) == set(want_sd)
    for name, t in want_sd.items():
        assert torch.equal(sd[name], t), name

    image = _image()
    scan_model = jdino.DINODetector(**TINY, scan_layers=True)
    want = jax.jit(lambda v, x: scan_model.apply(v, x, train=False))(
        scanned, jnp.asarray(image))
    port = DINODetector(**TINY)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(image))
    for key in EVAL_KEYS + ("pred_masks", "enc_masks"):
        _assert_close(got[key], want[key], key)


def test_det_predictor_matches_infer(flax_model):
    """``DetPredictor(device="cpu")`` against ``_infer`` of
    train_net.evaluate_detector, re-stated here with the JAX functions."""
    model, variables = flax_model
    topk = 15

    def infer(imgs):
        out = model.apply(variables, imgs, train=False)
        logits = out["pred_logits"][-1].astype(jnp.float32)
        boxes = out["pred_boxes"][-1]
        masks = out["pred_masks"][-1]
        scores = jax.nn.sigmoid(logits)
        mask_prob = jax.nn.sigmoid(masks.astype(jnp.float32))
        mask_fg = (masks > 0).astype(jnp.float32)
        mask_score = (mask_fg * mask_prob).sum((-2, -1)) / (mask_fg.sum((-2, -1)) + 1e-10)
        cls_scores = jnp.sqrt(scores.max(-1) * jnp.maximum(mask_score, 1e-6))
        cls_ids = scores.argmax(-1)
        s, xyxy, keep = jdino.nms_topk(cls_scores, boxes, topk=min(topk, boxes.shape[1]),
                                       iou_thresh=0.3)
        order = jnp.argsort(-jnp.where(keep, s, -1.0), axis=1)
        return s, xyxy, keep, cls_ids, order, masks

    pred = DetPredictor(device="cpu", dtype=torch.float32, topk=topk, iou_thresh=0.3,
                        num_classes=TINY["num_classes"], num_queries=TINY["num_queries"],
                        model_kwargs={k: v for k, v in TINY.items()
                                      if k not in ("num_classes", "num_queries")})
    pred.model.load_state_dict(dino_from_flax(variables))
    image = _image().astype(np.uint8)  # a raw frame, as a request brings it
    want = infer(jnp.asarray(image, jnp.float32))
    got = pred(image, want_masks=True)
    assert len(got) == 6 and len(pred(image)) == 5
    s, xyxy, keep, cls_ids, order, masks = got
    _assert_close(masks, want[5], "masks")
    _assert_close(s, want[0], "scores")
    _assert_close(xyxy, want[1], "boxes")
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(cls_ids.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want[4]))
    assert 1 <= int(keep.sum()) <= topk


def test_det_predictor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetPredictor()


def test_det_predictor_draws_the_sampling_projections():
    """At the reference's init (zero sampling_offsets and attention_weights)
    every query samples one pattern; the predictor's seeded weights must not
    leave them there, and two seeds must differ."""
    kw = dict(device="cpu", dtype=torch.float32, num_classes=5, num_queries=40,
              model_kwargs={k: v for k, v in TINY.items()
                            if k not in ("num_classes", "num_queries")})
    a, b = DetPredictor(seed=0, **kw), DetPredictor(seed=1, **kw)
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    for name, t in sd_a.items():
        if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
            assert float(t.std()) > 0.05, name
        if t.is_floating_point() and t.numel() > 4:
            assert not torch.equal(t, sd_b[name]), name

"""The port's semseg evaluation against the JAX package's, on the CPU in f32
with the tiny model (``test_torch_model.TINY``), weights written by
``ir_ads_tpu.utils.checkpoint.save_weights`` and read by the port's
``load_weights`` + ``from_flax``.

  * The val slice end to end: the JAX ``Synthetic`` val split through its
    val augmentation, loader, ``msf_logits`` (two scales, flip) and
    ``Metrics``, with the Pallas kernels interpreted under ``R5_ENV``,
    against ``ir_ads_tpu_torch.val_mm.main`` on the same config.  At 64x128
    every DSCF level has 2n = 16 keys (the rows path, K3 + K4) and at scale
    0.75 (64x96) 2n = 12 (the einsum branch, K6's bias at level 3).  Probabilities
    to atol 2e-3 / rtol 1e-3; the confusion matrices equal but for pixels
    whose top two JAX probabilities lie within that tolerance (counted and
    bounded); mIoU, mF1 and mAcc to 0.01.  One align_corners=True resize in
    place of the two-stage resize must miss the probabilities.
  * Sliding mode against JAX's split form (``fuse=False``) with two tiles.
  * ``Metrics`` alone, with ignore labels; every configs/*.yaml through
    both loaders; the eval forward runs the fused head only; the raw cache
    path gives the host-normalised path's metrics; ``SemSegPredictor``'s
    logits are those of the model it built before the eval forward, and a
    JAX checkpoint loads into it; ``infer_mm``'s colour output against the
    JAX infer_mm.py's; the entry points import nothing of JAX.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ir_ads_tpu.data.augmentations import get_val_augmentation as jax_val_aug
from ir_ads_tpu.data.datasets import Synthetic as JaxSynthetic
from ir_ads_tpu.data.loader import DataLoader as JaxLoader
from ir_ads_tpu.evaluation import semseg_eval as jeval
from ir_ads_tpu.models import build_model as jax_build_model
from ir_ads_tpu.training.metrics import Metrics as JaxMetrics
from ir_ads_tpu.utils.checkpoint import save_weights
from ir_ads_tpu.utils.config import load_config as jax_load_config
from ir_ads_tpu_torch import val_mm
from ir_ads_tpu_torch.evaluation import semseg_eval as teval
from ir_ads_tpu_torch.models import build_model
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops.layers import resize_bilinear
from ir_ads_tpu_torch.serve import SemSegPredictor, cast_model_, init_random_
from ir_ads_tpu_torch.training.metrics import Metrics
from ir_ads_tpu_torch.utils.config import DEFAULTS, _merge, load_config
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY
from test_torch_slice_r5 import R5_ENV
from test_torch_spatial_shard import keep_sharded_logits

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 128
CLASSES = 5
SCALES = (0.75, 1.0)
ATOL, RTOL = 2e-3, 1e-3


def _cfg(weights, **eval_cfg):
    return _merge(DEFAULTS, {
        "MODEL": {"BACKBONE_KWARGS": dict(TINY)},
        "DATASET": {"NAME": "Synthetic", "ROOT": "",
                    "KWARGS": {"image_size": [H, W], "num_classes": CLASSES, "length": 2}},
        "TRAIN": {"AMP": False},
        "EVAL": {"MODEL_PATH": str(weights), "IMAGE_SIZE": [H, W], "BATCH_SIZE": 2,
                 **eval_cfg},
    })


def fan_in_variables(module, seed, *args):
    """``random_variables`` with every kernel ~ N(0, 1/fan_in), as
    ``serve.init_random_`` draws them: the logits then vary across pixels by
    about a tenth of a unit (0.05 draws leave them flat to 1e-2, where no
    resize could be told from another)."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "var":
            v = 0.5 + rng.rand(*leaf.shape)
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model as its val_mm builds it (fused head upsampled), with
    numpy-seeded variables saved by the JAX checkpoint writer."""
    model = jax_build_model("CMNeXt", "SwinTransformer-B", num_classes=CLASSES, dtype=None,
                            backbone_kwargs=dict(TINY, drop_path_rate=0.0))
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    return model, fan_in_variables(model, 20, x, x)


@pytest.fixture
def weights(jax_model, tmp_path):
    path = tmp_path / "best" / "weights.msgpack"
    v = jax_model[1]
    save_weights(str(path), v["params"], v["batch_stats"])
    return path


def _jax_batches(n=2, batch=2):
    ds = JaxSynthetic("", "val", jax_val_aug((H, W)), ["img", "depth"], length=n,
                      image_size=(H, W), num_classes=CLASSES)
    return list(JaxLoader(ds, batch, shuffle=False, drop_last=False))


def _near_ties(probs, tol_atol, tol_rtol):
    """Pixels whose two largest probabilities lie within the tolerance."""
    top = np.sort(probs, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0] <= 2 * (tol_atol + tol_rtol * top[..., 1])


def _msf_one_resize(forward, rgb, dte, scales, flip=True):
    """Planted fault: the head-native logits resized once, align_corners=True,
    straight to the full size."""
    b, h, w = rgb.shape[:3]
    acc = 0.0
    for s in scales:
        size = (teval.align32(s * h), teval.align32(s * w))
        sr = resize_bilinear(rgb, size, align_corners=True)
        sd = resize_bilinear(dte, size, align_corners=True)
        logits = forward(torch.cat([sr, sr.flip(2)]), torch.cat([sd, sd.flip(2)]))
        logits = torch.cat([logits[:b], logits[b:].flip(2)])
        probs = torch.softmax(resize_bilinear(logits, (h, w), align_corners=True).float(), -1)
        acc = acc + probs[:b] + probs[b:]
    return acc


def test_val_slice_msf_matches_jax_r5(jax_model, weights, monkeypatch):
    for k, v in R5_ENV.items():
        monkeypatch.setenv(k, v)
    model, variables = jax_model
    jfwd = jeval.make_forward_fn(model, variables)
    jmetrics = JaxMetrics(CLASSES, 255)
    cfg = _cfg(weights, MSF={"ENABLE": True, "FLIP": True, "SCALES": list(SCALES)})
    port = val_mm.build_eval_model(cfg, CLASSES, "cpu")
    assert [m.deform_atten.branch(n) for m, n in zip(port.backbone.DeformMPGBlocks,
                                                     (8, 8, 8, 8))] == ["pallas3"] * 3 + ["xla"]
    tfwd = teval.make_forward_fn(port)
    [(rgb, dte, label)] = _jax_batches()
    want = np.asarray(jeval.msf_logits(jfwd, jnp.asarray(rgb), jnp.asarray(dte), SCALES))
    jmetrics.update(jnp.argmax(jnp.asarray(want), -1), jnp.asarray(label))
    rgb_t, dte_t = torch.from_numpy(rgb), torch.from_numpy(dte)
    got = teval.msf_logits(tfwd, rgb_t, dte_t, SCALES)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    near = _near_ties(want, ATOL, RTOL)
    apart = got.argmax(-1).numpy() != want.argmax(-1)
    print(f"near ties {int(near.sum())} of {near.size} pixels, labels apart {int(apart.sum())}")
    assert not (apart & ~near).any(), "labels differ away from a near tie"
    assert near.sum() <= 0.01 * near.size

    # the planted fault: one align_corners=True resize must miss the bar
    bad = _msf_one_resize(tfwd, rgb_t, dte_t, SCALES).numpy()
    assert not np.allclose(bad, want, atol=ATOL, rtol=RTOL)

    # the entry point: dataset, val augmentation, loader, evaluate, Metrics
    result = val_mm.main(cfg, device="cpu")
    assert result["mode"] == "msf" and result["images"] == 2 and len(result["latency_s"]) == 1
    assert abs(result["miou"] - jmetrics.compute_iou()[1]) <= 0.01
    assert abs(result["mf1"] - jmetrics.compute_f1()[1]) <= 0.01
    assert abs(result["macc"] - jmetrics.compute_pixel_acc()[1]) <= 0.01
    # the confusion matrices: equal but for the differing near ties
    tm = Metrics(CLASSES, 255)
    tm.update(got, torch.from_numpy(label))
    hist = tm.hist.numpy()
    assert np.abs(hist - np.asarray(jmetrics.hist)).sum() <= 2 * int(apart.sum())
    assert int(hist.sum()) == int(np.asarray(jmetrics.hist).sum())
    reports = list(weights.parent.glob("eval_*.txt"))
    assert len(reports) == 1 and reports[0].read_text().splitlines()[-1].startswith("Mean")


def test_sliding_matches_jax_split_form(jax_model, monkeypatch):
    """Two 64x96 tiles of each 64x128 image, flip: JAX's split form (what
    val_mm.py runs) on head-native logits against the port's."""
    for k, v in R5_ENV.items():
        monkeypatch.setenv(k, v)
    model, variables = jax_model
    native = model.clone(upsample_logits=False)
    assert teval.tile_grid(W, 96, 64) == [0, 32]
    rgb, dte, _ = _jax_batches(2)[0]
    jpredict = jeval.make_sliding_window_fn(
        jeval.make_forward_fn(native, variables), (H, W), (H, 96), CLASSES, fuse=False)
    want = np.asarray(jpredict(jnp.asarray(rgb), jnp.asarray(dte)))
    port = build_model("CMNeXt", "SwinTransformer-B", CLASSES, backbone_kwargs=TINY,
                       state_dict=from_flax(variables), upsample_logits=False)
    predict = teval.make_sliding_window_fn(teval.make_forward_fn(port), (H, W), (H, 96), CLASSES)
    got = predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_metrics_match_jax():
    rng = np.random.RandomState(3)
    c = 7
    jm, tm = JaxMetrics(c, 255), Metrics(c, 255)
    for _ in range(3):
        pred = rng.randint(0, c, (2, 9, 11))
        label = rng.randint(0, c, (2, 9, 11))
        label[rng.rand(2, 9, 11) < 0.2] = 255
        logits = rng.randn(2, 9, 11, c).astype(np.float32)
        jm.update(jnp.asarray(pred), jnp.asarray(label))
        tm.update(torch.from_numpy(pred), torch.from_numpy(label))
        jm.update(jnp.asarray(logits), jnp.asarray(label))
        tm.update(torch.from_numpy(logits), label)
    assert tm.hist.dtype == torch.int64
    np.testing.assert_array_equal(tm.hist.numpy(), np.asarray(jm.hist).astype(np.int64))
    for name in ("compute_iou", "compute_f1", "compute_pixel_acc"):
        assert getattr(tm, name)() == getattr(jm, name)()
    tm.reset()
    assert int(tm.hist.sum()) == 0


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_config_loads_as_jax(path):
    assert load_config(str(path)) == jax_load_config(str(path))


def test_card_config_is_phase_7s():
    """The port's card config is the dict chip_smoke.py's phase 7 drives."""
    monkey = pytest.MonkeyPatch()
    monkey.syspath_prepend(str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        monkey.undo()
    cfg = load_config(str(ROOT / "ir_ads_tpu_torch" / "configs" / "nyu_rgbd_synthetic.yaml"))
    assert cfg == smoke.eval_config("msf")


@pytest.mark.parametrize("upsample", [False, True])
def test_forward_fn_runs_the_fused_head_only(upsample):
    torch.manual_seed(0)
    model = CMNeXt(num_classes=CLASSES, backbone_kwargs=TINY, head_dims=(32, 16),
                   upsample_logits=upsample)
    init_random_(model, 4)
    model.eval()
    rgb, dte = torch.randn(2, H, W, 3), torch.randn(2, H, W, 3)
    with torch.no_grad():
        want = model(rgb, dte)[0]
    ran = []
    hooks = [getattr(model, n).register_forward_hook(lambda *a, n=n: ran.append(n))
             for n in ("decode_head", "decode_head_rgb", "decode_head_dte")]
    got = teval.make_forward_fn(model)(rgb, dte)
    for h in hooks:
        h.remove()
    assert ran == ["decode_head"]
    assert torch.equal(got, want)


def test_predictor_keeps_its_logits_and_loads_a_checkpoint(jax_model, weights):
    """The predictor's logits equal those of the model it built before it
    ran the eval forward (CMNeXt, init_random_, cast, forward(...)[0]), in
    bf16; a JAX checkpoint by path gives the logits of the same weights by
    state_dict."""
    kw = dict(device="cpu", num_classes=CLASSES, image_size=(H, W), backbone_kwargs=TINY,
              head_dims=(32, 16), seed=5)
    g = np.random.RandomState(6)
    rgb = g.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    dep = g.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    pred = SemSegPredictor(**kw)
    got, labels = pred(rgb, dep)
    old = CMNeXt(num_classes=CLASSES, backbone_kwargs=TINY, head_dims=(32, 16),
                 upsample_logits=False)
    init_random_(old, 5)
    cast_model_(old, torch.bfloat16)
    old.eval()
    predict = teval.make_sliding_window_fn(lambda r, d: old(r, d)[0], (H, W), (H, W), CLASSES)
    with torch.no_grad():
        want = predict(*pred.normalize(rgb, dep))
    assert torch.equal(got, want) and torch.equal(labels, want.argmax(-1))

    kw.update(dtype=torch.float32, head_dims=(512, 256))
    by_path = SemSegPredictor(model_path=str(weights.parent), **kw)(rgb, dep)[0]
    by_dict = SemSegPredictor(state_dict=from_flax(jax_model[1]), **kw)(rgb, dep)[0]
    assert torch.equal(by_path, by_dict)


def test_cache_path_and_single_scale(weights, tmp_path, monkeypatch):
    """Single-scale eval from a RawCache (uint8 batches normalised on the
    device) gives the host-normalised path's metrics; the sharded eval runs
    from it too, its zero halo rows normalised on the device as the JAX
    val_mm.py's are (tests/test_torch_spatial_shard.py holds its logits)."""
    plain = val_mm.main(_cfg(weights), device="cpu")
    cached = val_mm.main(_cfg(weights, CACHE_DIR=str(tmp_path / "cache")), device="cpu")
    assert plain["mode"] == cached["mode"] == "single-scale"
    assert (plain["miou"], plain["mf1"], plain["macc"]) == (
        cached["miou"], cached["mf1"], cached["macc"])
    assert json.loads((tmp_path / "cache" / "meta.json").read_text())["n"] == 2
    kept = keep_sharded_logits(monkeypatch)
    sharded = val_mm.main(_cfg(weights, CACHE_DIR=str(tmp_path / "cache"),
                               SPATIAL_SHARD={"ENABLE": True, "HALO": 16}), device="cpu")
    assert sharded["mode"] == "spatial_shard" and np.isfinite(sharded["miou"])
    assert [tuple(t.shape) for t in kept] == [(2, H, W, CLASSES)]


def test_legacy_backbones_raise():
    """The legacy models build under every dispatch the JAX package gives a
    meaning for them (tests/test_torch_legacy_dispatch.py,
    tests/test_torch_legacy_train.py), dscf_pallas and dscf_pallas2 too
    (K17 at every MiT stage, at 8, 8, 10 and 8 channels a head), and raise
    where the port has no counterpart: the Swin options."""
    for bb in ("CMNeXt-B2", "CMX-B2"):
        for dispatch in ("dscf_pallas", "dscf_pallas2"):
            model = build_model("CMNeXt", bb, CLASSES, dispatch=dispatch)
            dscf = [m.deform_atten for m in getattr(model.backbone, "DeformMPGBlocks", ())]
            assert [(d.attn_impl, d.proj_q.out_channels // d.n_heads) for d in dscf] == (
                [(dispatch[len("dscf_"):], hc) for hc in (8, 8, 10, 8)]
                if bb == "CMNeXt-B2" else [])
        for key in ("dual_batch", "use_remat"):
            with pytest.raises(ValueError, match=key):
                build_model("CMNeXt", bb, CLASSES, backbone_kwargs={key: True})
        with pytest.raises(ValueError, match="head_dims"):
            build_model("CMNeXt", bb, CLASSES, head_dims=(512, 256))


def test_infer_matches_jax_infer_mm(jax_model, weights, tmp_path, monkeypatch):
    """infer_mm's colour prediction of a synthesized 50x70 PNG (resized to
    64x96, predicted, resized back by nearest) against the JAX infer_mm.py's on
    the same weights; pixels whose source label is a near tie of the JAX
    logits may differ.  predict_array runs without PIL."""
    monkeypatch.setenv("IR_ADS_COMPILE_CACHE", "0")  # the JAX infer_mm.py's disk cache
    monkeypatch.syspath_prepend(str(ROOT))
    jinfer = importlib.import_module("infer_mm")
    from ir_ads_tpu_torch import infer_mm

    cfg = _merge(jax_load_config(str(ROOT / "configs" / "mfnet_rgbt.yaml")), {
        "MODEL": {"BACKBONE_KWARGS": dict(TINY, drop_path_rate=0.0)},
        "TRAIN": {"AMP": False},
        "EVAL": {"MODEL_PATH": str(weights), "IMAGE_SIZE": [64, 64]}})
    g = np.random.RandomState(8)
    png = tmp_path / "frame.png"
    Image.fromarray(g.randint(0, 256, (50, 70, 3)).astype(np.uint8)).save(png)
    # MFNet has 9 classes: new weights of that head width
    model9 = jax_build_model("CMNeXt", "SwinTransformer-B", num_classes=9, dtype=None,
                             backbone_kwargs=dict(TINY, drop_path_rate=0.0))
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    v9 = fan_in_variables(model9, 21, x, x)
    save_weights(str(weights), v9["params"], v9["batch_stats"])

    # the JAX infer_mm.py's SemSeg without its __init__, whose flax init of the
    # model runs op by op (about 100 s here): the same model and weights
    jseg = object.__new__(jinfer.SemSeg)
    jseg.size, jseg.palette = cfg["EVAL"]["IMAGE_SIZE"], jinfer.get_dataset("MFNet").PALETTE
    jfwd = jax.jit(lambda v, r, d: model9.apply(v, r, d, train=False)[0])
    jseg._forward = lambda r, d: jfwd(v9, r, d)
    want, _ = jseg.predict(str(png))
    tseg = infer_mm.SemSeg(cfg, device="cpu")
    got, _ = tseg.predict(str(png))
    assert got.shape == want.shape == (50, 70, 3)
    rgb = np.asarray(Image.open(png).convert("RGB"))
    xr = jseg.preprocess(rgb)
    logits = np.asarray(jseg._forward(
        ((xr / 255.0 - jinfer.IMAGENET_MEAN) / jinfer.IMAGENET_STD)[None], (xr / 255.0)[None]))
    near = _near_ties(logits[0], ATOL, RTOL)
    # the source pixel of each output pixel under the nearest resize
    idx = np.arange(near.size, dtype=np.int32).reshape(near.shape)
    src = np.asarray(Image.fromarray(idx, mode="I").resize((70, 50), Image.NEAREST))
    apart = (got != want).any(-1)
    assert not (apart & ~near.reshape(-1)[src]).any()
    assert apart.mean() <= 0.01
    arr, _ = tseg.predict_array(rgb)
    assert arr.shape == (50, 70, 3) and arr.dtype == np.uint8


@pytest.mark.parametrize("module", ["ir_ads_tpu_torch.val_mm", "ir_ads_tpu_torch.infer_mm"])
def test_entry_points_import_no_jax(module):
    code = (f"import sys, {module}; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ir_ads_tpu')); print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

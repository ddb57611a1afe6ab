"""The anomaly stack on the port against the JAX package, on the CPU in f32.

- ``anomaly.data``: ``MVTecAD``, ``balanced_batches`` and ``test_batches``
  on a synthesized 32x32 tree, bit for bit, also with training-set
  pollution (``cont_rate``) and an outlier-exposure root.
- ``deviation_loss`` in both forms (the reference's 5000 samples as a
  tensor, drawn by ``jax.random`` under the JAX function's key).
- ``AnomalyScoreNet`` (ResNet-18 at 32x32, batch 6; ResNet-50 in eval) with
  flax weights carried over by ``utils.jax_params.anomaly_from_flax``: eval
  and train outputs, the new batch statistics, one step's loss and
  gradients against ``jax.value_and_grad``; atol 2e-3 / rtol 1e-3, the
  slices' standing bar, and each parameter group's gradient within 1e-3 of
  JAX's in norm.
- Every LightSB function, diagonal and rotated, dim 8, n 3, batch 5, atol /
  rtol 1e-4, the draws made by ``jax.random`` under the keys the JAX
  functions split; ``fit_lightsb`` for 20 steps within 2e-3 / 1e-3.
- ``train_ad.auroc`` equal to the JAX driver's, ties included; the entry
  point with ``tests/test_anomaly.py``'s flags, its weights read by JAX's
  ``load_weights``, and JAX-written weights scoring as JAX scores.

The JAX models run jitted with LLVM's cheap settings (``FAST_COMPILE``) and
the port in one thread.
"""

import runpy
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.anomaly import data as jdata
from ir_ads_tpu.anomaly import deviation as jdev
from ir_ads_tpu.anomaly import sb as jsb
from ir_ads_tpu_torch import train_ad
from ir_ads_tpu_torch.anomaly import data as pdata
from ir_ads_tpu_torch.anomaly import sb as psb
from ir_ads_tpu_torch.anomaly.deviation import AnomalyScoreNet, deviation_loss
from ir_ads_tpu_torch.utils.checkpoint import load_anomaly_weights, save_anomaly_weights
from ir_ads_tpu_torch.utils.jax_params import anomaly_from_flax, anomaly_to_flax
from ir_ads_tpu_torch.utils.logging import get_logger

ATOL, RTOL = 2e-3, 1e-3
SB_TOL = 1e-4
GROUP_REL = 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
CLASSES = [("train", ["good"], 12), ("test", ["good", "crack", "hole"], 4)]


def _jit(f, **kw):
    return jax.jit(f, compiler_options=FAST_COMPILE, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_tree(root, classname, splits, seed):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for split, classes, n in splits:
        for cl in classes:
            d = root / classname / split / cl
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                    d / f"{i:03d}.png")


@pytest.fixture(scope="module")
def fake_mvtec(tmp_path_factory):
    """``tests/test_anomaly.py``'s tree (widget), plus a second class whose
    train/good images an outlier-exposure run reads."""
    root = tmp_path_factory.mktemp("mvtec")
    _write_tree(root, "widget", CLASSES, 0)
    _write_tree(root, "gadget", [("train", ["good"], 5)], 1)
    return root


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(know_class="crack", n_anomaly=2),
    dict(know_class=None, n_anomaly=3, cont_rate=0.2),
    dict(know_class="hole", n_anomaly=2, outlier_root=True),
], ids=["know_class", "cont_rate", "outlier_root"])
def test_dataset_and_batches_bit_equal(fake_mvtec, opts):
    opts = dict(opts)
    if opts.pop("outlier_root", False):
        opts["outlier_root"] = str(fake_mvtec)
    kw = dict(dataset_root=str(fake_mvtec), classname="widget", img_size=32, **opts)
    for train in (True, False):
        want = jdata.MVTecAD(jdata.ADConfig(**kw), train=train)
        got = pdata.MVTecAD(pdata.ADConfig(**kw), train=train)
        assert got.images == want.images
        for name in ("labels", "normal_idx", "outlier_idx"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert got.ood_data == want.ood_data
        if train:
            for seed in (10, 11):
                pairs = zip(pdata.balanced_batches(got, 6, 3, seed=seed),
                            jdata.balanced_batches(want, 6, 3, seed=seed))
                for (gi, gl), (wi, wl) in pairs:
                    np.testing.assert_array_equal(gi, wi)
                    np.testing.assert_array_equal(gl, wl)
        for (gi, gl), (wi, wl) in zip(pdata.test_batches(got, 5),
                                      jdata.test_batches(want, 5)):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    if "outlier_root" in opts:  # the exposure images were drawn (label 2 from gadget)
        assert got.ood_data and all("gadget" in p for p in got.ood_data)


# --------------------------------------------------------------------------
# the deviation loss and the score network
# --------------------------------------------------------------------------

def test_deviation_loss_both_forms():
    rng = np.random.RandomState(0)
    y_pred = (rng.randn(16) * 3).astype(np.float32)
    y_true = (rng.rand(16) > 0.5).astype(np.float32)
    got = deviation_loss(torch.from_numpy(y_pred), torch.from_numpy(y_true))
    want = jdev.deviation_loss(jnp.asarray(y_pred), jnp.asarray(y_true))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    key = jax.random.PRNGKey(3)
    ref = np.array(jax.random.normal(key, (5000,)))
    got = deviation_loss(torch.from_numpy(y_pred), torch.from_numpy(y_true),
                         ref=torch.from_numpy(ref))
    want = jdev.deviation_loss(jnp.asarray(y_pred), jnp.asarray(y_true), key=key)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    # torch's default std (unbiased) misses JAX's population std at this bar
    r = torch.from_numpy(ref)
    unbiased = deviation_loss((torch.from_numpy(y_pred) - r.mean()) / r.std(),
                              torch.from_numpy(y_true))
    assert abs(float(unbiased) - float(want)) > 1e-6


def _variables(backbone, seed, size=32):
    """numpy-seeded flax variables of ``AnomalyScoreNet``: kernels N(0,
    1 / fan_in), BatchNorm scale 1 +- 0.1, bias, mean +- 0.05-0.1, var 0.5-1.5."""
    model = jdev.AnomalyScoreNet(backbone=backbone)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, size, size, 3))))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*leaf.shape)
        elif name == "var":
            v = 0.5 + rng.rand(*leaf.shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*leaf.shape)
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return np.asarray(v, np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _port(variables, backbone="resnet18"):
    model = AnomalyScoreNet(backbone)
    model.load_state_dict(anomaly_from_flax(variables))
    return model


def _images(seed, n=6, size=32):
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, size, size, 3).astype(np.float32) - pdata.IMAGENET_MEAN)
            / pdata.IMAGENET_STD).astype(np.float32)


@pytest.fixture(scope="module")
def r18():
    """The ResNet-18 score network, its variables and its jitted eval apply."""
    model, variables = _variables("resnet18", 7)
    return model, variables, _jit(lambda v, x: model.apply(v, x, train=False))


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=name)


def test_score_net_eval_and_train_forward(r18):
    model, variables, infer = r18
    port = _port(variables)
    x = _images(1)
    want = infer(variables, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    for g, w, name in zip(got, want, ("score", "pooled")):
        _close(g, w, f"eval {name}")
    (want, mut) = _jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    for g, w, name in zip(got, want, ("score", "pooled")):
        _close(g, w, f"train {name}")
    new_stats = anomaly_from_flax({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    sd = port.state_dict()
    assert sum(n.endswith("running_mean") for n in new_stats) == 20  # ResNet-18's norms
    for name, want_t in new_stats.items():
        if name.endswith(("running_mean", "running_var")):
            _close(sd[name], want_t.numpy(), name)
    # the round trip of the names
    back = anomaly_from_flax(anomaly_to_flax(sd))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_score_net_resnet50_eval():
    model, variables = _variables("resnet50", 8)
    x = _images(2, n=2)
    want = _jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = _port(variables, "resnet50").eval()(torch.from_numpy(x))
    for g, w, name in zip(got, want, ("score", "pooled")):
        _close(g, w, name)


def _group(name):
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "features" else parts[0]


def test_deviation_step_loss_and_gradients(r18):
    """One step of train_ad's: the loss and each parameter group's gradient
    (stem, res2-res5, head) against JAX's ``value_and_grad`` of the JAX
    driver's loss."""
    model, variables, _ = r18
    x = _images(3)
    labels = np.asarray([0, 0, 2, 0, 1, 1], np.int32)

    def loss_fn(params, batch_stats, imgs, labels):
        (score, _), _ = model.apply({"params": params, "batch_stats": batch_stats}, imgs,
                                    train=True, mutable=["batch_stats"])
        return jdev.deviation_loss(score, (labels > 0).astype(jnp.float32))

    loss, grads = _jit(jax.value_and_grad(loss_fn))(variables["params"],
                                                     variables["batch_stats"], x, labels)
    port = _port(variables)
    opt = torch.optim.SGD(port.parameters(), lr=0.0)  # the step's gradients kept
    got = train_ad.train_step(port, opt, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(loss), atol=ATOL, rtol=RTOL)
    want = anomaly_from_flax({"params": jax.tree.map(np.asarray, grads)})
    groups = {}
    for name, p in port.named_parameters():
        _close(p.grad, want[name].numpy(), name)
        d, n = groups.setdefault(_group(name), [0.0, 0.0])
        groups[_group(name)] = [d + float(((p.grad - want[name]) ** 2).sum()),
                                n + float((want[name] ** 2).sum())]
    assert set(groups) == {"features.stem", "features.res2", "features.res3",
                           "features.res4", "features.res5", "score_head"}
    for g, (d, n) in groups.items():
        assert np.sqrt(d / n) < GROUP_REL, (g, np.sqrt(d / n))


# --------------------------------------------------------------------------
# LightSB
# --------------------------------------------------------------------------

DIM, N, B = 8, 3, 5


def _sb_params(rotated, seed=0):
    rng = np.random.RandomState(seed)
    arrays = dict(
        log_alpha_raw=rng.randn(N).astype(np.float32) * 0.1,
        r=rng.randn(N, DIM).astype(np.float32),
        S_log_diag=rng.randn(N, DIM).astype(np.float32) * 0.3 - 1.0,
        S_rot_raw=rng.randn(N, DIM, DIM).astype(np.float32) if rotated else None)
    j = jsb.LightSBParams(**{k: None if v is None else jnp.asarray(v)
                             for k, v in arrays.items()})
    p = psb.LightSBParams(**{k: None if v is None else torch.from_numpy(v)
                             for k, v in arrays.items()})
    return j, p


def _sb_close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=SB_TOL,
                               rtol=SB_TOL, err_msg=name)


EPS, STEPS = 0.3, 4


def _jax_lightsb(jp, x, t, key):
    """Every JAX LightSB output on (x, t) and the draws its sampling
    functions take from ``key``, split as they split it (one compile)."""
    logits, r_x = jsb._exp_argument(jp, EPS, x)
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    return dict(
        S=jsb.get_S(jp), log_alpha=jsb.get_log_alpha(jp, EPS), logits=logits, r_x=r_x,
        log_C=jsb.get_log_C(jp, EPS, x), log_potential=jsb.get_log_potential(jp, EPS, x),
        drift=jsb.get_drift(jp, EPS, x, t),
        # sample_posterior: categorical(k1) = argmax(logits + gumbel(k1)), normal(k2)
        post_gumbel=jax.random.gumbel(k1, logits.shape, logits.dtype),
        post_categorical=jax.random.categorical(k1, logits, axis=-1),
        post_noise=jax.random.normal(k2, x.shape),
        posterior=jsb.sample_posterior(jp, EPS, x, key),
        # Euler-Maruyama: step i's noise from split(key, n_steps)[i]
        em_noise=jax.vmap(lambda k: jax.random.normal(k, x.shape))(
            jax.random.split(key, STEPS)),
        euler_maruyama=jsb.sample_euler_maruyama(jp, EPS, x, key, STEPS),
        # at a time moment: the posterior's draws from k1 (split again), the bridge's from k2
        tm_gumbel=jax.random.gumbel(ka, logits.shape, logits.dtype),
        tm_post_noise=jax.random.normal(kb, x.shape), tm_noise=jax.random.normal(k2, x.shape),
        time_moment=jsb.sample_at_time_moment(jp, EPS, x, 0.4, key))


@pytest.mark.parametrize("rotated", [False, True], ids=["diagonal", "rotated"])
def test_lightsb_functions(rotated):
    jp, pp = _sb_params(rotated)
    rng = np.random.RandomState(1)
    x = rng.randn(B, DIM).astype(np.float32)
    t = np.asarray([0.1, 0.3, 0.5, 0.7, 0.9], np.float32)
    want = jax.tree.map(np.array, _jit(_jax_lightsb)(jp, x, t, jax.random.PRNGKey(5)))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    draw = {k: torch.from_numpy(v) for k, v in want.items()}
    logits, r_x = psb._exp_argument(pp, EPS, xt)
    got = dict(S=psb.get_S(pp), log_alpha=psb.get_log_alpha(pp, EPS), logits=logits, r_x=r_x,
               log_C=psb.get_log_C(pp, EPS, xt), log_potential=psb.get_log_potential(pp, EPS, xt),
               drift=psb.get_drift(pp, EPS, xt, tt),
               posterior=psb.sample_posterior(pp, EPS, xt, draw["post_gumbel"],
                                              draw["post_noise"]),
               euler_maruyama=psb.sample_euler_maruyama(pp, EPS, xt, draw["em_noise"]),
               time_moment=psb.sample_at_time_moment(pp, EPS, xt, 0.4, draw["tm_gumbel"],
                                                     draw["tm_post_noise"], draw["tm_noise"]))
    np.testing.assert_array_equal(np.argmax(want["logits"] + want["post_gumbel"], -1),
                                  want["post_categorical"])
    assert got["euler_maruyama"].shape == (B, STEPS + 1, DIM)
    for name, g in got.items():
        _sb_close(g, want[name], name)
    with torch.no_grad():  # the drift takes its gradient inside no_grad too
        _sb_close(psb.get_drift(pp, EPS, xt, tt), want["drift"], "get_drift no_grad")


@pytest.mark.parametrize("diagonal", [True, False], ids=["diagonal", "rotated"])
def test_lightsb_init(diagonal):
    jp, jeps = jsb.init_lightsb(jax.random.PRNGKey(0), dim=DIM, n_potentials=N, epsilon=0.2,
                                is_diagonal=diagonal)
    pp, peps = psb.init_lightsb(torch.Generator().manual_seed(0), dim=DIM, n_potentials=N,
                                epsilon=0.2, is_diagonal=diagonal)
    assert peps == jeps
    for g, w in zip(pp, jp):
        assert (g is None) == (w is None)
        if g is not None:
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    _sb_close(pp.log_alpha_raw, jp.log_alpha_raw, "log_alpha_raw")
    _sb_close(pp.S_log_diag, jp.S_log_diag, "S_log_diag")
    samples = np.random.RandomState(2).randn(N, DIM).astype(np.float32)
    got = psb.init_r_by_samples(pp, torch.from_numpy(samples))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(
        jsb.init_r_by_samples(jp, jnp.asarray(samples)).r))


@pytest.fixture(scope="module")
def jax_train_ad():
    """The root driver, imported without its persistent compilation cache
    (it would write under the home directory)."""
    from ir_ads_tpu.utils import compile_cache

    compile_cache._done = True
    import train_ad as module

    return module


def test_fit_lightsb_20_steps(jax_train_ad):
    rng = np.random.RandomState(4)
    f0 = (rng.randn(40, DIM) * 0.5).astype(np.float32)
    f1 = (rng.randn(12, DIM) * 0.5 + 1.0).astype(np.float32)
    want, weps, wloss = jax_train_ad.fit_lightsb(jnp.asarray(f0), jnp.asarray(f1),
                                                 jax.random.PRNGKey(2), n_potentials=N,
                                                 steps=20)
    got, geps, gloss = train_ad.fit_lightsb(torch.from_numpy(f0), torch.from_numpy(f1),
                                            torch.Generator().manual_seed(2), n_potentials=N,
                                            steps=20)
    assert geps == weps and got.S_rot_raw is None
    np.testing.assert_allclose(gloss, wloss, atol=ATOL, rtol=RTOL)
    for g, w, name in zip(got[:3], want[:3], ("log_alpha_raw", "r", "S_log_diag")):
        _close(g, w, name)


def test_auroc_equal_with_ties(jax_train_ad):
    rng = np.random.RandomState(5)
    for _ in range(5):
        scores = rng.randint(0, 6, 40).astype(np.float32)  # many ties
        labels = rng.randint(0, 3, 40)
        assert train_ad.auroc(scores, labels) == jax_train_ad.auroc(scores, labels)
    assert train_ad.auroc(np.asarray([0.1, 0.4, 0.35, 0.8]), np.asarray([0, 0, 1, 1])) == 0.75
    assert np.isnan(train_ad.auroc(np.ones(3), np.zeros(3)))


# --------------------------------------------------------------------------
# the entry point and the weights file
# --------------------------------------------------------------------------

def test_train_ad_entry_point(fake_mvtec, tmp_path, monkeypatch, caplog):
    """``python -m ir_ads_tpu_torch.train_ad --device cpu`` with
    tests/test_anomaly.py's flags; JAX's ``load_weights`` reads the file
    into ``AnomalyScoreNet``'s template, and the port reads it back."""
    from ir_ads_tpu.utils.checkpoint import load_weights

    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "train_ad", "--dataset_root", str(fake_mvtec), "--classname", "widget",
        "--know_class", "crack", "--nAnomaly", "2", "--img_size", "32", "--batch_size", "6",
        "--steps_per_epoch", "2", "--epochs", "1", "--lightsb", "--sb_potentials", "2",
        "--output", str(out), "--device", "cpu"])
    get_logger()  # set up first: caplog restores the level it finds, for later tests
    caplog.set_level("INFO", logger="ir_ads_tpu_torch")
    with warnings.catch_warnings():  # the module is imported already, by this file
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module("ir_ads_tpu_torch.train_ad", run_name="__main__", alter_sys=True)
    text = caplog.text
    assert "deviation-score AUROC:" in text and "LightSB-potential AUROC:" in text
    roc = float(text.split("deviation-score AUROC: ")[1].split()[0])
    assert np.isfinite(roc)
    path = out / "widget_weights.msgpack"
    model, template = _variables("resnet18", 0)
    w = load_weights(str(path), {"params": template["params"],
                                 "batch_stats": template["batch_stats"]})
    leaves = jax.tree.leaves(w)
    assert len(leaves) == len(jax.tree.leaves(template))
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    sd = load_anomaly_weights(str(path))
    flat = anomaly_from_flax(jax.tree.map(np.asarray, w))
    assert set(sd) == set(flat) and all(torch.equal(sd[k], flat[k]) for k in sd)


def test_jax_weights_score_as_jax(fake_mvtec, tmp_path, r18):
    """Weights the JAX side wrote (``save_weights``) give, through the
    port's ``load_anomaly_weights`` and ``train_ad.evaluate``, the test
    scores and features JAX's ``infer`` gives; the port's writer gives the
    same tree back."""
    from ir_ads_tpu.utils.checkpoint import save_weights

    from ir_ads_tpu_torch.utils.checkpoint import load_weights

    model, variables, infer = r18
    path = tmp_path / "widget_weights.msgpack"
    save_weights(str(path), variables["params"], variables["batch_stats"])
    cfg = dict(dataset_root=str(fake_mvtec), classname="widget", know_class="crack",
               n_anomaly=2, img_size=32)
    port = AnomalyScoreNet("resnet18")
    port.load_state_dict(load_anomaly_weights(str(path)))
    scores, labels, feats = train_ad.evaluate(port, pdata.MVTecAD(pdata.ADConfig(**cfg), False),
                                              6, torch.device("cpu"))
    want = [infer(variables, imgs) for imgs, _ in
            jdata.test_batches(jdata.MVTecAD(jdata.ADConfig(**cfg), False), 6)]
    np.testing.assert_allclose(scores, np.concatenate([w[0] for w in want]), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(feats, np.concatenate([w[1] for w in want]), atol=ATOL,
                               rtol=RTOL)
    assert labels.tolist() == [0] * 4 + [1] * 4
    again = tmp_path / "again.msgpack"
    save_anomaly_weights(str(again), port.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(load_weights(str(path))))
    got = dict(jax.tree_util.tree_leaves_with_path(load_weights(str(again))))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k

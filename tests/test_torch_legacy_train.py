"""Training the legacy models on the port against the JAX package, on the
CPU: CMNeXt-B0 (the MiT dual stream) and CMX-B0 under the ``train``
dispatch, at 64x64 (every DSCF stage takes the einsum attention, its bias
by K6's plain version: JAX's ``IR_ADS_DSCF_ATTN`` level-3 entry ``xla`` with
``IR_ADS_DSCF_RPE3=pallas``, the packed kernel interpreted).

  * The trainable set (``requires_grad`` after the adapter-only freeze) is
    JAX's ``adapter_mask`` leaf for leaf on both trees, carried through
    ``from_flax``'s names.
  * One train forward draws what the JAX modules draw: drop-path on both
    residual branches of every block (the MiT's shared block once a
    stream, CMX's two stacks each once), at ``linspace(0, 0.1,
    sum(depths))``; the adapters' dropout at 0.1 (CMNeXt); the head's at
    0.1; the same generator state gives the same logits and another one
    other logits; eval mode draws nothing.  The BatchNorms (the DSCF's
    fuse_q, CMX's FFM pair, the head's) move their statistics in train
    mode only.
  * Two training steps (f32, the shipped recipe's adapter-only AdamW,
    every stochastic rate 0 on both sides: the JAX modules' rates are
    fixed, so the test sets them through subclasses) against JAX's jitted
    ``make_train_step``: both steps' loss and loss_main at 1e-4, every
    trainable parameter and every BatchNorm statistic after step 2 at
    atol 2e-3 / rtol 1e-3 (tests/test_torch_training.py's bars), the
    updates held on their own (all but 0.5 % of the trainable elements
    within a tenth of one AdamW step), frozen parameters bit-equal.
  * The bf16 train forward (what a bf16 step's loss and statistics come
    from) against JAX's ``dtype=bfloat16`` model, at tests/test_torch_mit.py's
    rule: at most 1.25x JAX bf16's own distance from JAX f32, for the port
    against JAX bf16 and against JAX f32.
  * Checkpoints of a legacy train state (params, batch_stats, optax's
    masked AdamW state) read both ways.
  * ``SemSegTrainer`` in bf16 and ``train_mm.main`` (with a resume from
    ``latest/``) train both models.

About 80 s in one process: three JAX compiles, the port in one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ir_ads_tpu.models as jmodels
from ir_ads_tpu.models import build_model as jax_build_model
from ir_ads_tpu.models.backbones import cmx as jcmx
from ir_ads_tpu.models.backbones import mit as jmit
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.models.heads import segformer as jseg
from ir_ads_tpu.training import losses as jlosses
from ir_ads_tpu.training import optim as joptim
from ir_ads_tpu.training.train_state import TrainState as JaxTrainState
from ir_ads_tpu.training.train_state import make_train_step
from ir_ads_tpu.utils import checkpoint as jckpt
from ir_ads_tpu_torch import train_mm
from ir_ads_tpu_torch.models import CMNeXtLegacy
from ir_ads_tpu_torch.models.backbones import cmx as tcmx
from ir_ads_tpu_torch.models.backbones import mit as tmit
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.heads import segformer as tseg
from ir_ads_tpu_torch.train import RECIPE, RECIPE_ITERS_PER_EPOCH, SemSegTrainer, build_state
from ir_ads_tpu_torch.training import optim
from ir_ads_tpu_torch.utils import checkpoint as tckpt
from ir_ads_tpu_torch.utils.config import DEFAULTS, _merge
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from test_torch_mit import fill_variables
from test_torch_train_mm import MOMENT, _flax_named, _optax_parts
from test_torch_training import TRAIN_ENV

H = W = 64
CLASSES = 5
BACKBONES = ["CMNeXt-B0", "CMX-B0"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _MiTNoDrop(jmit.MiTDualStream):
    drop_path_rate: float = 0.0


class _CMXNoDrop(jcmx.CMX):
    drop_path_rate: float = 0.0


class _HeadNoDrop(jseg.SegFormerHead):
    drop: float = 0.0


class _AdapterNoDrop(jswin.Adapter):
    drop: float = 0.0


def _rates_zero(mp):
    """The JAX legacy model with every stochastic rate 0 (CMNeXtLegacy builds
    its backbone, its head and the MiT's adapters at the modules' default
    rates, which no argument reaches), traced under the train dispatch's
    environment."""
    mp.setattr(jmodels, "MiTDualStream", _MiTNoDrop)
    mp.setattr(jmodels, "CMXBackbone", _CMXNoDrop)
    mp.setattr(jmodels, "SegFormerHead", _HeadNoDrop)
    mp.setattr(jmit, "Adapter", _AdapterNoDrop)
    for k, v in TRAIN_ENV.items():
        mp.setenv(k, v)


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    rgb = rng.randn(b, H, W, 3).astype(np.float32)
    dte = rng.randn(b, H, W, 3).astype(np.float32)
    label = rng.randint(0, CLASSES, (b, H, W))
    label[0, :4] = 255
    return rgb, dte, label


BATCHES = [_batch(94), _batch(95)]


@pytest.fixture(scope="module")
def variables():
    """Each model's flax variables (legacy_variables: every branch moves the
    logits), drawn once, in the shapes of the port's tree carried to flax's
    (``to_flax``, which tests/test_torch_mit.py holds leaf for leaf against
    JAX's: no JAX trace)."""
    return {bb: fill_variables(to_flax(CMNeXtLegacy(bb, CLASSES).state_dict()), 91 + i)
            for i, bb in enumerate(BACKBONES)}


@pytest.fixture(scope="module")
def jax_steps(variables):
    """JAX's two f32 training steps of each model (rates 0), run on demand:
    the metrics, and the params and statistics after step 1 and step 2."""
    cache = {}

    def run(backbone):
        if backbone in cache:
            return cache[backbone]
        v = variables[backbone]
        with pytest.MonkeyPatch.context() as mp:
            _rates_zero(mp)
            model = jax_build_model("CMNeXt", backbone, num_classes=CLASSES)
            params = jax.tree.map(jnp.asarray, v["params"])
            tx = joptim.get_optimizer("adamw", _schedule(), 0.01, "Adapter", params=params)
            state = JaxTrainState.create(model.apply, params,
                                         jax.tree.map(jnp.asarray, v["batch_stats"]), tx)
            step_fn = jax.jit(make_train_step(jlosses.cross_entropy, 255))
            metrics, trees = [], []
            for b in BATCHES:
                state, m = step_fn(state, tuple(jnp.asarray(a) for a in b),
                                   jax.random.PRNGKey(0))
                metrics.append({k: float(x) for k, x in m.items()})
                trees.append(from_flax({
                    "params": jax.tree.map(np.asarray, state.params),
                    "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}))
        cache[backbone] = dict(metrics=metrics, after=trees)
        return cache[backbone]

    return run


def _port_model(backbone, v=None, rates=True):
    """The port's legacy model under the train dispatch; without ``rates``
    every block's drop-path, the adapters' and the head's dropout at 0."""
    model = CMNeXtLegacy(backbone, CLASSES, "train")
    if not rates:
        model.head_drop = 0.0
        for m in model.modules():
            if isinstance(m, (tmit.CEBlock, tcmx.MiTBlock)):
                m.drop_path_rate = 0.0
            if isinstance(m, tmit.CEBlock):
                m.adapter_drop = 0.0
    if v is not None:
        model.load_state_dict(from_flax(v))
    return model


def _port_state(backbone, v, rates=False, dtype=torch.float32):
    state = build_state(_port_model(backbone, v, rates), RECIPE, RECIPE_ITERS_PER_EPOCH, 0)
    state.dtype = dtype
    return state


def _schedule():
    return joptim.warmup_poly_schedule(4e-4, 401 * 198, 0.9, 1980, 0.1)


# --------------------------------------------------------------------------
# the adapter-only freeze
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", BACKBONES)
def test_trainable_set_equals_jax_adapter_mask(variables, backbone):
    """CMX has no adapter: its trainable set is what the patterns select in
    its tree, the extra stream's patch embeddings and the head."""
    v = variables[backbone]
    mask = joptim.adapter_mask(v["params"])
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                             mask, v["params"])
    want = {k: bool(t.flatten()[0]) for k, t in from_flax({"params": as_arrays}).items()}
    port = _port_model(backbone)
    optim.freeze_(port, "Adapter")
    got = {n: p.requires_grad for n, p in port.named_parameters()}
    assert got == want
    trained = {n for n, t in got.items() if t}
    assert 0 < len(trained) < len(got)
    if backbone == "CMX-B0":
        assert all(n.startswith(("backbone.extra_patch_embed", "decode_head.")) for n in trained)
    else:
        assert "backbone.block1_0.MLP_DTE_Adapter.D_fc1.weight" in trained
        assert "backbone.DeformMPGBlocks.2.deform_atten.rpe_table" in trained
        assert "backbone.MPGBlocks.0.U_fc1.weight" in trained
        assert "backbone.block1_0.attn.q.weight" not in trained


# --------------------------------------------------------------------------
# the stochastic pieces and the statistics of one train forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", BACKBONES)
def test_one_train_forward_draws_and_moves_statistics(monkeypatch, backbone):
    draws = []

    def recorder(module, name, kind):
        fn = getattr(module, name)

        def rec(x, rate, training, generator=None):
            if training and rate > 0.0:
                draws.append((kind, round(rate, 6)))
            return fn(x, rate, training, generator)
        monkeypatch.setattr(module, name, rec)

    recorder(tmit, "drop_path", "path")
    recorder(tcmx, "drop_path", "path")
    recorder(tswin, "dropout", "adapter")
    recorder(tseg, "dropout", "head")
    model = _port_model(backbone)
    from ir_ads_tpu_torch.serve import init_random_
    init_random_(model, 92)
    rgb, dte = (torch.from_numpy(a) for a in _batch(93)[:2])
    stats = {n: b.clone() for n, b in model.named_buffers() if n.endswith("running_mean")}
    with torch.no_grad():
        model.eval()
        served = model(rgb, dte)[0]
        assert not draws
        model.train()
        a = model(rgb, dte, torch.Generator().manual_seed(1))[0]
    depths = tmit.MIT_SETTINGS["B0"][1]
    rates = [round(r, 6) for r in np.linspace(0.0, 0.1, sum(depths))[1:]]  # 0 draws nothing
    streams = 2  # the MiT's shared block once a stream; CMX's two stacks
    want = [("path", r) for r in rates for _ in range(2 * streams)]
    if backbone.startswith("CMNeXt"):
        want += [("adapter", 0.1)] * (sum(depths) * streams)
    want += [("head", 0.1)]
    assert sorted(draws) == sorted(want)
    n_bn = 4 + 1 if backbone.startswith("CMNeXt") else 2 * 4 + 1
    moved = [n for n, b in model.named_buffers()
             if n.endswith("running_mean") and not torch.equal(b, stats[n])]
    assert len(stats) == len(moved) == n_bn
    with torch.no_grad():
        b = model(rgb, dte, torch.Generator().manual_seed(1))[0]
        c = model(rgb, dte, torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, served)


# --------------------------------------------------------------------------
# two training steps on both sides
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", BACKBONES)
def test_two_training_steps_match_jax(jax_steps, variables, backbone):
    want_metrics, want_sd = jax_steps(backbone)["metrics"], jax_steps(backbone)["after"][1]
    port = _port_state(backbone, variables[backbone])
    start = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    got_metrics = [{k: float(x) for k, x in port.train_step(port.batch(*b)).items()}
                   for b in BATCHES]
    for got, want in zip(got_metrics, want_metrics):
        for key in ("loss", "loss_main"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4)
    moved = off = total = 0
    for n, p in port.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(), atol=2e-3,
                                       rtol=1e-3, err_msg=n)
            moved += not torch.equal(p, start[n])
            diff = (p.detach() - start[n]) - (want_sd[n] - start[n])
            off += int((diff.abs() > 4e-6).sum())
            total += p.numel()
        else:
            assert torch.equal(p, start[n]), n
    print(f"{backbone}: {moved} trainable tensors moved; updates off by more than a tenth "
          f"of a step: {off} of {total}")
    assert moved > 10 and off <= 0.005 * total
    n_stats = 0
    for n, b in port.model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want_sd[n].numpy(), atol=2e-3, rtol=1e-3,
                                       err_msg=n)
            n_stats += 1
    assert n_stats == 2 * (5 if backbone.startswith("CMNeXt") else 9)


def test_bf16_train_forward_within_jax_bf16_distance(jax_steps, variables, monkeypatch):
    """CMNeXt-B0's step-1 loss and updated BatchNorm statistics in bf16: the
    port against JAX bf16 and against JAX f32 (its f32 step's), each at
    most 1.25x JAX bf16's own distance from JAX f32 (the unit-weight DSCF
    carries bf16's offsets into the sampling, tests/test_torch_mit.py)."""
    _rates_zero(monkeypatch)
    v = variables["CMNeXt-B0"]
    rgb, dte, label = BATCHES[0]
    model = jax_build_model("CMNeXt", "CMNeXt-B0", num_classes=CLASSES, dtype=jnp.bfloat16)

    @jax.jit
    def run(vv, a, b, lbl):
        (y, _, _), mut = model.apply(vv, a, b, train=True, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.cross_entropy(y, lbl, 255), mut["batch_stats"]

    loss, stats = run(v, jnp.asarray(rgb, jnp.bfloat16), jnp.asarray(dte, jnp.bfloat16),
                      jnp.asarray(label))
    j16 = (float(loss), from_flax({"batch_stats": jax.tree.map(np.asarray, stats)}))
    f32 = jax_steps("CMNeXt-B0")
    j32 = (f32["metrics"][0]["loss_main"], f32["after"][0])
    port = _port_state("CMNeXt-B0", v, dtype=torch.bfloat16)
    got_loss = float(port.train_step(port.batch(rgb, dte, label))["loss_main"])
    got = {n: b.clone() for n, b in port.model.named_buffers()
           if n.endswith(("running_mean", "running_var"))}
    assert len(got) == 10

    def rel_stats(a, b):
        num = sum(float(torch.sum((a[n].float() - b[n].float()) ** 2)) for n in got)
        return (num / sum(float(torch.sum(b[n].float() ** 2)) for n in got)) ** 0.5

    own = (abs(j16[0] - j32[0]) / abs(j32[0]), rel_stats(j16[1], j32[1]))
    port16 = (abs(got_loss - j16[0]) / abs(j16[0]), rel_stats(got, j16[1]))
    port32 = (abs(got_loss - j32[0]) / abs(j32[0]), rel_stats(got, j32[1]))
    print(f"loss, statistics: port vs JAX bf16 {port16}, vs JAX f32 {port32}; "
          f"JAX bf16 vs f32 {own}")
    for mine, bar in zip(zip(port16, port32), own):
        assert max(mine) <= 1.25 * bar


# --------------------------------------------------------------------------
# checkpoints, the trainer and train_mm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", BACKBONES)
def test_legacy_checkpoints_read_both_ways(variables, backbone, tmp_path):
    """A legacy train state (adapter-only AdamW: optax.masked's empty maps
    for the frozen leaves) written by the port and read by JAX's
    load_checkpoint, and the other way: params, statistics, moments,
    counts and step bit for bit."""
    v = variables[backbone]
    model = jax_build_model("CMNeXt", backbone, num_classes=CLASSES)

    def jax_state():
        tx = joptim.get_optimizer("adamw", _schedule(), 0.01, "Adapter", params=v["params"])
        return JaxTrainState.create(model.apply, v["params"], v["batch_stats"], tx)

    port = _port_state(backbone, v)
    g = torch.Generator().manual_seed(97)
    with torch.no_grad():
        for p in port.model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
        for n, b in port.model.named_buffers():
            if n.endswith("running_mean"):
                b.add_(torch.randn(b.shape, generator=g))
    trained = {n: p for n, p in port.model.named_parameters() if p.requires_grad}
    for p in trained.values():
        port.optimizer.state[p] = {"exp_avg": torch.randn(p.shape, generator=g),
                                   "exp_avg_sq": torch.rand(p.shape, generator=g),
                                   "step": torch.tensor(5.0)}
    port.step = 5
    tckpt.save_checkpoint(str(tmp_path / "port"), port, 0.25, 3)
    restored, manifest = jckpt.load_checkpoint(str(tmp_path / "port"), jax_state())
    assert int(restored.step) == 5 and manifest["epoch"] == 3
    back = from_flax({"params": jax.tree.map(np.asarray, restored.params),
                      "batch_stats": jax.tree.map(np.asarray, restored.batch_stats)})
    for k, t in port.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k
    parts, counts = _optax_parts(restored.opt_state)
    assert counts == [5] and int(parts["count"]) == 5
    for key in ("mu", "nu"):
        named = _flax_named(parts[key])
        assert set(named) == set(trained)
        for n, p in trained.items():
            assert torch.equal(named[n], port.optimizer.state[p][MOMENT[key]]), (key, n)

    rng = np.random.RandomState(98)

    def draw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return (x + rng.randn(*x.shape)).astype(x.dtype)
        return np.asarray(7, x.dtype)

    js = jax_state()
    js = js.replace(opt_state=jax.tree.map(draw, js.opt_state), step=np.asarray(7, np.int32),
                    params=jax.tree.map(draw, js.params),
                    batch_stats=jax.tree.map(draw, js.batch_stats))
    jckpt.save_checkpoint(str(tmp_path / "jax"), js, 0.5, 4)
    port = _port_state(backbone, v)
    manifest = tckpt.load_checkpoint(str(tmp_path / "jax"), port)
    assert manifest["epoch"] == 4 and port.step == 7
    want = from_flax({"params": jax.tree.map(np.asarray, js.params),
                      "batch_stats": jax.tree.map(np.asarray, js.batch_stats)})
    for k, t in port.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k
    parts, _ = _optax_parts(js.opt_state)
    for key in ("mu", "nu"):
        named = _flax_named(parts[key])
        for n, p in port.model.named_parameters():
            if p.requires_grad:
                assert torch.equal(port.optimizer.state[p][MOMENT[key]], named[n]), (key, n)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_trainer_and_train_mm_train_a_legacy_model(backbone, tmp_path, monkeypatch):
    """SemSegTrainer in bf16 with every stochastic piece on: finite losses,
    f32 masters, trainable parameters moved, frozen ones bit-equal, the
    Swin options refused by name.  train_mm.main for 2 epochs of 2 steps,
    then a run stopped after epoch 1 and resumed from latest/ ends where
    the uninterrupted one does."""
    tr = SemSegTrainer(device="cpu", dtype=torch.bfloat16, seed=3, num_classes=CLASSES,
                       backbone=backbone)
    assert isinstance(tr.model, CMNeXtLegacy) and tr.model.training
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    out = [tr.step(*_batch(99 + i)) for i in range(2)]
    assert all(np.isfinite(m["loss"]) and m["loss"] > 0 for m in out)
    for n, p in tr.model.named_parameters():
        assert p.dtype == torch.float32
        # the DSCF key bias (a shift of every score) and a bias ahead of a
        # train-mode BatchNorm have a zero gradient in exact arithmetic
        assert torch.equal(p, start[n]) != p.requires_grad or n.endswith(
            ("deform_atten.proj_k.bias", "fuse_q.conv.0.bias", ".proj.bias")), n
    for key, kw in (("head_dims", dict(head_dims=(64, 32))),
                    ("dual_batch", dict(backbone_kwargs=dict(dual_batch=True)))):
        with pytest.raises(ValueError, match=key):
            SemSegTrainer(device="cpu", backbone=backbone, **kw)

    def cfg(save_dir):
        return _merge(DEFAULTS, {
            "SAVE_DIR": str(save_dir), "MODEL": {"BACKBONE": backbone},
            "DATASET": {"NAME": "Synthetic", "ROOT": "",
                        "KWARGS": {"image_size": [H, W], "num_classes": CLASSES, "length": 4},
                        "VAL_KWARGS": {"length": 2}},
            "TRAIN": {"IMAGE_SIZE": [H, W], "BATCH_SIZE": 2, "EPOCHS": 2, "EVAL_START": 0,
                      "EVAL_INTERVAL": 1, "AMP": False},
            "OPTIMIZER": {"NAME": "adamw", "LR": 1e-3, "WEIGHT_DECAY": 0.01,
                          "TRAIN_TYPE": "Adapter"},
            "SCHEDULER": {"NAME": "warmuppolylr", "POWER": 0.9, "WARMUP": 1,
                          "WARMUP_RATIO": 0.1},
            "EVAL": {"MODEL_PATH": "", "IMAGE_SIZE": [H, W], "BATCH_SIZE": 2,
                     "MSF": {"ENABLE": False}},
        })

    whole = train_mm.main(cfg(tmp_path / "a"), device="cpu", seed=5)
    assert [e["steps"] for e in whole["epochs"]] == [2, 2]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["miou"]) for e in whole["epochs"])
    short = _merge(cfg(tmp_path / "b"), {"TRAIN": {"EPOCHS": 1}})
    train_mm.main(short, device="cpu", seed=5)
    monkeypatch.setenv("IR_ADS_RESUME", str(train_mm.save_dir_of(short) / "latest"))
    resumed = train_mm.main(cfg(tmp_path / "b"), device="cpu", seed=5)
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    a, b = resumed["state"].model.state_dict(), whole["state"].model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_card_config_is_the_swin_training_config_with_cmnext_b2():
    from pathlib import Path

    from ir_ads_tpu_torch.utils.config import load_config

    root = Path(train_mm.__file__).resolve().parent / "configs"
    legacy = load_config(str(root / "nyu_rgbd_synthetic_cmnext_b2_train.yaml"))
    swin = load_config(str(root / "nyu_rgbd_synthetic_train.yaml"))
    assert legacy["MODEL"].pop("BACKBONE") == "CMNeXt-B2"
    assert swin["MODEL"].pop("BACKBONE") == "SwinTransformer-B"
    assert legacy == swin

"""The port's training driver, ``ir_ads_tpu_torch.train_mm``, on the CPU with
the tiny model (``test_torch_model.TINY``), and its ``drop_rate > 0`` path:

  * ``main`` for 2 epochs on Synthetic 64x64 frames (8 train, 2 val images,
    adapter-only AdamW, drop-path and the modality mask on): ``best/``,
    ``latest/``, ``train.log`` and ``scalars.jsonl``; ``latest/`` read back
    by ``load_weights`` + ``from_flax`` is the live state bit for bit; the
    CLI runs on the card unless told otherwise; the entry point imports
    nothing of JAX.
  * A run stopped after epoch 1 and resumed from ``latest/`` (through
    ``IR_ADS_RESUME``) ends bit-equal to the uninterrupted run: parameters,
    statistics, the optimizer's moments and counts, the step.
  * ``drop_rate = 1e-12``: both sides take the module attention path that
    the rate switches to (K12's plain version on the port's side, the XLA
    window attention on JAX's CPU) and no element drops; two training
    steps' losses, gradients and parameters against a jitted JAX step at
    ``test_two_training_steps_match_jax``'s tolerances.
  * ``drop_rate > 0``: the dropout is elementwise, scaled by 1 / (1 - p),
    and the same for the same (seed, step).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.training import losses as jlosses
from ir_ads_tpu.training import optim as joptim
from ir_ads_tpu.training.train_state import TrainState as JaxTrainState
from ir_ads_tpu_torch import train_mm
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.ops import layers
from ir_ads_tpu_torch.train import SemSegTrainer, build_model_and_state
from ir_ads_tpu_torch.utils.checkpoint import load_weights
from ir_ads_tpu_torch.utils.config import DEFAULTS, _merge, load_config
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's CPU ops in one thread: the suite runs several test
    processes at once, and each PyTorch process starting a thread a core
    made these tests ten times slower there than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(save_dir, **model):
    return _merge(DEFAULTS, {
        "SAVE_DIR": str(save_dir),
        "MODEL": {"BACKBONE_KWARGS": dict(TINY, drop_path_rate=0.2, **model)},
        "DATASET": {"NAME": "Synthetic", "ROOT": "",
                    "KWARGS": {"image_size": [64, 64], "num_classes": 5, "length": 8},
                    "VAL_KWARGS": {"length": 2}},
        "TRAIN": {"IMAGE_SIZE": [64, 64], "BATCH_SIZE": 4, "EPOCHS": 2, "EVAL_START": 0,
                  "EVAL_INTERVAL": 1, "AMP": False},
        "OPTIMIZER": {"NAME": "adamw", "LR": 1e-3, "WEIGHT_DECAY": 0.01,
                      "TRAIN_TYPE": "Adapter"},
        "SCHEDULER": {"NAME": "warmuppolylr", "POWER": 0.9, "WARMUP": 1, "WARMUP_RATIO": 0.1},
        "EVAL": {"MODEL_PATH": "", "IMAGE_SIZE": [64, 64], "BATCH_SIZE": 2,
                 "MSF": {"ENABLE": False}},
    })


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    cfg = _cfg(out)
    return cfg, train_mm.main(cfg, device="cpu", seed=5), train_mm.save_dir_of(cfg)


def test_driver_writes_checkpoints_logs_and_scalars(uninterrupted):
    cfg, result, save_dir = uninterrupted
    assert save_dir.name == "Synthetic_SwinTransformer-B_id"
    for sub in ("best", "latest"):
        assert {p.name for p in (save_dir / sub).iterdir()} == {
            "weights.msgpack", "train_state.msgpack", "manifest.json"}
    manifest = json.loads((save_dir / "latest" / "manifest.json").read_text())
    assert manifest["epoch"] == 2 and manifest["config"]["TRAIN"]["EPOCHS"] == 2
    log = (save_dir / "train.log").read_text()
    assert "epoch 2/2 loss" in log and "mIoU" in log and "done. best mIoU" in log
    lines = [json.loads(s) for s in (save_dir / "scalars.jsonl").read_text().splitlines()]
    assert [(d["tag"], d["step"]) for d in lines] == [
        (t, e) for e in (0, 1) for t in ("train/loss", "train/img_per_sec", "val/mIoU")]
    epochs = result["epochs"]
    assert [e["steps"] for e in epochs] == [2, 2] and result["state"].step == 4
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["miou"]) for e in epochs)
    live = result["state"].model.state_dict()
    back = from_flax(load_weights(str(save_dir / "latest")))
    assert set(back) == set(live)
    for k, t in live.items():
        assert torch.equal(back[k], t), k


class _Stop(Exception):
    pass


def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(uninterrupted, tmp_path,
                                                          monkeypatch):
    cfg, result, _ = uninterrupted
    cfg = _merge(cfg, {"SAVE_DIR": str(tmp_path)})
    save = train_mm.save_checkpoint

    def stop_after_epoch_1(directory, state, best_miou=0.0, epoch=0, extra=None):
        n = save(directory, state, best_miou, epoch, extra)
        if directory.endswith("latest") and epoch == 1:
            raise _Stop
        return n

    monkeypatch.setattr(train_mm, "save_checkpoint", stop_after_epoch_1)
    with pytest.raises(_Stop):
        train_mm.main(cfg, device="cpu", seed=5)
    monkeypatch.setattr(train_mm, "save_checkpoint", save)
    latest = train_mm.save_dir_of(cfg) / "latest"
    monkeypatch.setenv("IR_ADS_RESUME", str(latest))
    resumed = train_mm.main(cfg, device="cpu", seed=5)
    assert "resumed from" in (train_mm.save_dir_of(cfg) / "train.log").read_text()
    assert [e["epoch"] for e in resumed["epochs"]] == [2]

    a, b = resumed["state"], result["state"]
    assert a.step == b.step == 4
    for (n, t), (m, u) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert n == m and torch.equal(t, u), n
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    moved = 0
    for n, p in pa.items():
        if not p.requires_grad:
            continue
        sa, sb = a.optimizer.state[p], b.optimizer.state[pb[n]]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)
        moved += 1
    assert moved > 100


def test_card_config_is_the_nyu_recipe_on_synthetic_frames():
    """The card's training config (chip_smoke.py phase 8) is
    configs/nyu_rgbd.yaml's model, train, loss, optimizer, scheduler and
    eval, cut to 2 epochs gated from the first, single-scale, on Synthetic
    frames at NYU's size and classes."""
    want = load_config(str(ROOT / "configs" / "nyu_rgbd.yaml"))
    got = load_config(str(ROOT / "ir_ads_tpu_torch" / "configs" /
                          "nyu_rgbd_synthetic_train.yaml"))
    for key in ("MODEL", "LOSS", "OPTIMIZER", "SCHEDULER"):
        assert got[key] == want[key], key
    assert got["TRAIN"] == {**want["TRAIN"], "EPOCHS": 2, "EVAL_START": 0}
    assert got["EVAL"] == _merge(want["EVAL"], {"MSF": {"ENABLE": False}})
    assert got["DATASET"] == {**want["DATASET"], "NAME": "Synthetic", "ROOT": "",
                              "KWARGS": {"image_size": [480, 640], "num_classes": 40,
                                         "length": 8},
                              "VAL_KWARGS": {"length": 2}}


def test_cli_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(_cfg(tmp_path)))  # JSON is YAML
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mm.cli(["--cfg", str(path)])


def test_entry_point_imports_no_jax():
    code = ("import sys, ir_ads_tpu_torch.train_mm; bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'ir_ads_tpu')); "
            "print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# --------------------------------------------------------------------------
# drop_rate > 0
# --------------------------------------------------------------------------

H, W = 64, 80
SMALL = dict(TINY, depths=(1, 1, 1, 1))  # no scanned stage: a quicker JAX compile


def _batch(seed):
    rng = np.random.RandomState(seed)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    label = rng.randint(0, 5, (2, H, W))
    label[0, :4] = 255
    return rgb, dte, label


def _counting(monkeypatch):
    """Calls of K1 and K12 through the backbone."""
    calls = {"window_block": 0, "window_attention_qkv": 0}
    for name in calls:
        fn = getattr(tswin, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tswin, name, counted)
    return calls


def test_drop_rate_1e12_steps_match_jax(monkeypatch):
    """f32, every other stochastic rate 0, the same weights and batches: at
    drop_rate 1e-12 keep = 1 - 1e-12 rounds to 1 in f32 on both sides, so
    no element drops and both take the module path the rate switches to.
    Losses to 1e-4; every trainable gradient of both steps and every
    parameter after them to atol 2e-3 / rtol 1e-3
    (test_two_training_steps_match_jax's bar); the gradients of the Swin
    blocks, the path the rate switches, also on their own scale (3e-3 of
    each norm, that test's second bar; the largest reading here is 2.7e-3).
    That test's own-scale bar does not hold for every group on these
    weights: the DSCF's offset and output parameters reach 1.2e-2 of their
    (small) norms, the decode heads' 3.4e-3, on either DSCF bias form.
    Frozen parameters stay bit-equal."""
    kwargs = dict(SMALL, drop_path_rate=0.0, adapter_drop=0.0, drop_rate=1e-12)
    rgb, dte, _ = _batch(50)
    model = JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5, backbone_kwargs=kwargs,
                      head_dims=(32, 16), head_drop=0.0, mmst_mask=False)
    v = random_variables(model, 51, jnp.asarray(rgb), jnp.asarray(dte))
    kw = dict(base_lr=4e-4, max_iter=401 * 198, power=0.9, warmup_iter=1980,
              warmup_ratio=0.1)
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = joptim.get_optimizer("adamw", joptim.warmup_poly_schedule(**kw), 0.01, "Adapter",
                              params=params)
    state = JaxTrainState.create(model.apply, params,
                                 jax.tree.map(jnp.asarray, v["batch_stats"]), tx)

    @jax.jit
    def step(st, batch):
        """make_train_step's step, returning its gradients too."""
        keys = {"mmst": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

        def loss_fn(p):
            (y, y_rgb, y_dte), mut = st.apply_fn(
                {"params": p, "batch_stats": st.batch_stats}, batch[0], batch[1],
                train=True, rngs=keys, mutable=["batch_stats"])
            lbl = batch[2]
            masked = jnp.where(jnp.argmax(y, -1) == lbl, 255, lbl)
            main = jlosses.cross_entropy(y, lbl, 255)
            return main + 0.01 * (jlosses.cross_entropy(y_rgb, masked, 255)
                                  + jlosses.cross_entropy(y_dte, masked, 255)), (
                mut["batch_stats"], main)

        (loss, (stats, main)), grads = jax.value_and_grad(loss_fn, has_aux=True)(st.params)
        upd, opt = st.tx.update(grads, st.opt_state, st.params)
        import optax

        return st.replace(step=st.step + 1, params=optax.apply_updates(st.params, upd),
                          batch_stats=stats, opt_state=opt), loss, main, grads

    batches = [_batch(52), _batch(53)]
    want = []
    for b in batches:
        state, loss, main, grads = step(state, tuple(jnp.asarray(a) for a in b))
        want.append((float(loss), float(main),
                     from_flax({"params": jax.tree.map(np.asarray, grads)})))
    want_sd = from_flax({"params": jax.tree.map(np.asarray, state.params),
                         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})

    calls = _counting(monkeypatch)
    tr = SemSegTrainer(device="cpu", dtype=torch.float32, num_classes=5, head_dims=(32, 16),
                       backbone_kwargs=kwargs, head_drop=0.0, mmst_mask=False,
                       state_dict=from_flax(v))
    for blk in tr.model.backbone.DeformMPGBlocks:  # JAX's CPU default: the XLA-form bias
        blk.deform_atten.rpe3 = "xla"
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    for b, (w_loss, w_main, w_grads) in zip(batches, want):
        m = tr.step(*b)
        assert calls == {"window_block": 0, "window_attention_qkv": 2 * sum(SMALL["depths"])}
        calls.update(window_block=0, window_attention_qkv=0)
        np.testing.assert_allclose(m["loss"], w_loss, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(m["loss_main"], w_main, atol=1e-4, rtol=1e-4)
        got = {n: p.grad for n, p in tr.model.named_parameters() if p.requires_grad}
        assert len(got) > 100
        for n, g in got.items():
            w = w_grads[n].numpy()
            np.testing.assert_allclose(g.numpy(), w, atol=2e-3, rtol=1e-3, err_msg=n)
            if ".stages." in n:
                err, norm = float(np.linalg.norm(g.numpy() - w)), float(np.linalg.norm(w))
                assert err <= 3e-3 * norm, f"gradient of {n}: {err:.3e} of {norm:.3e}"
    for n, p in tr.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(), atol=2e-3,
                                       rtol=1e-3, err_msg=n)
        else:
            assert torch.equal(p, start[n]), n
    # in eval mode the same model runs K1 again
    tr.model.eval()
    with torch.no_grad():
        tr.model(*tr.batch(*batches[0])[:2])
    assert calls["window_block"] == 2 * sum(SMALL["depths"]) and calls[
        "window_attention_qkv"] == 0


def test_dropout_is_elementwise_scaled_and_keyed_by_the_step(monkeypatch, tmp_path):
    """drop_rate 0.5 and every other rate 0: each dropout site's output is 0
    or its input / 0.5 element by element, about half kept; a step's draws
    are the same from the same (seed, step) and differ at another step."""
    seen = []

    def spy(x, rate, training, generator=None):
        out = drop(x, rate, training, generator)
        if training and rate > 0:
            seen.append((x.detach(), out.detach(), rate))
        return out

    drop = layers.dropout
    monkeypatch.setattr(layers, "dropout", spy)
    monkeypatch.setattr(tswin, "dropout", spy)
    cfg = _cfg(tmp_path, drop_rate=0.5)
    cfg["MODEL"]["BACKBONE_KWARGS"].update(drop_path_rate=0.0, adapter_drop=0.0)
    state = build_model_and_state(cfg, 5, iters_per_epoch=2, device="cpu", seed=7)
    model = state.model.train()
    x = torch.from_numpy(_batch(54)[0])
    with torch.no_grad():
        a = model(x, x, state.generator(3))[0]
        sites = len(seen)
        b = model(x, x, state.generator(3))[0]
        c = model(x, x, state.generator(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sites == 2 * sum(TINY["depths"]) * 3  # proj, and twice in the FFN
    for inp, out, rate in seen:
        assert rate == 0.5
        assert bool(((out == 0) | (out == inp / 0.5)).all())
        kept = float((out != 0).float().mean())
        assert 0.3 < kept < 0.7, kept

"""The port's training path against the JAX package, on the CPU: losses,
schedules, AdamW, the adapter-only freeze, the stochastic pieces on their
own, flax's BatchNorm statistics, and the slice as a whole: two training
steps of a tiny CMNeXt on both sides from the same weights and batches.

The JAX side runs what its training step runs on its chip: the v4 half-block
kernel at every stage, the rows DSCF kernels at levels 0-2, the einsum DSCF
with the packed rpe kernel at level 3, and both Pallas backward kernels, all
in interpret mode.  JAX and PyTorch random streams cannot agree, so the
parity runs have every stochastic rate at 0; the stochastic pieces are held
by their own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.training import losses as jlosses
from ir_ads_tpu.training import optim as joptim
from ir_ads_tpu.training.train_state import TrainState, make_train_step
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import layers
from ir_ads_tpu_torch.train import SemSegTrainer
from ir_ads_tpu_torch.training import losses, optim
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables

TRAIN_ENV = {
    "IR_ADS_SWIN_ATTN": "pallas4",
    "IR_ADS_DSCF_ATTN": "pallas3,pallas3,pallas3,xla",
    "IR_ADS_DSCF_RPE3": "pallas",
    "IR_ADS_PALLAS_INTERPRET": "1",  # also turns both backward kernels on
}


# --------------------------------------------------------------------------
# losses, schedules, optimizer
# --------------------------------------------------------------------------

def _loss_inputs(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(2, 12, 16, 5)).astype(dtype)
    labels = rng.randint(0, 5, (2, 12, 16))
    labels[0, :3] = 255
    labels[1, 5, 2:9] = 255
    return logits, labels


@pytest.mark.parametrize("name", ["CrossEntropy", "OhemCrossEntropy", "Dice"])
def test_losses_match_jax(name):
    """Value and gradient wrt the logits; the ignore label is out of both the
    numerator and the denominator.  f32 on both sides: 1e-5."""
    logits, labels = _loss_inputs(20)
    jfn, tfn = jlosses.get_loss(name), losses.get_loss(name)
    want, want_grad = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(labels), 255))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = tfn(lg, torch.from_numpy(labels), 255)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=1e-4)
    # ignored pixels carry no gradient
    assert float(lg.grad[torch.from_numpy(labels) == 255].abs().max()) == 0.0


def test_cross_entropy_class_weights_and_all_ignored():
    logits, labels = _loss_inputs(21)
    wts = np.asarray([0.5, 1.0, 2.0, 1.5, 0.1], np.float32)
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 255,
                                 jnp.asarray(wts))
    got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 255,
                               torch.from_numpy(wts))
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)
    none = torch.full((2, 12, 16), 255)
    assert float(losses.cross_entropy(torch.from_numpy(logits), none, 255)) == 0.0
    with pytest.raises(ValueError):
        losses.get_loss("Focal")


def test_ohem_takes_the_top_k_branch_when_few_pixels_are_hard():
    """Confident, correct logits: no pixel is above the threshold, so the
    mean of the n_valid / 16 hardest is taken on both sides."""
    rng = np.random.RandomState(22)
    labels = rng.randint(0, 5, (2, 12, 16))
    logits = (np.eye(5, dtype=np.float32)[labels] * 8 + 0.1 * rng.randn(2, 12, 16, 5)
              ).astype(np.float32)
    want = jlosses.ohem_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.ohem_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(want) < -np.log(0.7)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-5)


SCHEDULE_KW = dict(base_lr=4e-4, max_iter=401 * 198, warmup_iter=1980, warmup_ratio=0.1)


@pytest.mark.parametrize("name,extra", [("warmuppolylr", dict(power=0.9)),
                                        ("warmupcosinelr", dict(eta_ratio=0.05))])
@pytest.mark.parametrize("step", [0, 1, 990, 1979, 1980, 1981, 40000, 401 * 198 - 1,
                                  401 * 198])
def test_schedules_match_jax(name, extra, step):
    """Values at step 0, inside and at the end of the warmup, mid-run and at
    the end.  JAX computes in f32: relative 1e-5 (the poly's (1 - t)^0.9
    amplifies an f32 ulp of t near t = 1; atol 1e-9 there).  Past max_iter
    the JAX poly is NaN (a negative base); the port's stays at 0."""
    want = float(joptim.get_schedule(name, **SCHEDULE_KW, **extra)(step))
    got = optim.get_schedule(name, **SCHEDULE_KW, **extra)(step)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError):
        optim.get_schedule("step")
    if name == "warmuppolylr":
        assert optim.get_schedule(name, **SCHEDULE_KW, **extra)(401 * 198 + 50) == 0.0


class _Toy(nn.Module):
    """A frozen matrix, and a trainable matrix, bias and per-channel weight
    under adapter-matched names."""

    def __init__(self, values):
        super().__init__()
        self.backbone = nn.Linear(3, 4)
        self.adapter = nn.Linear(4, 2)
        self.mpg_gamma = nn.Parameter(torch.zeros(2))
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.from_numpy(values[name]))


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_two_updates_match_optax(name):
    """Two updates with different gradients and the schedule stepping from 0
    (inside a 1-step warmup, so the two learning rates differ): trainable
    parameters agree with optax to 1e-6, frozen ones are bit-equal, and under
    AdamW the vectors get no weight decay."""
    rng = np.random.RandomState(23)
    shapes = {"backbone.weight": (4, 3), "backbone.bias": (4,), "adapter.weight": (2, 4),
              "adapter.bias": (2,), "mpg_gamma": (2,)}
    values = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    kw = dict(base_lr=0.1, max_iter=10, warmup_iter=1, warmup_ratio=0.1)

    tree = {k.replace(".", "/"): jnp.asarray(v) for k, v in values.items()}
    tx = joptim.get_optimizer(name, joptim.warmup_poly_schedule(**kw), 0.01, "Adapter",
                              params=tree)
    state = tx.init(tree)
    for g in grads:
        upd, state = tx.update({k.replace(".", "/"): jnp.asarray(v) for k, v in g.items()},
                               state, tree)
        tree = optax.apply_updates(tree, upd)

    toy = _Toy(values)
    schedule = optim.warmup_poly_schedule(**kw)
    opt = optim.get_optimizer(name, toy, schedule, 0.01, "Adapter")
    assert [n for n, p in toy.named_parameters() if not p.requires_grad] == [
        "backbone.weight", "backbone.bias"]
    for step, g in enumerate(grads):
        for n, p in toy.named_parameters():
            p.grad = torch.from_numpy(g[n]) if p.requires_grad else None
        optim.set_lr(opt, schedule(step))
        opt.step()
    for n, p in toy.named_parameters():
        want = np.asarray(tree[n.replace(".", "/")])
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-6, rtol=1e-6,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(p.detach().numpy(), values[n])
            np.testing.assert_array_equal(want, values[n])


# --------------------------------------------------------------------------
# the adapter-only freeze
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_variables():
    rng = np.random.RandomState(24)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    model = _jax_model()
    return random_variables(model, 25, jnp.asarray(rgb), jnp.asarray(dte)), rgb, dte


H, W = 64, 80


def _jax_model():
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                     backbone_kwargs=dict(TINY, drop_path_rate=0.0, adapter_drop=0.0),
                     head_dims=(32, 16), head_drop=0.0, mmst_mask=False)


def test_trainable_set_equals_jax_adapter_mask(tiny_variables):
    """The JAX mask, carried through from_flax's names, is the port's
    ``requires_grad`` set; "head" matches the three decode heads only."""
    v = tiny_variables[0]
    mask = joptim.adapter_mask(v["params"])
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                             mask, v["params"])
    want = {k: bool(t.flatten()[0]) for k, t in from_flax({"params": as_arrays}).items()
            if not k.endswith("relative_position_index")}
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16), dispatch="train")
    optim.freeze_(port, "Adapter")
    got = {n: p.requires_grad for n, p in port.named_parameters()}
    assert got == want
    assert 0 < sum(got.values()) < len(got)
    by_head = {n for n in got if "head" in n.lower()}
    assert by_head and all(n.startswith(("decode_head.", "decode_head_rgb.",
                                         "decode_head_dte.")) for n in by_head)
    for frozen in ("backbone.patch_embed.projection.weight", "backbone.norm0.weight",
                   "backbone.fuse_norm1.weight",
                   "backbone.stages.1.blocks.0.attn.w_msa.qkv.weight",
                   "backbone.stages.0.blocks.0.ffn.layers.1.weight"):
        assert got[frozen] is False
    for trained in ("backbone.extra_patch_embed.projection.weight",
                    "backbone.stages.1.blocks.2.MLP_DTE_Adapter.D_fc1.weight",
                    "backbone.MPGBlocks.0.tfts_gamma_rgb",
                    "backbone.DeformMPGBlocks.3.deform_atten.rpe_table",
                    "decode_head_rgb.linear_pred.bias"):
        assert got[trained] is True
    optim.freeze_(port, "all")
    assert all(p.requires_grad for p in port.parameters())


# --------------------------------------------------------------------------
# the stochastic pieces on their own
# --------------------------------------------------------------------------

def test_drop_path_is_per_sample_scaled_and_reproducible():
    x = torch.ones(64, 3, 5)
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a = layers.drop_path(x, 0.25, True, gen())
    b = layers.drop_path(x, 0.25, True, gen())
    assert torch.equal(a, b)  # same seed, same mask
    per_sample = a.reshape(64, -1)
    assert bool(((per_sample == 0) | (per_sample == 1 / 0.75)).all())
    assert bool((per_sample.min(dim=1).values == per_sample.max(dim=1).values).all())
    kept = float((per_sample[:, 0] > 0).float().mean())
    assert 0.55 < kept < 0.95
    assert layers.drop_path(x, 0.25, False, gen()) is x
    assert layers.drop_path(x, 0.0, True, gen()) is x


def test_dropout_is_elementwise_scaled_and_reproducible():
    x = torch.ones(50, 40)
    a = layers.dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    b = layers.dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    c = layers.dropout(x, 0.1, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a == 0) | ((a - 1 / 0.9).abs() < 1e-6)).all())
    assert 0.85 < float((a > 0).float().mean()) < 0.95
    assert layers.dropout(x, 0.1, False) is x


def test_modality_mask_zeroes_one_rgb_and_another_dte_sample():
    rgb, dte = torch.ones(4, 3, 5, 2), torch.ones(4, 3, 5, 2)
    seen = set()
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        r, d = tswin.apply_modality_mask(rgb, dte, g)
        r2, d2 = tswin.apply_modality_mask(rgb, dte, torch.Generator().manual_seed(seed))
        assert torch.equal(r, r2) and torch.equal(d, d2)
        r_zero = [i for i in range(4) if float(r[i].abs().sum()) == 0]
        d_zero = [i for i in range(4) if float(d[i].abs().sum()) == 0]
        assert len(r_zero) == 1 and len(d_zero) == 1 and r_zero != d_zero
        assert float(r.sum()) == 3 * 30 and float(d.sum()) == 3 * 30
        seen.add((r_zero[0], d_zero[0]))
    assert len(seen) > 1
    r, d = tswin.apply_modality_mask(rgb[:1], dte[:1], torch.Generator().manual_seed(0))
    assert float(r.sum()) == 0 and float(d.sum()) == 0  # batch 1: both, as the JAX one


def test_stochastic_pieces_are_on_only_under_the_train_dispatch_in_train_mode():
    kw = dict(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16))
    x = torch.from_numpy(np.random.RandomState(26).randn(2, H, W, 3).astype(np.float32))
    with torch.no_grad():
        model = CMNeXt(dispatch="train", **kw)
        gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
        a = model.train()(x, x, gen(1))[0]
        assert torch.equal(a, model(x, x, gen(1))[0])
        assert not torch.equal(a, model(x, x, gen(2))[0])
        model.eval()
        assert torch.equal(model(x, x, gen(1))[0], model(x, x, gen(2))[0])
        served = CMNeXt(dispatch="r5", **kw).train()
        assert torch.equal(served(x, x, gen(1))[0], served(x, x, gen(2))[0])


def test_flax_batchnorm_statistics_after_a_train_forward():
    """flax updates the running variance with the biased batch variance and
    momentum 0.9; torch's own BatchNorm2d would use the unbiased one."""
    import flax.linen as fnn

    rng = np.random.RandomState(27)
    x = (rng.randn(3, 4, 5, 6) * 2 + 1).astype(np.float32)  # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(1 + 0.1 * rng.randn(6), jnp.float32),
                    "bias": jnp.asarray(0.1 * rng.randn(6), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.randn(6), jnp.float32),
                         "var": jnp.asarray(rng.rand(6) + 0.5, jnp.float32)}}
    want, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = layers.FlaxBatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    port.load_state_dict({"weight": torch.from_numpy(np.asarray(v["params"]["scale"])),
                          "bias": torch.from_numpy(np.asarray(v["params"]["bias"])),
                          "running_mean": torch.from_numpy(np.asarray(v["batch_stats"]["mean"])),
                          "running_var": torch.from_numpy(np.asarray(v["batch_stats"]["var"])),
                          "num_batches_tracked": torch.tensor(0)})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-6, rtol=1e-6)
    unbiased = 0.9 * np.asarray(v["batch_stats"]["var"]) + 0.1 * x.reshape(-1, 6).var(0, ddof=1)
    assert np.abs(port.running_var.numpy() - unbiased).max() > 1e-4
    # eval mode: torch's own running-statistics path
    port.eval()
    ev = bn.clone(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    got_ev = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_ev.detach().numpy(), np.asarray(ev), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------

def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SemSegTrainer()


def _tiny_trainer(**kw):
    return SemSegTrainer(**{**dict(device="cpu", num_classes=5, backbone_kwargs=TINY,
                                   head_dims=(32, 16)), **kw})


def _batch(seed):
    rng = np.random.RandomState(seed)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    label = rng.randint(0, 5, (2, H, W))
    label[0, :4] = 255
    return rgb, dte, label


def test_trainer_keeps_f32_masters_under_bf16_compute_and_freezes():
    """The shipped recipe at a tiny size, bf16 compute, every stochastic
    piece on: parameters stay f32, every trainable one moves, every frozen
    one and the serving model's buffers' shapes stay, losses are finite, and
    the same seed gives the same run."""
    runs = []
    for _ in range(2):
        tr = _tiny_trainer(dtype=torch.bfloat16, seed=3)
        start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        stats = {n: b.detach().clone() for n, b in tr.model.named_buffers()
                 if n.endswith("running_var")}
        out = [tr.step(*_batch(30 + i)) for i in range(2)]
        assert tr.steps == 2
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["loss_main"]) for m in out)
        assert all(m["loss"] > m["loss_main"] > 0 for m in out)
        for n, p in tr.model.named_parameters():
            assert p.dtype == torch.float32
            if p.requires_grad:  # (the key bias's gradient is zero: softmax shift)
                assert not torch.equal(p, start[n]) or n.endswith("proj_k.bias"), n
            else:
                assert torch.equal(p, start[n]) and p.grad is None, n
        for n, b in tr.model.named_buffers():
            if n.endswith("running_var"):
                assert b.dtype == torch.float32 and not torch.equal(b, stats[n]), n
        runs.append(out)
    assert runs[0] == runs[1]


# --------------------------------------------------------------------------
# the slice as a whole: two training steps on both sides
# --------------------------------------------------------------------------

def test_two_training_steps_match_jax(monkeypatch, tiny_variables):
    """f32, stochastic rates 0, the same weights and batches: the loss and
    loss_main of both steps, every trainable gradient of step 1, every
    parameter and every BatchNorm statistic after step 2, at atol 2e-3 /
    rtol 1e-3 (the eval slice's bar); frozen parameters bit-equal to their
    start.  The gradients are also held each on its own scale (below).  That bar is wider than two lr-sized AdamW steps (4e-5 each), so
    the updates are also held on their own: AdamW divides a gradient by its
    own size, which turns f32 noise on a near-zero gradient into a step of
    either sign, so a few elements may differ by up to a step; all but 0.5 %
    of the trainable elements must agree to a tenth of one step (4e-6)."""
    for k, val in TRAIN_ENV.items():
        monkeypatch.setenv(k, val)
    v, _, _ = tiny_variables
    batches = [_batch(40), _batch(41)]
    kw = dict(base_lr=4e-4, max_iter=401 * 198, power=0.9, warmup_iter=1980,
              warmup_ratio=0.1)

    model = _jax_model()
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = joptim.get_optimizer("adamw", joptim.warmup_poly_schedule(**kw), 0.01, "Adapter",
                              params=params)
    state = TrainState.create(model.apply, params,
                              jax.tree.map(jnp.asarray, v["batch_stats"]), tx)
    # jitted, as train_mm.py runs it: one compile is several times faster
    # here than the op-by-op dispatch of the interpreted kernels
    step_fn = jax.jit(make_train_step(jlosses.cross_entropy, 255))
    rng = jax.random.PRNGKey(0)

    @jax.jit
    def jax_grads(st, batch):
        def loss(p):
            (y, y_rgb, y_dte), _ = st.apply_fn(
                {"params": p, "batch_stats": st.batch_stats}, batch[0], batch[1],
                train=True, rngs={"mmst": rng, "dropout": rng}, mutable=["batch_stats"])
            lbl = batch[2]
            masked = jnp.where(jnp.argmax(y, -1) == lbl, 255, lbl)
            return (jlosses.cross_entropy(y, lbl, 255) + 0.01 * (
                jlosses.cross_entropy(y_rgb, masked, 255)
                + jlosses.cross_entropy(y_dte, masked, 255)))
        return jax.grad(loss)(st.params)

    jb = [tuple(jnp.asarray(a) for a in b) for b in batches]
    want_grads = from_flax({"params": jax.tree.map(np.asarray, jax_grads(state, jb[0]))})
    want_metrics = []
    for b in jb:
        state, m = step_fn(state, b, rng)
        want_metrics.append({k: float(x) for k, x in m.items()})
    want_sd = from_flax({"params": jax.tree.map(np.asarray, state.params),
                         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})

    tr = _tiny_trainer(dtype=torch.float32, state_dict=from_flax(v), head_drop=0.0,
                       mmst_mask=False,
                       backbone_kwargs=dict(TINY, drop_path_rate=0.0, adapter_drop=0.0))
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    got_metrics = [tr.step(*batches[0])]
    got_grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()
                 if p.requires_grad}
    got_metrics.append(tr.step(*batches[1]))

    for got, want in zip(got_metrics, want_metrics):
        for key in ("loss", "loss_main"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4)
    assert len(got_grads) > 100
    # Many gradients of this tiny model are far smaller than that atol (norms
    # down to 2e-10), so each is also held on its own scale: ||got - want|| <=
    # 3e-3 ||want|| (f32 sums in another order through the whole model; the
    # worst seen is 1.8e-3) and element by element within 3e-3 max|want| +
    # rtol 1e-3.  A bias ahead of a train-mode BatchNorm and the DSCF key bias
    # (a shift of every score) have a zero gradient in exact arithmetic; there
    # both sides must be f32 noise, under 1e-5 of the largest gradient norm.
    zero = ("deform_atten.proj_k.bias", "fuse_q.conv.0.bias", ".proj.bias")
    norms = {n: float(np.linalg.norm(want_grads[n].numpy())) for n in got_grads}
    largest = max(norms.values())
    held = []
    for n, g in got_grads.items():
        want = want_grads[n].numpy()
        np.testing.assert_allclose(g.numpy(), want, atol=2e-3, rtol=1e-3,
                                   err_msg=f"gradient of {n}")
        if n.endswith(zero):
            assert max(norms[n], float(g.norm())) <= 1e-5 * largest, n
            continue
        err = float(np.linalg.norm(g.numpy() - want))
        assert err <= 3e-3 * norms[n], f"gradient of {n}: {err:.3e} of {norms[n]:.3e}"
        np.testing.assert_allclose(g.numpy(), want, atol=3e-3 * float(np.abs(want).max()),
                                   rtol=1e-3, err_msg=f"gradient of {n}")
        held.append(norms[n])
    print(f"gradient norms held on their own scale: {len(held)} of {len(norms)}, from "
          f"{min(held):.3e} to {largest:.3e}, {sum(v < 2e-3 for v in held)} under 2e-3")
    assert len(norms) - len(held) == 4 + 4 + 3 * 4  # DSCF levels; c1-c4 of three heads
    moved = off = total = 0
    for n, p in tr.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(), atol=2e-3,
                                       rtol=1e-3, err_msg=n)
            if torch.equal(p, start[n]):
                # softmax ignores a shift of every score, so the key bias has a
                # zero gradient (f32 noise of ~1e-15, under AdamW's eps)
                assert n.endswith("deform_atten.proj_k.bias"), n
                assert float(got_grads[n].abs().max()) < 1e-10
            else:
                moved += 1
            diff = (p.detach() - start[n]) - (want_sd[n] - start[n])
            off += int((diff.abs() > 4e-6).sum())
            total += p.numel()
        else:
            assert torch.equal(p, start[n]), n
            np.testing.assert_array_equal(want_sd[n].numpy(), start[n].numpy())
    assert moved >= len(got_grads) - 4
    print(f"updates off by more than a tenth of a step: {off} of {total}")
    assert off <= 0.005 * total
    n_stats = 0
    for n, b in tr.model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want_sd[n].numpy(), atol=2e-3, rtol=1e-3,
                                       err_msg=n)
            n_stats += 1
    assert n_stats == 2 * (4 + 3)  # four DSCF fuse_q BNs, three heads

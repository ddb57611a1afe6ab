"""The training entry point's pieces against the JAX package, on the CPU:

  * the four random training transforms and ``get_train_augmentation``,
    bit for bit on the same ``np.random.default_rng(seed)``, both sides of
    every coin and crops that need the bottom-right pad;
  * two AdamW updates with ``grad_clip_norm`` against optax, the norm over
    the trainable parameters only under ``TRAIN_TYPE: Adapter``, with and
    without clipping, and the clip alone bit for bit;
  * ``to_flax`` and ``from_flax`` round trips on the tiny model's flax
    variables, bit for bit;
  * checkpoints both ways: JAX's ``load_checkpoint`` reads what the port
    wrote, and the port's reads what JAX wrote, for AdamW and SGD under
    Adapter and all, and AdamW with ``grad_clip_norm`` (params,
    statistics, moments, counts and step equal), and a checkpoint of
    another optimizer's form is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ir_ads_tpu.data import augmentations as jaug
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.training import optim as joptim
from ir_ads_tpu.training.train_state import TrainState as JaxTrainState
from ir_ads_tpu.utils import checkpoint as jckpt
from ir_ads_tpu_torch.data import augmentations as taug
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.train import build_state
from ir_ads_tpu_torch.training import optim
from ir_ads_tpu_torch.utils import checkpoint as tckpt
from ir_ads_tpu_torch.utils.config import DEFAULTS, _merge
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from test_torch_model import TINY, random_variables

# --------------------------------------------------------------------------
# the training transforms
# --------------------------------------------------------------------------


def _sample(seed, h=60, w=80):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 40, (h, w)).astype(np.int32)
    label[:3] = 255
    return {"img": rng.randint(0, 256, (h, w, 3), dtype=np.uint8),
            "depth": rng.randint(0, 256, (h, w, 3), dtype=np.uint8), "mask": label}


def _equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


TRANSFORMS = {
    "crop": (lambda m: m.RandomResizedCrop((64, 64), scale=(0.5, 2.0), seg_fill=255)),
    "flip": (lambda m: m.RandomHorizontalFlip(p=0.5)),
    "jitter": (lambda m: m.RandomColorJitter(p=0.5)),
    "blur": (lambda m: m.RandomGaussianBlur(3, p=0.5)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_train_transform_is_jax_bit_for_bit(name):
    """Sixteen samples each on its own seeded generator: the outputs and the
    generators' next draws equal; the coin falls both ways (the crop: a
    window inside the resized map and one that needs the pad)."""
    sides = set()
    for seed in range(16):
        sample = _sample(seed)
        t_rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = TRANSFORMS[name](taug)(dict(sample), t_rng)
        want = TRANSFORMS[name](jaug)(dict(sample), j_rng)
        _equal(got, want)
        assert t_rng.random() == j_rng.random()
        if name == "crop":
            sides.add(bool((got["mask"][-1] == 255).all() and (got["img"][-1] == 0).all()))
        else:
            sides.add(not all(np.array_equal(got[k], sample[k]) for k in sample))
    assert sides == {True, False}


def test_train_augmentation_is_jax_bit_for_bit():
    for seed in range(8):
        sample = _sample(100 + seed, 48, 72)
        got = taug.get_train_augmentation((64, 64))(dict(sample), np.random.default_rng(seed))
        want = jaug.get_train_augmentation((64, 64))(dict(sample), np.random.default_rng(seed))
        _equal(got, want)
        assert got["img"].dtype == np.float32 and got["mask"].shape == (64, 64)


# --------------------------------------------------------------------------
# gradient clipping
# --------------------------------------------------------------------------

SHAPES = {"backbone.weight": (4, 3), "backbone.bias": (4,), "adapter.weight": (2, 4),
          "adapter.bias": (2,), "mpg_gamma": (2,)}


class _Toy(nn.Module):
    def __init__(self, values):
        super().__init__()
        self.backbone = nn.Linear(3, 4)
        self.adapter = nn.Linear(4, 2)
        self.mpg_gamma = nn.Parameter(torch.zeros(2))
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.from_numpy(values[name]))


def _optax_run(name, train_type, values, grads, kw, bound):
    tree = {k.replace(".", "/"): jnp.asarray(v) for k, v in values.items()}
    tx = joptim.get_optimizer(name, joptim.warmup_poly_schedule(**kw), 0.01, train_type,
                              params=tree, grad_clip_norm=bound)
    state = tx.init(tree)
    for g in grads:
        upd, state = tx.update({k.replace(".", "/"): jnp.asarray(v) for k, v in g.items()},
                               state, tree)
        tree = optax.apply_updates(tree, upd)
    return {k.replace("/", "."): np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("train_type", ["Adapter", "all"])
def test_clipped_updates_match_optax(train_type):
    """Two updates with ``grad_clip_norm``, at a bound that the global norm
    of the trainable gradients exceeds in both updates (0.5) and at one it
    exceeds in neither (100): the trainable parameters agree with optax to
    rtol 1e-6 and atol 1e-6 (test_torch_training's optimizer bar), while
    optax without the clip is further off than that at 0.5; frozen ones
    stay.  lr 0.01: optax takes AdamW's bias correction 1 - b2^t in f32
    (2e-3 at t = 2, to 3e-5 of itself), torch in double, so their updates
    part by up to 3e-5 of a step."""
    rng = np.random.RandomState(29)
    values = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (2.0 * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(2)]
    kw = dict(base_lr=0.01, max_iter=10, warmup_iter=1, warmup_ratio=0.1)
    name = "adamw"
    unclipped = _optax_run(name, train_type, values, grads, kw, None)
    for bound in (0.5, 100.0):
        want = _optax_run(name, train_type, values, grads, kw, bound)
        toy = _Toy(values)
        schedule = optim.warmup_poly_schedule(**kw)
        opt = optim.get_optimizer(name, toy, schedule, 0.01, train_type, grad_clip_norm=bound)
        trained = {n for n, p in toy.named_parameters() if p.requires_grad}
        for step, g in enumerate(grads):
            norm = np.sqrt(sum(float((g[n].astype(np.float64) ** 2).sum()) for n in trained))
            assert (norm >= bound) == (bound == 0.5)
            for n, p in toy.named_parameters():
                p.grad = torch.from_numpy(g[n].copy()) if p.requires_grad else None
            optim.set_lr(opt, schedule(step))
            opt.step()
        far = 0.0
        for n, p in toy.named_parameters():
            if n in trained:
                np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6, atol=1e-6,
                                           err_msg=f"{n} at bound {bound}")
                far = max(far, float(np.abs(p.detach().numpy() - unclipped[n]).max()))
            else:
                np.testing.assert_array_equal(p.detach().numpy(), values[n])
        assert (far > 1e-5) == (bound == 0.5), far


def test_clip_is_optax_not_clip_grad_norm():
    """(g / norm) * max_norm with no epsilon, bit for bit against optax's
    transform on one f32 tree; torch's clip_grad_norm_ is another function."""
    rng = np.random.RandomState(30)
    gs = [rng.randn(5, 7).astype(np.float32), rng.randn(11).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(1.5).update([jnp.asarray(g) for g in gs], None)
    params = [nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(params, gs):
        p.grad = torch.from_numpy(g.copy())
    optim.clip_by_global_norm_(params, 1.5)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=2e-7, atol=0)


# --------------------------------------------------------------------------
# to_flax
# --------------------------------------------------------------------------

def _jax_model():
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                     backbone_kwargs=dict(TINY), head_dims=(32, 16))


@pytest.fixture(scope="module")
def tiny_variables():
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return random_variables(_jax_model(), 31, x, x)


def _same_tree(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def test_to_flax_round_trips_bit_for_bit(tiny_variables):
    """to_flax(from_flax(v)) is v (stage 1's four blocks restacked as two
    pairs) and from_flax(to_flax(sd)) is sd, for the tiny model's flax
    variables and for the port model's own state_dict."""
    v = jax.tree.map(np.asarray, tiny_variables)
    sd = from_flax(v)
    back = to_flax(sd)
    _same_tree(back, v)
    assert back["params"]["backbone"]["stages_1"]["pairs"]["block1"]["ffn"]["Dense_0"][
        "kernel"].shape == (2, 32, 128)
    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16), dispatch="train")
    port.load_state_dict(sd)
    again = from_flax(to_flax(port.state_dict()))
    assert set(again) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert again[k].dtype == t.dtype and torch.equal(again[k], t), k


def test_to_flax_refuses_a_name_it_cannot_map():
    with pytest.raises(ValueError, match="to_flax"):
        to_flax({"decode_head.linear_c1.weight": torch.zeros(2, 2)})  # no ".proj"


# --------------------------------------------------------------------------
# checkpoints both ways
# --------------------------------------------------------------------------

# (optimizer, TRAIN_TYPE, grad_clip_norm): every form train_mm's recipe can
# build, and one with the clip inside the mask
FORMS = [("adamw", "Adapter", None), ("adamw", "all", None), ("sgd", "Adapter", None),
         ("sgd", "all", None), ("adamw", "Adapter", 1.0)]


def _port_state(variables, name, train_type, clip=None):
    model = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16), dispatch="train")
    model.load_state_dict(from_flax(variables))
    cfg = _merge(DEFAULTS, {"OPTIMIZER": {"NAME": name, "TRAIN_TYPE": train_type},
                            "TRAIN": {"EPOCHS": 3}})
    state = build_state(model, cfg, iters_per_epoch=2, seed=0)
    state.grad_clip_norm = clip
    return state


def _jax_state(variables, name, train_type, clip=None):
    params = variables["params"]
    tx = joptim.get_optimizer(name, joptim.warmup_poly_schedule(4e-4, 8, warmup_iter=2),
                              0.01, train_type, params=params, grad_clip_norm=clip)
    return JaxTrainState.create(_jax_model().apply, params, variables["batch_stats"], tx)


def _optax_parts(opt_state):
    """{"mu", "nu", "count"} of the ScaleByAdamState, or {"trace"}, and the
    schedule's counts, found by type in the optax state."""
    found, counts = {}, []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.update(mu=node.mu, nu=node.nu, count=node.count)
        elif isinstance(node, optax.TraceState):
            found.update(trace=node.trace)
        elif type(node).__name__ == "ScaleByScheduleState":
            counts.append(int(node.count))
        elif isinstance(node, tuple):
            for child in node:
                visit(child)

    visit(opt_state)
    return found, counts


MOMENT = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}


def _flax_named(tree):
    """A masked moment tree (frozen leaves as optax.MaskedNode) by the
    port's names."""
    def strip(t):
        if isinstance(t, dict):
            return {k: strip(v) for k, v in t.items() if not isinstance(v, optax.MaskedNode)}
        return np.asarray(t)

    return from_flax({"params": strip(tree)})


def _port_wrote(tiny_variables, tmp_path, name, train_type, clip):
    """JAX's load_checkpoint reads what the port wrote, its every leaf moved
    from the start and its moments drawn."""
    port = _port_state(tiny_variables, name, train_type, clip)
    g = torch.Generator().manual_seed(32)
    with torch.no_grad():
        for p in port.model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
        for n, b in port.model.named_buffers():
            if n.endswith("running_mean"):
                b.add_(torch.randn(b.shape, generator=g))
    trained = {n: p for n, p in port.model.named_parameters() if p.requires_grad}
    for p in trained.values():
        port.optimizer.state[p] = {
            "exp_avg": torch.randn(p.shape, generator=g),
            "exp_avg_sq": torch.rand(p.shape, generator=g), "step": torch.tensor(5.0),
        } if name == "adamw" else {"momentum_buffer": torch.randn(p.shape, generator=g)}
    port.step = 5
    tckpt.save_checkpoint(str(tmp_path), port, 0.25, 3, extra={"config": {"k": 1}})

    restored, manifest = jckpt.load_checkpoint(str(tmp_path), _jax_state(
        tiny_variables, name, train_type, clip))
    assert manifest == {"best_miou": 0.25, "epoch": 3, "config": {"k": 1}}
    assert int(restored.step) == 5
    got = from_flax({"params": jax.tree.map(np.asarray, restored.params),
                     "batch_stats": jax.tree.map(np.asarray, restored.batch_stats)})
    for k, t in port.model.state_dict().items():
        assert torch.equal(got[k], t), k
    parts, counts = _optax_parts(restored.opt_state)
    assert counts == [5]
    for key in ("mu", "nu") if name == "adamw" else ("trace",):
        named = _flax_named(parts[key])
        assert {k for k in named if not k.endswith("index")} == set(trained)
        for n, p in trained.items():
            assert torch.equal(named[n], port.optimizer.state[p][MOMENT[key]]), (key, n)
    if name == "adamw":
        assert int(parts["count"]) == 5


def _jax_wrote(tiny_variables, tmp_path, name, train_type, clip):
    """The port's load_checkpoint reads what JAX wrote, every leaf drawn."""
    state = _jax_state(tiny_variables, name, train_type, clip)
    rng = np.random.RandomState(33)

    def draw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return (x + rng.randn(*x.shape)).astype(x.dtype)
        return np.asarray(7, x.dtype)

    state = state.replace(opt_state=jax.tree.map(draw, state.opt_state),
                          step=np.asarray(7, np.int32),
                          params=jax.tree.map(draw, state.params))
    jckpt.save_checkpoint(str(tmp_path), state, 0.5, 4)

    port = _port_state(tiny_variables, name, train_type, clip)
    manifest = tckpt.load_checkpoint(str(tmp_path), port)
    assert manifest["epoch"] == 4 and manifest["best_miou"] == 0.5 and port.step == 7
    want = from_flax({"params": jax.tree.map(np.asarray, state.params),
                      "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    for k, t in port.model.state_dict().items():
        assert torch.equal(t, want[k]), k
    parts, _ = _optax_parts(state.opt_state)
    trained = {n: p for n, p in port.model.named_parameters() if p.requires_grad}
    assert (len(trained) < len(list(port.model.parameters()))) == (train_type == "Adapter")
    for key in ("mu", "nu") if name == "adamw" else ("trace",):
        named = _flax_named(parts[key])
        for n, p in trained.items():
            assert torch.equal(port.optimizer.state[p][MOMENT[key]], named[n]), (key, n)
    if name == "adamw":
        assert all(float(port.optimizer.state[p]["step"]) == 7.0 for p in trained.values())


@pytest.mark.parametrize("name,train_type,clip", FORMS)
def test_checkpoints_read_both_ways(tiny_variables, tmp_path, name, train_type, clip):
    """Params, statistics, moments, counts and step equal bit for bit."""
    _port_wrote(tiny_variables, tmp_path / "port", name, train_type, clip)
    _jax_wrote(tiny_variables, tmp_path / "jax", name, train_type, clip)


def test_a_checkpoint_of_another_optimizer_is_refused(tiny_variables, tmp_path):
    tckpt.save_checkpoint(str(tmp_path), _port_state(tiny_variables, "sgd", "Adapter"))
    for other in (("adamw", "Adapter"), ("sgd", "all"), ("sgd", "Adapter", 1.0)):
        with pytest.raises(ValueError, match="opt_state"):
            tckpt.load_checkpoint(str(tmp_path), _port_state(tiny_variables, *other))

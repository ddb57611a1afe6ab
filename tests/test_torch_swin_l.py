"""The Swin-L CMNeXt on the port against the JAX package, on the CPU in f32.

A tiny configuration keeps the shapes that set Swin-L apart from Swin-B:
12 channels a DSCF head at every level (embed 96, DSCF heads 1/2/4/8: the
full model's 24 * 2^i channels over 2 * 2^i heads), window heads of d = 32
(192 / 6 in the full model), a depth-4 stage, so that the JAX package scans
block pairs (under remat by pair), and 64x112 frames, where every DSCF
level has 2n % 8 == 0 and takes the rows path (K3 + K4).

  * K4's and K8's plain versions at 12 channels a head against the
    interpreted Pallas rows kernels (both forms, bf16) and backward kernel.
  * The r5 logits against JAX's (its kernels interpreted, as
    tests/test_torch_slice_r5.py runs them), atol 2e-3 / rtol 1e-3.
  * One training step with remat on every block against JAX's Swin-L step
    (``use_remat`` forced on for -L), every stochastic rate 0: the loss at
    1e-4, then every trainable gradient group by group at the bar above.
  * Remat on and off give the same gradients bit for bit, with drop-path,
    the adapter's and the heads' dropout, the modality mask (and, with
    ``drop_rate``, the blocks' dropout) drawn from one seeded generator; a
    recomputation that draws from the generator where the forward left it
    (not replayed) must not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.ops.pallas_dscf import pallas_dscf_attention_rows, pallas_dscf_rows_bwd
from ir_ads_tpu.training import losses as jlosses
from ir_ads_tpu_torch.models import build_model
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops import dscf_rows, dscf_rows_bwd
from ir_ads_tpu_torch.train import SemSegTrainer
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from test_torch_model import random_variables
from test_torch_slice_r5 import R5_ENV
from test_torch_training import TRAIN_ENV

TINY_L = dict(embed_dim=96, depths=(1, 4, 1, 1), num_heads=(3, 6, 12, 24), window_size=4,
              dscf_heads=(1, 2, 4, 8))
H, W = 64, 112
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(**kw):
    return JaxCMNeXt(backbone="SwinTransformer-L", num_classes=5,
                     backbone_kwargs=dict(TINY_L, drop_path_rate=0.0, adapter_drop=0.0),
                     head_dims=(32, 16), head_drop=0.0, mmst_mask=False, **kw)


def _frames(seed, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, H, W, 3).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def variables():
    rgb, dte = _frames(50)
    return random_variables(_jax_model(), 51, jnp.asarray(rgb), jnp.asarray(dte))


# --------------------------------------------------------------------------
# K4 and K8 at 12 channels a head
# --------------------------------------------------------------------------

def _rows_inputs(seed, bg=2, h=8, w=16, hg=2, hc=12, m=48):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(bg, n, hg * hc).astype(np.float32) for n in (h * w, m, m, h * w))
    bias = (2.0 * rng.randn(bg, hg, h, m, w)).astype(np.float32)
    return q, k, v, bias, g, hg


@pytest.mark.parametrize("packed", [True, False])
def test_rows_attention_12_channels_matches_pallas(packed):
    """bf16 at the model's scale 12 ** -0.5, bit for bit (the rounding
    points are the kernel's); f32 at 1e-5."""
    q, k, v, bias, _, hg = _rows_inputs(60)
    scale = 12 ** -0.5
    for jdt, tdt in ((jnp.bfloat16, BF16), (jnp.float32, torch.float32)):
        want = pallas_dscf_attention_rows(*(jnp.asarray(a, jdt) for a in (q, k, v, bias)),
                                          scale, hg, interpret=True, packed=packed)
        got = dscf_rows.dscf_rows_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, bias)),
                                            scale, hg, packed)
        want = np.asarray(want.astype(jnp.float32))
        if tdt == BF16:
            assert float((got.float().numpy() != want).mean()) == 0.0
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_bwd_12_channels_matches_pallas(dtype):
    q, k, v, bias, g, hg = _rows_inputs(61)
    scale = 12 ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_dscf_rows_bwd(*(jnp.asarray(a, jdt) for a in (q, k, v, bias, g)), scale, hg,
                                interpret=True)
    got = dscf_rows_bwd.dscf_rows_bwd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, bias, g)),
                                      scale, hg)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   err_msg=name, **tol)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_swin_l_is_built_with_remat_and_its_widths():
    with torch.device("meta"):  # the full width, no weights drawn
        model = CMNeXt("SwinTransformer-L", 40, dispatch="train")
        served = CMNeXt("SwinTransformer-L", 40)
    bb = model.backbone
    assert bb.num_features == [192, 384, 768, 1536]
    assert [s.blocks[0].num_heads for s in bb.stages] == [6, 12, 24, 48]
    assert all(s.use_remat for s in bb.stages)
    assert [m.deform_atten.n_heads for m in bb.DeformMPGBlocks] == [2, 4, 8, 16]
    assert [m.deform_atten.proj_q.weight.shape[0] // m.deform_atten.n_heads
            for m in bb.DeformMPGBlocks] == [12] * 4
    # eval dispatches ignore remat
    assert not any(s.use_remat for s in served.backbone.stages)
    # build_model takes it from the registry
    tiny = build_model("CMNeXt", "SwinTransformer-L", 5, backbone_kwargs=TINY_L,
                       head_dims=(32, 16), dispatch="train")
    assert all(s.use_remat for s in tiny.backbone.stages)


def test_swin_l_r5_logits_match_jax(monkeypatch, variables):
    for k, v in R5_ENV.items():
        monkeypatch.setenv(k, v)
    rgb, dte = _frames(52)
    model = _jax_model(upsample_logits=False)
    # jitted: one compile is faster here than the interpreted kernels op by op
    fwd = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False)[0])
    want = np.asarray(fwd(variables, jnp.asarray(rgb), jnp.asarray(dte)))
    port = CMNeXt("SwinTransformer-L", num_classes=5, backbone_kwargs=TINY_L,
                  head_dims=(32, 16), upsample_logits=False).eval()
    assert [m.deform_atten.rows_path(8) for m in port.backbone.DeformMPGBlocks] == [
        True, True, True, False]
    port.load_state_dict(from_flax(variables))
    # the Swin-L tree carries back to flax's leaf by leaf
    back = dict(_leaves(to_flax(port.state_dict())))
    assert back.keys() == dict(_leaves(variables)).keys()
    assert all(np.array_equal(back[k], a) for k, a in _leaves(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(rgb), torch.from_numpy(dte))[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _jax_loss_and_grads(model, variables, rgb, dte, label):
    rng = jax.random.PRNGKey(0)

    @jax.jit
    def run(params, batch):
        def loss(p):
            (y, y_rgb, y_dte), _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, batch[0], batch[1],
                train=True, rngs={"mmst": rng, "dropout": rng}, mutable=["batch_stats"])
            lbl = batch[2]
            masked = jnp.where(jnp.argmax(y, -1) == lbl, 255, lbl)
            return (jlosses.cross_entropy(y, lbl, 255) + 0.01 * (
                jlosses.cross_entropy(y_rgb, masked, 255)
                + jlosses.cross_entropy(y_dte, masked, 255)))
        return jax.value_and_grad(loss)(params)

    loss, grads = run(jax.tree.map(jnp.asarray, variables["params"]),
                      (jnp.asarray(rgb), jnp.asarray(dte), jnp.asarray(label)))
    return float(loss), from_flax({"params": jax.tree.map(np.asarray, grads)})


def _label(seed):
    label = np.random.RandomState(seed).randint(0, 5, (2, H, W))
    label[0, :4] = 255
    return label


def check_step_against_jax(trainer, want_loss, want_grads, batch):
    """The loss at 1e-4 and every trainable gradient at atol 2e-3 / rtol
    1e-3 (tests/test_torch_rows_path.py's bars at 64x112, where the rows
    path's discontinuities make a finer per-group bar a matter of the
    draw)."""
    got = trainer.step(*batch)
    np.testing.assert_allclose(got["loss"], want_loss, atol=1e-4, rtol=1e-4)
    grads = {n: p.grad for n, p in trainer.model.named_parameters() if p.requires_grad}
    assert len(grads) > 100
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=f"gradient of {n}")


def test_swin_l_train_step_with_remat_matches_jax(monkeypatch, variables):
    for k, v in TRAIN_ENV.items():
        monkeypatch.setenv(k, v)
    rgb, dte = _frames(53)
    label = _label(54)
    want_loss, want_grads = _jax_loss_and_grads(_jax_model(), variables, rgb, dte, label)
    tr = SemSegTrainer(device="cpu", dtype=torch.float32, num_classes=5, head_dims=(32, 16),
                       backbone="SwinTransformer-L", head_drop=0.0, mmst_mask=False,
                       backbone_kwargs=dict(TINY_L, drop_path_rate=0.0, adapter_drop=0.0),
                       state_dict=from_flax(variables))
    assert all(s.use_remat for s in tr.model.backbone.stages)
    check_step_against_jax(tr, want_loss, want_grads, (rgb, dte, label))


# --------------------------------------------------------------------------
# remat replays the draws
# --------------------------------------------------------------------------

SMALL = dict(embed_dim=16, depths=(1, 2, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
             drop_path_rate=0.3, adapter_drop=0.1)


def _grads(remat, drop_rate, seed=7):
    torch.manual_seed(0)  # the global generator, which the port never draws from
    model = CMNeXt(num_classes=5, head_dims=(32, 16), dispatch="train", head_drop=0.1,
                   backbone_kwargs=dict(SMALL, use_remat=remat, drop_rate=drop_rate)).train()
    model.load_state_dict(_weights())
    rgb, dte = (torch.from_numpy(a) for a in _frames(55))
    gen = torch.Generator().manual_seed(seed)
    ys = model(rgb, dte, gen)
    sum(y.square().mean() for y in ys).backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


_WEIGHTS = {}


def _weights():
    if not _WEIGHTS:
        from ir_ads_tpu_torch.serve import init_random_

        model = CMNeXt(num_classes=5, head_dims=(32, 16), dispatch="train",
                       backbone_kwargs=SMALL)
        init_random_(model, 4)
        _WEIGHTS.update(model.state_dict())
    return _WEIGHTS


@pytest.mark.parametrize("drop_rate", [0.0, 0.1])
def test_remat_gives_the_same_gradients_bit_for_bit(drop_rate):
    plain, remat = _grads(False, drop_rate), _grads(True, drop_rate)
    assert set(plain) == set(remat) and len(plain) > 100
    for n in plain:
        assert torch.equal(plain[n], remat[n]), n


def test_remat_without_replayed_draws_moves_the_gradients(monkeypatch):
    """The planted fault: the recomputation draws from the step's generator
    where the forward left it, as ``checkpoint`` alone would."""
    plain = _grads(False, 0.0)
    monkeypatch.setattr(tswin.ReplayedDraws, "__call__", lambda self: self.generator)
    faulted = _grads(True, 0.0)
    moved = [n for n in plain
             if float((faulted[n] - plain[n]).norm()) > 1e-6 * float(plain[n].norm())]
    assert len(moved) > 10, moved

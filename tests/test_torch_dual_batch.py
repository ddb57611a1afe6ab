"""``dual_batch``: both streams through each Swin stage in one call (the JAX
package's sub-mode "dual"), on the CPU in f32.

  * The tiny CMNeXt's r5 logits with ``dual_batch=True`` against JAX's
    (its kernels interpreted, tests/test_torch_slice_r5.py's environment),
    atol 2e-3 / rtol 1e-3; and against the port's own streams-in-turn
    logits under r5 (K5 with the adapters stacked, K2 once a half), r4i8
    (K11 once a half), v7_01 (K13, S = 2) and r2 (the module path), where
    only the f32 sums' order may differ (1e-5).
  * One dual training step against JAX's dual step (every stochastic rate
    0): the loss and every trainable gradient at atol 2e-3 / rtol 1e-3;
    and the dual step's gradients against the streams-in-turn step's.  The
    step's inputs are tests/test_torch_rows_path.py's (frames and labels
    from seed 82, weights from 83): on other draws the train-mode forward
    (BatchNorm on batch statistics, the MMST loss's argmax mask) can put the
    port's streams-in-turn step as far from JAX's as the bar, dual or not
    (ROADMAP, Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops.int8 import quantize_int8_
from ir_ads_tpu_torch.train import SemSegTrainer
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables
from test_torch_slice_r5 import R5_ENV
from test_torch_swin_l import _jax_loss_and_grads, check_step_against_jax
from test_torch_training import TRAIN_ENV

H, W = 64, 112


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, H, W, 3).astype(np.float32) for _ in range(2)]


def _jax_model(**kw):
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                     backbone_kwargs=dict(TINY, drop_path_rate=0.0, adapter_drop=0.0,
                                          dual_batch=True),
                     head_dims=(32, 16), head_drop=0.0, mmst_mask=False, **kw)


@pytest.fixture(scope="module")
def variables():
    rgb, dte = _frames(80)
    return random_variables(_jax_model(), 81, jnp.asarray(rgb), jnp.asarray(dte))


def _port(dual, dispatch="r5", **kw):
    return CMNeXt(num_classes=5, backbone_kwargs=dict(TINY, dual_batch=dual),
                  head_dims=(32, 16), upsample_logits=False, dispatch=dispatch, **kw).eval()


def test_dual_r5_logits_match_jax(monkeypatch, variables):
    for k, v in R5_ENV.items():
        monkeypatch.setenv(k, v)
    rgb, dte = _frames(82)
    model = _jax_model(upsample_logits=False)
    fwd = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False)[0])
    want = np.asarray(fwd(variables, jnp.asarray(rgb), jnp.asarray(dte)))
    port = _port(True)
    assert port.backbone.dual_batch
    port.load_state_dict(from_flax(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(rgb), torch.from_numpy(dte))[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("dispatch", ["r5", "r4i8", "v7_01", "r2"])
def test_dual_logits_match_the_streams_in_turn(variables, dispatch):
    rgb, dte = (torch.from_numpy(a) for a in _frames(83))
    outs = []
    for dual in (False, True):
        port = _port(dual, dispatch)
        port.load_state_dict(from_flax(variables))
        if dispatch == "r4i8":
            quantize_int8_(port, None)
        with torch.no_grad():
            outs.append(port(rgb, dte))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def _step_inputs():
    """tests/test_torch_rows_path.py's training inputs."""
    rng = np.random.RandomState(82)
    rgb, dte = (rng.randn(2, H, W, 3).astype(np.float32) for _ in range(2))
    label = rng.randint(0, 5, (2, H, W))
    label[0, :4] = 255
    return rgb, dte, label


def _trainer(dual, state_dict):
    return SemSegTrainer(device="cpu", dtype=torch.float32, num_classes=5, head_dims=(32, 16),
                         head_drop=0.0, mmst_mask=False, state_dict=state_dict,
                         backbone_kwargs=dict(TINY, drop_path_rate=0.0, adapter_drop=0.0,
                                              dual_batch=dual))


def test_dual_train_step_matches_jax_and_the_streams_in_turn(monkeypatch):
    for k, v in TRAIN_ENV.items():
        monkeypatch.setenv(k, v)
    rgb, dte, label = _step_inputs()
    variables = random_variables(_jax_model(), 83, jnp.asarray(rgb), jnp.asarray(dte))
    want_loss, want_grads = _jax_loss_and_grads(_jax_model(), variables, rgb, dte, label)
    dual = _trainer(True, from_flax(variables))
    check_step_against_jax(dual, want_loss, want_grads, (rgb, dte, label))
    turns = _trainer(False, from_flax(variables))
    turns.step(rgb, dte, label)
    grads = dict(turns.model.named_parameters())
    for n, p in dual.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), grads[n].grad.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=n)


def test_drivers_take_swin_l_and_dual_batch_from_the_config(tmp_path):
    """``MODEL.BACKBONE: SwinTransformer-L`` with ``BACKBONE_KWARGS.dual_batch``
    (tiny widths) through ``train_mm.main`` (remat on, as for -L) and then
    ``val_mm.main`` on the checkpoint it wrote."""
    from ir_ads_tpu_torch import train_mm, val_mm
    from test_torch_train_driver import _cfg as train_cfg

    cfg = train_cfg(tmp_path, dual_batch=True)
    cfg["MODEL"]["BACKBONE"] = "SwinTransformer-L"
    cfg["TRAIN"]["EPOCHS"] = 1
    result = train_mm.main(cfg, device="cpu", seed=5)
    assert train_mm.save_dir_of(cfg).name == "Synthetic_SwinTransformer-L_id"
    bb = result["state"].model.backbone
    assert bb.dual_batch and all(s.use_remat for s in bb.stages)
    assert np.isfinite(result["epochs"][0]["loss"])
    cfg["EVAL"]["MODEL_PATH"] = str(train_mm.save_dir_of(cfg) / "latest")
    evaluated = val_mm.main(cfg, device="cpu")
    assert evaluated["images"] == 2 and np.isfinite(evaluated["miou"])

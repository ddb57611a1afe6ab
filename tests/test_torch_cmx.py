"""The legacy CMX (``models/backbones/cmx.py`` with ``models/modules/
fusion.py``) against the JAX package, on the CPU, weights carried across by
utils/jax_params.from_flax and drawn as tests/test_torch_mit.py draws them
(``legacy_variables``: fan-in kernels, so that FRM's and FFM's branches
move the logits).

  * FRM, ``_CrossLinearAttention`` (its softmax over axis -2 of k^T v) and
    FFM in eval (its two BatchNorms with running statistics) and the plain
    MiT block against their flax modules, f32, atol 2e-5.
  * CMX-B0's logits at 64x64 against JAX's jitted apply, f32, atol 2e-3 /
    rtol 1e-3, under the port's r5 and xla dispatches: CMX has no DSCF, so
    both run the same function, and JAX's trace under ``R5_ENV`` is its
    only one.
  * ``from_flax`` -> ``to_flax`` leaf for leaf, the FFMs' ``batch_stats``
    among them; CMX-B5's parameter shapes on the meta device against
    ``jax.eval_shape``'s.

One JAX compile, the port in one thread: about 40 s in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models import build_model as jax_build_model
from ir_ads_tpu.models.backbones import cmx as jcmx
from ir_ads_tpu.models.modules import fusion as jfusion
from ir_ads_tpu_torch.models import CMNeXtLegacy
from ir_ads_tpu_torch.models.backbones import cmx as tcmx
from ir_ads_tpu_torch.models.modules import fusion as tfusion
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from test_torch_mit import (
    ATOL, CLASSES, RTOL, _jitted_logits, _port_logits, carried, frames, legacy_variables,
    one_thread, shapes_of,
)
from test_torch_slice_r5 import R5_ENV

__all__ = ["one_thread"]  # the module-scoped fixture: the port in one thread


def _pair(seed, *shape):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(2))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_feature_rectify_module_matches_flax():
    x1, x2 = _pair(40, 2, 6, 9, 32)
    jm = jfusion.FeatureRectifyModule()
    v = legacy_variables(jm, 41, jnp.asarray(x1), jnp.asarray(x2))
    port = carried(tfusion.FeatureRectifyModule(32), v)
    want = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    for g, w in zip(got, want):
        _close(g, w)
    # each stream is rectified by the other: swapping them moves both
    with torch.no_grad():
        swapped = port(torch.from_numpy(x2), torch.from_numpy(x1))
    assert not torch.allclose(swapped[1], got[0], atol=1e-3)


@pytest.mark.parametrize("heads", [1, 5])
def test_cross_linear_attention_matches_flax(heads):
    x1, x2 = _pair(42 + heads, 2, 30, 40)
    jm = jfusion._CrossLinearAttention(heads)
    v = legacy_variables(jm, 43, jnp.asarray(x1), jnp.asarray(x2))
    port = carried(tfusion._CrossLinearAttention(40, heads), v)
    assert port.kv1.bias is None and port.kv2.bias is None
    want = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    for g, w in zip(got, want):
        _close(g, w)


def test_feature_fusion_module_matches_flax_in_eval():
    x1, x2 = _pair(44, 2, 5, 6, 40)
    jm = jfusion.FeatureFusionModule(num_heads=5)
    v = legacy_variables(jm, 45, jnp.asarray(x1), jnp.asarray(x2))
    assert set(v["batch_stats"]) == {"embed_bn", "out_bn"}
    port = carried(tfusion.FeatureFusionModule(40, num_heads=5), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    _close(got, jm.apply(v, jnp.asarray(x1), jnp.asarray(x2)))


def test_mit_block_matches_flax():
    x = np.random.RandomState(46).randn(2, 8, 12, 64).astype(np.float32)
    jm = jcmx.MiTBlock(64, 2, 4)
    v = legacy_variables(jm, 47, jnp.asarray(x))
    port = carried(tcmx.MiTBlock(64, 2, 4), v)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


@pytest.fixture(scope="module")
def cmx_b0():
    rgb, dte = frames(48)
    model = jax_build_model("CMNeXt", "CMX-B0", num_classes=CLASSES)
    v = legacy_variables(model, 49, jnp.asarray(rgb), jnp.asarray(dte))
    return dict(v=v, rgb=rgb, dte=dte, want=_jitted_logits(model, v, rgb, dte, R5_ENV))


@pytest.mark.parametrize("dispatch", ["r5", "xla"])
def test_cmx_b0_matches_jax(cmx_b0, dispatch):
    got = _port_logits(cmx_b0["v"], cmx_b0["rgb"], cmx_b0["dte"], "CMX-B0", dispatch)
    assert got.shape == cmx_b0["want"].shape and np.abs(cmx_b0["want"]).max() > 0.5
    np.testing.assert_allclose(got, cmx_b0["want"], atol=ATOL, rtol=RTOL)


def test_cmx_weights_round_trip_leaf_for_leaf(cmx_b0):
    v = cmx_b0["v"]
    back = to_flax(from_flax(v))
    flat = lambda t: {tuple(p.key for p in path): leaf  # noqa: E731
                      for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    for coll in ("params", "batch_stats"):
        want, got = flat(v[coll]), flat(back[coll])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    assert ("backbone", "ffm_3", "out_bn", "mean") in flat(v["batch_stats"])
    port = CMNeXtLegacy("CMX-B0", CLASSES)
    port.load_state_dict(from_flax(v))
    assert set(from_flax(to_flax(port.state_dict()))) == set(port.state_dict())


def test_cmx_b5_parameter_shapes_match_jax():
    with torch.device("meta"):
        port = CMNeXtLegacy("CMX-B5", 40)
    want, got = shapes_of(jax_build_model("CMNeXt", "CMX-B5", num_classes=40), port)
    assert got == want
    assert sum(1 for k in got if k.startswith("backbone.extra_block3_") and k.endswith(
        "attn.q.weight")) == 40

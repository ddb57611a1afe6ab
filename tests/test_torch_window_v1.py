"""K20, the v1 window attention from separate q, k and v, against the JAX
package's ``pallas_window_attention`` (run in interpret mode) and its twin,
on the CPU, the cases of tests/test_pallas_swin.py:32-71 at 32 channels a
head.

The kernel upcasts q and k to f32 and scales q by the f32 scale with no
rounding; its twin (``window_attention`` under a dense -1e9 mask) rounds
``q * bf16(scale)`` to bf16.  So in bf16 the two are not one function: the
port's plain version follows the kernel bit for bit, and the twin's form
misses it by over ``TWIN_SHARE`` of the outputs.  In f32 all three agree to
f32 rounding.  The backward is the twin's vjp on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops import pallas_swin
from ir_ads_tpu_torch.ops import window_attention_v1 as k20

TWIN_SHARE = 0.2  # measured: 0.32 shifted, 0.35 unshifted
WS, HEADS, D, HP, WP, IMAGES = 4, 2, 32, 8, 8, 2  # 8 windows of 16 tokens


def _inputs(seed):
    rng = np.random.RandomState(seed)
    n, nw = WS * WS, (HP // WS) * (WP // WS)
    q, k, v = (rng.randn(IMAGES * nw, HEADS, n, D).astype(np.float32) for _ in range(3))
    return q, k, v, rng.randn(HEADS, n, n).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shifted", [False, True])
def test_v1_plain_version_matches_pallas_v1_and_its_twin(shifted, dtype):
    q, k, v, bias = _inputs(60 + shifted)
    region = pallas_swin.shift_region_ids(HP, WP, WS, WS // 2) if shifted else None
    scale = D ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(pallas_swin.pallas_window_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias),
        None if region is None else jnp.asarray(region), scale, interpret=True), np.float32)
    args = (*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(bias),
            None if region is None else torch.from_numpy(region), scale)
    got = k20.window_attention_v1(*args)
    twin = k20.window_attention_v1_twin(*args).float().numpy()
    assert got.dtype == tdt and got.shape == q.shape
    got = got.float().numpy()
    if dtype == "float32":
        for other in (want, twin):
            np.testing.assert_allclose(got, other, atol=1e-5, rtol=1e-5)
    else:
        share = float((twin != want).mean())
        print(f"shifted {shifted}: the twin's form differs in {share:.4f} of the outputs")
        np.testing.assert_array_equal(got, want)
        assert share > TWIN_SHARE
    assert k20.KERNEL.launches == 0


@pytest.mark.parametrize("shifted", [False, True])
def test_v1_gradient_matches_jax_vjp(monkeypatch, shifted):
    orig = pallas_swin.pallas_window_attention
    monkeypatch.setattr(pallas_swin, "pallas_window_attention",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    q, k, v, bias = _inputs(62 + shifted)
    n = WS * WS
    region = (pallas_swin.shift_region_ids(HP, WP, WS, WS // 2) if shifted
              else np.zeros((1, n), np.int32))
    scale = D ** -0.5
    g = np.random.RandomState(64).randn(*q.shape).astype(np.float32)
    out, vjp = jax.vjp(
        lambda a, b, c, e: pallas_swin.fused_window_attention(a, b, c, e, jnp.asarray(region),
                                                              scale),
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    got = k20.fused_window_attention(*leaves, torch.from_numpy(region), scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)

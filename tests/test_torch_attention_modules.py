"""The port's attention modules (models/modules/attention_modules.py)
against the JAX package's, on the CPU in f32, weights carried by
utils/jax_params.library_from_flax: MSPoolAttention, MSPABlock in eval and
train mode (its BatchNorms' batch statistics and running updates; its
``c_net`` is the one rank-3 kernel of the library), PSA and
BidirectionalCrossAttention; ``_avg_pool_same`` divides by the real pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models.modules import attention_modules as jam
from ir_ads_tpu_torch.models.modules import attention_modules as tam
from tests.test_torch_heads import check_stats, close, port_of, random_variables, run_jax


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k", [3, 7, 11])
def test_avg_pool_same_counts_real_pixels(k):
    x = _x(0, 2, 9, 7, 4)
    got = tam._avg_pool_same(torch.from_numpy(x), k)
    close(got, jam._avg_pool_same(jnp.asarray(x), k), atol=1e-6, rtol=1e-6)
    # a corner averages its real neighbours only
    r = k // 2
    close(got[:, 0, 0], x[:, :r + 1, :r + 1].mean((1, 2)), atol=1e-6, rtol=1e-6)


def test_ms_pool_attention_matches_jax():
    x = _x(1, 2, 9, 10, 8)
    jmod = jam.MSPoolAttention(8)
    v = random_variables(jmod, 2, jnp.asarray(x))
    port = port_of(tam.MSPoolAttention(8), v)
    close(port(torch.from_numpy(x)), run_jax(jmod, v, jnp.asarray(x))[0])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mspa_block_matches_jax(train):
    x = _x(3, 2, 8, 9, 8)
    jmod = jam.MSPABlock(8, mlp_ratio=2.0)
    v = random_variables(jmod, 4, jnp.asarray(x))
    v["params"]["layer_scale_1"] = np.full(8, 0.5, np.float32)  # branches of weight
    v["params"]["layer_scale_2"] = np.full(8, 0.7, np.float32)
    want, updated = run_jax(jmod, v, jnp.asarray(x), train=train)
    port = port_of(tam.MSPABlock(8, mlp_ratio=2.0), v)
    assert tuple(port.c_net.weight.shape) == (1, 1, 3)
    close(port.train(train)(torch.from_numpy(x)), want)
    check_stats(port, updated)


def test_psa_matches_jax():
    x = _x(5, 2, 7, 6, 16)
    jmod = jam.PSA(16)
    v = random_variables(jmod, 6, jnp.asarray(x))
    port = port_of(tam.PSA(16), v)
    close(port(torch.from_numpy(x)), run_jax(jmod, v, jnp.asarray(x))[0])


def test_bidirectional_cross_attention_matches_jax():
    x, ctx = _x(7, 2, 12, 16), _x(8, 2, 9, 24)
    jmod = jam.BidirectionalCrossAttention(16, heads=2, dim_head=8)
    v = random_variables(jmod, 9, jnp.asarray(x), jnp.asarray(ctx))
    port = port_of(tam.BidirectionalCrossAttention(16, 24, heads=2, dim_head=8), v)
    want = run_jax(jmod, v, jnp.asarray(x), jnp.asarray(ctx))[0]
    got = port(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got[0], want[0])
    close(got[1], want[1])

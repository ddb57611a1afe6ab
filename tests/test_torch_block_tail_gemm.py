"""K2's launch sequence (csrc/block_tail.cu) in plain torch, on the CPU: the
order of its sums, and its bars against the JAX package's ``_tail_kernel``,
interpreted, and the port's plain version.

K2 runs five launches: the adapter's two GEMMs on x (the second, with b2
folded in, writes the f32 init of the W2 GEMM), LN2 of x, the W1 GEMM with
the tanh GELU as its epilogue, and one W2 GEMM over the whole hidden from
that init, out = bf16(x + acc) (csrc/gemm_mma.cuh, each product one f32
accumulator per output taking the 16-deep steps of k in ascending order
from its init, the steps past K rounded up to 16 not taken), modelled by
tests/test_torch_swin_block_gemm.py's ``gemm``: one step is the exact sum
of 16 products of bf16 values rounded to f32 (stand-in for the tensor
cores' own sum), added to the accumulator.

The earlier fused launch (its tail steps later K13's, until it too moved to
these launches) made the adapter's output into an f32 tile, then walked the hidden 64 columns at a
time, adding each chunk's W2 products to that tile 16 deep at a time.
First, the sequence gives that order's bits, at C = 128, where the
adapter's width Ca = C / 16 = 8 is below one 16-deep step (the zero-filled
ragged step), on a row count no 64- or 128-row tile divides.  Second, the
sequence meets K2's bars (chip_smoke.py's ``check_block_tail``: atol 3e-2,
rtol 2e-2, the branch out - x within 1e-2) against the interpreted kernel
and the plain version, with weights carried from a flax tree by
``from_flax``, and the adapter dropped fails them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_mlp import fused_block_tail_pallas
from ir_ads_tpu_torch.ops.block_tail import block_tail_reference
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_swin_block_gemm import gemm

BF16 = torch.bfloat16
CHUNK = 64  # the fused form's hidden columns a step


def adapter_init(x, aw1, ab1, aw2, ab2, b2, adapter_scale):
    """adapter_scale * (relu(x Wa1^T + ab1) Wa2^T + ab2) + b2 in f32, the
    hidden rounded to bf16: both forms' (the fused tail's adapter step,
    the adapter GEMMs' epilogues)."""
    hid = torch.relu(gemm(x, aw1) + ab1.float()).to(BF16)
    return adapter_scale * (gemm(hid, aw2) + ab2.float()) + b2.float()


def ln2(x, g, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps).to(BF16)


def fused_order(x, params, eps=1e-5, adapter_scale=0.5):
    """The fused launch: the adapter into the f32 tile, then the FFN 64
    hidden columns at a time, each chunk's W2 products added 16 deep."""
    g, b, w1, b1, w2, b2, aw1, ab1, aw2, ab2 = params
    acc = adapter_init(x, aw1, ab1, aw2, ab2, b2, adapter_scale)
    xn = ln2(x, g, b, eps)
    for j0 in range(0, w1.shape[0], CHUNK):
        hid = F.gelu(gemm(xn, w1[j0:j0 + CHUNK]) + b1[j0:j0 + CHUNK].float(),
                     approximate="tanh").to(BF16)
        for kk in range(0, CHUNK, 16):
            acc = acc + (hid[:, kk:kk + 16].double()
                         @ w2[:, j0 + kk:j0 + kk + 16].double().t()).float()
    return (x.float() + acc).to(BF16)


def sequence(x, params, eps=1e-5, adapter_scale=0.5):
    """K2's five launches; the arguments and result of
    ``block_tail_reference`` (bf16)."""
    g, b, w1, b1, w2, b2, aw1, ab1, aw2, ab2 = params
    init = adapter_init(x, aw1, ab1, aw2, ab2, b2, adapter_scale)
    hid = F.gelu(gemm(ln2(x, g, b, eps), w1) + b1.float(), approximate="tanh").to(BF16)
    return (x.float() + gemm(hid, w2, init)).to(BF16)


def _case(seed, rows, c):
    """bf16 inputs from one numpy seed: x, the port's parameters carried
    from a flax tree (Dense kernels (in, out)) by ``from_flax``, and the JAX
    kernel's."""
    rng = np.random.RandomState(seed)
    hidden, ca = 4 * c, c // 16
    r = lambda *s, std=1.0, mean=0.0: (  # noqa: E731
        rng.randn(*s) * std + mean).astype(np.float32)
    dense = lambda fan_in, fan_out: {  # noqa: E731
        "kernel": r(fan_in, fan_out, std=fan_in ** -0.5), "bias": r(fan_out, std=0.02)}
    tree = {"params": {"norm2": {"scale": r(c, std=0.05, mean=1.0), "bias": r(c, std=0.05)},
                       "ffn": {"Dense_0": dense(c, hidden), "Dense_1": dense(hidden, c)},
                       "adapter": {"fc1": dense(c, ca), "fc2": dense(ca, c)}}}
    sd = from_flax(tree)
    names = ("norm2.weight", "norm2.bias", "ffn.layers.0.0.weight", "ffn.layers.0.0.bias",
             "ffn.layers.1.weight", "ffn.layers.1.bias", "adapter.fc1.weight",
             "adapter.fc1.bias", "adapter.fc2.weight", "adapter.fc2.bias")
    params = [sd[n].to(BF16) for n in names]
    x = torch.from_numpy(r(rows, c)).to(BF16)
    jt = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    jparams = [jt(t.t() if t.ndim == 2 else t) for t in params]  # back to (in, out)
    return x, params, jt(x), jparams


def _bars(got, want, x):
    """chip_smoke.py's hold for K2: element by element, and on the branch."""
    g, wt = got.float(), want.float()
    elem = bool(((g - wt).abs() <= 3e-2 + 2e-2 * wt.abs()).all())
    rel = float((g - wt).norm() / (wt - x.float()).norm())
    return elem and rel <= 1e-2, rel


# (rows, C): C = 128 has Ca = 8, under one 16-deep step; 300 and 200 rows
# are multiples of no 64- or 128-row tile
CASES = [(300, 128), (200, 64)]


@pytest.mark.parametrize("rows,c", CASES)
def test_five_launches_give_the_fused_order(rows, c):
    x, params, _, _ = _case(7 + c, rows, c)
    fused = fused_order(x, params)
    assert torch.equal(sequence(x, params), fused)
    # the W2 GEMM's init is one order with the fused tile, not a close one:
    # starting W2's sum from zero and adding the adapter's output after
    # moves bits of the f32 sum
    g, b, w1, b1, w2, b2, aw1, ab1, aw2, ab2 = params
    hid = F.gelu(gemm(ln2(x, g, b, 1e-5), w1) + b1.float(), approximate="tanh").to(BF16)
    init = adapter_init(x, aw1, ab1, aw2, ab2, b2, 0.5)
    assert not torch.equal(gemm(hid, w2) + init, gemm(hid, w2, init))


@pytest.mark.parametrize("rows,c", CASES)
def test_sequence_meets_the_card_bars(rows, c):
    x, params, jx, jparams = _case(11 + c, rows, c)
    got = sequence(x, params)
    plain = block_tail_reference(x, *params)
    kernel = torch.from_numpy(np.array(fused_block_tail_pallas(jx, *jparams, interpret=True),
                                       np.float32))
    assert got.shape == x.shape and got.dtype == BF16
    for want in (kernel, plain):
        ok, rel = _bars(got, want, x)
        assert ok, rel
    # the bars see the adapter: the sequence without it fails them
    assert not _bars(sequence(x, params, adapter_scale=0.0), plain, x)[0]

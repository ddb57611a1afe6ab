"""K18's plain version in the kernel's order, ``rpe_bias_jmajor_ordered``,
on the CPU:

  * in bf16 against the JAX package's ``dscf_rpe_bias_pallas``
    (``_rpe_kernel``, interpreted) on the shapes of K18's cases in
    tests/test_torch_dscf_variants.py, and once with a third of the
    position coordinates at -1, as the served model clamps 22-33 % of them:
    one bf16 ulp or 1e-5, and at most ``JMAJOR_SHARE`` of the outputs
    differing (chip_smoke.py's bar); K3's form (bf16 hat weights, table and
    u) must fail it;
  * in f32 against the einsum plain version at 1e-5;
  * the CUDA kernel's two-tap arithmetic (csrc/dscf_rpe.cu
    ``rpe_jmajor_kernel``, written out below in torch) bit for bit against
    it in f32, before the rounding, on random, clamped and out-of-range
    positions and a table with signed zeros: the outer taps weigh exactly
    0, and a tap off the table or of weight 0 adds a signed zero that leaves
    the sum as skipping it does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops.pallas_dscf_rpe import dscf_rpe_bias_pallas
from ir_ads_tpu_torch.ops.dscf_rpe import hat_slopes, rpe_bias_bf16
from ir_ads_tpu_torch.ops.dscf_rpe_jmajor import (
    rpe_bias_jmajor_ordered, rpe_bias_jmajor_reference,
)

JMAJOR_SHARE = 0.01  # chip_smoke.py's bar for K18
F32 = torch.float32
SHAPES = [(24, 32, 1, 2), (12, 16, 2, 2)]  # (h, w, G, hg), test_torch_dscf_variants.py


def _inputs(seed, g, hg, m=8, s1=23, s2=31, std=0.5, clamped=0.0, spread=1.0):
    """pos (2 G, m, 2) uniform in [-spread, spread], each coordinate -1 with
    probability ``clamped``; table (G, hg, s1, s2) ~ N(0, std^2)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, (2 * g, m, 2)).astype(np.float32)
    pos[rng.rand(*pos.shape) < clamped] = -1.0
    return pos, (std * rng.randn(g, hg, s1, s2)).astype(np.float32)


@pytest.mark.parametrize("h,w,g,hg,clamped", [(*s, 0.0) for s in SHAPES] + [(24, 32, 1, 2, 1 / 3)])
def test_ordered_matches_rpe_kernel_in_bf16(h, w, g, hg, clamped):
    pos, table = _inputs(91, g, hg, clamped=clamped)
    want = np.asarray(jnp.asarray(dscf_rpe_bias_pallas(
        jnp.asarray(pos), jnp.asarray(table), h, w, out_dtype=jnp.bfloat16, j_chunk=4,
        interpret=True), jnp.float32))
    tp, tt = torch.from_numpy(pos), torch.from_numpy(table)
    got = rpe_bias_jmajor_ordered(tp, tt, h, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2 * g, hg, 8, h, w)
    got = got.float().numpy()
    k3 = rpe_bias_bf16(tp, tt, h, w, "bemhw").to(torch.bfloat16).float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    share, share_k3 = float((got != want).mean()), float((k3 != want).mean())
    print(f"{share:.5f} of outputs differ; in K3's form {share_k3:.5f}")
    assert (np.abs(got - want) <= np.maximum(spacing, 1e-5)).all()
    assert share <= JMAJOR_SHARE < share_k3


@pytest.mark.parametrize("h,w,g,hg", SHAPES)
def test_ordered_matches_einsum_plain_version_in_f32(h, w, g, hg):
    pos, table = (torch.from_numpy(a) for a in _inputs(92, g, hg, std=1.0))
    got = rpe_bias_jmajor_ordered(pos, table, h, w, F32, chunk_elems=1000)
    want = rpe_bias_jmajor_reference(pos, table, h, w, F32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _two_taps(pos, table, h, w):
    """The CUDA kernel's arithmetic in f32: the two middle taps of each axis,
    a tap off the table weighted 0 at a clamped index, each sum from +0."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    ay, ax = hat_slopes(s1, s2, h, w)
    by = ((0.5 - 0.5 * pos[..., 0]) * 0.5) * float(s1 - 1)
    bx = ((0.5 - 0.5 * pos[..., 1]) * 0.5) * float(s2 - 1)
    yv = torch.arange(h, dtype=F32) * ay + by[..., None]  # (BG, M, h)
    xv = torch.arange(w, dtype=F32) * ax + bx[..., None]  # (BG, M, w)

    def middle(v, size):
        t1 = torch.floor(v)
        out = []
        for t in (t1, t1 + 1.0):
            hat = torch.clamp(1.0 - (v - t).abs(), min=0.0)
            on = (t >= 0) & (t < size)
            out.append((t.long().clamp(0, size - 1), torch.where(on, hat, torch.zeros_like(hat))))
        return out

    (y1, wy1), (y2, wy2) = middle(yv, s1)
    (x1, wx1), (x2, wx2) = middle(xv, s2)
    tb = table[torch.arange(bg) % g].reshape(bg, hg, s1 * s2)

    def tab(ys, xs):
        idx = (ys[..., :, None] * s2 + xs[..., None, :]).reshape(bg, 1, -1)
        return torch.gather(tb, 2, idx.expand(bg, hg, -1)).reshape(bg, hg, m, h, w)

    zero = torch.zeros((), dtype=F32)
    col = lambda t: t[:, None, :, None, :]  # noqa: E731
    row = lambda t: t[:, None, :, :, None]  # noqa: E731

    def u(ys):
        return (zero + col(wx1) * tab(ys, x1)) + col(wx2) * tab(ys, x2)

    return (zero + row(wy1) * u(y1)) + row(wy2) * u(y2)


@pytest.mark.parametrize("clamped,spread", [(0.0, 1.0), (1 / 3, 1.0), (0.2, 1.5)])
@pytest.mark.parametrize("h,w,g,hg", SHAPES + [(15, 20, 2, 2)])
def test_two_taps_are_the_ordered_sequence_bit_for_bit(h, w, g, hg, clamped, spread):
    pos, table = _inputs(93, g, hg, m=16, s1=2 * h - 1, s2=2 * w - 1, std=1.0,
                         clamped=clamped, spread=spread)
    rng = np.random.RandomState(94)
    table[rng.rand(*table.shape) < 0.1] = -0.0
    table[rng.rand(*table.shape) < 0.05] = 0.0
    pos, table = torch.from_numpy(pos), torch.from_numpy(table)
    want = rpe_bias_jmajor_ordered(pos, table, h, w, F32)
    got = _two_taps(pos, table, h, w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want.view(torch.int32) == torch.tensor(-0.0).view(torch.int32)).sum() == 0

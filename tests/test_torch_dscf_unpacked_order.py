"""The order in which K4's unpacked form and K16 sum on the tensor cores,
against the JAX package's two unpacked kernels, on the CPU in bf16.

``_dscf_rows_kernel`` and ``_dscf_fused_kernel`` (ir_ads_tpu/ops/
pallas_dscf.py) round the unnormalised ``exp(s - max)`` to bf16, sum P.V
in f32 and divide by ``den = jnp.sum(exp(s - max))`` after it.  On the card
both run csrc/dscf.cuh's ``dscf_attend_mma``: four warps share a tile of 16
query pixels and split the keys, padded with -inf to 4 x 8 NT (NT the
first of 4, 8, ..., 32 n-tiles a warp that covers M); every score is held
until the final max; a warp's lane t sums the unrounded weights of keys 8n
+ 2t and 8n + 2t + 1 in n order, the four lanes meet by shuffles (xor 1,
then xor 2), the warps' dens are summed in warp order; each warp's P.V over
its keys is summed in warp order and divided by den.  ``mma_order`` below
is that order in plain torch (the tensor cores' own order inside a product
is not known: torch's f32 product stands for it).

It must part from the interpreted Pallas kernels on at most
``ROUNDING_SHARE`` of the bf16 outputs (chip_smoke.py's bar for the kernels
against their plain versions), and the packed form (normalise, round, then
P.V) on more: the share bar can tell the two forms apart.  Shapes: level 3's
15x20 plane and level 2's 30x40 at 600 keys, and an 8x16 plane at 50 keys
(one n-tile set of 4 a warp, most keys padding); the fused kernel has no row
band at 15x20 (the reference raises there), so it takes the other two.  The
bias is K3's plain version's (bit-equal to the interpreted rows rpe kernel,
tests/test_torch_kernels.py) from a table of std 3, as the fused kernel
builds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_dscf import pallas_dscf_attention_fused, pallas_dscf_attention_rows
from ir_ads_tpu_torch.ops.dscf_rows import attend_reference
from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_rows_reference
from ir_ads_tpu_torch.ops.layers import q_scale

ROUNDING_SHARE = 0.01  # chip_smoke.py's bar
WARPS = 4
BF16 = torch.bfloat16


def n_tiles(m: int) -> int:
    """8-key n-tiles a warp: the kernels' first instantiated count that
    covers ceil(M / 32)."""
    return next(nt for nt in range(4, 33, 4) if 32 * nt >= m)


def mma_order(qh, kh, vh, bh, scale):
    """``dscf_attend_mma``'s unpacked form on (BG, hg, N, 8) heads, (BG,
    hg, M, 8) keys and values and the bias (BG, hg, N, M)."""
    m = kh.shape[-2]
    nt = n_tiles(m)
    keys = WARPS * 8 * nt
    qs = (qh.float() * q_scale(scale, qh.dtype)).to(qh.dtype).float()
    s = F.pad(qs @ kh.float().transpose(-1, -2) + bh.float(), (0, keys - m),
              value=float("-inf"))
    v = F.pad(vh.float(), (0, 0, 0, keys - m))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    # key w * 8 nt + 8 n + 2 t + i: warp w, n-tile n, lane t, pair half i
    pair = e.reshape(*e.shape[:-1], WARPS, nt, 4, 2)
    pair = pair[..., 0] + pair[..., 1]
    lane = torch.zeros_like(pair[..., 0, :])
    for n in range(nt):
        lane = lane + pair[..., n, :]
    lane = lane + lane[..., [1, 0, 3, 2]]
    lane = lane + lane[..., [2, 3, 0, 1]]
    den = torch.zeros_like(lane[..., 0, 0])
    out = torch.zeros(*e.shape[:-1], vh.shape[-1])
    a = e.to(qh.dtype).float()
    for w in range(WARPS):
        den = den + lane[..., w, 0]
        keys_w = slice(w * 8 * nt, (w + 1) * 8 * nt)
        out = out + a[..., keys_w] @ v[..., keys_w, :]
    return (out / den[..., None]).to(qh.dtype)


def _heads(t, hg):
    bg, n, gc = t.shape
    return t.reshape(bg, n, hg, gc // hg).transpose(1, 2)


@pytest.mark.parametrize("kernel,bg,h,w,m", [
    ("rows", 2, 15, 20, 600), ("rows", 1, 30, 40, 600), ("rows", 2, 8, 16, 50),
    ("fused", 1, 30, 40, 600), ("fused", 2, 8, 16, 50),
])
def test_unpacked_mma_order_rounds_as_the_pallas_kernel(kernel, bg, h, w, m):
    rng = np.random.RandomState(110 + h + m)
    hg, gc, scale = 2, 16, 8 ** -0.5
    q, k, v = (torch.from_numpy(rng.randn(bg, n, gc).astype(np.float32)).to(BF16)
               for n in (h * w, m, m))
    pos = torch.from_numpy(rng.uniform(-1.0, 1.0, (bg, m, 2)).astype(np.float32))
    table = torch.from_numpy((3.0 * rng.randn(1, hg, 2 * h - 1, 2 * w - 1)).astype(np.float32))
    bias = rpe_bias_rows_reference(pos, table, h, w, BF16)  # (BG, hg, h, M, w)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    if kernel == "rows":
        want = pallas_dscf_attention_rows(jq, jk, jv, jnp.asarray(bias.float().numpy(),
                                                                  jnp.bfloat16),
                                          scale, hg, interpret=True, packed=False)
    else:
        want = pallas_dscf_attention_fused(jq, jk, jv, jnp.asarray(pos.numpy()),
                                           jnp.asarray(table.numpy()), h, w, scale, hg,
                                           store_dtype=jnp.bfloat16, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    bh = bias.float().permute(0, 1, 2, 4, 3).reshape(bg, hg, h * w, m)
    args = (_heads(q, hg), _heads(k, hg), _heads(v, hg), bh, scale)

    def share(out):
        got = out.transpose(1, 2).reshape(bg, h * w, gc).float().numpy()
        return float((got != want).mean())

    mine, packed = share(mma_order(*args)), share(attend_reference(*args, packed=True))
    print(f"{kernel} {h}x{w} M={m}: the tensor cores' order parts {mine:.4f} of the "
          f"outputs from the Pallas kernel, the packed form {packed:.4f}")
    assert mine <= ROUNDING_SHARE
    assert packed > ROUNDING_SHARE

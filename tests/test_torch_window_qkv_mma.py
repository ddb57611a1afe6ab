"""K12's tensor-core design on the CPU: its q operand and the order of its
sums (csrc/window_mma.cuh in its rounded form, which K12 and K15 run).

  * Every finite bf16 q times the bf16 scales of d = 32 and d = 16: the
    kernel's operand, f32(q) * f32(bf16(scale)) rounded once to bf16
    (``__fmul_rn``, then the round; the wrapper passes ``q_scale``), is the
    plain version's ``q * q_scale(scale, bf16)``, bit for bit, subnormal
    results included (the card keeps them); and JAX's ``(q *
    scale).astype(bf16)`` wherever the f32 product is normal (XLA on the
    CPU flushes subnormal f32 values to zero).  One bf16 operand carries it; K20's
    three-part split is not needed.
  * A plain version in the kernel's order against the interpreted
    ``pallas_window_attention_qkv``, bf16: scores by 16-deep steps of d
    into one f32 sum (torch's f32 product of a step stands for the tensor
    cores' sum of its 16 products, as in tests/test_torch_window_v1_mma.py);
    the bias and -1e9 where the region ids differ; each row's sum of exp(s
    - max) per lane t over keys 8n + 2t and 8n + 2t + 1 in n order, then
    across the quad (xor 1, then xor 2); p = bf16(e * RN(1 / sum)); P.V by
    16-key steps.  It parts from the kernel on at most ``ROUNDING_SHARE``
    of the outputs, the unnormalised form (bf16(e) . V, then divided by the
    sum: K4's unpacked form) on more.  On
    N = 16 windows at d = 16 and N = 144 windows at d = 32, shifted and
    not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops import pallas_swin
from ir_ads_tpu_torch.ops import window_attention_qkv as k12
from ir_ads_tpu_torch.ops.layers import q_scale

ROUNDING_SHARE = 0.01  # chip_smoke.py's bar
F32, BF16 = torch.float32, torch.bfloat16
N_TILES = (2, 4, 8, 12, 18)  # the kernel's instantiated 8-key n-tile counts


@pytest.mark.parametrize("d", [32, 16])
def test_the_rounded_operand_is_the_plain_versions_q_s(d):
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    q = bits.view(BF16)
    q = q[torch.isfinite(q.float())]
    assert q.numel() == 65536 - 2 * 128  # all but the infinities and NaNs
    s = q_scale(d ** -0.5, BF16)
    assert s == float(torch.tensor(d ** -0.5).to(BF16))
    product = q.float() * torch.tensor(s, dtype=F32)
    kernel = product.to(BF16)
    plain = q * q_scale(d ** -0.5, q.dtype)  # ops.window_attention's q_s
    jax_qs = torch.from_numpy(np.asarray(
        (jnp.asarray(q.float().numpy(), jnp.bfloat16) * d ** -0.5).astype(jnp.bfloat16),
        np.float32)).to(BF16)
    assert torch.equal(kernel.view(torch.int16), plain.view(torch.int16))
    normal = product.abs() >= torch.finfo(F32).tiny
    assert torch.equal(kernel[normal].view(torch.int16), jax_qs[normal].view(torch.int16))


def qkv_mma_order(qkv, bias, region, scale, heads):
    """K12's function, (B nW, N, 3C) -> (B nW, N, C), in the kernel's order."""
    bn, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    keys = 8 * next(nt for nt in N_TILES if 8 * nt >= n)
    split = lambda t: t.reshape(bn, n, heads, d).transpose(1, 2).float()  # noqa: E731
    q, k, v = (split(qkv[..., i * c:(i + 1) * c]) for i in range(3))
    qs = (q * q_scale(scale, BF16)).to(BF16).float()
    s = torch.zeros(bn, heads, n, n)
    for k0 in range(0, d, 16):
        s = s + qs[..., k0:k0 + 16] @ k[..., k0:k0 + 16].transpose(-1, -2)
    s = s + bias.float()[None]
    if region is not None:
        nw = region.shape[0]
        neq = (region[:, :, None] != region[:, None, :])[None, :, None]
        s = s.reshape(bn // nw, nw, heads, n, n)
        s = torch.where(neq, s - 1e9, s).reshape(bn, heads, n, n)
    s = F.pad(s, (0, keys - n), value=float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pair = e.reshape(*e.shape[:-1], keys // 8, 4, 2)  # key 8 n + 2 t + i
    pair = pair[..., 0] + pair[..., 1]
    lane = torch.zeros_like(pair[..., 0, :])
    for nt in range(keys // 8):
        lane = lane + pair[..., nt, :]
    lane = lane + lane[..., [1, 0, 3, 2]]
    lane = lane + lane[..., [2, 3, 0, 1]]
    p = (e * (1.0 / lane[..., :1])).to(BF16).float()
    v = F.pad(v, (0, 0, 0, keys - n))
    o = torch.zeros(bn, heads, n, d)
    for kk in range(0, keys, 16):
        o = o + p[..., kk:kk + 16] @ v[..., kk:kk + 16, :]
    return o.to(BF16).transpose(1, 2).reshape(bn, n, c)


def unnormalised_form(qkv, bias, region, scale, heads):
    """The same scores, but bf16(exp(s - max)) . V divided by the sum after
    the product (the rounding of K4's unpacked form)."""
    bn, n, c3 = qkv.shape
    c = c3 // 3
    split = lambda t: t.reshape(bn, n, heads, c // heads).transpose(1, 2).float()  # noqa: E731
    q, k, v = (split(qkv[..., i * c:(i + 1) * c]) for i in range(3))
    s = (q * q_scale(scale, BF16)).to(BF16).float() @ k.transpose(-1, -2) + bias.float()[None]
    if region is not None:
        nw = region.shape[0]
        neq = (region[:, :, None] != region[:, None, :])[None, :, None]
        s = s.reshape(bn // nw, nw, heads, n, n)
        s = torch.where(neq, s - 1e9, s).reshape(bn, heads, n, n)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e.to(BF16).float() @ v) / e.sum(-1, keepdim=True)
    return o.to(BF16).transpose(1, 2).reshape(bn, n, c)


# (ws, heads, d, map height, map width, images): N = 16 windows at d = 16
# on an 8 x 12 map; N = 144 windows at d = 32 on a 24 x 24 map
CASES = [(4, 2, 16, 8, 12, 2), (12, 2, 32, 24, 24, 1)]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,heads,d,hp,wp,images", CASES)
def test_kernel_order_stays_within_the_share_of_pallas_v2(ws, heads, d, hp, wp, images,
                                                          shifted):
    n, nw, c = ws * ws, (hp // ws) * (wp // ws), heads * d
    rng = np.random.RandomState(90 + ws + shifted)
    qkv = rng.randn(images * nw, n, 3 * c).astype(np.float32)
    bias = rng.randn(heads, n, n).astype(np.float32)
    region = pallas_swin.shift_region_ids(hp, wp, ws, ws // 2) if shifted else None
    scale = d ** -0.5
    want = np.asarray(pallas_swin.pallas_window_attention_qkv(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
        None if region is None else jnp.asarray(region), scale, heads, interpret=True),
        np.float32)
    args = (torch.from_numpy(qkv).to(BF16), torch.from_numpy(bias),
            None if region is None else torch.from_numpy(region), scale, heads)
    assert k12.tensor_core_design(BF16, n, d)
    mine = float((qkv_mma_order(*args).float().numpy() != want).mean())
    other = float((unnormalised_form(*args).float().numpy() != want).mean())
    print(f"N = {n}, d = {d}, shifted {shifted}: the kernel's order parts on {mine:.5f} "
          f"of the outputs, the unnormalised form on {other:.5f}")
    assert mine <= ROUNDING_SHARE < other

"""K20's tensor-core design on the CPU: the split of q * scale and the order
of its sums (csrc/window_attention_v1.cu, window_attention_v1_mma_kernel).

  * Every finite bf16 q, zero and subnormals included, times Swin's scales
    (d = 32 and d = 16): the three bf16 parts hi = bf16(qs), mid = bf16(qs -
    hi), lo = bf16(qs - hi - mid) of qs = f32(q) * scale (one f32
    rounding), each difference exact in f32, sum back to qs exactly
    wherever |qs| >= 2^-110, and within 2^-133 below.
  * A plain version in the kernel's order (each 16-deep step of d: hi, mid,
    then lo times k^T into one f32 sum; torch's f32 product of a step stands
    for the tensor cores' sum of its 16 products, as in
    tests/test_torch_dscf_unpacked_order.py) against the interpreted
    ``pallas_window_attention``, bf16: at most ``ROUNDING_SHARE`` of the
    outputs apart, while the twin's form (``window_attention_v1_twin``, q *
    bf16(scale) rounded) parts on more.  On the N = 16 windows of
    tests/test_torch_window_v1.py, shifted and not, and on N = 144, d = 32
    windows of a 24 x 24 map, shifted and not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops import pallas_swin
from ir_ads_tpu_torch.ops import window_attention_v1 as k20

ROUNDING_SHARE = 0.01  # chip_smoke.py's bar
F32, BF16 = torch.float32, torch.bfloat16


def split3(qs):
    """The kernel's three bf16 parts of the f32 tensor qs, as f32, and the two
    f32 differences they are rounded from."""
    hi = qs.to(BF16).float()
    r1 = qs - hi
    mid = r1.to(BF16).float()
    r2 = r1 - mid
    return (hi, mid, r2.to(BF16).float()), (r1, r2)


@pytest.mark.parametrize("d", [32, 16])
def test_three_bf16_parts_carry_q_times_scale(d):
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    q = bits.view(BF16).float()
    q = q[torch.isfinite(q)]
    assert q.numel() == 65536 - 2 * 128  # all but the infinities and NaNs
    assert (q == 0).sum() == 2 and ((q != 0) & (q.abs() < 2.0 ** -126)).sum() == 254
    qs = q * torch.tensor(d ** -0.5, dtype=F32)
    (hi, mid, lo), (r1, r2) = split3(qs)
    exact = lambda a, b, c: (a.double() - b.double() == c.double()).all()  # noqa: E731
    assert exact(qs, hi, r1) and exact(r1, mid, r2)  # both differences exact in f32
    total = hi.double() + mid.double() + lo.double()  # exact in f64
    big = qs.abs() >= 2.0 ** -110
    assert torch.equal(total[big], qs.double()[big])
    assert ((total - qs.double()).abs()[~big] < 2.0 ** -133).all()
    print(f"d = {d}: {int(big.sum())} values exact, {int((~big).sum())} under 2^-110, "
          f"{int((total != qs.double()).sum())} of them off")


def v1_mma_order(q, k, v, bias, region, scale):
    """K20's function with its scores in the kernel's order of sums."""
    bn, nh, n, d = q.shape
    parts, _ = split3(q.float() * scale)
    kf = k.float()
    s = torch.zeros(bn, nh, n, n)
    for k0 in range(0, d, 16):
        for part in parts:
            s = s + part[..., k0:k0 + 16] @ kf[..., k0:k0 + 16].transpose(-1, -2)
    s = s + bias.float()[None]
    if region is not None:
        nw = region.shape[0]
        neq = (region[:, :, None] != region[:, None, :])[None, :, None]
        s = s.reshape(bn // nw, nw, nh, n, n)
        s = torch.where(neq, s - 1e9, s).reshape(bn, nh, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.float()).to(v.dtype)


# (window, heads, d, map side, images): the N = 16 windows of
# tests/test_torch_window_v1.py, and N = 144, d = 32 windows of a 24 x 24 map
CASES = [(4, 2, 32, 8, 2), (12, 2, 32, 24, 1)]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,heads,d,side,images", CASES)
def test_kernel_order_stays_within_the_share_of_pallas_v1(ws, heads, d, side, images, shifted):
    n, nw = ws * ws, (side // ws) ** 2
    rng = np.random.RandomState(70 + ws + shifted)
    q, k, v = (rng.randn(images * nw, heads, n, d).astype(np.float32) for _ in range(3))
    bias = rng.randn(heads, n, n).astype(np.float32)
    region = pallas_swin.shift_region_ids(side, side, ws, ws // 2) if shifted else None
    scale = d ** -0.5
    want = np.asarray(pallas_swin.pallas_window_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(bias),
        None if region is None else jnp.asarray(region), scale, interpret=True), np.float32)
    args = (*(torch.from_numpy(a).to(BF16) for a in (q, k, v)), torch.from_numpy(bias),
            None if region is None else torch.from_numpy(region), scale)
    assert k20.tensor_core_design(BF16, n, d)
    mine = float((v1_mma_order(*args).float().numpy() != want).mean())
    twin = float((k20.window_attention_v1_twin(*args).float().numpy() != want).mean())
    print(f"N = {n}, shifted {shifted}: the kernel's order parts on {mine:.5f} of the "
          f"outputs, the twin's form on {twin:.5f}")
    assert mine <= ROUNDING_SHARE < twin

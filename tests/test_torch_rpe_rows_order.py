"""K3's and K6's CUDA kernels (csrc/dscf_rpe.cu ``rpe_plane_kernel`` in K3's
bf16 form, through csrc/dscf.cuh's rpe_* parts) written out in torch, in
their order of work, on the CPU:

  * the table staged in bf16 with a zero row and a zero column past its
    last; each key's y taps per query row (``rpe_row``, ``rpe_pair``) and
    x taps per column (``rpe_col``); u(s) = bf16(w1 T[s, x1] + w2 T[s, x1 +
    1]) computed once per (key, column, table row) and read by every query
    row whose taps reach row s; the two-tap sample ``(+0 + wy1 u(y1)) + wy2
    u(y1 + 1)``; the four-tap search where ``rpe_pair`` or ``rpe_col`` says
    the middle taps do not suffice (``rpe_search``);
  * bit for bit against ``rpe_bias_bf16`` (the plain version), in f32
    before the final rounding and in bf16 after, in both layouts ("behmw",
    K3's, and "bemhw", K6's), on random positions, on positions clamped to
    -1 and +1, and on a table with signed zeros, at small shapes with ay and
    ax below 1, at 1 and above 1, as the four DSCF levels have them;
  * the two-tap value bit for bit the four-tap search wherever the kernel
    takes it, and the search taken (and bit-equal) at positions constructed
    to give an outer tap of either axis a weight;
  * in bf16 bit for bit against the JAX package's interpreted
    ``dscf_rpe_bias_rows_pallas`` and ``dscf_rpe_bias_packed_pallas``, as
    tests/test_torch_kernels.py holds the wrappers, with coordinates
    clamped to -1 and +1 once each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_dscf_rpe import dscf_rpe_bias_packed_pallas, dscf_rpe_bias_rows_pallas
from ir_ads_tpu_torch.ops.dscf_rpe import hat_slopes, rpe_bias_bf16, searching_coordinates

F32, BF16 = torch.float32, torch.bfloat16
# (h, w, s1, s2): ay = (s1 - 1) / (2 (h - 1)) and ax likewise below 1, at 1
# and above 1 (levels 0-1, 1 and 2-3 of the model)
SHAPES = [(24, 32, 23, 31), (12, 16, 23, 31), (6, 8, 23, 31), (12, 8, 23, 15)]


def _bf16(x):
    return x.to(BF16).float()


def _hat(ai, s, b):
    """bf16(max(0, 1 - |(ai - s) + b|)) in that f32 order (``rpe_hat_bf16``)."""
    return _bf16(torch.clamp(1.0 - ((ai - s) + b).abs(), min=0.0))


def _parts(pos, table, h, w):
    """The kernel's per-key parts: rpe_key, rpe_row / rpe_pair, rpe_col."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    ay, ax = hat_slopes(s1, s2, h, w)
    by = ((0.5 - 0.5 * pos[..., 0]) * 0.5) * float(s1 - 1)  # (BG, M)
    bx = ((0.5 - 0.5 * pos[..., 1]) * 0.5) * float(s2 - 1)
    ar = (torch.arange(h, dtype=F32) * ay)[None, None]  # ay * r rounded
    byr = by[..., None]
    y0 = torch.floor(ar + byr) - 1.0  # (BG, M, h)
    wy = []
    for dy in range(4):
        s = y0 + dy
        wy.append(torch.where((s >= 0) & (s < s1), _hat(ar, s, byr), torch.zeros(())))
    y1 = y0 + 1.0
    pair_y = (wy[0] == 0) & (wy[3] == 0) & (y1 >= 0) & (y1 < s1)
    ac = (torch.arange(w, dtype=F32) * ax)[None, None]  # ax * c rounded
    bxc = bx[..., None]
    xf = torch.floor(ac + bxc)  # (BG, M, w): x1
    d0 = (ac - (xf - 1.0)) + bxc
    d3 = (ac - (xf + 2.0)) + bxc
    pair_x = (xf >= 0) & (xf < s2) & (d0.abs() >= 1) & (d3.abs() >= 1)
    w1, w2 = _hat(ac, xf, bxc), _hat(ac, xf + 1.0, bxc)
    return dict(y0=y0, wy=wy, pair_y=pair_y, ac=ac, bx=bxc, xf=xf, pair_x=pair_x, w1=w1, w2=w2)


def _gather_cols(t, cols):
    """t (BG, hg, S, C) at columns cols (BG, M, w): (BG, hg, M, S, w)."""
    bg, hg, s, _ = t.shape
    _, m, w = cols.shape
    idx = cols.long()[:, None, :, None, :].expand(bg, hg, m, s, w)
    return torch.gather(t[:, :, None].expand(bg, hg, m, s, t.shape[-1]), 4, idx)


def rpe_bias_rows_ordered(pos, table, h, w, order):
    """The kernel's sample in f32 before its final rounding, output axes in
    ``order`` over (b, e, m, h, w) = (BG, hg, M, h, w); and the mask of the
    outputs that took the four-tap search."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    p = _parts(pos.float(), table, h, w)
    tb = _bf16(table.float())[torch.arange(bg) % g]  # (BG, hg, S1, S2)
    tp = F.pad(tb, (0, 1, 0, 1))  # the zero row and column past the last
    # u(s) once per (key, column, table row s <= S1): (BG, hg, M, S1 + 1, w)
    xa = p["xf"].clamp(0, s2 - 1)
    col = lambda t: t[:, None, :, None, :]  # noqa: E731  (BG, M, w) -> (BG, 1, M, 1, w)
    u = _bf16(col(p["w1"]) * _gather_cols(tp, xa) + col(p["w2"]) * _gather_cols(tp, xa + 1))
    # the two-tap sample of every (key, row, column) from u of rows y1, y1 + 1
    y1 = (p["y0"] + 1.0).clamp(0, s1 - 1).long()  # (BG, M, h)
    rows = lambda r: r[:, None, :, :, None].expand(bg, hg, m, h, w)  # noqa: E731
    ua = torch.gather(u, 3, rows(y1))
    ub = torch.gather(u, 3, rows(y1 + 1))
    wy1, wy2 = (rows(p["wy"][i]) for i in (1, 2))
    two = wy2 * ub + ((wy1 * ua) + 0.0)  # products of bf16 values: exact in f32
    searched = ~(rows(p["pair_y"]) & col(p["pair_x"]).expand(bg, hg, m, h, w))
    out = torch.where(searched, rpe_search(p, tb, h, w), two)
    perm = {"behmw": (0, 1, 3, 2, 4), "bemhw": (0, 1, 2, 3, 4)}[order]
    return out.permute(*perm), searched.permute(*perm)


def rpe_search(p, tb, h, w):
    """``rpe_search`` of every output: the four taps of each axis, a tap off
    the table or of weight 0 skipped, u and the sum from +0 in tap order."""
    bg, hg, s1, s2 = tb.shape
    m = p["y0"].shape[1]
    x0 = p["xf"] - 1.0
    wx = []
    for dx in range(4):
        t = x0 + dx
        wx.append(torch.where((t >= 0) & (t < s2), _hat(p["ac"], t, p["bx"]), torch.zeros(())))
    flat = tb.reshape(bg, hg, s1 * s2)
    acc = torch.zeros(bg, hg, m, h, w)
    for dy in range(4):
        ys = (p["y0"] + dy).clamp(0, s1 - 1)  # (BG, M, h)
        u = torch.zeros(bg, hg, m, h, w)
        for dx in range(4):
            xs = (x0 + dx).clamp(0, s2 - 1)  # (BG, M, w)
            idx = (ys[..., :, None] * s2 + xs[..., None, :]).long().reshape(bg, 1, -1)
            tv = torch.gather(flat, 2, idx.expand(bg, hg, -1)).reshape(bg, hg, m, h, w)
            wdx = wx[dx][:, None, :, None, :]
            u = torch.where(wdx != 0, u + wdx * tv, u)
        wdy = p["wy"][dy][:, None, :, :, None]
        acc = torch.where(wdy != 0, acc + wdy * _bf16(u), acc)
    return acc


def _inputs(seed, bg, m, s1, s2, g=1, hg=2, clamped=0.0, zeros=False):
    """pos (bg, m, 2) uniform in [-1, 1], a share ``clamped`` of the
    coordinates at -1 and as many at +1; table (g, hg, s1, s2) ~ N(0, 1/4),
    with ``zeros`` a tenth of it -0 and a twentieth +0."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1.0, 1.0, (bg, m, 2)).astype(np.float32)
    at = rng.rand(*pos.shape)
    pos[at < clamped] = -1.0
    pos[(at >= clamped) & (at < 2 * clamped)] = 1.0
    table = (0.5 * rng.randn(g, hg, s1, s2)).astype(np.float32)
    if zeros:
        table[rng.rand(*table.shape) < 0.1] = -0.0
        table[rng.rand(*table.shape) < 0.05] = 0.0
    return torch.from_numpy(pos), torch.from_numpy(table)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == F32 else torch.int16)


@pytest.mark.parametrize("order", ["behmw", "bemhw"])
@pytest.mark.parametrize("clamped,zeros", [(0.0, False), (1 / 6, False), (1 / 6, True)])
@pytest.mark.parametrize("h,w,s1,s2", SHAPES)
def test_ordered_is_the_plain_version_bit_for_bit(h, w, s1, s2, clamped, zeros, order):
    pos, table = _inputs(41, 4, 24, s1, s2, g=2, clamped=clamped, zeros=zeros)
    got, _ = rpe_bias_rows_ordered(pos, table, h, w, order)
    want = rpe_bias_bf16(pos, table, h, w, order)
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))  # f32, before the final rounding
    assert torch.equal(_bits(got.to(BF16)), _bits(want.to(BF16)))


@pytest.mark.parametrize("h,w,s1,s2", SHAPES)
def test_two_taps_are_the_search_where_the_kernel_takes_them(h, w, s1, s2):
    pos, table = _inputs(42, 4, 64, s1, s2, clamped=1 / 6, zeros=True)
    got, searched = rpe_bias_rows_ordered(pos, table, h, w, "bemhw")
    p = _parts(pos, table, h, w)
    search = rpe_search(p, _bf16(table)[torch.zeros(4, dtype=torch.long)], h, w)
    assert searched.float().mean() < 0.01
    assert torch.equal(_bits(got[~searched]), _bits(search[~searched]))


@pytest.mark.parametrize("axis", [0, 1])
def test_the_search_is_taken(axis):
    """Positions whose y (axis 0) or x (axis 1) coordinate makes an outer
    tap's weight non-zero: the kernel searches the four taps there, and stays
    the plain version bit for bit, and the interpreted Pallas kernels."""
    h, w, s1, s2 = 12, 16, 23, 31
    ay, ax = hat_slopes(s1, s2, h, w)
    size, slope, n = (s1, ay, h) if axis == 0 else (s2, ax, w)
    hits = searching_coordinates(size, slope, n, 16)
    assert len(hits) >= 8
    pos, table = _inputs(46, 2, len(hits), s1, s2, zeros=True)
    pos[0, :, axis] = torch.from_numpy(hits)
    got, searched = rpe_bias_rows_ordered(pos, table, h, w, "bemhw")
    assert searched[0].any() and not searched[1].any()
    assert torch.equal(_bits(got), _bits(rpe_bias_bf16(pos, table, h, w, "bemhw")))
    want = np.asarray(dscf_rpe_bias_packed_pallas(
        jnp.asarray(pos.numpy()), jnp.asarray(table.numpy()), h, w, out_dtype=jnp.bfloat16,
        interpret=True), np.float32)
    np.testing.assert_array_equal(got.flatten(3).to(BF16).float().numpy(), want)


@pytest.mark.parametrize("clamped", [0.0, 1 / 6])
def test_ordered_matches_rows_kernel_in_bf16(clamped):
    h, w, s1, s2 = 12, 16, 23, 31
    pos, table = _inputs(44, 4, 8, s1, s2, g=2, clamped=clamped)
    want = np.asarray(dscf_rpe_bias_rows_pallas(
        jnp.asarray(pos.numpy()), jnp.asarray(table.numpy()), h, w, out_dtype=jnp.bfloat16,
        j_chunk=4, interpret=True), np.float32)
    got, _ = rpe_bias_rows_ordered(pos, table, h, w, "behmw")
    np.testing.assert_array_equal(got.to(BF16).float().numpy(), want)


@pytest.mark.parametrize("clamped", [0.0, 1 / 6])
def test_ordered_matches_packed_kernel_in_bf16(clamped):
    h, w, s1, s2 = 15, 20, 23, 31
    pos, table = _inputs(45, 4, 16, s1, s2, g=2, clamped=clamped)
    want = np.asarray(dscf_rpe_bias_packed_pallas(
        jnp.asarray(pos.numpy()), jnp.asarray(table.numpy()), h, w, out_dtype=jnp.bfloat16,
        interpret=True), np.float32)
    got, _ = rpe_bias_rows_ordered(pos, table, h, w, "bemhw")
    np.testing.assert_array_equal(got.flatten(3).to(BF16).float().numpy(), want)

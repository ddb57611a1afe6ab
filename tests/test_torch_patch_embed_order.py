"""K19's staging map and fragment layout (csrc/patch_embed.cu) written out
in numpy, on the CPU.

The kernel walks bands of 128 output pixels in flat (b, py, px) order.  It
copies each pixel's patch into 48 shared-memory slots (slot 12 r + q of
pixel i at 56 i + 12 r + q holds x[b, 4 py + r, 12 px + q], 8 bytes a copy)
and stages the (48, 128) weight transposed, column n at 56 n.  Each warp
reads its 16 pixels' A fragments and the weight's B fragments by ldmatrix,
multiplies with mma.sync m16n8k16, and writes the accumulator layout's rows
through its own (16, 136) shared tile as 16-byte pieces of whole pixel rows.
Here the same index arithmetic runs on element indices: the band's slots
must be ``ops.patch_embed.patchify_flat``'s patches (on ragged bands, a last
band shorter than the others, bands across output rows and images), the
fragments must be the PTX layout of those patches and of the weight, and
every output element must come from its own pixel and channel.  K19's plain
version is held to the interpreted Pallas kernel at the same ragged shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops import pallas_patch
from ir_ads_tpu_torch.ops import patch_embed as k19

P, C, ROW, K, E = 4, 3, 12, 48, 128
BAND, LD, OUT_LD, WARPS = 128, 56, 136, 8  # the kernel's kBand, kLd, kOutLd, kWarps
SHAPES = [(2, 8, 148), (1, 4, 1200), (3, 12, 64)]  # (B, H, W): 148, 300, 144 pixels


def stage_band(band, b, h, w):
    """The band's buffer of BAND * LD slots: the flat index into x of the
    element each slot receives (stage_band's copies), -1 where none."""
    hp, wp = h // P, w // P
    slots = np.full(BAND * LD, -1, np.int64)
    for e in range(P * BAND * (ROW // 4)):  # copy e, 8 bytes = 4 elements
        r, rem = divmod(e, BAND * (ROW // 4))
        i, j = divmod(rem, ROW // 4)
        p = band * BAND + i
        if p >= b * hp * wp:
            continue
        px, q = p % wp, p // wp
        py, bi = q % hp, q // hp
        src = ((bi * h + py * P + r) * w * C) + px * ROW + 4 * j
        dst = i * LD + r * ROW + 4 * j
        slots[dst:dst + 4] = src + np.arange(4)
    return slots


def staged_weight():
    """sm.w: flat index into the (48, 128) weight of each slot."""
    wt = np.full(E * LD, -1, np.int64)
    i = np.arange(K * E)
    wt[(i % E) * LD + i // E] = i
    return wt


def ldmatrix_x4(smem, row_addr):
    """ldmatrix .x4 (no transpose): lanes 8m..8m+7 give the rows of matrix
    m; lane l receives, from each matrix m, elements 2 (l % 4) and 2 (l % 4)
    + 1 of row l // 4.  Returns (32, 4, 2)."""
    out = np.empty((32, 4, 2), smem.dtype)
    for lane in range(32):
        for m in range(4):
            a = row_addr[8 * m + lane // 4] + 2 * (lane % 4)
            out[lane, m] = smem[a:a + 2]
    return out


@pytest.mark.parametrize("b,h,w", SHAPES)
def test_staged_bands_are_the_patches(b, h, w):
    n_pix = b * (h // P) * (w // P)
    x = torch.arange(b * h * w * C, dtype=torch.float64).reshape(b, h, w * C)
    want = k19.patchify_flat(x, P, C).reshape(n_pix, K).long().numpy()
    n_bands = -(-n_pix // BAND)
    assert n_pix % BAND  # a last band shorter than the others
    got = np.full((n_bands * BAND, K), -1, np.int64)
    for band in range(n_bands):
        slots = stage_band(band, b, h, w).reshape(BAND, LD)
        assert (slots[:, K:] == -1).all()  # the padding is never written
        got[band * BAND:(band + 1) * BAND] = slots[:, :K]
    np.testing.assert_array_equal(got[:n_pix], want)
    assert (got[n_pix:] == -1).all()


@pytest.mark.parametrize("b,h,w", SHAPES[:1])
def test_fragments_and_stores_follow_the_mma_layout(b, h, w):
    """For every warp and k step of the last (ragged) band: the A fragments
    are rows of patches, k = 12 r + q, the B fragments weight rows k of
    columns n, and the epilogue's stores put accumulator (row, column) at
    output pixel band * 128 + 16 warp + row, channel column."""
    n_pix = b * (h // P) * (w // P)
    band = n_pix // BAND
    xs, wt = stage_band(band, b, h, w), staged_weight()
    patches = k19.patchify_flat(torch.arange(b * h * w * C).reshape(b, h, w * C), P, C)
    patches = patches.reshape(n_pix, K).numpy()
    out = np.full(n_pix * E, -1, np.int64)
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    for warp in range(WARPS):
        for ks in range(K // 16):
            a = ldmatrix_x4(xs, warp * 16 * LD + (lane & 15) * LD + 16 * ks + (lane >> 4) * 8)
            for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):  # a0..a3
                for half in range(2):
                    p = band * BAND + warp * 16 + g + dr
                    k = 16 * ks + 2 * c + dk + half
                    live = p < n_pix
                    np.testing.assert_array_equal(
                        a[live, reg, half], patches[p[live], k[live]])
            for n in range(0, E // 8, 2):
                r = ldmatrix_x4(wt, (8 * n + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * ks
                                + ((lane >> 3) & 1) * 8)
                for reg, (dn, dk) in enumerate(((0, 0), (0, 8), (1, 0), (1, 8))):
                    for half in range(2):  # b0, b1 of tiles n, n + 1: (k, column g)
                        k = 16 * ks + 2 * c + dk + half
                        np.testing.assert_array_equal(r[:, reg, half], k * E + 8 * (n + dn) + g)
        # the accumulator layout through the warp's tile to device memory;
        # a tile element is tagged with its (row, column) as 1000 row + column
        os = np.full(16 * OUT_LD, -1, np.int64)
        for n in range(E // 8):
            for e in range(4):
                row, col = g + 8 * (e >> 1), 8 * n + 2 * c + (e & 1)
                os[row * OUT_LD + col] = 1000 * row + col
        pix0 = band * BAND + warp * 16
        for m in range(16 * E // 8 // 32):
            e = lane + 32 * m
            row, chunk = e // (E // 8), e % (E // 8)
            for ln in np.nonzero(pix0 + row < n_pix)[0]:
                dst = (pix0 + row[ln]) * E + 8 * chunk[ln]
                src = row[ln] * OUT_LD + 8 * chunk[ln]
                out[dst:dst + 8] = os[src:src + 8]
    mine = out.reshape(n_pix, E)[band * BAND:]
    rows = np.arange(len(mine))[:, None]
    np.testing.assert_array_equal(mine, 1000 * (rows % 16) + np.arange(E)[None])


def test_plain_version_matches_the_pallas_kernel_on_ragged_bands():
    """At (2, 8, 148 * 3), whose 148 pixels leave a band of 20: K19's plain
    version bit for bit the interpreted Pallas kernel in bf16 with a zero
    projection bias (tests/test_torch_flat_input.py's bar; a non-zero one
    meets the interpreted kernel's skipped rounding)."""
    rng = np.random.RandomState(7)
    b, h, w = SHAPES[0]
    x = rng.randn(b, h, w * C).astype(np.float32)
    wk2 = (rng.randn(K, E) * K ** -0.5).astype(np.float32)
    bias = np.zeros(E, np.float32)
    g = (1.0 + 0.05 * rng.randn(E)).astype(np.float32)
    be = (0.02 * rng.randn(E)).astype(np.float32)
    want = np.asarray(pallas_patch.pallas_patch_embed(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk2, jnp.bfloat16),
        *(jnp.asarray(a) for a in (bias, g, be)), P, C, interpret=True), np.float32)
    got = k19.patch_embed_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wk2).bfloat16(),
        *(torch.from_numpy(a) for a in (bias, g, be)), P, C)
    assert got.shape == (b, h // P, w // P, E)
    np.testing.assert_array_equal(got.float().numpy(), want)

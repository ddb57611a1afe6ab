"""K9's plain version (ops/msdeform.ms_deform_attn_plain) and the
MSDeformAttention module against the JAX package, on the CPU.

The plain version is held against the Pallas kernel in interpret mode (whose
arithmetic it repeats) and against the JAX CPU default ``ms_deform_attn_xla``:
in f32 all three are one function up to summation order (atol = rtol = 1e-5,
the bar of tests/test_pallas_msdeform.py); in bf16 the plain version follows
the kernel's rounding points (f32 sum over all slots, one rounding), so it is
held to the kernel within one bf16 ulp of the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection.msdeform_attn import MSDeformAttention as JaxMSDeformAttention
from ir_ads_tpu.detection.msdeform_attn import ms_deform_attn_xla
from ir_ads_tpu.ops.pallas_msdeform import ms_deform_attn_pallas
from ir_ads_tpu_torch.detection.msdeform_attn import MSDeformAttention, offset_bias_init
from ir_ads_tpu_torch.ops import msdeform
from ir_ads_tpu_torch.utils.jax_params import _tensor

SHAPE_SETS = [
    # the two of tests/test_pallas_msdeform.py
    (((12, 16), (6, 8), (3, 4)), 2, 4, 8, 37, 3),
    (((16, 20), (8, 10), (4, 5), (2, 3)), 1, 8, 32, 100, 4),
    # a ragged query count, DINO's level aspect
    (((13, 19), (7, 10), (4, 5), (2, 3)), 2, 8, 16, 203, 4),
]


def _data(seed, shapes, bs, heads, d, lq, points):
    """Locations in [-0.1, 1.1]: part of the corners fall outside."""
    rng = np.random.RandomState(seed)
    n_value = sum(h * w for h, w in shapes)
    value = rng.randn(bs, n_value, heads, d).astype(np.float32)
    loc = rng.rand(bs, lq, heads, len(shapes), points, 2).astype(np.float32) * 1.2 - 0.1
    w = rng.rand(bs, lq, heads, len(shapes), points).astype(np.float32)
    w /= w.reshape(bs, lq, heads, -1).sum(-1)[..., None, None]
    return value, loc, w


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("shapes,bs,heads,d,lq,points", SHAPE_SETS)
def test_plain_matches_jax_f32(shapes, bs, heads, d, lq, points, reference):
    value, loc, w = _data(0, shapes, bs, heads, d, lq, points)
    args = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w))
    want = (ms_deform_attn_pallas(*args, True) if reference == "pallas_interpret"
            else ms_deform_attn_xla(*args))
    got = msdeform.ms_deform_attn_plain(
        torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(w))
    assert got.shape == (bs, lq, heads * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes,bs,heads,d,lq,points", SHAPE_SETS[1:])
def test_plain_matches_pallas_kernel_bf16(shapes, bs, heads, d, lq, points):
    """bf16 values and weights, f32 locations (the model's types): the f32
    sums differ in order only, so the one rounding on store lands within one
    ulp (2^-8 relative spacing, 2^-7 allowed; atol for sums that cancel)."""
    value, loc, w = _data(1, shapes, bs, heads, d, lq, points)
    vb = jnp.asarray(value).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = ms_deform_attn_pallas(vb, shapes, jnp.asarray(loc), wb, True)
    got = msdeform.ms_deform_attn_plain(
        torch.from_numpy(value).bfloat16(), shapes, torch.from_numpy(loc),
        torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)
    assert (got == want).mean() > 0.99  # nearly every element bit-equal


def test_plain_zero_padding_semantics():
    """A location whose four corners are outside gives 0; one on a border
    pixel's centre gives that pixel; half a pixel outside gives half of it."""
    shapes = ((2, 3),)
    value = torch.arange(1.0, 7.0).reshape(1, 6, 1, 1)
    # (x, y): far outside; centre of pixel (0, 0); on the left edge beside it
    loc = torch.tensor([[-1.0, -1.0], [0.5 / 3, 0.5 / 2], [0.0, 0.5 / 2]])
    loc = loc.reshape(1, 3, 1, 1, 1, 2)
    w = torch.ones(1, 3, 1, 1, 1)
    got = msdeform.ms_deform_attn_plain(value, shapes, loc, w).reshape(3)
    np.testing.assert_allclose(got.numpy(), [0.0, 1.0, 0.5], atol=1e-6)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    value, loc, w = (torch.from_numpy(a) for a in _data(2, *SHAPE_SETS[0]))
    got = msdeform.ms_deform_attn(value, SHAPE_SETS[0][0], loc, w)
    want = msdeform.ms_deform_attn_plain(value, SHAPE_SETS[0][0], loc, w)
    assert torch.equal(got, want)
    assert msdeform.KERNEL.launches == 0


def test_wrapper_is_forward_only():
    value, loc, w = (torch.from_numpy(a) for a in _data(3, *SHAPE_SETS[0]))
    with pytest.raises(RuntimeError, match="forward-only"):
        msdeform.ms_deform_attn(value.requires_grad_(), SHAPE_SETS[0][0], loc, w)
    with torch.no_grad():
        msdeform.ms_deform_attn(value, SHAPE_SETS[0][0], loc, w)


def test_offset_bias_init_matches_jax():
    from ir_ads_tpu.detection.msdeform_attn import _offset_bias_init

    np.testing.assert_array_equal(offset_bias_init(8, 4, 4), _offset_bias_init(8, 4, 4))


def _random_like(tree, rng, scale=0.3):
    return jax.tree.map(
        lambda a: (scale * rng.randn(*a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("ref_dim,with_mask", [
    (2, False), (4, False), (2, True), (4, True)])
def test_module_matches_flax(ref_dim, with_mask, monkeypatch):
    """Every weight random (the zero-initialised offset and weight
    projections too, so that each query samples its own pattern), through
    the flax module under its Pallas kernel in interpret mode.  f32: atol
    2e-5 on outputs of order 1."""
    import ir_ads_tpu.ops.pallas_msdeform as pm

    monkeypatch.setenv("IR_ADS_MSDEFORM", "pallas")
    orig = pm.ms_deform_attn_pallas
    monkeypatch.setattr(pm, "ms_deform_attn_pallas",
                        lambda v, s, l, w: orig(v, s, l, w, True))
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))
    n_value = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(5 + ref_dim)
    b, lq, c = 2, 29, 64
    query = rng.randn(b, lq, c).astype(np.float32)
    value = rng.randn(b, n_value, c).astype(np.float32)
    qpos = rng.randn(b, lq, c).astype(np.float32)
    ref = rng.rand(b, lq, 4, ref_dim).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] *= 0.5
    mask = (rng.rand(b, n_value) < 0.2) if with_mask else None

    jmod = JaxMSDeformAttention(embed_dim=c, num_heads=8, num_levels=4, num_points=4)
    jargs = (jnp.asarray(query), jnp.asarray(value), jnp.asarray(ref), shapes)
    variables = jmod.init(jax.random.PRNGKey(0), *jargs)
    params = _random_like(variables["params"], rng)
    want = jmod.apply({"params": params}, *jargs, query_pos=jnp.asarray(qpos),
                      key_padding_mask=None if mask is None else jnp.asarray(mask))

    mod = MSDeformAttention(c, 8, 4, 4)
    mod.load_state_dict({f"{name}.{'weight' if leaf == 'kernel' else leaf}": _tensor(leaf, arr)
                         for name, sub in params.items() for leaf, arr in sub.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(query), torch.from_numpy(value), torch.from_numpy(ref),
                  shapes, query_pos=torch.from_numpy(qpos),
                  key_padding_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_module_samples_through_the_wrapper(monkeypatch):
    """The module reaches the sampling by the wrapper's name alone, so the
    plain path on a card is had by replacing that name and no argument
    selects it."""
    from ir_ads_tpu_torch.detection import msdeform_attn as det_attn

    calls = []

    def record(value, spatial_shapes, locations, weights):
        calls.append((tuple(value.shape), tuple(locations.shape), locations.dtype))
        return msdeform.ms_deform_attn_plain(value, spatial_shapes, locations, weights)

    monkeypatch.setattr(det_attn, "ms_deform_attn", record)
    shapes = ((4, 6), (2, 3))
    mod = MSDeformAttention(64, 8, 2, 4)
    with torch.no_grad():
        mod(torch.randn(1, 7, 64), torch.randn(1, 30, 64), torch.rand(1, 7, 2, 2), shapes)
    assert calls == [((1, 30, 8, 8), (1, 7, 8, 2, 4, 2), torch.float32)]

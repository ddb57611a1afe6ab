"""The port's backward kernels (K7 window attention, K8 DSCF rows) and the
autograd Functions around K1, K3, K4 and K6, on the CPU (plain versions),
against the JAX package: its Pallas backward kernels in interpret mode and
``jax.vjp`` of its XLA twins.  Inputs come from numpy seeds.

f32 bars are the JAX package's own for the same comparisons (atol = rtol =
5e-4, tests/test_pallas_swin_bwd.py and tests/test_dscf_rows.py): both sides
sum in f32 in another order.  bf16 bars are 5e-2, as the JAX bf16 smoke: the
two sides round at the same points, and an f32 sum of another order can flip
a rounding by one bf16 ulp (2^-8) of a value of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ir_ads_tpu.ops.pallas_dscf as pallas_dscf
import ir_ads_tpu.ops.pallas_dscf_rpe as pallas_rpe
from ir_ads_tpu.models.backbones import swin as jswin
from ir_ads_tpu.ops.pallas_dscf import dscf_rows_reference as jax_rows_reference
from ir_ads_tpu.ops.pallas_dscf import pallas_dscf_rows_bwd
from ir_ads_tpu.ops.pallas_swin import (
    _block_bwd_manual, _block_reference, _qkv_reference, pallas_window_attention_bwd,
    shift_region_ids,
)
from ir_ads_tpu_torch.models.backbones import swin as tswin
from ir_ads_tpu_torch.ops import (
    block_tail, dscf_rows, dscf_rows_bwd, dscf_rpe, dscf_rpe_packed, swin_block,
    swin_block_v6, window_attn_bwd,
)
from ir_ads_tpu_torch.utils.jax_params import from_flax

F32 = dict(atol=5e-4, rtol=5e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def random_variables(module, seed, *args):
    """numpy-seeded values in the shapes of ``module.init``'s tree."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "var":
            v = 0.5 + rng.rand(*leaf.shape)
        else:
            v = 0.05 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(dtype)


# --------------------------------------------------------------------------
# K7: window-attention backward
# --------------------------------------------------------------------------

def _attn_inputs(seed, bn, ws, c, heads):
    rng = np.random.RandomState(seed)
    n = ws * ws
    return (rng.randn(bn, n, 3 * c).astype(np.float32),
            rng.randn(bn, n, c).astype(np.float32),
            (0.5 * rng.randn(heads, n, n)).astype(np.float32))


@pytest.mark.parametrize("want_ow,want_dbias", [(True, True), (False, False),
                                                (True, False), (False, True)])
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_bwd_matches_pallas_kernel(dtype, shift, want_ow, want_dbias):
    """K7's plain version against the Pallas backward kernel, interpreted."""
    ws, c, heads, hp, wp, b = 4, 32, 2, 8, 12, 2
    nw = (hp // ws) * (wp // ws)
    qkvw, dow, bias = _attn_inputs(3, b * nw, ws, c, heads)
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    scale = (c // heads) ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_window_attention_bwd(
        _j(qkvw, jdt), _j(dow, jdt), _j(bias), None if region is None else jnp.asarray(region),
        scale, heads, interpret=True, want_ow=want_ow, want_dbias=want_dbias)
    got = window_attn_bwd.window_attention_bwd(
        _t(qkvw, tdt), _t(dow, tdt), _t(bias),
        None if region is None else torch.from_numpy(np.asarray(region)),
        scale, heads, want_ow, want_dbias)
    tol = F32 if dtype == "float32" else BF16
    for name, g, w_ in zip(("dqkv", "ow", "dbias"), got, want):
        assert (g is None) == (w_ is None), name
        if g is not None:
            assert g.dtype == (torch.float32 if name == "dbias" else tdt)
            np.testing.assert_allclose(_np(g.float()), _np(w_), err_msg=name, **tol)
    assert (got[1] is None) == (not want_ow) and (got[2] is None) == (not want_dbias)


def test_window_attention_bwd_matches_vjp_of_the_twin():
    """ow is the forward's attention output; dqkv and dbias are the vjp of
    the JAX twin of the attention core."""
    ws, c, heads = 4, 32, 2
    qkvw, dow, bias = _attn_inputs(4, 6, ws, c, heads)
    scale = (c // heads) ** -0.5
    dqkv, ow, dbias = window_attn_bwd.window_attention_bwd(
        _t(qkvw), _t(dow), _t(bias), None, scale, heads)
    want_ow, vjp = jax.vjp(lambda a, b_: _qkv_reference(a, b_, None, scale, heads),
                           _j(qkvw), _j(bias))
    want_dqkv, want_dbias = vjp(_j(dow))
    np.testing.assert_allclose(ow.numpy(), _np(want_ow), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(dqkv.numpy(), _np(want_dqkv), **F32)
    np.testing.assert_allclose(dbias.numpy(), _np(want_dbias), **F32)


# --------------------------------------------------------------------------
# the K1 Function: window_block's eight gradients
# --------------------------------------------------------------------------

ORDER = ("ln_scale", "ln_bias", "wqkv", "bqkv", "wproj", "bproj", "bias")


def _block_inputs(seed, c, heads, ws, b, hp, wp):
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    n = ws * ws
    p = dict(ln_scale=1.0 + r(c), ln_bias=r(c), wqkv=r(c, 3 * c), bqkv=r(3 * c),
             wproj=r(c, c), bproj=r(c), bias=r(heads, n, n))
    x = rng.randn(b, hp, wp, c).astype(np.float32)
    g = rng.randn(b, hp, wp, c).astype(np.float32)
    return p, x, g


def _port_block_grads(p, x, g, region, scale, heads, ws, h_real, w_real, shift,
                      dtype=torch.float32, frozen=()):
    """Gradients of the port's window_block through autograd; JAX's (in, out)
    weights go in as (out, in) and the gradients come back transposed."""
    leaves = {}
    for k in ORDER:
        a = p[k].T if k in ("wqkv", "wproj") else p[k]
        t = _t(np.ascontiguousarray(a), torch.float32 if k == "bias" else dtype)
        leaves[k] = t.requires_grad_(k not in frozen)
    xt = _t(x, dtype).requires_grad_()
    reg = None if region is None else torch.from_numpy(np.asarray(region))
    y = swin_block.window_block(xt, *[leaves[k] for k in ORDER], reg, scale, heads,
                                ws, h_real, w_real, shift)
    y.backward(_t(g, dtype))
    out = [xt.grad]
    for k in ORDER:
        gr = leaves[k].grad
        out.append(gr.t() if gr is not None and k in ("wqkv", "wproj") else gr)
    return out


BLOCK_GEOMETRIES = [
    pytest.param(dict(shift=0), id="shift0"),
    pytest.param(dict(shift=2), id="shift2"),
    pytest.param(dict(shift=2, h_real=7, w_real=10), id="padded"),
    pytest.param(dict(shift=0, c=128, heads=4, b=1, wp=8), id="d32"),
]


@pytest.mark.parametrize("geo", BLOCK_GEOMETRIES)
def test_window_block_grads_match_jax(monkeypatch, geo):
    """All eight gradients of the K1 Function against jax.vjp of
    ``_block_reference`` and against ``_block_bwd_manual`` with its Pallas
    kernel interpreted."""
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    geo = dict(dict(c=32, heads=2, ws=4, b=2, hp=8, wp=12, h_real=None, w_real=None), **geo)
    c, heads, ws, b, hp, wp = (geo[k] for k in ("c", "heads", "ws", "b", "hp", "wp"))
    shift, h_real, w_real = geo["shift"], geo["h_real"], geo["w_real"]
    p, x, g = _block_inputs(5, c, heads, ws, b, hp, wp)
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    jregion = None if region is None else jnp.asarray(region)
    scale = (c // heads) ** -0.5
    args = [_j(p[k]) for k in ORDER]
    _, vjp = jax.vjp(
        lambda *a: _block_reference(*a, jregion, scale, heads, ws, h_real=h_real,
                                    w_real=w_real, shift=shift), _j(x), *args)
    want_vjp = vjp(_j(g))
    want_manual = _block_bwd_manual((_j(x), *args, jregion), _j(g), scale, heads, ws,
                                    h_real, w_real, shift)
    got = _port_block_grads(p, x, g, region, scale, heads, ws, h_real, w_real, shift)
    tol = dict(atol=1e-3, rtol=1e-3) if c == 128 else F32  # JAX's bar at d = 32
    for name, a, wv, wm in zip(("dx",) + ORDER, got, want_vjp, want_manual):
        np.testing.assert_allclose(a.numpy(), _np(wv), err_msg=f"{name} vs vjp", **tol)
        np.testing.assert_allclose(a.numpy(), _np(wm), err_msg=f"{name} vs manual", **tol)


def test_window_block_grads_bf16_match_jax_manual(monkeypatch):
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    c, heads, ws, b, hp, wp, shift = 32, 2, 4, 1, 8, 8, 2
    p, x, g = _block_inputs(6, c, heads, ws, b, hp, wp)
    region = shift_region_ids(hp, wp, ws, shift)
    scale = (c // heads) ** -0.5
    args = [_j(p[k], jnp.float32 if k == "bias" else jnp.bfloat16) for k in ORDER]
    want = _block_bwd_manual((_j(x, jnp.bfloat16), *args, jnp.asarray(region)),
                             _j(g, jnp.bfloat16), scale, heads, ws, hp, wp, shift)
    got = _port_block_grads(p, x, g, region, scale, heads, ws, hp, wp, shift,
                            dtype=torch.bfloat16)
    for name, a, w_ in zip(("dx",) + ORDER, got, want):
        np.testing.assert_allclose(_np(a.float()), _np(w_), err_msg=name, **BF16)


def test_frozen_attention_parameters_skip_ow_and_dbias(monkeypatch):
    """Freezing with requires_grad is what reaches K7: a frozen wproj skips
    ow, a frozen bias skips dbias, and dx is unchanged."""
    c, heads, ws, b, hp, wp, shift = 32, 2, 4, 1, 8, 12, 2
    p, x, g = _block_inputs(7, c, heads, ws, b, hp, wp)
    region = shift_region_ids(hp, wp, ws, shift)
    scale = (c // heads) ** -0.5
    seen = []
    orig = swin_block.window_attention_bwd

    def spy(*a, want_ow=True, want_dbias=True):
        seen.append((want_ow, want_dbias))
        return orig(*a, want_ow=want_ow, want_dbias=want_dbias)

    monkeypatch.setattr(swin_block, "window_attention_bwd", spy)
    full = _port_block_grads(p, x, g, region, scale, heads, ws, hp, wp, shift)
    frozen = _port_block_grads(p, x, g, region, scale, heads, ws, hp, wp, shift,
                               frozen=ORDER)
    part = _port_block_grads(p, x, g, region, scale, heads, ws, hp, wp, shift,
                             frozen=("wproj",))
    assert seen == [(True, True), (False, False), (False, True)]
    assert all(gr is None for gr in frozen[1:])
    assert torch.equal(frozen[0], full[0]) and torch.equal(part[0], full[0])
    assert part[5] is None and torch.equal(part[7], full[7])


def test_window_block_gradcheck_f64():
    """The plain versions run in f64, so autograd's numerical check applies
    to the Function (K1 forward, manual backward with K7's plain version)."""
    c, heads, ws, b, hp, wp, shift = 8, 2, 2, 1, 4, 4, 1
    p, x, _ = _block_inputs(8, c, heads, ws, b, hp, wp)
    region = torch.from_numpy(np.asarray(shift_region_ids(hp, wp, ws, shift)))
    leaves = [torch.from_numpy(x).double().requires_grad_()]
    for k in ORDER:
        a = p[k].T if k in ("wqkv", "wproj") else p[k]
        leaves.append(torch.from_numpy(np.ascontiguousarray(a) * 4).double().requires_grad_())
    fn = lambda *a: swin_block.window_block(  # noqa: E731
        *a, region, (c // heads) ** -0.5, heads, ws, 3, 4, shift)
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6, rtol=1e-4)


# --------------------------------------------------------------------------
# K8: DSCF rows backward, and the K4 Function
# --------------------------------------------------------------------------

def _rows_inputs(seed, bg, h, w, gc, hg, m, mp):
    rng = np.random.RandomState(seed)
    q = rng.randn(bg, h * w, gc).astype(np.float32)
    k = rng.randn(bg, mp, gc).astype(np.float32)
    v = rng.randn(bg, mp, gc).astype(np.float32)
    k[:, m:], v[:, m:] = 3.0, 5.0  # padded keys must not be seen
    bias = rng.randn(bg, hg, h, m, w).astype(np.float32)
    g = rng.randn(bg, h * w, gc).astype(np.float32)
    return q, k, v, bias, g


@pytest.mark.parametrize("m,mp", [(8, 8), (5, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_bwd_matches_pallas_kernel_and_vjp(dtype, m, mp):
    """K8's plain version against the Pallas rows backward kernel,
    interpreted, and (f32) against jax.vjp of the rows twin; keys past M
    carry zero gradients."""
    bg, h, w, gc, hg, scale = 2, 8, 16, 16, 2, 0.25
    q, k, v, bias, g = _rows_inputs(9, bg, h, w, gc, hg, m, mp)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_dscf_rows_bwd(*(_j(a, jdt) for a in (q, k, v, bias, g)), scale, hg,
                                interpret=True)
    got = dscf_rows_bwd.dscf_rows_bwd(*(_t(a, tdt) for a in (q, k, v, bias, g)), scale, hg)
    tol = F32 if dtype == "float32" else BF16
    assert got[0].dtype == tdt and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == tuple(w_.shape), name
        np.testing.assert_allclose(_np(a.float()), _np(w_), err_msg=name, **tol)
    assert float(got[1][:, m:].abs().max() if mp > m else 0.0) == 0.0
    assert float(got[2][:, m:].abs().max() if mp > m else 0.0) == 0.0
    if dtype == "float32":
        _, vjp = jax.vjp(lambda a, b, c, d: jax_rows_reference(a, b, c, d, scale, hg),
                         *(_j(a) for a in (q, k, v, bias)))
        for name, a, w_ in zip(("dq", "dk", "dv", "dbias"), got, vjp(_j(g))):
            np.testing.assert_allclose(a.numpy(), _np(w_), err_msg=name, **F32)


def test_rows_attention_function_grads_match_jax_vjp():
    """Autograd through dscf_rows_attention (K4 forward, K8 backward)."""
    bg, h, w, gc, hg, m, mp, scale = 2, 4, 8, 16, 2, 5, 8, 0.25
    q, k, v, bias, g = _rows_inputs(10, bg, h, w, gc, hg, m, mp)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    dscf_rows.dscf_rows_attention(*leaves, scale, hg, True).backward(_t(g))
    _, vjp = jax.vjp(lambda a, b, c, d: jax_rows_reference(a, b, c, d, scale, hg),
                     *(_j(a) for a in (q, k, v, bias)))
    for name, leaf, w_ in zip(("dq", "dk", "dv", "dbias"), leaves, vjp(_j(g))):
        np.testing.assert_allclose(leaf.grad.numpy(), _np(w_), err_msg=name, **F32)


def test_rows_attention_gradcheck_f64():
    bg, h, w, gc, hg, m, mp = 1, 2, 3, 16, 2, 3, 8
    q, k, v, bias, _ = _rows_inputs(11, bg, h, w, gc, hg, m, mp)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v, bias)]
    fn = lambda *a: dscf_rows.dscf_rows_attention(*a, 0.25, hg, True)  # noqa: E731
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6, rtol=1e-4)


# --------------------------------------------------------------------------
# K3 / K6 Functions: the backward through the f32 twin
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["rows", "packed"])
def test_rpe_bias_grads_match_jax_twin(layout):
    """Gradients of pos and of the table through the rpe bias Functions
    against jax.grad of the JAX package's XLA twin in the same layout."""
    bg, g_, hg, m, h, w = 4, 2, 2, 6, 5, 7
    rng = np.random.RandomState(12)
    pos = (rng.rand(bg, m, 2) * 1.8 - 0.9).astype(np.float32)
    table = rng.randn(g_, hg, 2 * h - 1, 2 * w - 1).astype(np.float32)
    if layout == "rows":
        shape, fn = (bg, hg, h, m, w), dscf_rpe.rpe_bias_rows
        jfn = pallas_rpe.dscf_rpe_bias_rows_reference
    else:
        shape, fn = (bg, hg, m, h * w), dscf_rpe_packed.rpe_bias_packed
        jfn = pallas_rpe.dscf_rpe_bias_packed_reference
    cot = rng.randn(*shape).astype(np.float32)
    tp, tt = _t(pos).requires_grad_(), _t(table).requires_grad_()
    out = fn(tp, tt, h, w, torch.float32)
    assert out.shape == shape
    out.backward(_t(cot))
    want = jax.grad(lambda p_, t_: jnp.sum(jfn(p_, t_, h, w, jnp.float32) * _j(cot)),
                    argnums=(0, 1))(_j(pos), _j(table))
    np.testing.assert_allclose(tp.grad.numpy(), _np(want[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tt.grad.numpy(), _np(want[1]), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# DAttentionMM under pallas3: every parameter gradient against the JAX module
# --------------------------------------------------------------------------

def test_dattention_pallas3_grads_match_jax(monkeypatch):
    """Train mode (BatchNorm on batch statistics), loss sum(out^2): the
    port's parameter gradients, K8 and the bias twin on the way, against
    jax.grad of the JAX module with both Pallas backward kernels interpreted.
    atol 5e-3 on gradients of size up to ~1e3, rtol 2e-3: f32 sums of
    another order through the softmax over the sampled keys."""
    monkeypatch.setenv("IR_ADS_PALLAS_INTERPRET", "1")
    for mod, name in ((pallas_dscf, "pallas_dscf_attention_rows"),
                      (pallas_rpe, "dscf_rpe_bias_rows_pallas")):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _o=orig, **kw: _o(*a, **{**kw, "interpret": True}))

    rng = np.random.RandomState(13)
    x, y = (rng.randn(2, 8, 8, 32).astype(np.float32) for _ in range(2))
    mod = jswin.DAttentionMM(dim=32, n_heads=4, n_groups=2, stride=2, attn_impl="pallas3")
    v = random_variables(mod, 14, jnp.asarray(x), jnp.asarray(y))

    def loss(params):
        out, mut = mod.apply({"params": params, "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), jnp.asarray(y), True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), mut["batch_stats"]

    (want_loss, want_stats), want = jax.value_and_grad(loss, has_aux=True)(v["params"])
    port = tswin.DAttentionMM(32, 4, 2, 2).train()
    port.load_state_dict(from_flax(v))
    out = port(torch.from_numpy(x), torch.from_numpy(y))
    got_loss = (out ** 2).sum()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-4)
    want_sd = from_flax({"params": jax.tree.map(np.asarray, want)})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(), err_msg=name,
                                   atol=5e-3, rtol=2e-3)
    assert float(port.rpe_table.grad.abs().sum()) > 0.0
    stats = from_flax({"batch_stats": jax.tree.map(np.asarray, want_stats)})
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), err_msg=name,
                                       atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the eval-only kernels refuse autograd
# --------------------------------------------------------------------------

def _tail_args(c, rng):
    hid, ca = 4 * c, max(c // 16, 1)
    shapes = [(c,), (c,), (hid, c), (hid,), (c, hid), (c,), (ca, c), (ca,), (c, ca), (c,)]
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1) for s in shapes]


@pytest.mark.parametrize("which", ["input", "parameter"])
def test_block_tail_raises_under_autograd(which):
    rng = np.random.RandomState(15)
    x = torch.from_numpy(rng.randn(6, 32).astype(np.float32))
    args = _tail_args(32, rng)
    (x if which == "input" else args[6]).requires_grad_()
    with pytest.raises(RuntimeError, match="eval-only"):
        block_tail.block_tail(x, *args)
    with torch.no_grad():
        assert block_tail.block_tail(x, *args).shape == x.shape


@pytest.mark.parametrize("which", ["input", "parameter"])
def test_window_block_v6_raises_under_autograd(which):
    rng = np.random.RandomState(16)
    c, heads, ws = 32, 2, 4
    x = torch.from_numpy(rng.randn(1, 8, 8, c).astype(np.float32))
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)  # noqa: E731
    attn = [r(c), r(c), r(3 * c, c), r(3 * c), r(c, c), r(c), r(heads, ws * ws, ws * ws)]
    tail = _tail_args(c, rng)
    (x if which == "input" else tail[8]).requires_grad_()
    with pytest.raises(RuntimeError, match="eval-only"):
        swin_block_v6.window_block_v6(x, attn, tail, None, 0.25, heads, ws, 0)
    with torch.no_grad():
        assert swin_block_v6.window_block_v6(
            x, attn, tail, None, 0.25, heads, ws, 0).shape == x.shape


@pytest.mark.parametrize("dispatch", ["r5", "r4"])
def test_eval_dispatch_model_raises_when_it_would_record_a_gradient(dispatch):
    """A model built for an eval dispatch and put in train mode does not run
    K2 or K5 under autograd silently."""
    from ir_ads_tpu_torch.models.cmnext import CMNeXt

    small = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
    model = CMNeXt(num_classes=5, backbone_kwargs=small, head_dims=(32, 16),
                   dispatch=dispatch).train()
    x = torch.zeros(2, 32, 32, 3)
    with pytest.raises(RuntimeError, match="eval-only"):
        model(x, x)

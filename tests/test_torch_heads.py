"""The port's decode heads (models/heads/{extra,align}_heads.py) against
the JAX package's, on the CPU in f32 at tiny widths, weights carried by
utils/jax_params.library_from_flax; eval mode and train mode (batch
statistics, their running updates, and the dropout at rate 1e-12 so that
both sides keep every element).  NMF2D and LightHamHead take the bases JAX
draws from PRNGKey(0); LawinHead raises ValueError where the JAX head fails.
The JAX modules run jitted at XLA's backend optimisation level 0 (the same
f32 function): op by op they take ten times as long."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models import heads as jheads
from ir_ads_tpu.models.heads import extra_heads as jextra
from ir_ads_tpu_torch.models import heads as theads
from ir_ads_tpu_torch.models.heads import extra_heads as textra
from ir_ads_tpu_torch.utils.jax_params import library_from_flax

ATOL, RTOL = 2e-3, 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
DROP = 1e-12  # dropout on, and no element dropped on either side
IN_DIMS = (8, 16, 24, 32)
SIZES = ((16, 16), (8, 8), (4, 4), (2, 2))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(module, seed, *args, **kw):
    """numpy-seeded values in the shapes of ``module.init``'s tree (scales
    near 1, variances in [0.5, 1.5), the rest 0.05 * N(0, 1))."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kw))
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


def port_of(module, variables):
    """``module`` with the flax ``variables`` loaded strictly."""
    module.load_state_dict(library_from_flax(variables, module))
    return module


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


def run_jax(module, variables, *args, train=False, **kw):
    """(output, updated batch_stats or None) of the flax module, jitted
    (``FAST_COMPILE``); ``kw`` are static."""
    if not train:
        return jax.jit(lambda v, *a: module.apply(v, *a, **kw),
                       compiler_options=FAST_COMPILE)(variables, *args), None
    out, upd = jax.jit(lambda v, *a: module.apply(
        v, *a, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(3)},
        **kw), compiler_options=FAST_COMPILE)(variables, *args)
    return out, upd.get("batch_stats")


def check_stats(port, updated):
    """The port's running statistics after a train-mode forward against
    flax's updated batch_stats."""
    if not updated:
        return
    sd = port.state_dict()
    for name, t in library_from_flax({"batch_stats": updated}).items():
        close(sd[name], t)


def pyramid(seed=0, b=2, dims=IN_DIMS, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, c).astype(np.float32) for c, (h, w) in zip(dims, sizes)]


HEAD_CASES = {
    "UPerHead": dict(channel=16, num_classes=5, drop=DROP),
    "FPNHead": dict(channel=16, num_classes=5, drop=DROP),
    "FCNHead": dict(channel=16, num_classes=5),
    "CondHead": dict(channel=16, num_classes=5, drop=DROP),
    "SFHead": dict(channel=16, num_classes=5, drop=DROP),
    "FaPNHead": dict(channel=16, num_classes=5, drop=DROP),
    "LawinHead": dict(embed_dim=16, num_classes=5, patch=2, drop=DROP),
}


@functools.lru_cache(maxsize=None)
def _jax_heads(seed=1):
    """{name: (variables, {train: (output, updated batch_stats)})} of every
    JAX head of ``HEAD_CASES`` on ``pyramid()``, both modes of all of them
    from one jitted call (one compile)."""
    feats = [jnp.asarray(f) for f in pyramid()]
    mods = {name: jheads.HEADS[name](**kw) for name, kw in HEAD_CASES.items()}
    vs = {name: random_variables(m, seed, feats) for name, m in mods.items()}

    def every(vs, fs):
        outs = {}
        for name, m in mods.items():
            out, upd = m.apply(vs[name], fs, train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(3)})
            outs[name] = (m.apply(vs[name], fs), out, upd.get("batch_stats"))
        return outs

    outs = jax.jit(every, compiler_options=FAST_COMPILE)(vs, feats)
    return {name: (vs[name], {False: (want, None), True: (out, updated)})
            for name, (want, out, updated) in outs.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_head_matches_jax(name, train):
    v, outs = _jax_heads()[name]
    want, updated = outs[train]
    feats = pyramid()
    port = port_of(theads.HEADS[name](IN_DIMS, **HEAD_CASES[name]), v).train(train)
    got = port([torch.from_numpy(f) for f in feats], generator=torch.Generator().manual_seed(0))
    if name == "CondHead" and train:  # (guidance, seg)
        close(got[0], want[0])
        got, want = got[1], want[1]
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)
    check_stats(port, updated)


def _nmf_bases(b, c, rank=64):
    """The bases the JAX NMF2D draws without an ``nmf`` rng."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (b, c, rank), jnp.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_nmf2d_matches_jax(train):
    x = np.abs(np.random.RandomState(2).randn(2, 6, 5, 32)).astype(np.float32)
    want, _ = run_jax(jextra.NMF2D(), {}, jnp.asarray(x), train=train)
    port = textra.NMF2D().train(train)
    got = port(torch.from_numpy(x), torch.tensor(_nmf_bases(2, 32)))
    close(got, want)
    # the steps count: one step fewer moves the result
    port.train(not train)
    other = port(torch.from_numpy(x), torch.tensor(_nmf_bases(2, 32)))
    assert not np.allclose(other.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_light_ham_head_matches_jax(train):
    feats = pyramid(3)
    jmod = jheads.HEADS["LightHamHead"](ham_channels=32, num_classes=5)
    v = random_variables(jmod, 4, [jnp.asarray(f) for f in feats])
    want, _ = run_jax(jmod, v, [jnp.asarray(f) for f in feats], train=train)
    port = port_of(theads.HEADS["LightHamHead"](IN_DIMS, ham_channels=32, num_classes=5), v)
    got = port.train(train)([torch.from_numpy(f) for f in feats],
                            torch.tensor(_nmf_bases(2, 32)))
    assert tuple(got.shape) == (2, 8, 8, 5)
    close(got, want)


def test_lawin_raises_where_jax_fails():
    """Level 1 at 6x6 with patch 4: JAX crops the query windows to 4x4 and
    its concatenation with the 6x6 paths fails; the port names the rule."""
    sizes = ((12, 12), (6, 6), (3, 3), (2, 2))
    feats = pyramid(5, sizes=sizes)
    kw = dict(embed_dim=16, num_classes=5, patch=4)
    jmod = jheads.HEADS["LawinHead"](**kw)
    with pytest.raises(TypeError):
        v = random_variables(jmod, 6, [jnp.asarray(f) for f in feats])
        jmod.apply(v, [jnp.asarray(f) for f in feats])
    port = theads.HEADS["LawinHead"](IN_DIMS, **kw)
    with pytest.raises(ValueError, match="multiple of patch"):
        port([torch.from_numpy(f) for f in feats])


def test_registry_names():
    assert list(theads.HEADS) == list(jheads.HEADS)
    assert len(theads.HEADS) == 9


def test_conv_module_group_norm_matches_jax():
    x = np.random.RandomState(7).randn(2, 5, 6, 16).astype(np.float32)
    for norm, act in (("gn", True), ("gn", False), ("none", True)):
        jmod = jextra.ConvModule(64, 3, norm=norm, act=act)
        v = random_variables(jmod, 8, jnp.asarray(x))
        port = port_of(textra.ConvModule(16, 64, 3, norm=norm, act=act), v)
        close(port(torch.from_numpy(x)), run_jax(jmod, v, jnp.asarray(x))[0])

"""The legacy models under the dispatches the JAX package gives a meaning for
them, on the CPU in f32, against the JAX package traced under the
environment each dispatch stands for.

A legacy model reads from the dispatch its DSCF's level-3 attention (the
MiT runs level 3 at every stage), its ``rpe3`` and its int8 flag.  Under
r4, r4i8, r2, v5 and map that is ``pallas3``: K3's plain version, then K4's
unpacked form (the reference's ``IR_ADS_DSCF_PACKED`` "1,1,1,0" at level
3), at CMNeXt-B0's 4, 5, 4, 4 channels a head, where the 2n keys are a
multiple of 8 (64x112 frames: n = 2 x 4 at every stage), and the einsum
elsewhere (64x80: n = 2 x 3), its bias by K6's plain version under r4, r4i8
and v5 and in the XLA form under r2 and map.

  * K4's plain version at 4, 5 and 10 channels a head (B0's and B1-B5's
    widths) against the interpreted ``_dscf_rows_kernel`` (the unpacked
    form): f32 at 2e-5, bf16 bit for bit (the rounding points are the
    kernel's, and at these sizes the f32 sums agree).
  * CMNeXt-B0's logits under r4, r2, v5 and map at 64x112 and 64x80
    against JAX's jitted apply, at tests/test_torch_mit.py's bars (atol
    2e-3, rtol 1e-3).  JAX is traced once for each environment as a
    legacy model reads it (``IR_ADS_DSCF_*`` and ``IR_ADS_INT8``; the Swin
    block variables of the five sets do not reach it): r4 with v5, r2
    with map, and at 64x112, where no stage takes the einsum branch, r4
    with r2.
  * r4i8: each int8 DSCF (B0's stages 0 and 2) against flax's under
    ``IR_ADS_INT8=1`` at f32's noise; the whole CMNeXt-B0 against JAX's
    r4i8 at the w8a8 bar stated in its test (measured: worst logit
    4.66e-3 apart, 10.8x closer than JAX's float r4); CMX-B0 (no DSCF:
    the head's composed projection in w8a8) against JAX's at 2e-3 / 1e-3,
    and under the float dispatches bit-equal to r5, which
    tests/test_torch_cmx.py holds against JAX.
  * r1 bit-equal to xla, v7_01 and dscf_pallas4 bit-equal to r5, on both
    legacy families, and dscf_pallas and dscf_pallas2 on CMX-B0 (no DSCF).
  * CMNeXt-B0 under dscf_pallas and dscf_pallas2 (K17's plain version at
    every stage, at 4, 4, 5 and 4 channels a head, the 16 keys padded to
    128; the bias in the XLA form or by K18's plain version) against JAX's
    under ``IR_ADS_DSCF_ATTN=pallas`` and ``pallas2`` at 64x112, the bars
    above.
  * ``SemSegPredictor``, ``val_mm`` and ``infer_mm`` take the new
    dispatches.

About two minutes in one process: six JAX compiles of CMNeXt-B0, two of
its int8 DSCF and one of CMX-B0, the port in one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.models import build_model as jax_build_model
from ir_ads_tpu.ops.pallas_dscf import pallas_dscf_attention_rows
from ir_ads_tpu_torch import val_mm
from ir_ads_tpu_torch.models import CMNeXtLegacy, build_model
from ir_ads_tpu_torch.ops import dscf_rows
from ir_ads_tpu_torch.serve import SemSegPredictor
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from test_torch_mit import (
    ATOL, CLASSES, RTOL, _cfg, _jitted_logits, fill_variables, legacy_variables,
)

BF16 = torch.bfloat16
INTERPRET = {"IR_ADS_PALLAS_INTERPRET": "1", "IR_ADS_FFN": "fused"}
# the JAX environment each dispatch stands for (bench.py's sets; the port's
# rpe3 "pallas" is IR_ADS_DSCF_RPE3=pallas, its "xla" the variable's default)
ENV = {
    "r4": {"IR_ADS_SWIN_ATTN": "pallas4", "IR_ADS_DSCF_ATTN": "pallas3",
           "IR_ADS_DSCF_RPE3": "pallas"},
    "r4i8": {"IR_ADS_SWIN_ATTN": "pallas4", "IR_ADS_DSCF_ATTN": "pallas3",
             "IR_ADS_DSCF_RPE3": "pallas", "IR_ADS_SWIN_PACKED": "1", "IR_ADS_INT8": "1"},
    "r2": {"IR_ADS_SWIN_ATTN": "pallas", "IR_ADS_DSCF_ATTN": "pallas3"},
    "v5": {"IR_ADS_SWIN_ATTN": "pallas5", "IR_ADS_DSCF_ATTN": "pallas3",
           "IR_ADS_DSCF_RPE3": "pallas"},
    "map": {"IR_ADS_SWIN_ATTN": "pallas_map", "IR_ADS_DSCF_ATTN": "pallas3"},
    "dscf_pallas": {"IR_ADS_DSCF_ATTN": "pallas"},
    "dscf_pallas2": {"IR_ADS_DSCF_ATTN": "pallas2"},
}
# what a legacy model reads of the environment
READ = ("IR_ADS_DSCF_ATTN", "IR_ADS_DSCF_RPE3", "IR_ADS_INT8")
SIZES = {"rows": (64, 112), "einsum": (64, 80)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed, h, w, b=2):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, w, 3).astype(np.float32) for _ in range(2))


# --------------------------------------------------------------------------
# K4 at the MiT's head widths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hc", [4, 5, 10])
def test_rows_attention_at_mit_head_widths_matches_pallas(hc):
    """The unpacked form, the MiT's (level 3 at every stage); two heads a
    group, as every MiT stage has; a 4x16 plane over 40 keys, the bias at
    the served model's scale."""
    rng = np.random.RandomState(70 + hc)
    bg, h, w, hg, m = 2, 4, 16, 2, 40
    q, k, v = (rng.randn(bg, n, hg * hc).astype(np.float32) for n in (h * w, m, m))
    bias = (2.0 * rng.randn(bg, hg, h, m, w)).astype(np.float32)
    scale = hc ** -0.5
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        want = pallas_dscf_attention_rows(*(jnp.asarray(a, jdt) for a in (q, k, v, bias)),
                                          scale, hg, interpret=True, packed=False)
        want = np.asarray(want.astype(jnp.float32))
        got = dscf_rows.dscf_rows_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v, bias)), scale, hg, False)
        assert got.shape == (bg, h * w, hg * hc)
        if tdt == BF16:
            assert int((got.float().numpy() != want).sum()) == 0
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_k4_and_k8_head_widths():
    from ir_ads_tpu_torch.ops.dscf_heads import HEAD_CHANNELS

    assert HEAD_CHANNELS["dscf_rows"] == (4, 5, 8, 10, 12)
    assert HEAD_CHANNELS["dscf_rows_bwd"] == (8, 12)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def b0():
    """CMNeXt-B0 (JAX), its weights, frames at both sizes and a cache of
    JAX's logits by (size, the environment as a legacy model reads it)."""
    model = jax_build_model("CMNeXt", "CMNeXt-B0", num_classes=CLASSES)
    frames = {k: _frames(80, *hw) for k, hw in SIZES.items()}
    return dict(model=model, v=_variables("CMNeXt-B0", 81), frames=frames, cache={})


def _variables(backbone, seed):
    """legacy_variables' values in the shapes of the port's tree carried to
    flax's (``to_flax``, held leaf for leaf against JAX's tree by
    tests/test_torch_mit.py and tests/test_torch_cmx.py): no JAX trace."""
    return fill_variables(to_flax(CMNeXtLegacy(backbone, CLASSES).state_dict()), seed)


def _jax(fix, size, dispatch):
    env = {**INTERPRET, **ENV[dispatch]}
    # IR_ADS_DSCF_RPE3 is read only by the einsum branch (swin.py:1494-1513),
    # which no stage takes at the rows size
    read = READ if size == "einsum" else tuple(k for k in READ if k != "IR_ADS_DSCF_RPE3")
    key = (size, tuple(env.get(k, "") for k in read))
    if key not in fix["cache"]:
        fix["cache"][key] = _jitted_logits(fix["model"], fix["v"], *fix["frames"][size], env)
    return fix["cache"][key]


def _port(fix, size, dispatch, backbone="CMNeXt-B0"):
    port = build_model("CMNeXt", backbone, CLASSES, dispatch=dispatch,
                       state_dict=from_flax(fix["v"]))
    rgb, dte = (torch.from_numpy(a) for a in fix["frames"][size])
    with torch.no_grad():
        return port, port(rgb, dte)[0].numpy()


def _check_dscf(port, dispatch, size):
    dscf = [m.deform_atten for m in port.backbone.DeformMPGBlocks]
    assert {d.attn_impl for d in dscf} == {"pallas3"} and all(d.level == 3 for d in dscf)
    assert [d.proj_q.out_channels // d.n_heads for d in dscf] == [4, 4, 5, 4]
    h, w = SIZES[size]
    n = -(-h // 32) * -(-w // 32)  # offsets a field at every stage
    assert all(d.rows_path(n) == (size == "rows") for d in dscf)
    assert {d.rpe3 for d in dscf} == {"pallas" if dispatch in ("r4", "r4i8", "v5") else "xla"}
    assert {d.int8 for d in dscf} == {dispatch == "r4i8"}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("dispatch", ["r4", "r2", "v5", "map"])
def test_cmnext_b0_matches_jax_under_the_dispatch(b0, dispatch, size):
    port, got = _port(b0, size, dispatch)
    _check_dscf(port, dispatch, size)
    want = _jax(b0, size, dispatch)
    assert got.shape == (2, *SIZES[size], CLASSES) and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("stage", [0, 2])
def test_int8_mit_dscf_matches_flax(monkeypatch, stage):
    """The DSCF of CMNeXt-B0's stage 0 (32 channels, 4 a head) and stage 2
    (160, 5 a head) under ``IR_ADS_INT8=1`` on both sides, rows path, at
    f32's noise: atol 2e-5 + rtol 1e-5 (outputs up to ~6)."""
    from ir_ads_tpu.models.backbones import swin as jswin
    from ir_ads_tpu_torch.models.backbones import swin as tswin
    from ir_ads_tpu_torch.ops.int8 import quantize_int8_
    from test_torch_mit import carried

    for k, val in {**INTERPRET, **ENV["r4i8"]}.items():
        monkeypatch.setenv(k, val)
    dim, stride, g, heads, hw = ((32, 8, 1, 2, (16, 28)), None, (160, 2, 4, 8, (4, 7)))[stage]
    x, y = (np.random.RandomState(85 + s).randn(2, *hw, dim).astype(np.float32) for s in (0, 1))
    jm = jswin.DeformMPGBlock(dim=dim, stride=stride, n_groups=g, n_heads=heads, level=3,
                              ratio=0.25)
    v = legacy_variables(jm, 86, jnp.asarray(x), jnp.asarray(y))
    port = carried(tswin.DeformMPGBlock(dim, stride, g, heads, level=3, ratio=0.25,
                                        attn_impl="pallas3", int8=True, rpe3="pallas"), v)
    assert quantize_int8_(port) == 1 and port.deform_atten.rows_path(8)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)


def test_cmnext_b0_under_r4i8_matches_jax(b0):
    """w8a8 is chaotic in depth: an f32 ulp that flips one s8 code moves the
    next product's per-row scale, and the MiT's DSCF (unit deform weight at
    every stage) carries it on to every later stage.  Each int8 DSCF
    agrees with flax's at f32's noise (``test_int8_mit_dscf_matches_flax``);
    the whole model lies 0.159 (in norm) from JAX's r4i8, 10.8x closer than
    JAX's float r4 (1.72), its worst logit 4.66e-3 apart (measured here).
    Bars: atol 1e-2 / rtol 1e-3 element by element, and at least 8x closer
    to JAX's r4i8 than JAX's float r4 is (tests/test_torch_slice_r4i8.py
    asks 10x of the Swin model, whose DSCF levels 0-2 weigh 1e-3)."""
    port, got = _port(b0, "rows", "r4i8")
    _check_dscf(port, "r4i8", "rows")
    want = _jax(b0, "rows", "r4i8")
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-3)
    dist = np.linalg.norm(got - want)
    int8_vs_float = np.linalg.norm(want - _jax(b0, "rows", "r4"))
    print(f"|port - jax r4i8| {dist:.3e}, |jax r4i8 - jax r4| {int8_vs_float:.3e}, "
          f"worst {np.abs(got - want).max():.3e}")
    assert 8 * dist <= int8_vs_float


def test_cmx_b0_under_r4i8_matches_jax(b0):
    model = jax_build_model("CMNeXt", "CMX-B0", num_classes=CLASSES)
    rgb, dte = b0["frames"]["rows"]
    v = _variables("CMX-B0", 82)
    want = _jitted_logits(model, v, rgb, dte, {**INTERPRET, **ENV["r4i8"]})
    fix = dict(v=v, frames=b0["frames"])
    got = _port(fix, "rows", "r4i8", "CMX-B0")[1]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    floated = {d: _port(fix, "rows", d, "CMX-B0")[1] for d in ("r5", "r4", "r2", "v5", "map")}
    for d in ("r4", "r2", "v5", "map"):  # no DSCF: the dispatch reaches the head's int8 only
        assert np.array_equal(floated[d], floated["r5"]), d
    assert 10 * np.linalg.norm(got - want) <= np.linalg.norm(want - floated["r5"])


@pytest.mark.parametrize("backbone", ["CMNeXt-B0", "CMX-B0"])
def test_r1_v7_01_and_dscf_pallas4_are_xla_and_r5(b0, backbone):
    """The three dispatches differ from xla and r5 only in the Swin blocks
    and DSCF levels 0-2, which a legacy model does not have."""
    v = b0["v"] if backbone == "CMNeXt-B0" else None
    rgb, dte = (torch.from_numpy(a) for a in b0["frames"]["einsum"])

    def logits(dispatch):
        m = build_model("CMNeXt", backbone, CLASSES, dispatch=dispatch, seed=83,
                        state_dict=None if v is None else from_flax(v))
        with torch.no_grad():
            return m(rgb, dte)[0]

    assert torch.equal(logits("r1"), logits("xla"))
    r5 = logits("r5")
    same = ("v7_01", "dscf_pallas4") + (("dscf_pallas", "dscf_pallas2")
                                        if backbone == "CMX-B0" else ())
    for d in same:
        assert torch.equal(logits(d), r5), d


@pytest.mark.parametrize("dispatch", ["dscf_pallas", "dscf_pallas2"])
def test_cmnext_b0_matches_jax_under_dscf_pallas(b0, dispatch):
    """The MiT's DSCF on K17 (with K18's bias under dscf_pallas2) at every
    stage, where dscf_pallas and dscf_pallas2 were refused before K17 took
    the MiT's head widths."""
    port, got = _port(b0, "rows", dispatch)
    dscf = [m.deform_atten for m in port.backbone.DeformMPGBlocks]
    assert {d.attn_impl for d in dscf} == {dispatch[len("dscf_"):]}
    assert all(d.level == 3 for d in dscf)
    assert [d.proj_q.out_channels // d.n_heads for d in dscf] == [4, 4, 5, 4]
    want = _jax(b0, "rows", dispatch)
    assert got.shape == (2, *SIZES["rows"], CLASSES) and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dispatch", ["r4", "r4i8"])
def test_entry_points_take_the_new_dispatches(dispatch, tmp_path):
    """SemSegPredictor serves CMNeXt-B0 under the dispatch as a direct
    forward of the same model does; val_mm and infer_mm run it."""
    from ir_ads_tpu_torch import infer_mm
    from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn

    h, w = SIZES["rows"]
    pred = SemSegPredictor(device="cpu", dtype=torch.float32, seed=3, num_classes=CLASSES,
                           image_size=(h, w), backbone="CMNeXt-B0", dispatch=dispatch)
    assert isinstance(pred.model, CMNeXtLegacy) and pred.model.dispatch == dispatch
    g = np.random.RandomState(84)
    rgb, dep = (g.randint(0, 256, (2, h, w, 3)).astype(np.uint8) for _ in range(2))
    logits, _ = pred(rgb, dep)
    model = build_model("CMNeXt", "CMNeXt-B0", CLASSES, seed=3, dispatch=dispatch,
                        upsample_logits=False)
    predict = make_sliding_window_fn(model.forward_fused, (h, w), (h, w), CLASSES)
    with torch.no_grad():
        assert torch.equal(logits, predict(*pred.normalize(rgb, dep)))
    result = val_mm.main(_cfg("CMNeXt-B0", msf=True), device="cpu", dispatch=dispatch, seed=4)
    assert result["mode"] == "msf" and 0.0 <= result["miou"] <= 100.0
    seg = infer_mm.SemSeg(_cfg("CMNeXt-B0"), device="cpu", dispatch=dispatch, seed=5)
    color, _ = seg.predict_array(g.randint(0, 256, (50, 70, 3)).astype(np.uint8))
    assert color.shape == (50, 70, 3)

"""The port's deformable convolutions (detection/deform_conv.py), RegNet,
the alternative backbones (models/backbones/alt_backbones.py: ConvNeXt,
FocalNet, ViT, InternImage, EVA-02) and the detectron2 project trunks
(models/projects/{vitdet,mvit}.py) against the JAX package's, on the CPU
in f32 at tiny widths, weights carried by utils/jax_params.
library_from_flax.  Offsets reach past the map, so that zero padding is
held; ViTDet and EVA-02 run on a grid other than their table's, which
resizes it (``jax.image``'s cubic) and cuts EVA-02's rope table; MViT's
windowed blocks resize their rel-pos tables."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import deform_conv as jdc
from ir_ads_tpu.models.backbones import alt_backbones as jalt
from ir_ads_tpu.models.backbones import regnet as jreg
from ir_ads_tpu.models.projects import mvit as jmvit
from ir_ads_tpu.models.projects import vitdet as jvitdet
from ir_ads_tpu_torch.detection import deform_conv as tdc
from ir_ads_tpu_torch.models.backbones import alt_backbones as talt
from ir_ads_tpu_torch.models.backbones import regnet as treg
from ir_ads_tpu_torch.models.projects import mvit as tmvit
from ir_ads_tpu_torch.models.projects import vitdet as tvitdet
from tests.test_torch_heads import (
    FAST_COMPILE, check_stats, close, port_of, random_variables,
)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _jit(f):
    return jax.jit(f, compiler_options=FAST_COMPILE)


@pytest.mark.parametrize("stride,padding,modulated", [(1, None, True), (2, 1, False)])
def test_deform_conv2d_matches_jax(stride, padding, modulated):
    x, w = _x(0, 2, 9, 11, 6), _x(1, 3, 3, 6, 5)
    ho = (9 + 2 * 1 - 3) // stride + 1
    wo = (11 + 2 * 1 - 3) // stride + 1
    off = _x(2, 2, ho, wo, 18, scale=3.0)  # many taps past the border
    mask = np.random.RandomState(3).rand(2, ho, wo, 9).astype(np.float32) if modulated else None
    want = _jit(lambda *a: jdc.deform_conv2d(*a, stride=stride, padding=padding))(
        *map(jnp.asarray, (x, w, off)), None if mask is None else jnp.asarray(mask))
    got = tdc.deform_conv2d(*_t(x, w, off), None if mask is None else torch.from_numpy(mask),
                            stride, padding)
    close(got, want, atol=1e-5, rtol=1e-5)


def test_dcn_v3_core_matches_jax():
    x, off = _x(4, 2, 7, 8, 12), _x(5, 2, 7, 8, 3 * 9 * 2, scale=3.0)
    mask = np.asarray(jax.nn.softmax(jnp.asarray(_x(6, 2, 7, 8, 3, 9)), -1)).reshape(2, 7, 8, 27)
    want = _jit(lambda *a: jdc.dcn_v3_core(*a, kernel=3, groups=3))(
        *map(jnp.asarray, (x, off, mask)))
    close(tdc.dcn_v3_core(*_t(x, off, mask), kernel=3, groups=3), want, atol=1e-5, rtol=1e-5)


# name: (JAX module, port module, the input's seed and shape, train mode
# tested); each at tiny widths.  RegNet: two variants of REGNET_PARAMS'
# form at widths 8-64 with 1, 1, 2 and 1 blocks of group width 4, put into
# both tables while the modules are built and traced (``mock.patch.dict``),
# on two 64x64 images (res5 at 2x2: batch statistics over 8 positions);
# the published variants run at full size on the card (chip_smoke.py
# phase 14 (c)).  ConvNeXt's train mode runs drop-path at 1e-12: on,
# and nothing dropped.  ViTDet's table is at 8x8 tokens and the run at
# 8x10: the cubic resize, a padded window row, and global blocks sized for
# the run's grid.  MViT: four one-block stages on 16x16 tokens, windows of
# 8 and 4, the kv stride 2 then 1, global attention at the stages' last
# blocks.
CONVNEXT = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32), drop_path_rate=1e-12)
FOCALNET = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32))
VIT = dict(patch_size=8, dim=16, depth=2, num_heads=2)
INTERNIMAGE = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32), groups=(2, 2, 4, 4))
VITDET = dict(img_size=64, patch_size=8, dim=16, depth=3, num_heads=2, window_size=3,
              global_attn_indexes=(1,), drop_path_rate=0.0)
EVA02 = dict(img_size=64, patch_size=8, dim=16, depth=3, num_heads=2, window_size=4,
             global_indexes=(2,), drop_path_rate=0.0)
MVIT = dict(embed_dim=8, depth=4, last_block_indexes=(0, 1, 2, 3), adaptive_kv_stride=2,
            adaptive_window_size=8)
TINY_REGNETS = {  # (w_0, w_a, w_m, depth, group_width, se_ratio)
    "regnetx_tiny": (8, 12.0, 2.0, 5, 4, 0.0),
    "regnety_tiny": (8, 12.0, 2.0, 5, 4, 0.25),
}
CASES = {
    "regnetx_tiny": (lambda: jreg.RegNet("regnetx_tiny"),
                     lambda: treg.RegNet("regnetx_tiny"), (7, 2, 64, 64, 3), False),
    "regnety_tiny": (lambda: jreg.RegNet("regnety_tiny", frozen_bn=False),
                     lambda: treg.RegNet("regnety_tiny", frozen_bn=False),
                     (7, 2, 64, 64, 3), True),
    "convnext": (lambda: jalt.ConvNeXt(**CONVNEXT), lambda: talt.ConvNeXt(**CONVNEXT),
                 (8, 2, 64, 48, 3), True),
    "focalnet": (lambda: jalt.FocalNet(**FOCALNET), lambda: talt.FocalNet(**FOCALNET),
                 (9, 2, 64, 48, 3), False),
    "vit": (lambda: jalt.ViT(**VIT), lambda: talt.ViT(img_size=(32, 48), **VIT),
            (10, 2, 32, 48, 3), False),
    "internimage": (lambda: jalt.InternImage(**INTERNIMAGE),
                    lambda: talt.InternImage(**INTERNIMAGE), (11, 2, 64, 48, 3), False),
    "vitdet": (lambda: jvitdet.ViTDet(**VITDET), lambda: tvitdet.ViTDet(grid=(8, 10), **VITDET),
               (12, 2, 64, 80, 3), False),
    "pyramid": (lambda: jvitdet.SimpleFeaturePyramid(out_channels=8),
                lambda: tvitdet.SimpleFeaturePyramid(16, 8), (13, 2, 4, 5, 16), False),
    "eva02": (lambda: jalt.EVA02ViT(**EVA02), lambda: talt.EVA02ViT(**EVA02),
              (15, 2, 64, 80, 3), False),
    "mvit": (lambda: jmvit.MViT(**MVIT), lambda: tmvit.MViT(img_size=(64, 64), **MVIT),
             (16, 2, 64, 64, 3), False),
}


@functools.lru_cache(maxsize=None)
def _jax_trunks():
    """(inputs, variables, {name: (eval outputs, (train outputs, updated
    batch_stats) or None)}) of every case, all from one jitted call (one
    compile)."""
    with mock.patch.dict(jreg.REGNET_PARAMS, TINY_REGNETS):  # read when traced
        xs = {name: _x(*case[2]) for name, case in CASES.items()}
        mods = {name: case[0]() for name, case in CASES.items()}
        vs = {name: random_variables(m, 11, jnp.asarray(xs[name])) for name, m in mods.items()}

        def every(vs, xs):
            outs = {}
            for name, m in mods.items():
                train = None
                if CASES[name][3]:
                    out, upd = m.apply(vs[name], xs[name], train=True, mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(3)})
                    train = (out, upd.get("batch_stats"))
                outs[name] = (m.apply(vs[name], xs[name]), train)
            return outs

        outs = _jit(every)(vs, {name: jnp.asarray(x) for name, x in xs.items()})
        return xs, vs, outs


def _check(name, train=False):
    """The port's module of case ``name`` against the JAX module's outputs
    (and, in train mode, its updated batch statistics)."""
    xs, vs, outs = _jax_trunks()
    want, updated = outs[name][1] if train else (outs[name][0], None)
    with mock.patch.dict(treg.REGNET_PARAMS, TINY_REGNETS):
        port = port_of(CASES[name][1](), vs[name]).train(train)
    kw = ({} if name.startswith("regnet") or name == "pyramid"
          else {"generator": torch.Generator().manual_seed(0)})
    got = port(torch.from_numpy(xs[name]), **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        close(got[key], want[key])
    check_stats(port, updated)
    return port


def test_regnet_widths_match_jax():
    for name, (w0, wa, wm, d, gw, _) in jreg.REGNET_PARAMS.items():
        assert treg.regnet_widths(w0, wa, wm, d) == jreg.regnet_widths(w0, wa, wm, d), name
        ws = jreg.regnet_widths(w0, wa, wm, d)[0]
        assert treg.adjust_widths_groups(ws, gw) == jreg.adjust_widths_groups(ws, gw)


@pytest.mark.parametrize("variant,train", [
    ("regnetx_tiny", False), ("regnety_tiny", False), ("regnety_tiny", True)],
    ids=["x-frozen", "y-eval", "y-train"])
def test_regnet_matches_jax(variant, train):
    """RegNetX with frozen BatchNorms, RegNetY (SE) with flax's."""
    _check(variant, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_convnext_matches_jax(train):
    _check("convnext", train)


def test_focalnet_matches_jax():
    _check("focalnet")


def test_vit_matches_jax():
    _check("vit")


def test_internimage_matches_jax():
    _check("internimage")


def test_vitdet_matches_jax():
    assert tuple(_check("vitdet").pos_embed.shape) == (1, 8, 8, 16)


def test_simple_feature_pyramid_matches_jax():
    _check("pyramid")
    assert sorted(_jax_trunks()[2]["pyramid"][0]) == ["p2", "p3", "p4", "p5", "p6"]


def test_eva02_matches_jax():
    _check("eva02")


def test_mvit_matches_jax():
    _check("mvit")


def test_backbone_registry_names():
    assert list(talt.BACKBONES) == list(jalt.BACKBONES)
    assert len(talt.BACKBONES) == 6

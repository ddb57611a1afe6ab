"""The port's reference-checkpoint import (ir_ads_tpu_torch/utils/
torch_import.py) and its CLI (ir_ads_tpu_torch/convert_pth.py) against the
JAX package's, on the CPU.

  * ``import_cmnext_state_dict`` of the torch reference model's state_dict
    (tests/utils/torch_swin_ref.CMNeXtRef, weights drawn from a seed) is
    ``from_flax`` of the JAX importer's tree leaf by leaf, bit for bit, with
    and without the ``backbone.`` prefix; the port then gives CMNeXtRef's
    logits (atol 2e-3 / rtol 1e-3, tests/test_swin_parity.py's bar).
  * ``_resize_bias_table`` is ``jax.image.resize``'s bicubic within 1e-6
    relative (shrinking, where it antialiases, and growing); the resize of
    ``F.interpolate(mode="bicubic")`` (a = -0.75, no antialiasing) must
    miss that bar.  ``import_pretrained_swin`` of a synthesized window-7
    upstream checkpoint matches the JAX importer's within the same bar.
  * ``convert_pth import`` then ``export``: the exported keys and arrays
    are the JAX ``do_export``'s of the same file, and they carry back to
    the imported state_dict.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import convert_pth as jax_convert
import ir_ads_tpu.models.cmnext as jax_cmnext
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.utils import torch_import as jimport
from ir_ads_tpu_torch import convert_pth
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.utils import torch_import
from ir_ads_tpu_torch.utils.checkpoint import load_weights
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables
from tests.utils.torch_swin_ref import CMNeXtRef

H, W = 64, 80
RESIZE_REL = 1e-6


def _ref_model(seed=0):
    ref = CMNeXtRef(embed_dim=16, depths=(1, 4, 1, 1), heads=(1, 2, 4, 8), ws=4,
                    num_classes=5, head_dims=(32, 16))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for name, buf in ref.named_buffers():
            if "running_var" in name:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            elif "running_mean" in name:
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
    return ref.eval()


def _port(**kw):
    return CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16), **kw).eval()


def _jax_model():
    return JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5, backbone_kwargs=TINY,
                     head_dims=(32, 16), mmst_mask=False)


@pytest.fixture(scope="module")
def jax_target():
    z = jnp.zeros((1, H, W, 3))
    return random_variables(_jax_model(), 3, z, z)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("prefixed", [True, False])
def test_cmnext_import_is_the_jax_importers_bit_for_bit(jax_target, prefixed):
    ref = _ref_model()
    sd = ref.state_dict()
    if not prefixed:  # the backbone's keys without "backbone."
        sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v
              for k, v in sd.items()}
    jvars, jwarn = jimport.import_cmnext_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_target)
    want = from_flax(jvars)
    port = _port()
    got, warnings = torch_import.import_cmnext_state_dict(sd, port.state_dict())
    assert warnings == [] and [w for w in jwarn if "relative_position_index" not in w] == []
    assert set(want) <= set(got)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    # parameters and BN statistics all came from the checkpoint
    computed = lambda names: {n for n in names if n.endswith(torch_import.COMPUTED)}  # noqa: E731
    assert set(got) - computed(got) == set(want) - computed(want)


def test_imported_port_gives_the_reference_logits():
    ref = _ref_model(1)
    rng = np.random.RandomState(0)
    rgb, dte = (rng.randn(2, H, W, 3).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        want = ref(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (rgb, dte)))
    port = _port(mmst_mask=False)
    state, warnings = torch_import.import_cmnext_state_dict(ref.state_dict(), port.state_dict())
    assert warnings == []
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(rgb), torch.from_numpy(dte))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_.permute(0, 2, 3, 1).numpy(),
                                   atol=2e-3, rtol=1e-3)


def test_import_warns_on_shapes_and_unknown_keys_and_keeps_the_target():
    port = _port()
    target = port.state_dict()
    name = "backbone.stages.0.blocks.0.norm1.weight"
    sd = {name: torch.zeros(3), "backbone.no_such.weight": torch.zeros(1),
          "decode_head.linear_pred.bias": torch.arange(5.0)}
    got, warnings = torch_import.import_cmnext_state_dict(sd, target)
    assert len(warnings) == 2 and "shape mismatch" in warnings[0] and "no param" in warnings[1]
    assert torch.equal(got[name], target[name])
    assert torch.equal(got["decode_head.linear_pred.bias"], torch.arange(5.0))


@pytest.mark.parametrize("sizes", [(13, 7), (13, 23), (23, 13), (7, 7)],
                         ids=lambda s: f"{s[0]}to{s[1]}")
def test_bias_table_resize_is_jax_image_resize(sizes):
    s1, s2 = sizes
    table = np.random.RandomState(s1 * s2).randn(s1 * s1, 6).astype(np.float32)
    want = jimport._resize_bias_table(table, s2 * s2)
    got = torch_import._resize_bias_table(table, s2 * s2)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel(got, want) <= RESIZE_REL
    if s1 != s2:  # torch's bicubic (a = -0.75, clamped, not antialiased) misses the bar
        img = torch.from_numpy(table.T.reshape(1, 6, s1, s1))
        other = F.interpolate(img, size=(s2, s2), mode="bicubic", align_corners=False)
        other = other.reshape(6, s2 * s2).T.numpy()
        assert _rel(other, want) > 100 * RESIZE_REL


def _upstream_swin(port_sd, seed):
    """An upstream (mmseg) Swin checkpoint for the port's backbone shapes at
    window 7: the RGB stream's patch embedding, the stages' blocks without
    adapters, the output norms, and the window-7 buffers."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, t in port_sd.items():
        key = name[len("backbone."):]
        if not name.startswith("backbone.") or key.startswith(("extra_", "MPG", "Deform",
                                                                "fuse_norm")):
            continue
        if "Adapter" in key or key.endswith("num_batches_tracked"):
            continue
        if key.endswith("relative_position_bias_table"):
            sd[key] = torch.from_numpy(rng.randn(13 * 13, t.shape[1]).astype(np.float32))
        elif key.endswith("relative_position_index"):
            sd[key] = torch.zeros(49, 49, dtype=torch.int64)
        else:
            sd[key] = torch.from_numpy((0.1 * rng.randn(*t.shape)).astype(np.float32))
    sd["head.fc.weight"] = torch.zeros(3, 4)  # a classification head the model lacks
    return {"backbone." + k: v for k, v in sd.items()}


def test_pretrained_swin_import_matches_jax(jax_target):
    port = _port()
    port.load_state_dict(from_flax(jax_target))  # what the import leaves, equal too
    sd = _upstream_swin(port.state_dict(), 5)
    jvars, _ = jimport.import_pretrained_swin({k: v.numpy() for k, v in sd.items()},
                                              jax_target, window_size=4)
    want = from_flax(jvars)
    got, warnings = torch_import.import_pretrained_swin(sd, port.state_dict(), window_size=4)
    assert warnings == ["no param backbone.head.fc.weight"]
    tables = 0
    for name, w in want.items():
        if name.endswith("relative_position_bias_table"):
            tables += 1
            assert _rel(got[name], w) <= RESIZE_REL, name
        else:
            assert torch.equal(got[name], w), name
    assert tables == 7
    # the surgery: the extra stream starts from the RGB stream's weights
    for a, b in (("patch_embed.projection.weight", "extra_patch_embed.projection.weight"),
                 ("norm2.bias", "extra_norm2.bias")):
        assert torch.equal(got["backbone." + a], got["backbone." + b])


def test_convert_import_export_round_trip_and_jax_export(jax_target, tmp_path, monkeypatch):
    ref = _ref_model(2)
    pth = str(tmp_path / "model.pth")
    torch.save({"state_dict": ref.state_dict()}, pth)
    warnings = convert_pth.do_import(pth, str(tmp_path / "port"), num_classes=5,
                                     backbone_kwargs=TINY, head_dims=(32, 16))
    assert warnings == []
    imported = convert_pth.read_pth(pth)
    # the JAX CLI on the same file; its model's init gives the tiny tree
    # (random_variables, drawn without compiling: every leaf is imported)
    class Tiny:
        def __init__(self, backbone, num_classes):
            assert (backbone, num_classes) == ("SwinTransformer-B", 5)

        def init(self, rngs, *inputs):
            return jax_target

    monkeypatch.setattr(jax_cmnext, "CMNeXt", Tiny)
    args = lambda **kw: type("Args", (), dict(backbone="SwinTransformer-B",  # noqa: E731
                                              num_classes=5, **kw))
    jax_convert.do_import(args(pth=pth, out=str(tmp_path / "jax"), pretrained_swin=False))
    mine = load_weights(str(tmp_path / "port"))
    theirs = load_weights(str(tmp_path / "jax"))
    assert set(from_flax(mine)) == set(from_flax(theirs))
    for name, t in from_flax(theirs).items():
        assert torch.equal(from_flax(mine)[name], t), name
    # export: the JAX do_export's keys and arrays, and back to the import
    out = str(tmp_path / "port.pth")
    convert_pth.main(["export", "--weights", str(tmp_path / "port" / "weights.msgpack"),
                      "--out", out])
    jax_convert.do_export(args(weights=str(tmp_path / "port" / "weights.msgpack"),
                               out=str(tmp_path / "jax.pth")))
    got = torch.load(out, weights_only=True)
    want = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
    assert set(got) == set(want) and all(k.startswith(("params.", "batch_stats.")) for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tree = {"params": {}, "batch_stats": {}}
    for k, v in got.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    back = from_flax(tree)
    for name, t in back.items():
        if name in imported:
            assert torch.equal(t, imported[name]), name
    assert os.path.getsize(out) > 0

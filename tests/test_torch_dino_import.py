"""The DINO half of the reference-checkpoint importer on the port
(``utils.torch_import.import_dino_state_dict``) against the JAX package's:
at tests/test_dino_import.py's tiny detector (ResNet-50, embed 32, 1 + 1
layers, 3 levels), every reference key the JAX importer reads is
synthesized (the port's names are the reference's), and JAX's import onto
the flax tree, carried over by ``jax_params.dino_from_flax``, must equal
the port's import bit for bit, with the same warnings as sets.  JAX
names a warning by its flax path and the port by its own name (a third of
the packed ``in_proj`` as ``name[q]`` ...), so the JAX warnings are
mapped to the port's names first.  The flax template is the port's tree
through ``dino_to_flax``, whose structure and shapes are held against
``jax.eval_shape`` of the flax detector's init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection.dino import DINODetector as JaxDINO
from ir_ads_tpu.utils.torch_import import import_dino_state_dict as jax_import
from ir_ads_tpu_torch.detection.dino import DINODetector
from ir_ads_tpu_torch.utils.jax_params import _dino_module, dino_from_flax, dino_to_flax
from ir_ads_tpu_torch.utils.torch_import import COMPUTED, import_dino_state_dict

TINY = dict(num_classes=6, num_queries=10, embed_dim=32, num_encoder_layers=1,
            num_decoder_layers=1, num_levels=3, backbone_arch="resnet50", dn_number=0,
            max_gt=2)


@pytest.fixture(scope="module")
def target():
    torch.manual_seed(0)
    return DINODetector(**TINY).state_dict()


def _reference(target, seed):
    """A reference-named state_dict: every parameter and statistic of the
    port's tree, random (the statistics' variances positive)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in target.items():
        if k.endswith(COMPUTED):
            continue
        a = rng.randn(*v.shape).astype(np.float32)
        sd[k] = np.abs(a) + 0.5 if k.endswith("running_var") else a
    return sd


def _port_name(kind, path, n_mapped):
    """A JAX warning's flax path as the port's name."""
    segs = path.split("/")
    if segs[-2] in ("q_proj", "k_proj", "v_proj"):
        base = _dino_module(tuple(segs[:-2]), n_mapped)
        leaf = "in_proj_weight" if segs[-1] == "kernel" else "in_proj_bias"
        return kind, f"{base}.attn.{leaf}[{segs[-2][0]}]"
    coll = "batch_stats" if segs[-1] in ("mean", "var") else "params"
    tree = leaf = {}
    for s in segs[:-1]:
        leaf = leaf.setdefault(s, {})
    leaf[segs[-1]] = np.zeros((1, 1) if segs[-1] == "kernel" else (1,), np.float32)
    names = [k for k in dino_from_flax({coll: tree}) if not k.endswith(COMPUTED)]
    assert len(names) == 1, (path, names)
    return kind, names[0]


def _jax_run(target, sd):
    variables, warnings = jax_import(sd, dino_to_flax(target))
    n_mapped = len({k.split(".")[2] for k in target if k.startswith("neck.convs.")})
    mapped = set()
    for w in warnings:
        kind = "no param" if w.startswith("no param") else "shape mismatch"
        path = w[len(kind) + 1:].split(":")[0]
        mapped.add(_port_name(kind, path, n_mapped))
    return dino_from_flax(variables), mapped


def _port_run(target, sd):
    got, warnings = import_dino_state_dict(target, sd)
    kinds = set()
    for w in warnings:
        kind = "no param" if w.startswith("no param") else "shape mismatch"
        kinds.add((kind, w[len(kind) + 1:].split(":")[0]))
    return got, kinds


def _assert_same(got, want, target):
    assert set(got) == set(target)
    for k, v in want.items():
        if k.endswith(COMPUTED):
            continue
        assert got[k].dtype == target[k].dtype, k
        assert torch.equal(got[k], v), k


def test_template_is_the_flax_tree(target):
    shapes = jax.eval_shape(lambda: JaxDINO(**TINY).init(
        {"params": jax.random.PRNGKey(0), "cdn": jax.random.PRNGKey(1)},
        jnp.ones((1, 64, 64, 3))))
    tree = dino_to_flax(target)
    want = {jax.tree_util.keystr(p): s.shape
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want


def test_import_matches_jax_bit_for_bit(target):
    sd = _reference(target, 1)
    want, jwarn = _jax_run(target, sd)
    got, pwarn = _port_run(target, sd)
    assert jwarn == pwarn == set()
    _assert_same(got, want, target)
    for k in sd:  # every key landed
        assert torch.equal(got[k], torch.from_numpy(sd[k])), k


def test_import_warnings_match_jax(target):
    """Keys the model has no place for (a second encoder layer, a third
    class head), mismatched shapes (a class head, the packed in_proj's
    last third, a backbone conv), and a key the checkpoint lacks (a
    decoder norm's: the target's value kept)."""
    sd = _reference(target, 2)
    layer = "transformer.encoder.layers.0."
    for k in [k for k in sd if k.startswith(layer)]:
        sd["transformer.encoder.layers.1." + k[len(layer):]] = sd[k] * 2
    sd["class_embed.2.weight"] = np.ones((6, 32), np.float32)
    sd["class_embed.0.weight"] = np.ones((7, 32), np.float32)
    qkv = "transformer.decoder.layers.0.attentions.0.attn.in_proj_weight"
    sd[qkv] = sd[qkv][:90]
    sd["backbone.res3.0.conv2.weight"] = np.ones((128, 128, 1, 1), np.float32)
    for k in ("weight", "bias"):
        del sd[f"transformer.decoder.layers.0.norms.2.{k}"]
    want, jwarn = _jax_run(target, sd)
    got, pwarn = _port_run(target, sd)
    assert pwarn == jwarn
    assert ("shape mismatch", qkv + "[v]") in pwarn
    assert ("shape mismatch", qkv + "[q]") not in pwarn
    assert ("no param", "class_embed.2.weight") in pwarn
    assert ("shape mismatch", "class_embed.0.weight") in pwarn
    assert ("shape mismatch", "backbone.res3.0.conv2.weight") in pwarn
    assert sum(w[1].startswith("transformer.encoder.layers.1.") for w in pwarn) == 16
    _assert_same(got, want, target)
    for name in ("class_embed.0.weight", "backbone.res3.0.conv2.weight",
                 "transformer.decoder.layers.0.norms.2.weight"):
        assert torch.equal(got[name], target[name]), name
    c = 32  # the packed projection's q and k thirds landed, its v third kept
    assert torch.equal(got[qkv][: 2 * c], torch.from_numpy(sd[qkv][: 2 * c]))
    assert torch.equal(got[qkv][2 * c:], target[qkv][2 * c:])


def test_missing_tensor_of_a_read_module_raises_as_jax(target):
    sd = _reference(target, 3)
    del sd["neck.convs.0.gn.bias"]
    with pytest.raises(KeyError):
        jax_import(sd, dino_to_flax(target))
    with pytest.raises(KeyError):
        import_dino_state_dict(target, sd)

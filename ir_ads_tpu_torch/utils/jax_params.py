"""Carry a flax CMNeXt parameter tree over to the port.

``from_flax(variables)`` takes the JAX model's variables as nested dicts of
numpy arrays (``{"params": ..., "batch_stats": ...}``) and returns a
state_dict for ``ir_ads_tpu_torch.models.cmnext.CMNeXt``, whose names are the
reference checkpoint's.  It is the inverse of
``ir_ads_tpu/utils/torch_import.import_cmnext_state_dict``:

  Dense kernel (in, out)            -> Linear weight (out, in)
  Conv kernel (kh, kw, in, out)     -> Conv2d weight (out, in, kh, kw)
  LayerNorm / BatchNorm scale, bias -> weight, bias
  batch_stats mean, var             -> running_mean, running_var
  stages_i/pairs/block{0,1} (stacked over block pairs by the scanned deep
  stages)                           -> stages.i.blocks.{2p, 2p+1}

plus the buffers the flax tree does not hold (relative_position_index,
num_batches_tracked).  Any tree of the same structure goes through the same
mapping: a flax gradient tree or an updated parameter tree given as
``{"params": tree}`` comes back keyed by the port's parameter names, and
``batch_stats`` by its buffer names, so a training step is compared name by
name.

``dino_from_flax(variables)`` does the same for the detection stack's
``DINODetector`` (``ir_ads_tpu_torch.detection.dino``): the inverse of
``import_dino_state_dict``, from either parameter layout of the flax
transformer (unrolled, or stacked by ``scan_layers``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ir_ads_tpu_torch.ops.window_attention import relative_position_index

# flax module name -> reference module path, per parent context
_RENAME = {
    "proj@patch_embed": "projection",
    "proj@extra_patch_embed": "projection",
    "adapter_rgb": "MLP_RGB_Adapter",
    "adapter_dte": "MLP_DTE_Adapter",
    "Dense_0@ffn": "layers.0.0",
    "Dense_1@ffn": "layers.1",
    "rel_pos_bias_table": "relative_position_bias_table",
    "dw": "0",
    "LayerNorm_0": "1.norm",
    "pw": "3",
    "fuse_q_conv": "fuse_q.conv.0",
    "fuse_q_bn": "fuse_q.conv.1",
    "sample_weight_fc1": "get_sample_weight.0",
    "sample_weight_fc2": "get_sample_weight.2",
    "linear_fuse": "linear_fuse.conv",
    "fuse_bn": "linear_fuse.bn",
}
_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _module_name(seg: str, parent: str) -> str:
    if f"{seg}@{parent}" in _RENAME:
        return _RENAME[f"{seg}@{parent}"]
    if seg in _RENAME:
        return _RENAME[seg]
    m = re.fullmatch(r"(stages|blocks)_(\d+)", seg)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"mpg_(\d+)", seg)
    if m:
        return f"MPGBlocks.{m.group(1)}"
    m = re.fullmatch(r"deform_mpg_(\d+)", seg)
    if m:
        return f"DeformMPGBlocks.{m.group(1)}"
    if re.fullmatch(r"linear_c\d+", seg) and parent.startswith("decode_head"):
        return f"{seg}.proj"
    return seg


def _tensor(leaf: str, arr: np.ndarray) -> torch.Tensor:
    if leaf == "kernel" and arr.ndim == 2:
        arr = arr.T
    elif leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(arr, dtype=np.float32))  # own, writable copy


def _unstack_pairs(path, arr):
    """stages_i/pairs/block{s}/... stacked over pairs -> one entry per block."""
    i = path.index("pairs")
    slot = int(path[i + 1][-1])
    for p in range(arr.shape[0]):
        yield path[:i] + (f"blocks_{2 * p + slot}",) + path[i + 2:], arr[p]


def from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of numpy arrays) -> port state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(coll, {})):
            items = _unstack_pairs(path, arr) if "pairs" in path else [(path, arr)]
            for p, a in items:
                names = [_module_name(seg, p[j - 1] if j else "")
                         for j, seg in enumerate(p[:-1])]
                leaf = p[-1]
                names.append(_RENAME.get(leaf, _LEAF.get(leaf, leaf)))
                sd[".".join(names)] = _tensor(leaf, a)
    for name in list(sd):
        if name.endswith("relative_position_bias_table"):
            ws = (int(round(np.sqrt(sd[name].shape[0]))) + 1) // 2
            sd[name[: -len("bias_table")] + "index"] = torch.from_numpy(
                relative_position_index(ws, ws))
        if name.endswith("running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


# --------------------------------------------------------------------------
# detection: DINODetector
# --------------------------------------------------------------------------

_DINO_TOP = {
    "seg_map_conv1": "mapping_fpn_features_for_seg.0",
    "seg_map_bn": "mapping_fpn_features_for_seg.1",
    "seg_map_conv2": "mapping_fpn_features_for_seg.3",
    "seg_post_ln": "post_layernorm",
}
_DINO_TRANSFORMER = {
    "ref_point_head": "transformer.decoder.ref_point_head",
    "decoder_norm": "transformer.decoder.norm",
    "enc_output": "transformer.enc_output",
    "enc_output_norm": "transformer.enc_output_norm",
}
_DINO_LAYER = {"Dense_0": "ffns.0.layers.0.0", "Dense_1": "ffns.0.layers.1"}


def _unstack_scanned(tr: Dict) -> Dict:
    """A ``scan_layers`` transformer tree (``encoder_scan/layer``,
    ``decoder_scan/{layer,bbox_embed,class_embed}``, leaves stacked on a
    leading layer axis) as the unrolled one (``encoder_i``, ``decoder_i``,
    ``bbox_embed_i``, ``class_embed_i``)."""
    out = {k: v for k, v in tr.items() if k not in ("encoder_scan", "decoder_scan")}

    def unstack(stacked, name):
        leaves = list(_walk(stacked))
        for i in range(leaves[0][1].shape[0]):
            layer = out.setdefault(f"{name}_{i}", {})
            for path, arr in leaves:
                node = layer
                for seg in path[:-1]:
                    node = node.setdefault(seg, {})
                node[path[-1]] = arr[i]

    if "encoder_scan" in tr:
        unstack(tr["encoder_scan"]["layer"], "encoder")
    if "decoder_scan" in tr:
        unstack(tr["decoder_scan"]["layer"], "decoder")
        unstack(tr["decoder_scan"]["bbox_embed"], "bbox_embed")
        unstack(tr["decoder_scan"]["class_embed"], "class_embed")
    return out


def _dino_module(path: Tuple[str, ...], n_mapped: int) -> str:
    """Reference module path of a flax module path (leaf excluded)."""
    head, rest = path[0], path[1:]

    def sub(segs):  # an MLP's ``layer{k}`` is ``layers.k`` there
        return "".join("." + (f"layers.{s[5:]}" if s.startswith("layer") else s)
                       for s in segs)

    if head == "backbone":
        mod = rest[0]
        if mod in ("stem_conv", "stem_bn"):
            return "backbone.stem.conv1" + (".norm" if mod == "stem_bn" else "")
        m = re.fullmatch(r"layer(\d+)_(\d+)", mod)
        block = f"backbone.res{int(m.group(1)) + 1}.{m.group(2)}"
        part = rest[1]
        if part.startswith("downsample"):
            return f"{block}.shortcut" + (".norm" if part.endswith("bn") else "")
        return f"{block}.conv{part[-1]}" + (".norm" if part.startswith("bn") else "")
    if head == "neck":
        kind, i = rest[0].rsplit("_", 1)
        leaf = "conv" if kind.endswith("conv") else "gn"
        if kind.startswith("extra"):
            return f"neck.extra_convs.{int(i) - n_mapped}.{leaf}"
        return f"neck.convs.{i}.{leaf}"
    if head == "transformer":
        mod = rest[0]
        if mod in _DINO_TRANSFORMER:
            return _DINO_TRANSFORMER[mod] + sub(rest[1:])
        m = re.fullmatch(r"(encoder|decoder|class_embed|bbox_embed)_(\d+)", mod)
        kind, i = m.group(1), m.group(2)
        if kind in ("class_embed", "bbox_embed"):
            return f"{kind}.{i}" + sub(rest[1:])
        base = f"transformer.{kind}.layers.{i}"
        part = rest[1]
        if part in ("self_attn", "cross_attn"):
            slot = 1 if part == "cross_attn" else 0
            return f"{base}.attentions.{slot}" + sub(rest[2:])
        if part == "ffn":
            return f"{base}.{_DINO_LAYER[rest[2]]}"
        return f"{base}.norms.{int(part[-1]) - 1}"  # norm1 ..
    m = re.fullmatch(r"(mask|roi)_embed_(\d+)", head)
    if m:
        name = "mask_embed" if m.group(1) == "mask" else "ROI_embed"
        return f"{name}.{m.group(2)}" + (".0" if m.group(1) == "roi" else "") + sub(rest)
    return _DINO_TOP[head]


def dino_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``DINODetector`` variables (nested dicts of numpy arrays, from
    either transformer layout) -> the port's state_dict.  A tree that holds
    only some of the detector's subtrees maps those."""
    params = dict(variables["params"])
    if "transformer" in params:
        params["transformer"] = _unstack_scanned(params["transformer"])
    n_mapped = sum(1 for k in params.get("neck", {}) if re.fullmatch(r"conv_\d+", k))
    sd: Dict[str, torch.Tensor] = {}
    mha: Dict[str, Dict[str, np.ndarray]] = {}
    for coll in (params, variables.get("batch_stats", {})):
        for path, arr in _walk(coll):
            leaf = path[-1]
            if path == ("label_enc",):
                sd["label_enc.weight"] = _tensor(leaf, arr)
            elif path[0] == "transformer" and len(path) == 2:
                name = {"tgt_embed": "tgt_embed.weight"}.get(leaf, leaf)
                sd[f"transformer.{name}"] = _tensor(leaf, arr)  # level_embeds, tgt_embed
            elif "self_attn" in path and path[1].startswith("decoder_") \
                    and path[-2] in ("q_proj", "k_proj", "v_proj"):
                base = _dino_module(path[:-2], n_mapped)
                mha.setdefault(base, {})[f"{path[-2]}.{leaf}"] = arr
            else:
                mods = tuple(s for s in path[:-1] if s != "BatchNorm_0")
                name = _dino_module(mods, n_mapped)
                if "self_attn" in path and path[1].startswith("decoder_"):
                    name = name.replace(".attentions.0.", ".attentions.0.attn.")
                sd[f"{name}.{_LEAF.get(leaf, leaf)}"] = _tensor(leaf, arr)
    for base, parts in mha.items():  # the three projections packed as torch's MHA
        sd[f"{base}.attn.in_proj_weight"] = torch.cat(
            [_tensor("kernel", parts[f"{p}_proj.kernel"]) for p in "qkv"])
        sd[f"{base}.attn.in_proj_bias"] = torch.cat(
            [_tensor("bias", parts[f"{p}_proj.bias"]) for p in "qkv"])
    for name in list(sd):
        if name.endswith("running_var") and ".norm." not in name:
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd

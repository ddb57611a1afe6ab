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

``to_flax(state_dict)`` is ``from_flax``'s inverse: the port's state_dict
(or any dict keyed by its parameter and statistic names) back as the flax
``{"params", "batch_stats"}`` tree of numpy arrays, the deep stages'
blocks restacked over pairs, f32 tensors written as f32;
``from_flax(to_flax(sd))`` gives ``sd`` back bit for bit and
``to_flax(from_flax(v))`` gives ``v``.  Each name is checked by mapping
its flax path forward again.

``dino_from_flax(variables)`` does the same for the detection stack's
``DINODetector`` (``ir_ads_tpu_torch.detection.dino``): the inverse of
``import_dino_state_dict``, from either parameter layout of the flax
transformer (unrolled, or stacked by ``scan_layers``); ``dino_to_flax`` is
its inverse.  ``anomaly_from_flax`` / ``anomaly_to_flax`` map the anomaly
stack's ``AnomalyScoreNet`` (its ResNet trunk by the detector's names).
``library_from_flax`` maps the semseg library's heads, attention modules
and backbones, the detection meta-architectures and ROI heads and the
detectron2 projects, whose port attributes carry the flax modules' names.
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
    """A flax leaf in the port's layout: a Dense kernel (in, out) as a
    Linear weight, a Conv kernel (k, in, out) / (kh, kw, in, out) as a
    Conv1d / Conv2d weight (a depthwise (k, k, 1, C) as (C, 1, k, k)); every
    other leaf as flax holds it."""
    order = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}.get(arr.ndim)
    if leaf == "kernel" and order:
        arr = arr.transpose(order)
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


# port name -> flax path, applied in order to the dotted name (the inverse of
# ``_RENAME`` and ``_module_name``); ``to_flax`` checks each result by mapping
# it forward again
_INVERSE = (
    (r"\.projection\.", ".proj."),
    (r"MLP_RGB_Adapter", "adapter_rgb"),
    (r"MLP_DTE_Adapter", "adapter_dte"),
    (r"ffn\.layers\.0\.0\.", "ffn.Dense_0."),
    (r"ffn\.layers\.1\.", "ffn.Dense_1."),
    (r"(conv_offset_[xy])\.0\.", r"\1.dw."),
    (r"(conv_offset_[xy])\.1\.norm\.", r"\1.LayerNorm_0."),
    (r"(conv_offset_[xy])\.3\.", r"\1.pw."),
    (r"fuse_q\.conv\.0\.", "fuse_q_conv."),
    (r"fuse_q\.conv\.1\.", "fuse_q_bn."),
    (r"get_sample_weight\.0\.", "sample_weight_fc1."),
    (r"get_sample_weight\.2\.", "sample_weight_fc2."),
    (r"linear_fuse\.conv\.", "linear_fuse."),
    (r"linear_fuse\.bn\.", "fuse_bn."),
    (r"(linear_c\d+)\.proj\.", r"\1."),
    (r"(stages|blocks)\.(\d+)", r"\1_\2"),
    (r"DeformMPGBlocks\.(\d+)", r"deform_mpg_\1"),
    (r"MPGBlocks\.(\d+)", r"mpg_\1"),
)
_BUFFERS = ("relative_position_index", "num_batches_tracked")  # not in the flax tree


def _port_name(path: Tuple[str, ...]) -> str:
    """The port's name of the flax leaf at ``path`` (``from_flax``'s map)."""
    names = [_module_name(seg, path[j - 1] if j else "") for j, seg in enumerate(path[:-1])]
    names.append(_RENAME.get(path[-1], _LEAF.get(path[-1], path[-1])))
    return ".".join(names)


def _flax_leaf(name: str, arr: np.ndarray) -> Tuple[str, Tuple[str, ...], np.ndarray]:
    """(collection, flax path, array in flax's layout) of one port entry."""
    module, leaf = name.rsplit(".", 1)
    dotted = module + "."
    for pattern, repl in _INVERSE:
        dotted = re.sub(pattern, repl, dotted)
    if leaf == "relative_position_bias_table":
        leaf = "rel_pos_bias_table"
    coll = "params"
    if leaf in ("running_mean", "running_var"):
        coll, leaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "weight":
        leaf = "kernel" if arr.ndim in (2, 4) else "scale"
    if leaf == "kernel":
        arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
    path = tuple(dotted.rstrip(".").split(".")) + (leaf,)
    if _port_name(path) != name:
        raise ValueError(f"to_flax: {name} maps to {'/'.join(path)}, which from_flax "
                         f"names {_port_name(path)}")
    return coll, path, arr


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's state_dict -> flax variables (nested dicts of numpy
    arrays, f32 for f32 tensors; the buffers flax does not hold are
    dropped).  A stage of depth >= 4 and even is stacked over block pairs,
    as the JAX SwinStage scans it (``stages_i/pairs/block{0,1}``)."""
    depth: Dict[str, int] = {}
    for name in state_dict:
        m = re.match(r"(.*stages\.\d+)\.blocks\.(\d+)\.", name)
        if m:
            depth[m.group(1)] = max(depth.get(m.group(1), 0), int(m.group(2)) + 1)
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    stacked: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in state_dict.items():
        if name.rsplit(".", 1)[-1] in _BUFFERS:
            continue
        t = t.detach().cpu()
        coll, path, arr = _flax_leaf(name, (t.float() if t.dtype == torch.bfloat16 else t).numpy())
        m = re.match(r"(.*stages\.\d+)\.blocks\.(\d+)\.", name)
        if m and depth[m.group(1)] >= 4 and depth[m.group(1)] % 2 == 0:
            j = int(m.group(2))
            i = path.index(f"blocks_{j}")
            key = (coll,) + path[:i] + ("pairs", f"block{j % 2}") + path[i + 1:]
            stacked.setdefault(key, {})[j // 2] = arr
            continue
        _put(out[coll], path, np.array(arr, order="C"))
    for key, parts in stacked.items():
        _put(out[key[0]], key[1:], np.stack([parts[p] for p in range(len(parts))]))
    return out


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for seg in path[:-1]:
        tree = tree.setdefault(seg, {})
    tree[path[-1]] = value


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


_DINO_TOP_INV = {v: k for k, v in _DINO_TOP.items()}
_DINO_TRANSFORMER_INV = {v: k for k, v in _DINO_TRANSFORMER.items()}
_DINO_LAYER_INV = {v: k for k, v in _DINO_LAYER.items()}


def _mlp_layers(rest: str) -> Tuple[str, ...]:
    """``layers.k`` (an MLP's layer) -> ``layer{k}``."""
    m = re.fullmatch(r"layers\.(\d+)", rest)
    return (f"layer{m.group(1)}",)


def _dino_flax_module(module: str, n_mapped: int) -> Tuple[str, ...]:
    """The flax module path of a port module path (``_dino_module``'s
    inverse); norms of the backbone end in their ``BatchNorm_0``."""
    m = re.fullmatch(r"backbone\.stem\.conv1(\.norm)?", module)
    if m:
        return ("backbone", "stem_bn", "BatchNorm_0") if m.group(1) else ("backbone", "stem_conv")
    m = re.fullmatch(r"backbone\.res(\d)\.(\d+)\.(conv(\d)|shortcut)(\.norm)?", module)
    if m:
        block = f"layer{int(m.group(1)) - 1}_{m.group(2)}"
        kind = "downsample_" if m.group(3) == "shortcut" else ""
        num = m.group(4) or ""
        if m.group(5):
            return ("backbone", block, f"{kind}bn{num}", "BatchNorm_0")
        return ("backbone", block, f"{kind}conv{num}")
    m = re.fullmatch(r"neck\.(convs|extra_convs)\.(\d+)\.(conv|gn)", module)
    if m:
        i = int(m.group(2)) + (n_mapped if m.group(1) == "extra_convs" else 0)
        return ("neck", f"{'extra_' if m.group(1) == 'extra_convs' else ''}{m.group(3)}_{i}")
    if module in _DINO_TOP_INV:
        return (_DINO_TOP_INV[module],)
    m = re.fullmatch(r"(mask_embed|ROI_embed)\.(\d+)(?:\.0)?\.(layers\.\d+)", module)
    if m:
        name = "mask_embed" if m.group(1) == "mask_embed" else "roi_embed"
        return (f"{name}_{m.group(2)}",) + _mlp_layers(m.group(3))
    m = re.fullmatch(r"class_embed\.(\d+)", module)
    if m:
        return ("transformer", f"class_embed_{m.group(1)}")
    m = re.fullmatch(r"bbox_embed\.(\d+)\.(layers\.\d+)", module)
    if m:
        return ("transformer", f"bbox_embed_{m.group(1)}") + _mlp_layers(m.group(2))
    for port, flax in _DINO_TRANSFORMER_INV.items():
        if module == port or module.startswith(port + ".layers."):
            rest = module[len(port) + 1:]
            return ("transformer", flax) + (_mlp_layers(rest) if rest else ())
    m = re.fullmatch(r"transformer\.(encoder|decoder)\.layers\.(\d+)\.(.*)", module)
    if m:
        base = ("transformer", f"{m.group(1)}_{m.group(2)}")
        part = m.group(3)
        a = re.fullmatch(r"attentions\.(\d)\.(?:attn\.)?(\w+)", part)
        if a:
            slot = "cross_attn" if a.group(1) == "1" else "self_attn"
            return base + (slot, a.group(2))
        if part in _DINO_LAYER_INV:
            return base + ("ffn", _DINO_LAYER_INV[part])
        n = re.fullmatch(r"norms\.(\d)", part)
        if n:
            return base + (f"norm{int(n.group(1)) + 1}",)
    raise ValueError(f"dino_to_flax: no flax module for {module!r}")


def dino_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's ``DINODetector`` state_dict (or any dict keyed by its
    parameter and statistic names) -> the flax ``{"params", "batch_stats"}``
    tree of the unrolled transformer layout, numpy, f32 for f32 and bf16
    tensors: ``dino_from_flax``'s inverse.  The decoder self-attention's
    packed projections are split into q_proj / k_proj / v_proj.  Each
    name is checked by mapping its flax path forward again."""
    n_mapped = len({n.split(".")[2] for n in state_dict if n.startswith("neck.convs.")})
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        module, leaf = name.rsplit(".", 1)
        if leaf in _BUFFERS:
            continue
        arr = _numpy(t)
        if name == "label_enc.weight":
            _put(out["params"], ("label_enc",), np.array(arr))
            continue
        if name in ("transformer.level_embeds", "transformer.tgt_embed.weight"):
            _put(out["params"], ("transformer", module.split(".")[1] if leaf == "weight"
                                 else leaf), np.array(arr))
            continue
        if leaf.startswith("in_proj_"):  # torch's packed MHA projections
            path = _dino_flax_module(module + ".q_proj", n_mapped)[:-1]
            kind = "kernel" if leaf == "in_proj_weight" else "bias"
            for i, part in enumerate(np.split(arr, 3)):
                _put(out["params"], path + (f"{'qkv'[i]}_proj", kind),
                     np.array(part.T if kind == "kernel" else part))
            continue
        coll, leaf, arr = _to_flax_leaf(leaf, arr)
        _put(out[coll], _dino_flax_module(module, n_mapped) + (leaf,), arr)
    back = dino_from_flax(out)
    for name in state_dict:
        if name.rsplit(".", 1)[1] not in _BUFFERS and name not in back:
            raise ValueError(f"dino_to_flax: {name} does not map back")
    return out


def _to_flax_leaf(leaf: str, arr: np.ndarray) -> Tuple[str, str, np.ndarray]:
    """(collection, flax leaf name, array in flax's layout) of a port
    parameter or statistic."""
    coll = "params"
    if leaf in ("running_mean", "running_var"):
        coll, leaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "weight":
        leaf = "kernel" if arr.ndim in (2, 4) else "scale"
    if leaf == "kernel":
        arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
    return coll, leaf, np.array(arr, order="C")


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# --------------------------------------------------------------------------
# anomaly: AnomalyScoreNet
# --------------------------------------------------------------------------

def anomaly_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``AnomalyScoreNet`` variables (nested dicts of numpy arrays) ->
    the port's state_dict: the trunk (``features``) through the detector's
    ResNet map, the head's Dense as ``score_head``; every BatchNorm's
    ``num_batches_tracked`` 0."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(coll, {})):
            leaf = path[-1]
            mods = tuple(s for s in path[:-1] if s != "BatchNorm_0")
            if mods == ("score_head",):
                name = "score_head"
            elif mods[0] == "features":
                name = "features" + _dino_module(("backbone",) + mods[1:], 0)[len("backbone"):]
            else:
                raise ValueError(f"anomaly_from_flax: no port module for {'/'.join(path)}")
            sd[f"{name}.{_LEAF.get(leaf, leaf)}"] = _tensor(leaf, arr)
    for name in list(sd):
        if name.endswith("running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def anomaly_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's ``AnomalyScoreNet`` state_dict -> the flax ``{"params",
    "batch_stats"}`` tree of numpy arrays: ``anomaly_from_flax``'s inverse."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        module, leaf = name.rsplit(".", 1)
        if leaf in _BUFFERS:
            continue
        if module == "score_head":
            path: Tuple[str, ...] = ("score_head",)
        elif module.startswith("features."):
            path = ("features",) + _dino_flax_module("backbone" + module[len("features"):], 0)[1:]
        else:
            raise ValueError(f"anomaly_to_flax: no flax module for {name!r}")
        coll, leaf, arr = _to_flax_leaf(leaf, _numpy(t))
        _put(out[coll], path + (leaf,), arr)
    return out


# --------------------------------------------------------------------------
# the semseg library: heads, attention modules, alternative backbones
# --------------------------------------------------------------------------

_RESNET_PART = re.compile(r"stem_conv|stem_bn|layer\d+_\d+")


def _library_module(mods: Tuple[str, ...]) -> str:
    """The port's module path of a flax module path: joined by dots, but a
    ResNet (a ``backbone`` whose child is ``stem_*`` or ``layer{i}_{j}``, the
    detection meta-architectures') under the detector's names
    (``_dino_module``: ``backbone.res2.0.conv1.norm`` ...)."""
    for i in range(1, len(mods)):
        if mods[i - 1] == "backbone" and _RESNET_PART.fullmatch(mods[i]):
            rest = tuple(m for m in mods[i:] if m != "BatchNorm_0")
            return ".".join(mods[:i - 1] + (_dino_module(("backbone",) + rest, 0),))
    return ".".join(mods)


def library_from_flax(variables: Dict, module: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """flax variables of a module of the semseg library (models/heads/
    {extra,align}_heads.py, models/modules/attention_modules.py,
    models/backbones/{regnet,alt_backbones}.py, models/projects/{vitdet,
    mvit}.py), of a detection meta-architecture or ROI head (detection/
    {meta_arch,roi_heads}.py), of a detectron2 project (models/projects/*)
    -> the port module's state_dict: the flax path joined by dots (a
    ResNet ``backbone`` by the detector's names, ``_library_module``),
    ``kernel`` / ``scale`` as ``weight`` (``_tensor``; ``pos_embed``,
    ``rel_pos_*``, ``gamma``, ``layer_scale_*`` and FaPN's ``dcn_kernel``
    as flax holds them), the batch statistics as ``running_mean`` /
    ``running_var``.  With ``module`` the
    buffers flax does not hold (``num_batches_tracked``) come from it, and a
    name on either side alone raises."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(coll, {})):
            leaf = path[-1]
            name = ".".join(filter(None, (_library_module(path[:-1]), _LEAF.get(leaf, leaf))))
            sd[name] = _tensor(leaf, arr)
    if module is not None:
        own = module.state_dict()
        for name, t in own.items():
            if name not in sd and name.endswith("num_batches_tracked"):
                sd[name] = t.clone()
        missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
        if missing or extra:
            raise ValueError(f"library_from_flax: port names without a flax leaf {missing}, "
                             f"flax leaves without a port name {extra}")
    return sd

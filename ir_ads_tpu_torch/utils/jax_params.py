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

"""Reference PyTorch checkpoints into the port: the CMNeXt half of
ir_ads_tpu/utils/torch_import.py.

The port's module and parameter names are the reference checkpoint's
(semseg/models/cmnext.py with backbones/swin.py), in torch's layouts, so a
reference state_dict maps onto the port's by name: no transposes.  What is
left is the surgery the JAX importer does:

  ``import_cmnext_state_dict``: a full IR-ADS CMNeXt state_dict, its
    backbone keys with or without the ``backbone.`` prefix;
  ``import_pretrained_swin``: a raw upstream (mmseg-format) Swin
    checkpoint, with the reference's weight surgery (train_mm.py:59-81):
    ``backbone.`` / ``module.`` prefixes stripped, the relative-position
    bias tables resized to the model's window (``_resize_bias_table``),
    and the RGB stream's patch embedding and output norms copied into the
    extra (DTE) stream's.

Both take the target model's state_dict and return (the new state_dict,
warnings), with ``load_state_dict(strict=False)`` semantics: a key the
checkpoint lacks keeps the target's value, a key of another shape keeps it
too and is warned about, and so is a checkpoint key the model has no place
for.  As in the JAX importer, only parameters and BatchNorm running
statistics are imported; the buffers the port computes itself
(``relative_position_index``, ``num_batches_tracked``) are not.

The JAX importer resizes a bias table with ``jax.image.resize(...,
method="bicubic")``: Keys' cubic with a = -0.5, half-pixel centres, the
weights renormalised over the taps inside the table, and, when it shrinks,
the kernel widened by the shrink factor (antialiased).  ``F.interpolate(
mode="bicubic")`` takes a = -0.75, clamps at the borders and does not
antialias, so the resize is written out here to JAX's definition.

``import_dino_state_dict``: the DINO half, a reference vCLR-DINO
state_dict onto the port's ``DINODetector``.  It reads the keys the JAX
importer reads (the d2 ResNet-50's res2-res5 at 3/4/6/3 blocks, neck convs
0-7, encoder and decoder layers 0-11, heads 0-7), with the same warnings in
the port's names, and raises the same KeyError where a module it reads
lacks a tensor (a norm's bias, a BatchNorm's statistics).  The decoder
self-attention's packed ``in_proj`` is taken as its q, k and v thirds, each
held to the target's third (``name[q]``, ``[k]``, ``[v]`` in a warning), as
the JAX importer splits it into three projections.  Extra neck convs land
at the level after the checkpoint's mapped ones, counted in the target.
JAX's ``stack_`` / ``unstack_encoder_layers`` and the decoder forms convert
between flax's unrolled and scanned (``scan_layers``) layouts; the port has
one layout and ``jax_params.dino_from_flax`` unstacks a scanned tree, so
they need no counterpart.

Works on tensors or numpy arrays: ``torch.load`` a .pth and pass its
state_dict.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
# buffers the port computes itself: never imported, never warned about
COMPUTED = ("relative_position_index", "num_batches_tracked")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's), in x's
    dtype."""
    x = np.abs(x)
    one, two = x.dtype.type(1.0), x.dtype.type(2.0)
    out = ((x.dtype.type(1.5) * x - x.dtype.type(2.5)) * x) * x + one
    out = np.where(x >= one, ((x.dtype.type(-0.5) * x + x.dtype.type(2.5)) * x
                              - x.dtype.type(4.0)) * x + two, out)
    return np.where(x >= two, x.dtype.type(0.0), out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of one axis of jax.image.resize's bicubic
    (``scale_and_translate`` with no translation, antialiased), in its f32
    steps: half-pixel sample positions, the kernel widened by 1 / scale when
    it shrinks, each column renormalised to sum to 1, and columns whose
    sample lies outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # the Python scale, inverted in f64
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0))


def _resize_bias_table(table, target_len: int) -> np.ndarray:
    """Bicubic-resize a ((2w-1)^2, heads) bias table to another window
    size (reference swin.py:1396-1418), as jax.image.resize does it: the
    module docstring.  Returns f32 numpy."""
    table = np.asarray(table, dtype=np.float64)
    l1, nh = table.shape
    s1 = int(round(l1 ** 0.5))
    s2 = int(round(target_len ** 0.5))
    if s1 * s1 != l1 or s2 * s2 != target_len:
        raise ValueError(f"non-square bias table {l1} -> {target_len}")
    w = _resize_weights(s1, s2).astype(np.float64)  # the products summed in f64
    out = np.einsum("ijc,ia,jb->abc", table.reshape(s1, s1, nh), w, w)
    return out.reshape(target_len, nh).astype(np.float32)


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def import_cmnext_state_dict(sd: Mapping, target: StateDict) -> Tuple[StateDict, List[str]]:
    """A full IR-ADS CMNeXt state_dict onto ``target`` (the port model's
    state_dict).  Returns (the new state_dict, warnings): the module
    docstring's semantics."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    pre = "backbone." if any(k.startswith("backbone.") for k in sd) else ""
    heads = ("decode_head.", "decode_head_rgb.", "decode_head_dte.")
    out = {k: v.clone() for k, v in target.items()}
    warnings: List[str] = []
    for key, value in sd.items():
        if key.endswith(COMPUTED):
            continue
        if key.startswith(heads):
            name = key
        elif pre and not key.startswith(pre):
            name = None  # neither the backbone nor a head
        else:
            name = "backbone." + key[len(pre):]
        if name not in out:
            warnings.append(f"no param {key}")
        elif tuple(out[name].shape) != tuple(value.shape):
            warnings.append(f"shape mismatch {name}: {tuple(out[name].shape)} vs "
                            f"{tuple(value.shape)}")
        else:
            out[name] = value.to(out[name].dtype).clone()
    return out, warnings


def import_pretrained_swin(sd: Mapping, target: StateDict,
                           window_size: int = 12) -> Tuple[StateDict, List[str]]:
    """An upstream (mmseg-format) Swin checkpoint onto ``target``'s
    backbone, with the reference's weight surgery: the module docstring."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    sd = {(k[9:] if k.startswith("backbone.") else k): v for k, v in sd.items()}
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    target_len = (2 * window_size - 1) ** 2
    for k in list(sd):
        if "relative_position_bias_table" in k and sd[k].shape[0] != target_len:
            sd[k] = torch.from_numpy(_resize_bias_table(sd[k].float().numpy(), target_len))
    extra = {}
    for k, v in sd.items():
        if k.startswith("patch_embed."):
            extra["extra_" + k] = v
        if re.match(r"norm\d+\.", k) or k.startswith("norm."):
            extra["extra_" + k] = v
    sd.update(extra)
    return import_cmnext_state_dict({"backbone." + k: v for k, v in sd.items()}, target)


def import_dino_state_dict(target: StateDict, sd: Mapping) -> Tuple[StateDict, List[str]]:
    """A reference vCLR-DINO state_dict (projects/.../modeling/dino.py over
    detrex layers) onto ``target`` (the port ``DINODetector``'s
    state_dict).  Returns (the new state_dict, warnings): the module
    docstring's semantics."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    out = {k: v.clone() for k, v in target.items()}
    warnings: List[str] = []

    def assign(name: str, value: torch.Tensor, part: int = -1) -> None:
        label = name if part < 0 else f"{name}[{'qkv'[part]}]"
        if name not in out:
            warnings.append(f"no param {label}")
            return
        dst = out[name]
        if part >= 0:
            n = dst.shape[0] // 3
            dst = dst[part * n: (part + 1) * n]
        if tuple(dst.shape) != tuple(value.shape):
            warnings.append(f"shape mismatch {label}: {tuple(dst.shape)} vs "
                            f"{tuple(value.shape)}")
        else:
            dst.copy_(value.to(dst.dtype))

    def linear(prefix: str, name: str = "") -> None:  # also a conv: bias if present
        name = name or prefix
        assign(f"{name}.weight", sd[f"{prefix}.weight"])
        if f"{prefix}.bias" in sd:
            assign(f"{name}.bias", sd[f"{prefix}.bias"])

    def norm(prefix: str, name: str = "",
             leaves: Tuple[str, ...] = ("weight", "bias")) -> None:
        for k in leaves:
            assign(f"{name or prefix}.{k}", sd[f"{prefix}.{k}"])

    def batch_norm(prefix: str) -> None:
        norm(prefix, leaves=("weight", "bias", "running_mean", "running_var"))

    def conv_norm(prefix: str) -> None:  # d2 Conv2d with its FrozenBN as .norm
        assign(f"{prefix}.weight", sd[f"{prefix}.weight"])
        batch_norm(f"{prefix}.norm")

    def msdeform(prefix: str) -> None:
        for sub in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            linear(f"{prefix}.{sub}")

    def torch_mha(prefix: str) -> None:  # packed qkv, taken a third at a time
        w, b = sd[f"{prefix}.attn.in_proj_weight"], sd[f"{prefix}.attn.in_proj_bias"]
        c = w.shape[1]
        for i in range(3):
            assign(f"{prefix}.attn.in_proj_weight", w[i * c: (i + 1) * c], i)
            assign(f"{prefix}.attn.in_proj_bias", b[i * c: (i + 1) * c], i)
        linear(f"{prefix}.attn.out_proj")

    def mlp(prefix: str, n: int = 3) -> None:
        for i in range(n):
            linear(f"{prefix}.layers.{i}")

    # d2 ResNet-50 backbone (stem + res2..5 bottlenecks)
    if "backbone.stem.conv1.weight" in sd:
        conv_norm("backbone.stem.conv1")
        for res, n_blocks in {2: 3, 3: 4, 4: 6, 5: 3}.items():
            for j in range(n_blocks):
                base = f"backbone.res{res}.{j}"
                if f"{base}.conv1.weight" not in sd:
                    continue
                for ci in (1, 2, 3):
                    conv_norm(f"{base}.conv{ci}")
                if f"{base}.shortcut.weight" in sd:
                    conv_norm(f"{base}.shortcut")

    # neck (ChannelMapper): extra convs continue the checkpoint's level index
    n_ref = len([k for k in sd if k.startswith("neck.convs.") and k.endswith(".conv.weight")])
    n_target = len({k.split(".")[2] for k in out if k.startswith("neck.convs.")})
    for i in range(8):
        if f"neck.convs.{i}.conv.weight" in sd:
            linear(f"neck.convs.{i}.conv")
            norm(f"neck.convs.{i}.gn")
        if f"neck.extra_convs.{i}.conv.weight" in sd:
            j = n_ref + i - n_target
            linear(f"neck.extra_convs.{i}.conv", f"neck.extra_convs.{j}.conv")
            norm(f"neck.extra_convs.{i}.gn", f"neck.extra_convs.{j}.gn")

    tr = "transformer"
    if f"{tr}.level_embeds" in sd:
        assign(f"{tr}.level_embeds", sd[f"{tr}.level_embeds"])
    if f"{tr}.tgt_embed.weight" in sd:
        assign(f"{tr}.tgt_embed.weight", sd[f"{tr}.tgt_embed.weight"])
    if f"{tr}.enc_output.weight" in sd:
        linear(f"{tr}.enc_output")
        norm(f"{tr}.enc_output_norm")
    if "label_enc.weight" in sd:
        assign("label_enc.weight", sd["label_enc.weight"])

    # encoder layers: attentions.0 = MSDeformAttn; norms.{0,1}; ffns.0
    for i in range(12):
        base = f"{tr}.encoder.layers.{i}"
        if f"{base}.attentions.0.sampling_offsets.weight" not in sd:
            continue
        msdeform(f"{base}.attentions.0")
        norm(f"{base}.norms.0")
        norm(f"{base}.norms.1")
        linear(f"{base}.ffns.0.layers.0.0")
        linear(f"{base}.ffns.0.layers.1")

    # decoder layers: attentions.0 = packed-qkv MHA, attentions.1 = MSDeformAttn
    for i in range(12):
        base = f"{tr}.decoder.layers.{i}"
        if f"{base}.attentions.0.attn.in_proj_weight" in sd:
            torch_mha(f"{base}.attentions.0")
        if f"{base}.attentions.1.sampling_offsets.weight" in sd:
            msdeform(f"{base}.attentions.1")
        for k in range(3):
            if f"{base}.norms.{k}.weight" in sd:
                norm(f"{base}.norms.{k}")
        if f"{base}.ffns.0.layers.0.0.weight" in sd:
            linear(f"{base}.ffns.0.layers.0.0")
            linear(f"{base}.ffns.0.layers.1")

    if f"{tr}.decoder.ref_point_head.layers.0.weight" in sd:
        mlp(f"{tr}.decoder.ref_point_head", 2)
    if f"{tr}.decoder.norm.weight" in sd:
        norm(f"{tr}.decoder.norm")

    # shared heads (the class_embed / bbox_embed ModuleLists, dino.py:218-231)
    for i in range(8):
        if f"class_embed.{i}.weight" in sd:
            linear(f"class_embed.{i}")
        if f"bbox_embed.{i}.layers.0.weight" in sd:
            mlp(f"bbox_embed.{i}")
        if f"mask_embed.{i}.layers.0.weight" in sd:
            mlp(f"mask_embed.{i}")
        if f"ROI_embed.{i}.0.layers.0.weight" in sd:
            mlp(f"ROI_embed.{i}.0")

    # fused-FPN seg mapping (dino.py:256-262)
    if "mapping_fpn_features_for_seg.0.weight" in sd:
        linear("mapping_fpn_features_for_seg.0")
        batch_norm("mapping_fpn_features_for_seg.1")
        linear("mapping_fpn_features_for_seg.3")
        norm("post_layernorm")

    return out, warnings

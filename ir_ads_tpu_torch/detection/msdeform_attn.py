"""Multi-scale deformable attention module: counterpart of
ir_ads_tpu/detection/msdeform_attn.py ``MSDeformAttention`` (detrex
MultiScaleDeformableAttention, batch-first).  The sampling itself is K9
(ops/msdeform.py).  The JAX package's other formulations of the sampling
(``xla2`` ... ``xla5``) are lowerings of the same function for the TPU
compiler; the port has the one kernel, whose wrapper takes its plain version
for CPU tensors only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import with_bias
from ir_ads_tpu_torch.ops.msdeform import ms_deform_attn


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` as flax's ``nn.Dense`` computes it in its parameters' dtype: an
    input of another dtype is cast to it, as a flax layer with ``dtype`` set
    casts its input, and the bias is added to the rounded product
    (``ops.layers.with_bias``)."""
    return with_bias(F.linear(x.to(lin.weight.dtype), lin.weight), lin.bias)


def offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Directional point-spread bias of ``sampling_offsets``."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (heads, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


@functools.lru_cache(maxsize=8)
def _level_sizes(spatial_shapes, device: torch.device) -> torch.Tensor:
    """(levels, 2) f32 as (w, h), copied to ``device`` once per shape set."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=device)


class MSDeformAttention(nn.Module):
    """query (B, Lq, C), value (B, sum(h*w), C), reference_points (B, Lq,
    levels, 2 or 4) in [0, 1] -> identity + output_proj(sampled)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, n * 2)
        self.attention_weights = nn.Linear(embed_dim, n)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)
        with torch.no_grad():  # the reference's init: every query samples one pattern
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                offset_bias_init(num_heads, num_levels, num_points)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,
        value: torch.Tensor,
        reference_points: torch.Tensor,
        spatial_shapes: Sequence[Tuple[int, int]],
        identity: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, sum(h*w)) True = pad
    ) -> torch.Tensor:
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        b, lq, _ = query.shape
        heads, levels, points = self.num_heads, self.num_levels, self.num_points

        v = dense(value, self.value_proj)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        v = v.reshape(b, value.shape[1], heads, self.embed_dim // heads)

        offsets = dense(query, self.sampling_offsets).reshape(b, lq, heads, levels, points, 2)
        weights = dense(query, self.attention_weights).reshape(b, lq, heads, levels * points)
        # softmax over all levels and points in f32, then back
        weights = torch.softmax(weights.float(), -1).to(query.dtype)
        weights = weights.reshape(b, lq, heads, levels, points)

        # the references are f32, so the locations are f32 whatever the
        # compute dtype
        if reference_points.shape[-1] == 2:
            normalizer = _level_sizes(tuple(map(tuple, spatial_shapes)), query.device)
            locations = (reference_points[:, :, None, :, None, :]
                         + offsets / normalizer[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            locations = (reference_points[:, :, None, :, None, :2]
                         + offsets / points
                         * reference_points[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(v, spatial_shapes, locations, weights)
        return identity + dense(out, self.output_proj)

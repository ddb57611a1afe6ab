"""Conditional DETR attention and the learned position embedding:
counterpart of ir_ads_tpu/detection/conditional_attn.py
(``ConditionalSelfAttention``, ``ConditionalCrossAttention``,
``PositionEmbeddingLearned``; reference detrex/layers/attention.py and
position_embedding.py), for the DAB / Conditional-DETR family.  No driver
of the port builds them; they are here for the detrex surface.

Each flax ``Dense`` is an ``nn.Linear`` of the same name, so
``utils.jax_params.from_flax`` carries a flax tree over (a ``kernel``
becomes the transposed ``weight``), and ``PositionEmbeddingLearned``'s
``row_embed`` and ``col_embed`` are parameters of the flax shapes.  The
arithmetic is the JAX modules': the products as flax computes them
(``ops.layers.linear``), scores of the query scaled by the head scale
rounded to its dtype, summed in f32, an f32 softmax, the probabilities
cast to the value dtype and P.V summed in f32.  Layouts (B, N, C).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ir_ads_tpu_torch.ops.layers import linear, q_scale


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, n_heads, c // n_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((q * scale) k^T) v over (B, heads, N, d) heads, the scores
    and softmax in f32; ``attn_mask`` (Nq, Nk) bool, True = masked."""
    attn = (q * q_scale(scale, q.dtype)).float() @ k.float().transpose(-1, -2)
    if attn_mask is not None:
        attn = attn.masked_fill(attn_mask[None, None], -1e9)
    attn = torch.softmax(attn, -1)
    return (attn.to(v.dtype).float() @ v.float()).to(v.dtype)


class ConditionalSelfAttention(nn.Module):
    """Content and position projected separately, then added (the
    conditional DETR decoder's self-attention)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        for name in ("query_content_proj", "query_pos_proj", "key_content_proj",
                     "key_pos_proj", "value_proj", "out_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim))

    def forward(self, query: torch.Tensor, query_pos: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        if identity is None:
            identity = query
        nh = self.num_heads
        q = linear(query, self.query_content_proj) + linear(query_pos, self.query_pos_proj)
        k = linear(query, self.key_content_proj) + linear(query_pos, self.key_pos_proj)
        v = linear(query, self.value_proj)
        out = _attend(_heads(q, nh), _heads(k, nh), _heads(v, nh),
                      (self.embed_dim // nh) ** -0.5, attn_mask)
        return identity + linear(_merge(out), self.out_proj)


class ConditionalCrossAttention(nn.Module):
    """The decoder's cross-attention, content and spatial similarities in
    one head space of 2d channels (conditional DETR).  ``query_pos_proj``
    enters the first layer only (``is_first_layer``); the flax module
    creates it only where it is called so, and a tree without it loads with
    ``strict=False``."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        for name in ("query_content_proj", "key_content_proj", "value_proj", "key_pos_proj",
                     "query_pos_proj", "query_pos_sine_proj", "out_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim))

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                query_pos: torch.Tensor, key_pos: torch.Tensor,
                query_sine_embed: torch.Tensor, is_first_layer: bool = False,
                identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        if identity is None:
            identity = query
        nh = self.num_heads
        qc = linear(query, self.query_content_proj)
        kc = linear(key, self.key_content_proj)
        v = linear(value, self.value_proj)
        kp = linear(key_pos, self.key_pos_proj)
        if is_first_layer:
            qc = qc + linear(query_pos, self.query_pos_proj)
            kc = kc + kp
        qs = linear(query_sine_embed, self.query_pos_sine_proj)
        # content and spatial parts side by side in each head: 2d channels
        q = torch.cat([_heads(qc, nh), _heads(qs, nh)], dim=-1)
        k = torch.cat([_heads(kc, nh), _heads(kp, nh)], dim=-1)
        out = _attend(q, k, _heads(v, nh), (2 * (self.embed_dim // nh)) ** -0.5)
        return identity + linear(_merge(out), self.out_proj)


class PositionEmbeddingLearned(nn.Module):
    """Learned row and column embeddings (detrex position_embedding.py),
    initialised uniform in [0, 1) as flax's ``uniform(1.0)``."""

    def __init__(self, num_pos_feats: int = 256, max_size: int = 50):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = nn.Parameter(torch.rand(max_size, num_pos_feats // 2))
        self.col_embed = nn.Parameter(torch.rand(max_size, num_pos_feats // 2))

    def forward(self, h: int, w: int) -> torch.Tensor:
        """(h, w, num_pos_feats): the column's embedding, then the row's."""
        half = self.num_pos_feats // 2
        x = self.col_embed[None, :w].expand(h, w, half)
        y = self.row_embed[:h, None].expand(h, w, half)
        return torch.cat([x, y], dim=-1)

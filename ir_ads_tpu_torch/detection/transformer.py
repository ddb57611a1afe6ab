"""DINO deformable transformer (two-stage, box-refining): counterpart of
ir_ads_tpu/detection/transformer.py.

Parameter names are the reference checkpoint's (``encoder.layers.i.
attentions.0`` ..., ``decoder.layers.i.attentions.{0,1}``, ``decoder.
ref_point_head``, ``decoder.norm``).  The class and box heads belong to the
detector there (``class_embed.i``, ``bbox_embed.i``, index L = the encoder
stage's) and are handed to ``forward``.  The JAX package's ``scan_layers``
and ``use_remat`` are compile structure for XLA: here the layers are a loop.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.msdeform_attn import MSDeformAttention, dense
from ir_ads_tpu_torch.ops.layers import LayerNorm, q_scale, with_bias

NORM_EPS = 1e-6  # flax's LayerNorm default, which the JAX modules keep


def layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=NORM_EPS)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 128,
                       temperature: int = 10000, exchange_xy: bool = True) -> torch.Tensor:
    """(..., K) -> (..., K * num_pos_feats), in f32."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def embed(x):
        x = x * scale / dim_t
        return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], -1).flatten(-2)

    parts = [embed(pos[..., i:i + 1]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, -1)


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: int = 10000, offset: float = -0.5,
                            normalize: bool = True) -> np.ndarray:
    """2-D sine position embedding of an unpadded (h, w) map, (h, w,
    2 * num_pos_feats), a constant of the shape."""
    y = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x = np.cumsum(np.ones((h, w), np.float32), axis=1)
    if normalize:
        eps = 1e-6
        y = (y + offset) / (y[-1:, :] + eps) * 2 * math.pi
        x = (x + offset) / (x[:, -1:] + eps) * 2 * math.pi
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * np.floor(dim_t / 2) / num_pos_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], -1)
    return np.concatenate([pos_y.reshape(h, w, -1), pos_x.reshape(h, w, -1)], axis=-1)


def make_encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Per-token per-level normalized reference points (sum h*w, levels, 2)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, axis=0)
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))


def make_output_proposals(
        spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Initial proposal boxes per token: (unsigmoided (sum h*w, 4) with inf
    at invalid tokens, valid (sum h*w,))."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        grid = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        props.append(np.concatenate([grid, np.full_like(grid, 0.05 * (2.0 ** lvl))], -1))
    proposals = np.concatenate(props, axis=0)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
    logit = np.log(proposals / (1 - proposals))
    logit[~valid] = np.inf
    return logit, valid


@functools.lru_cache(maxsize=8)  # 20 MB on the device per 800x1216 shape set
def _shape_constants(spatial_shapes, c: int, device: torch.device):
    """The constants of one set of level shapes, on ``device``: sine position
    embedding (sum h*w, C), encoder reference points and proposals in f32,
    the proposals' validity, each token's level."""
    pos = np.concatenate([position_embedding_sine(h, w, c // 2).reshape(h * w, c)
                          for h, w in spatial_shapes])
    proposals, valid = make_output_proposals(spatial_shapes)
    level = np.repeat(np.arange(len(spatial_shapes)), [h * w for h, w in spatial_shapes])
    arrays = (pos, make_encoder_reference_points(spatial_shapes), proposals, valid, level)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def top_k(scores: torch.Tensor, k: int):
    """The k largest along the last axis in descending order, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` leaves ties open)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class MLP(nn.Module):
    """ReLU MLP (``layers.i``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = F.relu(dense(x, lin))
        return dense(x, self.layers[-1])


class _PackedProjections(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention``: q, k, v packed."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class MultiheadAttention(nn.Module):
    """Standard attention where query_pos / key_pos are added to q and k
    only.  Scores and softmax in f32 from ``q * head_dim**-0.5`` rounded to
    the compute dtype, the scale itself first rounded to it (``q_scale``);
    probabilities cast to the value dtype."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.attn = _PackedProjections(embed_dim)

    def forward(self, query, key=None, value=None, identity=None, query_pos=None,
                key_pos=None, attn_mask=None):
        if key is None:
            key = query
        if value is None:
            value = key
        if identity is None:
            identity = query
        if key_pos is None and query_pos is not None and key.shape == query.shape:
            key_pos = query_pos
        q = query + query_pos if query_pos is not None else query
        k = key + key_pos if key_pos is not None else key
        b, lq, c = q.shape
        hd = c // self.num_heads
        w, bias = self.attn.in_proj_weight, self.attn.in_proj_bias

        def split(t, i):
            t = with_bias(F.linear(t.to(w.dtype), w[i * c:(i + 1) * c]), bias[i * c:(i + 1) * c])
            return t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        qh, kh, vh = split(q, 0), split(k, 1), split(value, 2)
        # f32 scores of the rounded operands (their products are exact in f32);
        # q scaled by the scale rounded to q's dtype, as JAX's weak typing does
        attn = (qh * q_scale(hd ** -0.5, qh.dtype)).float() @ kh.float().transpose(-1, -2)
        if attn_mask is not None:  # True = masked
            attn = attn.masked_fill(attn_mask[None, None], -1e9)
        attn = torch.softmax(attn, -1)
        out = attn.to(vh.dtype) @ vh
        out = out.transpose(1, 2).reshape(b, lq, c)
        return identity + dense(out, self.attn.out_proj)


class FFN(nn.Module):
    """x + fc2(relu(fc1 x)), mmcv names ``layers.0.0`` and ``layers.1``."""

    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Sequential(nn.Linear(dim, ffn_dim)), nn.Linear(ffn_dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + dense(F.relu(dense(x, self.layers[0][0])), self.layers[1])


class EncoderLayer(nn.Module):
    """self_attn (MSDeform) -> norm -> ffn -> norm."""

    def __init__(self, embed_dim, num_heads, ffn_dim, num_levels):
        super().__init__()
        self.attentions = nn.ModuleList(
            [MSDeformAttention(embed_dim, num_heads, num_levels)])
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim)])
        self.norms = nn.ModuleList([layer_norm(embed_dim) for _ in range(2)])

    def forward(self, x, query_pos, reference_points, spatial_shapes,
                key_padding_mask=None):
        x = self.attentions[0](x, x, reference_points, spatial_shapes,
                               query_pos=query_pos, key_padding_mask=key_padding_mask)
        x = self.norms[0](x)
        return self.norms[1](self.ffns[0](x))


class DecoderLayer(nn.Module):
    """self_attn -> norm -> cross_attn (MSDeform) -> norm -> ffn -> norm."""

    def __init__(self, embed_dim, num_heads, ffn_dim, num_levels):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dim, num_heads),
            MSDeformAttention(embed_dim, num_heads, num_levels)])
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim)])
        self.norms = nn.ModuleList([layer_norm(embed_dim) for _ in range(3)])

    def forward(self, x, memory, query_pos, reference_points, spatial_shapes,
                attn_mask=None, key_padding_mask=None):
        x = self.attentions[0](x, query_pos=query_pos, attn_mask=attn_mask)
        x = self.norms[0](x)
        x = self.attentions[1](x, memory, reference_points, spatial_shapes,
                               query_pos=query_pos, key_padding_mask=key_padding_mask)
        x = self.norms[1](x)
        return self.norms[2](self.ffns[0](x))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Decoder(nn.Module):
    def __init__(self, layers, embed_dim):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.ref_point_head = MLP(2 * embed_dim, embed_dim, embed_dim, 2)
        self.norm = layer_norm(embed_dim)


class DINOTransformer(nn.Module):
    """Encoder + two-stage proposal selection + box-refining decoder.

    ``forward(feats, class_embed, bbox_embed, ...)`` takes the NHWC level
    maps and the detector's heads (L decoder layers' and, last, the encoder
    stage's) and returns the JAX module's dict: hidden_states (L, B, Q, C)
    post-norm, references (L, B, Q, 4) look-forward-twice, init_reference,
    enc_class / enc_coord / enc_state of the selected proposals, memory,
    pred_logits, pred_boxes (from the normed state), spatial_shapes; and
    the selection itself, the encoder-stage scores and the selected token
    indices (``enc_scores``, ``topk_idx``), which the detector does not pass
    on.
    """

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, ffn_dim: int = 2048,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 num_levels: int = 4, num_queries: int = 900,
                 learnt_init_query: bool = True):
        super().__init__()
        self.embed_dim, self.num_levels = embed_dim, num_levels
        self.num_queries, self.learnt_init_query = num_queries, learnt_init_query
        args = (embed_dim, num_heads, ffn_dim, num_levels)
        self.encoder = _Encoder(EncoderLayer(*args) for _ in range(num_encoder_layers))
        self.decoder = _Decoder((DecoderLayer(*args) for _ in range(num_decoder_layers)),
                                embed_dim)
        self.level_embeds = nn.Parameter(torch.randn(num_levels, embed_dim))
        self.enc_output = nn.Linear(embed_dim, embed_dim)
        self.enc_output_norm = layer_norm(embed_dim)
        if learnt_init_query:
            self.tgt_embed = nn.Embedding(num_queries, embed_dim)
            nn.init.xavier_uniform_(self.tgt_embed.weight)

    def forward(
        self,
        feats: Sequence[torch.Tensor],  # (B, H, W, C) per level
        class_embed: Sequence[nn.Module],
        bbox_embed: Sequence[nn.Module],
        dn_queries: Optional[torch.Tensor] = None,  # (B, n_dn, C)
        dn_refs: Optional[torch.Tensor] = None,     # (B, n_dn, 4) unsigmoided
        attn_mask: Optional[torch.Tensor] = None,   # (Q_total, Q_total) True = mask
    ) -> Dict[str, torch.Tensor]:
        b, c = feats[0].shape[0], self.embed_dim
        dtype = feats[0].dtype
        spatial_shapes = tuple((f.shape[1], f.shape[2]) for f in feats)
        pos, enc_ref, proposals, valid, level = _shape_constants(
            spatial_shapes, c, feats[0].device)

        memory = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1)
        pos_embed = (pos.to(dtype) + self.level_embeds.to(dtype)[level])[None].expand(b, -1, -1)
        enc_ref = enc_ref[None].expand(b, -1, -1, -1)  # f32

        for layer in self.encoder.layers:
            memory = layer(memory, pos_embed, enc_ref, spatial_shapes)

        # two-stage proposals
        nl = len(self.decoder.layers)
        output_memory = torch.where(valid[None, :, None], memory, torch.zeros_like(memory))
        output_memory = self.enc_output_norm(dense(output_memory, self.enc_output))
        enc_class = dense(output_memory, class_embed[nl])  # (B, S, classes)
        enc_coord_unact = bbox_embed[nl](output_memory) + proposals[None]  # f32

        scores = enc_class.amax(-1).masked_fill(~valid[None], -torch.inf)
        topk_idx = top_k(scores, self.num_queries)[1]  # (B, K)

        def take(t):
            return torch.gather(t, 1, topk_idx[..., None].expand(-1, -1, t.shape[-1]))

        topk_coords_unact = take(enc_coord_unact)
        topk_class = take(enc_class)
        reference = topk_coords_unact.detach().sigmoid()
        target_unact = take(output_memory)
        if self.learnt_init_query:
            target = self.tgt_embed.weight[None].to(dtype).expand(b, -1, -1)
        else:
            target = target_unact.detach()
        if dn_queries is not None:
            target = torch.cat([dn_queries, target], dim=1)
            reference = torch.cat([dn_refs.sigmoid(), reference], dim=1)
        init_reference = reference

        hidden_states, references, pred_boxes = [], [], []
        x = target
        for i, layer in enumerate(self.decoder.layers):
            ref_input = reference[:, :, None, :].expand(-1, -1, self.num_levels, -1)
            query_pos = self.decoder.ref_point_head(get_sine_pos_embed(reference, c // 2))
            x = layer(x, memory, query_pos, ref_input, spatial_shapes, attn_mask)
            # the box delta on the raw layer output drives the refinement; the
            # reported boxes come from the normed state against the incoming
            # reference
            ref_unact = inverse_sigmoid(reference)
            new_reference = (bbox_embed[i](x) + ref_unact).sigmoid()
            normed = self.decoder.norm(x)
            pred_boxes.append((bbox_embed[i](normed) + ref_unact).sigmoid())
            hidden_states.append(normed)
            references.append(new_reference)  # look forward twice
            reference = new_reference.detach()

        return {
            "hidden_states": torch.stack(hidden_states),
            "references": torch.stack(references),
            "init_reference": init_reference,
            "enc_class": topk_class,
            "enc_coord": topk_coords_unact.sigmoid(),
            "enc_state": target_unact,
            "memory": memory,
            "pred_logits": torch.stack(
                [dense(h, class_embed[i]) for i, h in enumerate(hidden_states)]),
            "pred_boxes": torch.stack(pred_boxes),
            "spatial_shapes": spatial_shapes,
            "enc_scores": scores,
            "topk_idx": topk_idx,
        }

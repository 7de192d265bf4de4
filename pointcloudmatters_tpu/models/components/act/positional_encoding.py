"""Positional embeddings for ACT observation tokens.

Counterparts of reference `act/positional_encoding.py:14-92` and
the 3D point embedding `act/act.py:467-506`. Feature maps are NHWC (the
conv layout); embeddings are returned token-last ``(..., D)`` so they add
directly onto batch-first token sequences.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from pointcloudmatters_tpu import nn


def _sine_embed_1d(values: jax.Array, num_feats: int, temperature: float) -> jax.Array:
    """(…,) scalar positions -> (…, num_feats) interleaved sin/cos."""
    idx = jnp.arange(num_feats, dtype=jnp.float32)
    dim_t = temperature ** (2 * jnp.floor(idx / 2) / num_feats)
    pos = values[..., None] / dim_t
    # even slots take sin, odd slots cos — same layout the reference builds by
    # stack-interleaving (`positional_encoding.py:50-56`), but shape-agnostic
    return jnp.where(idx % 2 == 0, jnp.sin(pos), jnp.cos(pos))


class PositionEmbeddingSine(nn.Module):
    """2D sine embedding over an NHWC feature map -> (1, H*W, 2*num_pos_feats).

    Matches reference semantics (`positional_encoding.py:33-59`): row/col
    positions are 1-based cumsums, optionally normalized to ``scale``; channel
    order is (y-embed, x-embed).
    """

    num_pos_feats: int = 64
    temperature: float = 10000.0
    normalize: bool = False
    scale: Optional[float] = None

    def __call__(self, feature_map: jax.Array) -> jax.Array:
        if self.scale is not None and not self.normalize:
            raise ValueError("normalize should be True if scale is passed")
        scale = self.scale if self.scale is not None else 2 * math.pi
        H, W = feature_map.shape[-3], feature_map.shape[-2]
        y = jnp.arange(1, H + 1, dtype=jnp.float32)[:, None]
        x = jnp.arange(1, W + 1, dtype=jnp.float32)[None, :]
        y = jnp.broadcast_to(y, (H, W))
        x = jnp.broadcast_to(x, (H, W))
        if self.normalize:
            eps = 1e-6
            y = y / (H + eps) * scale
            x = x / (W + eps) * scale
        pos_y = _sine_embed_1d(y, self.num_pos_feats, self.temperature)
        pos_x = _sine_embed_1d(x, self.num_pos_feats, self.temperature)
        pos = jnp.concatenate([pos_y, pos_x], axis=-1)  # (H, W, 2*feats)
        return pos.reshape(1, H * W, -1)


class PositionEmbeddingLearned(nn.Module):
    """Learned 50x50 row/col embedding (`positional_encoding.py:60-92`)."""

    num_pos_feats: int = 256

    @nn.compact
    def __call__(self, feature_map: jax.Array) -> jax.Array:
        H, W = feature_map.shape[-3], feature_map.shape[-2]
        row = self.param(
            "row_embed", nn.initializers.uniform(1.0), (50, self.num_pos_feats)
        )
        col = self.param(
            "col_embed", nn.initializers.uniform(1.0), (50, self.num_pos_feats)
        )
        x_emb = col[:W][None, :, :]  # (1, W, F)
        y_emb = row[:H][:, None, :]  # (H, 1, F)
        pos = jnp.concatenate(
            [jnp.broadcast_to(x_emb, (H, W, self.num_pos_feats)),
             jnp.broadcast_to(y_emb, (H, W, self.num_pos_feats))],
            axis=-1,
        )
        return pos.reshape(1, H * W, -1)


def coord_embedding_sine(
    coord: jax.Array,
    hidden_dim: int,
    temperature: float = 10000.0,
    normalize: bool = False,
    scale: Optional[float] = None,
) -> jax.Array:
    """3D sine embedding of point coordinates (`act/act.py:467-506`).

    Args:
        coord: (..., 3) xyz.
        hidden_dim: output channels; each axis gets ``hidden_dim // 3`` feats,
            remainder zero-padded.
    Returns:
        (..., hidden_dim)
    """
    if scale is not None and not normalize:
        raise ValueError("normalize should be True if scale is passed")
    if scale is None:
        scale = 2 * math.pi
    num_pos_feats = hidden_dim // 3
    num_pad_feats = hidden_dim - num_pos_feats * 3
    x, y, z = coord[..., 0], coord[..., 1], coord[..., 2]
    if normalize:
        eps = 1e-6
        x = x / (jnp.max(x) + eps) * scale
        y = y / (jnp.max(y) + eps) * scale
        z = z / (jnp.max(z) + eps) * scale

    # Reference quirk (`act/act.py:490-501`): the per-axis layout is BLOCKED,
    # not interleaved — `torch.stack((sin(even), cos(odd)), dim=2)` inserts
    # the stack axis before the frequency axis because of a retained
    # singleton dim, so flatten yields [sin(a0),sin(a2),... , cos(a1),
    # cos(a3),...]. Parity-tested against the reference implementation.
    idx = jnp.arange(num_pos_feats, dtype=jnp.float32)
    dim_t = temperature ** (2 * jnp.floor(idx / 2) / num_pos_feats)

    def axis_embed(v):
        vals = v[..., None] / dim_t  # (..., num_pos_feats)
        return jnp.concatenate(
            [jnp.sin(vals[..., 0::2]), jnp.cos(vals[..., 1::2])], axis=-1
        )

    pos = jnp.concatenate([axis_embed(x), axis_embed(y), axis_embed(z)], axis=-1)
    if num_pad_feats:
        pad = jnp.zeros(pos.shape[:-1] + (num_pad_feats,), pos.dtype)
        pos = jnp.concatenate([pos, pad], axis=-1)
    return pos

"""Transformer action denoiser — alternative to ConditionalUnet1D.

Reference `diffusion/transformer_for_diffusion.py` (present in the reference
but never selected by any config — library-surface parity). Architecture:
sinusoidal time embedding (+ optional obs conditioning tokens) feed a small
encoder whose memory cross-conditions a (optionally causal) decoder over the
noisy action trajectory; BERT-style encoder-only mode when ``time_as_cond``
is off. Batch-first throughout.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion.conditional_unet1d import (
    SinusoidalPosEmb,
)


class _EncLayer(nn.Module):
    n_emb: int
    n_head: int
    p_drop: float = 0.0

    @nn.compact
    def __call__(self, x, mask=None, deterministic=True):
        y = nn.LayerNorm(name="norm1")(x)
        y = nn.MultiHeadDotProductAttention(
            num_heads=self.n_head, qkv_features=self.n_emb,
            dropout_rate=self.p_drop, name="attn",
        )(y, y, y, mask=mask, deterministic=deterministic)
        x = x + y
        y = nn.LayerNorm(name="norm2")(x)
        y = nn.Dense(4 * self.n_emb, name="fc1")(y)
        y = jax.nn.gelu(y)
        y = nn.Dense(self.n_emb, name="fc2")(y)
        return x + y


class _DecLayer(nn.Module):
    n_emb: int
    n_head: int
    p_drop: float = 0.0

    @nn.compact
    def __call__(self, x, memory, self_mask=None, deterministic=True):
        y = nn.LayerNorm(name="norm1")(x)
        y = nn.MultiHeadDotProductAttention(
            num_heads=self.n_head, qkv_features=self.n_emb,
            dropout_rate=self.p_drop, name="self_attn",
        )(y, y, y, mask=self_mask, deterministic=deterministic)
        x = x + y
        y = nn.LayerNorm(name="norm2")(x)
        y = nn.MultiHeadDotProductAttention(
            num_heads=self.n_head, qkv_features=self.n_emb,
            dropout_rate=self.p_drop, name="cross_attn",
        )(y, memory, memory, deterministic=deterministic)
        x = x + y
        y = nn.LayerNorm(name="norm3")(x)
        y = nn.Dense(4 * self.n_emb, name="fc1")(y)
        y = jax.nn.gelu(y)
        y = nn.Dense(self.n_emb, name="fc2")(y)
        return x + y


class TransformerForDiffusion(nn.Module):
    input_dim: int
    output_dim: int
    horizon: int
    n_obs_steps: Optional[int] = None
    cond_dim: int = 0
    n_layer: int = 12
    n_head: int = 12
    n_emb: int = 768
    p_drop_emb: float = 0.1
    p_drop_attn: float = 0.1
    causal_attn: bool = False
    time_as_cond: bool = True
    obs_as_cond: bool = False
    n_cond_layers: int = 0

    @nn.compact
    def __call__(self, sample: jax.Array, timestep, cond=None,
                 train: bool = False) -> jax.Array:
        B, T = sample.shape[0], sample.shape[1]
        obs_as_cond = self.cond_dim > 0
        timesteps = jnp.broadcast_to(jnp.atleast_1d(jnp.asarray(timestep)), (B,))
        # cast the f32 sinusoids before the MLP so the conditioning token
        # doesn't promote the whole transformer to f32 under bf16-mixed
        # (see conditional_unet1d.py)
        time_emb = SinusoidalPosEmb(self.n_emb, name="time_pos")(timesteps)
        time_emb = time_emb.astype(sample.dtype)
        time_emb = nn.Dense(self.n_emb * 4, name="time_fc1")(time_emb)
        time_emb = nn.Dense(self.n_emb, name="time_fc2")(
            time_emb * jnp.tanh(jax.nn.softplus(time_emb))
        )[:, None, :]
        input_emb = nn.Dense(self.n_emb, name="input_emb")(sample)
        drop = lambda x: nn.Dropout(self.p_drop_emb,
                                    deterministic=not train)(x)
        causal = None
        if self.causal_attn:
            causal = jnp.tril(jnp.ones((1, 1, T, T), bool))

        if not self.time_as_cond:  # BERT-style encoder-only
            tokens = jnp.concatenate([time_emb, input_emb], axis=1)
            pos = self.param("pos_emb", nn.initializers.zeros,
                             (1, self.horizon + 1, self.n_emb))
            x = drop(tokens + pos[:, : tokens.shape[1]])
            mask = None
            if self.causal_attn:
                L = tokens.shape[1]
                mask = jnp.tril(jnp.ones((1, 1, L, L), bool))
            for i in range(self.n_layer):
                x = _EncLayer(self.n_emb, self.n_head, self.p_drop_attn,
                              name=f"encoder_{i}")(x, mask=mask,
                                                   deterministic=not train)
            x = x[:, 1:]
        else:
            cond_tokens = time_emb
            if obs_as_cond:
                cond_obs = nn.Dense(self.n_emb, name="cond_obs_emb")(cond)
                cond_tokens = jnp.concatenate([cond_tokens, cond_obs], axis=1)
            t_cond = 1 + (self.n_obs_steps or self.horizon)
            cond_pos = self.param("cond_pos_emb", nn.initializers.zeros,
                                  (1, t_cond, self.n_emb))
            memory = drop(cond_tokens + cond_pos[:, : cond_tokens.shape[1]])
            if self.n_cond_layers > 0:
                for i in range(self.n_cond_layers):
                    memory = _EncLayer(self.n_emb, self.n_head,
                                       self.p_drop_attn,
                                       name=f"cond_encoder_{i}")(
                        memory, deterministic=not train)
            else:
                memory = nn.Dense(4 * self.n_emb, name="cond_mlp1")(memory)
                memory = memory * jnp.tanh(jax.nn.softplus(memory))
                memory = nn.Dense(self.n_emb, name="cond_mlp2")(memory)

            pos = self.param("pos_emb", nn.initializers.zeros,
                             (1, self.horizon, self.n_emb))
            x = drop(input_emb + pos[:, :T])
            for i in range(self.n_layer):
                x = _DecLayer(self.n_emb, self.n_head, self.p_drop_attn,
                              name=f"decoder_{i}")(
                    x, memory, self_mask=causal, deterministic=not train)

        x = nn.LayerNorm(name="ln_f")(x)
        return nn.Dense(self.output_dim, name="head")(x)

"""DETR-style transformer for ACT, batch-first.

Behavioral contract follows reference `act/transformer.py:16-425` (pre/post
norm encoder + decoder, positional embeddings added to attention inputs only,
value stream un-positioned), redesigned for XLA:

- batch-first ``(B, L, D)`` everywhere — no seq-first permutes (those exist in
  the reference only because torch ``nn.MultiheadAttention`` wants them)
- padding is a boolean ``key_padding_mask`` (True = PAD, torch convention)
  folded into the attention bias; static shapes throughout
- one attention per layer via ``nn.MultiHeadDotProductAttention``
  (q = x + pos, k = x + pos, v = x), plain XLA math as the reference's torch
  ``nn.MultiheadAttention``
- the top-level ``Transformer`` takes token sequences ``(B, L, D)`` directly;
  the reference's ``(B, C, H, W)``/``(B, C, 1, N)`` flattening lives with the
  callers in `act.py`.

Quirk preserved: with ``return_intermediate_dec`` the caller (ACT) consumes
index 0 — the *first* decoder layer's normed output (`act/act.py:262-270`).
Later layers are not computed (``TransformerDecoder.live_layers``), so this
build does not pay for the reference's wasted 6/7 of decoder compute.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.nn_utils import (
    BitsDropout,
    activation_fn,
)


def _attention_mask(key_padding_mask: Optional[jax.Array]) -> Optional[jax.Array]:
    """(B, L) True=PAD -> (B, 1, 1, L) True=attend, or None."""
    if key_padding_mask is None:
        return None
    return ~key_padding_mask[:, None, None, :]


class EfficientMHA(nn.Module):
    """Multi-head attention, parameter-compatible with
    ``nn.MultiHeadDotProductAttention`` (query/key/value/out DenseGeneral
    trees) but with a bandwidth-frugal attention-weight dropout.

    ``nn.Dropout``'s per-element dropout draws (B, H, L, L) *float32* uniforms — for
    2k point tokens that is 4.3 GB of generated randomness per layer. Here
    the keep-mask comes from uint8 random bits (4x less traffic); the drop
    rate is quantized to the nearest 1/256 (0.1 -> 0.1016), which is noise
    at these rates. The attention core is jax.checkpoint'ed, so only q/k/v
    are saved for backward — the memory-frugal choice for very long token
    sequences. It is not the default; select it when memory, not time,
    binds.
    """

    num_heads: int
    d_model: int
    dropout_rate: float = 0.0

    @nn.compact
    def __call__(self, inputs_q, inputs_k, inputs_v, mask=None,
                 deterministic: bool = True) -> jax.Array:
        H = self.num_heads
        Dh = self.d_model // H
        dense = functools.partial(
            nn.DenseGeneral, features=(H, Dh), axis=-1,
        )
        q = dense(name="query")(inputs_q)   # (B, L, H, Dh)
        k = dense(name="key")(inputs_k)
        v = dense(name="value")(inputs_v)
        drop_rng = (
            self.make_rng("dropout")
            if self.dropout_rate > 0.0 and not deterministic else None
        )

        # checkpointed core: only q/k/v (+rng key) are saved for the backward
        # pass; the (B, H, L, L) logits/probs/keep-mask are recomputed. At 2k
        # point tokens those are 4.3 GB *per layer*.
        @jax.checkpoint
        def core(q, k, v, key):
            logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.asarray(
                np.sqrt(Dh), q.dtype
            )
            if mask is not None:
                logits = jnp.where(
                    mask, logits, jnp.asarray(-1e9, logits.dtype)
                )
            probs = jax.nn.softmax(logits, axis=-1)
            if key is not None:
                threshold = max(1, int(round(self.dropout_rate * 256)))
                keep_prob = (256 - threshold) / 256.0
                bits = jax.random.bits(key, probs.shape, jnp.uint8)
                probs = jnp.where(
                    bits >= threshold, probs / keep_prob, 0.0
                ).astype(probs.dtype)
            return jnp.einsum("bhqk,bkhd->bqhd", probs, v)

        out = core(q, k, v, drop_rng)
        return nn.DenseGeneral(
            features=self.d_model, axis=(-2, -1), name="out"
        )(out)


class TransformerEncoderLayer(nn.Module):
    d_model: int
    nhead: int
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = False

    @nn.compact
    def __call__(
        self,
        src: jax.Array,
        pos: Optional[jax.Array] = None,
        key_padding_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.nhead,
            qkv_features=self.d_model,
            out_features=self.d_model,
            dropout_rate=self.dropout,
            broadcast_dropout=True,
            name="self_attn",
        )
        ffn_in = nn.Dense(self.dim_feedforward, name="linear1")
        ffn_out = nn.Dense(self.d_model, name="linear2")
        norm1 = nn.LayerNorm(epsilon=1e-5, name="norm1")
        norm2 = nn.LayerNorm(epsilon=1e-5, name="norm2")
        act = activation_fn(self.activation)
        # BitsDropout: the residual streams here are (B, L~2051, D); uint8
        # bits are a quarter of nn.Dropout's 32-bit draws
        drop = lambda x: BitsDropout(self.dropout, deterministic=deterministic)(x)
        mask = _attention_mask(key_padding_mask)

        def with_pos(x):
            # cast: sinusoid/coord tables are built f32; letting them promote
            # x would silently run the whole attention stack (and everything
            # downstream of the residual) in f32 under bf16-mixed
            return x if pos is None else x + pos.astype(x.dtype)

        if self.normalize_before:
            x = norm1(src)
            qk = with_pos(x)
            src = src + drop(attn(qk, qk, x, mask=mask, deterministic=deterministic))
            x = norm2(src)
            src = src + drop(ffn_out(drop(act(ffn_in(x)))))
        else:
            qk = with_pos(src)
            src = src + drop(attn(qk, qk, src, mask=mask, deterministic=deterministic))
            src = norm1(src)
            src = src + drop(ffn_out(drop(act(ffn_in(src)))))
            src = norm2(src)
        return src


class TransformerDecoderLayer(nn.Module):
    d_model: int
    nhead: int
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = False

    @nn.compact
    def __call__(
        self,
        tgt: jax.Array,
        memory: jax.Array,
        pos: Optional[jax.Array] = None,
        query_pos: Optional[jax.Array] = None,
        memory_key_padding_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        self_attn = nn.MultiHeadDotProductAttention(
            num_heads=self.nhead,
            qkv_features=self.d_model,
            out_features=self.d_model,
            dropout_rate=self.dropout,
            broadcast_dropout=True,
            name="self_attn",
        )
        cross_attn = nn.MultiHeadDotProductAttention(
            num_heads=self.nhead,
            qkv_features=self.d_model,
            out_features=self.d_model,
            dropout_rate=self.dropout,
            broadcast_dropout=True,
            name="multihead_attn",
        )
        ffn_in = nn.Dense(self.dim_feedforward, name="linear1")
        ffn_out = nn.Dense(self.d_model, name="linear2")
        norm1 = nn.LayerNorm(epsilon=1e-5, name="norm1")
        norm2 = nn.LayerNorm(epsilon=1e-5, name="norm2")
        norm3 = nn.LayerNorm(epsilon=1e-5, name="norm3")
        act = activation_fn(self.activation)
        drop = lambda x: BitsDropout(self.dropout, deterministic=deterministic)(x)
        mem_mask = _attention_mask(memory_key_padding_mask)

        def with_pos(x, p):
            # see encoder-layer note: keep the compute dtype, don't promote
            return x if p is None else x + p.astype(x.dtype)

        if self.normalize_before:
            x = norm1(tgt)
            qk = with_pos(x, query_pos)
            tgt = tgt + drop(self_attn(qk, qk, x, deterministic=deterministic))
            x = norm2(tgt)
            tgt = tgt + drop(
                cross_attn(
                    with_pos(x, query_pos), with_pos(memory, pos), memory,
                    mask=mem_mask, deterministic=deterministic,
                )
            )
            x = norm3(tgt)
            tgt = tgt + drop(ffn_out(drop(act(ffn_in(x)))))
        else:
            qk = with_pos(tgt, query_pos)
            tgt = tgt + drop(self_attn(qk, qk, tgt, deterministic=deterministic))
            tgt = norm1(tgt)
            tgt = tgt + drop(
                cross_attn(
                    with_pos(tgt, query_pos), with_pos(memory, pos), memory,
                    mask=mem_mask, deterministic=deterministic,
                )
            )
            tgt = norm2(tgt)
            tgt = tgt + drop(ffn_out(drop(act(ffn_in(tgt)))))
            tgt = norm3(tgt)
        return tgt


class TransformerEncoder(nn.Module):
    """Stack of encoder layers + optional final pre-norm
    (`transformer.py:118-158`). Also used standalone as the CVAE posterior
    encoder (`act/act.py:168-171`)."""

    d_model: int = 256
    nhead: int = 8
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = False
    num_layers: int = 4

    @nn.compact
    def __call__(
        self,
        src: jax.Array,
        pos: Optional[jax.Array] = None,
        key_padding_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        for i in range(self.num_layers):
            src = TransformerEncoderLayer(
                self.d_model, self.nhead, self.dim_feedforward, self.dropout,
                self.activation, self.normalize_before, name=f"layers_{i}",
            )(src, pos, key_padding_mask, deterministic)
        if self.normalize_before:
            src = nn.LayerNorm(epsilon=1e-5, name="norm")(src)
        return src


class TransformerDecoder(nn.Module):
    d_model: int
    nhead: int
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = False
    num_layers: int = 6
    return_intermediate: bool = False
    # How many leading layers to actually COMPUTE at apply time. The ACT
    # caller consumes only ``hs[0]`` (`act/act.py:262-270` takes the first
    # intermediate), but XLA does NOT dead-code-eliminate the remaining
    # layers through jax.grad's saved residuals.
    # During ``init`` every layer still runs so the parameter tree stays
    # identical to the reference (ported checkpoints load unchanged).
    # ``None`` = compute all layers.
    live_layers: Optional[int] = None

    @nn.compact
    def __call__(
        self,
        tgt: jax.Array,
        memory: jax.Array,
        pos: Optional[jax.Array] = None,
        query_pos: Optional[jax.Array] = None,
        memory_key_padding_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        norm = nn.LayerNorm(epsilon=1e-5, name="norm")
        n_run = self.num_layers
        if (
            self.live_layers is not None
            and self.return_intermediate
            and not self.is_initializing()
        ):
            n_run = min(self.live_layers, self.num_layers)
        intermediate = []
        out = tgt
        for i in range(n_run):
            out = TransformerDecoderLayer(
                self.d_model, self.nhead, self.dim_feedforward, self.dropout,
                self.activation, self.normalize_before, name=f"layers_{i}",
            )(out, memory, pos=pos, query_pos=query_pos,
              memory_key_padding_mask=memory_key_padding_mask,
              deterministic=deterministic)
            if self.return_intermediate:
                intermediate.append(norm(out))
        if self.return_intermediate:
            # final entry re-normed exactly like the reference
            # (`transformer.py:198-203` pops and re-appends)
            intermediate[-1] = norm(out)
            return jnp.stack(intermediate)  # (n_run, B, nq, D)
        return norm(out)[None]  # (1, B, nq, D)


class Transformer(nn.Module):
    """ACT encoder-decoder over observation tokens (`transformer.py:16-115`).

    ``__call__`` consumes batch-first tokens:
        src:        (B, L, D) observation tokens
        pos:        (1 or B, L, D) positional embedding for src
        latent_input:  (B, D) CVAE latent token
        proprio_input: (B, k, D) proprio (+ optional goal) tokens
    Prepends [latent, proprio...] with ``additional_pos_embed`` learned
    positions (`transformer.py:86-99`), runs the encoder, then decodes
    ``num_queries`` zero-initialized targets against learned query embeddings.

    Returns (num_intermediate, B, num_queries, D).
    """

    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = False
    return_intermediate_dec: bool = False
    # With return_intermediate_dec the ACT caller consumes only hs[0]; by
    # default compute just that first decoder layer (params for the rest
    # still exist — see TransformerDecoder.live_layers). Set to None to
    # compute every intermediate.
    decoder_live_layers: Optional[int] = 1

    @nn.compact
    def __call__(
        self,
        src: jax.Array,
        query_embed: jax.Array,
        pos: Optional[jax.Array] = None,
        latent_input: Optional[jax.Array] = None,
        proprio_input: Optional[jax.Array] = None,
        additional_pos_embed: Optional[jax.Array] = None,
        key_padding_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        B = src.shape[0]
        if latent_input is not None:
            extra = [latent_input[:, None, :]]
            if proprio_input is not None:
                extra.append(proprio_input)
            addition = jnp.concatenate(extra, axis=1)  # (B, n_add, D)
            src = jnp.concatenate([addition, src], axis=1)
            if pos is not None and additional_pos_embed is not None:
                pos = jnp.broadcast_to(pos, (B,) + pos.shape[1:])
                add_pos = jnp.broadcast_to(
                    additional_pos_embed[None],
                    (B,) + additional_pos_embed.shape,
                )
                pos = jnp.concatenate([add_pos, pos], axis=1)
            if key_padding_mask is not None:
                no_pad = jnp.zeros((B, addition.shape[1]), bool)
                key_padding_mask = jnp.concatenate([no_pad, key_padding_mask], 1)

        memory = TransformerEncoder(
            self.d_model, self.nhead, self.dim_feedforward, self.dropout,
            self.activation, self.normalize_before, self.num_encoder_layers,
            name="encoder",
        )(src, pos=pos, key_padding_mask=key_padding_mask,
          deterministic=deterministic)

        num_queries = query_embed.shape[0]
        query_pos = jnp.broadcast_to(
            query_embed[None], (B, num_queries, self.d_model)
        )
        tgt = jnp.zeros_like(query_pos)
        hs = TransformerDecoder(
            self.d_model, self.nhead, self.dim_feedforward, self.dropout,
            self.activation, self.normalize_before, self.num_decoder_layers,
            return_intermediate=self.return_intermediate_dec,
            live_layers=self.decoder_live_layers, name="decoder",
        )(tgt, memory, pos=pos, query_pos=query_pos,
          memory_key_padding_mask=key_padding_mask, deterministic=deterministic)
        return hs

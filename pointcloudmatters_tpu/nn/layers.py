"""The layers the policies build on, channels-last, over ``nn.Module``.

Parameter names, shapes, default initializers and the dtype rules follow
``flax.linen`` (so the torch weight-porting maps in ``utils/torch_layouts``
hold): with ``dtype=None`` a layer computes in the promoted dtype of its
input and parameters, which under bf16-mixed training is bf16; normalization
statistics are always reduced in float32.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pointcloudmatters_tpu.nn.module import Module, compact, merge_param

initializers = jax.nn.initializers
default_kernel_init = initializers.lecun_normal()
Dtype = Any
Array = jax.Array


def promote_dtype(*args, dtype: Optional[Dtype] = None):
    """Casts the non-None ``args`` to ``dtype``, or to their promoted type."""
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
    return tuple(None if a is None else jnp.asarray(a, dtype) for a in args)


def _tuple(x) -> tuple:
    return tuple(x) if isinstance(x, Sequence) else (x,)


def _flat_batch(inputs: Array, n_spatial: int):
    """(inputs with exactly one batch dim, batch shape to restore)."""
    batch_shape = inputs.shape[: inputs.ndim - n_spatial - 1]
    flat = inputs.reshape((-1,) + inputs.shape[len(batch_shape):])
    return flat, batch_shape


def _padding(padding, rank: int):
    if isinstance(padding, str):
        return padding
    pads = [tuple(p) for p in padding]
    if len(pads) != rank or any(len(p) != 2 for p in pads):
        raise ValueError(f"padding {padding!r} does not fit {rank} spatial dims")
    return pads


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis."""

    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, inputs: Array) -> Array:
        kernel = self.param("kernel", default_kernel_init,
                            (inputs.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", initializers.zeros, (self.features,),
                           jnp.float32) if self.use_bias else None)
        inputs, kernel, bias = promote_dtype(inputs, kernel, bias,
                                             dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else y + bias


class DenseGeneral(Module):
    """A linear map contracting ``axis`` of the input into ``features``
    (either may be a tuple). The kernel is initialized as the flat
    ``(prod(in), prod(features))`` matrix, so fan-in counts every
    contracted axis."""

    features: Union[int, Sequence[int]]
    axis: Union[int, Sequence[int]] = -1
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, inputs: Array) -> Array:
        features = _tuple(self.features)
        axis = tuple(a % inputs.ndim for a in _tuple(self.axis))
        n_axis = len(axis)

        def kernel_init(rng, shape, dtype):
            flat = (int(np.prod(shape[:n_axis])), int(np.prod(shape[n_axis:])))
            return jnp.reshape(default_kernel_init(rng, flat, dtype), shape)

        kernel = self.param("kernel", kernel_init,
                            tuple(inputs.shape[a] for a in axis) + features,
                            jnp.float32)
        bias = self.param("bias", initializers.zeros, features, jnp.float32)
        inputs, kernel, bias = promote_dtype(inputs, kernel, bias,
                                             dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            ((axis, tuple(range(n_axis))), ((), ())))
        return y + bias


def _conv_dimension_numbers(ndim: int):
    lhs = (0, ndim - 1) + tuple(range(1, ndim - 1))
    rhs = (ndim - 1, ndim - 2) + tuple(range(0, ndim - 2))
    return lax.ConvDimensionNumbers(lhs, rhs, lhs)


class Conv(Module):
    """N-d convolution, inputs ``(batch..., spatial..., in)``, kernel
    ``(spatial..., in, features)``; ``padding`` is "SAME", "VALID" or one
    (low, high) pair per spatial dim."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, inputs: Array) -> Array:
        ks = tuple(self.kernel_size)
        n = len(ks)
        x, batch_shape = _flat_batch(inputs, n)
        kernel = self.param("kernel", default_kernel_init,
                            ks + (x.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", initializers.zeros, (self.features,),
                           jnp.float32) if self.use_bias else None)
        x, kernel, bias = promote_dtype(x, kernel, bias, dtype=self.dtype)
        strides = ((self.strides,) * n if isinstance(self.strides, int)
                   else tuple(self.strides))
        y = lax.conv_general_dilated(
            x, kernel, strides, _padding(self.padding, n),
            dimension_numbers=_conv_dimension_numbers(x.ndim),
        )
        if bias is not None:
            y = y + bias
        return y.reshape(batch_shape + y.shape[1:])


class ConvTranspose(Module):
    """Transposed convolution (``lax.conv_transpose``, kernel not flipped),
    kernel ``(spatial..., in, features)``."""

    features: int
    kernel_size: Sequence[int]
    strides: Optional[Sequence[int]] = None
    padding: Any = "SAME"

    @compact
    def __call__(self, inputs: Array) -> Array:
        ks = tuple(self.kernel_size)
        n = len(ks)
        x, batch_shape = _flat_batch(inputs, n)
        kernel = self.param("kernel", default_kernel_init,
                            ks + (x.shape[-1], self.features), jnp.float32)
        bias = self.param("bias", initializers.zeros, (self.features,),
                          jnp.float32)
        x, kernel, bias = promote_dtype(x, kernel, bias)
        y = lax.conv_transpose(x, kernel, tuple(self.strides or (1,) * n),
                               _padding(self.padding, n))
        y = y + bias
        return y.reshape(batch_shape + y.shape[1:])


class Embed(Module):
    """Lookup table ``(num_embeddings, features)`` indexed by integers."""

    num_embeddings: int
    features: int

    def setup(self):
        self.embedding = self.param(
            "embedding",
            initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0),
            (self.num_embeddings, self.features), jnp.float32)

    def __call__(self, inputs: Array) -> Array:
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Embed takes integer inputs")
        return jnp.take(self.embedding, inputs, axis=0)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def _normalize(mdl: Module, x: Array, stats_x: Array, stats_axes: tuple,
               expand_axes: tuple, epsilon: float,
               group_size: int = 1) -> Array:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with per-channel
    (last axis) scale and bias. Mean and biased variance (E[x^2] - E[x]^2,
    clipped at 0) are reduced in float32 over ``stats_axes`` of
    ``stats_x``, repeated ``group_size`` times on the last axis, and
    broadcast back over ``expand_axes``; the result takes the promoted
    dtype of ``x`` and the parameters."""
    xf = stats_x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = xf.mean(stats_axes)
    var = jnp.maximum(0.0, (xf * xf).mean(stats_axes) - mean * mean)
    if group_size > 1:
        mean = jnp.repeat(mean, group_size, axis=-1)
        var = jnp.repeat(var, group_size, axis=-1)
    mean = jnp.expand_dims(mean, expand_axes)
    var = jnp.expand_dims(var, expand_axes)
    features = (x.shape[-1],)
    scale = mdl.param("scale", initializers.ones, features, jnp.float32)
    bias = mdl.param("bias", initializers.zeros, features, jnp.float32)
    y = (x - mean) * (lax.rsqrt(var + epsilon) * scale) + bias
    return y.astype(jnp.result_type(x, scale, bias))


class LayerNorm(Module):
    """Normalizes over the last axis."""

    epsilon: float = 1e-6

    @compact
    def __call__(self, x: Array) -> Array:
        axes = (x.ndim - 1,)
        return _normalize(self, x, x, axes, axes, self.epsilon)


class GroupNorm(Module):
    """Normalizes each of ``num_groups`` channel groups over the spatial
    axes and the group's channels, per batch element."""

    num_groups: int = 32
    epsilon: float = 1e-6

    @compact
    def __call__(self, x: Array) -> Array:
        channels = x.shape[-1]
        if self.num_groups <= 0 or channels % self.num_groups:
            raise ValueError(
                f"{self.num_groups} groups do not divide {channels} channels")
        size = channels // self.num_groups
        grouped = x.reshape(x.shape[:-1] + (self.num_groups, size))
        spatial = tuple(range(1, x.ndim - 1))
        return _normalize(self, x, grouped, spatial + (grouped.ndim - 1,),
                          spatial, self.epsilon, group_size=size)


# ---------------------------------------------------------------------------
# Dropout and attention
# ---------------------------------------------------------------------------

class Dropout(Module):
    """Inverted dropout; draws from the ``dropout`` rng stream.
    ``deterministic`` is given as a field or at the call."""

    rate: float
    deterministic: Optional[bool] = None

    @compact
    def __call__(self, inputs: Array,
                 deterministic: Optional[bool] = None) -> Array:
        deterministic = merge_param("deterministic", self.deterministic,
                                    deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep_prob = 1.0 - self.rate
        keep = jax.random.bernoulli(self.make_rng("dropout"), p=keep_prob,
                                    shape=inputs.shape)
        return lax.select(keep, inputs / keep_prob, jnp.zeros_like(inputs))


def dot_product_attention(query: Array, key: Array, value: Array,
                          mask: Optional[Array] = None,
                          broadcast_dropout: bool = True,
                          dropout_rng: Optional[Array] = None,
                          dropout_rate: float = 0.0,
                          deterministic: bool = True,
                          dtype: Optional[Dtype] = None) -> Array:
    """softmax(q k^T / sqrt(d)) v over ``(batch..., length, heads, depth)``;
    ``mask`` is True where attention is allowed. Attention-weight dropout is
    shared across batch and heads when ``broadcast_dropout``."""
    query, key, value = promote_dtype(query, key, value, dtype=dtype)
    dtype = query.dtype
    query = query / jnp.sqrt(query.shape[-1]).astype(dtype)
    weights = jnp.einsum("...qhd,...khd->...hqk", query, key)
    if mask is not None:
        weights = jnp.where(mask, weights, jnp.finfo(dtype).min)
    weights = jax.nn.softmax(weights).astype(dtype)
    if not deterministic and dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        shape = ((1,) * (key.ndim - 2) + weights.shape[-2:]
                 if broadcast_dropout else weights.shape)
        keep = jax.random.bernoulli(dropout_rng, keep_prob, shape)
        weights = weights * (keep.astype(dtype) / jnp.asarray(keep_prob, dtype))
    return jnp.einsum("...hqk,...khd->...qhd", weights, value)


class MultiHeadDotProductAttention(Module):
    """Multi-head attention with ``query``/``key``/``value`` projections to
    ``(heads, head_dim)`` and an ``out`` projection back."""

    num_heads: int
    dtype: Optional[Dtype] = None
    qkv_features: Optional[int] = None
    out_features: Optional[int] = None
    broadcast_dropout: bool = True
    dropout_rate: float = 0.0

    @compact
    def __call__(self, inputs_q: Array, inputs_k: Optional[Array] = None,
                 inputs_v: Optional[Array] = None, *,
                 mask: Optional[Array] = None,
                 deterministic: bool = True) -> Array:
        if inputs_k is None:
            inputs_k = inputs_q
        if inputs_v is None:
            inputs_v = inputs_k
        features = self.out_features or inputs_q.shape[-1]
        qkv_features = self.qkv_features or inputs_q.shape[-1]
        if qkv_features % self.num_heads:
            raise ValueError(
                f"{qkv_features} features do not split into "
                f"{self.num_heads} heads")
        dense = functools.partial(
            DenseGeneral, axis=-1, dtype=self.dtype,
            features=(self.num_heads, qkv_features // self.num_heads),
        )
        query = dense(name="query")(inputs_q)
        key = dense(name="key")(inputs_k)
        value = dense(name="value")(inputs_v)
        dropout = self.dropout_rate > 0.0 and not deterministic
        x = dot_product_attention(
            query, key, value, mask=mask,
            broadcast_dropout=self.broadcast_dropout,
            dropout_rng=self.make_rng("dropout") if dropout else None,
            dropout_rate=self.dropout_rate, deterministic=not dropout,
            dtype=self.dtype,
        )
        return DenseGeneral(features=features, axis=(-2, -1), dtype=self.dtype,
                            name="out")(x)


def max_pool(inputs: Array, window_shape: Sequence[int],
             strides: Optional[Sequence[int]] = None, padding: Any = "VALID"):
    """Max over windows of the spatial axes of ``(batch..., spatial..., C)``."""
    window = tuple(window_shape)
    x, batch_shape = _flat_batch(inputs, len(window))
    strides = tuple(strides or (1,) * len(window))
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(map(tuple, padding)) + ((0, 0),)
    y = lax.reduce_window(x, -jnp.inf, lax.max, (1,) + window + (1,),
                          (1,) + strides + (1,), padding)
    return y.reshape(batch_shape + y.shape[1:])

"""Shared NN building blocks for the model stack.

Key departure from the reference: every module here is padded-native. The
reference operates on packed variable-length tensors; under XLA's static
shapes we carry fixed shapes plus validity masks, so normalization layers must
exclude padding slots from their statistics. ``MaskedBatchNorm`` is the
workhorse replacing ``nn.BatchNorm1d`` (reference
`src/models/components/pcd_encoder/pointnet.py:29`,
`src/models/components/act/act.py:371`).

Cross-replica ("sync") batch norm — the reference's
``sync_batchnorm: true`` under DDP (`configs/trainer/ddp.yaml:8`) — falls out
of passing ``axis_name``: the masked sums/counts are ``psum``-ed over the
device mesh, which is exact. Under the trainer's GSPMD data parallelism the
statistics are already global (computed over the logically-global batch).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

Dtype = Any


def get_sinusoid_encoding_table(n_position: int, d_hid: int) -> jnp.ndarray:
    """(1, n_position, d_hid) interleaved sin/cos table
    (reference `act/utils.py:41-55`)."""
    position = np.arange(n_position)[:, None]
    hid_j = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid_j // 2) / d_hid)
    table = np.where(hid_j % 2 == 0, np.sin(angle), np.cos(angle))
    return jnp.asarray(table[None], jnp.float32)


def reparametrize(mu: jax.Array, logvar: jax.Array, rng: jax.Array) -> jax.Array:
    """VAE reparameterization, std = exp(logvar/2) (`act/utils.py:35-38`)."""
    std = jnp.exp(0.5 * logvar)
    eps = jax.random.normal(rng, std.shape, std.dtype)
    return mu + std * eps


def activation_fn(name: str) -> Callable[[jax.Array], jax.Array]:
    """Activation registry mirroring `act/transformer.py:417-425`."""
    table = {
        "relu": jax.nn.relu,
        "gelu": jax.nn.gelu,
        "glu": jax.nn.glu,
        "silu": jax.nn.silu,
        "mish": lambda x: x * jnp.tanh(jax.nn.softplus(x)),
    }
    if name not in table:
        raise RuntimeError(f"activation should be one of {sorted(table)}, not {name}.")
    return table[name]


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid elements only, torch-semantics.

    - normalization uses biased variance; running stats store the unbiased
      variance (matching ``torch.nn.BatchNorm1d``)
    - ``momentum`` is the torch convention: ``new = (1-m)*old + m*batch``
    - ``mask`` (broadcastable to ``x.shape[:-1]``) excludes padding slots from
      the statistics; padded activations still get normalized (they are
      ignored downstream anyway)
    - ``axis_name`` makes the statistics cross-replica exact (psum of sums and
      counts) — the equivalent of Lightning's sync_batchnorm.
    """

    momentum: float = 0.1
    eps: float = 1e-5
    axis_name: Optional[str] = None
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        mask: Optional[jax.Array] = None,
        use_running_average: bool = True,
    ) -> jax.Array:
        features = x.shape[-1]
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros((features,), jnp.float32)
        )
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones((features,), jnp.float32)
        )
        scale = self.param("scale", nn.initializers.ones, (features,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (features,), jnp.float32)

        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            # f32-accumulating reductions (dtype=...) keep the statistics
            # exact WITHOUT materializing an f32 copy of x — for the grouped
            # point tensors this op normalizes, that copy is gigabytes
            reduce_axes = tuple(range(x.ndim - 1))
            if mask is None:
                count = jnp.asarray(np.prod(x.shape[:-1]), jnp.float32)
                total = jnp.sum(x, axis=reduce_axes, dtype=jnp.float32)
                total_sq = jnp.sum(x * x, axis=reduce_axes, dtype=jnp.float32)
            else:
                m = mask.astype(x.dtype)[..., None]
                count = jnp.sum(mask.astype(jnp.float32))
                total = jnp.sum(x * m, axis=reduce_axes, dtype=jnp.float32)
                total_sq = jnp.sum(
                    (x * m) * x, axis=reduce_axes, dtype=jnp.float32
                )
            if self.axis_name is not None:
                total = jax.lax.psum(total, self.axis_name)
                total_sq = jax.lax.psum(total_sq, self.axis_name)
                count = jax.lax.psum(count, self.axis_name)
            count = jnp.maximum(count, 1.0)
            mean = total / count
            var = jnp.maximum(total_sq / count - mean * mean, 0.0)  # biased
            if not self.is_initializing():
                unbiased = var * count / jnp.maximum(count - 1.0, 1.0)
                ra_mean.value = (
                    (1.0 - self.momentum) * ra_mean.value + self.momentum * mean
                )
                ra_var.value = (
                    (1.0 - self.momentum) * ra_var.value + self.momentum * unbiased
                )

        # fold (mean, var, scale, bias) into one per-channel affine applied in
        # the compute dtype: y = x * eff_scale + eff_bias
        eff_scale = scale * jax.lax.rsqrt(var + self.eps)
        eff_bias = bias - mean * eff_scale
        out_dtype = self.dtype or x.dtype
        y = x * eff_scale.astype(x.dtype) + eff_bias.astype(x.dtype)
        return y.astype(out_dtype)


class GroupedBNReluMax(nn.Module):
    """Fused point-token builder: ``max_k(relu(BN(where(hole, 0, g[nn] - h))))``.

    Exact reformulation of the gather→BatchNorm→ReLU→max-pool tail of the
    reference token builder (`act/act.py:457-460`,
    `vision/pcd_obs_encoder.py:180-198`): BatchNorm applies one per-channel
    affine ``y = x*es + eb`` and ReLU is monotone, so the K-neighbor max-pool
    only needs the per-token ``max``/``min`` of the gathered rows (max when
    the effective scale ``es >= 0``, min when negative) plus the global
    ``sum``/``sumsq`` for the batch statistics — the intermediate BN output
    over the full neighborhood tensor is never needed. XLA may still
    materialize the raw ``(B, M, K, D)`` gather itself (~1 GB at the
    flagship shape), so the win of this reformulation is eliminating the
    BN/ReLU passes and h-broadcasts over that tensor, not the gather
    traffic.

    Bit-exact vs the unfused path: bf16 rounding is monotone, so
    ``max_k(fl(fl(x_k*es)+eb))`` equals the same map applied to
    ``max_k(x_k)`` (or ``min_k`` for negative ``es``); the branch tests the
    *casted* scale, matching the unfused multiply. Holes (``nn_idx < 0``)
    contribute exact-zero rows to both the statistics (count includes them —
    the reference quirk) and the max, as in `functions/grouping.py:35-59`.

    Variable tree (params ``scale``/``bias``, batch_stats ``mean``/``var``,
    torch momentum/unbiased-running-var semantics, optional ``axis_name``
    cross-replica stats) is identical to ``MaskedBatchNorm`` — checkpoints
    trained with the unfused builder load unchanged.
    """

    momentum: float = 0.1
    eps: float = 1e-5
    axis_name: Optional[str] = None

    @nn.compact
    def __call__(
        self,
        g: jax.Array,
        h: jax.Array,
        nn_idx: jax.Array,
        use_running_average: bool = True,
    ) -> jax.Array:
        """g: (B, N, D) projected source rows; h: (B, M, D) projected query
        offsets; nn_idx: (B, M, K) int32 into N, -1 = hole. Returns the
        (B, M, D) pooled tokens."""
        from pointcloudmatters_tpu.ops.pointops import gather_rows_padded

        features = h.shape[-1]
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros((features,), jnp.float32)
        )
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones((features,), jnp.float32)
        )
        scale = self.param("scale", nn.initializers.ones, (features,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (features,), jnp.float32)

        hole = (nn_idx < 0)[..., None]  # (B, M, K, 1)
        gg = gather_rows_padded(g, nn_idx)  # (B, M, K, D) — not stored
        x = gg - h[:, :, None, :]
        neg_inf = jnp.asarray(-jnp.inf, x.dtype)
        pos_inf = jnp.asarray(jnp.inf, x.dtype)
        vmax = jnp.max(jnp.where(hole, neg_inf, x), axis=2)  # (B, M, D)
        vmin = jnp.min(jnp.where(hole, pos_inf, x), axis=2)
        xz = jnp.where(hole, 0.0, x)
        total = jnp.sum(xz, axis=(0, 1, 2), dtype=jnp.float32)
        total_sq = jnp.sum(xz * xz, axis=(0, 1, 2), dtype=jnp.float32)

        any_hole = jnp.any(nn_idx < 0, axis=2)[..., None]  # (B, M, 1)
        xmax = jnp.where(any_hole, jnp.maximum(vmax, 0.0), vmax)
        xmin = jnp.where(any_hole, jnp.minimum(vmin, 0.0), vmin)

        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            count = jnp.asarray(np.prod(nn_idx.shape), jnp.float32)
            if self.axis_name is not None:
                total = jax.lax.psum(total, self.axis_name)
                total_sq = jax.lax.psum(total_sq, self.axis_name)
                count = jax.lax.psum(count, self.axis_name)
            count = jnp.maximum(count, 1.0)
            mean = total / count
            var = jnp.maximum(total_sq / count - mean * mean, 0.0)
            if not self.is_initializing():
                unbiased = var * count / jnp.maximum(count - 1.0, 1.0)
                ra_mean.value = (
                    (1.0 - self.momentum) * ra_mean.value + self.momentum * mean
                )
                ra_var.value = (
                    (1.0 - self.momentum) * ra_var.value + self.momentum * unbiased
                )

        out_dtype = h.dtype
        eff_scale = scale * jax.lax.rsqrt(var + self.eps)
        eff_bias = (bias - mean * eff_scale).astype(out_dtype)
        eff_scale = eff_scale.astype(out_dtype)
        sel = jnp.where(eff_scale >= 0, xmax.astype(out_dtype),
                        xmin.astype(out_dtype))
        return jax.nn.relu(sel * eff_scale + eff_bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with constant (non-trainable, non-updating) statistics and
    affine params — reference ``FrozenBatchNorm2d`` (`act/backbone.py:23-58`).

    Parameters live in the ``batch_stats`` collection so the optimizer never
    sees them; weight-porting utilities overwrite them directly.
    """

    eps: float = 1e-5
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        features = x.shape[-1]
        mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros((features,), jnp.float32)
        ).value
        var = self.variable(
            "batch_stats", "var", lambda: jnp.ones((features,), jnp.float32)
        ).value
        scale = self.variable(
            "batch_stats", "scale", lambda: jnp.ones((features,), jnp.float32)
        ).value
        bias = self.variable(
            "batch_stats", "bias", lambda: jnp.zeros((features,), jnp.float32)
        ).value
        y = (x.astype(jnp.float32) - mean) * jax.lax.rsqrt(var + self.eps)
        y = y * scale + bias
        return y.astype(self.dtype or x.dtype)


class BitsDropout(nn.Module):
    """Dropout from uint8 random bits — 4x less RNG work than nn.Dropout.

    ``nn.Dropout`` draws one 32-bit random word per element for the
    (B, 2051, 512) residual streams of the ACT encoder. Drawing uint8 bits
    quarters that RNG work; the drop rate is quantized to the nearest 1/256
    (0.1 -> 25.6/256
    rounds to 26/256 = 0.1016), the same documented trade as ``EfficientMHA``
    in `act/transformer.py`. Expectation is exactly preserved (inverse scaling
    uses the quantized keep probability); only the train-time noise
    granularity changes vs the reference's torch dropout.
    """

    rate: float
    deterministic: Optional[bool] = None

    @nn.compact
    def __call__(self, x: jax.Array,
                 deterministic: Optional[bool] = None) -> jax.Array:
        deterministic = nn.merge_param(
            "deterministic", self.deterministic, deterministic
        )
        if self.rate == 0.0 or deterministic:
            return x
        # round-to-nearest halves the quantization bias vs ceil (0.1 ->
        # 25.6/256 = 0.1000 at the nearest grid point); floor at 1 so tiny
        # nonzero rates still drop
        threshold = max(1, int(round(self.rate * 256)))
        if threshold >= 256:
            return jnp.zeros_like(x)
        keep_prob = (256 - threshold) / 256.0
        bits = jax.random.bits(self.make_rng("dropout"), x.shape, jnp.uint8)
        return jnp.where(
            bits >= jnp.uint8(threshold),
            x * jnp.asarray(1.0 / keep_prob, x.dtype),
            jnp.zeros((), x.dtype),
        )


class MLP(nn.Module):
    """Simple ReLU MLP head (DETR-style)."""

    hidden_dim: int
    output_dim: int
    num_layers: int
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        for i in range(self.num_layers - 1):
            x = nn.Dense(self.hidden_dim, dtype=self.dtype)(x)
            x = jax.nn.relu(x)
        return nn.Dense(self.output_dim, dtype=self.dtype)(x)

"""Farthest point sampling as one Pallas kernel, GPU route: Triton.

The design is the reference CUDA kernel's (`sampling_cuda_kernel.cu:14-129`):
one program per cloud runs all ``npoints`` rounds in a loop. The cloud's
coordinates and its running min-distance cache stay in registers for the
whole loop; each round updates the cache, reduces it to its argmax inside
the block, and reads the chosen point's coordinates back with three scalar
loads. The plain XLA version (`pointops._farthest_point_sampling_padded_xla`)
instead runs every round as separate small kernels.

Triton blocks are powers of two, so each row is padded to ``N_pow2`` with
slots whose distance starts at -1 and can never be chosen while a valid point
has a non-negative distance. At 16 warps a 16,384-point row holds 32 points
per thread and 4 values per point (x, y, z, min-distance): 128 of the 255
registers a thread may use.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

_BIG = 1.0e10

# Largest padded row the kernel holds in registers (32 warps x 32 threads x
# 32 points per thread); wider rows use the XLA loop.
MAX_POINTS = 32768


def _fps_kernel(x_ref, y_ref, z_ref, d_ref, o_ref, *, npoints: int):
    x, y, z = x_ref[...], y_ref[...], z_ref[...]

    def body(i, carry):
        dist, px, py, pz = carry
        dx, dy, dz = x - px, y - py, z - pz
        dist = jnp.minimum(dist, dx * dx + dy * dy + dz * dz)
        # first index of the maximum: the tie rule of jnp.argmax
        sel = jnp.argmax(dist).astype(jnp.int32)
        o_ref[i] = sel
        return dist, x_ref[sel], y_ref[sel], z_ref[sel]

    # seed at index 0, as the CUDA kernel seeds at the segment start
    o_ref[0] = jnp.int32(0)
    jax.lax.fori_loop(
        1, npoints, body, (d_ref[...], x_ref[0], y_ref[0], z_ref[0])
    )


def supported(n: int) -> bool:
    """Whether a row of ``n`` points fits the kernel's registers."""
    return pl.next_power_of_2(n) <= MAX_POINTS


def _num_warps(n_pow2: int) -> int:
    return max(4, min(32, n_pow2 // 1024))


@functools.partial(jax.jit, static_argnames=("npoints", "interpret"))
def farthest_point_sampling_padded_triton(
    xyz: jax.Array, mask: jax.Array, npoints: int, interpret: bool = False
) -> jax.Array:
    """Same contract as ``pointops._farthest_point_sampling_padded_xla``:
    (B, N, 3), (B, N) -> (B, npoints) int32, seeded at index 0. Geometry is
    float32 whatever the input dtype."""
    B, N, _ = xyz.shape
    n_pow2 = pl.next_power_of_2(N)
    if not supported(N):
        raise ValueError(f"FPS kernel holds at most {MAX_POINTS} points, got {N}")
    out_pow2 = pl.next_power_of_2(npoints)
    pad = n_pow2 - N
    xyz = jnp.pad(xyz.astype(jnp.float32), ((0, 0), (0, pad), (0, 0)))
    valid = jnp.pad(mask.astype(bool), ((0, 0), (0, pad)))
    dist0 = jnp.where(valid, _BIG, -1.0).astype(jnp.float32)
    row = pl.BlockSpec((None, n_pow2), lambda b: (b, 0))
    out = pl.pallas_call(
        functools.partial(_fps_kernel, npoints=npoints),
        out_shape=jax.ShapeDtypeStruct((B, out_pow2), jnp.int32),
        grid=(B,),
        in_specs=[row, row, row, row],
        out_specs=pl.BlockSpec((None, out_pow2), lambda b: (b, 0)),
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=_num_warps(n_pow2), num_stages=1
        ),
        interpret=interpret,
        name="fps_triton",
    )(xyz[..., 0], xyz[..., 1], xyz[..., 2], dist0)
    return out[:, :npoints]

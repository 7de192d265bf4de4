"""Device-side sparse-voxel primitives for submanifold / strided 3D convs.

The reference builds SpUNet/PointNet on the ``spconv`` CUDA library
(`src/models/components/pcd_encoder/spunet.py:10`), whose core is a
rulebook: per kernel-offset index pairs built by hashing voxel coordinates.
Static-shape reformulation (SURVEY §7.1 decision 2), fully on device with
static shapes:

- voxel coords are linearized to int32 keys and **sorted once per
  resolution**; neighbor lookup for all kernel offsets is a vectorized
  binary search (``searchsorted``) over the sorted keys — O(K·N·log N)
  with no host round-trips and no dynamic shapes
- a submanifold conv is then ``sum_k gather(feat, idx_k) @ W_k``, evaluated
  as one stacked ``(N, K*Ci) x (K*Ci, Co)`` matmul
- strided down-conv = per-point tap matmul + deterministic scatter-add onto
  first-occurrence "representative" slots of the parent voxel (replacing
  spconv's atomic rulebook scatter); the padded point count is carried
  unchanged with a shrinking validity mask
- inverse up-conv gathers the parent feature back to each child point
  (spconv's indice-key reuse semantics: child positions are exactly the
  pre-downsample point set)

Coordinates must be non-negative and < 1024 per axis (int32 keys; grid
sampling at 5 mm over table-top scenes uses < 300 — `transformpcd.py` grid
sample shifts to the origin).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

_S = 1024  # per-axis coordinate bound for key linearization
_INVALID = np.int32(2**31 - 1)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """(K, 3) integer offsets of a centered cubic kernel, row-major — the
    iteration order spconv uses for its weight planes."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def linearize(grid_coord: jax.Array, valid: jax.Array) -> jax.Array:
    """(B, N, 3) int coords -> (B, N) int32 keys; invalid/out-of-range ->
    INT32_MAX (sorts to the tail)."""
    gc = grid_coord.astype(jnp.int32)
    in_range = jnp.all((gc >= 0) & (gc < _S), axis=-1)
    key = (gc[..., 0] * _S + gc[..., 1]) * _S + gc[..., 2]
    return jnp.where(valid & in_range, key, _INVALID)


@functools.partial(jax.jit, static_argnames=("offsets_tuple",))
def _neighbor_indices_impl(grid_coord, valid, offsets_tuple):
    offsets = jnp.asarray(np.array(offsets_tuple, np.int32))  # (K, 3)
    key = linearize(grid_coord, valid)  # (B, N)
    order = jnp.argsort(key, axis=-1)
    sorted_key = jnp.take_along_axis(key, order, axis=-1)

    q_coord = grid_coord[:, :, None, :] + offsets[None, None, :, :]  # (B,N,K,3)
    q_valid = jnp.broadcast_to(valid[:, :, None], q_coord.shape[:-1])
    q_key = linearize(q_coord, q_valid)  # (B, N, K)

    def row(sk, ord_, qk):
        pos = jnp.searchsorted(sk, qk.reshape(-1))
        pos = jnp.clip(pos, 0, sk.shape[0] - 1)
        found = sk[pos] == qk.reshape(-1)
        idx = jnp.where(found, ord_[pos], -1)
        return idx.reshape(qk.shape)

    idx = jax.vmap(row)(sorted_key, order, q_key)
    # queries from invalid slots and unmatched keys are -1
    return jnp.where(q_key == _INVALID, -1, idx).astype(jnp.int32)


def neighbor_indices(grid_coord: jax.Array, valid: jax.Array,
                     offsets: np.ndarray) -> jax.Array:
    """For each point and kernel offset, the index of the neighbor voxel in
    the same batch row, or -1. ``offsets`` is a static (K, 3) array."""
    return _neighbor_indices_impl(
        grid_coord, valid, tuple(map(tuple, np.asarray(offsets).tolist()))
    )


def gather_neighbors(feat: jax.Array, idx: jax.Array) -> jax.Array:
    """(B, N, C), (B, N, K) -> (B, N, K, C); -1 -> zeros."""
    B, N, K = idx.shape
    safe = jnp.maximum(idx, 0)
    g = jax.vmap(lambda f, i: f[i])(feat, safe.reshape(B, N * K))
    g = g.reshape(B, N, K, feat.shape[-1])
    return jnp.where((idx < 0)[..., None], 0.0, g)


def submconv(feat: jax.Array, weight: jax.Array, idx: jax.Array) -> jax.Array:
    """Submanifold sparse conv as a single stacked matmul.

    Args:
        feat: (B, N, Ci)
        weight: (K, Ci, Co) — one plane per kernel offset
        idx: (B, N, K) neighbor indices from ``neighbor_indices``
    Returns:
        (B, N, Co)
    """
    B, N, K = idx.shape
    Ci, Co = weight.shape[1], weight.shape[2]
    gathered = gather_neighbors(feat, idx).reshape(B, N, K * Ci)
    return jnp.einsum(
        "bnk,ko->bno", gathered, weight.reshape(K * Ci, Co),
        preferred_element_type=jnp.float32,
    ).astype(feat.dtype)


def voxel_downsample(grid_coord: jax.Array, valid: jax.Array):
    """Stride-2 voxel pooling bookkeeping.

    Returns:
        parent_coord: (B, N, 3) ``grid_coord // 2`` (valid where input valid)
        rep: (B, N) int32 — for every point, the index of the representative
            (first-occurrence) point of its parent voxel; -1 for invalid
        new_valid: (B, N) — True only at representative slots. The padded
            length N is unchanged; downstream levels just carry more padding.
    """
    parent = jnp.where(valid[..., None], grid_coord // 2, 0)
    key = linearize(parent, valid)  # (B, N)
    N = key.shape[1]
    order = jnp.argsort(key, axis=-1)
    sorted_key = jnp.take_along_axis(key, order, axis=-1)
    prev = jnp.concatenate(
        [jnp.full_like(sorted_key[:, :1], -1), sorted_key[:, :-1]], axis=1
    )
    is_first = sorted_key != prev  # (B, N) in sorted space
    pos = jnp.arange(N)[None, :]
    first_pos = jnp.where(is_first, pos, 0)
    group_first = jax.lax.associative_scan(jnp.maximum, first_pos, axis=1)
    rep_sorted = jnp.take_along_axis(order, group_first, axis=1)  # orig idx
    # scatter back to original point order
    rep = jnp.zeros_like(rep_sorted)
    rep = jax.vmap(lambda r, o, v: r.at[o].set(v))(rep, order, rep_sorted)
    rep = jnp.where(valid, rep, -1)
    new_valid = jnp.zeros_like(valid)
    new_valid = jax.vmap(
        lambda nv, o, f: nv.at[o].set(f)
    )(new_valid, order, is_first & (sorted_key != _INVALID))
    return parent, rep.astype(jnp.int32), new_valid


def strided_downconv(feat: jax.Array, weight: jax.Array, grid_coord: jax.Array,
                     rep: jax.Array, valid: jax.Array) -> jax.Array:
    """Stride-2 sparse conv: each point contributes ``feat @ W[tap]`` (tap =
    its position inside the 2x2x2 window) scatter-added onto its parent's
    representative slot. Deterministic segment scatter — improves on
    spconv's atomicAdd (SURVEY §5.2).

    weight: (8, Ci, Co), tap order = binary (x, y, z) low bits.
    """
    local = (grid_coord & 1)
    tap = (local[..., 0] * 2 + local[..., 1]) * 2 + local[..., 2]  # (B,N) 0..7
    onehot = jax.nn.one_hot(tap, 8, dtype=feat.dtype)  # (B, N, 8)
    # contrib[b,n] = feat[b,n] @ W[tap[b,n]]  — as one stacked matmul
    B, N, Ci = feat.shape
    Co = weight.shape[-1]
    mixed = jnp.einsum("bnc,bnk->bnkc", feat, onehot).reshape(B, N, 8 * Ci)
    contrib = jnp.einsum(
        "bnk,ko->bno", mixed, weight.reshape(8 * Ci, Co),
        preferred_element_type=jnp.float32,
    ).astype(feat.dtype)
    contrib = jnp.where(valid[..., None], contrib, 0.0)
    safe_rep = jnp.maximum(rep, 0)
    out = jnp.zeros((B, N, Co), contrib.dtype)
    return jax.vmap(lambda o, r, c: o.at[r].add(c))(out, safe_rep, contrib)


def inverse_upconv(parent_feat: jax.Array, weight: jax.Array,
                   grid_coord: jax.Array, rep: jax.Array,
                   valid: jax.Array) -> jax.Array:
    """Inverse of ``strided_downconv`` (spconv SparseInverseConv3d semantics):
    each child point reads its parent's feature through its tap weight.

    parent_feat: (B, N, Ci) features living on representative slots.
    weight: (8, Ci, Co).
    """
    B, N = rep.shape
    safe_rep = jnp.maximum(rep, 0)
    gathered = jax.vmap(lambda f, r: f[r])(parent_feat, safe_rep)  # (B,N,Ci)
    gathered = jnp.where(valid[..., None], gathered, 0.0)
    local = (grid_coord & 1)
    tap = (local[..., 0] * 2 + local[..., 1]) * 2 + local[..., 2]
    onehot = jax.nn.one_hot(tap, 8, dtype=gathered.dtype)
    Ci, Co = weight.shape[1], weight.shape[2]
    mixed = jnp.einsum("bnc,bnk->bnkc", gathered, onehot).reshape(B, N, 8 * Ci)
    return jnp.einsum(
        "bnk,ko->bno", mixed, weight.reshape(8 * Ci, Co),
        preferred_element_type=jnp.float32,
    ).astype(parent_feat.dtype)

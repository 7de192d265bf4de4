"""pointops — point-cloud primitives (JAX).

Re-implements the 16-symbol API of the reference CUDA extension
(`libs/pointops/functions/__init__.py:1-14`) in two layers:

1. **Padded-native core** (`*_padded`): operates on fixed-shape
   ``(B, N, ...)`` tensors with boolean validity masks. This is the layout
   the whole compute path uses — XLA requires static shapes, and batched
   dense tensors map onto matmuls and vector ops, unlike the reference's
   packed "offset" layout. All core ops are jittable and differentiable
   where the reference kernels have backward passes.

2. **Packed-offset API wrappers**: the reference's exact signatures
   (``xyz (n,3)``, ``offset (b,)`` prefix sums — see
   `libs/pointops/functions/sampling.py:6-26`) for parity tests and host-side
   use. They pad per-segment, call the core, and re-pack; they are eager
   (shapes are data-dependent) and not meant for the jitted hot path.

Semantics matched against the CUDA kernels:
- FPS seeds at the segment start and iteratively argmaxes the running
  min-distance cache (`sampling_cuda_kernel.cu:14-129`).
- kNN pads short segments with idx ``-1`` / dist2 ``1e10``, results sorted by
  ascending distance (`knn_query_cuda_kernel.cu:60-104`); the python wrapper
  returns sqrt distances (`functions/query.py:6-23`).
- Ball query keeps candidates with ``d2 <= 1e-5 or min_r^2 <= d2 < max_r^2``,
  sorts ascending, and evenly strides down when oversampled
  (`ball_query_cuda_kernel.cu:57-120`). The reference writes the candidate
  *index* into dist2 in the oversampled branch — a latent bug we do not
  replicate (we return the true distance).
- aggregation tiles ``weight`` across channel groups of size ``w_c``
  (`aggregation_cuda_kernel.cu:5-20`).
- attention_relation_step / attention_fusion_step are edge-list scatter
  attention primitives (`attention_cuda_kernel.cu:9-90`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pointcloudmatters_tpu.ops import fps_triton

__all__ = [
    # padded-native core
    "farthest_point_sampling_padded",
    "knn_query_padded",
    "ball_query_padded",
    "random_ball_query_padded",
    "grouping_padded",
    "interpolation_padded",
    "subtraction_padded",
    "aggregation_padded",
    "knn_query_and_group_padded",
    # packed-offset API (reference signatures)
    "farthest_point_sampling",
    "knn_query",
    "ball_query",
    "random_ball_query",
    "grouping",
    "grouping2",
    "interpolation",
    "interpolation2",
    "subtraction",
    "aggregation",
    "attention_relation_step",
    "attention_fusion_step",
    "knn_query_and_group",
    "ball_query_and_group",
    "query_and_group",
    "offset2batch",
    "batch2offset",
    "offset2bincount",
]

_BIG = 1.0e10


def _sqdist(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pairwise squared euclidean distance (..., M, 3) x (..., N, 3) -> (..., M, N).

    Matmul expansion |a|^2 + |b|^2 - 2ab^T: the cross term is one matmul and
    the result is (..., M, N) directly, with no (..., M, N, 3) intermediate.
    Clamped at zero against cancellation."""
    a2 = jnp.sum(a * a, axis=-1)[..., :, None]
    b2 = jnp.sum(b * b, axis=-1)[..., None, :]
    # precision=HIGHEST: a default-precision f32 matmul may run in TF32 (on
    # the GPU) or bf16 passes, and the expansion then cancels
    # catastrophically — ~5e-4 absolute d2 noise on unit-box clouds re-ranks
    # most kNN neighbours. Contraction depth is 3, so full precision costs
    # nothing.
    ab = jnp.einsum("...mc,...nc->...mn", a, b,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST).astype(a.dtype)
    return jnp.maximum(a2 + b2 - 2.0 * ab, 0.0)


# ---------------------------------------------------------------------------
# Farthest point sampling
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("npoints",))
def _farthest_point_sampling_padded_xla(
    xyz: jax.Array, mask: jax.Array, npoints: int
) -> jax.Array:
    """Iterative FPS over padded batches, as plain XLA.

    Args:
        xyz: (B, N, 3) float coordinates; valid points must be packed at the
            front of each row (index 0 valid).
        mask: (B, N) bool validity.
        npoints: number of samples per batch row.

    Returns:
        (B, npoints) int32 indices into N. Seeds at index 0 like the CUDA
        kernel seeds at the segment start (`sampling_cuda_kernel.cu:39`).
        When a row has fewer than ``npoints`` valid points, indices repeat
        (running min-distance hits zero), matching reference behavior.
        Distances are direct coordinate differences, as in the CUDA kernel.
    """
    B, N, _ = xyz.shape
    valid = mask.astype(bool)
    # padding slots get -1 so they are never argmax-selected while any valid
    # point still has nonnegative running distance
    init_dist = jnp.where(valid, _BIG, -1.0).astype(xyz.dtype)
    out0 = jnp.zeros((B, npoints), jnp.int32)
    start = jnp.zeros((B,), jnp.int32)

    def body(i, carry):
        dist, last, out = carry
        p = jnp.take_along_axis(xyz, last[:, None, None], axis=1)  # (B,1,3)
        diff = xyz - p
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        dist = jnp.minimum(dist, d)  # padding stays at -1
        nxt = jnp.argmax(dist, axis=-1).astype(jnp.int32)
        out = out.at[:, i].set(nxt)
        return dist, nxt, out

    _, _, out = lax.fori_loop(1, npoints, body, (init_dist, start, out0))
    return out


# ---------------------------------------------------------------------------
# kNN query
# ---------------------------------------------------------------------------

def _topk_min(d2: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """k smallest of ``d2`` along the last axis by iterative min-extraction:
    k passes of (min, argmin, mask-out). Ascending output."""
    vals, idxs = [], []
    for _ in range(k):
        a = jnp.argmin(d2, axis=-1)
        v = jnp.take_along_axis(d2, a[..., None], axis=-1)[..., 0]
        vals.append(v)
        idxs.append(a.astype(jnp.int32))
        d2 = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, d2.shape, d2.ndim - 1)
            == a[..., None],
            _BIG, d2,
        )
    return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)


@functools.partial(jax.jit, static_argnames=("nsample", "chunk"))
def _knn_query_padded_xla(
    new_xyz: jax.Array,
    xyz: jax.Array,
    mask: jax.Array,
    nsample: int,
    chunk: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Exact kNN of ``new_xyz`` queries in the padded reference cloud.

    Scans the reference cloud in fixed-size chunks; each chunk is reduced to
    its local k nearest via iterative min-extraction (no sorting networks —
    see ``_topk_min``), then merged with the running best the same way. Peak
    memory is O(B*M*(k+chunk)) instead of O(B*M*N)
    (a memory-frugal analog of `knn_query_cuda_kernel.cu:60-104`).

    Args:
        new_xyz: (B, M, 3) query points.
        xyz: (B, N, 3) reference points.
        mask: (B, N) bool validity of reference points.
        nsample: k.
        chunk: reference-chunk length per scan step.

    Returns:
        idx: (B, M, nsample) int32, ``-1`` placeholder where fewer than k
            valid references exist.
        dist2: (B, M, nsample) squared distances, ascending, ``1e10``
            placeholders. (The packed wrapper sqrt's this like
            `functions/query.py:23`.)
    """
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    chunk = min(chunk, N)
    n_chunks = -(-N // chunk)
    N_pad = n_chunks * chunk
    if N_pad != N:
        xyz = jnp.pad(xyz, ((0, 0), (0, N_pad - N), (0, 0)))
        mask = jnp.pad(mask, ((0, 0), (0, N_pad - N)))

    xyz_c = xyz.reshape(B, n_chunks, chunk, 3).transpose(1, 0, 2, 3)
    mask_c = mask.reshape(B, n_chunks, chunk).transpose(1, 0, 2)
    base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

    best_d = jnp.full((B, M, nsample), _BIG, jnp.float32)
    best_i = jnp.full((B, M, nsample), -1, jnp.int32)

    def step(carry, inp):
        bd, bi = carry
        pts, msk, offs = inp
        d2 = _sqdist(new_xyz, pts)  # (B, M, chunk)
        d2 = jnp.where(msk[:, None, :], d2, _BIG)
        # local k-best of this chunk, then merge with the running k-best
        loc_d, loc_i = _topk_min(d2, nsample)
        loc_i = jnp.where(loc_d >= _BIG, -1, loc_i + offs)
        cand_d = jnp.concatenate([bd, loc_d], axis=-1)  # (B, M, 2k)
        cand_i = jnp.concatenate([bi, loc_i], axis=-1)
        new_d, sel = _topk_min(cand_d, nsample)
        return (new_d, jnp.take_along_axis(cand_i, sel, axis=-1)), None

    (best_d, best_i), _ = lax.scan(step, (best_d, best_i), (xyz_c, mask_c, base))
    best_i = jnp.where(best_d >= _BIG, -1, best_i)
    return best_i, best_d




def kernel_route() -> str:
    """The one place that chooses how the point ops run on this platform.

    ``"triton"`` on a GPU: FPS runs its Pallas kernel (`ops/fps_triton.py`).
    ``"xla"`` on the CPU (tests): every op runs its plain XLA version. Any
    other platform raises — nothing falls back silently.
    """
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(
        f"no point-op route for platform {platform!r}; expected 'gpu' or 'cpu'"
    )


def farthest_point_sampling_padded(
    xyz: jax.Array, mask: jax.Array, npoints: int
) -> jax.Array:
    """Iterative FPS over padded batches; see `_farthest_point_sampling_padded_xla`
    for semantics. Geometry runs in float32 whatever the compute dtype. On a
    GPU, rows of up to ``fps_triton.MAX_POINTS`` points run the one-program-
    per-cloud Triton kernel (`ops/fps_triton.py`)."""
    xyz = xyz.astype(jnp.float32)
    if kernel_route() == "triton" and fps_triton.supported(xyz.shape[1]):
        return fps_triton.farthest_point_sampling_padded_triton(
            xyz, mask, npoints
        )
    return _farthest_point_sampling_padded_xla(xyz, mask, npoints)


def knn_query_padded(
    new_xyz: jax.Array,
    xyz: jax.Array,
    mask: jax.Array,
    nsample: int,
    chunk: int = 2048,
) -> tuple[jax.Array, jax.Array]:
    """Exact kNN over padded batches; see `_knn_query_padded_xla` for
    semantics. Geometry runs in float32 whatever the compute dtype."""
    return _knn_query_padded_xla(
        new_xyz.astype(jnp.float32), xyz.astype(jnp.float32), mask, nsample,
        chunk=chunk,
    )


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("nsample",))
def ball_query_padded(
    new_xyz: jax.Array,
    xyz: jax.Array,
    mask: jax.Array,
    nsample: int,
    max_radius: float,
    min_radius: float = 0.0,
) -> tuple[jax.Array, jax.Array]:
    """Radius query mirroring `ball_query_cuda_kernel.cu:57-120`.

    Candidates satisfy ``d2 <= 1e-5 or min_r^2 <= d2 < max_r^2``; sorted
    ascending by distance; if more than ``nsample`` survive, every
    ``cnt/nsample``-th is kept (even striding). Returns true squared
    distances (the reference's oversampled branch leaks indices into dist2 —
    not replicated).
    """
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    d2 = _sqdist(new_xyz, xyz)  # (B, M, N)
    in_range = (d2 <= 1e-5) | ((d2 >= min_radius**2) & (d2 < max_radius**2))
    in_range &= mask[:, None, :]
    d2s = jnp.where(in_range, d2, _BIG)
    order = jnp.argsort(d2s, axis=-1)  # ascending; invalid at the tail
    d2_sorted = jnp.take_along_axis(d2s, order, axis=-1)
    cnt = jnp.sum(in_range, axis=-1)  # (B, M)

    k_iota = jax.lax.broadcasted_iota(jnp.int32, (B, M, nsample), 2)
    sep = cnt[..., None].astype(jnp.float32) / nsample
    strided_pos = (sep * k_iota.astype(jnp.float32)).astype(jnp.int32)
    direct_pos = k_iota
    pos = jnp.where(cnt[..., None] > nsample, strided_pos, direct_pos)
    pos = jnp.clip(pos, 0, N - 1)
    idx = jnp.take_along_axis(order, pos, axis=-1).astype(jnp.int32)
    dist2 = jnp.take_along_axis(d2_sorted, pos, axis=-1)
    missing = direct_pos >= cnt[..., None]
    taking_all = cnt[..., None] <= nsample
    invalid = taking_all & missing
    idx = jnp.where(invalid, -1, idx)
    dist2 = jnp.where(invalid, _BIG, dist2)
    return idx, dist2


@functools.partial(jax.jit, static_argnames=("nsample",))
def random_ball_query_padded(
    key: jax.Array,
    new_xyz: jax.Array,
    xyz: jax.Array,
    mask: jax.Array,
    nsample: int,
    max_radius: float,
    min_radius: float = 0.0,
) -> tuple[jax.Array, jax.Array]:
    """Ball query where candidates are taken in random order instead of by
    distance (`functions/query.py:26-69`)."""
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    d2 = _sqdist(new_xyz, xyz)
    in_range = (d2 <= 1e-5) | ((d2 >= min_radius**2) & (d2 < max_radius**2))
    in_range &= mask[:, None, :]
    # per-row random priority; out-of-range pushed to the tail
    prio = jax.random.uniform(key, (B, 1, N))
    prio = jnp.broadcast_to(prio, (B, M, N))
    prio = jnp.where(in_range, prio, 2.0)
    order = jnp.argsort(prio, axis=-1)
    take = order[..., :nsample].astype(jnp.int32)
    taken_ok = jnp.take_along_axis(in_range, order, axis=-1)[..., :nsample]
    dist2 = jnp.take_along_axis(d2, take, axis=-1)
    idx = jnp.where(taken_ok, take, -1)
    dist2 = jnp.where(taken_ok, dist2, _BIG)
    return idx, dist2


# ---------------------------------------------------------------------------
# Grouping / subtraction / aggregation / interpolation
# ---------------------------------------------------------------------------

def grouping_padded(
    idx: jax.Array,
    feat: jax.Array,
    xyz: jax.Array | None = None,
    new_xyz: jax.Array | None = None,
    with_xyz: bool = False,
) -> jax.Array:
    """Gather neighborhoods; ``-1`` indices produce zeros.

    Mirrors the pure-torch grouping with the ``sign(idx+1)`` mask trick
    (`functions/grouping.py:35-59`). Differentiable (XLA gather/scatter-add —
    deterministic, unlike the reference's atomicAdd backward).

    Args:
        idx: (B, M, K) int32 into N, -1 = hole.
        feat: (B, N, C).
        xyz / new_xyz: (B, N, 3) / (B, M, 3), needed when ``with_xyz``.
    Returns:
        (B, M, K, C) or (B, M, K, 3 + C) with leading relative coordinates.
    """
    B, M, K = idx.shape
    safe = jnp.maximum(idx, 0)
    hole = (idx < 0)[..., None]
    gf = jax.vmap(lambda f, i: f[i])(feat, safe.reshape(B, M * K))
    gf = gf.reshape(B, M, K, feat.shape[-1])
    gf = jnp.where(hole, 0.0, gf)
    if not with_xyz:
        return gf
    assert xyz is not None and new_xyz is not None
    gx = jax.vmap(lambda p, i: p[i])(xyz, safe.reshape(B, M * K)).reshape(B, M, K, 3)
    gx = gx - new_xyz[:, :, None, :]
    gx = jnp.where(hole, 0.0, gx)
    return jnp.concatenate([gx, gf], axis=-1)


def subtraction_padded(input1: jax.Array, input2: jax.Array, idx: jax.Array) -> jax.Array:
    """(B,N,C), (B,N,C), (B,N,K) -> (B,N,K,C): ``input1[i] - input2[idx[i,k]]``
    (`functions/subtraction.py:6-37`)."""
    B, N, K = idx.shape
    safe = jnp.maximum(idx, 0)
    g2 = jax.vmap(lambda f, i: f[i])(input2, safe.reshape(B, N * K))
    g2 = g2.reshape(B, N, K, input2.shape[-1])
    return input1[:, :, None, :] - g2


def aggregation_padded(
    input: jax.Array, position: jax.Array, weight: jax.Array, idx: jax.Array
) -> jax.Array:
    """Position-weighted neighborhood aggregation (`aggregation_cuda_kernel.cu:5-20`).

    out[b,i,c] = sum_k (input[b, idx[b,i,k], c] + position[b,i,k,c])
                 * weight[b,i,k, c mod w_c]
    """
    B, N, K, C = position.shape
    w_c = weight.shape[-1]
    safe = jnp.maximum(idx, 0)
    gi = jax.vmap(lambda f, i: f[i])(input, safe.reshape(B, N * K))
    gi = gi.reshape(B, N, K, C)
    w = jnp.tile(weight, (1, 1, 1, C // w_c))
    return jnp.sum((gi + position) * w, axis=2)


def interpolation_padded(
    xyz: jax.Array,
    new_xyz: jax.Array,
    feat: jax.Array,
    mask: jax.Array,
    k: int = 3,
) -> jax.Array:
    """Inverse-distance-weighted kNN feature interpolation
    (`functions/interpolation.py:8-23`): weights = (1/(dist+1e-8)) normalized
    over the k neighbors, with dist the *euclidean* distance."""
    idx, dist2 = knn_query_padded(new_xyz, xyz, mask, k)
    dist = jnp.sqrt(dist2)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / jnp.sum(recip, axis=-1, keepdims=True)  # (B,M,k)
    g = grouping_padded(idx, feat)  # (B,M,k,C)
    return jnp.sum(g * weight[..., None], axis=2)


def gather_rows_padded(feat: jax.Array, idx: jax.Array) -> jax.Array:
    """Batched row gather ``feat[b, idx[b, ...], :]`` -> ``(B, *idx.shape[1:], C)``.

    Flattens the batch into one big row-gather (``jnp.take`` over a
    ``(B*N, C)`` table): a single gather of contiguous rows instead of the
    batched-gather HLO that ``vmap``/``take_along_axis`` produce. Negative
    indices are clamped to 0 (callers mask holes themselves).

    ``mode="clip"`` is essential, not cosmetic: the default FILL_OR_DROP
    gather uses a NaN fill value whose zero-times-NaN masking leaks NaNs into
    the *gradient* when XLA fuses the transpose-scatter with surrounding
    reductions (reproduced on the CPU; indices here are always
    in-bounds, so clip semantics are exact).
    """
    B, N, C = feat.shape
    flat = feat.reshape(B * N, C)
    off = (jnp.arange(B, dtype=jnp.int32) * N).reshape((B,) + (1,) * (idx.ndim - 1))
    safe = jnp.maximum(idx, 0) + off
    return jnp.take(flat, safe.reshape(-1), axis=0, mode="clip").reshape(
        idx.shape + (C,)
    )


def knn_query_and_group_padded(
    feat: jax.Array,
    xyz: jax.Array,
    mask: jax.Array,
    new_xyz: jax.Array,
    nsample: int,
    with_xyz: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Fused kNN + grouping, padded-native analog of `functions/utils.py:5-18`."""
    idx, _ = knn_query_padded(new_xyz, xyz, mask, nsample)
    return grouping_padded(idx, feat, xyz, new_xyz, with_xyz=with_xyz), idx


# ---------------------------------------------------------------------------
# Edge-list scatter attention (point-transformer primitives)
# ---------------------------------------------------------------------------

def attention_relation_step(
    query: jax.Array,
    key: jax.Array,
    weight: jax.Array,
    index_target: jax.Array,
    index_refer: jax.Array,
) -> jax.Array:
    """relation[e,g] = sum_c q[tgt[e],g,c] * k[ref[e],g,c] * w[c]
    (`attention_cuda_kernel.cu:9-24`). Differentiable."""
    q = query[index_target]  # (m,g,c)
    k = key[index_refer]
    return jnp.sum(q * k * weight[None, None, :], axis=-1)


def attention_fusion_step(
    weight: jax.Array,
    value: jax.Array,
    index_target: jax.Array,
    index_refer: jax.Array,
) -> jax.Array:
    """out[n,g,c] += w[e,g] * v[ref[e],g,c] scattered to tgt[e]
    (`attention_cuda_kernel.cu:50-66`). Deterministic segment-sum replaces the
    reference's atomicAdd."""
    contrib = weight[:, :, None] * value[index_refer]  # (m,g,c)
    out = jnp.zeros_like(value)
    return out.at[index_target].add(contrib)


# ---------------------------------------------------------------------------
# Packed-offset helpers + API wrappers (reference signatures, eager)
# ---------------------------------------------------------------------------

def offset2bincount(offset) -> np.ndarray:
    offset = np.asarray(offset)
    return np.diff(offset, prepend=0)


def offset2batch(offset) -> np.ndarray:
    """(b,) prefix sums -> (n,) batch ids (`functions/utils.py:102-115`)."""
    counts = offset2bincount(offset)
    return np.repeat(np.arange(len(counts)), counts)


def batch2offset(batch) -> np.ndarray:
    """(n,) batch ids -> (b,) prefix sums (`functions/utils.py:118-121`)."""
    batch = np.asarray(batch)
    return np.cumsum(np.bincount(batch)).astype(np.int32)


def _pack_to_padded(x, offset):
    """(n, c), (b,) -> (b, n_max, c), (b, n_max) mask."""
    x = np.asarray(x)
    counts = offset2bincount(offset)
    b, n_max = len(counts), int(counts.max())
    out = np.zeros((b, n_max) + x.shape[1:], x.dtype)
    mask = np.zeros((b, n_max), bool)
    start = 0
    for i, c in enumerate(counts):
        out[i, :c] = x[start : start + c]
        mask[i, :c] = True
        start += c
    return out, mask


def _starts(offset):
    offset = np.asarray(offset)
    return np.concatenate([[0], offset[:-1]])


def farthest_point_sampling(xyz, offset, new_offset):
    """Packed FPS: (n,3), (b,), (b,) -> (m,) global indices
    (`functions/sampling.py:6-26`)."""
    xyz_p, mask = _pack_to_padded(np.asarray(xyz, np.float32), offset)
    new_counts = offset2bincount(new_offset)
    npoints = int(new_counts.max())
    idx = np.asarray(farthest_point_sampling_padded(jnp.asarray(xyz_p), jnp.asarray(mask), npoints))
    starts = _starts(offset)
    out = [idx[i, : c] + starts[i] for i, c in enumerate(new_counts)]
    return np.concatenate(out).astype(np.int32)


def _packed_query(fn, nsample, xyz, offset, new_xyz, new_offset, **kw):
    if new_xyz is None or new_offset is None:
        new_xyz, new_offset = xyz, offset
    xyz_p, mask = _pack_to_padded(np.asarray(xyz, np.float32), offset)
    q_p, qmask = _pack_to_padded(np.asarray(new_xyz, np.float32), new_offset)
    idx_p, dist2_p = fn(jnp.asarray(q_p), jnp.asarray(xyz_p), jnp.asarray(mask), nsample, **kw)
    idx_p, dist2_p = np.asarray(idx_p), np.asarray(dist2_p)
    starts = _starts(offset)
    new_counts = offset2bincount(new_offset)
    idx_rows, d_rows = [], []
    for i, c in enumerate(new_counts):
        row_idx = idx_p[i, :c]
        row_idx = np.where(row_idx >= 0, row_idx + starts[i], -1)
        idx_rows.append(row_idx)
        d_rows.append(dist2_p[i, :c])
    return (
        np.concatenate(idx_rows, axis=0).astype(np.int32),
        np.concatenate(d_rows, axis=0),
    )


def knn_query(nsample, xyz, offset, new_xyz=None, new_offset=None):
    """Reference signature (`functions/query.py:6-23`): returns (idx (m,k),
    dist (m,k)) with *euclidean* distances."""
    idx, dist2 = _packed_query(knn_query_padded, nsample, xyz, offset, new_xyz, new_offset)
    return idx, np.sqrt(dist2)


def ball_query(nsample, max_radius, min_radius, xyz, offset, new_xyz=None, new_offset=None):
    """Reference signature (`functions/query.py:110-150`)."""
    assert min_radius < max_radius
    fn = functools.partial(ball_query_padded)
    idx, dist2 = _packed_query(
        lambda q, x, m, k: fn(q, x, m, k, max_radius, min_radius),
        nsample, xyz, offset, new_xyz, new_offset,
    )
    return idx, np.sqrt(dist2)


def random_ball_query(nsample, max_radius, min_radius, xyz, offset,
                      new_xyz=None, new_offset=None, key=None):
    """Reference signature (`functions/query.py:26-69`); pass a jax PRNG key
    instead of relying on torch's global RNG."""
    assert min_radius < max_radius
    if key is None:
        key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
    idx, dist2 = _packed_query(
        lambda q, x, m, k: random_ball_query_padded(key, q, x, m, k, max_radius, min_radius),
        nsample, xyz, offset, new_xyz, new_offset,
    )
    return idx, np.sqrt(dist2)


def grouping(idx, feat, xyz, new_xyz=None, with_xyz=False):
    """Packed gather with -1 masking (`functions/grouping.py:35-59`)."""
    if new_xyz is None:
        new_xyz = xyz
    idx = np.asarray(idx)
    feat = np.asarray(feat)
    xyz = np.asarray(xyz)
    new_xyz = np.asarray(new_xyz)
    m, nsample = idx.shape
    safe = np.maximum(idx, 0)
    grouped_feat = feat[safe]  # (m, k, c)
    grouped_feat[idx < 0] = 0.0
    if with_xyz:
        grouped_xyz = xyz[safe] - new_xyz[:, None, :]
        grouped_xyz[idx < 0] = 0.0
        return np.concatenate([grouped_xyz, grouped_feat], axis=-1)
    return grouped_feat


def grouping2(input, idx):
    """CUDA-grouping signature: (n,c), (m,k) -> (m,k,c) (`functions/grouping.py:6-32`)."""
    input = np.asarray(input)
    idx = np.asarray(idx)
    return input[np.maximum(idx, 0)]


def interpolation(xyz, new_xyz, feat, offset, new_offset, k=3):
    """IDW interpolation, packed (`functions/interpolation.py:8-23`)."""
    idx, dist = knn_query(k, xyz, offset, new_xyz, new_offset)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(axis=1, keepdims=True)
    feat = np.asarray(feat)
    safe = np.maximum(idx, 0)
    return np.einsum("mkc,mk->mc", feat[safe], weight).astype(feat.dtype)


interpolation2 = interpolation


def subtraction(input1, input2, idx):
    """(n,c), (n,c), (n,k) -> (n,k,c) (`functions/subtraction.py:6-37`)."""
    input1, input2, idx = np.asarray(input1), np.asarray(input2), np.asarray(idx)
    return input1[:, None, :] - input2[np.maximum(idx, 0)]


def aggregation(input, position, weight, idx):
    """(n,c),(n,k,c),(n,k,w_c),(n,k) -> (n,c) (`functions/aggregation.py:6-56`)."""
    input, position = np.asarray(input), np.asarray(position)
    weight, idx = np.asarray(weight), np.asarray(idx)
    c = position.shape[-1]
    w = np.tile(weight, (1, 1, c // weight.shape[-1]))
    return ((input[np.maximum(idx, 0)] + position) * w).sum(axis=1)


def knn_query_and_group(
    feat, xyz, offset=None, new_xyz=None, new_offset=None,
    idx=None, nsample=None, with_xyz=False,
):
    """`functions/utils.py:5-18`."""
    if idx is None:
        assert nsample is not None
        idx, _ = knn_query(nsample, xyz, offset, new_xyz, new_offset)
    return grouping(idx, feat, xyz, new_xyz, with_xyz), idx


def ball_query_and_group(
    feat, xyz, offset=None, new_xyz=None, new_offset=None,
    idx=None, max_radio=None, min_radio=0, nsample=None, with_xyz=False,
):
    """`functions/utils.py:21-39`."""
    if idx is None:
        assert nsample is not None and offset is not None
        assert max_radio is not None and min_radio is not None
        idx, _ = ball_query(nsample, max_radio, min_radio, xyz, offset, new_xyz, new_offset)
    return grouping(idx, feat, xyz, new_xyz, with_xyz), idx


def query_and_group(
    nsample, xyz, new_xyz, feat, idx, offset, new_offset,
    dilation=0, with_feat=True, with_xyz=True,
):
    """Dilated kNN query + group (`functions/utils.py:42-99`)."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        num_total = 1 + (nsample - 1) * (dilation + 1)
        idx_full, _ = knn_query(num_total, xyz, offset, new_xyz, new_offset)
        batch_end = list(np.asarray(offset))
        batch_start = [0] + batch_end[:-1]
        nb_end = list(np.asarray(new_offset))
        nb_start = [0] + nb_end[:-1]
        rows = []
        for i in range(len(batch_end)):
            seg = batch_end[i] - batch_start[i]
            if seg < num_total:
                soft = (seg - 1) / (nsample - 1) - 1
            else:
                soft = dilation
            cols = [int((soft + 1) * j) for j in range(nsample)]
            rows.append(idx_full[nb_start[i] : nb_end[i]][:, cols])
        idx = np.concatenate(rows, axis=0)
    if not with_feat:
        return idx
    feat = np.asarray(feat)
    xyz = np.asarray(xyz)
    new_xyz = np.asarray(new_xyz)
    safe = np.maximum(idx, 0)
    grouped_xyz = xyz[safe] - new_xyz[:, None, :]
    grouped_feat = feat[safe]
    if with_xyz:
        return np.concatenate([grouped_xyz, grouped_feat], axis=-1), idx
    return grouped_feat, idx

"""Batch collation.

Two families:

1. **Padded collate** (the default training path): point clouds
   are padded to a bucketed fixed length and stacked to dense ``(P, N, ...)``
   tensors with a validity mask. XLA needs static shapes; bucket sizes are
   rounded up to ``pad_multiple`` so the jitted train step recompiles at most
   a handful of times. This replaces the reference's packed concat collate
   (`src/utils/sparse_tensor_utils.py:36-82`) on device.

2. **Packed collate parity fns** (`point_collate_fn` / `pcd_collate_fn`):
   numpy versions of the reference API for host-side interop and tests.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

# per-point keys that get padded; anything else in a pcd dict is stacked as-is
_POINT_KEYS = ("coord", "grid_coord", "color", "feat", "normal", "segment",
               "mask", "displacement", "index")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _part1by2_np(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits over 30 (host mirror of `ops/pointops.py` Morton)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_order(coord: np.ndarray) -> np.ndarray:
    """Morton (Z-curve) permutation of an (N, 3) cloud, quantized to a 10-bit
    grid over its bounding box. Spatially-coherent point order keeps
    neighbouring points close in memory for the kNN gathers; sorting here,
    on the host in the collate worker, keeps it off the device. Point clouds
    are sets — any
    permutation of the valid points is semantically identical (FPS picks a
    different but equally valid sample; exact-kNN results are order-invariant
    up to distance ties)."""
    c = coord.astype(np.float32, copy=False)
    if len(c) == 0:
        return np.empty((0,), np.int64)
    lo = c.min(axis=0)
    scale = 1023.0 / np.maximum(c.max(axis=0) - lo, 1e-6)
    q = np.clip((c - lo) * scale, 0.0, 1023.0).astype(np.int32)
    code = (
        _part1by2_np(q[:, 0])
        | (_part1by2_np(q[:, 1]) << 1)
        | (_part1by2_np(q[:, 2]) << 2)
    )
    return np.argsort(code, kind="stable")


def default_collate(batch: Sequence):
    """Recursively stack a list of numpy samples."""
    elem = batch[0]
    if isinstance(elem, Mapping):
        return {k: default_collate([d[k] for d in batch]) for k in elem}
    if isinstance(elem, (list, tuple)) and not isinstance(elem, str):
        return [default_collate(list(group)) for group in zip(*batch)]
    if isinstance(elem, str):
        return list(batch)
    arrs = [np.asarray(b) for b in batch]
    return np.stack(arrs, axis=0)


def pad_point_clouds(pcds: list[dict], pad_multiple: int = 512,
                     max_points: int | None = None,
                     spatial_sort: bool = True) -> dict:
    """Pad a list of variable-length pcd dicts to one dense masked batch.

    Returns a dict with each per-point key stacked to ``(P, N, ...)`` plus:
    - ``valid``: (P, N) bool — True for real points (packed at the front)
    - ``count``: (P,) int32 — true point counts
    - ``offset``: (P,) int32 — cumulative counts (packed-layout parity)

    ``spatial_sort`` (default on) reorders each cloud's valid points along a
    Morton curve so the device-side chunk-skipping kNN kernel can early-out;
    see ``morton_order``.
    """
    counts = np.array([len(p["coord"]) for p in pcds], np.int32)
    n_max = int(counts.max()) if len(counts) else 0
    n_pad = _round_up(max(n_max, 1), pad_multiple)
    if max_points is not None:
        n_pad = min(n_pad, max_points)

    orders = None
    if spatial_sort:
        orders = [morton_order(np.asarray(p["coord"])[:n_pad]) for p in pcds]

    out: dict = {}
    present = [k for k in _POINT_KEYS if k in pcds[0]]
    for key in present:
        first = np.asarray(pcds[0][key])
        shape = (len(pcds), n_pad) + first.shape[1:]
        stacked = np.zeros(shape, first.dtype)
        for i, p in enumerate(pcds):
            arr = np.asarray(p[key])[:n_pad]
            if orders is not None:
                arr = arr[orders[i]]
            stacked[i, : len(arr)] = arr
        out[key] = stacked
    valid = np.zeros((len(pcds), n_pad), bool)
    for i, c in enumerate(np.minimum(counts, n_pad)):
        valid[i, :c] = True
    out["valid"] = valid
    out["count"] = np.minimum(counts, n_pad)
    out["offset"] = np.cumsum(out["count"]).astype(np.int32)
    # pass through any non-point keys (e.g. min_coord)
    for k, v in pcds[0].items():
        if k not in _POINT_KEYS and k not in out:
            out[k] = default_collate([np.asarray(p[k]) for p in pcds])
    return out


def padded_pcd_collate_fn(batch: Sequence[dict], pad_multiple: int = 512,
                          max_points: int | None = None) -> dict:
    """Padded collate: default-stack everything, pad-and-stack ``pcds``.

    Mirrors the reference's dispatch of `pcd_collate_fn`
    (`sparse_tensor_utils.py:65-82`) but produces fixed-shape masked arrays.
    For DP samples the pcds live under ``obs``.
    """
    batch = list(batch)
    holder = "obs" if ("obs" in batch[0] and isinstance(batch[0]["obs"], Mapping)
                       and "pcds" in batch[0]["obs"]) else None
    if holder is None and "pcds" not in batch[0]:
        return default_collate(batch)
    if holder:
        pcd_lists = [dict(b["obs"]).pop("pcds") for b in batch]
        batch = [
            {**b, "obs": {k: v for k, v in b["obs"].items() if k != "pcds"}}
            for b in batch
        ]
    else:
        pcd_lists = [b["pcds"] for b in batch]
        batch = [{k: v for k, v in b.items() if k != "pcds"} for b in batch]
    out = default_collate(batch)
    flat = [p for sample in pcd_lists for p in sample]
    padded = pad_point_clouds(flat, pad_multiple=pad_multiple, max_points=max_points)
    padded["clouds_per_sample"] = np.int32(len(pcd_lists[0]))
    if holder:
        out["obs"]["pcds"] = padded
    else:
        out["pcds"] = padded
    return out


# ---------------------------------------------------------------------------
# Packed-layout parity collates (host-side / tests)
# ---------------------------------------------------------------------------

def point_collate_fn(batch: Sequence):
    """Concat packed point dicts, cumsum any 'offset' key
    (`sparse_tensor_utils.py:36-62`)."""
    if not isinstance(batch, Sequence):
        raise TypeError(f"{type(batch)} is not supported.")
    elem = batch[0]
    if isinstance(elem, np.ndarray):
        return np.concatenate(list(batch), axis=0)
    if isinstance(elem, str):
        return list(batch)
    if isinstance(elem, Mapping):
        out = {k: point_collate_fn([d[k] for d in batch]) for k in elem}
        for k in out:
            if "offset" in k:
                out[k] = np.cumsum(out[k]).astype(np.int64)
        return out
    if isinstance(elem, Sequence):
        lists = [list(d) + [np.array([d[0].shape[0]])] for d in batch]
        merged = [point_collate_fn(samples) for samples in zip(*lists)]
        merged[-1] = np.cumsum(merged[-1]).astype(np.int32)
        return merged
    return default_collate(list(batch))


def pcd_collate_fn(batch: Sequence[dict]):
    """Packed-layout equivalent of the reference `pcd_collate_fn`
    (`sparse_tensor_utils.py:65-82`)."""
    batch = [dict(b) for b in batch]
    nested = "obs" in batch[0] and isinstance(batch[0]["obs"], Mapping) \
        and "pcds" in batch[0]["obs"]
    if "pcds" in batch[0] or nested:
        if nested:
            for b in batch:
                b["obs"] = dict(b["obs"])
            pcds = [b["obs"].pop("pcds") for b in batch]
        else:
            pcds = [b.pop("pcds") for b in batch]
        out = default_collate(batch)
        flat = [p for sample in pcds for p in sample]
        packed = point_collate_fn(flat)
        if nested:
            out["obs"]["pcds"] = packed
        else:
            out["pcds"] = packed
        return out
    return default_collate(batch)

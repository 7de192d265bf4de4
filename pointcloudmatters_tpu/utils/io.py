"""IO helpers (reference `src/utils/io.py`): json / h5 / npz / pickle / npy."""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(obj, path: str, **kwargs):
    with open(path, "w") as f:
        json.dump(obj, f, **kwargs)


def load_h5_data(data) -> dict:
    """Recursively materialize an h5py group (or a nested dict of arrays)
    into nested numpy dicts (reference `src/utils/io.py:81-88`)."""
    out = {}
    for k in data.keys():
        v = data[k]
        out[k] = load_h5_data(v) if hasattr(v, "keys") else np.asarray(v[()])
    return out


class NpzTrajectories:
    """Read-only view of a trajectory archive saved with ``np.savez``, whose
    keys are the HDF5 dataset paths (``traj_0/obs/agent/qpos``): indexing by
    a group name returns that group as nested dicts of arrays. It stands in
    for an ``h5py.File`` where h5py is not installed."""

    def __init__(self, path: str):
        self._npz = np.load(path)

    def __getitem__(self, group: str) -> dict:
        prefix = group.rstrip("/") + "/"
        out: dict = {}
        for key in self._npz.files:
            if not key.startswith(prefix):
                continue
            node = out
            *parents, leaf = key[len(prefix):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = self._npz[key]
        if not out:
            raise KeyError(group)
        return out

    def close(self) -> None:
        self._npz.close()


def open_trajectories(path: str):
    """A trajectory file: ``.npz`` archives need only numpy; anything else is
    opened as HDF5 (ManiSkill2's demonstration format), which needs h5py."""
    if path.endswith(".npz"):
        return NpzTrajectories(path)
    if h5py is None:
        raise ImportError(
            f"reading {path} needs h5py; convert it to .npz or install h5py"
        )
    return h5py.File(path, "r")


def trajectory_sidecar(path: str) -> str:
    """The JSON file that describes a trajectory file's episodes."""
    return os.path.splitext(path)[0] + ".json"


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path: str):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_npy(path: str, allow_pickle: bool = True):
    return np.load(path, allow_pickle=allow_pickle)


def save_npz_dict(path: str, tree: dict) -> None:
    """Save a (possibly nested) dict of arrays as a flat npz with '/'-joined keys."""
    flat = {}

    def _walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                _walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    _walk("", tree)
    np.savez(path, **flat)


def load_npz_dict(path: str) -> dict:
    """Inverse of :func:`save_npz_dict`."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def load_numpy_pickle(path: str):
    """Load an object saved via ``np.save`` with pickling (the RLBench
    preprocessing format, reference `src/utils/io.py` analog)."""
    obj = np.load(path, allow_pickle=True)
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return obj.item()
    return obj


def listdir(path: str):
    import os

    return sorted(os.listdir(path))

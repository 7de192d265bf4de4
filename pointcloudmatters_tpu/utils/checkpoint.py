"""Checkpoints as a directory holding one ``.npz`` of leaves and a JSON index.

``save_tree(path, tree)`` writes every leaf of a pytree of arrays and
scalars under its key path. ``load_tree(path)`` rebuilds plain containers
(dicts; lists for sequence positions) from the index; ``load_tree(path,
template)`` fills the structure of ``template`` instead, so optimizer-state
namedtuples and empty nodes round-trip exactly. PRNG key arrays are stored
as their key data.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import jax
import numpy as np

_ARRAYS = "arrays.npz"
_INDEX = "index.json"


def _key_entry(k) -> list:
    if isinstance(k, jax.tree_util.DictKey):
        return ["d", k.key if isinstance(k.key, (str, int)) else str(k.key)]
    if isinstance(k, jax.tree_util.SequenceKey):
        return ["i", k.idx]
    if isinstance(k, jax.tree_util.GetAttrKey):
        return ["d", k.name]
    if isinstance(k, jax.tree_util.FlattenedIndexKey):
        return ["i", k.key]
    raise TypeError(f"unsupported pytree key {k!r}")


def _leaf_name(path) -> str:
    return jax.tree_util.keystr(path)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, jax.Array) and jax.dtypes.issubdtype(
            x.dtype, jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    return np.asarray(jax.device_get(x))


def save_tree(path: str, tree: Any) -> None:
    """Writes ``tree`` to the directory ``path``, replacing what was there."""
    path = os.path.abspath(path)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {f"a{i}": _to_numpy(x) for i, (_, x) in enumerate(leaves)}
    index = [
        {"key": [_key_entry(k) for k in p], "name": _leaf_name(p)}
        for p, _ in leaves
    ]
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    with open(os.path.join(tmp, _INDEX), "w") as f:
        json.dump(index, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _build(entries: list) -> Any:
    """Nested dicts/lists from ``[(key entries, value)]``."""
    if len(entries) == 1 and not entries[0][0]:
        return entries[0][1]
    groups: dict = {}
    for key, value in entries:
        groups.setdefault((key[0][0], key[0][1]), []).append((key[1:], value))
    if all(kind == "i" for kind, _ in groups):
        return [_build(groups[k]) for k in sorted(groups, key=lambda k: k[1])]
    return {name: _build(items) for (_, name), items in groups.items()}


def load_tree(path: str, template: Optional[Any] = None) -> Any:
    """Reads a tree written by ``save_tree``: plain containers, or the
    structure of ``template`` (matched by key path)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _INDEX)) as f:
        index = json.load(f)
    with np.load(os.path.join(path, _ARRAYS)) as z:
        values = [z[f"a{i}"] for i in range(len(index))]
    if template is None:
        if not index:
            return {}
        return _build([(entry["key"], v) for entry, v in zip(index, values)])
    by_name = {entry["name"]: v for entry, v in zip(index, values)}
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    missing = [_leaf_name(p) for p, _ in paths if _leaf_name(p) not in by_name]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing[:5]}")
    return jax.tree_util.tree_unflatten(
        treedef, [by_name[_leaf_name(p)] for p, _ in paths]
    )

"""A small module system for the model stack: dataclass modules whose
parameters live in nested dicts, outside the module objects.

The API is the subset of ``flax.linen`` that the policies use, with the same
naming rules, so variable trees (and the checkpoints and weight-porting maps
built on them) keep their layout:

- a module is a dataclass; its fields are hyperparameters, plus the
  keyword-only ``parent`` and ``name``
- ``init(rngs, *args)`` returns ``{"params": ..., "batch_stats": ...}``;
  ``apply(variables, *args, rngs=..., mutable=[...])`` runs a method against
  them and, with ``mutable``, also returns the updated collections
- submodules are named by attribute in ``setup`` (``layers_0`` for the
  first element of a list attribute, ``maps_key`` for a dict entry), by
  field name when passed in as a field, and by their explicit ``name`` or
  ``ClassName_<n>`` (counted per class within each ``@compact`` call) when
  built inside a ``@compact`` method
- ``make_rng(stream)`` derives a fresh key per call from the stream's root
  key, the module's path and a per-path counter; a stream that was not
  passed falls back to ``params``

Modules are bound lazily: ``init``/``apply`` clone the root, give it a scope
(the variable store plus a path), and every submodule gets the scope of its
parent pushed with its own name.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import zlib
from typing import Any, Callable, Optional, Sequence

import jax

__all__ = ["Module", "compact", "merge_param", "while_loop"]


class _Unspecified:
    def __repr__(self) -> str:
        return "<unspecified parent>"


_UNSPECIFIED = _Unspecified()
_MISSING = object()

# modules whose methods are running, innermost last; a submodule built with
# no explicit parent takes the innermost one
_context = threading.local()


def _module_stack() -> list:
    stack = getattr(_context, "stack", None)
    if stack is None:
        stack = _context.stack = []
    return stack


# ---------------------------------------------------------------------------
# Variable store
# ---------------------------------------------------------------------------

def _copy_dicts(tree: Any) -> Any:
    """The nested dicts of ``tree`` copied, leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Store:
    """The variables, rng streams and mutability of one ``init``/``apply``."""

    def __init__(self, variables: dict, rngs: dict, mutable, initializing: bool):
        self.mutable = mutable  # True (init) or a frozenset of names
        self.variables = {
            col: _copy_dicts(tree) if self.is_mutable(col) else tree
            for col, tree in variables.items()
        }
        self.rngs = rngs
        self.initializing = initializing
        self.rng_counts: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def get(self, col: str, path: tuple, name: str):
        node = self.variables.get(col, _MISSING)
        for key in path + (name,):
            if not isinstance(node, dict) or key not in node:
                return _MISSING
            node = node[key]
        return node

    def put(self, col: str, path: tuple, name: str, value) -> None:
        if not self.is_mutable(col):
            raise ValueError(
                f"cannot set {col}/{'/'.join(path + (name,))}: collection "
                f"{col!r} is immutable here; pass mutable=[{col!r}] to apply"
            )
        node = self.variables.setdefault(col, {})
        for key in path:
            node = node.setdefault(key, {})
        node[name] = value

    def make_rng(self, stream: str, path: tuple):
        if stream not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(
                    f"{'/'.join(path) or '<root>'} needs rng stream "
                    f"{stream!r}, which was not passed"
                )
            stream = "params"
        count = self.rng_counts.get((stream, path), 0)
        self.rng_counts[(stream, path)] = count + 1
        key = jax.random.fold_in(
            self.rngs[stream], zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF
        )
        return jax.random.fold_in(key, count)


@dataclasses.dataclass(frozen=True)
class _Scope:
    store: _Store
    path: tuple = ()

    def push(self, name: str) -> "_Scope":
        return _Scope(self.store, self.path + (name,))


class Variable:
    """A named slot in a collection; ``.value`` reads and writes the store."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self.collection, self.name = scope, col, name

    @property
    def value(self):
        return self._scope.store.get(self.collection, self._scope.path, self.name)

    @value.setter
    def value(self, new) -> None:
        self._scope.store.put(self.collection, self._scope.path, self.name, new)


class _State:
    """Per-instance bookkeeping of a bound module."""

    def __init__(self):
        self.in_setup = False
        self.setup_done = False
        self.in_compact = False
        self.autoname: dict = {}


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

def compact(fn: Callable) -> Callable:
    """Marks the method that may build submodules inline (``__call__``)."""
    fn._compact = True
    return fn


# Module's own API: never wrapped as a user method
_API = frozenset({
    "setup", "param", "variable", "make_rng", "is_initializing", "init",
    "apply", "clone",
})


def _wrap_method(fn: Callable) -> Callable:
    is_compact = getattr(fn, "_compact", False)

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        scope = self.__dict__.get("_scope")
        if scope is None:  # unbound: a plain call
            return fn(self, *args, **kwargs)
        self._try_setup()
        state = self._state
        outer = state.in_compact
        if is_compact:
            state.in_compact = True
        stack = _module_stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            if is_compact and not outer:
                state.in_compact = False
                state.autoname = {}

    wrapped._compact = is_compact
    return wrapped


def _map_modules(fn: Callable, value: Any, suffix: str = "") -> Any:
    """Applies ``fn(suffix, module)`` to the modules in a field or setup
    attribute (a module, or dicts/lists/tuples of them), rebuilding the
    containers that hold one."""
    if isinstance(value, Module):
        return fn(suffix, value)
    if isinstance(value, dict):
        items = {k: _map_modules(fn, v, f"{suffix}_{k}") for k, v in value.items()}
        if any(items[k] is not value[k] for k in value):
            return type(value)(items) if type(value) is not dict else items
        return value
    if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
        items = [_map_modules(fn, v, f"{suffix}_{i}") for i, v in enumerate(value)]
        if any(a is not b for a, b in zip(items, value)):
            return type(value)(items)
        return value
    return value


@dataclasses.dataclass(repr=False, eq=False)
class Module:
    """Base class of every model component (see the module docstring)."""

    parent: Any = dataclasses.field(
        default=_UNSPECIFIED, kw_only=True, repr=False, compare=False, hash=False
    )
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("__annotations__", {})
        for key, value in list(cls.__dict__.items()):
            if (
                inspect.isfunction(value)
                and key not in fields
                and key not in _API
                and (key == "__call__" or not key.startswith("__"))
            ):
                setattr(cls, key, _wrap_method(value))
        dataclasses.dataclass(
            cls, repr=False, eq=True, unsafe_hash="__hash__" not in cls.__dict__
        )

    def __post_init__(self) -> None:
        object.__setattr__(self, "_state", _State())
        object.__setattr__(self, "_scope", None)
        parent = self.parent
        if parent is _UNSPECIFIED:
            stack = _module_stack()
            parent = stack[-1] if stack else None
            object.__setattr__(self, "parent", parent)
        if not isinstance(parent, Module) or parent._scope is None:
            return
        if parent._state.in_setup and self.name is None:
            return  # named by the attribute it is assigned to
        if not (parent._state.in_setup or parent._state.in_compact):
            raise RuntimeError(
                f"{type(self).__name__} built in {type(parent).__name__} "
                "outside setup() and @compact"
            )
        if self.name is None:
            prefix = type(self).__name__
            n = parent._state.autoname.get(prefix, 0)
            parent._state.autoname[prefix] = n + 1
            object.__setattr__(self, "name", f"{prefix}_{n}")
        object.__setattr__(self, "_scope", parent._scope.push(self.name))

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{f.name}={getattr(self, f.name, None)!r}"
            for f in dataclasses.fields(self) if f.repr
        )
        return f"{type(self).__name__}({fields})"

    # -- attribute handling --------------------------------------------------
    def __setattr__(self, key: str, value: Any) -> None:
        state = self.__dict__.get("_state")
        if state is None:  # inside the dataclass __init__
            object.__setattr__(self, key, value)
        elif state.in_setup:
            object.__setattr__(self, key, self._adopt(key, value))
        else:
            raise AttributeError(
                f"{type(self).__name__} is frozen; set attributes in setup()"
            )

    def __getattr__(self, key: str) -> Any:
        # only reached when normal lookup fails: attributes made in setup()
        d = self.__dict__
        if key.startswith("__") or d.get("_scope") is None:
            raise AttributeError(key)
        state = d["_state"]
        if not state.setup_done and not state.in_setup:
            self._try_setup()
            if key in d:
                return d[key]
        raise AttributeError(f"{type(self).__name__} has no attribute {key!r}")

    def _adopt(self, attr: str, value: Any) -> Any:
        """Binds the unnamed or parentless modules in ``value`` as children
        named after ``attr``; modules bound elsewhere stay shared."""
        cache: dict = {}

        def adopt(suffix: str, sub: Module) -> Module:
            if sub.parent is None:  # built outside: each parent gets a copy
                if id(sub) not in cache:
                    cache[id(sub)] = sub.clone(name=None)
                sub = cache[id(sub)]
            if sub.name is None:
                object.__setattr__(sub, "parent", self)
                object.__setattr__(sub, "name", f"{attr}{suffix}")
                object.__setattr__(sub, "_scope", self._scope.push(sub.name))
            return sub

        return _map_modules(adopt, value)

    def _try_setup(self) -> None:
        state = self._state
        if state.setup_done or state.in_setup or self._scope is None:
            return
        state.in_setup = True
        stack = _module_stack()
        stack.append(self)
        try:
            for f in dataclasses.fields(self):
                if f.init and f.name not in ("parent", "name"):
                    value = getattr(self, f.name)
                    object.__setattr__(self, f.name, self._adopt(f.name, value))
            self.setup()
        finally:
            stack.pop()
            state.in_setup = False
            state.autoname = {}
        state.setup_done = True

    def setup(self) -> None:
        """Builds submodules and variables; runs once, on first use."""

    # -- variables -------------------------------------------------------------
    def _bound_scope(self) -> _Scope:
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound; call it through "
                "init() or apply()"
            )
        return self._scope

    def param(self, name: str, init_fn: Callable, *args) -> Any:
        scope = self._bound_scope()
        value = scope.store.get("params", scope.path, name)
        if value is _MISSING:
            if not scope.store.is_mutable("params"):
                raise KeyError(
                    f"no parameter {'/'.join(scope.path + (name,))} in the "
                    "variables passed to apply"
                )
            value = init_fn(self.make_rng("params"), *args)
            scope.store.put("params", scope.path, name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Optional[Callable] = None,
                 *args) -> Variable:
        scope = self._bound_scope()
        if scope.store.get(col, scope.path, name) is _MISSING:
            if init_fn is None or not scope.store.is_mutable(col):
                raise KeyError(
                    f"no variable {col}/{'/'.join(scope.path + (name,))} in "
                    "the variables passed to apply"
                )
            scope.store.put(col, scope.path, name, init_fn(*args))
        return Variable(scope, col, name)

    def make_rng(self, stream: str = "params") -> jax.Array:
        scope = self._bound_scope()
        return scope.store.make_rng(stream, scope.path)

    def is_initializing(self) -> bool:
        return self._bound_scope().store.initializing

    # -- entry points ----------------------------------------------------------
    def clone(self, **updates) -> "Module":
        """A copy with ``updates`` applied, unbound and without a parent."""
        attrs = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self) if f.init
        }
        attrs.update(parent=None, **updates)
        return type(self)(**attrs)

    def _run(self, store: _Store, method: Optional[str], args, kwargs):
        root = self.clone()
        object.__setattr__(root, "_scope", _Scope(store))
        fn = root if method is None else getattr(root, method)
        return fn(*args, **kwargs)

    def init(self, rngs, *args, **kwargs) -> dict:
        """Runs ``__call__`` creating every variable it touches; returns them
        by collection. ``rngs`` is a key (the ``params`` stream) or a dict of
        streams."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        store = _Store({}, rngs, True, initializing=True)
        self._run(store, None, args, kwargs)
        return store.variables

    def apply(self, variables: dict, *args, rngs: Optional[dict] = None,
              method: Optional[str] = None, mutable: Sequence[str] = (),
              **kwargs):
        """Runs ``method`` (default ``__call__``) against ``variables``.
        With ``mutable`` collection names, returns ``(out, those
        collections updated)``."""
        store = _Store(dict(variables), dict(rngs or {}), frozenset(mutable),
                       initializing=False)
        out = self._run(store, method, args, kwargs)
        if not mutable:
            return out
        return out, {
            col: tree for col, tree in store.variables.items()
            if store.is_mutable(col)
        }


def merge_param(name: str, a: Any, b: Any) -> Any:
    """The one of a module field and a call argument that is set."""
    if (a is None) == (b is None):
        raise ValueError(
            f"{name!r} must be set exactly once: as a field or as an argument"
        )
    return a if b is None else b


def while_loop(cond_fn: Callable, body_fn: Callable, module: Module,
               init: Any) -> Any:
    """``lax.while_loop`` over ``body_fn(module, carry)``; the module's
    variables are read-only inside the loop. During ``init`` the body runs
    once outside the loop first, so the variables it needs exist."""
    if module.is_initializing():
        body_fn(module, init)
    return jax.lax.while_loop(
        lambda c: cond_fn(module, c), lambda c: body_fn(module, c), init
    )


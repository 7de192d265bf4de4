"""Linear normalizers as JAX-friendly pytrees.

Replaces the reference's torch-module normalizers
(`src/utils/diffusion_policy/normalizer.py:14,108`) and stat helpers
(`src/utils/normalize_utils.py:7-42`). Parameters live in a plain nested dict
of numpy arrays, so a normalizer can be carried inside the checkpoint
pytree and used inside jitted functions.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "SingleFieldLinearNormalizer",
    "LinearNormalizer",
    "array_to_stats",
    "get_range_normalizer_from_stat",
    "get_image_range_normalizer",
    "get_identity_normalizer_from_stat",
]


def array_to_stats(arr: np.ndarray) -> dict:
    arr = np.asarray(arr).reshape(-1, arr.shape[-1])
    return {
        "min": arr.min(0),
        "max": arr.max(0),
        "mean": arr.mean(0),
        "std": arr.std(0),
    }


class SingleFieldLinearNormalizer:
    """x_norm = x * scale + offset."""

    def __init__(self, scale, offset, input_stats: dict | None = None):
        self.scale = np.asarray(scale, np.float32)
        self.offset = np.asarray(offset, np.float32)
        self.input_stats = {
            k: np.asarray(v, np.float32) for k, v in (input_stats or {}).items()
        }

    # --- constructors (reference API) ---
    @classmethod
    def create_manual(cls, scale, offset, input_stats_dict=None):
        return cls(scale, offset, input_stats_dict)

    @classmethod
    def create_identity(cls, dtype=np.float32):
        return cls(np.ones(1, dtype), np.zeros(1, dtype),
                   {"min": np.full(1, -1.0), "max": np.ones(1),
                    "mean": np.zeros(1), "std": np.ones(1)})

    @classmethod
    def create_fit(cls, data, mode="limits", output_max=1.0, output_min=-1.0,
                   range_eps=1e-4, fit_offset=True):
        stat = array_to_stats(np.asarray(data))
        if mode == "limits":
            return get_range_normalizer_from_stat(
                stat, output_max=output_max, output_min=output_min, range_eps=range_eps
            )
        if mode == "gaussian":
            # torch-parity: unbiased std (`normalizer.py:229` uses
            # tensor.std(), n-1 denominator), and near-constant dims get
            # scale 1 rather than an eps clamp (`normalizer.py:253-256`)
            arr = np.asarray(data, np.float32).reshape(-1, np.asarray(data).shape[-1])
            std = arr.std(0, ddof=1) if arr.shape[0] > 1 else np.zeros(arr.shape[1])
            stat = dict(stat, std=std.astype(np.float32))
            denom = np.where(std < range_eps, 1.0, std)
            scale = 1.0 / denom
            offset = -stat["mean"] * scale if fit_offset else np.zeros_like(std)
            return cls(scale, offset, stat)
        raise ValueError(mode)

    # --- transforms ---
    def normalize(self, x):
        xp = jnp if isinstance(x, jnp.ndarray) else np
        return x * xp.asarray(self.scale) + xp.asarray(self.offset)

    def unnormalize(self, x):
        xp = jnp if isinstance(x, jnp.ndarray) else np
        return (x - xp.asarray(self.offset)) / xp.asarray(self.scale)

    def __call__(self, x):
        return self.normalize(x)

    # --- pytree/state-dict persistence ---
    def state_dict(self) -> dict:
        return {"scale": self.scale, "offset": self.offset,
                "input_stats": dict(self.input_stats)}

    @classmethod
    def from_state_dict(cls, state: dict) -> "SingleFieldLinearNormalizer":
        return cls(state["scale"], state["offset"], state.get("input_stats"))


class LinearNormalizer:
    """Dict of per-field normalizers; persisted inside the checkpoint pytree
    like the reference's DictOfTensorMixin state-dict trick
    (`src/utils/diffusion_policy/dict_of_tensor_mixin.py:16-35`)."""

    def __init__(self):
        self.params: dict[str, SingleFieldLinearNormalizer] = {}

    def __setitem__(self, key: str, value: SingleFieldLinearNormalizer):
        self.params[key] = value

    def __getitem__(self, key: str) -> SingleFieldLinearNormalizer:
        return self.params[key]

    def __contains__(self, key: str) -> bool:
        return key in self.params

    def keys(self):
        return self.params.keys()

    def fit(self, data: dict, **kwargs):
        for key, value in data.items():
            self.params[key] = SingleFieldLinearNormalizer.create_fit(value, **kwargs)

    def normalize(self, x):
        if isinstance(x, dict):
            return {k: self.params[k].normalize(v) for k, v in x.items() if k in self.params}
        return self.params["_default"].normalize(x)

    def unnormalize(self, x):
        if isinstance(x, dict):
            return {k: self.params[k].unnormalize(v) for k, v in x.items() if k in self.params}
        return self.params["_default"].unnormalize(x)

    def __call__(self, x):
        return self.normalize(x)

    def get_input_stats(self) -> dict:
        return {k: dict(v.input_stats) for k, v in self.params.items()}

    def state_dict(self) -> dict:
        return {k: v.state_dict() for k, v in self.params.items()}

    @classmethod
    def from_state_dict(cls, state: dict) -> "LinearNormalizer":
        out = cls()
        for k, v in state.items():
            out.params[k] = SingleFieldLinearNormalizer.from_state_dict(v)
        return out


def get_range_normalizer_from_stat(stat, output_max=1, output_min=-1, range_eps=1e-4):
    """[-1, 1] range normalizer; near-constant dims map to the output center
    (`src/utils/normalize_utils.py:7-20`)."""
    input_max = np.asarray(stat["max"], np.float32)
    input_min = np.asarray(stat["min"], np.float32)
    input_range = input_max - input_min
    ignore = input_range < range_eps
    input_range = np.where(ignore, output_max - output_min, input_range)
    scale = (output_max - output_min) / input_range
    offset = output_min - scale * input_min
    offset = np.where(ignore, (output_max + output_min) / 2 - input_min, offset)
    return SingleFieldLinearNormalizer.create_manual(scale, offset, stat)


def get_image_range_normalizer():
    """[0,1] image -> [-1,1] (`src/utils/normalize_utils.py:23-34`)."""
    stat = {"min": np.zeros(1, np.float32), "max": np.ones(1, np.float32),
            "mean": np.full(1, 0.5, np.float32),
            "std": np.full(1, np.sqrt(1 / 12), np.float32)}
    return SingleFieldLinearNormalizer.create_manual(
        np.array([2.0], np.float32), np.array([-1.0], np.float32), stat)


def get_identity_normalizer_from_stat(stat):
    return SingleFieldLinearNormalizer.create_manual(
        np.ones_like(np.asarray(stat["min"], np.float32)),
        np.zeros_like(np.asarray(stat["min"], np.float32)), stat)

"""The in-repo module system (``pointcloudmatters_tpu.nn``) and checkpoint
format (``utils/checkpoint``): naming, variable handling, layer numerics and
layouts, and that the training path imports neither flax nor orbax."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pointcloudmatters_tpu import nn
from pointcloudmatters_tpu.utils.checkpoint import load_tree, save_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)


def _shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): x.shape
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _Leaf(nn.Module):
    width: int = 3

    @nn.compact
    def __call__(self, x):
        return nn.Dense(self.width)(nn.Dense(self.width)(x))


class _SetupParent(nn.Module):
    child: nn.Module  # adopted under the field name

    def setup(self):
        self.layers = [nn.Dense(2), nn.Dense(2)]
        self.heads = {"a": nn.Dense(1), "b": nn.Dense(1)}
        self.table = self.param("table", nn.initializers.zeros, (2,))

    def __call__(self, x):
        x = self.child(x)
        for layer in self.layers:
            x = layer(x)
        return self.heads["a"](x) + self.heads["b"](x) + self.table.sum()


class _Counter(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool):
        count = self.variable("batch_stats", "n", lambda: jnp.zeros(()))
        if train and not self.is_initializing():
            count.value = count.value + 1
        return x + count.value


def test_naming_follows_setup_fields_and_compact():
    model = _SetupParent(child=_Leaf())
    variables = model.init(KEY, jnp.ones((4, 5)))
    assert set(_shapes(variables["params"])) == {
        "['child']['Dense_0']['kernel']", "['child']['Dense_0']['bias']",
        "['child']['Dense_1']['kernel']", "['child']['Dense_1']['bias']",
        "['layers_0']['kernel']", "['layers_0']['bias']",
        "['layers_1']['kernel']", "['layers_1']['bias']",
        "['heads_a']['kernel']", "['heads_a']['bias']",
        "['heads_b']['kernel']", "['heads_b']['bias']", "['table']",
    }
    out = model.apply(variables, jnp.ones((4, 5)))
    assert out.shape == (4, 1)


def test_compact_module_called_twice_shares_its_params():
    class Twice(nn.Module):
        @nn.compact
        def __call__(self, x):
            dense = nn.Dense(4, name="shared")
            return dense(x) + dense(x)

    variables = Twice().init(KEY, jnp.ones((2, 4)))
    assert list(variables["params"]) == ["shared"]


def test_apply_mutable_collections():
    model = _Counter()
    variables = model.init(KEY, jnp.zeros(()), train=True)
    assert float(variables["batch_stats"]["n"]) == 0.0
    out, mutated = model.apply(variables, jnp.zeros(()), train=True,
                               mutable=["batch_stats"])
    assert float(mutated["batch_stats"]["n"]) == 1.0
    assert float(variables["batch_stats"]["n"]) == 0.0  # input untouched
    assert float(model.apply(variables, jnp.zeros(()), train=False)) == 0.0
    with pytest.raises(ValueError, match="immutable"):
        model.apply(variables, jnp.zeros(()), train=True)


def test_missing_param_in_apply_raises():
    with pytest.raises(KeyError, match="no parameter Dense_1/kernel"):
        _Leaf().apply({"params": {}}, jnp.ones((1, 2)))


def test_make_rng_distinct_and_falls_back_to_params():
    class Draw(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("dropout"), self.make_rng("dropout")

    a, b = Draw().apply({}, rngs={"dropout": KEY})
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    c, _ = Draw().apply({}, rngs={"params": KEY})  # no dropout stream given
    assert c.shape == a.shape
    with pytest.raises(ValueError, match="dropout"):
        Draw().apply({})


def test_clone_and_merge_param():
    leaf = _Leaf(width=2)
    assert leaf.clone(width=5).width == 5 and leaf.width == 2
    assert nn.merge_param("d", None, True) is True
    with pytest.raises(ValueError):
        nn.merge_param("d", True, False)


def test_while_loop_reads_params_and_creates_them_at_init():
    class Loop(nn.Module):
        def setup(self):
            self.step = nn.Dense(3)

        def __call__(self, x):
            return nn.while_loop(lambda m, c: c[0] < 4,
                                 lambda m, c: (c[0] + 1, m.step(c[1])),
                                 self, (0, x))[1]

    x = jnp.ones((2, 3))
    variables = Loop().init(KEY, x)
    out = Loop().apply(variables, x)
    k, b = variables["params"]["step"]["kernel"], variables["params"]["step"]["bias"]
    ref = x
    for _ in range(4):
        ref = ref @ k + b
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def _layer_cases():
    x = jax.random.normal(KEY, (2, 6, 8))
    im = jax.random.normal(KEY, (2, 8, 8, 3))
    mask = jnp.ones((2, 1, 1, 6), bool).at[0, ..., -1].set(False)
    return {
        "dense": (lambda m: m.Dense(5), (x,), {}),
        "dense_general_out": (
            lambda m: m.DenseGeneral(8, axis=(-2, -1)), (x.reshape(2, 6, 2, 4),), {}),
        "layer_norm_bf16": (lambda m: m.LayerNorm(epsilon=1e-5),
                            (x.astype(jnp.bfloat16),), {}),
        "group_norm": (lambda m: m.GroupNorm(num_groups=4, epsilon=1e-5), (x,), {}),
        "conv1d": (lambda m: m.Conv(4, (3,), strides=(2,), padding=[(1, 1)]),
                   (x,), {}),
        "conv2d": (lambda m: m.Conv(4, (3, 3), strides=(2, 2), padding="VALID"),
                   (im,), {}),
        "conv_transpose": (
            lambda m: m.ConvTranspose(4, (4,), strides=(2,), padding="SAME"), (x,), {}),
        "embed": (lambda m: m.Embed(3, 5), (jnp.array([0, 2, 1]),), {}),
        "attention": (
            lambda m: m.MultiHeadDotProductAttention(
                num_heads=2, qkv_features=8, out_features=8),
            (x, x, x), {"mask": mask}),
    }


@pytest.mark.parametrize("case", sorted(_layer_cases()))
def test_layers_match_flax_layout_and_math(case):
    """Same variable tree and, on the same variables, the same outputs as
    the flax.linen layer of that name (where flax is installed)."""
    linen = pytest.importorskip("flax.linen")
    build, args, kwargs = _layer_cases()[case]
    ours, ref = build(nn), build(linen)
    variables = ours.init(KEY, *args, **kwargs)
    assert _shapes(variables) == _shapes(ref.init(KEY, *args, **kwargs))
    np.testing.assert_array_equal(
        np.asarray(ours.apply(variables, *args, **kwargs), np.float32),
        np.asarray(ref.apply(variables, *args, **kwargs), np.float32))


def test_dense_general_fan_in_counts_every_contracted_axis():
    layer = nn.DenseGeneral(64, axis=(-2, -1))
    kernel = layer.init(KEY, jnp.ones((1, 16, 32)))["params"]["kernel"]
    # lecun normal over the flat (16*32, 64) matrix: std ~ 1/sqrt(512)
    assert kernel.shape == (16, 32, 64)
    assert abs(float(jnp.std(kernel)) * np.sqrt(512) - 1.0) < 0.1


def test_checkpoint_roundtrip_raw_and_template(tmp_path):
    params = {"a": {"kernel": np.ones((2, 3), np.float32)},
              "b": np.arange(4, dtype=np.int32)}
    tx = optax.adamw(1e-3)
    item = {"params": params, "opt_state": tx.init(params), "step": 7,
            "rng": jax.random.PRNGKey(3), "extras": {"names": ["x", "y"]}}
    save_tree(str(tmp_path / "ck"), item)
    raw = load_tree(str(tmp_path / "ck"))
    assert set(raw) == {"params", "opt_state", "step", "rng", "extras"}
    assert int(raw["step"]) == 7 and list(raw["extras"]["names"]) == ["x", "y"]
    back = load_tree(str(tmp_path / "ck"), item)
    assert jax.tree.structure(back) == jax.tree.structure(item)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(item)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    save_tree(str(tmp_path / "ck"), {"step": 8})  # replaces the directory
    assert int(load_tree(str(tmp_path / "ck"))["step"]) == 8


def test_training_path_imports_no_flax_orbax_or_h5py():
    """The flagship's modules, trainer and config load with those packages
    unimportable, as on a machine that lacks them."""
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('flax', 'orbax', 'h5py', 'treescope'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, '.')
import src.train, chip_smoke
from pointcloudmatters_tpu.utils import config as C
cfg = C.compose('configs', 'train', chip_smoke.FLAGSHIP_ARGV)
C.set_runtime(output_dir='.', cwd='.')
C.resolve_config(cfg)
model = C.instantiate(cfg.model)
print(type(model.policy).__name__)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ACTPCD"

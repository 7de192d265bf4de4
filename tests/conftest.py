"""Test configuration: JAX on a virtual 8-device CPU mesh.

The suite runs on the host CPU, with 8 virtual devices so the sharding tests
have a mesh. Tests that need an NVIDIA GPU carry the ``gpu`` marker (see
``pytest.ini``) and take the ``gpu_device`` fixture, which skips them
anywhere else. On a machine with a card:

    PCM_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

ON_GPU = os.environ.get("PCM_TEST_GPU", "0") == "1"

if not ON_GPU:
    # override hard: a setdefault would leave an inherited JAX_PLATFORMS
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))
# tests import sibling helper modules (_reference_stubs, _torch_port)
if str(REPO_ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(REPO_ROOT / "tests"))

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def config_dir() -> str:
    return str(REPO_ROOT / "configs")


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none. Decided here, at
    run time, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with PCM_TEST_GPU=1 -m gpu)")
    return jax.devices()[0]

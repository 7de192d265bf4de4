"""The FPS Triton kernel (interpret mode), its CUDA lowering, and the one
place that chooses between kernel and plain XLA (``pointops.kernel_route``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from pointcloudmatters_tpu.ops import fps_triton, pointops


def _clouds(B, N, counts, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    mask = np.arange(N)[None] < np.asarray(counts)[:, None]
    return jnp.asarray(xyz), jnp.asarray(mask)


def _kernel(xyz, mask, npoints):
    return fps_triton.farthest_point_sampling_padded_triton(
        xyz, mask, npoints, interpret=True)


@pytest.mark.parametrize(
    "B,N,counts,npoints",
    [
        (2, 1000, [1000, 1000], 64),   # N not a power of two
        (3, 512, [512, 300, 17], 32),  # partial-valid rows
        (2, 96, [96, 10], 40),         # npoints > valid count: repeats
        (1, 4096, [4096], 128),        # padded to the kernel's 4-warp floor
    ],
)
def test_kernel_matches_xla_loop(B, N, counts, npoints):
    xyz, mask = _clouds(B, N, counts)
    got = np.asarray(_kernel(xyz, mask, npoints))
    ref = np.asarray(
        pointops._farthest_point_sampling_padded_xla(xyz, mask, npoints))
    assert got.shape == (B, npoints) and got.dtype == np.int32
    assert (got[:, 0] == 0).all()
    np.testing.assert_array_equal(got, ref)
    short = np.asarray(chip_smoke.fps_shortfall(xyz, mask, got))
    assert short.max() <= chip_smoke.FPS_REL_TOL


@pytest.mark.parametrize("bg_ratio", [0.25, 0.5])
def test_kernel_foreground_background_split(bg_ratio):
    """ACTPCD's fg/bg split (`act.py` _fps_indices): each FPS sees a mask
    that is not packed at the front, and seeds at index 0 regardless."""
    B, N, npoints = 2, 700, 64
    xyz, mask = _clouds(B, N, [700, 500], seed=1)
    fg = jnp.asarray(np.random.RandomState(2).rand(B, N) > 0.6)
    n_bg = int(npoints * bg_ratio)
    for part, n in ((mask & fg, npoints - n_bg), (mask & ~fg, n_bg)):
        got = np.asarray(_kernel(xyz, part, n))
        ref = np.asarray(
            pointops._farthest_point_sampling_padded_xla(xyz, part, n))
        np.testing.assert_array_equal(got, ref)
        # every pick after the seed is inside its part of the cloud
        assert np.take_along_axis(np.asarray(part), got[:, 1:], 1).all()


def test_shortfall_flags_a_wrong_pick():
    xyz, mask = _clouds(1, 300, [300])
    good = np.asarray(_kernel(xyz, mask, 20))
    bad = good.copy()
    bad[0, 5] = bad[0, 4]  # re-picks a chosen point: distance 0
    assert float(chip_smoke.fps_shortfall(xyz, mask, good).max()) == 0.0
    assert float(chip_smoke.fps_shortfall(xyz, mask, bad).max()) > 0.5


def test_check_fps_reports_both_ends():
    xyz, mask = _clouds(2, 640, [640, 333], seed=3)
    res = chip_smoke.check_fps(xyz, mask, 48, interpret=True)
    assert res["shortfall"] <= chip_smoke.FPS_REL_TOL
    assert res["same_index_share"] == 1.0
    assert res["kernel_s"] > 0 and res["xla_s"] > 0


@pytest.mark.parametrize("n,warps", [(1000, 4), (10240, 16), (16384, 16),
                                     (32768, 32)])
def test_kernel_lowers_to_triton_for_cuda(n, warps):
    """Cross-platform lowering: the Pallas call becomes a Triton custom call
    with the intended warp count, without a GPU present."""
    f = jax.jit(lambda x, m: fps_triton.farthest_point_sampling_padded_triton(
        x, m, 128))
    lowered = f.trace(
        jax.ShapeDtypeStruct((2, n, 3), jnp.float32),
        jax.ShapeDtypeStruct((2, n), jnp.bool_),
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"num_warps = {warps} : i32" in text


def test_supported_sizes():
    assert fps_triton.supported(16384) and fps_triton.supported(20000)
    assert not fps_triton.supported(fps_triton.MAX_POINTS + 1)
    with pytest.raises(ValueError, match="at most"):
        _kernel(jnp.zeros((1, fps_triton.MAX_POINTS + 1, 3)),
                jnp.ones((1, fps_triton.MAX_POINTS + 1), bool), 4)


# ---------------------------------------------------------------------------
# the one selection point
# ---------------------------------------------------------------------------

def test_route_on_cpu_is_xla():
    assert pointops.kernel_route() == "xla"


def test_route_on_gpu_is_triton(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pointops.kernel_route() == "triton"


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_route_elsewhere_raises(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no point-op route"):
        pointops.kernel_route()
    with pytest.raises(RuntimeError, match="no point-op route"):
        pointops.farthest_point_sampling_padded(
            jnp.zeros((1, 8, 3)), jnp.ones((1, 8), bool), 2)


@pytest.mark.parametrize("n,expect_kernel", [(1000, True),
                                             (fps_triton.MAX_POINTS + 1, False)])
def test_fps_dispatch(monkeypatch, n, expect_kernel):
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        fps_triton, "farthest_point_sampling_padded_triton",
        lambda x, m, k: calls.append(x.dtype) or jnp.zeros((1, k), jnp.int32))
    monkeypatch.setattr(
        pointops, "_farthest_point_sampling_padded_xla",
        lambda x, m, k: jnp.ones((1, k), jnp.int32))
    out = pointops.farthest_point_sampling_padded(
        jnp.zeros((1, n, 3), jnp.bfloat16), jnp.ones((1, n), bool), 4)
    assert bool(calls) == expect_kernel
    assert int(out[0, 0]) == (0 if expect_kernel else 1)
    if expect_kernel:
        assert calls == [jnp.float32]  # geometry always runs in float32


def test_geometry_runs_in_float32():
    """bf16 coordinates give the same FPS and kNN as their float32 values."""
    xyz, mask = _clouds(2, 400, [400, 250], seed=5)
    low = xyz.astype(jnp.bfloat16)
    high = low.astype(jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(pointops.farthest_point_sampling_padded(low, mask, 32)),
        np.asarray(pointops.farthest_point_sampling_padded(high, mask, 32)))
    q = high[:, :30]
    i_low, d_low = pointops.knn_query_padded(q.astype(jnp.bfloat16), low, mask, 8)
    i_high, d_high = pointops.knn_query_padded(q, high, mask, 8)
    np.testing.assert_array_equal(np.asarray(i_low), np.asarray(i_high))
    assert d_low.dtype == jnp.float32


@pytest.mark.parametrize("B,M,N,k", [(2, 64, 1000, 8), (3, 40, 300, 16)])
def test_knn_matches_brute_force(B, M, N, k):
    xyz, mask = _clouds(B, N, [N] + [N // 3] * (B - 1), seed=6)
    q = jnp.take_along_axis(
        xyz, pointops.farthest_point_sampling_padded(xyz, mask, M)[..., None],
        axis=1)
    res = chip_smoke.check_knn(q, xyz, mask, k)
    assert res["set_mismatches"] == 0
    assert res["dist_rel_err"] <= chip_smoke.KNN_REL_TOL


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_fps_kernel_on_card(gpu_device):
    for B, N in chip_smoke.FPS_SHAPES:
        xyz, mask = chip_smoke.make_clouds(B, N)
        chip_smoke.check_fps(xyz, mask, chip_smoke.FPS_NPOINTS)


@pytest.mark.gpu
def test_knn_on_card(gpu_device):
    B, M, N, k = chip_smoke.KNN_SHAPE
    xyz, mask = chip_smoke.make_clouds(B, N, seed=1)
    q = jnp.take_along_axis(
        xyz, pointops.farthest_point_sampling_padded(xyz, mask, M)[..., None],
        axis=1)
    chip_smoke.check_knn(q, xyz, mask, k)

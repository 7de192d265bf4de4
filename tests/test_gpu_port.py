"""What surrounds the GPU path and can be checked on the CPU: device choice,
the compile cache, the bench's peak table, the trace reduction, trajectory
files without h5py, and ``chip_smoke.py``'s phases at a tiny size."""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from pointcloudmatters_tpu.trainer import Trainer
from pointcloudmatters_tpu.utils import compile_cache
from pointcloudmatters_tpu.utils import io as io_utils
from pointcloudmatters_tpu.utils.profiling import summarize_device_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the flagship experiment cut to a CPU-sized model (same overrides as the
# CLI end-to-end tests)
TINY = (
    "data.train.point_num_per_cam=256", "data.pad_multiple=64",
    "data.train.chunk_size=5", "model.policy.hidden_dim=32",
    "model.policy.pcd_npoints=16", "model.policy.pcd_nsample=4",
    "model.policy.transformer.num_encoder_layers=1",
    "model.policy.transformer.num_decoder_layers=1",
    "model.policy.transformer.nhead=4", "trainer.accelerator=cpu",
)


# ---------------------------------------------------------------------------
# device choice
# ---------------------------------------------------------------------------

def test_accelerator_gpu_raises_without_a_gpu(tmp_path):
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="gpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        trainer.mesh


@pytest.mark.parametrize("accelerator", ["mps", "cuda", ""])
def test_unknown_accelerator_rejected(tmp_path, accelerator):
    with pytest.raises(ValueError, match="accelerator must be one of"):
        Trainer(default_root_dir=str(tmp_path), accelerator=accelerator)


@pytest.mark.parametrize("accelerator", ["cpu", "auto"])
def test_host_accelerators_build_a_mesh(tmp_path, accelerator):
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator=accelerator,
                      devices=2)
    assert trainer.mesh.devices.size == 2
    assert trainer.mesh.devices.flat[0].platform == "cpu"


def test_shipped_configs_ask_for_the_gpu():
    from pointcloudmatters_tpu.utils import config as C

    cfg = C.compose(os.path.join(REPO, "configs"), "train",
                    chip_smoke.FLAGSHIP_ARGV)
    assert cfg.trainer.accelerator == "gpu"
    assert cfg.model.policy.transformer.get("attention_impl") is None
    gpu = C.compose(os.path.join(REPO, "configs"), "train", ["trainer=gpu"])
    assert gpu.trainer.accelerator == "gpu"


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

def test_compile_cache_follows_the_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.cache_dir() == str(tmp_path / "cc")


def test_compile_cache_defaults_inside_the_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------

def test_peak_table_known_kind():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize("kind", ["cpu", "Apple M2", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published bf16 peak"):
        bench.peak_bf16_flops(kind)


def test_bench_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.device_info()


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------

def test_summarize_device_events_busy_idle_and_top():
    events = [  # (line, op, start ns, duration ns)
        ("s0", "gemm", 0, 40), ("s1", "fps", 30, 20),  # overlap: busy 0-50
        ("s0", "gemm", 100, 40), ("s0", "knn", 150, 10),
    ]
    out = summarize_device_events(events, top=2)
    assert out["window_ns"] == 160
    assert out["busy_ns"] == 50 + 40 + 10
    assert out["idle_share"] == pytest.approx(1 - 100 / 160)
    assert [r["op"] for r in out["top"]] == ["gemm", "fps"]
    assert out["top"][0] == {"op": "gemm", "ns": 80, "count": 2}


def test_summarize_no_events():
    assert summarize_device_events([])["idle_share"] is None


# ---------------------------------------------------------------------------
# trajectories without h5py
# ---------------------------------------------------------------------------

def test_npz_trajectories_match_h5(tmp_path):
    from tests.synth import make_synthetic_maniskill2

    h5 = make_synthetic_maniskill2(str(tmp_path / "t.h5"), n_episodes=2,
                                   episode_len=3, cam_side=4)
    npz = make_synthetic_maniskill2(str(tmp_path / "t.npz"), n_episodes=2,
                                    episode_len=3, cam_side=4)
    a = io_utils.load_h5_data(io_utils.open_trajectories(h5)["traj_1"])
    b = io_utils.load_h5_data(io_utils.open_trajectories(npz)["traj_1"])
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert io_utils.trajectory_sidecar(npz) == str(tmp_path / "t.json")
    with pytest.raises(KeyError):
        io_utils.open_trajectories(npz)["traj_9"]


def test_dataset_reads_npz(tmp_path):
    from pointcloudmatters_tpu.data.components.maniskill2 import (
        ManiSkill2GoalPosSingleTaskACTPCDDataset,
    )
    from tests.synth import make_synthetic_maniskill2

    path = make_synthetic_maniskill2(str(tmp_path / "t.npz"), n_episodes=2,
                                     episode_len=4, cam_side=8)
    ds = ManiSkill2GoalPosSingleTaskACTPCDDataset(
        dataset_file=path, chunk_size=5, cache_dir=str(tmp_path / "cache"),
        goal_cond_keys=["goal_pos"],
        camera_ids=[0], point_num_per_cam=64, loop=3)
    assert len(ds) == 6
    item = ds[0]
    assert item["actions"].shape == (5, 7)


# ---------------------------------------------------------------------------
# chip_smoke on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_installations_present_here():
    versions = chip_smoke.phase_installations()
    assert set(versions) == set(chip_smoke.INSTALLATIONS
                                + chip_smoke.OPTIONAL_INSTALLATIONS)


def test_chip_smoke_installations_fail_when_one_is_missing(monkeypatch):
    real = chip_smoke.importlib.import_module

    def fake(name):
        if name == "yaml":
            raise ImportError(name)
        return real(name)

    monkeypatch.setattr(chip_smoke.importlib, "import_module", fake)
    with pytest.raises(SystemExit, match="yaml"):
        chip_smoke.phase_installations()


def test_chip_smoke_installations_flax_not_needed(monkeypatch):
    real = chip_smoke.importlib.import_module

    def fake(name):
        if name.split(".")[0] in ("flax", "orbax", "h5py"):
            raise ImportError(name)
        return real(name)

    monkeypatch.setattr(chip_smoke.importlib, "import_module", fake)
    versions = chip_smoke.phase_installations()
    assert versions["flax"] is None and versions["yaml"]


def test_chip_smoke_frontend_tiny():
    res = chip_smoke.phase_frontend((2, 600, 32, 4, 16), interpret=True)
    assert res["grad_max_abs_diff"] < 1e-3


def test_chip_smoke_train_and_correctness_tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    res = chip_smoke.phase_train(
        str(tmp_path), steps=3, extra=TINY + ("data.batch_size_train=2",
                                              "logger=csv"),
        batch_size=2, cam_side=16, profile=False)
    assert np.isfinite(res["loss"])
    assert res["compiles_after_warmup"] == 0
    assert len(res["step_s"]) == 2 and res["median_step_s"] > 0
    assert res["memory"]["temp_size_in_bytes"] > 0
    assert res["fps_in_step"]["xla_step_s"] > 0
    out = chip_smoke.phase_correctness(res)
    assert out["a_hat_rel_l2"] <= chip_smoke.FORWARD_REL_TOL


def test_chip_smoke_dp_step_compare_two_virtual_devices(tmp_path):
    """The --four comparison's logic on 2 of the 8 virtual CPU devices."""
    data = chip_smoke.make_flagship_data(str(tmp_path), episodes=4,
                                         cam_side=16)
    argv = chip_smoke.FLAGSHIP_ARGV + list(TINY) + [
        f"data.train.dataset_file={data}",
        f"data.train.cache_dir={tmp_path}/cache",
        "data.batch_size_train=4", "trainer.accumulate_grad_batches=1",
        "trainer.devices=2", "+trainer.prng_impl=threefry2x32",
        f"paths.log_dir={tmp_path}/logs",
    ]
    res = chip_smoke.dp_step_compare(jax.devices()[:2], argv, 4, str(tmp_path))
    assert res["n_devices"] == 2
    assert res["loss_rel"] <= chip_smoke.FOUR_LOSS_REL_TOL
    assert res["param_max_step_over_lr"] > 0

"""RLBench vertical tests: datasets, eval loop with a fake task, training
vertical through the composed config."""

import os

import numpy as np
import pytest

from tests.synth import make_synthetic_rlbench

from pointcloudmatters_tpu.data.components.rlbench.constants import loc_bounds
from pointcloudmatters_tpu.data.components.rlbench.datasets import (
    RLBenchSingleTaskACTPCDDataset,
    RLBenchSingleTaskACTRGBDDataset,
    RLBenchSingleTaskDiffusionPolicyPCDDataset,
    quat_to_6d_np,
)

TASK = "close_jar"
TRANSFORM = [
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.GridSamplePCD",
     "grid_size": 0.01, "hash_type": "fnv", "mode": "train",
     "return_grid_coord": True, "keys": ["coord", "color"]},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.NormalizeColorPCD"},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.ToTensorPCD"},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.CollectPCD",
     "keys": ["coord", "grid_coord"], "feat_keys": ["color", "coord"]},
]


def _instantiate_transform():
    from pointcloudmatters_tpu.utils.config import instantiate

    return [instantiate(t) for t in TRANSFORM]


@pytest.fixture(scope="module")
def rlbench_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rlbench"))
    return make_synthetic_rlbench(root, task_name=TASK, n_episodes=3)


class TestRLBenchDatasets:
    def test_act_rgbd_sample(self, rlbench_root):
        ds = RLBenchSingleTaskACTRGBDDataset(
            root=os.path.join(rlbench_root, "train"), task_names=[TASK],
            chunk_size=4, include_depth=True,
        )
        s = ds[0]
        assert s["image"].shape == (1, 16, 16, 4)  # NHWC rgb+depth
        assert s["qpos"].shape == (11,)  # 3 + 6d + gripper + collision
        assert s["actions"].shape == (4, 11)
        assert s["is_pad"].dtype == bool
        assert s["goal_cond"].shape == (512,)
        # positions normalized into [-1, 1]
        assert np.all(np.abs(s["qpos"][:3]) <= 1.0 + 1e-5)

    def test_act_pcd_sample(self, rlbench_root):
        ds = RLBenchSingleTaskACTPCDDataset(
            root=os.path.join(rlbench_root, "train"), task_names=[TASK],
            chunk_size=4, transform_pcd=_instantiate_transform(),
        )
        s = ds[0]
        pcd = s["pcds"][0]
        assert pcd["coord"].shape[-1] == 3
        assert pcd["feat"].shape[-1] == 6
        assert "grid_coord" in pcd

    def test_pcd_mask_labeling(self, rlbench_root):
        ds = RLBenchSingleTaskACTPCDDataset(
            root=os.path.join(rlbench_root, "train"), task_names=[TASK],
            chunk_size=4, transform_pcd=_instantiate_transform(),
            use_mask=True,
        )
        s = ds[0]
        pcd = s["pcds"][0]
        assert pcd["mask"].dtype == bool
        assert pcd["feat"].shape[-1] == 6  # the mask channel was stripped

    def test_dp_pcd_sample(self, rlbench_root):
        ds = RLBenchSingleTaskDiffusionPolicyPCDDataset(
            root=os.path.join(rlbench_root, "train"), task_names=[TASK],
            chunk_size=4, n_obs_steps=2,
            transform_pcd=_instantiate_transform(),
        )
        s = ds[0]
        assert s["obs"]["qpos"].shape == (4, 11)
        assert len(s["obs"]["pcds"]) == 2
        assert s["action"].shape == (4, 11)
        assert s["goal"]["task_emb"].shape == (512,)
        norm = ds.get_normalizer()
        np.testing.assert_array_equal(
            np.asarray(norm["action"].scale), 1.0
        )  # identity: loc-bounds already applied

    def test_quat_to_6d(self):
        from pointcloudmatters_tpu.utils import rotation_conversions as rc
        import jax.numpy as jnp

        q = np.random.RandomState(0).randn(5, 4).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        got = quat_to_6d_np(q)
        want = np.asarray(
            rc.matrix_to_rotation_6d(rc.quaternion_to_matrix(jnp.asarray(q)))
        )
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestRLBenchEvalLoop:
    def test_act_eval_with_fake_task(self, rlbench_root):
        from pointcloudmatters_tpu.envs.rlbench_eval import run_rlbench_act_eval

        rng = np.random.RandomState(0)
        pos_lo, pos_hi = (np.array(b) for b in loc_bounds[TASK])

        class FakeSim:
            def __init__(self):
                self.t = 0
                self.actions = []

            def reset(self, ep):
                self.t = 0
                return "close the jar", {"obs": ep}

            def step(self, action):
                # action arrives unnormalized + quat + thresholded gripper
                assert action.shape == (9,)  # 3 + quat4 + grip + collision
                assert np.all(action[:3] >= pos_lo - 1e-4)
                assert np.all(action[:3] <= pos_hi + 1e-4)
                assert action[-1] in (0.0, 1.0) and action[-2] in (0.0, 1.0)
                self.actions.append(action)
                self.t += 1
                done = self.t >= 3
                return {"obs": self.t}, float(done), done

        sim = FakeSim()

        def predict(obs, description):
            assert description == "close the jar"
            # normalized chunk with quaternion rot: (chunk, 3+4+1+1)
            chunk = rng.uniform(-0.9, 0.9, (4, 9)).astype(np.float32)
            quat = rng.randn(4, 4)
            chunk[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
            return chunk

        rate = run_rlbench_act_eval(
            predict=predict, reset_fn=sim.reset, step_fn=sim.step,
            task_name=TASK, episodes_num=2, max_steps=5, collision=True,
            temporal_agg=True, agg_action_dim=11, agg_chunk_size=4,
        )
        assert rate == 1.0  # fake sim always "succeeds" at step 3

    def test_dp_eval_with_fake_task(self):
        from pointcloudmatters_tpu.envs.rlbench_eval import run_rlbench_dp_eval

        class FakeSim:
            def __init__(self):
                self.t = 0

            def reset(self, ep):
                self.t = 0
                return "task", {"o": 0}

            def step(self, action):
                self.t += 1
                done = self.t >= 4
                return {"o": self.t}, float(done), done

        sim = FakeSim()
        calls = dict(n=0, hist_len=[])

        def predict(hist, description):
            calls["n"] += 1
            calls["hist_len"].append(len(hist))
            a = np.zeros((2, 9), np.float32)
            a[:, 3] = 1.0  # unit quat
            return a

        rate = run_rlbench_dp_eval(
            predict=predict, reset_fn=sim.reset, step_fn=sim.step,
            task_name=TASK, n_obs_steps=2, episodes_num=1, max_steps=10,
        )
        assert rate == 1.0
        assert all(h == 2 for h in calls["hist_len"])  # obs-history window


class TestRLBenchTrainingVertical:
    def test_act_pcd_training_via_compose(self, rlbench_root, tmp_path):
        from pointcloudmatters_tpu.utils import config as C
        from pointcloudmatters_tpu.utils.config import resolve_config, set_runtime

        cfg = C.compose(
            os.path.join(os.path.dirname(__file__), "..", "configs"), "train",
            [
                "exp_rlbench_act_policy=base",
                "exp_rlbench_act_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd",
                "debug=default",
                f"rlbench_task={TASK}",
                f"data.train.root={rlbench_root}/train",
                f"data.val.root={rlbench_root}/val",
                "data.train.chunk_size=4",
                "data.batch_size_train=2",
                "data.batch_size_val=2",
                "data.pad_multiple=64",
                "model.policy.hidden_dim=32",
                "model.policy.pcd_npoints=16",
                "model.policy.pcd_nsample=4",
                "model.policy.transformer.num_encoder_layers=1",
                "model.policy.transformer.num_decoder_layers=1",
                "model.policy.transformer.nhead=4",
                "trainer.check_val_every_n_epoch=1",
                "trainer.limit_val_batches=1",
                "callbacks=none",
                "logger=null",
                f"paths.log_dir={tmp_path}/logs",
            ],
        )
        set_runtime(output_dir=str(tmp_path / "out"), cwd=str(tmp_path))
        resolve_config(cfg)
        dm = C.instantiate(cfg.data)
        model = C.instantiate(cfg.model)
        trainer = C.instantiate(cfg.trainer, callbacks=[], logger=None)
        trainer.fit(model, datamodule=dm)
        out = model.train_metrics.compute()
        assert np.isfinite(out["train/loss"])
        # RLBench modules validate by held-out loss
        val = model.best_val_metrics.compute()
        assert np.isfinite(val["val/loss_best"])


class TestCustomEnvRegistry:
    def test_import_without_simulator_is_noop(self):
        """The custom env module must import cleanly when mani_skill2 is
        absent (the training host need not have the simulator)."""
        import pointcloudmatters_tpu.envs.custom_maniskill2 as c

        assert c.register_custom_envs() in (True, False)
        # env-ID surface bookkeeping matches the reference inventory scale
        n_light = sum(map(len, c.LIGHT_LEVELS.values()))
        assert n_light == 25
        assert len(c.BACKGROUND_LEVELS) == 11
        assert len(c.FOREGROUND_LEVELS) == 5
        assert len(c.MULTIVIEW_TASKS) == 9

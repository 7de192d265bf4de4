"""ManiSkill2 task modules: BC training + simulator-rollout validation.

Counterparts of `src/models/maniskill2_act_bc_module.py:17` and
`src/models/maniskill2_dp_bc_module.py:21`. Training is the jitted BCModule
path; validation spins up the ManiSkill2 simulator on the host and rolls the
policy closed-loop (`envs/rollout.py`). When the simulator stack isn't
installed (or an ``env_factory`` isn't injected), validation degrades to the
held-out-loss path with a warning instead of crashing — the same information
the RLBench modules log.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from pointcloudmatters_tpu.envs.rollout import (
    make_maniskill2_env,
    run_maniskill2_rollouts,
)
from pointcloudmatters_tpu.models.bc_module import BCModule
from pointcloudmatters_tpu.utils.metrics import Metrics
from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

def _reward_figure_logger(trainer):
    """Per-episode reward curves into TensorBoard (reference
    `maniskill2_act_bc_module.py:298-304`); no-op without matplotlib/TB."""
    figure_loggers = [
        lg for lg in getattr(trainer.logger, "loggers", [])
        if hasattr(lg, "log_figure")
    ]
    if not figure_loggers:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    def on_episode_end(idx, success, rewards):
        fig = plt.figure()
        ax = fig.add_subplot(111)
        ax.plot(rewards)
        ax.set_title(f"episode {idx} success={success}")
        for lg in figure_loggers:
            lg.log_figure(f"val/rewards_{idx}", fig, trainer.global_step)
        plt.close(fig)

    return on_episode_end



class ManiSkill2ACTBCModule(BCModule):
    def __init__(
        self,
        policy,
        optimizer=None,
        lr_scheduler=None,
        env_id: Optional[str] = None,
        obs_mode: str = "pointcloud",
        shader_dir: str = "ibl",
        rt_samples_per_pixel: int = 32,
        rt_use_denoiser: bool = True,
        use_stereo_depth: bool = False,
        temporal_agg: bool = True,
        num_envs: int = 1,
        env_factory: Optional[Callable] = None,
        train_metrics=None,
        val_metrics=None,
        best_val_metrics=None,
        **hparams,
    ):
        super().__init__(
            policy=policy, optimizer=optimizer, lr_scheduler=lr_scheduler,
            train_metrics=train_metrics,
            val_metrics=val_metrics or Metrics(
                ["MeanMetric"], ["mean_success"], ["val/mean_success"]
            ),
            best_val_metrics=best_val_metrics or Metrics(
                ["MaxMetric"], ["val/mean_success"], ["val/mean_success"]
            ),
            **hparams,
        )
        self.env_id = env_id
        self.obs_mode = obs_mode
        self.shader_dir = shader_dir
        self.rt_samples_per_pixel = rt_samples_per_pixel
        self.rt_use_denoiser = rt_use_denoiser
        self.use_stereo_depth = use_stereo_depth
        self.temporal_agg = temporal_agg
        self.num_envs = num_envs
        self.env_factory = env_factory

    @property
    def val_metric_keys(self) -> list[str]:
        return []  # rollout metrics come from the simulator, not the eval step

    def _make_env(self, dataset, record_dir=None):
        if self.env_factory is not None:
            return self.env_factory(self)
        env_kwargs = getattr(dataset, "env_kwargs", {}) or {}
        control_mode = env_kwargs.get("control_mode", "pd_ee_delta_pose")
        # rt_* only matter under the ray tracer; forwarding them
        # unconditionally mirrors the reference (`maniskill2_act_bc_module
        # .py:103-108`), which always passes its render_config
        return make_maniskill2_env(
            self.env_id, record_dir=record_dir, obs_mode=self.obs_mode,
            control_mode=control_mode, shader_dir=self.shader_dir,
            rt_samples_per_pixel=self.rt_samples_per_pixel,
            rt_use_denoiser=self.rt_use_denoiser,
            use_stereo_depth=self.use_stereo_depth,
        )

    def run_validation(self, trainer, datamodule) -> dict:
        dataset = datamodule.data_train
        val_loader = datamodule.val_dataloader()
        n_episodes = len(val_loader.dataset) if val_loader is not None else 0
        from pointcloudmatters_tpu.trainer import _limit

        n_episodes = _limit(n_episodes, trainer.limit_val_batches)
        if n_episodes <= 0:
            return {}
        try:
            env = self._make_env(dataset)
        except Exception as e:  # simulator not available in this environment
            log.warning(
                f"ManiSkill2 simulator unavailable ({type(e).__name__}: {e}); "
                "falling back to held-out-loss validation"
            )
            return super().run_validation(trainer, datamodule)

        import functools

        import jax

        policy_apply = jax.jit(
            functools.partial(self.policy.apply, train=False)
        )

        def predict(data_dict):
            variables = {
                "params": trainer.state.params,
                "batch_stats": trainer.state.batch_stats,
            }
            out = policy_apply(variables, data_dict)
            return np.asarray(out["a_hat"])

        policy_cfg = self.policy
        try:
            metrics = run_maniskill2_rollouts(
                predict=predict,
                dataset=dataset,
                env=env,
                env_id=self.env_id or "",
                n_episodes=n_episodes,
                action_dim=policy_cfg.action_dim,
                num_queries=policy_cfg.num_queries,
                temporal_agg=self.temporal_agg,
                pad_multiple=getattr(datamodule, "pad_multiple", 512),
                on_episode_end=_reward_figure_logger(trainer),
                # num_envs > 1 overlaps host SAPIEN stepping across an env
                # pool while the device serves predictions (SURVEY §7.4.5)
                env_factory=(
                    (lambda: self._make_env(dataset))
                    if self.num_envs > 1 else None
                ),
                num_envs=self.num_envs,
            )
        finally:
            env.close()
        self.val_metrics.reset()
        self.val_metrics.update(metrics)
        out = self.val_metrics.compute()
        for extra in ("mean_grasp", "mean_align"):
            if extra in metrics:
                out[f"val/{extra}"] = metrics[extra]
        self.best_val_metrics.update(out)
        out.update(self.best_val_metrics.compute())
        return out


class RLBenchACTBCModule(BCModule):
    """Held-out-loss validation only (`rlbench_act_bc_module.py:88-110`)."""

    def __init__(self, policy, optimizer=None, lr_scheduler=None, **hparams):
        super().__init__(
            policy=policy, optimizer=optimizer, lr_scheduler=lr_scheduler,
            **hparams,
        )


class ManiSkill2DiffusionPolicyBCModule(ManiSkill2ACTBCModule):
    """Diffusion-policy task module (`src/models/maniskill2_dp_bc_module.py:21`).

    Differences from the ACT module: the dataset's ``LinearNormalizer`` is
    attached to the policy before init (`maniskill2_dp_bc_module.py:54-57`),
    only ``loss`` is tracked in training metrics, and validation rollouts
    execute the policy's full ``n_action_steps`` window per prediction.
    """

    train_rng_streams = ("noise", "dropout", "crop", "mask")

    def __init__(self, policy, optimizer=None, lr_scheduler=None,
                 train_metrics=None, **hparams):
        super().__init__(
            policy=policy, optimizer=optimizer, lr_scheduler=lr_scheduler,
            train_metrics=train_metrics or Metrics(
                ["MeanMetric"], ["loss"], ["train/loss"]
            ),
            **hparams,
        )

    def setup_module(self, trainer, example_batch) -> None:
        super().setup_module(trainer, example_batch)
        datamodule = getattr(trainer, "datamodule", None)
        dataset = getattr(datamodule, "data_train", None)
        if (self.policy.normalizer is None and dataset is not None
                and hasattr(dataset, "get_normalizer")):
            normalizer = dataset.get_normalizer()
            self.policy = self.policy.clone(normalizer=normalizer)
            self._extras["normalizer"] = normalizer.state_dict()
            log.info("wired dataset LinearNormalizer into the policy")

    def load_state_dict_extras(self, extras: dict) -> None:
        super().load_state_dict_extras(extras)
        if "normalizer" in self._extras:
            from pointcloudmatters_tpu.utils.normalizer import LinearNormalizer

            normalizer = LinearNormalizer.from_state_dict(
                self._extras["normalizer"]
            )
            self.policy = self.policy.clone(normalizer=normalizer)

    def run_validation(self, trainer, datamodule) -> dict:
        from pointcloudmatters_tpu.envs.rollout import (
            run_maniskill2_dp_rollouts,
        )

        dataset = datamodule.data_train
        val_loader = datamodule.val_dataloader()
        n_episodes = len(val_loader.dataset) if val_loader is not None else 0
        from pointcloudmatters_tpu.trainer import _limit

        n_episodes = _limit(n_episodes, trainer.limit_val_batches)
        if n_episodes <= 0:
            return {}
        try:
            env = self._make_env(dataset)
        except Exception as e:
            log.warning(
                f"ManiSkill2 simulator unavailable ({type(e).__name__}: {e}); "
                "falling back to held-out-loss validation"
            )
            return BCModule.run_validation(self, trainer, datamodule)

        import functools

        import jax

        policy_apply = jax.jit(
            functools.partial(self.policy.apply, train=False)
        )
        sample_key = jax.random.PRNGKey(getattr(trainer, "seed", 0) or 0)
        counter = dict(n=0)

        def predict(data_dict):
            variables = {
                "params": trainer.state.params,
                "batch_stats": trainer.state.batch_stats,
            }
            counter["n"] += 1
            out = policy_apply(
                variables, data_dict,
                rngs={"sample": jax.random.fold_in(sample_key, counter["n"])},
            )
            return np.asarray(out["action"])

        try:
            metrics = run_maniskill2_dp_rollouts(
                predict=predict,
                dataset=dataset,
                env=env,
                env_id=self.env_id or "",
                n_episodes=n_episodes,
                n_obs_steps=self.policy.n_obs_steps,
                pad_multiple=getattr(datamodule, "pad_multiple", 512),
                on_episode_end=_reward_figure_logger(trainer),
            )
        finally:
            env.close()
        self.val_metrics.reset()
        self.val_metrics.update(metrics)
        out = self.val_metrics.compute()
        for extra in ("mean_grasp", "mean_align"):
            if extra in metrics:
                out[f"val/{extra}"] = metrics[extra]
        self.best_val_metrics.update(out)
        out.update(self.best_val_metrics.compute())
        return out


class RLBenchDiffusionPolicyBCModule(ManiSkill2DiffusionPolicyBCModule):
    """Held-out-loss validation only (`rlbench_dp_bc_module.py:17,46-50`)."""

    def run_validation(self, trainer, datamodule) -> dict:
        return BCModule.run_validation(self, trainer, datamodule)

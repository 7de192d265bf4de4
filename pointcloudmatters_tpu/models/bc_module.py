"""Behavior-cloning task modules (the reference's LightningModules).

``BCModule`` is the shared machinery of the four task modules
(`src/models/maniskill2_act_bc_module.py:17`, `maniskill2_dp_bc_module.py:21`,
`rlbench_act_bc_module.py:18`, `rlbench_dp_bc_module.py:17`): it owns the
policy, optimizer/scheduler configs, and metric routing, and exposes the pure
functions the ``Trainer`` jits. Simulator-rollout validation lives in the
ManiSkill2 subclasses (`maniskill2_modules.py`); the base validates by
held-out loss like the RLBench modules (`rlbench_act_bc_module.py:88-110`).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pointcloudmatters_tpu.trainer import TrainState
from pointcloudmatters_tpu.utils.metrics import Metrics
from pointcloudmatters_tpu.utils.optimizer import build_optimizer
from pointcloudmatters_tpu.utils.pylogger import RankedLogger
from pointcloudmatters_tpu.utils.scheduler import (
    build_momentum_schedule,
    build_scheduler,
)

log = RankedLogger(__name__, rank_zero_only=True)

_MODEL_INPUT_KEYS = (
    "qpos", "actions", "is_pad", "goal_cond", "image", "env_state", "obs",
    "action", "goal",
)
_PCD_INPUT_KEYS = ("coord", "grid_coord", "feat", "valid", "mask", "color", "condition")


def select_model_batch(batch: dict) -> dict:
    """Strip collate bookkeeping (offsets, counts) down to model inputs so the
    jitted step doesn't capture unused arrays."""
    out = {k: batch[k] for k in _MODEL_INPUT_KEYS if k in batch}
    if "pcds" in batch:
        out["pcds"] = {
            k: batch["pcds"][k] for k in _PCD_INPUT_KEYS if k in batch["pcds"]
        }
    if "obs" in batch and isinstance(batch["obs"], dict):
        obs = dict(batch["obs"])
        if "pcds" in obs:
            obs["pcds"] = {
                k: obs["pcds"][k] for k in _PCD_INPUT_KEYS if k in obs["pcds"]
            }
        out["obs"] = obs
    return out


class BCModule:
    """Base task module. Subclasses override validation behavior."""

    # PRNG streams the policy consumes during training; the trainer folds the
    # step rng into one key per stream (ACT: vae sampling + dropout; DP
    # overrides with noise/crop streams)
    train_rng_streams: tuple = ("vae", "dropout", "mask")

    def __init__(
        self,
        policy: Any,
        optimizer: Optional[dict] = None,
        lr_scheduler: Optional[dict] = None,
        train_metrics: Optional[Any] = None,
        val_metrics: Optional[Any] = None,
        best_val_metrics: Optional[Any] = None,
        param_dicts: Optional[list] = None,
        compile: bool = False,
        **hparams,
    ):
        self.policy = policy
        self.optimizer_cfg = dict(optimizer or {"type": "AdamW", "lr": 1e-4})
        self.lr_scheduler_cfg = lr_scheduler
        self.param_dicts = param_dicts
        self.hparams = dict(hparams)
        self.compile = compile  # always jitted; kept for config parity

        self.train_metrics = train_metrics or Metrics(
            ["MeanMetric"] * 3,
            ["loss", "action_loss", "kl_loss"],
            ["train/loss", "train/action_loss", "train/kl_loss"],
        )
        self.val_metrics = val_metrics or Metrics(
            ["MeanMetric"], ["loss"], ["val/loss"]
        )
        self.best_val_metrics = best_val_metrics or Metrics(
            ["MinMetric"], ["val/loss"], ["val/loss_best"]
        )

        self.tx: Optional[optax.GradientTransformation] = None
        self.schedule = None
        self.seed = 0
        self._extras: dict = {}

    # -- metric key routing -------------------------------------------------
    @property
    def train_metric_keys(self) -> list[str]:
        return self.train_metrics.input_keys

    @property
    def val_metric_keys(self) -> list[str]:
        return [k for k in self.val_metrics.input_keys if k != "mean_success"]

    # -- optimizer ----------------------------------------------------------
    def configure_optimizers(self, params, total_steps: int,
                             gradient_clip_val: Optional[float] = None,
                             accumulate_grad_batches: int = 1,
                             schedule_transform=None) -> None:
        """Builds the optax chain; mirrors the reference's
        ``configure_optimizers`` with total_steps injection
        (`maniskill2_act_bc_module.py:343-367`). ``schedule_transform``
        optionally wraps the built LR schedule (SWA callback's SWALR)."""
        base_lr = float(self.optimizer_cfg.get("lr", 1e-4))
        schedule = None
        b1_schedule = None
        if self.lr_scheduler_cfg:
            sched_cfg = self.lr_scheduler_cfg.get(
                "scheduler", self.lr_scheduler_cfg
            )
            schedule = build_scheduler(dict(sched_cfg), total_steps, base_lr)
            # OneCycleLR cycle_momentum=True (torch default): beta1 cycles
            # 0.95 <-> 0.85 inverse to the LR
            b1_schedule = build_momentum_schedule(dict(sched_cfg), total_steps)
        if schedule_transform is not None:
            schedule = schedule_transform(schedule)
        tx = build_optimizer(
            dict(self.optimizer_cfg), params=params,
            param_dicts=self.param_dicts, lr_schedule=schedule,
            b1_schedule=b1_schedule,
        )
        if gradient_clip_val:
            tx = optax.chain(optax.clip_by_global_norm(gradient_clip_val), tx)
        if accumulate_grad_batches > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=accumulate_grad_batches)
        self.tx = tx
        self.schedule = schedule

    # -- state construction -------------------------------------------------
    def setup_module(self, trainer, example_batch: dict) -> None:
        self.seed = getattr(trainer, "seed", self.seed)
        self._opt_knobs = dict(
            total_steps=trainer.estimated_stepping_batches or 1,
            gradient_clip_val=trainer.gradient_clip_val,
            accumulate_grad_batches=trainer.accumulate_grad_batches,
        )

    def initial_state(self, example_batch: dict) -> TrainState:
        rng = jax.random.PRNGKey(self.seed)
        init_rng, vae_rng, drop_rng, state_rng = jax.random.split(rng, 4)
        batch = select_model_batch(example_batch)
        # jit the init: eager tracing dispatches thousands of tiny ops
        init_fn = jax.jit(
            lambda rngs, b: self.policy.init(rngs, b, train=True)
        )
        variables = init_fn(
            {"params": init_rng, "vae": vae_rng, "dropout": drop_rng}, batch
        )
        from pointcloudmatters_tpu.models.components.pretrained import (
            load_pretrained_into,
        )

        variables = load_pretrained_into(self.policy, variables)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
        log.info(f"initialized policy: {n_params:,} parameters")
        if self.tx is None:
            knobs = getattr(self, "_opt_knobs", {"total_steps": 1})
            self.configure_optimizers(params=params, **knobs)
        opt_state = self.tx.init(params)
        return TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=batch_stats, opt_state=opt_state, rng=state_rng,
        )

    # -- pure step functions (jitted by the Trainer) ------------------------
    def make_rngs(self, key: jax.Array) -> dict:
        keys = jax.random.split(key, len(self.train_rng_streams))
        return dict(zip(self.train_rng_streams, keys))

    def apply_train(self, variables: dict, batch: dict, rngs: dict):
        return self.policy.apply(
            variables, select_model_batch(batch), train=True, rngs=rngs,
            mutable=["batch_stats"],
        )

    def apply_eval(self, variables: dict, batch: dict):
        # deterministic eval still needs the streams bound (e.g. DP's noise
        # draw when computing a held-out loss)
        rngs = self.make_rngs(jax.random.PRNGKey(0))
        return self.policy.apply(
            variables, select_model_batch(batch), train=False, rngs=rngs
        )

    # -- inference (rollouts, serving) --------------------------------------
    def predict(self, variables: dict, obs: dict):
        """Action prediction for closed-loop control; obs has no actions."""
        out = self.policy.apply(variables, select_model_batch(obs), train=False)
        return out["a_hat"]

    # -- validation ---------------------------------------------------------
    def run_validation(self, trainer, datamodule) -> dict:
        """Held-out-loss validation (RLBench modules' behavior,
        `rlbench_act_bc_module.py:88-110`)."""
        loader = datamodule.val_dataloader()
        if loader is None:
            return {}
        if not self._has_real_val_data(loader):
            return {}
        eval_step = trainer._build_eval_step(self)
        self.val_metrics.reset()
        from pointcloudmatters_tpu.trainer import _limit

        n_val = _limit(len(loader), trainer.limit_val_batches)
        for i, batch in enumerate(loader):
            if i >= n_val:
                break
            metrics = eval_step(trainer.state, trainer.shard_batch(batch))
            self.val_metrics.update({k: float(v) for k, v in metrics.items()})
        out = self.val_metrics.compute()
        self.best_val_metrics.update(out)
        out.update(self.best_val_metrics.compute())
        return out

    @staticmethod
    def _has_real_val_data(loader) -> bool:
        ds = getattr(loader, "dataset", None)
        return not type(ds).__name__.startswith("Dummy")

    # -- checkpoint extras (normalizers etc.) --------------------------------
    def state_dict_extras(self) -> dict:
        return dict(self._extras)

    def load_state_dict_extras(self, extras: dict) -> None:
        self._extras.update(extras or {})

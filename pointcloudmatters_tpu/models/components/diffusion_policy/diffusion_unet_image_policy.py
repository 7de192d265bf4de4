"""Diffusion policy: DDPM over normalized action trajectories.

Reference `diffusion_unet_image_policy.py:23-313`. Training adds noise at a
random timestep and regresses it (epsilon-prediction MSE with the impainting
loss mask); inference runs the full reverse chain under a lifted
``nn.while_loop`` — one compiled UNet body iterated ``num_inference_steps``
times on device, instead of 100 Python-level launches.

Normalization: the ``LinearNormalizer`` (fit on the dataset, reference
`maniskill2_dp_bc_module.py:54-57`) is attached as a module field via
``policy.clone(normalizer=...)`` before init; its stats are numpy constants
baked into the jitted step. The task module persists the stats in checkpoint
extras, mirroring the reference's state-dict trick
(`dict_of_tensor_mixin.py:16-35`).

Call protocol: ``policy(data_dict, train=...)``. With ``"action"`` present ->
``{"loss": ...}``; without -> ``{"action", "action_pred", "a_hat"}`` (the
``a_hat`` alias feeds the shared rollout loop). RNG streams: ``noise``
(training), ``sample`` (inference), ``dropout``/``crop`` (encoders).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion.conditional_unet1d import (
    ConditionalUnet1D,
)
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion.ddpm import (
    DDPMScheduler,
)
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion.mask_generator import (
    LowdimMaskGenerator,
)


class DiffusionUnetImagePolicy(nn.Module):
    shape_meta: Any
    noise_scheduler: DDPMScheduler
    obs_encoder: nn.Module
    horizon: int
    n_action_steps: int
    n_obs_steps: int
    num_inference_steps: Optional[int] = None
    obs_as_global_cond: bool = True
    diffusion_step_embed_dim: int = 256
    down_dims: Sequence[int] = (256, 512, 1024)
    kernel_size: int = 5
    n_groups: int = 8
    cond_predict_scale: bool = True
    normalizer: Any = None  # LinearNormalizer; None = identity

    @property
    def action_dim(self) -> int:
        shape = self.shape_meta["action"]["shape"]
        assert len(shape) == 1
        return int(shape[0])

    # kept for parity with ACT-driven code paths (rollout loop)
    @property
    def num_queries(self) -> int:
        return self.n_action_steps

    def setup(self):
        if not self.obs_as_global_cond:
            raise NotImplementedError("obs_as_global_cond=False")
        self.model = ConditionalUnet1D(
            input_dim=self.action_dim,
            local_cond_dim=None,
            global_cond_dim=-1,  # inferred from the actual cond width
            diffusion_step_embed_dim=self.diffusion_step_embed_dim,
            down_dims=tuple(self.down_dims),
            kernel_size=self.kernel_size,
            n_groups=self.n_groups,
            cond_predict_scale=self.cond_predict_scale,
            name="model",
        )
        self.mask_generator = LowdimMaskGenerator(
            action_dim=self.action_dim, obs_dim=0,
            max_n_obs_steps=self.n_obs_steps, fix_obs_steps=True,
            action_visible=False,
        )

    # ------------------------------------------------------------------
    # normalization helpers (stats are numpy constants)
    # ------------------------------------------------------------------
    def _normalize_obs(self, obs: dict) -> dict:
        if self.normalizer is None:
            return dict(obs)
        out = {}
        for k, v in obs.items():
            out[k] = self.normalizer[k].normalize(v) if k in self.normalizer else v
        return out

    def _normalize_action(self, action):
        if self.normalizer is None or "action" not in self.normalizer:
            return action
        return self.normalizer["action"].normalize(action)

    def _unnormalize_action(self, action):
        if self.normalizer is None or "action" not in self.normalizer:
            return action
        return self.normalizer["action"].unnormalize(action)

    # ------------------------------------------------------------------
    # conditioning
    # ------------------------------------------------------------------
    def _global_cond(self, data_dict: dict, train: bool):
        obs = dict(data_dict["obs"])
        pcds = obs.pop("pcds", None)
        nobs = self._normalize_obs(obs)
        To = self.n_obs_steps
        value = next(iter(nobs.values()))
        B = value.shape[0]
        # (B, T, ...) -> first To frames flattened to (B*To, ...)
        this_nobs = {
            k: v[:, :To].reshape((B * To,) + v.shape[2:]) for k, v in nobs.items()
        }
        if pcds is not None:
            this_nobs["pcds"] = pcds  # already (B*To, N, ...) from collate
        nobs_features = self.obs_encoder(this_nobs, train=train)
        global_cond = nobs_features.reshape(B, -1)

        goal = data_dict.get("goal")
        if goal is not None and "task_emb" in goal:
            task_emb = goal["task_emb"].reshape(B, -1)
            global_cond = jnp.concatenate([global_cond, task_emb], axis=-1)
        return global_cond, B

    # ------------------------------------------------------------------
    # inference (`diffusion_unet_image_policy.py:106-227`)
    # ------------------------------------------------------------------
    def conditional_sample(self, cond_data, cond_mask, global_cond, key):
        scheduler = self.noise_scheduler
        n_steps = self.num_inference_steps or scheduler.num_train_timesteps
        ts = scheduler.inference_timesteps(n_steps)
        ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)

        key, k0 = jax.random.split(key)
        init_traj = jax.random.normal(k0, cond_data.shape, cond_data.dtype)

        def cond_fn(mdl, carry):
            i, _ = carry
            return i < len(ts)

        def body_fn(mdl, carry):
            i, traj = carry
            traj = jnp.where(cond_mask, cond_data, traj)
            t = jnp.asarray(ts)[i]
            pred = mdl.model(traj, t, global_cond=global_cond)
            noise = jax.random.normal(jax.random.fold_in(key, i), traj.shape)
            traj = scheduler.step(pred, t, jnp.asarray(ts_prev)[i], traj, noise)
            return i + 1, traj

        _, traj = nn.while_loop(
            cond_fn, body_fn, self, (jnp.zeros((), jnp.int32), init_traj)
        )
        return jnp.where(cond_mask, cond_data, traj)

    def predict_action(self, data_dict: dict) -> dict:
        global_cond, B = self._global_cond(data_dict, train=False)
        T, Da = self.horizon, self.action_dim
        cond_data = jnp.zeros((B, T, Da), jnp.float32)
        cond_mask = jnp.zeros((B, T, Da), bool)
        nsample = self.conditional_sample(
            cond_data, cond_mask, global_cond, self.make_rng("sample")
        )
        action_pred = self._unnormalize_action(nsample[..., :Da])
        start = self.n_obs_steps - 1
        action = action_pred[:, start:start + self.n_action_steps]
        return dict(data_dict, action=action, action_pred=action_pred,
                    a_hat=action, is_training=False)

    # ------------------------------------------------------------------
    # training (`diffusion_unet_image_policy.py:233-313`)
    # ------------------------------------------------------------------
    def compute_loss(self, data_dict: dict, train: bool) -> dict:
        global_cond, B = self._global_cond(data_dict, train=train)
        nactions = self._normalize_action(data_dict["action"])
        trajectory = nactions

        condition_mask = self.mask_generator(trajectory.shape)
        key = self.make_rng("noise")
        k_noise, k_t = jax.random.split(key)
        noise = jax.random.normal(k_noise, trajectory.shape, trajectory.dtype)
        timesteps = jax.random.randint(
            k_t, (B,), 0, self.noise_scheduler.num_train_timesteps
        )
        noisy = self.noise_scheduler.add_noise(trajectory, noise, timesteps)
        noisy = jnp.where(condition_mask, trajectory, noisy)

        pred = self.model(noisy, timesteps, global_cond=global_cond)
        pred_type = self.noise_scheduler.prediction_type
        if pred_type == "epsilon":
            target = noise
        elif pred_type == "sample":
            target = trajectory
        else:
            raise ValueError(f"Unsupported prediction type {pred_type}")

        loss_mask = (~condition_mask).astype(pred.dtype)
        loss = ((pred - target) ** 2) * loss_mask
        loss = jnp.mean(loss.reshape(B, -1), axis=-1).mean()
        return dict(data_dict, loss=loss, is_training=True)

    def __call__(self, data_dict: dict, train: bool = False) -> dict:
        if "action" in data_dict:
            return self.compute_loss(data_dict, train)
        return self.predict_action(data_dict)

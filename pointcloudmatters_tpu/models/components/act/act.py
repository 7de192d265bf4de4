"""ACT policy family — CVAE action-chunking transformers.

Re-implements the four policies of reference `act/act.py:40,312,601,707`
(`ACT`, `ACTPCD`, `ACTRLBench`, `ACTRLBenchPCD`) as ``nn`` modules over
padded batches:

- batch-first token sequences; point clouds are ``(B, N, ...)`` + ``valid``
  masks instead of the packed offset layout, so FPS/kNN/grouping run as
  batched XLA ops (`pointcloudmatters_tpu.ops.pointops`)
- the CVAE posterior samples with an explicit ``vae`` PRNG stream during
  training; at evaluation the latent is the posterior mean when actions are
  provided (the reference samples there too — a noise source we drop) and
  zeros otherwise (`act/act.py:177-182`)
- quirk preserved: the decoder output consumed is intermediate index 0 — the
  *first* decoder layer (`act/act.py:262-270`); the remaining layers are not
  computed

Call protocol: ``module(data_dict, train=...)`` returns a new dict with
outputs merged (``a_hat``, ``is_pad_hat``, and when actions are present
``loss``/``action_loss``/``kl_loss``), mirroring the reference's data-dict
threading.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.act.positional_encoding import (
    coord_embedding_sine,
)
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer,
    TransformerEncoder,
)
from pointcloudmatters_tpu.models.components.loss.misc import (
    KLDivergence,
    build_action_loss,
    masked_action_loss,
)
from pointcloudmatters_tpu.models.components.nn_utils import (
    GroupedBNReluMax,
    get_sinusoid_encoding_table,
    reparametrize,
)
from pointcloudmatters_tpu.ops.pointops import (
    farthest_point_sampling_padded,
    knn_query_padded,
)
from pointcloudmatters_tpu.utils.rotation_conversions import (
    matrix_to_quaternion,
    rotation_6d_to_matrix,
)


class ACT(nn.Module):
    """Action Chunking Transformer (`act/act.py:40-309`).

    ``backbone`` is any image encoder module with protocol
    ``backbone(images_nhwc, train=...) -> (B, h, w, c) | (B, c)``.
    """

    backbone: Optional[nn.Module]
    transformer: Transformer
    encoder: Optional[TransformerEncoder]
    hidden_dim: int
    num_queries: int
    num_cameras: int
    action_dim: int = 8
    qpos_dim: int = 9
    env_state_dim: int = 0
    latent_dim: int = 32
    action_loss: Any = None
    klloss: Any = None
    kl_weight: float = 20.0
    goal_cond_dim: int = 0
    obs_feature_pos_embedding: Optional[nn.Module] = None
    freeze_backbone: bool = False
    ignore_vae: bool = False
    pretrained_weight: Optional[str] = None
    feature_mode: str = "cls"

    def setup(self):
        if self.backbone is not None:
            self.input_proj = nn.Dense(self.hidden_dim, name="input_proj")
        else:
            self.input_proj_env_state = nn.Dense(self.hidden_dim)
            self.state_pos_embed = self.param(
                "state_pos_embed", nn.initializers.normal(1.0),
                (2 + int(self.goal_cond_dim > 0), self.hidden_dim),
            )
        self.input_proj_robot_state = nn.Dense(self.hidden_dim)
        self.cls_embed = self.param(
            "cls_embed", nn.initializers.normal(1.0), (1, self.hidden_dim)
        )
        self.encoder_action_proj = nn.Dense(self.hidden_dim)
        self.encoder_joint_proj = nn.Dense(self.hidden_dim)
        self.latent_proj = nn.Dense(self.latent_dim * 2)
        if self.goal_cond_dim > 0:
            self.proj_goal_cond_emb = nn.Dense(self.hidden_dim)
        self.action_head = nn.Dense(self.action_dim)
        self.is_pad_head = nn.Dense(1)
        self.query_embed = self.param(
            "query_embed", nn.initializers.normal(1.0),
            (self.num_queries, self.hidden_dim),
        )
        self.latent_out_proj = nn.Dense(self.hidden_dim)
        self.additional_pos_embed = self.param(
            "additional_pos_embed", nn.initializers.normal(1.0),
            (2 + int(self.goal_cond_dim > 0), self.hidden_dim),
        )
        self._klloss = self.klloss if callable(self.klloss) else KLDivergence()
        self._action_loss = build_action_loss(self.action_loss)

    # ------------------------------------------------------------------
    # CVAE posterior (`act/act.py:137-188`)
    # ------------------------------------------------------------------
    def forward_encoder(self, data_dict: dict, train: bool) -> dict:
        qpos = data_dict["qpos"]
        actions = data_dict.get("actions")
        is_pad = data_dict.get("is_pad")
        is_training = actions is not None
        bs = qpos.shape[0]

        if is_training and not self.ignore_vae:
            action_embed = self.encoder_action_proj(actions)  # (B, nq, D)
            qpos_embed = self.encoder_joint_proj(qpos)[:, None, :]  # (B, 1, D)
            cls = jnp.broadcast_to(
                self.cls_embed[None], (bs, 1, self.hidden_dim)
            ).astype(action_embed.dtype)
            tokens = jnp.concatenate([cls, qpos_embed, action_embed], axis=1)
            no_pad = jnp.zeros((bs, 2), bool)  # never mask [CLS], qpos
            pad_mask = jnp.concatenate([no_pad, is_pad], axis=1)
            pos = get_sinusoid_encoding_table(
                1 + 1 + self.num_queries, self.hidden_dim
            )
            out = self.encoder(
                tokens, pos=pos, key_padding_mask=pad_mask,
                deterministic=not train,
            )
            latent_info = self.latent_proj(out[:, 0])  # [CLS] output only
            mu = latent_info[:, : self.latent_dim]
            logvar = latent_info[:, self.latent_dim:]
            if train:
                latent_sample = reparametrize(mu, logvar, self.make_rng("vae"))
            else:
                latent_sample = mu
            latent_input = self.latent_out_proj(latent_sample)
        else:
            mu = logvar = None
            latent_sample = jnp.zeros((bs, self.latent_dim), jnp.float32)
            latent_input = self.latent_out_proj(latent_sample)

        return dict(
            data_dict, mu=mu, logvar=logvar, latent_input=latent_input,
            is_training=is_training,
        )

    # ------------------------------------------------------------------
    # Observation tokens (`act/act.py:190-253`)
    # ------------------------------------------------------------------
    def _goal_embed(self, data_dict: dict) -> Optional[jax.Array]:
        if self.goal_cond_dim <= 0:
            return None
        goal = data_dict["goal_cond"]
        if goal.ndim > 2:
            goal = goal.reshape(goal.shape[0], -1)
        return self.proj_goal_cond_emb(goal)

    def forward_obs_embed(self, data_dict: dict, train: bool) -> dict:
        qpos = data_dict["qpos"]
        latent_input = data_dict["latent_input"]
        goal_cond = self._goal_embed(data_dict)

        if self.backbone is not None:
            image = data_dict["image"]  # (B, num_cameras, H, W, C)
            cam_tokens, cam_pos = [], []
            for cam_id in range(self.num_cameras):
                feats = self.backbone(image[:, cam_id], train=train)
                if self.freeze_backbone:
                    feats = jax.lax.stop_gradient(feats)
                if feats.ndim == 2:  # ViT-style pooled feature
                    feats = feats[:, None, None, :]
                pos = self.obs_feature_pos_embedding(feats)  # (1, hw, D)
                cam_tokens.append(
                    self.input_proj(feats).reshape(feats.shape[0], -1, self.hidden_dim)
                )
                cam_pos.append(pos)
            src = jnp.concatenate(cam_tokens, axis=1)
            pos = jnp.concatenate(cam_pos, axis=1)
            proprio = self.input_proj_robot_state(qpos)[:, None, :]
            if goal_cond is not None:
                proprio = jnp.concatenate([proprio, goal_cond[:, None, :]], 1)
            return dict(data_dict, src=src, pos=pos, latent_input=latent_input,
                        proprio_input=proprio)

        # state-only path (`act/act.py:237-246`)
        qpos_tok = self.input_proj_robot_state(qpos)[:, None, :]
        env_tok = self.input_proj_env_state(data_dict["env_state"])[:, None, :]
        toks = [qpos_tok, env_tok]
        if goal_cond is not None:
            toks.append(goal_cond[:, None, :])
        src = jnp.concatenate(toks, axis=1)
        pos = self.state_pos_embed[None]
        return dict(data_dict, src=src, pos=pos, latent_input=None,
                    proprio_input=None)

    # ------------------------------------------------------------------
    # Decoder + heads (`act/act.py:255-279`)
    # ------------------------------------------------------------------
    def _decode(self, data_dict: dict, train: bool) -> jax.Array:
        hs = self.transformer(
            data_dict["src"],
            self.query_embed,
            pos=data_dict["pos"],
            latent_input=data_dict["latent_input"],
            proprio_input=data_dict["proprio_input"],
            additional_pos_embed=(
                self.additional_pos_embed
                if data_dict["latent_input"] is not None else None
            ),
            deterministic=not train,
        )
        return hs[0]  # first decoder layer intermediate — reference quirk

    def forward_decoder(self, data_dict: dict, train: bool) -> dict:
        hs = self._decode(data_dict, train)
        a_hat = self.action_head(hs)
        is_pad_hat = self.is_pad_head(hs)
        return dict(data_dict, a_hat=a_hat, is_pad_hat=is_pad_hat)

    # ------------------------------------------------------------------
    # Loss (`act/act.py:281-291`)
    # ------------------------------------------------------------------
    def forward_loss(self, data_dict: dict) -> dict:
        total_kld = self._klloss(data_dict["mu"], data_dict["logvar"])
        action_loss = masked_action_loss(
            self._action_loss, data_dict["a_hat"], data_dict["actions"],
            data_dict["is_pad"],
        )
        return dict(
            data_dict,
            action_loss=action_loss,
            kl_loss=total_kld,
            loss=action_loss + total_kld * self.kl_weight,
        )

    def __call__(self, data_dict: dict, train: bool = False) -> dict:
        data_dict = self.forward_encoder(data_dict, train)
        data_dict = self.forward_obs_embed(data_dict, train)
        data_dict = self.forward_decoder(data_dict, train)
        if not data_dict["is_training"]:
            return data_dict
        return self.forward_loss(data_dict)


class ACTPCD(ACT):
    """ACT over point-cloud tokens (`act/act.py:312-598`).

    ``backbone`` protocol: ``backbone(pcd_dict, train=...) -> (B, N, C)``
    per-point features over the padded cloud.
    """

    pcd_nsample: int = 16
    pcd_npoints: int = 1024
    sampling: str = "fps"
    heatmap_th: float = 0.1
    use_mask: bool = False
    bg_ratio: float = 0.0
    pre_sample: bool = False
    in_channels: int = 6

    def setup(self):
        super().setup()
        self.input_proj = None
        if not self.pre_sample:
            proj_dim = self.hidden_dim
        else:
            proj_dim = self.backbone.in_channels
        self.pcd_linear = nn.Dense(proj_dim, use_bias=False, name="pcd_linear")
        self.pcd_bn = GroupedBNReluMax(name="pcd_bn")

    # ------------------------------------------------------------------
    # FPS + kNN-group token builder (`act/act.py:384-465`)
    # ------------------------------------------------------------------
    def _fps_indices(self, coord, valid, fg_mask) -> jax.Array:
        npoints = self.pcd_npoints
        if not self.use_mask or fg_mask is None:
            return farthest_point_sampling_padded(coord, valid, npoints)
        n_bg = int(npoints * self.bg_ratio)
        n_fg = npoints - n_bg
        fg_idx = farthest_point_sampling_padded(
            coord, valid & fg_mask.astype(bool), n_fg
        )
        if n_bg > 0:
            bg_idx = farthest_point_sampling_padded(
                coord, valid & ~fg_mask.astype(bool), n_bg
            )
            return jnp.concatenate([fg_idx, bg_idx], axis=1)
        return fg_idx

    def pcd_sampling(self, coord, feat, valid, fg_mask=None, train=False):
        """Returns (new_xyz (B,m,3), tokens (B,m,proj_dim), idx (B,m)).

        The reference projects the gathered ``(m, k, 3 + C)`` neighborhoods
        through the linear layer (`act/act.py:457-460`). ``pcd_linear`` is
        bias-free, so the same map splits linearly:

            Dense([xyz[nn] - new_xyz, feat[nn]])
              = (Dense([xyz, feat]))[nn] - Dense([new_xyz, 0])

        Projecting the N source points once instead of every (m, k) gather
        copy cuts the dominant matmul M*K/N-fold (3.2x at the flagship
        shapes). The gather→BN→ReLU→max tail then runs through the fused
        ``GroupedBNReluMax`` (bit-exact — see its docstring), which never
        applies BN/ReLU over the (B, m, k, D) neighborhood tensor.
        """
        idx = self._fps_indices(coord, valid, fg_mask)
        new_xyz = jnp.take_along_axis(coord, idx[..., None], axis=1)
        nn_idx, _ = knn_query_padded(new_xyz, coord, valid, self.pcd_nsample)
        zeros_f = jnp.zeros(new_xyz.shape[:-1] + (feat.shape[-1],), feat.dtype)
        src_cat = jnp.concatenate([coord, feat], axis=-1)
        query_cat = jnp.concatenate([new_xyz, zeros_f], axis=-1)
        h = self.pcd_linear(query_cat)
        g = self.pcd_linear(src_cat)  # (B, N, D)
        x = self.pcd_bn(g, h, nn_idx, use_running_average=not train)
        return new_xyz, x, idx

    def forward_pcd_embed(self, pcd_dict: dict, train: bool):
        coord = pcd_dict["coord"]
        valid = pcd_dict["valid"].astype(bool)
        fg_mask = pcd_dict.get("mask") if self.use_mask else None

        if self.pre_sample:
            new_xyz, feat, idx = self.pcd_sampling(
                coord, pcd_dict["feat"], valid, fg_mask, train=train,
            )
            sampled = dict(
                pcd_dict,
                coord=new_xyz,
                feat=feat,
                valid=jnp.ones(idx.shape, bool),
            )
            if "grid_coord" in pcd_dict:
                sampled["grid_coord"] = jnp.take_along_axis(
                    pcd_dict["grid_coord"], idx[..., None], axis=1
                )
            features = self.backbone(sampled, train=train)
            coords_out = new_xyz
        else:
            features = self.backbone(pcd_dict, train=train)
            if self.freeze_backbone:
                features = jax.lax.stop_gradient(features)
            coords_out, features, _ = self.pcd_sampling(
                coord, features, valid, fg_mask, train=train,
            )

        pcd_pos = coord_embedding_sine(coords_out, self.hidden_dim)
        return features, pcd_pos  # both (B, npoints, hidden)

    def forward_obs_embed(self, data_dict: dict, train: bool) -> dict:
        qpos = data_dict["qpos"]
        latent_input = data_dict["latent_input"]
        goal_cond = self._goal_embed(data_dict)

        src, pos = self.forward_pcd_embed(data_dict["pcds"], train)
        proprio = self.input_proj_robot_state(qpos)[:, None, :]
        if goal_cond is not None:
            proprio = jnp.concatenate([proprio, goal_cond[:, None, :]], axis=1)
        return dict(data_dict, src=src, pos=pos, latent_input=latent_input,
                    proprio_input=proprio)


class _RLBenchHeadMixin:
    """Gripper-pose action head shared by the RLBench variants
    (`act/act.py:649-704,770-825`): sigmoid gripper (+ collision) channels,
    6D-rotation output converted to quaternion at inference, and a position
    loss weight on the xyz channels."""

    def forward_decoder(self, data_dict: dict, train: bool) -> dict:
        hs = self._decode(data_dict, train)
        a_hat = self.action_head(hs)
        position = a_hat[..., :3]
        if self.collision:
            collision = jax.nn.sigmoid(a_hat[..., -1:])
            gripper = jnp.concatenate(
                [jax.nn.sigmoid(a_hat[..., -2:-1]), collision], axis=-1
            )
            rot = a_hat[..., 3:-2]
        else:
            gripper = jax.nn.sigmoid(a_hat[..., -1:])
            rot = a_hat[..., 3:-1]
        if not data_dict["is_training"]:
            if self.rot_type != "6d":
                raise NotImplementedError(self.rot_type)
            rot = matrix_to_quaternion(rotation_6d_to_matrix(rot))
        a_hat = jnp.concatenate([position, rot, gripper], axis=-1)
        is_pad_hat = self.is_pad_head(hs)
        return dict(data_dict, a_hat=a_hat, is_pad_hat=is_pad_hat)

    def forward_loss(self, data_dict: dict) -> dict:
        total_kld = self._klloss(data_dict["mu"], data_dict["logvar"])
        per_elem = self._action_loss(data_dict["a_hat"], data_dict["actions"])
        weight = jnp.ones(per_elem.shape[-1])
        weight = weight.at[:3].set(self.position_loss_weight)
        per_elem = per_elem * weight
        keep = (~data_dict["is_pad"])[..., None].astype(per_elem.dtype)
        action_loss = jnp.mean(per_elem * keep)
        return dict(
            data_dict,
            action_loss=action_loss,
            kl_loss=total_kld,
            loss=action_loss + total_kld * self.kl_weight,
        )


class ACTRLBench(_RLBenchHeadMixin, ACT):
    """`act/act.py:601-704`."""

    rot_type: str = "6d"
    collision: bool = False
    position_loss_weight: float = 1.0


class ACTRLBenchPCD(_RLBenchHeadMixin, ACTPCD):
    """`act/act.py:707-825`."""

    rot_type: str = "6d"
    collision: bool = False
    position_loss_weight: float = 1.0

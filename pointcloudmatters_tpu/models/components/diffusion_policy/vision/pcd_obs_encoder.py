"""Point-cloud observation encoder for the diffusion policy, padded-native.

Reference `vision/pcd_obs_encoder.py:14-296`: per-point backbone features ->
FPS to ``pcd_npoints`` -> kNN-group(``pcd_nsample``) -> linear-BN-ReLU-maxpool
-> 1x1-conv projector + global maxpool over points -> one feature vector per
observation frame; low-dim keys concatenated. Operates on padded ``(B*To, N,
...)`` clouds with validity masks (batched XLA FPS/kNN from
``pointcloudmatters_tpu.ops.pointops``) instead of the packed offset layout.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.nn_utils import (
    GroupedBNReluMax,
    MaskedBatchNorm,
)
from pointcloudmatters_tpu.ops.pointops import (
    farthest_point_sampling_padded,
    knn_query_padded,
)


class PCDObsEncoder(nn.Module):
    shape_meta: Any
    pcd_model: nn.Module
    share_pcd_model: bool = True
    n_obs_step: int = 2
    pcd_nsample: int = 16
    pcd_npoints: int = 1024
    use_mask: bool = False
    bg_ratio: float = 0.0
    pcd_hidden_dim: int = 128
    projector_layers: int = 2
    projector_channels: Sequence[int] = (128, 128, 128)
    pre_sample: bool = False
    in_channel: int = 6

    @property
    def output_dim(self) -> int:
        """Feature width contributed per obs frame, before low-dim concat."""
        return self.projector_channels[self.projector_layers]

    def setup(self):
        meta = self.shape_meta["obs"]
        self.pcd_keys = sorted(k for k, a in meta.items()
                               if a.get("type", "low_dim") == "pcd")
        self.low_dim_keys = sorted(k for k, a in meta.items()
                                   if a.get("type", "low_dim") == "low_dim")
        if not self.pre_sample:
            proj_in = self.pcd_hidden_dim
        else:
            proj_in = self.in_channel
        self.linear = nn.Dense(proj_in, use_bias=False, name="linear")
        self.bn = GroupedBNReluMax(name="bn")
        blocks = []
        for i in range(self.projector_layers):
            blocks.append(nn.Dense(self.projector_channels[i],
                                   name=f"projector_conv{i}"))
            blocks.append(MaskedBatchNorm(name=f"projector_bn{i}"))
        self.projector_blocks = blocks
        self.projector_out = nn.Dense(
            self.projector_channels[self.projector_layers], name="projector_out"
        )
        self.projector_out_bn = MaskedBatchNorm(name="projector_out_bn")

    # -- FPS + kNN token pooling (`pcd_obs_encoder.py:123-198`) -------------
    def _fps_indices(self, coord, valid, fg_mask):
        npoints = self.pcd_npoints
        if not self.use_mask or fg_mask is None:
            return farthest_point_sampling_padded(coord, valid, npoints)
        n_bg = int(npoints * self.bg_ratio)
        fg_idx = farthest_point_sampling_padded(
            coord, valid & fg_mask.astype(bool), npoints - n_bg
        )
        if n_bg > 0:
            bg_idx = farthest_point_sampling_padded(
                coord, valid & ~fg_mask.astype(bool), n_bg
            )
            return jnp.concatenate([fg_idx, bg_idx], axis=1)
        return fg_idx

    def pcd_sampling(self, coord, feat, valid, fg_mask=None, train=False):
        # fused token builder — the bias-free linear over the grouped
        # [xyz[nn] - new_xyz, feat[nn]] rows splits as
        # Dense([xyz, feat])[nn] - Dense([new_xyz, 0]); the gather→BN→ReLU→max
        # tail runs through GroupedBNReluMax (bit-exact, see its docstring)
        idx = self._fps_indices(coord, valid, fg_mask)
        new_xyz = jnp.take_along_axis(coord, idx[..., None], axis=1)
        nn_idx, _ = knn_query_padded(new_xyz, coord, valid, self.pcd_nsample)
        zeros_f = jnp.zeros(new_xyz.shape[:-1] + (feat.shape[-1],), feat.dtype)
        src_cat = jnp.concatenate([coord, feat], axis=-1)
        query_cat = jnp.concatenate([new_xyz, zeros_f], axis=-1)
        h = self.linear(query_cat)
        g = self.linear(src_cat)  # (B, N, D)
        x = self.bn(g, h, nn_idx, use_running_average=not train)
        return new_xyz, x, idx  # (B, npoints, proj_in)

    def encode_pcd(self, pcd_dict: dict, train: bool) -> jax.Array:
        coord = pcd_dict["coord"]
        valid = pcd_dict["valid"].astype(bool)
        fg_mask = pcd_dict.get("mask") if self.use_mask else None
        if self.pre_sample:
            new_xyz, feat, idx = self.pcd_sampling(
                coord, pcd_dict["feat"], valid, fg_mask, train=train,
            )
            sampled = dict(pcd_dict, coord=new_xyz, feat=feat,
                           valid=jnp.ones(idx.shape, bool))
            if "grid_coord" in pcd_dict:
                sampled["grid_coord"] = jnp.take_along_axis(
                    pcd_dict["grid_coord"], idx[..., None], axis=1
                )
            x = self.pcd_model(sampled, train=train)
        else:
            features = self.pcd_model(pcd_dict, train=train)
            _, x, _ = self.pcd_sampling(coord, features, valid, fg_mask,
                                        train=train)
        # projector (`pcd_obs_encoder.py:102-122`): pointwise convs + BN +
        # ReLU, global maxpool over points, final pointwise conv + BN
        for i in range(self.projector_layers):
            x = self.projector_blocks[2 * i](x)
            x = self.projector_blocks[2 * i + 1](x, use_running_average=not train)
            x = jax.nn.relu(x)
        x = jnp.max(x, axis=1)  # (B, C)
        x = self.projector_out(x)
        x = self.projector_out_bn(x, use_running_average=not train)
        return x

    def __call__(self, obs_dict: dict, train: bool = False) -> jax.Array:
        features = []
        batch_size: Optional[int] = None
        for key in self.pcd_keys:
            feat = self.encode_pcd(obs_dict[key], train)
            batch_size = feat.shape[0]
            features.append(feat)
        for key in self.low_dim_keys:
            data = obs_dict[key]
            if batch_size is not None:
                assert data.shape[0] == batch_size, (key, data.shape, batch_size)
            features.append(data)
        return jnp.concatenate(features, axis=-1)

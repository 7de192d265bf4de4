"""Multi-key image/low-dim observation encoder, NHWC.

Reference `vision/multi_image_obs_encoder.py:19-244` + the robomimic-style
``CropRandomizer`` (`vision/crop_randomizer.py:13-150`): per-key resize ->
crop (random at train, center at eval) -> optional ImageNet norm -> shared or
per-key rgb model; depth channels merged onto their rgb key; low-dim keys
concatenated raw. ``use_group_norm`` is a construction-time property of the
rgb model here (pass a GroupNorm-built encoder) rather than a post-hoc module
surgery — modules are immutable.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from pointcloudmatters_tpu import nn

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def center_crop(x: jax.Array, h: int, w: int) -> jax.Array:
    H, W = x.shape[-3], x.shape[-2]
    top, left = (H - h) // 2, (W - w) // 2
    return x[..., top:top + h, left:left + w, :]


def random_crop(x: jax.Array, h: int, w: int, key: jax.Array) -> jax.Array:
    """One random crop per batch element (CropRandomizer num_crops=1,
    `crop_randomizer.py:88-150`)."""
    B, H, W = x.shape[0], x.shape[-3], x.shape[-2]
    kh, kw = jax.random.split(key)
    tops = jax.random.randint(kh, (B,), 0, H - h + 1)
    lefts = jax.random.randint(kw, (B,), 0, W - w + 1)

    def crop_one(img, top, left):
        return jax.lax.dynamic_slice(
            img, (top, left, 0), (h, w, img.shape[-1])
        )

    return jax.vmap(crop_one)(x, tops, lefts)


class MultiImageObsEncoder(nn.Module):
    shape_meta: Any
    rgb_model: nn.Module
    resize_shape: Union[Tuple[int, int], None] = None
    crop_shape: Union[Tuple[int, int], None] = None
    random_crop: bool = True
    use_group_norm: bool = False  # see module docstring
    share_rgb_model: bool = False
    imagenet_norm: bool = False
    use_depth: bool = False
    only_depth: bool = False

    def setup(self):
        meta = self.shape_meta["obs"]
        self.rgb_keys = sorted(k for k, a in meta.items()
                               if a.get("type", "low_dim") == "rgb")
        self.depth_keys = sorted(k for k, a in meta.items()
                                 if a.get("type", "low_dim") == "depth")
        self.low_dim_keys = sorted(k for k, a in meta.items()
                                   if a.get("type", "low_dim") == "low_dim")
        if not self.share_rgb_model:
            # independent copy per rgb key (reference deep-copies the model)
            self.key_models = {
                k: self.rgb_model.clone(name=f"model_{k}") for k in self.rgb_keys
            }

    def _transform(self, img: jax.Array, train: bool) -> jax.Array:
        if self.resize_shape is not None:
            h, w = self.resize_shape
            img = jax.image.resize(
                img, img.shape[:-3] + (h, w, img.shape[-1]), method="bilinear"
            )
        if self.crop_shape is not None:
            h, w = self.crop_shape
            if self.random_crop and train:
                img = random_crop(img, h, w, self.make_rng("crop"))
            else:
                img = center_crop(img, h, w)
        if self.imagenet_norm:
            mean = jnp.asarray(_IMAGENET_MEAN, img.dtype)
            std = jnp.asarray(_IMAGENET_STD, img.dtype)
            rgb = (img[..., :3] - mean) / std
            img = jnp.concatenate([rgb, img[..., 3:]], axis=-1) \
                if img.shape[-1] > 3 else rgb
        return img

    def _merge_depth(self, key: str, img: jax.Array, obs_dict: dict) -> jax.Array:
        use_depth = self.use_depth or self.only_depth
        depth_key = key.replace("rgb", "depth")
        if use_depth and depth_key in obs_dict and depth_key in self.depth_keys:
            depth = obs_dict[depth_key]
            if self.only_depth:
                return depth
            return jnp.concatenate([img, depth], axis=-1)
        return img

    def __call__(self, obs_dict: dict, train: bool = False) -> jax.Array:
        features = []
        batch_size: Optional[int] = None
        if self.share_rgb_model and self.rgb_keys:
            imgs = []
            for key in self.rgb_keys:
                img = self._merge_depth(key, obs_dict[key], obs_dict)
                imgs.append(self._transform(img, train))
                batch_size = img.shape[0]
            stacked = jnp.concatenate(imgs, axis=0)  # (N*B, H, W, C)
            feat = self.rgb_model(stacked, train=train)
            if feat.ndim > 2:
                raise ValueError(
                    "shared rgb_model must pool to (B, D); set avg_pool=True"
                )
            feat = feat.reshape(len(self.rgb_keys), batch_size, -1)
            feat = jnp.moveaxis(feat, 0, 1).reshape(batch_size, -1)
            features.append(feat)
        else:
            for key in self.rgb_keys:
                img = self._merge_depth(key, obs_dict[key], obs_dict)
                img = self._transform(img, train)
                feat = self.key_models[key](img, train=train)
                batch_size = feat.shape[0]
                features.append(feat.reshape(batch_size, -1))
        for key in self.low_dim_keys:
            data = obs_dict[key]
            if batch_size is not None:
                assert data.shape[0] == batch_size, (key, data.shape)
            features.append(data)
        return jnp.concatenate(features, axis=-1)

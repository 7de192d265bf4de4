"""robomimic-style CropRandomizer, NHWC — full reference surface.

Reference `vision/crop_randomizer.py:13-256` (itself from diffusion_policy /
robomimic): ``forward_in`` samples ``num_crops`` random crops per image at
train time and folds them into the batch dim (center crop expanded N-fold at
eval); ``forward_out`` splits ``[B*N, ...]`` back and averages the N crop
features. ``pos_enc`` appends two channels encoding each cropped pixel's
normalized source location.

The shipped configs only exercise ``num_crops=1`` (which
``MultiImageObsEncoder`` handles inline); this module completes the n-crop
library surface for parity. Layout is NHWC (XLA conv layout); the reference
is NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from pointcloudmatters_tpu import nn


def crop_image_from_indices(
    images: jax.Array, crop_indices: jax.Array, crop_height: int,
    crop_width: int,
) -> jax.Array:
    """Crop NHWC ``images (..., H, W, C)`` at ``crop_indices (..., N, 2)``
    (top-left (h, w) per crop) -> ``(..., N, CH, CW, C)``
    (`crop_randomizer.py:150-256`)."""
    assert crop_indices.shape[-1] == 2
    *lead, H, W, C = images.shape
    n = crop_indices.shape[-2]
    flat_imgs = images.reshape((-1, H, W, C))
    flat_idx = crop_indices.reshape((-1, n, 2))

    def crop_one(img, tl):
        return jax.lax.dynamic_slice(
            img, (tl[0], tl[1], 0), (crop_height, crop_width, C)
        )

    crops = jax.vmap(  # over batch
        jax.vmap(crop_one, in_axes=(None, 0))  # over crops
    )(flat_imgs, flat_idx)
    return crops.reshape((*lead, n, crop_height, crop_width, C))


def sample_random_image_crops(
    key: jax.Array, images: jax.Array, crop_height: int, crop_width: int,
    num_crops: int, pos_enc: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Uniformly sample ``num_crops`` crops per image
    (`crop_randomizer.py:258-331`). Returns ``(crops, crop_inds)`` with
    crops ``(..., N, CH, CW, C[+2])``."""
    *lead, H, W, C = images.shape
    if pos_enc:
        ph, pw = jnp.meshgrid(
            jnp.arange(H, dtype=images.dtype) / H,
            jnp.arange(W, dtype=images.dtype) / W, indexing="ij",
        )
        pos = jnp.broadcast_to(
            jnp.stack([ph, pw], axis=-1), (*lead, H, W, 2)
        )
        images = jnp.concatenate([images, pos], axis=-1)

    kh, kw = jax.random.split(key)
    lead_shape = tuple(lead) + (num_crops,)
    tops = jax.random.randint(kh, lead_shape, 0, H - crop_height)
    lefts = jax.random.randint(kw, lead_shape, 0, W - crop_width)
    crop_inds = jnp.stack([tops, lefts], axis=-1)  # (..., N, 2)
    crops = crop_image_from_indices(images, crop_inds, crop_height, crop_width)
    return crops, crop_inds


class CropRandomizer(nn.Module):
    """``forward_in`` / ``forward_out`` pair around an encoder
    (`crop_randomizer.py:13-147`). ``input_shape`` is (H, W, C) here (NHWC)
    vs the reference's (C, H, W)."""

    input_shape: Sequence[int]
    crop_height: int
    crop_width: int
    num_crops: int = 1
    pos_enc: bool = False

    def output_shape_in(self, input_shape: Optional[Sequence[int]] = None):
        out_c = self.input_shape[-1] + 2 if self.pos_enc else self.input_shape[-1]
        return [self.crop_height, self.crop_width, out_c]

    def output_shape_out(self, input_shape: Sequence[int]):
        return list(input_shape)

    def forward_in(self, inputs: jax.Array, train: bool = False) -> jax.Array:
        """(B, H, W, C) -> (B*N, CH, CW, C[+2]); random crops at train,
        expanded center crop at eval."""
        B, H, W, C = inputs.shape
        if train:
            crops, _ = sample_random_image_crops(
                self.make_rng("dropout"), inputs,
                self.crop_height, self.crop_width, self.num_crops,
                pos_enc=self.pos_enc,
            )
            return crops.reshape((B * self.num_crops,) + crops.shape[2:])
        top = (H - self.crop_height) // 2
        left = (W - self.crop_width) // 2
        out = inputs[:, top:top + self.crop_height,
                     left:left + self.crop_width, :]
        if self.pos_enc:
            ph, pw = jnp.meshgrid(
                (jnp.arange(self.crop_height, dtype=inputs.dtype) + top) / H,
                (jnp.arange(self.crop_width, dtype=inputs.dtype) + left) / W,
                indexing="ij",
            )
            pos = jnp.broadcast_to(
                jnp.stack([ph, pw], axis=-1),
                (B, self.crop_height, self.crop_width, 2),
            )
            out = jnp.concatenate([out, pos], axis=-1)
        if self.num_crops > 1:
            out = jnp.repeat(out, self.num_crops, axis=0)
        return out

    def forward_out(self, inputs: jax.Array) -> jax.Array:
        """(B*N, ...) -> (B, ...) by averaging the N crop features."""
        if self.num_crops <= 1:
            return inputs
        b = inputs.shape[0] // self.num_crops
        return jnp.mean(
            inputs.reshape((b, self.num_crops) + inputs.shape[1:]), axis=1
        )

    def __call__(self, inputs: jax.Array, train: bool = False) -> jax.Array:
        return self.forward_in(inputs, train=train)

"""MultiViT / MultiMAE multi-modal image encoder, NHWC.

The reference vendors the full EPFL MultiMAE implementation (~2,600 LoC,
`src/models/components/img_encoder/multivit.py`); the training call-sites use
only the *encoder* path: per-modality patch adapters (RGB + depth) -> shared
transformer -> the last global token as the image feature
(`multivit.py:2336-2420,2537-2597`). This module implements exactly that
surface, batch-first JAX:

- ``PatchedInputAdapter``-equivalent: per-modality patch conv + fixed 2D
  sincos position embedding
- shared pre-norm ViT trunk (reuses ``vit._Block``), ``num_global_tokens``
  learned globals appended after the modality tokens
- ``MultiViTModel``: 4-channel RGB-D input split into modalities, ImageNet
  RGB normalization + truncated (10-90%) depth standardization
  (`multivit.py:2576-2585`), resize-256 -> center-crop-224, returns the
  global token ``(B, 768)``
- ``load_torch_multimae_state_dict`` ports the EPFL checkpoint (semseg and
  output-adapter weights dropped, as the reference does)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.img_encoder.vit import (
    _Block,
    get_2d_sincos_pos_embed,
)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def truncated_depth_standardize(depth: jax.Array) -> jax.Array:
    """Standardize depth by the 10-90% truncated mean/var
    (`multivit.py:2576-2585`). Sorting replaces torch's flatten+sort."""
    flat = jnp.sort(depth.reshape(depth.shape[0], -1), axis=-1)
    n = flat.shape[-1]
    trunc = flat[:, int(0.1 * n): int(0.9 * n)]
    mean = jnp.mean(trunc, axis=-1)[:, None, None, None]
    var = jnp.var(trunc, axis=-1)[:, None, None, None]
    return (depth - mean) / jnp.sqrt(var + 1e-6)


class PatchedInputAdapter(nn.Module):
    """Patch-project one modality to tokens + sincos pos emb."""

    in_channels: int
    patch_size: int = 16
    dim_tokens: int = 768

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        B = x.shape[0]
        x = nn.Conv(
            self.dim_tokens, (self.patch_size, self.patch_size),
            strides=(self.patch_size, self.patch_size), padding="VALID",
            name="proj",
        )(x)
        h, w = x.shape[1], x.shape[2]
        tokens = x.reshape(B, h * w, self.dim_tokens)
        pos = get_2d_sincos_pos_embed(self.dim_tokens, h)[None]
        # cast the f32 sincos table: letting it promote would run the whole
        # MultiViT trunk in f32 under bf16-mixed (see tests/test_dtype_policy)
        return tokens + pos.astype(tokens.dtype)


class MultiViT(nn.Module):
    """Multi-modal ViT trunk (`multivit.py:2336-2420` encoder path)."""

    input_modalities: Dict[str, int] = None  # modality -> channels
    patch_size: int = 16
    dim_tokens: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_global_tokens: int = 1
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, inputs: Dict[str, jax.Array],
                 train: bool = False) -> jax.Array:
        modalities = self.input_modalities or {"rgb": 3, "depth": 1}
        token_groups = []
        B = next(iter(inputs.values())).shape[0]
        for name, channels in modalities.items():
            if name not in inputs:
                continue
            token_groups.append(PatchedInputAdapter(
                in_channels=channels, patch_size=self.patch_size,
                dim_tokens=self.dim_tokens, name=f"input_adapters_{name}",
            )(inputs[name]))
        tokens = jnp.concatenate(token_groups, axis=1)
        global_tokens = self.param(
            "global_tokens", nn.initializers.truncated_normal(0.02),
            (1, self.num_global_tokens, self.dim_tokens),
        )
        tokens = jnp.concatenate(
            [tokens, jnp.broadcast_to(
                global_tokens, (B, self.num_global_tokens, self.dim_tokens)
            ).astype(tokens.dtype)],
            axis=1,
        )
        for i in range(self.depth):
            tokens = _Block(self.dim_tokens, self.num_heads, self.mlp_ratio,
                            dtype=self.dtype, name=f"encoder_{i}")(
                tokens, deterministic=not train
            )
        return tokens  # (B, n_tokens + n_global, D)


class MultiViTModel(nn.Module):
    """4-channel RGB-D encoder returning the global token
    (`multivit.py:2537-2597`)."""

    ckpt_path: Optional[str] = None
    img_size: int = 224
    dim_tokens: int = 768
    depth: int = 12
    num_heads: int = 12
    dtype: Optional[Any] = None
    # accepted-and-ignored for config parity: the reference wrapper takes
    # **kwargs (`multivit.py:2598-2607`) and the RLBench DP config passes
    # `type: MultiViT` through it
    type: Optional[str] = None

    @property
    def num_channels(self) -> int:
        return self.dim_tokens

    def _preprocess(self, x: jax.Array) -> jax.Array:
        if x.shape[-3] != self.img_size or x.shape[-2] != self.img_size:
            short = 256 * self.img_size // 224
            x = jax.image.resize(
                x, x.shape[:-3] + (short, short, x.shape[-1]), method="bicubic"
            )
            top = (short - self.img_size) // 2
            x = x[..., top:top + self.img_size, top:top + self.img_size, :]
        return x

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        assert x.shape[-1] == 4, f"expected RGBD (..., 4), got {x.shape}"
        x = self._preprocess(x)
        rgb = (x[..., :3] - jnp.asarray(_IMAGENET_MEAN, x.dtype)) \
            / jnp.asarray(_IMAGENET_STD, x.dtype)
        depth = truncated_depth_standardize(x[..., 3:])
        tokens = MultiViT(
            input_modalities={"rgb": 3, "depth": 1},
            dim_tokens=self.dim_tokens, depth=self.depth,
            num_heads=self.num_heads, dtype=self.dtype, name="model",
        )({"rgb": rgb, "depth": depth}, train=train)
        return tokens[:, -1]  # global token


class MultiMAEModel(MultiViTModel):
    """Reference `MultiMAEModel` call-site parity (`multivit.py:2598-2654`):
    the encoder path of the MAE-pretrained model; pretraining decoders are
    out of scope (never exercised by the training configs)."""

    pass


def load_torch_multimae_state_dict(params: dict, state_dict: dict) -> dict:
    """Port the EPFL MultiMAE checkpoint onto ``MultiViTModel.init`` params.
    Drops semseg/output-adapter weights like the reference loader."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()
          if "semseg" not in k and "output_adapters" not in k}
    params = jax.tree.map(np.asarray, params)
    model = params["model"]
    model["global_tokens"] = sd["global_tokens"]
    for mod in ("rgb", "depth"):
        adapter = model[f"input_adapters_{mod}"]
        w = sd[f"input_adapters.{mod}.proj.weight"]  # OIHW
        adapter["proj"]["kernel"] = np.transpose(w, (2, 3, 1, 0))
        adapter["proj"]["bias"] = sd[f"input_adapters.{mod}.proj.bias"]
    i = 0
    while f"encoder_{i}" in model:
        blk = model[f"encoder_{i}"]
        tp = f"encoder.{i}"
        for ln in ("norm1", "norm2"):
            blk[ln]["scale"] = sd[f"{tp}.{ln}.weight"]
            blk[ln]["bias"] = sd[f"{tp}.{ln}.bias"]
        D = blk["norm1"]["scale"].shape[0]
        heads = blk["attn"]["query"]["kernel"].shape[1]
        head_dim = D // heads
        qkv_w = sd[f"{tp}.attn.qkv.weight"]
        qkv_b = sd.get(f"{tp}.attn.qkv.bias", np.zeros(3 * D, np.float32))
        for j, proj in enumerate(("query", "key", "value")):
            blk["attn"][proj]["kernel"] = (
                qkv_w[j * D:(j + 1) * D].T.reshape(D, heads, head_dim)
            )
            blk["attn"][proj]["bias"] = (
                qkv_b[j * D:(j + 1) * D].reshape(heads, head_dim)
            )
        blk["attn"]["out"]["kernel"] = (
            sd[f"{tp}.attn.proj.weight"].T.reshape(heads, head_dim, D)
        )
        blk["attn"]["out"]["bias"] = sd[f"{tp}.attn.proj.bias"]
        blk["mlp_fc1"]["kernel"] = sd[f"{tp}.mlp.fc1.weight"].T
        blk["mlp_fc1"]["bias"] = sd[f"{tp}.mlp.fc1.bias"]
        blk["mlp_fc2"]["kernel"] = sd[f"{tp}.mlp.fc2.weight"].T
        blk["mlp_fc2"]["bias"] = sd[f"{tp}.mlp.fc2.bias"]
        i += 1
    return params

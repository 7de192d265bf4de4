"""ViT image encoders, NHWC.

Reference `src/models/components/img_encoder/vit.py:96-975` (a vendored timm
VisionTransformer + MAE variant). Parity surface:

- ``VisionTransformer`` with three feature modes (`vit.py:158-175`):
  ``use_cls_token`` -> (B, D) CLS output; ``global_pool`` -> (B, D) mean of
  patch tokens through ``fc_norm``; ``reshape_embedding`` -> (B, h, w, D)
  spatial map (normed, CLS dropped)
- optional MAE-style random masking of patch tokens (`vit.py:130-157`)
- patch-embed channel inflation for 1/4/6-channel inputs with zero-init
  extra channels (1-channel: zero kernel, quirk preserved, `vit.py:793-806`)
- ``ViT`` wrapper: resize-256 -> center-crop-224 -> per-channel normalize
  (`vit.py:768-776`); ``MAEViT`` adds masking; ``VC1ViT`` loads VC-1 weights
  from a local checkpoint (zero-egress: no downloads) via
  ``load_torch_vit_state_dict``.

Attention/MLP blocks are pre-norm timm style; param names mirror timm keys
one-to-one so torch checkpoints port mechanically.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

_NORM_STATS = {
    1: ([0.5], [0.5]),
    3: ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    4: ([0.485, 0.456, 0.406, 0.5], [0.229, 0.224, 0.225, 0.5]),
    6: ([0.485, 0.456, 0.406, 0.5, 0.5, 0.5],
        [0.229, 0.224, 0.225, 0.5, 0.5, 0.5]),
}

_ARCHS = {
    "vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16": dict(embed_dim=1024, depth=24, num_heads=16),
    "mae_vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12),
    "mae_vit_large_patch16": dict(embed_dim=1024, depth=24, num_heads=16),
}


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """(grid^2 [+1], D) fixed sincos table (`vit.py:198-250`)."""
    def embed_1d(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (embed_dim // 4))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_w, grid_h = np.meshgrid(
        np.arange(grid_size, dtype=np.float32),
        np.arange(grid_size, dtype=np.float32),
    )
    emb = np.concatenate([embed_1d(grid_h), embed_1d(grid_w)], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


class _Block(nn.Module):
    embed_dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x, deterministic=True):
        y = nn.LayerNorm(name="norm1")(x)
        y = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=self.embed_dim,
            out_features=self.embed_dim, name="attn", dtype=self.dtype,
        )(y, y, y, deterministic=deterministic)
        x = x + y
        y = nn.LayerNorm(name="norm2")(x)
        y = nn.Dense(int(self.embed_dim * self.mlp_ratio), name="mlp_fc1",
                     dtype=self.dtype)(y)
        y = jax.nn.gelu(y, approximate=False)
        y = nn.Dense(self.embed_dim, name="mlp_fc2", dtype=self.dtype)(y)
        return x + y


class VisionTransformer(nn.Module):
    """(B, H, W, C) -> feature per ``classifier_feature`` mode."""

    img_size: int = 224
    patch_size: int = 16
    channels: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    classifier_feature: str = "use_cls_token"
    mask_ratio: Optional[float] = None
    dtype: Optional[Any] = None

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    def random_masking(self, x, mask_ratio, rng):
        """Keep a random (1-ratio) subset of tokens (`vit.py:130-157`)."""
        N, L, D = x.shape
        len_keep = int(L * (1 - mask_ratio))
        noise = jax.random.uniform(rng, (N, L))
        ids_shuffle = jnp.argsort(noise, axis=1)
        ids_keep = ids_shuffle[:, :len_keep]
        return jnp.take_along_axis(x, ids_keep[..., None], axis=1)

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        B = x.shape[0]
        x = nn.Conv(
            self.embed_dim, (self.patch_size, self.patch_size),
            strides=(self.patch_size, self.patch_size),
            padding="VALID", name="patch_embed_proj", dtype=self.dtype,
        )(x)
        h, w = x.shape[1], x.shape[2]
        x = x.reshape(B, h * w, self.embed_dim)

        pos_embed = self.param(
            "pos_embed",
            lambda key: jnp.asarray(
                get_2d_sincos_pos_embed(self.embed_dim, self.grid_size,
                                        cls_token=True)[None]
            ),
            # timm keeps a learned table; sincos init matches MAE/VC-1
        )
        cls_token = self.param(
            "cls_token", nn.initializers.truncated_normal(0.02),
            (1, 1, self.embed_dim),
        )
        x = x + pos_embed[:, 1:, :]
        if self.mask_ratio is not None and train:
            x = self.random_masking(x, self.mask_ratio, self.make_rng("mask"))
        cls = jnp.broadcast_to(
            cls_token + pos_embed[:, :1, :], (B, 1, self.embed_dim)
        ).astype(x.dtype)
        x = jnp.concatenate([cls, x], axis=1)

        for i in range(self.depth):
            x = _Block(self.embed_dim, self.num_heads, self.mlp_ratio,
                       dtype=self.dtype, name=f"blocks_{i}")(
                x, deterministic=not train
            )

        if self.classifier_feature == "global_pool":
            out = jnp.mean(x[:, 1:, :], axis=1)
            return nn.LayerNorm(name="fc_norm")(out)
        if self.classifier_feature == "use_cls_token":
            x = nn.LayerNorm(name="norm")(x)
            return x[:, 0]
        if self.classifier_feature == "reshape_embedding":
            x = nn.LayerNorm(name="norm")(x)
            tokens = x[:, 1:, :]
            g = int(round(tokens.shape[1] ** 0.5))
            return tokens.reshape(B, g, g, self.embed_dim)
        raise NotImplementedError(self.classifier_feature)


class ViT(nn.Module):
    """Wrapper with the reference's preprocessing (`vit.py:731-810`)."""

    model_name: str = "vit_base_patch16"
    channels: int = 3
    pretrained_path: Optional[str] = None
    feature_mode: str = "use_cls_token"
    mask_ratio: Optional[float] = None
    img_size: int = 224
    dtype: Optional[Any] = None

    @property
    def num_channels(self) -> int:
        return _ARCHS[self.model_name]["embed_dim"]

    def _preprocess(self, x: jax.Array) -> jax.Array:
        # Resize(256, bicubic) + CenterCrop(224) on square inputs reduces to a
        # bicubic resize then crop; per-channel normalization as configured.
        short = 256 * self.img_size // 224
        if x.shape[-3] != self.img_size or x.shape[-2] != self.img_size:
            x = jax.image.resize(
                x, x.shape[:-3] + (short, short, x.shape[-1]), method="bicubic"
            )
            top = (short - self.img_size) // 2
            x = x[..., top:top + self.img_size, top:top + self.img_size, :]
        mean, std = _NORM_STATS[self.channels]
        return (x - jnp.asarray(mean, x.dtype)) / jnp.asarray(std, x.dtype)

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        arch = _ARCHS[self.model_name]
        x = self._preprocess(x)
        return VisionTransformer(
            img_size=self.img_size, channels=self.channels,
            classifier_feature=self.feature_mode,
            mask_ratio=self.mask_ratio, dtype=self.dtype, name="model",
            **arch,
        )(x, train=train)


class MAEViT(ViT):
    """MAE-masked variant (`vit.py:814-908`); masking active in training."""

    model_name: str = "mae_vit_base_patch16"
    mask_ratio: Optional[float] = 0.75


class VC1ViT(ViT):
    """VC-1 weights variant (`vit.py:912-960`); supply ``pretrained_path`` to
    a local ``vc1_vitb.pth``/``vc1_vitl.pth`` and port via
    ``load_torch_vit_state_dict`` (downloads are out of scope here)."""

    pass


# ---------------------------------------------------------------------------
# torch (timm/VC-1) state-dict porting
# ---------------------------------------------------------------------------

def _inflate_patch_embed(w_oihw: np.ndarray, channels: int) -> np.ndarray:
    """Reference channel-inflation (`vit.py:777-806`): extra channels zero;
    1-channel input gets a zero kernel (quirk preserved)."""
    O, _, H, W = w_oihw.shape
    out = np.zeros((O, channels, H, W), w_oihw.dtype)
    if channels != 1:
        out[:, :3] = w_oihw[:, :3]
    return out


def load_torch_vit_state_dict(params: dict, state_dict: dict,
                              channels: int = 3) -> dict:
    """Map a timm/MAE/VC-1 ViT state dict onto ``ViT.init`` params."""
    sd = {k.replace("module.", ""): np.asarray(v)
          for k, v in state_dict.items()
          if "decoder" not in k and "mask_token" not in k}
    params = jax.tree.map(np.asarray, params)
    model = params["model"]

    pe = sd["patch_embed.proj.weight"]
    if pe.shape[1] != channels:
        pe = _inflate_patch_embed(pe, channels)
    model["patch_embed_proj"]["kernel"] = np.transpose(pe, (2, 3, 1, 0))
    model["patch_embed_proj"]["bias"] = sd["patch_embed.proj.bias"]
    model["pos_embed"] = sd["pos_embed"]
    model["cls_token"] = sd["cls_token"]
    for name in ("norm", "fc_norm"):
        if name in model and f"{name}.weight" in sd:
            model[name]["scale"] = sd[f"{name}.weight"]
            model[name]["bias"] = sd[f"{name}.bias"]

    i = 0
    while f"blocks_{i}" in model:
        blk = model[f"blocks_{i}"]
        tp = f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            blk[ln]["scale"] = sd[f"{tp}.{ln}.weight"]
            blk[ln]["bias"] = sd[f"{tp}.{ln}.bias"]
        D = blk["norm1"]["scale"].shape[0]
        qkv_w = sd[f"{tp}.attn.qkv.weight"]  # (3D, D)
        qkv_b = sd[f"{tp}.attn.qkv.bias"]
        heads = blk["attn"]["query"]["kernel"].shape[1]
        head_dim = D // heads
        for j, proj in enumerate(("query", "key", "value")):
            w = qkv_w[j * D:(j + 1) * D].T.reshape(D, heads, head_dim)
            b = qkv_b[j * D:(j + 1) * D].reshape(heads, head_dim)
            blk["attn"][proj]["kernel"] = w
            blk["attn"][proj]["bias"] = b
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

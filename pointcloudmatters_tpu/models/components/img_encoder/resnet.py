"""ResNet image encoders, NHWC.

Re-implements the torchvision-backed encoders of reference
`src/models/components/img_encoder/resnet.py:47-199` in JAX:

- torchvision ResNet-18/34/50 topology (v1.5 "stride-on-3x3" bottleneck)
  in NHWC, XLA's conv layout
- first-conv channel inflation for depth(1)/RGBD(4)/pointmap(6) inputs: RGB
  kernels copied, extra channels zero-initialized (`resnet.py:62-86`)
- forward preprocessing: resize to 224 + per-channel ImageNet normalization
  (`resnet.py:96-125`); input is float RGB in [0,1] (+ raw depth/coords)
- ``num_channels`` property and ``(B, h, w, C)`` spatial output (or pooled
  ``(B, C)`` with ``avg_pool``) feeding ACT's 1x1 projection
- ``load_torch_state_dict`` ports a torchvision/R3M state dict (R3M weights
  are the same graph, `resnet.py:143-199`); downloads are out of scope in
  this environment — pass a local ``pretrained_path``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.nn_utils import MaskedBatchNorm
from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

_NORM_STATS = {
    1: ([0.5], [0.5]),
    3: ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    4: ([0.485, 0.456, 0.406, 0.5], [0.229, 0.224, 0.225, 0.5]),
    6: ([0.485, 0.456, 0.406, 0.5, 0.5, 0.5],
        [0.229, 0.224, 0.225, 0.5, 0.5, 0.5]),
}

_STAGES = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}


def _conv(features, kernel, stride=1, name=None):
    return nn.Conv(
        features, (kernel, kernel), strides=(stride, stride),
        padding=[(kernel // 2, kernel // 2)] * 2, use_bias=False, name=name,
    )


class BasicBlock(nn.Module):
    features: int
    stride: int = 1
    downsample: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        identity = x
        out = _conv(self.features, 3, self.stride, name="conv1")(x)
        out = MaskedBatchNorm(name="bn1")(out, use_running_average=not train)
        out = jax.nn.relu(out)
        out = _conv(self.features, 3, 1, name="conv2")(out)
        out = MaskedBatchNorm(name="bn2")(out, use_running_average=not train)
        if self.downsample:
            identity = _conv(self.features, 1, self.stride, name="downsample_conv")(x)
            identity = MaskedBatchNorm(name="downsample_bn")(
                identity, use_running_average=not train
            )
        return jax.nn.relu(out + identity)


class Bottleneck(nn.Module):
    features: int  # bottleneck width; output = 4x
    stride: int = 1
    downsample: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        identity = x
        out = _conv(self.features, 1, 1, name="conv1")(x)
        out = MaskedBatchNorm(name="bn1")(out, use_running_average=not train)
        out = jax.nn.relu(out)
        out = _conv(self.features, 3, self.stride, name="conv2")(out)
        out = MaskedBatchNorm(name="bn2")(out, use_running_average=not train)
        out = jax.nn.relu(out)
        out = _conv(self.features * 4, 1, 1, name="conv3")(out)
        out = MaskedBatchNorm(name="bn3")(out, use_running_average=not train)
        if self.downsample:
            identity = _conv(self.features * 4, 1, self.stride,
                             name="downsample_conv")(x)
            identity = MaskedBatchNorm(name="downsample_bn")(
                identity, use_running_average=not train
            )
        return jax.nn.relu(out + identity)


class ResNetTorchVision(nn.Module):
    """Encoder protocol: ``module(images_nhwc, train=...) -> (B,h,w,C)``."""

    resnet_model: str = "resnet50"
    pretrained: bool = False
    pretrained_path: Optional[str] = None
    channels: int = 3
    avg_pool: bool = False
    resize_to: int = 224

    @property
    def num_channels(self) -> int:
        block, _ = _STAGES[self.resnet_model]
        return 512 if block == "basic" else 2048

    def _preprocess(self, x: jax.Array) -> jax.Array:
        H, W = x.shape[-3], x.shape[-2]
        if H != self.resize_to or W != self.resize_to:
            x = jax.image.resize(
                x, x.shape[:-3] + (self.resize_to, self.resize_to, x.shape[-1]),
                method="bilinear",
            )
        mean, std = _NORM_STATS[self.channels]
        mean = jnp.asarray(mean, x.dtype)
        std = jnp.asarray(std, x.dtype)
        return (x - mean) / std

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        if self.resnet_model not in _STAGES:
            raise NotImplementedError(self.resnet_model)
        block_kind, stage_sizes = _STAGES[self.resnet_model]
        Block = BasicBlock if block_kind == "basic" else Bottleneck
        x = self._preprocess(x)

        x = nn.Conv(64, (7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)],
                    use_bias=False, name="conv1")(x)
        x = MaskedBatchNorm(name="bn1")(x, use_running_average=not train)
        x = jax.nn.relu(x)
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])

        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * (2 ** stage)
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                down = b == 0 and (
                    stride != 1 or stage == 0 and block_kind == "bottleneck"
                )
                x = Block(features, stride=stride, downsample=down,
                          name=f"layer{stage + 1}_{b}")(x, train=train)

        if self.avg_pool:
            return jnp.mean(x, axis=(-3, -2))  # (B, C)
        return x  # (B, h, w, C)


# ---------------------------------------------------------------------------
# torch state-dict porting
# ---------------------------------------------------------------------------

def _port_conv(w: np.ndarray) -> np.ndarray:
    # torch OIHW -> HWIO (shared layout contract)
    from pointcloudmatters_tpu.utils.torch_layouts import conv2d_kernel

    return conv2d_kernel(w)


def _inflate_conv1(w_oihw: np.ndarray, channels: int) -> np.ndarray:
    """Replicate the reference's channel-inflation scheme
    (`resnet.py:62-86`): RGB kernels copied, extra channels zeroed; 1-channel
    depth gets a zero kernel (quirk preserved: the reference zeroes the only
    channel, `resnet.py:79-84`)."""
    O, _, H, W = w_oihw.shape
    out = np.zeros((O, channels, H, W), w_oihw.dtype)
    if channels == 1:
        pass  # reference zeroes it
    else:
        out[:, :3] = w_oihw[:, :3]
    return out


def load_torch_state_dict(params: dict, batch_stats: dict, state_dict: dict,
                          channels: int = 3) -> tuple[dict, dict]:
    """Map a torchvision/R3M ResNet state dict onto our param/batch-stats
    trees produced by ``ResNetTorchVision.init``. R3M dicts prefix keys with
    ``convnet.`` / ``module.convnet.`` — stripped here."""
    sd = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "").replace("convnet.", "").replace("resnet.", "")
        sd[k] = np.asarray(v)

    params = jax.tree.map(np.asarray, params)
    batch_stats = jax.tree.map(np.asarray, batch_stats)

    def put_bn(bn_params, bn_stats, torch_prefix):
        bn_params["scale"] = sd[f"{torch_prefix}.weight"]
        bn_params["bias"] = sd[f"{torch_prefix}.bias"]
        bn_stats["mean"] = sd[f"{torch_prefix}.running_mean"]
        bn_stats["var"] = sd[f"{torch_prefix}.running_var"]

    conv1 = sd["conv1.weight"]
    if conv1.shape[1] != channels:
        conv1 = _inflate_conv1(conv1, channels)
    params["conv1"]["kernel"] = _port_conv(conv1)
    put_bn(params["bn1"], batch_stats["bn1"], "bn1")

    for name in list(params.keys()):
        if not name.startswith("layer") or "_" not in name:
            continue
        stage, b = name.replace("layer", "").split("_")
        tp = f"layer{stage}.{b}"
        block_p, block_s = params[name], batch_stats[name]
        for i in (1, 2, 3):
            cname = f"conv{i}"
            if cname in block_p:
                block_p[cname]["kernel"] = _port_conv(sd[f"{tp}.conv{i}.weight"])
                put_bn(block_p[f"bn{i}"], block_s[f"bn{i}"], f"{tp}.bn{i}")
        if "downsample_conv" in block_p:
            block_p["downsample_conv"]["kernel"] = _port_conv(
                sd[f"{tp}.downsample.0.weight"]
            )
            put_bn(block_p["downsample_bn"], block_s["downsample_bn"],
                   f"{tp}.downsample.1")
    return params, batch_stats


class R3MResNet(ResNetTorchVision):
    """R3M-pretrained variant (`resnet.py:143-199`). Weight files must be
    provided locally via ``pretrained_path`` (zero-egress environment);
    loading happens through ``load_torch_state_dict``."""

    pass

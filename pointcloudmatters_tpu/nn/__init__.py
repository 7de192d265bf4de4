"""The model stack's module system and layers (see ``nn.module``)."""

from pointcloudmatters_tpu.nn.layers import (
    Conv,
    ConvTranspose,
    Dense,
    DenseGeneral,
    Dropout,
    Embed,
    GroupNorm,
    LayerNorm,
    MultiHeadDotProductAttention,
    initializers,
    max_pool,
)
from pointcloudmatters_tpu.nn.module import (
    Module,
    compact,
    merge_param,
    while_loop,
)

__all__ = [
    "Conv", "ConvTranspose", "Dense", "DenseGeneral", "Dropout", "Embed",
    "GroupNorm", "LayerNorm", "Module", "MultiHeadDotProductAttention",
    "compact", "initializers",
    "max_pool", "merge_param", "while_loop",
]

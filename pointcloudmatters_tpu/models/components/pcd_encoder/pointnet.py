"""PointNet encoder — padded-native per-point MLP.

The reference builds this from five ``spconv.SubMConv3d`` layers with
``kernel_size=1`` (`src/models/components/pcd_encoder/pointnet.py:31-62`).
A 1x1 submanifold sparse conv is exactly a per-point linear map — no
neighborhood structure — so the padded formulation is a dense masked MLP
over the padded ``(B, N, C)`` cloud: pure batched matmuls, no
sparse machinery at all. Channel widths (64, 64, 64, 128, 512), bias-free
linears, BatchNorm(eps=1e-3, momentum=0.01) + ReLU match the reference;
the batch-norm statistics are computed over valid points only (the packed
layout has no padding, so this is the faithful masked equivalent).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.nn_utils import MaskedBatchNorm


class PointNet(nn.Module):
    """Per-point feature extractor.

    Call with a padded pcd dict: ``feat (B, N, C_in)``, ``valid (B, N)``.
    Returns per-point features ``(B, N, 512)`` (or ``num_classes``).
    ``grid_coord`` is accepted and ignored — kernel-size-1 convs never read
    geometry (reference `pointnet.py:64-85` builds a SparseConvTensor only to
    run pointwise ops on it).
    """

    in_channels: int
    num_classes: int = 0
    axis_name: Optional[str] = None
    dtype: Optional[Any] = None
    # accepted-and-ignored for config parity: the reference PointNet takes
    # **kwargs (`pointnet.py:17-22`) and several DP configs pass a (null)
    # pretrained_path through to it
    pretrained_path: Optional[str] = None

    @property
    def num_channels(self) -> int:
        return self.num_classes if self.num_classes > 0 else 512

    @nn.compact
    def __call__(self, input_dict: dict, train: bool = False) -> jax.Array:
        x = input_dict["feat"]
        mask = input_dict.get("valid")
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected feat[...,-1] == {self.in_channels}, got {x.shape[-1]}"
            )
        for i, width in enumerate((64, 64, 64, 128, 512)):
            x = nn.Dense(width, use_bias=False, dtype=self.dtype, name=f"conv{i + 1}")(x)
            x = MaskedBatchNorm(
                momentum=0.01, eps=1e-3, axis_name=self.axis_name,
                dtype=self.dtype, name=f"bn{i + 1}",
            )(x, mask=mask, use_running_average=not train)
            x = jax.nn.relu(x)
        if self.num_classes > 0:
            x = nn.Dense(self.num_classes, dtype=self.dtype, name="final")(x)
        return x

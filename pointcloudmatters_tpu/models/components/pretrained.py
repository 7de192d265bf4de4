"""Pretrained-weight wiring.

The reference encoders load their checkpoints inside ``__init__`` (R3M via
gdown, VC-1/MultiMAE via URL download, PonderV2 via local path —
`img_encoder/resnet.py:143-199`, `vit.py:814-960`, `multivit.py:2537-2597`,
`pcd_encoder/spunet.py:399-409`). Params exist only after ``init``, so
the task module calls :func:`load_pretrained_into` right after policy init:
it walks the policy's submodule tree, finds encoder modules with a
``pretrained_path``, loads the torch state dict from the *local* file
(zero-egress: no downloads), and ports it with the per-family mapping
functions.
"""

from __future__ import annotations

import os
from typing import Any

import jax
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


def _load_torch_file(path: str) -> dict:
    import torch

    state = torch.load(os.path.expanduser(path), map_location="cpu",
                       weights_only=False)
    for key in ("state_dict", "model", "r3m"):
        if isinstance(state, dict) and key in state and isinstance(state[key], dict):
            return state[key]
    return state


def _port(module: nn.Module, params: dict, batch_stats: dict, sd: dict):
    name = type(module).__name__
    if name in ("ResNetTorchVision", "R3MResNet"):
        from pointcloudmatters_tpu.models.components.img_encoder.resnet import (
            load_torch_state_dict,
        )

        return load_torch_state_dict(params, batch_stats, sd,
                                     channels=module.channels)
    if name in ("ViT", "MAEViT", "VC1ViT"):
        from pointcloudmatters_tpu.models.components.img_encoder.vit import (
            load_torch_vit_state_dict,
        )

        return load_torch_vit_state_dict(params, sd,
                                         channels=module.channels), batch_stats
    if name in ("MultiViTModel", "MultiMAEModel"):
        from pointcloudmatters_tpu.models.components.img_encoder.multivit import (
            load_torch_multimae_state_dict,
        )

        return load_torch_multimae_state_dict(params, sd), batch_stats
    if name == "SpUNet":
        from pointcloudmatters_tpu.models.components.pcd_encoder.spunet import (
            load_ponderv2_weights,
        )

        return load_ponderv2_weights(params, batch_stats, sd,
                                     conditions=module.conditions)
    raise NotImplementedError(f"no pretrained porting for {name}")


def _walk(module: Any, params: dict, batch_stats: dict) -> None:
    """Recurse over submodule fields, porting any with a pretrained_path."""
    if not isinstance(module, nn.Module):
        return
    for field_name in getattr(module, "__dataclass_fields__", {}):
        sub = getattr(module, field_name, None)
        if not isinstance(sub, nn.Module):
            continue
        path = getattr(sub, "pretrained_path", None)
        if path and field_name in params:
            if not os.path.exists(os.path.expanduser(str(path))):
                log.warning(
                    f"pretrained_path {path} for {type(sub).__name__} not "
                    "found; keeping random init"
                )
            else:
                log.info(f"loading pretrained {type(sub).__name__} <- {path}")
                sd = _load_torch_file(str(path))
                new_p, new_s = _port(
                    sub, params[field_name], batch_stats.get(field_name, {}), sd
                )
                params[field_name] = new_p
                if field_name in batch_stats:
                    batch_stats[field_name] = new_s
        if field_name in params and isinstance(params.get(field_name), dict):
            _walk(sub, params[field_name], batch_stats.get(field_name, {}))


def load_pretrained_into(policy: nn.Module, variables: dict) -> dict:
    """Returns variables with any configured pretrained encoder weights
    ported in; a no-op when nothing declares a pretrained_path."""
    params = jax.tree.map(lambda x: x, dict(variables["params"]))
    batch_stats = jax.tree.map(
        lambda x: x, dict(variables.get("batch_stats", {}))
    )
    _walk(policy, params, batch_stats)
    out = dict(variables)
    out["params"] = params
    if "batch_stats" in variables:
        out["batch_stats"] = batch_stats
    return out

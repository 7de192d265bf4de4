"""Losses for the policy heads.

Equivalents of reference `src/models/components/loss/misc.py:6-26`
plus the elementwise action losses the configs wire in as
``torch.nn.{MSELoss,L1Loss}(reduction=none)``
(`configs/model/maniskill2_act_pcd_model.yaml:56-58`).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


class KLDivergence:
    """Unit-gaussian KL for the CVAE latent (`loss/misc.py:6-26`).

    Returns the *total* KLD: sum over latent dims, mean over batch.
    """

    def __call__(self, mu, logvar):
        if mu is None:
            return jnp.asarray(0.0)
        klds = -0.5 * (1 + logvar - mu * mu - jnp.exp(logvar))
        return jnp.mean(jnp.sum(klds, axis=-1))


def mse_loss(pred: jax.Array, target: jax.Array) -> jax.Array:
    """Elementwise squared error (``reduction="none"``)."""
    diff = pred - target
    return diff * diff


def l1_loss(pred: jax.Array, target: jax.Array) -> jax.Array:
    """Elementwise absolute error (``reduction="none"``)."""
    return jnp.abs(pred - target)


_ACTION_LOSSES = {
    "mse": mse_loss,
    "l2": mse_loss,
    "MSELoss": mse_loss,
    "l1": l1_loss,
    "L1Loss": l1_loss,
}


def build_action_loss(spec) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """Resolve an action-loss spec: a callable, a name, or a config dict whose
    ``type``/``_target_`` tail names the loss (config-schema parity with the
    reference's ``_target_: torch.nn.MSELoss``)."""
    if callable(spec):
        return spec
    if spec is None:
        return mse_loss
    if isinstance(spec, str):
        name = spec
    else:  # mapping-like config
        name = spec.get("type", spec.get("_target_", "mse"))
    name = str(name).split(".")[-1]
    if name not in _ACTION_LOSSES:
        raise KeyError(f"unknown action loss {name!r}; options: {sorted(_ACTION_LOSSES)}")
    return _ACTION_LOSSES[name]


def masked_action_loss(
    loss_fn: Callable, a_hat: jax.Array, actions: jax.Array, is_pad: jax.Array
) -> jax.Array:
    """Zero padded chunk slots then mean over *all* elements — the reference
    divides by the full element count, not the valid count
    (`act/act.py:284-285`); preserved exactly."""
    per_elem = loss_fn(a_hat, actions)
    keep = (~is_pad)[..., None].astype(per_elem.dtype)
    return jnp.mean(per_elem * keep)

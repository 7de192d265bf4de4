"""SpUNet — PonderV2-style sparse 3D UNet, in JAX.

Reference `src/models/components/pcd_encoder/spunet.py:229,411-463` (itself
from PonderV2/Pointcept). Architecture parity: SPConvPatchEmbedding stem
(k=5), per-stage SPConvDown (k=2 s=2) + BasicBlock residual towers, inverse
SPConvUp with skip concat, PDBatchNorm (per-condition decoupled BN + optional
SiLU-Linear FiLM modulation from a condition embedding), channels
(32,64,128,256,256,128,96,96), layers (2,3,4,6,2,2,2,2), optional cls-mode
mean pooling (replacing `torch_geometric.utils.scatter`).

Static-shape machinery (`pointcloudmatters_tpu.ops.sparse`): voxel hash maps
are sorted-key binary searches built once per resolution level and reused by
every block at that level (spconv's indice_key caching); convs are stacked
gathers + matmuls; down/up are deterministic segment scatter/gather over
first-occurrence representative slots with a constant padded length.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn

from pointcloudmatters_tpu.models.components.nn_utils import MaskedBatchNorm
from pointcloudmatters_tpu.ops import sparse as S


class PDBatchNorm(nn.Module):
    """Per-condition decoupled BN + optional adaptive FiLM
    (`spunet.py:19-73`). ``condition`` is a static string chosen at config
    level, so only the selected BN branch is traced (the reference computes
    all branches and multiplies by 0/1 flags — XLA would DCE them anyway)."""

    context_channels: int = 256
    eps: float = 1e-3
    momentum: float = 0.01
    conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D")
    decouple: bool = True
    adaptive: bool = False
    affine: bool = True

    @nn.compact
    def __call__(self, feat, mask=None, condition: Optional[str] = None,
                 context=None, train: bool = False):
        if self.decouple:
            assert condition in self.conditions, (condition, self.conditions)
            index = list(self.conditions).index(condition)
            # every branch is materialized (and, like the reference, its
            # running stats update in train mode — `spunet.py:58-65` calls
            # bn(feat) for all conditions and masks by 0/1); only the selected
            # branch contributes to the output
            out = 0.0
            for i in range(len(self.conditions)):
                branch = MaskedBatchNorm(
                    momentum=self.momentum, eps=self.eps, name=f"bns_{i}"
                )(feat, mask=mask, use_running_average=not train)
                out = out + branch * (1.0 if i == index else 0.0)
            feat = out
        else:
            feat = MaskedBatchNorm(
                momentum=self.momentum, eps=self.eps, name="bn"
            )(feat, mask=mask, use_running_average=not train)
        if self.adaptive:
            assert context is not None
            mod = nn.Dense(2 * feat.shape[-1], name="modulation")(
                jax.nn.silu(context)
            )
            shift, scale = jnp.split(mod, 2, axis=-1)
            feat = feat * (1.0 + scale) + shift
        return feat


class _NormArgs:
    """Bundle of the PDBatchNorm constructor kwargs shared by all layers."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def make(self, name):
        return PDBatchNorm(name=name, **self.kwargs)


class SpUNet(nn.Module):
    in_channels: int
    num_classes: int = 0
    base_channels: int = 32
    context_channels: int = 256
    channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96)
    layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2)
    cls_mode: bool = False
    conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D")
    zero_init: bool = False
    norm_decouple: bool = True
    norm_adaptive: bool = True
    norm_affine: bool = True
    pretrained_path: Optional[str] = None
    dtype: Optional[Any] = None

    @property
    def num_stages(self) -> int:
        return len(self.layers) // 2

    @property
    def num_channels(self) -> int:
        if self.num_classes > 0:
            return self.num_classes
        return (self.channels[-1] if not self.cls_mode
                else self.channels[self.num_stages - 1])

    def _norm(self):
        return _NormArgs(
            context_channels=self.context_channels, conditions=self.conditions,
            decouple=self.norm_decouple, adaptive=self.norm_adaptive,
            affine=self.norm_affine,
        )

    def _conv_param(self, name, k, ci, co):
        init = nn.initializers.truncated_normal(0.02)
        return self.param(name, init, (k, ci, co), jnp.float32)

    # -- building blocks ----------------------------------------------------
    def _subm_block(self, scope, x, idx, mask, ci, co, condition, context,
                    train, k=27):
        """conv(k) + PDBN + relu."""
        w = self._conv_param(f"{scope}_weight", k, ci, co)
        x = S.submconv(x, w, idx)
        x = self._norm().make(f"{scope}_bn")(
            x, mask=mask, condition=condition, context=context, train=train
        )
        return jax.nn.relu(x)

    def _basic_block(self, scope, x, idx, mask, ci, co, condition, context,
                     train):
        """Residual BasicBlock (`spunet.py:77-146`)."""
        residual = x
        w1 = self._conv_param(f"{scope}_conv1", 27, ci, co)
        out = S.submconv(x, w1, idx)
        out = self._norm().make(f"{scope}_bn1")(
            out, mask=mask, condition=condition, context=context, train=train
        )
        out = jax.nn.relu(out)
        w2 = self._conv_param(f"{scope}_conv2", 27, co, co)
        out = S.submconv(out, w2, idx)
        out = self._norm().make(f"{scope}_bn2")(
            out, mask=mask, condition=condition, context=context, train=train
        )
        if ci != co:
            wp = self._conv_param(f"{scope}_proj", 1, ci, co)
            residual = jnp.einsum(
                "bnc,co->bno", residual, wp[0],
                preferred_element_type=jnp.float32,
            ).astype(out.dtype)
            residual = self._norm().make(f"{scope}_proj_bn")(
                residual, mask=mask, condition=condition, context=context,
                train=train,
            )
        return jax.nn.relu(out + residual)

    # -- forward ------------------------------------------------------------
    @nn.compact
    def __call__(self, input_dict: dict, train: bool = False) -> jax.Array:
        grid_coord = input_dict["grid_coord"].astype(jnp.int32)
        feat = input_dict["feat"]
        valid = input_dict["valid"].astype(bool)
        condition = input_dict.get("condition", self.conditions[0])
        if not isinstance(condition, str):
            condition = self.conditions[0]

        context = input_dict.get("context")
        if context is None and self.norm_adaptive:
            table = nn.Embed(len(self.conditions), self.context_channels,
                             name="embedding_table")
            context = table(
                jnp.asarray([list(self.conditions).index(condition)])
            )

        off27 = S.kernel_offsets(3)
        off125 = S.kernel_offsets(5)

        # stem: k=5 patch embedding (`spunet.py:205-224`)
        idx_stem = S.neighbor_indices(grid_coord, valid, off125)
        x = self._subm_block(
            "conv_input", feat, idx_stem, valid, self.in_channels,
            self.base_channels, condition, context, train, k=125,
        )

        # resolution-level state
        coords = [grid_coord]
        valids = [valid]
        idx27 = [S.neighbor_indices(grid_coord, valid, off27)]
        reps = []

        skips = [x]
        enc_channels = self.base_channels
        enc_widths = [self.base_channels]
        for s in range(self.num_stages):
            parent, rep, new_valid = S.voxel_downsample(coords[-1], valids[-1])
            # representative slots carry the parent coords; others are padding
            w_down = self._conv_param(
                f"down{s}_weight", 8, enc_channels, self.channels[s]
            )
            x = S.strided_downconv(x, w_down, coords[-1], rep, valids[-1])
            x = self._norm().make(f"down{s}_bn")(
                x, mask=new_valid, condition=condition, context=context,
                train=train,
            )
            x = jax.nn.relu(x)
            reps.append(rep)
            coords.append(jnp.where(new_valid[..., None], parent, 0))
            valids.append(new_valid)
            idx27.append(S.neighbor_indices(coords[-1], new_valid, off27))

            for i in range(self.layers[s]):
                ci = self.channels[s]
                x = self._basic_block(
                    f"enc{s}_block{i}", x, idx27[-1], valids[-1], ci,
                    self.channels[s], condition, context, train,
                )
            enc_channels = self.channels[s]
            enc_widths.append(enc_channels)
            skips.append(x)

        x = skips.pop(-1)
        if not self.cls_mode:
            # decode width at stage s: channels[-1-s]
            # (96, 96, 128, 256 for the default tower — `spunet.py:319-359`)
            dec_channels_list = [
                self.channels[len(self.channels) - 1 - s]
                for s in range(self.num_stages)
            ]
            for s in reversed(range(self.num_stages)):
                dec_c = dec_channels_list[s]
                # SPConvUp: inverse conv back to the pre-down point set
                w_up = self._conv_param(f"up{s}_weight", 8, x.shape[-1], dec_c)
                x = S.inverse_upconv(x, w_up, coords[s], reps[s], valids[s])
                x = self._norm().make(f"up{s}_bn")(
                    x, mask=valids[s], condition=condition, context=context,
                    train=train,
                )
                x = jax.nn.relu(x)
                skip = skips.pop(-1)
                x = jnp.concatenate([x, skip], axis=-1)
                n_blocks = self.layers[len(self.channels) - s - 1]
                for i in range(n_blocks):
                    ci = x.shape[-1] if i == 0 else dec_c
                    x = self._basic_block(
                        f"dec{s}_block{i}", x, idx27[s], valids[s], ci, dec_c,
                        condition, context, train,
                    )
            out_valid = valids[0]
        else:
            out_valid = valids[-1]

        if self.num_classes > 0:
            wf = self._conv_param(
                "final_weight", 1, x.shape[-1], self.num_classes
            )
            bf = self.param("final_bias", nn.initializers.zeros,
                            (self.num_classes,), jnp.float32)
            x = jnp.einsum(
                "bnc,co->bno", x, wf[0], preferred_element_type=jnp.float32
            ).astype(x.dtype) + bf

        if self.cls_mode:
            # masked mean over valid voxels (`spunet.py:458-461`)
            m = out_valid[..., None].astype(x.dtype)
            x = jnp.sum(x * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1), 1.0)
        return x


# ---------------------------------------------------------------------------
# PonderV2 checkpoint porting (`spunet.py:399-409`)
# ---------------------------------------------------------------------------

def _port_spconv_weight(w: np.ndarray, k: int) -> np.ndarray:
    """spconv v2 SubMConv3d weights are (out, kd, kh, kw, in); our planes are
    (k^3, in, out) in row-major (x, y, z) offset order — the same traversal
    spconv uses for its kernel positions."""
    out_c, in_c = w.shape[0], w.shape[-1]
    return np.transpose(w.reshape(out_c, k ** 3, in_c), (1, 2, 0))


def load_ponderv2_weights(params: dict, batch_stats: dict, state_dict: dict,
                          conditions=("ScanNet", "S3DIS", "Structured3D")):
    """Map a PonderV2 checkpoint (``module.backbone.*`` keys,
    `spunet.py:399-409`) onto ``SpUNet.init`` params/batch_stats trees."""
    sd = {}
    for key, value in state_dict.items():
        if key.startswith("module.backbone."):
            sd[key.replace("module.backbone.", "")] = np.asarray(value)
        elif key.startswith("module.embedding_table"):
            sd[key.replace("module.", "")] = np.asarray(value)
    params = jax.tree.map(np.asarray, params)
    batch_stats = jax.tree.map(np.asarray, batch_stats)

    def put_pdbn(scope: str, torch_prefix: str):
        for i in range(len(conditions)):
            bnp = params[f"{scope}"][f"bns_{i}"]
            bns = batch_stats[f"{scope}"][f"bns_{i}"]
            bnp["scale"] = sd[f"{torch_prefix}.bns.{i}.weight"]
            bnp["bias"] = sd[f"{torch_prefix}.bns.{i}.bias"]
            bns["mean"] = sd[f"{torch_prefix}.bns.{i}.running_mean"]
            bns["var"] = sd[f"{torch_prefix}.bns.{i}.running_var"]
        mod_w = sd.get(f"{torch_prefix}.modulation.1.weight")
        if mod_w is not None and "modulation" in params[scope]:
            params[scope]["modulation"]["kernel"] = mod_w.T
            params[scope]["modulation"]["bias"] = sd[f"{torch_prefix}.modulation.1.bias"]

    if "embedding_table.weight" in sd and "embedding_table" in params:
        params["embedding_table"]["embedding"] = sd["embedding_table.weight"]

    params["conv_input_weight"] = _port_spconv_weight(sd["conv_input.conv.weight"], 5)
    put_pdbn("conv_input_bn", "conv_input.bn")

    s = 0
    while f"down{s}_weight" in params:
        params[f"down{s}_weight"] = _port_spconv_weight(
            sd[f"down.{s}.conv.weight"], 2
        )
        put_pdbn(f"down{s}_bn", f"down.{s}.bn")
        params[f"up{s}_weight"] = _port_spconv_weight(sd[f"up.{s}.conv.weight"], 2)
        put_pdbn(f"up{s}_bn", f"up.{s}.bn")
        for prefix, tp in ((f"enc{s}", f"enc.{s}"), (f"dec{s}", f"dec.{s}")):
            i = 0
            while f"{prefix}_block{i}_conv1" in params:
                params[f"{prefix}_block{i}_conv1"] = _port_spconv_weight(
                    sd[f"{tp}.block{i}.conv1.weight"], 3
                )
                params[f"{prefix}_block{i}_conv2"] = _port_spconv_weight(
                    sd[f"{tp}.block{i}.conv2.weight"], 3
                )
                put_pdbn(f"{prefix}_block{i}_bn1", f"{tp}.block{i}.bn1")
                put_pdbn(f"{prefix}_block{i}_bn2", f"{tp}.block{i}.bn2")
                if f"{prefix}_block{i}_proj" in params:
                    params[f"{prefix}_block{i}_proj"] = _port_spconv_weight(
                        sd[f"{tp}.block{i}.proj_conv.weight"], 1
                    )
                    put_pdbn(f"{prefix}_block{i}_proj_bn", f"{tp}.block{i}.proj_norm")
                i += 1
        s += 1
    if "final_weight" in params and "final.weight" in sd:
        params["final_weight"] = _port_spconv_weight(sd["final.weight"], 1)
        params["final_bias"] = sd["final.bias"]
    return params, batch_stats

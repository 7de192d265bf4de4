"""ConditionalUnet1D — FiLM-conditioned temporal UNet, channel-last.

Reference `diffusion/conditional_unet1d.py:17-297`. Layout: the
action trajectory stays ``(B, T, C)`` end-to-end (the reference permutes to
torch's ``(B, C, T)`` and back); convs are ``nn.Conv`` over the time
axis, which XLA lowers to matmuls.

Quirk preserved: with 3 down levels there are only 2 up levels, so the first
skip (full-resolution features) is never consumed — matches the published
diffusion_policy architecture bit-for-bit in topology.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from pointcloudmatters_tpu import nn


def mish(x):
    return x * jnp.tanh(jax.nn.softplus(x))


class SinusoidalPosEmb(nn.Module):
    """(B,) timesteps -> (B, dim) [sin | cos] halves
    (`diffusion/positional_embedding.py:7-21`)."""

    dim: int

    def __call__(self, x: jax.Array) -> jax.Array:
        half = self.dim // 2
        freq = jnp.exp(
            jnp.arange(half, dtype=jnp.float32)
            * (-np.log(10000.0) / (half - 1))
        )
        ang = x.astype(jnp.float32)[:, None] * freq[None, :]
        return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


class Conv1dBlock(nn.Module):
    """Conv -> GroupNorm -> Mish (`diffusion/conv1d_components.py:26-46`)."""

    features: int
    kernel_size: int
    n_groups: int = 8

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = nn.Conv(
            self.features, (self.kernel_size,),
            padding=[(self.kernel_size // 2,) * 2], name="conv",
        )(x)
        # torch GroupNorm eps (nn.GroupNorm defaults to 1e-6; parity-tested)
        x = nn.GroupNorm(num_groups=self.n_groups, epsilon=1e-5, name="norm")(x)
        return mish(x)


class Downsample1d(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        return nn.Conv(self.features, (3,), strides=(2,), padding=[(1, 1)],
                       name="conv")(x)


class Upsample1d(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        # torch ConvTranspose1d(k=4, s=2, p=1) is an exact 2x upsample; nn's
        # "SAME" transposed padding yields the same output length
        return nn.ConvTranspose(self.features, (4,), strides=(2,),
                                padding="SAME", name="conv")(x)


class ConditionalResidualBlock1D(nn.Module):
    """Two conv blocks with FiLM scale/bias conditioning
    (`conditional_unet1d.py:17-76`)."""

    features: int
    cond_dim: int
    kernel_size: int = 3
    n_groups: int = 8
    cond_predict_scale: bool = False

    @nn.compact
    def __call__(self, x: jax.Array, cond: jax.Array) -> jax.Array:
        out = Conv1dBlock(self.features, self.kernel_size, self.n_groups,
                          name="block0")(x)
        embed = nn.Dense(
            self.features * (2 if self.cond_predict_scale else 1),
            name="cond_encoder",
        )(mish(cond))[:, None, :]  # (B, 1, C or 2C)
        if self.cond_predict_scale:
            scale, bias = jnp.split(embed, 2, axis=-1)
            out = scale * out + bias
        else:
            out = out + embed
        out = Conv1dBlock(self.features, self.kernel_size, self.n_groups,
                          name="block1")(out)
        if x.shape[-1] != self.features:
            x = nn.Conv(self.features, (1,), name="residual_conv")(x)
        return out + x


class ConditionalUnet1D(nn.Module):
    """(B, T, input_dim) trajectory + (B,) timestep + (B, G) global cond ->
    (B, T, input_dim) prediction (`conditional_unet1d.py:78-297`)."""

    input_dim: int
    local_cond_dim: Optional[int] = None
    global_cond_dim: Optional[int] = None
    diffusion_step_embed_dim: int = 256
    down_dims: Sequence[int] = (256, 512, 1024)
    kernel_size: int = 3
    n_groups: int = 8
    cond_predict_scale: bool = False

    @nn.compact
    def __call__(
        self,
        sample: jax.Array,
        timestep: jax.Array,
        local_cond: Optional[jax.Array] = None,
        global_cond: Optional[jax.Array] = None,
    ) -> jax.Array:
        down_dims = list(self.down_dims)
        all_dims = [self.input_dim] + down_dims
        in_out = list(zip(all_dims[:-1], all_dims[1:]))
        dsed = self.diffusion_step_embed_dim

        timesteps = jnp.broadcast_to(
            jnp.atleast_1d(jnp.asarray(timestep)), (sample.shape[0],)
        )
        # sinusoids are computed in f32 for timestep resolution; cast before
        # the MLP or the f32 conditioning promotes the whole UNet (FiLM
        # scale/bias and every residual block) to f32 under bf16-mixed
        t_emb = SinusoidalPosEmb(dsed, name="pos_emb")(timesteps)
        t_emb = t_emb.astype(sample.dtype)
        t_emb = nn.Dense(dsed * 4, name="time_mlp1")(t_emb)
        t_emb = nn.Dense(dsed, name="time_mlp2")(mish(t_emb))
        global_feature = t_emb
        if global_cond is not None:
            global_feature = jnp.concatenate([t_emb, global_cond], axis=-1)

        cond_dim = dsed + (self.global_cond_dim or 0)
        del cond_dim  # implied by global_feature's width

        def res(features, name):
            return ConditionalResidualBlock1D(
                features, cond_dim=global_feature.shape[-1],
                kernel_size=self.kernel_size, n_groups=self.n_groups,
                cond_predict_scale=self.cond_predict_scale, name=name,
            )

        h_local = []
        if local_cond is not None:
            _, dim_out = in_out[0]
            h_local.append(res(dim_out, "local_down")(local_cond, global_feature))
            h_local.append(res(dim_out, "local_up")(local_cond, global_feature))

        x = sample
        h = []
        for idx, (_, dim_out) in enumerate(in_out):
            x = res(dim_out, f"down{idx}_res0")(x, global_feature)
            if idx == 0 and h_local:
                x = x + h_local[0]
            x = res(dim_out, f"down{idx}_res1")(x, global_feature)
            h.append(x)
            if idx < len(in_out) - 1:
                x = Downsample1d(dim_out, name=f"down{idx}_ds")(x)

        mid_dim = all_dims[-1]
        x = res(mid_dim, "mid_res0")(x, global_feature)
        x = res(mid_dim, "mid_res1")(x, global_feature)

        for idx, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
            x = jnp.concatenate([x, h.pop()], axis=-1)
            x = res(dim_in, f"up{idx}_res0")(x, global_feature)
            # reference quirk: h_local[1] is added only under an impossible
            # index condition (`conditional_unet1d.py:282-287`) — dead branch
            x = res(dim_in, f"up{idx}_res1")(x, global_feature)
            x = Upsample1d(dim_in, name=f"up{idx}_us")(x)

        x = Conv1dBlock(down_dims[0], self.kernel_size, self.n_groups,
                        name="final_block")(x)
        x = nn.Conv(self.input_dim, (1,), name="final_conv")(x)
        return x


def port_torch_state(ref_module) -> dict:
    """Port a reference torch ``ConditionalUnet1D``'s weights
    (`diffusion/conditional_unet1d.py:78-297`) onto this module's param tree.

    Used by the reference-parity tests and by checkpoint-porting tooling.
    Torch ``Conv1d`` weights ``(out, in, k)`` become ``(k, in, out)``;
    ``ConvTranspose1d`` weights ``(in, out, k)`` are spatially flipped for
    the ``transpose_kernel=False`` convention.
    """
    from pointcloudmatters_tpu.utils import torch_layouts as TL

    def t2n(t):
        return t.detach().cpu().numpy()

    def conv(c):
        out = {"kernel": TL.conv1d_kernel(t2n(c.weight))}
        if c.bias is not None:
            out["bias"] = t2n(c.bias)
        return out

    def conv_transpose(c):
        out = {"kernel": TL.conv_transpose1d_kernel(t2n(c.weight))}
        if c.bias is not None:
            out["bias"] = t2n(c.bias)
        return out

    def linear(l):
        out = {"kernel": TL.linear_kernel(t2n(l.weight))}
        if l.bias is not None:
            out["bias"] = t2n(l.bias)
        return out

    def norm(gn):
        return {"scale": t2n(gn.weight), "bias": t2n(gn.bias)}

    def block(b):  # Conv1dBlock: Sequential(conv, groupnorm, mish)
        return {"conv": conv(b.block[0]), "norm": norm(b.block[1])}

    def resblock(r):
        tree = {
            "block0": block(r.blocks[0]),
            "block1": block(r.blocks[1]),
            "cond_encoder": linear(r.cond_encoder[1]),
        }
        if hasattr(r.residual_conv, "weight"):  # not Identity
            tree["residual_conv"] = conv(r.residual_conv)
        return tree

    params = {
        "time_mlp1": linear(ref_module.diffusion_step_encoder[1]),
        "time_mlp2": linear(ref_module.diffusion_step_encoder[3]),
        "final_block": block(ref_module.final_conv[0]),
        "final_conv": conv(ref_module.final_conv[1]),
    }
    if ref_module.local_cond_encoder is not None:
        params["local_down"] = resblock(ref_module.local_cond_encoder[0])
        params["local_up"] = resblock(ref_module.local_cond_encoder[1])
    for i, (r0, r1, ds) in enumerate(ref_module.down_modules):
        params[f"down{i}_res0"] = resblock(r0)
        params[f"down{i}_res1"] = resblock(r1)
        if hasattr(ds, "conv"):  # not Identity on the last level
            params[f"down{i}_ds"] = {"conv": conv(ds.conv)}
    params["mid_res0"] = resblock(ref_module.mid_modules[0])
    params["mid_res1"] = resblock(ref_module.mid_modules[1])
    for i, (r0, r1, us) in enumerate(ref_module.up_modules):
        params[f"up{i}_res0"] = resblock(r0)
        params[f"up{i}_res1"] = resblock(r1)
        if hasattr(us, "conv"):
            params[f"up{i}_us"] = {"conv": conv_transpose(us.conv)}
    return params

"""Port a reference PyTorch-Lightning checkpoint to this framework's checkpoint.

The migration story for anyone holding reference-trained weights
(`src/train.py:93` / `test_rlbench_act.py:114` semantics): take the
Lightning ``.ckpt`` the reference's ``ModelCheckpoint`` wrote, map its
``state_dict`` onto this framework's parameter/batch-stats trees, and
save in the exact layout ``Trainer.save_checkpoint`` produces — so
``ckpt_path=<ported>`` works in ``src/train.py`` / ``src/validate.py``
unchanged.

Usage:
    python scripts/port_reference_ckpt.py <lightning.ckpt> <out_dir> \
        [--policy auto|act|dp] [--nhead 8]

Supported policies (auto-detected from state-dict keys):
- ACT family — ``ACT``/``ACTPCD``/``ACTRLBench``/``ACTRLBenchPCD``
  (reference `act/act.py:40,312,601,707`): CVAE projections/heads/embeddings,
  both transformer stacks, the PCD token-builder linear+BN, and PointNet
  (spconv k=1), SpUNet, ViT (base/large), MultiViT/MultiMAE (architectures
  inferred from the state-dict shapes), or torchvision-ResNet backbones.
- Diffusion policy — ``DiffusionUnetImagePolicy``
  (`diffusion_unet_image_policy.py:23`): ConditionalUnet1D, the PCD obs
  encoder, and the LinearNormalizer (persisted as checkpoint "extras", the
  DictOfTensorMixin counterpart).

Weight-layout conventions (proven by tests/test_reference_parity.py and
tests/test_ckpt_port.py):
- ``nn.Linear (out,in)`` -> Dense ``kernel (in,out)``
- ``nn.MultiheadAttention in_proj_*`` -> query/key/value DenseGeneral
  ``(d, H, dh)`` splits; ``out_proj`` -> ``(H, dh, d)``
- ``nn.BatchNorm1d`` -> params {scale,bias} + batch_stats {mean,var}
- spconv ``SubMConv3d`` k=1 ``(out,1,1,1,in)`` -> Dense ``kernel (in,out)``
- ``nn.Conv1d`` k=1 -> Dense; general Conv1d ``(out,in,k)`` -> ``(k,in,out)``
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from pointcloudmatters_tpu.utils import torch_layouts as TL  # noqa: E402


# ---------------------------------------------------------------------------
# state-dict navigation
# ---------------------------------------------------------------------------

class SD:
    """Flat torch state dict with prefix slicing."""

    def __init__(self, d: dict):
        self.d = {k: np.asarray(v) for k, v in d.items()}

    def sub(self, prefix: str) -> "SD":
        p = prefix + "."
        return SD({k[len(p):]: v for k, v in self.d.items() if k.startswith(p)})

    def __contains__(self, key: str) -> bool:
        return key in self.d or any(k.startswith(key + ".") for k in self.d)

    def __getitem__(self, key: str) -> np.ndarray:
        return self.d[key]

    def get(self, key: str, default=None):
        return self.d.get(key, default)

    def keys(self):
        return self.d.keys()

    def layer_indices(self, prefix: str) -> list[int]:
        idx = set()
        p = prefix + "."
        for k in self.d:
            if k.startswith(p):
                head = k[len(p):].split(".", 1)[0]
                if head.isdigit():
                    idx.add(int(head))
        return sorted(idx)


# ---------------------------------------------------------------------------
# primitive converters — layout math lives in utils/torch_layouts.py (the
# single torch->JAX layout contract, shared with the parity tests)
# ---------------------------------------------------------------------------

def linear(sd: SD, p: str) -> dict:
    out = {"kernel": TL.linear_kernel(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd.keys():
        out["bias"] = sd[f"{p}.bias"]
    return out


def layernorm(sd: SD, p: str) -> dict:
    return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def batchnorm(sd: SD, p: str) -> tuple[dict, dict]:
    return (
        {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]},
        {"mean": sd[f"{p}.running_mean"], "var": sd[f"{p}.running_var"]},
    )


def mha(sd: SD, p: str, nhead: int) -> dict:
    tree = TL.mha_in_proj(
        sd[f"{p}.in_proj_weight"], sd[f"{p}.in_proj_bias"], nhead
    )
    tree["out"] = TL.mha_out_proj(
        sd[f"{p}.out_proj.weight"], sd[f"{p}.out_proj.bias"], nhead
    )
    return tree


def conv1x1_2d(sd: SD, p: str) -> dict:
    """torch Conv2d k=1 (out,in,1,1) -> Dense kernel (in,out)."""
    out = {"kernel": TL.conv2d_k1_kernel(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd.keys():
        out["bias"] = sd[f"{p}.bias"]
    return out


def conv1d(sd: SD, p: str) -> dict:
    """torch Conv1d (out,in,k) -> (k,in,out)."""
    out = {"kernel": TL.conv1d_kernel(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd.keys():
        out["bias"] = sd[f"{p}.bias"]
    return out


def conv1d_as_dense(sd: SD, p: str) -> dict:
    """torch Conv1d k=1 (out,in,1) -> Dense kernel (in,out)."""
    out = {"kernel": TL.conv1d_k1_kernel(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd.keys():
        out["bias"] = sd[f"{p}.bias"]
    return out


def conv_transpose1d(sd: SD, p: str) -> dict:
    """torch ConvTranspose1d (in,out,k) -> (k,in,out), k flipped."""
    out = {"kernel": TL.conv_transpose1d_kernel(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd.keys():
        out["bias"] = sd[f"{p}.bias"]
    return out


def spconv_k1(sd: SD, p: str) -> dict:
    """spconv SubMConv3d k=1 -> Dense (spconv2 (out,1,1,1,in) layout — the
    reference pins spconv 2.x)."""
    out = {"kernel": TL.spconv_k1_kernel(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd.keys():
        out["bias"] = sd[f"{p}.bias"]
    return out


# ---------------------------------------------------------------------------
# transformer stacks (reference `act/transformer.py`)
# ---------------------------------------------------------------------------

def encoder_layer(sd: SD, p: str, nhead: int) -> dict:
    return {
        "self_attn": mha(sd, f"{p}.self_attn", nhead),
        "linear1": linear(sd, f"{p}.linear1"),
        "linear2": linear(sd, f"{p}.linear2"),
        "norm1": layernorm(sd, f"{p}.norm1"),
        "norm2": layernorm(sd, f"{p}.norm2"),
    }


def decoder_layer(sd: SD, p: str, nhead: int) -> dict:
    return {
        "self_attn": mha(sd, f"{p}.self_attn", nhead),
        "multihead_attn": mha(sd, f"{p}.multihead_attn", nhead),
        "linear1": linear(sd, f"{p}.linear1"),
        "linear2": linear(sd, f"{p}.linear2"),
        "norm1": layernorm(sd, f"{p}.norm1"),
        "norm2": layernorm(sd, f"{p}.norm2"),
        "norm3": layernorm(sd, f"{p}.norm3"),
    }


def transformer_encoder(sd: SD, p: str, nhead: int) -> dict:
    tree = {
        f"layers_{i}": encoder_layer(sd, f"{p}.layers.{i}", nhead)
        for i in sd.layer_indices(f"{p}.layers")
    }
    if f"{p}.norm.weight" in sd.keys():
        tree["norm"] = layernorm(sd, f"{p}.norm")
    return tree


def transformer(sd: SD, p: str, nhead: int) -> dict:
    dec = {
        f"layers_{i}": decoder_layer(sd, f"{p}.decoder.layers.{i}", nhead)
        for i in sd.layer_indices(f"{p}.decoder.layers")
    }
    dec["norm"] = layernorm(sd, f"{p}.decoder.norm")
    return {
        "encoder": transformer_encoder(sd, f"{p}.encoder", nhead),
        "decoder": dec,
    }


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------

def pointnet_backbone(sd: SD) -> tuple[dict, dict]:
    """Reference spconv PointNet (`pcd_encoder/pointnet.py:16-62`):
    conv{i}.0 = SubMConv3d, conv{i}.1 = BatchNorm1d."""
    params, stats = {}, {}
    for i in range(1, 6):
        params[f"conv{i}"] = spconv_k1(sd, f"conv{i}.0")
        bn_p, bn_s = batchnorm(sd, f"conv{i}.1")
        params[f"bn{i}"] = bn_p
        stats[f"bn{i}"] = bn_s
    if "final.weight" in sd.keys():
        params["final"] = spconv_k1(sd, "final")
    return params, stats


def spunet_backbone(sd: SD) -> tuple[dict, dict]:
    """Reference SpUNet (`pcd_encoder/spunet.py:229-463`) -> our SpUNet trees
    via the proven PonderV2 loader. The architecture (base/stage channels,
    block counts, condition count, adaptive modulation) is inferred from the
    state-dict shapes, so the default flagship tower and ablation variants
    both port without flags."""
    import jax
    import jax.numpy as jnp

    from pointcloudmatters_tpu.models.components.pcd_encoder.spunet import (
        SpUNet,
        load_ponderv2_weights,
    )

    w_in = sd["conv_input.conv.weight"]          # (out, 5,5,5, in)
    in_ch, base = int(w_in.shape[-1]), int(w_in.shape[0])
    S = len(sd.layer_indices("down"))
    enc_ch = [int(sd[f"enc.{s}.block0.conv2.weight"].shape[0])
              for s in range(S)]
    dec_out = [int(sd[f"dec.{s}.block0.conv2.weight"].shape[0])
               for s in range(S)]
    # decode width at our stage s is channels[2S-1-s] (spunet.py:228-236)
    channels = tuple(enc_ch) + tuple(dec_out[2 * S - 1 - p]
                                     for p in range(S, 2 * S))
    enc_layers = [len([
        k for k in sd.keys()
        if k.startswith(f"enc.{s}.block") and k.endswith(".conv1.weight")
    ]) for s in range(S)]
    dec_layers = [len([
        k for k in sd.keys()
        if k.startswith(f"dec.{s}.block") and k.endswith(".conv1.weight")
    ]) for s in range(S)]
    layers = tuple(enc_layers) + tuple(dec_layers[2 * S - 1 - p]
                                       for p in range(S, 2 * S))
    n_cond = len({
        k.split(".")[3] for k in sd.keys()
        if k.startswith("conv_input.bn.bns.")
    })
    adaptive = any(".modulation." in k for k in sd.keys())
    num_classes = int(sd["final.weight"].shape[0]) if "final.weight" in sd.keys() else 0
    conditions = tuple(f"cond{i}" for i in range(max(n_cond, 1)))
    ctx = (int(sd["conv_input.bn.modulation.1.weight"].shape[1])
           if adaptive and "conv_input.bn.modulation.1.weight" in sd.keys()
           else 256)

    model = SpUNet(
        in_channels=in_ch, num_classes=num_classes, base_channels=base,
        channels=channels, layers=layers, conditions=conditions,
        norm_adaptive=adaptive, context_channels=ctx,
    )
    d = {
        "grid_coord": jnp.zeros((1, 64, 3), jnp.int32).at[0, :, 0].set(
            jnp.arange(64)
        ),
        "feat": jnp.zeros((1, 64, in_ch), jnp.float32),
        "valid": jnp.ones((1, 64), bool),
    }
    variables = model.init(jax.random.PRNGKey(0), d, train=False)
    return load_ponderv2_weights(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
        {f"module.backbone.{k}": v for k, v in sd.d.items()},
        conditions=conditions,
    )


def vit_backbone(sd: SD) -> tuple[dict, dict]:
    """timm/MAE-style ViT keys (`img_encoder/vit.py:96-810`) -> our ViT
    trees via the existing loader; arch inferred from the weight shapes."""
    import jax
    import jax.numpy as jnp

    from pointcloudmatters_tpu.models.components.img_encoder.vit import (
        ViT,
        load_torch_vit_state_dict,
    )

    pe = sd["patch_embed.proj.weight"]  # (D, C, p, p)
    embed_dim, in_ch, patch = int(pe.shape[0]), int(pe.shape[1]), int(pe.shape[2])
    depth = len(sd.layer_indices("blocks"))
    name = {(768, 12, 16): "vit_base_patch16",
            (1024, 24, 16): "vit_large_patch16"}.get((embed_dim, depth, patch))
    if name is None:
        raise ValueError(
            f"unrecognized ViT architecture: embed_dim={embed_dim}, "
            f"depth={depth}, patch={patch} (known: base/16 and large/16)"
        )
    model = ViT(model_name=name, channels=in_ch)
    variables = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 224, 224, in_ch), jnp.float32), train=False,
    )
    params = load_torch_vit_state_dict(
        jax.tree.map(np.asarray, variables["params"]),
        dict(sd.d), channels=in_ch,
    )
    return params, {}


def multivit_backbone(sd: SD) -> tuple[dict, dict]:
    """EPFL MultiMAE/MultiViT trunk (`img_encoder/multivit.py:1790-2654`
    encoder surface) via the existing loader; dims from the weight shapes."""
    import jax
    import jax.numpy as jnp

    from pointcloudmatters_tpu.models.components.img_encoder.multivit import (
        MultiViTModel,
        load_torch_multimae_state_dict,
    )

    dim = int(sd["input_adapters.rgb.proj.weight"].shape[0])
    depth = len(sd.layer_indices("encoder"))
    heads = {768: 12, 1024: 16}.get(dim)
    if heads is None:
        raise ValueError(f"unrecognized MultiViT dim_tokens={dim}")
    model = MultiViTModel(dim_tokens=dim, depth=depth, num_heads=heads,
                          img_size=224)
    variables = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 224, 224, 4), jnp.float32), train=False,
    )
    params = load_torch_multimae_state_dict(
        jax.tree.map(np.asarray, variables["params"]), dict(sd.d)
    )
    return params, {}


def resnet_backbone(sd: SD, channels: int) -> tuple[dict, dict]:
    """torchvision ResNet keys -> our ResNetTorchVision trees, via the
    existing loader (`img_encoder/resnet.py`). Needs a template init to know
    the tree structure, so this imports jax lazily."""
    import jax
    import jax.numpy as jnp

    from pointcloudmatters_tpu.models.components.img_encoder.resnet import (
        ResNetTorchVision,
        load_torch_state_dict,
    )

    # infer the exact torchvision variant from block counts + block type so
    # an unexpected depth raises instead of silently dropping blocks
    stripped = {k.split("convnet.")[-1].split("module.")[-1] for k in sd.keys()}
    bottleneck = any("layer1.0.conv3" in k for k in stripped)
    per_stage = tuple(
        len({k.split(f"layer{st}.")[1].split(".")[0]
             for k in stripped if f"layer{st}." in k})
        for st in (1, 2, 3, 4)
    )
    arch = {("basic", (2, 2, 2, 2)): "resnet18",
            ("basic", (3, 4, 6, 3)): "resnet34",
            ("bottleneck", (3, 4, 6, 3)): "resnet50"}.get(
        ("bottleneck" if bottleneck else "basic", per_stage)
    )
    if arch is None:
        raise ValueError(
            "unrecognized torchvision ResNet layout: "
            f"{'bottleneck' if bottleneck else 'basic'} blocks {per_stage}"
        )
    model = ResNetTorchVision(
        resnet_model=arch, channels=channels, resize_to=64
    )
    variables = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, channels), jnp.float32), train=False,
    )
    params, stats = load_torch_state_dict(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
        {k: v for k, v in sd.d.items()},
        channels=channels,
    )
    return params, stats


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def port_act_policy(sd: SD, nhead: int) -> tuple[dict, dict]:
    """ACT family (`act/act.py:40,312,601,707`) -> (params, batch_stats)."""
    P: dict = {}
    S: dict = {}
    for name in ("cls_embed", "query_embed", "additional_pos_embed"):
        if f"{name}.weight" in sd.keys():
            P[name] = sd[f"{name}.weight"]
    # the reference names the state-only positional table `pos`
    # (`act/act.py:244` reads self.pos.weight); ours is state_pos_embed
    if "pos.weight" in sd.keys():
        P["state_pos_embed"] = sd["pos.weight"]
    for name in ("encoder_action_proj", "encoder_joint_proj", "latent_proj",
                 "latent_out_proj", "input_proj_robot_state", "action_head",
                 "is_pad_head", "proj_goal_cond_emb", "input_proj_env_state"):
        if f"{name}.weight" in sd.keys():
            P[name] = linear(sd, name)
    P["transformer"] = transformer(sd, "transformer", nhead)
    if "encoder.layers" in sd:
        P["encoder"] = transformer_encoder(sd, "encoder", nhead)

    # image path: input_proj is a 1x1 Conv2d (`act/act.py:96`)
    if "input_proj.weight" in sd.keys():
        w = sd["input_proj.weight"]
        P["input_proj"] = (
            conv1x1_2d(sd, "input_proj") if w.ndim == 4 else linear(sd, "input_proj")
        )

    # PCD token builder (`act/act.py:368-371`): linear -> pcd_linear, bn -> pcd_bn
    if "linear.weight" in sd.keys():
        P["pcd_linear"] = linear(sd, "linear")
    if "bn.weight" in sd.keys():
        bn_p, bn_s = batchnorm(sd, "bn")
        P["pcd_bn"] = bn_p
        S["pcd_bn"] = bn_s

    # backbone
    if "backbone" in sd:
        P["backbone"], bb_stats = port_any_backbone(sd.sub("backbone"))
        if bb_stats:
            S["backbone"] = bb_stats
    return P, S


def port_any_backbone(bsd: SD) -> tuple[dict, dict]:
    """Dispatch an encoder sub-state-dict to the right family loader
    (PointNet / SpUNet / ViT / Joiner-ResNet / direct-ResNet)."""
    if "conv1.0.weight" in bsd.keys():  # spconv PointNet
        return pointnet_backbone(bsd)
    if "conv_input.conv.weight" in bsd.keys():  # SpUNet
        return spunet_backbone(bsd)
    if "patch_embed.proj.weight" in bsd.keys():  # ViT family
        return vit_backbone(bsd)
    if "input_adapters.rgb.proj.weight" in bsd.keys():  # MultiViT/MultiMAE
        return multivit_backbone(bsd)
    if any(k.startswith("0.body.") for k in bsd.keys()):
        # DETR Joiner: backbone.0.body.<torchvision resnet>
        rsd = bsd.sub("0").sub("body")
        return resnet_backbone(rsd, rsd["conv1.weight"].shape[1])
    if any(k.endswith("layer1.0.conv1.weight") for k in bsd.keys()):
        # direct torchvision/R3M ResNet (keys possibly prefixed
        # convnet./module./resnet. — the loader strips those)
        conv1_key = next(
            k for k in bsd.keys() if k.endswith("conv1.weight")
            and "layer" not in k and "downsample" not in k
        )
        return resnet_backbone(bsd, bsd[conv1_key].shape[1])
    raise ValueError(
        "unrecognized encoder backbone keys: "
        + ", ".join(sorted(bsd.keys())[:5])
    )


def port_unet(sd: SD, p: str) -> dict:
    """ConditionalUnet1D (`diffusion/conditional_unet1d.py:78-297`) ->
    our param tree (naming contract in our conditional_unet1d.py)."""

    def block(bp: str) -> dict:  # Conv1dBlock = Sequential(conv, GN, mish)
        return {"conv": conv1d(sd, f"{bp}.block.0"),
                "norm": layernorm(sd, f"{bp}.block.1")}

    def resblock(rp: str) -> dict:
        tree = {
            "block0": block(f"{rp}.blocks.0"),
            "block1": block(f"{rp}.blocks.1"),
            "cond_encoder": linear(sd, f"{rp}.cond_encoder.1"),
        }
        if f"{rp}.residual_conv.weight" in sd.keys():
            tree["residual_conv"] = conv1d(sd, f"{rp}.residual_conv")
        return tree

    params = {
        "time_mlp1": linear(sd, f"{p}.diffusion_step_encoder.1"),
        "time_mlp2": linear(sd, f"{p}.diffusion_step_encoder.3"),
        "final_block": block(f"{p}.final_conv.0"),
        "final_conv": conv1d(sd, f"{p}.final_conv.1"),
    }
    if f"{p}.local_cond_encoder.0.blocks.0.block.0.weight" in sd.keys():
        params["local_down"] = resblock(f"{p}.local_cond_encoder.0")
        params["local_up"] = resblock(f"{p}.local_cond_encoder.1")
    for i in sd.layer_indices(f"{p}.down_modules"):
        dp = f"{p}.down_modules.{i}"
        params[f"down{i}_res0"] = resblock(f"{dp}.0")
        params[f"down{i}_res1"] = resblock(f"{dp}.1")
        if f"{dp}.2.conv.weight" in sd.keys():
            params[f"down{i}_ds"] = {"conv": conv1d(sd, f"{dp}.2.conv")}
    params["mid_res0"] = resblock(f"{p}.mid_modules.0")
    params["mid_res1"] = resblock(f"{p}.mid_modules.1")
    for i in sd.layer_indices(f"{p}.up_modules"):
        up = f"{p}.up_modules.{i}"
        params[f"up{i}_res0"] = resblock(f"{up}.0")
        params[f"up{i}_res1"] = resblock(f"{up}.1")
        if f"{up}.2.conv.weight" in sd.keys():
            params[f"up{i}_us"] = {"conv": conv_transpose1d(sd, f"{up}.2.conv")}
    return params


def port_pcd_obs_encoder(sd: SD, p: str) -> tuple[dict, dict]:
    """PCDObsEncoder (`vision/pcd_obs_encoder.py:14-120`)."""
    P: dict = {"linear": linear(sd, f"{p}.linear")}
    S: dict = {}
    bn_p, bn_s = batchnorm(sd, f"{p}.bn")
    P["bn"] = bn_p
    S["bn"] = bn_s
    bsd = sd.sub(f"{p}.pcd_model")
    if "conv1.0.weight" in bsd.keys():
        P["pcd_model"], S["pcd_model"] = pointnet_backbone(bsd)
    # projector Sequential: [conv,bn,relu]*L, maxpool, conv, bn
    conv_idx = sorted(
        int(k.split(".")[0]) for k in sd.sub(f"{p}.projector").keys()
        if k.endswith(".weight") and k.split(".")[0].isdigit()
        and sd[f"{p}.projector.{k.split('.')[0]}.weight"].ndim == 3
    )
    bn_idx = sorted(
        int(k.split(".")[0]) for k in sd.sub(f"{p}.projector").keys()
        if k.endswith(".running_mean")
    )
    for j, (ci, bi) in enumerate(zip(conv_idx[:-1], bn_idx[:-1])):
        P[f"projector_conv{j}"] = conv1d_as_dense(sd, f"{p}.projector.{ci}")
        bn_p, bn_s = batchnorm(sd, f"{p}.projector.{bi}")
        P[f"projector_bn{j}"] = bn_p
        S[f"projector_bn{j}"] = bn_s
    P["projector_out"] = conv1d_as_dense(sd, f"{p}.projector.{conv_idx[-1]}")
    bn_p, bn_s = batchnorm(sd, f"{p}.projector.{bn_idx[-1]}")
    P["projector_out_bn"] = bn_p
    S["projector_out_bn"] = bn_s
    return P, S


def port_normalizer(sd: SD, p: str) -> dict:
    """Reference LinearNormalizer params_dict -> our extras["normalizer"]
    (`utils/diffusion_policy/normalizer.py:14`, DictOfTensorMixin keys
    ``params_dict.<field>.{offset,scale,input_stats.*}``)."""
    out: dict = {}
    pd = sd.sub(f"{p}.params_dict")
    fields = {k.split(".", 1)[0] for k in pd.keys()}
    for f in sorted(fields):
        fsd = pd.sub(f)
        entry = {"scale": fsd["scale"], "offset": fsd["offset"]}
        stats = {
            k.split(".", 1)[1]: v
            for k, v in fsd.d.items() if k.startswith("input_stats.")
        }
        if stats:
            entry["input_stats"] = stats
        out[f] = entry
    return out


def port_multi_image_obs_encoder(sd: SD, p: str = "obs_encoder") -> tuple[dict, dict]:
    """MultiImageObsEncoder (`vision/multi_image_obs_encoder.py:19-244`):
    the torch ModuleDict ``key_model_map`` ("rgb" when shared, else one model
    per rgb key) maps to our ``rgb_model`` / ``model_<key>`` submodules."""
    kmm = sd.sub(f"{p}.key_model_map")
    P: dict = {}
    S: dict = {}
    models = sorted({k.split(".", 1)[0] for k in kmm.keys()})
    for m in models:
        params, stats = port_any_backbone(kmm.sub(m))
        name = "rgb_model" if m == "rgb" else f"model_{m}"
        P[name] = params
        if stats:
            S[name] = stats
    return P, S


def port_dp_policy(sd: SD) -> tuple[dict, dict, dict]:
    """DiffusionUnetImagePolicy -> (params, batch_stats, extras)."""
    P: dict = {"model": port_unet(sd, "model")}
    S: dict = {}
    if "obs_encoder.linear.weight" in sd.keys():
        P["obs_encoder"], S["obs_encoder"] = port_pcd_obs_encoder(
            sd, "obs_encoder"
        )
    elif "obs_encoder.key_model_map" in sd:
        P["obs_encoder"], S["obs_encoder"] = port_multi_image_obs_encoder(sd)
    extras = {}
    if f"normalizer.params_dict" in sd:
        extras["normalizer"] = port_normalizer(sd, "normalizer")
    return P, S, extras


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def port_state_dict(
    state_dict: dict, policy: str = "auto", nhead: int = 8
) -> dict:
    """Lightning state dict -> checkpoint item (Trainer layout)."""
    sd = SD({
        (k[len("policy."):] if k.startswith("policy.") else k): v
        for k, v in state_dict.items()
        if not k.endswith("num_batches_tracked")
        and not k.startswith(("train_metrics", "val_metrics",
                              "best_val_metrics"))
    })
    if policy == "auto":
        policy = "dp" if "model.diffusion_step_encoder.1.weight" in sd.keys() \
            else "act"
    extras: dict = {}
    if policy == "act":
        params, stats = port_act_policy(sd, nhead)
    elif policy == "dp":
        params, stats, extras = port_dp_policy(sd)
    else:
        raise ValueError(f"unknown policy {policy!r} (use auto|act|dp)")
    # the policy lives under BCModule.policy -> params root IS the policy
    # tree. epoch=-1 means "nothing trained yet": Trainer.restore_checkpoint
    # resumes at saved_epoch + 1, so 0 would silently skip epoch 0 when
    # fine-tuning a ported checkpoint.
    item = {
        "params": params,
        "batch_stats": stats,
        "step": 0,
        "epoch": -1,
    }
    if extras:
        item["extras"] = extras
    return item


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="Lightning .ckpt path")
    ap.add_argument("out", help="output checkpoint directory")
    ap.add_argument("--policy", default="auto", choices=["auto", "act", "dp"])
    ap.add_argument("--nhead", type=int, default=8,
                    help="attention heads (for in_proj splitting)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the mapped tree summary without writing")
    args = ap.parse_args(argv)

    import torch

    raw = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    state_dict = raw.get("state_dict", raw)
    state_dict = {
        k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        for k, v in state_dict.items()
    }
    item = port_state_dict(state_dict, policy=args.policy, nhead=args.nhead)
    n = sum(
        int(np.prod(np.shape(x)))
        for x in _tree_leaves(item["params"])
    )

    if args.dry_run:
        def summarize(tree, prefix="  "):
            for k in sorted(tree):
                v = tree[k]
                if isinstance(v, dict):
                    leaves = sum(
                        int(np.prod(np.shape(x))) for x in _tree_leaves(v)
                    )
                    print(f"{prefix}{k}/  ({leaves:,} params)")
                else:
                    print(f"{prefix}{k}: {tuple(np.shape(v))}")

        print(f"would port {n:,} parameters (dry run):")
        summarize(item["params"])
        if item.get("extras"):
            print(f"  extras: {sorted(item['extras'])}")
        return None

    from pointcloudmatters_tpu.utils.checkpoint import save_tree

    out = os.path.abspath(args.out)
    save_tree(out, item)
    print(f"ported {n:,} parameters -> {out}")
    return out


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()

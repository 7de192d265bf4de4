"""The torch -> JAX weight-LAYOUT contract, in one place.

Pure array-in/array-out converters shared by everything that maps reference
PyTorch weights onto this framework's parameter trees:

- the pretrained-encoder loaders (`img_encoder/resnet.py`, `vit.py`, ...)
- `conditional_unet1d.port_torch_state`
- the parity-test helpers (`tests/_torch_port.py`)
- the product checkpoint porter (`scripts/port_reference_ckpt.py`)

Keeping a single copy means a layout fix (e.g. the ConvTranspose1d spatial
flip) cannot silently diverge between the tests that prove the mapping and
the tools users run.

Conventions (torch -> ours):
- ``nn.Linear``            weight (out, in)        -> Dense kernel (in, out)
- ``nn.Conv1d``            weight (out, in, k)     -> Conv kernel (k, in, out)
- ``nn.Conv1d`` k=1        weight (out, in, 1)     -> Dense kernel (in, out)
- ``nn.Conv2d``            weight (out, in, h, w)  -> Conv kernel (h, w, in, out)
- ``nn.Conv2d`` k=1        weight (out, in, 1, 1)  -> Dense kernel (in, out)
- ``nn.ConvTranspose1d``   weight (in, out, k)     -> nn.ConvTranspose
  kernel (k, in, out) with the spatial axis FLIPPED
  (``transpose_kernel=False`` convention)
- spconv ``SubMConv3d`` k=1 weight (out,1,1,1,in)  -> Dense kernel (in, out)
- ``nn.MultiheadAttention`` in_proj (3D, D) + out_proj (D, D) ->
  ``MultiHeadDotProductAttention`` query/key/value DenseGeneral kernels
  (D, H, dh) and out kernel (H, dh, D)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "linear_kernel",
    "conv1d_kernel",
    "conv1d_k1_kernel",
    "conv2d_kernel",
    "conv2d_k1_kernel",
    "conv_transpose1d_kernel",
    "spconv_k1_kernel",
    "mha_in_proj",
    "mha_out_proj",
]


def linear_kernel(w) -> np.ndarray:
    return np.asarray(w).T


def conv1d_kernel(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 1, 0)


def conv1d_k1_kernel(w) -> np.ndarray:
    return np.asarray(w)[:, :, 0].T


def conv2d_kernel(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)


def conv2d_k1_kernel(w) -> np.ndarray:
    return np.asarray(w)[:, :, 0, 0].T


def conv_transpose1d_kernel(w) -> np.ndarray:
    # torch (in, out, k) -> (k, in, out); transpose_kernel=False
    # correlates rather than convolves, hence the spatial flip
    return np.ascontiguousarray(np.asarray(w).transpose(2, 0, 1)[::-1])


def spconv_k1_kernel(w) -> np.ndarray:
    """spconv2 stores (out, 1, 1, 1, in); squeeze + transpose -> (in, out)."""
    w = np.squeeze(np.asarray(w))
    if w.ndim != 2:
        raise ValueError(f"not a k=1 sparse conv weight: shape {w.shape}")
    return w.T


def mha_in_proj(w, b, nhead: int) -> dict:
    """torch packed in_proj (3D, D)/(3D,) -> {query,key,value} DenseGeneral
    trees with kernel (D, H, dh) and bias (H, dh)."""
    w = np.asarray(w)
    b = np.asarray(b)
    d = w.shape[1]
    dh = d // nhead
    out = {}
    for i, name in enumerate(("query", "key", "value")):
        out[name] = {
            "kernel": w[i * d:(i + 1) * d].T.reshape(d, nhead, dh),
            "bias": b[i * d:(i + 1) * d].reshape(nhead, dh),
        }
    return out


def mha_out_proj(w, b, nhead: int) -> dict:
    """torch out_proj (D, D)/(D,) -> DenseGeneral kernel (H, dh, D)."""
    w = np.asarray(w)
    d = w.shape[0]
    dh = d // nhead
    return {"kernel": w.T.reshape(nhead, dh, d), "bias": np.asarray(b)}

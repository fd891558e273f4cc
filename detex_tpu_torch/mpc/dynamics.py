"""Visual-latent dynamics model: conv encoder + residual MLP dynamics.

Counterpart of detex_tpu/mpc/dynamics.py:26-131.  Parameters are a dict
of tensors with the JAX tree's keys:

  * enc/conv{i}/w: (out, in, 3, 3), torch's OIHW (JAX keeps HWIO);
  * enc/proj/w and dyn/*/w: (in, out), as in JAX, applied as x @ w;
    proj's rows are in NHWC flatten order, so the encoder flattens its
    NCHW activations as NHWC;
  * every b: (out,).

Parameters are float32; `compute_dtype` (bf16 by default) sets where the
encoder and the MLP round, matching the JAX package op for op:

  * the convs run entirely in the compute dtype (output rounded, bias
    added in the compute dtype), as lax.conv_general_dilated does there;
  * the dense layers take compute-dtype operands with float32 results
    (JAX's preferred_element_type=float32).  Here: a float32 matmul of
    operands rounded to the compute dtype, which gives the exact products
    and a float32 sum; torch.matmul on bf16 would round its output.

On a CUDA device, results match the JAX package only with TF32 off
(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
both False); the tests and chip_smoke.py set both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

Params = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    image_size: int = 64           # observations are image_size x image_size
    channels: int = 4              # decoded RGBA8
    conv_features: Tuple[int, ...] = (32, 64, 128, 256)
    latent_dim: int = 128
    action_dim: int = 8
    hidden_dim: int = 512
    n_dynamics_layers: int = 2
    compute_dtype: torch.dtype = torch.bfloat16


def init_params(cfg: DynamicsConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters with the shapes and scales of the JAX
    init_params (He-normal weights, zero biases), drawn from `generator`
    on its own device and placed on `device`."""
    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * math.sqrt(2.0 / fan_in)).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    params: Params = {"enc": {}, "dyn": {}}
    c_in, size = cfg.channels, cfg.image_size
    for i, c_out in enumerate(cfg.conv_features):
        params["enc"][f"conv{i}"] = {
            "w": normal((c_out, c_in, 3, 3), 3 * 3 * c_in),
            "b": zeros(c_out)}
        c_in = c_out
        size //= 2
    flat = size * size * c_in
    params["enc"]["proj"] = {"w": normal((flat, cfg.latent_dim), flat),
                             "b": zeros(cfg.latent_dim)}
    d_in = cfg.latent_dim + cfg.action_dim
    for i in range(cfg.n_dynamics_layers):
        params["dyn"][f"fc{i}"] = {"w": normal((d_in, cfg.hidden_dim), d_in),
                                   "b": zeros(cfg.hidden_dim)}
        d_in = cfg.hidden_dim
    params["dyn"]["out"] = {"w": normal((d_in, cfg.latent_dim), d_in),
                            "b": zeros(cfg.latent_dim)}
    return params


def params_from_jax(tree, device=None) -> Params:
    """Carry over a JAX parameter tree given as numpy arrays
    (`jax.tree.map(np.asarray, params)`): conv weights go from HWIO to
    OIHW, dense weights and biases keep their layout."""
    def tensor(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    out: Params = {}
    for part, layers in tree.items():
        out[part] = {}
        for name, p in layers.items():
            w = np.asarray(p["w"])
            if name.startswith("conv"):
                w = np.transpose(w, (3, 2, 0, 1))
            out[part][name] = {"w": tensor(w), "b": tensor(p["b"])}
    return out


def _same_pad(size: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """XLA's padding="SAME": the total pad goes mostly after the data (for
    stride 2, k 3 on an even size: 0 before, 1 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _dot_f32(x: torch.Tensor, w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """x @ w with operands rounded to `dtype` and a float32 result."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


def encode(params: Params, obs: torch.Tensor,
           cfg: DynamicsConfig) -> torch.Tensor:
    """(B, H, W, C) uint8/int32/float observations -> (B, latent) float32."""
    cdt = cfg.compute_dtype
    x = obs.to(cdt)
    if obs.dtype in (torch.uint8, torch.int32):
        x = x * torch.tensor(1.0 / 255.0, dtype=cdt, device=x.device)
    x = x.permute(0, 3, 1, 2)                                  # NCHW
    for i in range(len(cfg.conv_features)):
        p = params["enc"][f"conv{i}"]
        ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = nnf.conv2d(nnf.pad(x, (pw[0], pw[1], ph[0], ph[1])),
                       p["w"].to(cdt), stride=2)
        x = torch.relu(x + p["b"].to(cdt)[None, :, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)         # NHWC flatten
    p = params["enc"]["proj"]
    return _dot_f32(x, p["w"], cdt) + p["b"]


def dynamics_apply(params: Params, z: torch.Tensor, u: torch.Tensor,
                   cfg: DynamicsConfig) -> torch.Tensor:
    """Residual latent dynamics: z' = z + MLP([z, u])."""
    cdt = cfg.compute_dtype
    x = torch.cat([z, u], dim=-1).to(cdt)
    for i in range(cfg.n_dynamics_layers):
        p = params["dyn"][f"fc{i}"]
        x = torch.relu(_dot_f32(x, p["w"], cdt) + p["b"]).to(cdt)
    p = params["dyn"]["out"]
    return z + (_dot_f32(x, p["w"], cdt) + p["b"])

"""Visual-latent dynamics model: conv encoder + residual MLP dynamics, and
its training step.

Counterpart of detex_tpu/mpc/dynamics.py.  Parameters are a dict of
tensors with the JAX tree's keys:

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

Training takes a torch.optim.AdamW over every parameter (make_optimizer);
train_step updates the parameter tensors in place.

On a mesh (parallel/mesh.py) with a "tp" axis of more than one rank, each
rank holds JAX's tensor-parallel shard of each leaf (param_shardings,
shard_params): conv weights and biases split by output channel, proj.w
and out.w by rows, fc_i.w by columns and fc_i.b with them; proj.b and
out.b replicated.  encode and dynamics_apply then gather, split or reduce
the activations where the layouts meet (Megatron's autograd pairs, so
each rank's gradients are those of its own shard), and train_step
averages the gradients over "dp" in one flat all_reduce.  AdamW is
elementwise and runs per shard unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from detex_tpu_torch.parallel import mesh as mesh_mod

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


def params_from_jax(tree, device=None, mesh=None) -> Params:
    """Carry over a JAX parameter tree given as numpy arrays
    (`jax.tree.map(np.asarray, params)`): conv weights go from HWIO to
    OIHW, dense weights and biases keep their layout.  With a mesh, this
    rank's tensor-parallel shards (shard_params)."""
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
    return out if mesh is None else shard_params(out, mesh)


def _tp_dim(name: str, leaf: str):
    """The dim of a leaf that JAX's param_shardings splits over "tp" (in
    the port's layout), or None for a replicated leaf."""
    if name.startswith("conv"):          # HWIO P(.., "tp") / b P("tp")
        return 0
    if name.startswith("fc"):            # w P(None, "tp"), b P("tp")
        return 1 if leaf == "w" else 0
    return 0 if leaf == "w" else None    # proj, out: w P("tp", None)


def _tp(mesh):
    """"tp" where `mesh` splits the parameters over it, else None."""
    return "tp" if mesh_mod.has_axis(mesh, "tp") else None


def param_shardings(mesh, cfg: DynamicsConfig) -> Dict:
    """Tensor-parallel layout (detex_tpu/mpc/dynamics.py:76-93), as the
    parameter tree with each leaf's dim split over "tp", or None where the
    leaf is replicated (everywhere on a mesh without a "tp" axis of more
    than one rank)."""
    tp = _tp(mesh)

    def layer(name):
        return {k: _tp_dim(name, k) if tp else None for k in ("w", "b")}

    enc = {f"conv{i}": layer(f"conv{i}")
           for i in range(len(cfg.conv_features))}
    enc["proj"] = layer("proj")
    dyn = {f"fc{i}": layer(f"fc{i}") for i in range(cfg.n_dynamics_layers)}
    dyn["out"] = layer("out")
    return {"enc": enc, "dyn": dyn}


def _map_leaves(fn, params: Params) -> Params:
    return {part: {name: {k: fn(name, k, v) for k, v in layer.items()}
                   for name, layer in layers.items()}
            for part, layers in params.items()}


def shard_leaf(x: torch.Tensor, mesh, name: str, leaf: str) -> torch.Tensor:
    """This rank's tensor-parallel shard of a whole leaf (or the
    statistics of one, such as AdamW's moments)."""
    tp = _tp(mesh)
    dim = _tp_dim(name, leaf)
    if tp is None or dim is None:
        return x
    return mesh_mod.piece_of(x.detach(), mesh, tp, dim)


def gather_leaf(x: torch.Tensor, mesh, name: str, leaf: str) -> torch.Tensor:
    """The whole leaf from every rank's shard (all_gather over "tp")."""
    tp = _tp(mesh)
    dim = _tp_dim(name, leaf)
    if tp is None or dim is None:
        return x.detach()
    return mesh_mod.whole_of(x.detach(), mesh, tp, dim)


def shard_params(params: Params, mesh) -> Params:
    """Every rank's tensor-parallel shards of whole parameters (the same
    whole parameters on every rank); the parameters themselves where
    `mesh` has no "tp" axis of more than one rank."""
    return _map_leaves(lambda n, k, v: shard_leaf(v, mesh, n, k), params)


def gather_params(params: Params, mesh) -> Params:
    """The whole parameters from every rank's shards (a collective: every
    rank of the mesh calls it)."""
    return _map_leaves(lambda n, k, v: gather_leaf(v, mesh, n, k), params)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every parameter tensor, in the sorted-key order of a JAX tree
    flatten (whatever the dicts' insertion order)."""
    return [params[part][name][k] for part in sorted(params)
            for name in sorted(params[part])
            for k in sorted(params[part][name])]


def opt_state_from_jax(optimizer: torch.optim.Optimizer,
                       adam_state) -> None:
    """Load optax's scale_by_adam state (count, mu, nu), given as numpy
    arrays (`jax.tree.map(np.asarray, opt_state[0])`), into `optimizer`
    from make_optimizer: mu and nu become each parameter's exp_avg and
    exp_avg_sq (conv moments go from HWIO to OIHW as the weights do; the
    optimizer moves them to its parameters' device), count its step."""
    count, mu, nu = adam_state
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
        for i, (m, v) in enumerate(zip(
            param_leaves(params_from_jax(mu)),
            param_leaves(params_from_jax(nu))))}
    optimizer.load_state_dict(sd)


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


def encode(params: Params, obs: torch.Tensor, cfg: DynamicsConfig,
           mesh=None) -> torch.Tensor:
    """(B, H, W, C) uint8/int32/float observations -> (B, latent) float32.

    With a "tp" mesh the params are this rank's shards: each conv computes
    its output channels from the gathered input channels, and proj takes
    its rows' slice of the gathered NHWC features (not the conv's channel
    split), its partial products summed over "tp"."""
    tp = _tp(mesh)
    cdt = cfg.compute_dtype
    x = obs.to(cdt)
    if obs.dtype in (torch.uint8, torch.int32):
        # 1/255 rounded to the compute dtype on the host: a tensor made on
        # the card from a Python number would be a copy that waits.
        x = x * torch.tensor(1.0 / 255.0, dtype=cdt).item()
    x = x.permute(0, 3, 1, 2)                                  # NCHW
    for i in range(len(cfg.conv_features)):
        p = params["enc"][f"conv{i}"]
        if tp and i:
            x = mesh_mod.copy_to_axis(
                mesh_mod.gather_over_axis(x, mesh, tp, 1), mesh, tp)
        ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = nnf.conv2d(nnf.pad(x, (pw[0], pw[1], ph[0], ph[1])),
                       p["w"].to(cdt), stride=2)
        x = torch.relu(x + p["b"].to(cdt)[None, :, None, None])
    if tp:
        x = mesh_mod.gather_over_axis(x, mesh, tp, 1)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)         # NHWC flatten
    p = params["enc"]["proj"]
    if not tp:
        return _dot_f32(x, p["w"], cdt) + p["b"]
    x = mesh_mod.split_over_axis(x, mesh, tp, 1)
    return mesh_mod.reduce_over_axis(_dot_f32(x, p["w"], cdt), mesh,
                                     tp) + p["b"]


def dynamics_apply(params: Params, z: torch.Tensor, u: torch.Tensor,
                   cfg: DynamicsConfig, mesh=None) -> torch.Tensor:
    """Residual latent dynamics: z' = z + MLP([z, u]).

    With a "tp" mesh: each fc_i computes its hidden columns from the
    gathered input, and out's row shards take this rank's hidden slice,
    their partial products summed over "tp"."""
    cdt = cfg.compute_dtype
    tp = _tp(mesh)
    x = torch.cat([z, u], dim=-1).to(cdt)
    for i in range(cfg.n_dynamics_layers):
        p = params["dyn"][f"fc{i}"]
        if tp:
            x = mesh_mod.copy_to_axis(
                mesh_mod.gather_over_axis(x, mesh, tp, -1) if i else x,
                mesh, tp)
        x = torch.relu(_dot_f32(x, p["w"], cdt) + p["b"]).to(cdt)
    p = params["dyn"]["out"]
    if not tp:
        return z + (_dot_f32(x, p["w"], cdt) + p["b"])
    if not cfg.n_dynamics_layers:
        x = mesh_mod.split_over_axis(x, mesh, tp, -1)
    return z + (mesh_mod.reduce_over_axis(_dot_f32(x, p["w"], cdt), mesh,
                                          tp) + p["b"])


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: DynamicsConfig, mesh=None) -> torch.Tensor:
    """Latent one-step prediction loss.

    batch: obs (B,H,W,C), action (B,A), next_obs (B,H,W,C)."""
    z = encode(params, batch["obs"], cfg, mesh)
    z_next = encode(params, batch["next_obs"], cfg, mesh).detach()
    z_pred = dynamics_apply(params, z, batch["action"], cfg, mesh)
    err = z_pred - z_next
    # Latent regularizer keeps the encoder from collapsing to zero.
    reg = torch.mean(torch.square(torch.mean(torch.square(z), dim=-1) - 1.0))
    return torch.mean(torch.sum(torch.square(err), dim=-1)) + 0.01 * reg


def make_optimizer(params: Params, lr: float = 3e-4) -> torch.optim.AdamW:
    """AdamW over every parameter, biases included (optax.adamw(lr,
    weight_decay=1e-5) decays every leaf); marks each as requiring grad.

    The two compute the same update.  optax: mu = b1 mu + (1-b1) g,
    nu = b2 nu + (1-b2) g^2, p -= lr (mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) +
    eps) + wd p).  torch: p *= 1 - lr wd, then p -= lr/(1-b1^t) mu /
    (sqrt(nu)/sqrt(1-b2^t) + eps).  Both decay the parameter before the
    step, correct both moments by the step count t, and add eps outside
    the square root (optax's eps_root is 0); only the rounding differs.

    On a card the optimizer is capturable: it keeps its step count on the
    device and computes the bias corrections there in float32, so that a
    CUDA graph can hold the step (train_loop._TrainGraph).  The eager card
    step uses it as well, so graphed and eager steps do the same
    arithmetic.  On the CPU (where torch refuses capturable=True) the
    corrections are host doubles."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-5,
                             capturable=leaves[0].device.type == "cuda")


def train_step(params: Params, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], cfg: DynamicsConfig,
               mesh=None):
    """One AdamW step on `batch`, in place; returns (params, loss before
    the step, a 0-d tensor).

    With a mesh, `batch` is this rank's rows of the global batch along
    "dp": the gradients and the loss are averaged over "dp" in one flat
    all_reduce, which gives the global batch mean's (the loss is a batch
    mean and the shards are equal)."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_fn(params, batch, cfg, mesh)
        loss.backward()
    loss = loss.detach()
    if mesh is not None and "dp" in mesh.mesh_dim_names:
        loss = _average_over_dp(param_leaves(params), loss, mesh)
    optimizer.step()
    return params, loss


def _average_over_dp(leaves: List[torch.Tensor], loss: torch.Tensor,
                     mesh) -> torch.Tensor:
    """Average every leaf's gradient and the loss over "dp" in place, with
    one all_reduce of one flat buffer; returns the averaged loss."""
    flat = torch.cat([p.grad.reshape(-1) for p in leaves]
                     + [loss.reshape(1)])
    flat = mesh_mod.all_reduce(flat, mesh, "dp") \
        / mesh_mod.axis_size(mesh, "dp")
    offset = 0
    for p in leaves:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return flat[-1]

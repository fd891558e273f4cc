"""Plain PyTorch reference of the visual-MPC model: the conv encoder, the
residual MLP dynamics, one MPPI update and one AdamW training step.

It is written from the configuration's equations (configs/
visual_mpc_64.json) and imports nothing of the program.  Parameters are a
dict {"enc": {"conv0".., "proj"}, "dyn": {"fc0".., "out"}} of {"w", "b"}
float32 tensors: conv weights (out, in, 3, 3), dense weights (in, out).

Precision is an object with three methods, so that the benchmark's control
can run the same equations one precision lower:

  * `act(x)`   : an activation or operand rounded to the compute type,
                 returned as float32 values;
  * `conv(x, w)`: a stride-2 3x3 conv of padded input, its output in the
                 compute type's storage (bfloat16);
  * `dot(x, w)` : x @ w on rounded operands with a float32 sum.

BF16 is the configuration's: bfloat16 convs, dense layers on
bfloat16-rounded operands with float32 sums, TF32 off.  FP8 is the
control's: every operand rounded to float8 e4m3 under a per-row scale
(each row's largest magnitude onto e4m3's largest value), the convs' and
dots' sums in float32, activations stored in bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

BF = torch.bfloat16


class BF16:
    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return x.to(BF).float()

    @staticmethod
    def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return nnf.conv2d(x.to(BF), w.to(BF), stride=2)

    @staticmethod
    def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(BF).float(), w.to(BF).float())


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale per slice along `dim`; the
    gradient passes the rounding unchanged, as in quantised training."""
    x = x.float()
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30).detach()
    scale = amax / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class FP8:
    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1)

    @staticmethod
    def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xq = _fp8(x.flatten(1), 1).reshape(x.shape)
        wq = _fp8(w.flatten(1), 1).reshape(w.shape)
        return nnf.conv2d(xq, wq, stride=2).to(BF)

    @staticmethod
    def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(_fp8(x, -1), _fp8(w, 0))


def init_params(dcfg: dict, generator: torch.Generator,
                out_scale: float = 1.0) -> dict:
    """He-normal weights and zero biases, each weight one randn draw from
    `generator` on its device, in the order conv0.., proj, fc0.., out; the
    dynamics' output layer then scaled by `out_scale` (a residual MLP's
    small last layer keeps long rollouts bounded)."""
    dev = generator.device

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=dev)
        return x * math.sqrt(2.0 / fan_in)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    params = {"enc": {}, "dyn": {}}
    c_in, size = dcfg["channels"], dcfg["image_size"]
    for i, c_out in enumerate(dcfg["conv_features"]):
        params["enc"][f"conv{i}"] = {
            "w": normal((c_out, c_in, 3, 3), 9 * c_in), "b": zeros(c_out)}
        c_in, size = c_out, size // 2
    flat = size * size * c_in
    params["enc"]["proj"] = {"w": normal((flat, dcfg["latent_dim"]), flat),
                             "b": zeros(dcfg["latent_dim"])}
    d_in = dcfg["latent_dim"] + dcfg["action_dim"]
    for i in range(dcfg["n_dynamics_layers"]):
        params["dyn"][f"fc{i}"] = {
            "w": normal((d_in, dcfg["hidden_dim"]), d_in),
            "b": zeros(dcfg["hidden_dim"])}
        d_in = dcfg["hidden_dim"]
    params["dyn"]["out"] = {
        "w": normal((d_in, dcfg["latent_dim"]), d_in) * out_scale,
        "b": zeros(dcfg["latent_dim"])}
    return params


def leaves(params: dict) -> list:
    """(name, tensor) of every parameter in sorted-key order."""
    return [(f"{part}/{name}/{k}", params[part][name][k])
            for part in sorted(params) for name in sorted(params[part])
            for k in sorted(params[part][name])]


def encode(params: dict, images: torch.Tensor, prec) -> torch.Tensor:
    """(B, H, W, 4) images with values 0..255 -> (B, latent) float32.
    Inputs are scaled by 1/255 in bfloat16; each conv pads as XLA's "SAME"
    does at stride 2 on even sides (none before, one after), adds its bias
    and applies relu in bfloat16; proj reads the features flattened
    channels-last."""
    scale = torch.tensor(1.0 / 255.0, dtype=BF).item()
    x = (images.to(BF) * scale).permute(0, 3, 1, 2)
    i = 0
    while f"conv{i}" in params["enc"]:
        p = params["enc"][f"conv{i}"]
        x = prec.conv(nnf.pad(x, (0, 1, 0, 1)), p["w"])
        x = torch.relu(x + p["b"].to(BF)[None, :, None, None])
        i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    p = params["enc"]["proj"]
    return prec.dot(x, p["w"]) + p["b"]


def dynamics(params: dict, z: torch.Tensor, u: torch.Tensor,
             prec) -> torch.Tensor:
    """z' = z + MLP([z, u]): hidden layers relu, rounded to the compute
    type; the output layer's sum and the residual in float32."""
    x = prec.act(torch.cat([z, u], dim=-1))
    i = 0
    while f"fc{i}" in params["dyn"]:
        p = params["dyn"][f"fc{i}"]
        x = prec.act(torch.relu(prec.dot(x, p["w"]) + p["b"]))
        i += 1
    p = params["dyn"]["out"]
    return z + (prec.dot(x, p["w"]) + p["b"])


def mppi_update(params: dict, z0: torch.Tensor, goal: torch.Tensor,
                nominal: torch.Tensor, eps: torch.Tensor, mcfg: dict,
                ccfg: dict, prec):
    """One MPPI update from the plan `nominal` (H, A) with the noise `eps`
    (K, H, A): K clipped perturbed plans rolled out from z0 through the
    dynamics, each costed goal_weight |z - goal|^2 + control_weight |u|^2
    per stage, weighted exp(-(S - min S) / T).  Returns (the new plan
    (H, A), the plan shifted by one step (H, A), min S)."""
    controls = torch.clamp(nominal[None] + eps, mcfg["action_low"],
                           mcfg["action_high"])
    k = controls.shape[0]
    z = z0.expand(k, -1)
    total = torch.zeros((k,), dtype=torch.float32, device=eps.device)
    for t in range(controls.shape[1]):
        u = controls[:, t]
        total = total + (ccfg["goal_weight"]
                         * torch.sum((z - goal[None]) ** 2, dim=-1)
                         + ccfg["control_weight"] * torch.sum(u ** 2, dim=-1))
        z = dynamics(params, z, u, prec)
    beta = torch.min(total)
    w = torch.exp(-(total - beta) / mcfg["temperature"])
    plan = torch.einsum("k,kha->ha", w, controls) / torch.sum(w)
    shifted = torch.cat([plan[1:], plan[-1:]], dim=0)
    return plan, shifted, beta


def loss(params: dict, obs: torch.Tensor, action: torch.Tensor,
         next_obs: torch.Tensor, prec) -> torch.Tensor:
    """One-step latent prediction loss: mean over the batch of
    |z + MLP([z, u]) - sg(enc(next_obs))|^2, plus 0.01 times the mean of
    (mean(z^2) - 1)^2, which keeps the latent from collapsing."""
    z = encode(params, obs, prec)
    z_next = encode(params, next_obs, prec).detach()
    err = dynamics(params, z, action, prec) - z_next
    reg = torch.mean(torch.square(torch.mean(torch.square(z), dim=-1) - 1.0))
    return torch.mean(torch.sum(torch.square(err), dim=-1)) + 0.01 * reg


def adamw_step(tensors: list, grads: list, state: list, step: int,
               lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 1e-5) -> None:
    """Decoupled-weight-decay Adam (Loshchilov and Hutter), in place, at
    step number `step` (1 first): p *= 1 - lr wd; m = b1 m + (1 - b1) g;
    v = b2 v + (1 - b2) g^2; p -= lr / (1 - b1^t) m / (sqrt(v) /
    sqrt(1 - b2^t) + eps).  `state` holds one [m, v] per tensor."""
    b1, b2 = betas
    c1, c2 = 1 - b1 ** step, math.sqrt(1 - b2 ** step)
    with torch.no_grad():
        for p, g, (m, v) in zip(tensors, grads, state, strict=True):
            p.mul_(1 - lr * weight_decay)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / c1 * m / (v.sqrt() / c2 + eps))

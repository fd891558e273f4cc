"""TD-MPC2 (Hansen, Su and Wang, "TD-MPC2: Scalable, Robust World Models for
Continuous Control", ICLR 2024, arXiv:2310.16828; code at
github.com/nicklashansen/tdmpc2): the world model and its planner, served
by the port's control step (mpc/runtime.py) beside the visual-MPC model.

The world model, as `tdmpc2/common/{layers,world_model,math}.py` write it:

  * NormedLinear: Linear, then LayerNorm, then Mish.  Every MLP is two
    NormedLinear layers of `mlp_dim` and a plain Linear out;
  * the pixel encoder: 3 stacked 64x64 RGB frames (9 channels, x / 255 -
    0.5) through 4 convs of `num_channels` (k7 s2, k5 s2, k3 s2, k3 s1,
    relu between them), flattened channel-major, then a Linear to
    `latent_dim` and SimNorm;
  * SimNorm: a softmax over each group of `simnorm_dim` latent entries;
  * dynamics [z, task, a] -> mlp_dim -> mlp_dim -> latent_dim, its out
    layer followed by LayerNorm and SimNorm;
  * reward and `num_q` Q heads [z, task, a] -> ... -> num_bins, read by
    the two-hot inverse: softmax over the bins, a dot with the bin centres
    linspace(vmin, vmax, num_bins), then symexp;
  * the policy prior [z, task] -> ... -> 2A: mean and log-std, the log-std
    squashed into [log_std_min, log_std_max], a sample mean + eps * std,
    tanh; the action masked to the task's dims;
  * a task embedding (a row of an (n_tasks, task_dim) table, max norm 1)
    joined after z to every MLP's input.

The planner is TD-MPC2's `plan` and `_estimate_value`: num_pi_trajs
trajectories of the policy prior; then `iterations` rounds of num_samples
trajectories (the prior's and mean + std * eps clamped to [-1, 1] for the
rest, masked), each valued by `horizon` discounted two-hot rewards plus
the mean of 2 of the Q heads (a pair drawn per round) at the terminal
latent and the prior's action there; the top num_elites by value weighted
exp(temperature * (v - max v)), the mean and std (clamped to [min_std,
max_std]) updated from them.  The action is the first action of an elite
chosen by the Gumbel-max trick on the weights (eval mode: no noise added);
the mean, shifted by one step with a zero last step, starts the next
step's planning.

Every random draw of a step is made before it, into static buffers
(empty_draws, draw), so that a captured step's replay reads them: the
policy's noise, the samples' noise, the Q pairs' keys and the Gumbel
choice's exponential draws.

Precision: parameters float32; every dense layer and conv takes operands
rounded to `compute_dtype` (bf16) into float32 sums (dynamics._dot_f32,
the visual-MPC model's rule); LayerNorm, Mish, SimNorm, the softmaxes, the
two-hot inverse and the planner's statistics run in float32.  Dropout is
off in serving.

Parameters are a dict of float32 tensors: dense weights (in, out), applied
as x @ w, conv weights (out, in, k, k); the Q ensemble's tensors stacked
on a leading axis of num_q.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as nnf

from detex_tpu_torch.mpc.dynamics import _dot_f32

# The pixel encoder's convs: (kernel, stride), relu after all but the last.
CONVS = ((7, 2), (5, 2), (3, 2), (3, 1))
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class TDMPC2Config:
    # The world model: MODEL_SIZE[317] (mlp_dim, latent_dim, num_q) and
    # config.yaml of the published code; the pixel encoder's frames and
    # channels from its pixel wrapper and config.yaml.
    image_size: int = 64
    frames: int = 3
    num_channels: int = 32
    latent_dim: int = 1376
    mlp_dim: int = 4096
    simnorm_dim: int = 8
    num_bins: int = 101
    vmin: float = -10.0
    vmax: float = 10.0
    num_q: int = 8
    task_dim: int = 96
    n_tasks: int = 80
    action_dim: int = 6
    log_std_min: float = -10.0
    log_std_max: float = 2.0
    # The served task: its action dims (the rest are masked) and discount.
    task_action_dim: int = 6
    discount: float = 0.99
    # The planner (config.yaml).
    horizon: int = 3
    iterations: int = 6
    num_samples: int = 512
    num_elites: int = 64
    num_pi_trajs: int = 24
    temperature: float = 0.5
    min_std: float = 0.05
    max_std: float = 2.0
    compute_dtype: torch.dtype = torch.bfloat16


def conv_side(cfg: TDMPC2Config) -> int:
    """The side of the last conv's output."""
    side = cfg.image_size
    for k, s in CONVS:
        side = (side - k) // s + 1
    return side


def mlp_rows(cfg: TDMPC2Config) -> int:
    """Rows through the world model's MLPs in one planning step: the prior's
    policy and dynamics calls, and each round's rewards, dynamics, terminal
    policy and Q pair."""
    h = cfg.horizon
    prior = cfg.num_pi_trajs * (h + (h - 1)) if cfg.num_pi_trajs else 0
    return prior + cfg.iterations * cfg.num_samples * (2 * h + 1 + 2)


# -- parameters ---------------------------------------------------------------

def init_params(cfg: TDMPC2Config, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters by TD-MPC2's weight_init, drawn from `generator` on
    its own device and placed on `device` (by default that one): dense
    weights truncated normal with std 0.02 (bounds +-2, as
    nn.init.trunc_normal_), conv weights orthogonal with relu's gain (the
    QR in float64 on the host), the task table uniform in +-0.02, biases
    0, LayerNorm scales 1.  The reward and Q out layers are not zeroed
    (TD-MPC2 zeroes them at init, which makes every value tie).  Drawn in
    the order task, encoder, dynamics, reward, policy, Q."""
    gdev = generator.device
    device = gdev if device is None else device

    def trunc(*shape):
        t = torch.empty(shape, device=gdev)
        torch.nn.init.trunc_normal_(t, std=0.02, generator=generator)
        return t.to(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def orthogonal(c_out, c_in, k):
        flat = torch.randn((c_out, c_in * k * k), generator=generator,
                           device=gdev).cpu().double()
        tall = flat.shape[0] < flat.shape[1]
        q, r = torch.linalg.qr(flat.t() if tall else flat)
        q = q * torch.diagonal(r).sign()
        q = (q.t() if tall else q) * math.sqrt(2.0)
        return q.float().reshape(c_out, c_in, k, k).to(device)

    def linear(d_in, d_out, q=()):
        return {"w": trunc(*q, d_in, d_out), "b": zeros(*q, d_out)}

    def normed(d_in, d_out, q=()):
        return dict(linear(d_in, d_out, q), ln_w=ones(*q, d_out),
                    ln_b=zeros(*q, d_out))

    def mlp(d_in, d_out, out_normed=False, q=()):
        m = cfg.mlp_dim
        return {"fc0": normed(d_in, m, q), "fc1": normed(m, m, q),
                "out": (normed if out_normed else linear)(m, d_out, q)}

    l, t, a = cfg.latent_dim, cfg.task_dim, cfg.action_dim
    table = torch.empty((cfg.n_tasks, t), device=gdev)
    table.uniform_(-0.02, 0.02, generator=generator)
    params = {"task": {"emb": table.to(device)}, "enc": {}}
    c_in = 3 * cfg.frames
    for i, (k, _) in enumerate(CONVS):
        params["enc"][f"conv{i}"] = {
            "w": orthogonal(cfg.num_channels, c_in, k),
            "b": zeros(cfg.num_channels)}
        c_in = cfg.num_channels
    params["enc"]["proj"] = linear(c_in * conv_side(cfg) ** 2, l)
    params["dyn"] = mlp(l + t + a, l, out_normed=True)
    params["rew"] = mlp(l + t + a, cfg.num_bins)
    params["pi"] = mlp(l + t, 2 * a)
    params["q"] = mlp(l + t + a, cfg.num_bins, q=(cfg.num_q,))
    return params


def task_context(params: Dict, task: int, cfg: TDMPC2Config) -> Dict:
    """What a served task fixes, on the parameters' device: its embedding
    row (renormalised to norm 1 where it is longer, as nn.Embedding's
    max_norm does), the action mask (1 on the task's first task_action_dim
    dims) and the two-hot bins."""
    row = params["task"]["emb"][int(task)]
    norm = torch.linalg.vector_norm(row)
    emb = torch.where(norm > 1.0, row * (1.0 / (norm + 1e-7)), row)
    dev = row.device
    mask = (torch.arange(cfg.action_dim, device=dev)
            < cfg.task_action_dim).float()
    bins = torch.linspace(cfg.vmin, cfg.vmax, cfg.num_bins, device=dev)
    return {"emb": emb, "mask": mask, "bins": bins}


# -- layers -------------------------------------------------------------------

def simnorm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax over each group of `dim` entries of the last axis."""
    shape = x.shape
    return torch.softmax(x.reshape(*shape[:-1], -1, dim), dim=-1) \
        .reshape(shape)


def two_hot_inv(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """(..., num_bins) logits -> (..., 1): symexp of the softmax's mean
    over the bins."""
    x = torch.sum(torch.softmax(x, dim=-1) * bins, dim=-1, keepdim=True)
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def _linear(x, p, cdt):
    return _dot_f32(x, p["w"], cdt) + p["b"]


def _layer_norm(x, p):
    return nnf.layer_norm(x, (x.shape[-1],), p["ln_w"], p["ln_b"], LN_EPS)


def _normed(x, p, cdt):
    """NormedLinear: Linear, LayerNorm, Mish."""
    return nnf.mish(_layer_norm(_linear(x, p, cdt), p))


def _hidden(x, layers, cdt):
    return _normed(_normed(x, layers["fc0"], cdt), layers["fc1"], cdt)


def next_latent(params, za, cfg: TDMPC2Config):
    """Dynamics on [z, task, a] -> the next latent (SimNorm groups)."""
    p = params["dyn"]
    x = _linear(_hidden(za, p, cfg.compute_dtype), p["out"],
                cfg.compute_dtype)
    return simnorm(_layer_norm(x, p["out"]), cfg.simnorm_dim)


def reward(params, za, bins, cfg: TDMPC2Config):
    """The reward head on [z, task, a], read by the two-hot inverse."""
    p, cdt = params["rew"], cfg.compute_dtype
    return two_hot_inv(_linear(_hidden(za, p, cdt), p["out"], cdt), bins)


def q_value(params, zqa, k, bins, cfg: TDMPC2Config):
    """Q head `k` (a one-element index tensor, gathered on the device
    without a host read) on [z, task, a], read by the two-hot inverse."""
    cdt = cfg.compute_dtype
    k = k.reshape(1)
    p = {name: {key: v.index_select(0, k)[0] for key, v in layer.items()}
         for name, layer in params["q"].items()}
    return two_hot_inv(_linear(_hidden(zqa, p, cdt), p["out"], cdt), bins)


def policy(params, zt, eps, mask, cfg: TDMPC2Config):
    """The policy prior's sampled action on [z, task] with the noise eps:
    tanh(mu + eps * exp(log_std)), masked to the task's dims."""
    p, cdt = params["pi"], cfg.compute_dtype
    mu, log_std = _linear(_hidden(zt, p, cdt), p["out"], cdt).chunk(2, -1)
    low, dif = cfg.log_std_min, cfg.log_std_max - cfg.log_std_min
    log_std = low + 0.5 * dif * (torch.tanh(log_std) + 1)
    mu, log_std, eps = mu * mask, log_std * mask, eps * mask
    return torch.tanh(mu + eps * torch.exp(log_std))


def encode(params, frames: torch.Tensor, cfg: TDMPC2Config) -> torch.Tensor:
    """(frames, S, S, 3) RGB 0..255, oldest first -> (1, latent_dim)."""
    cdt = cfg.compute_dtype
    side = frames.shape[1]
    x = frames.permute(0, 3, 1, 2).reshape(1, -1, side, side).float() \
        / 255.0 - 0.5
    for i, (_, stride) in enumerate(CONVS):
        p = params["enc"][f"conv{i}"]
        x = nnf.conv2d(x.to(cdt).float(), p["w"].to(cdt).float(),
                       stride=stride) + p["b"][None, :, None, None]
        if i < len(CONVS) - 1:
            x = torch.relu(x)
    return simnorm(_linear(x.reshape(1, -1), params["enc"]["proj"], cdt),
                   cfg.simnorm_dim)


# -- the draws ----------------------------------------------------------------

def empty_draws(cfg: TDMPC2Config, device) -> Dict[str, torch.Tensor]:
    """Zeroed static buffers for one step's draws: "gauss" (one flat
    buffer) with its views "prior_eps" (H, P, A), "sample_eps" (iterations,
    H, N - P, A) and "pi_eps" (iterations, N, A); "q_keys" (iterations,
    num_q) uniform; "exp" (num_elites,) exponential."""
    h, n, p, a = (cfg.horizon, cfg.num_samples, cfg.num_pi_trajs,
                  cfg.action_dim)
    it = cfg.iterations
    sizes = (h * p * a, it * h * (n - p) * a, it * n * a)
    gauss = torch.zeros((sum(sizes),), device=device)
    prior, sample, pi = gauss.split(sizes)
    return {"gauss": gauss, "prior_eps": prior.view(h, p, a),
            "sample_eps": sample.view(it, h, n - p, a),
            "pi_eps": pi.view(it, n, a),
            "q_keys": torch.zeros((it, cfg.num_q), device=device),
            "exp": torch.zeros((cfg.num_elites,), device=device)}


def draw(draws: Dict[str, torch.Tensor], generator) -> None:
    """One step's draws from `generator` into empty_draws' buffers, in
    place and in this order: the normal noise (prior's, samples', terminal
    policy's, one flat draw), the Q pairs' uniform keys, the Gumbel
    choice's exponential draws."""
    torch.randn(draws["gauss"].shape, generator=generator,
                out=draws["gauss"])
    torch.rand(draws["q_keys"].shape, generator=generator,
               out=draws["q_keys"])
    draws["exp"].exponential_(generator=generator)


def q_pairs(keys: torch.Tensor) -> torch.Tensor:
    """(iterations, num_q) uniform keys -> (iterations, 2) distinct heads:
    the two smallest keys' places, a pair drawn without replacement."""
    return torch.argsort(keys, dim=1)[:, :2]


# -- the planner --------------------------------------------------------------

def policy_prior(params, z, emb, eps, mask, cfg: TDMPC2Config):
    """(H, P, A): P trajectories of the policy prior from z, its noise eps
    (H, P, A)."""
    p = cfg.num_pi_trajs
    zp, e = z.expand(p, -1), emb.expand(p, -1)
    actions = []
    for t in range(cfg.horizon - 1):
        a = policy(params, torch.cat([zp, e], -1), eps[t], mask, cfg)
        actions.append(a)
        zp = next_latent(params, torch.cat([zp, e, a], -1), cfg)
    actions.append(policy(params, torch.cat([zp, e], -1), eps[-1], mask,
                          cfg))
    return torch.stack(actions)


def estimate_value(params, z, actions, emb, pair, eps, mask, bins,
                   cfg: TDMPC2Config):
    """(N, 1) values of the trajectories `actions` (H, N, A) from the
    latents z (N, L): the discounted two-hot rewards, plus the discounted
    mean of the Q heads `pair` at the terminal latent and the prior's
    action there (noise eps (N, A))."""
    e = emb.expand(z.shape[0], -1)
    g, discount = 0, 1.0
    for t in range(cfg.horizon):
        za = torch.cat([z, e, actions[t]], -1)
        r = reward(params, za, bins, cfg)
        z = next_latent(params, za, cfg)
        g = g + discount * r
        discount *= cfg.discount
    a = policy(params, torch.cat([z, e], -1), eps, mask, cfg)
    zqa = torch.cat([z, e, a], -1)
    q = (q_value(params, zqa, pair[0], bins, cfg)
         + q_value(params, zqa, pair[1], bins, cfg)) / 2
    return g + discount * q


def plan(params, z, warm, draws, ctx, cfg: TDMPC2Config) -> Dict:
    """One planning step from the latent z (1, L) and the warm-start mean
    `warm` (H, A) with one step's draws: {"action" (A,), "values" (N,) the
    first round's values, "mean" and "std" (H, A) the last round's,
    "elites" (rounds, E) each round's elite indices, "choice" the chosen
    elite}."""
    h, n, p, a = (cfg.horizon, cfg.num_samples, cfg.num_pi_trajs,
                  cfg.action_dim)
    emb, mask, bins = ctx["emb"], ctx["mask"], ctx["bins"]
    zn = z.expand(n, -1)
    mean = warm
    std = torch.full((h, a), cfg.max_std, device=z.device)
    actions = torch.empty((h, n, a), device=z.device)
    if p:
        actions[:, :p] = policy_prior(params, z, emb, draws["prior_eps"],
                                      mask, cfg)
    pairs = q_pairs(draws["q_keys"])
    values, elites = None, []
    for i in range(cfg.iterations):
        actions[:, p:] = (mean.unsqueeze(1) + std.unsqueeze(1)
                          * draws["sample_eps"][i]).clamp(-1, 1)
        actions = actions * mask
        value = estimate_value(params, zn, actions, emb, pairs[i],
                               draws["pi_eps"][i], mask, bins,
                               cfg).nan_to_num(0)
        if values is None:
            values = value[:, 0]
        idx = torch.topk(value.squeeze(1), cfg.num_elites, dim=0).indices
        elite_value, elite_actions = value[idx], actions[:, idx]
        score = torch.exp(cfg.temperature
                          * (elite_value - elite_value.max(0)[0]))
        score = score / score.sum(0)
        mean = torch.sum(score.unsqueeze(0) * elite_actions, dim=1) \
            / (score.sum(0) + 1e-9)
        std = torch.sqrt(torch.sum(
            score.unsqueeze(0) * (elite_actions - mean.unsqueeze(1)) ** 2,
            dim=1) / (score.sum(0) + 1e-9)).clamp(cfg.min_std, cfg.max_std)
        mean, std = mean * mask, std * mask
        elites.append(idx)
    choice = torch.argmax(torch.log(score.squeeze(1))
                          - torch.log(draws["exp"]))
    # A gather, not elite_actions[0, choice]: indexing by a 0-d tensor
    # reads it on the host, which a captured step cannot hold.
    action = elite_actions[0].index_select(0, choice.reshape(1))[0]
    return {"action": action.clamp(-1, 1),
            "values": values, "mean": mean, "std": std,
            "elites": torch.stack(elites), "choice": choice}


def warm_start(mean: torch.Tensor) -> torch.Tensor:
    """The next step's starting mean: `mean` shifted one step, its last
    step zero."""
    return torch.cat([mean[1:], torch.zeros_like(mean[-1:])])

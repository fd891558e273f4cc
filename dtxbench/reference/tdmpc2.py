"""Plain PyTorch reference of TD-MPC2 (Hansen, Su and Wang, ICLR 2024,
arXiv:2310.16828; github.com/nicklashansen/tdmpc2): the world model's
forward pass and one planning step (`TDMPC2.plan`, `_estimate_value`)
given the step's draws.

It imports nothing of the program and nothing of JAX, keeps no graph and
batches nothing beyond the published code's own batch of samples.  It
reads the configuration as one flat dict `m` (configs/tdmpc2_317m.json's
"model", "planner" and the task's "action_dim" as `task_action_dim` and
"discount"; `flat_config`).  Parameters: float32 dense weights (in, out),
applied as x @ w; conv weights (out, in, k, k); the Q ensemble stacked on
a leading axis.

Departures from the published code:
  1. The pixel encoder (4 convs of 32 channels over 3 stacked 64x64 RGB
     frames) is joined to the 317M model's latent, 1,376, by one Linear
     512 -> 1376 before its SimNorm; TD-MPC2 publishes the 317M widths
     for state observations only, and its pixel encoder ends in SimNorm
     over the 512 conv features.
  2. The encoder's random shift (ShiftAug, +-3 pixels, a training
     augmentation the published encoder applies in every call) is left
     out.
  3. The task embedding is joined to the MLPs' inputs, not the
     encoder's: TD-MPC2 joins it to a state vector; a pixel encoder takes
     none.
  4. A conv's bias is added after the conv: the same sum, rounded apart.
  5. The Q pair of a planning round is the two smallest of num_q uniform
     keys (a pair without replacement, as np.random.choice(num_q, 2,
     replace=False) draws it on the host), and only those two heads are
     computed; TD-MPC2 computes all num_q and keeps the two.
  6. The elite is chosen by argmax(log score + Gumbel); the published
     gumbel_softmax_sample takes the argmax of that sum's softmax: the
     same index.
  7. The policy's log-probability is not computed: the planner never
     reads it.  Dropout is off (serving).
  8. Weights (`init_params`): TD-MPC2's weight_init, except that the
     reward and Q out layers are not zeroed (zeroed, every value ties)
     and the conv weights' QR runs in float64 on the host.
  9. Precision (the configuration's): dense layers and convs on
     bf16-rounded operands with float32 sums, TF32 off; the rest float32.
     TD-MPC2 runs float32.

`BF16` is the configuration's precision; `FP8` the benchmark's control:
every dense and conv operand rounded to float8 e4m3 under a per-row scale
(each row's largest magnitude onto e4m3's largest value), sums float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

BF = torch.bfloat16
CONVS = ((7, 2), (5, 2), (3, 2), (3, 1))


def no_tf32() -> None:
    """float32 matmuls and convs in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class BF16:
    @staticmethod
    def dot(x, w):
        return torch.matmul(x.to(BF).float(), w.to(BF).float())

    @staticmethod
    def conv(x, w, stride):
        return nnf.conv2d(x.to(BF).float(), w.to(BF).float(), stride=stride)


def _fp8(x, dim):
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class FP8:
    @staticmethod
    def dot(x, w):
        return torch.matmul(_fp8(x, -1), _fp8(w, 0))

    @staticmethod
    def conv(x, w, stride):
        xq = _fp8(x.flatten(1), 1).reshape(x.shape)
        wq = _fp8(w.flatten(1), 1).reshape(w.shape)
        return nnf.conv2d(xq, wq, stride=stride)


def flat_config(config: dict) -> dict:
    """The configuration file's model, planner and task as one dict."""
    return dict(config["model"], **config["planner"],
                task_action_dim=config["task"]["action_dim"],
                discount=config["task"]["discount"])


def conv_side(m: dict) -> int:
    side = m["image_size"]
    for k, s in CONVS:
        side = (side - k) // s + 1
    return side


def init_params(m: dict, generator: torch.Generator) -> dict:
    """TD-MPC2's weight_init from `generator`, on its device, in the order
    task table, encoder, dynamics, reward, policy, Q: dense weights
    trunc_normal_(std=0.02) (bounds +-2), conv weights orthogonal_ with
    relu's gain sqrt(2), the table uniform in +-0.02, biases 0, LayerNorm
    scales 1 and shifts 0."""
    dev = generator.device

    def trunc(*shape):
        t = torch.empty(shape, device=dev)
        torch.nn.init.trunc_normal_(t, std=0.02, generator=generator)
        return t

    def orthogonal(c_out, c_in, k):
        flat = torch.randn((c_out, c_in * k * k), generator=generator,
                           device=dev).cpu().double()
        tall = flat.shape[0] < flat.shape[1]
        q, r = torch.linalg.qr(flat.t() if tall else flat)
        q = q * torch.diagonal(r).sign()
        q = (q.t() if tall else q) * math.sqrt(2.0)
        return q.float().reshape(c_out, c_in, k, k).to(dev)

    def layer(d_in, d_out, normed, q=()):
        out = {"w": trunc(*q, d_in, d_out),
               "b": torch.zeros((*q, d_out), device=dev)}
        if normed:
            out["ln_w"] = torch.ones((*q, d_out), device=dev)
            out["ln_b"] = torch.zeros((*q, d_out), device=dev)
        return out

    def mlp(d_in, d_out, out_normed=False, q=()):
        h = m["mlp_dim"]
        return {"fc0": layer(d_in, h, True, q), "fc1": layer(h, h, True, q),
                "out": layer(h, d_out, out_normed, q)}

    table = torch.empty((m["n_tasks"], m["task_dim"]), device=dev)
    table.uniform_(-0.02, 0.02, generator=generator)
    enc, c_in = {}, 3 * m["frames"]
    for i, (k, _) in enumerate(CONVS):
        enc[f"conv{i}"] = {"w": orthogonal(m["num_channels"], c_in, k),
                           "b": torch.zeros((m["num_channels"],),
                                            device=dev)}
        c_in = m["num_channels"]
    enc["proj"] = layer(c_in * conv_side(m) ** 2, m["latent_dim"], False)
    zta = m["latent_dim"] + m["task_dim"] + m["action_dim"]
    return {"task": {"emb": table}, "enc": enc,
            "dyn": mlp(zta, m["latent_dim"], out_normed=True),
            "rew": mlp(zta, m["num_bins"]),
            "pi": mlp(m["latent_dim"] + m["task_dim"], 2 * m["action_dim"]),
            "q": mlp(zta, m["num_bins"], q=(m["num_q"],))}


def draws(generator: torch.Generator, m: dict) -> dict:
    """One step's draws, in the program's order: one flat normal draw (the
    prior's noise (H, P, A), the samples' (iterations, H, N - P, A), the
    terminal policy's (iterations, N, A)), the Q pairs' uniform keys
    (iterations, num_q), the Gumbel choice's exponential draws
    (num_elites,)."""
    dev = generator.device
    h, n, p, a = (m["horizon"], m["num_samples"], m["num_pi_trajs"],
                  m["action_dim"])
    it = m["iterations"]
    sizes = (h * p * a, it * h * (n - p) * a, it * n * a)
    gauss = torch.randn((sum(sizes),), generator=generator, device=dev)
    prior, sample, pi = gauss.split(sizes)
    keys = torch.rand((it, m["num_q"]), generator=generator, device=dev)
    exp = torch.empty((m["num_elites"],), device=dev)
    exp.exponential_(generator=generator)
    return {"prior_eps": prior.view(h, p, a),
            "sample_eps": sample.view(it, h, n - p, a),
            "pi_eps": pi.view(it, n, a), "q_keys": keys, "exp": exp}


# -- the world model (tdmpc2/common/layers.py, world_model.py, math.py) -------

def simnorm(x, dim):
    shape = x.shape
    x = x.view(*shape[:-1], -1, dim)
    return nnf.softmax(x, dim=-1).view(shape)


def two_hot_inv(x, m):
    bins = torch.linspace(m["vmin"], m["vmax"], m["num_bins"],
                          device=x.device)
    x = nnf.softmax(x, dim=-1)
    x = torch.sum(x * bins, dim=-1, keepdim=True)
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def linear(x, p, prec):
    return prec.dot(x, p["w"]) + p["b"]


def layer_norm(x, p):
    return nnf.layer_norm(x, (x.shape[-1],), p["ln_w"], p["ln_b"], 1e-5)


def normed_linear(x, p, prec):
    return nnf.mish(layer_norm(linear(x, p, prec), p))


def mlp_hidden(x, layers, prec):
    x = normed_linear(x, layers["fc0"], prec)
    return normed_linear(x, layers["fc1"], prec)


def task_emb(params, x, task):
    """[x, the task's embedding row] (nn.Embedding with max_norm 1)."""
    row = params["task"]["emb"][task]
    norm = torch.linalg.vector_norm(row)
    row = torch.where(norm > 1.0, row * (1.0 / (norm + 1e-7)), row)
    return torch.cat([x, row.expand(x.shape[0], -1)], dim=-1)


def action_mask(m, device):
    mask = torch.zeros((m["action_dim"],), device=device)
    mask[:m["task_action_dim"]] = 1.0
    return mask


def encode(params, frames, m, prec):
    """(F, S, S, 3) RGB frames, oldest first -> (1, latent)."""
    side = frames.shape[1]
    x = frames.permute(0, 3, 1, 2).reshape(1, -1, side, side).float()
    x = x.div(255.0).sub(0.5)
    for i, (_, stride) in enumerate(CONVS):
        p = params["enc"][f"conv{i}"]
        x = prec.conv(x, p["w"], stride) + p["b"][None, :, None, None]
        if i < len(CONVS) - 1:
            x = torch.relu(x)
    x = x.flatten(1)
    return simnorm(linear(x, params["enc"]["proj"], prec), m["simnorm_dim"])


def next_latent(params, z, a, task, m, prec):
    x = torch.cat([task_emb(params, z, task), a], dim=-1)
    p = params["dyn"]
    x = layer_norm(linear(mlp_hidden(x, p, prec), p["out"], prec), p["out"])
    return simnorm(x, m["simnorm_dim"])


def reward(params, z, a, task, m, prec):
    x = torch.cat([task_emb(params, z, task), a], dim=-1)
    p = params["rew"]
    return two_hot_inv(linear(mlp_hidden(x, p, prec), p["out"], prec), m)


def pi(params, z, task, eps, m, prec):
    """The policy prior's sampled action, tanh-squashed and masked."""
    x = task_emb(params, z, task)
    p = params["pi"]
    mu, log_std = linear(mlp_hidden(x, p, prec), p["out"], prec) \
        .chunk(2, dim=-1)
    low = m["log_std_min"]
    dif = m["log_std_max"] - m["log_std_min"]
    log_std = low + 0.5 * dif * (torch.tanh(log_std) + 1)
    mask = action_mask(m, z.device)
    mu, log_std, eps = mu * mask, log_std * mask, eps * mask
    return torch.tanh(mu + eps * log_std.exp())


def q_avg(params, z, a, task, heads, m, prec):
    """The mean of the two Q heads `heads` (ints), each two-hot read."""
    x = torch.cat([task_emb(params, z, task), a], dim=-1)
    out = []
    for k in heads:
        p = {name: {key: v[k] for key, v in layer.items()}
             for name, layer in params["q"].items()}
        out.append(two_hot_inv(
            linear(mlp_hidden(x, p, prec), p["out"], prec), m))
    return (out[0] + out[1]) / 2


def estimate_value(params, z, actions, task, heads, eps, m, prec):
    g, discount = 0, 1.0
    for t in range(m["horizon"]):
        r = reward(params, z, actions[t], task, m, prec)
        z = next_latent(params, z, actions[t], task, m, prec)
        g = g + discount * r
        discount *= m["discount"]
    a = pi(params, z, task, eps, m, prec)
    return g + discount * q_avg(params, z, a, task, heads, m, prec)


def plan(params, z, warm, d, task, m, prec, pick_elites=None,
         pick_choice=None):
    """One planning step from the latent z (1, L) and the warm-start mean
    `warm` (H, A) (zeros at an episode's first step) with the draws `d`:
    {"action", "values" (the first round's (N,)), "mean", "std", "elites"
    (rounds, E), "choice"}.

    pick_elites(round, values (N,), own top-k indices) and
    pick_choice(keys (E,), own index) may replace the planner's own
    selection (the benchmark follows a program's choice where the values
    it rests on agree within its tolerance); by default the planner takes
    its own."""
    no_tf32()
    h, n, p, a = (m["horizon"], m["num_samples"], m["num_pi_trajs"],
                  m["action_dim"])
    mask = action_mask(m, z.device)
    pi_actions = torch.empty((h, p, a), device=z.device)
    zp = z.repeat(p, 1)
    for t in range(h - 1):
        pi_actions[t] = pi(params, zp, task, d["prior_eps"][t], m, prec)
        zp = next_latent(params, zp, pi_actions[t], task, m, prec)
    pi_actions[-1] = pi(params, zp, task, d["prior_eps"][-1], m, prec)

    z = z.repeat(n, 1)
    mean = warm.clone()
    std = m["max_std"] * torch.ones((h, a), device=z.device)
    actions = torch.empty((h, n, a), device=z.device)
    actions[:, :p] = pi_actions
    pairs = torch.argsort(d["q_keys"], dim=1)[:, :2].tolist()
    values, elites = None, []
    for i in range(m["iterations"]):
        actions[:, p:] = (mean.unsqueeze(1) + std.unsqueeze(1)
                          * d["sample_eps"][i]).clamp(-1, 1)
        actions = actions * mask
        value = estimate_value(params, z, actions, task, pairs[i],
                               d["pi_eps"][i], m, prec).nan_to_num_(0)
        if values is None:
            values = value[:, 0].clone()
        elite_idxs = torch.topk(value.squeeze(1), m["num_elites"],
                                dim=0).indices
        if pick_elites is not None:
            elite_idxs = pick_elites(i, value[:, 0], elite_idxs)
        elite_value, elite_actions = value[elite_idxs], actions[:, elite_idxs]
        max_value = elite_value.max(0)[0]
        score = torch.exp(m["temperature"] * (elite_value - max_value))
        score = score / score.sum(0)
        mean = torch.sum(score.unsqueeze(0) * elite_actions, dim=1) \
            / (score.sum(0) + 1e-9)
        std = torch.sqrt(torch.sum(
            score.unsqueeze(0) * (elite_actions - mean.unsqueeze(1)) ** 2,
            dim=1) / (score.sum(0) + 1e-9)).clamp(m["min_std"], m["max_std"])
        mean, std = mean * mask, std * mask
        elites.append(elite_idxs)
    keys = torch.log(score.squeeze(1)) - torch.log(d["exp"])
    choice = int(torch.argmax(keys))
    if pick_choice is not None:
        choice = pick_choice(keys, choice)
    return {"action": elite_actions[0, choice].clamp(-1, 1),
            "values": values, "mean": mean, "std": std,
            "elites": torch.stack(elites), "choice": choice}


def warm_start(mean):
    """The next step's start: mean[:-1] = the last mean[1:], mean[-1] = 0."""
    out = torch.zeros_like(mean)
    out[:-1] = mean[1:]
    return out

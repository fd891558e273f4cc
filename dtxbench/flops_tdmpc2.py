"""Operations of a TD-MPC2 planning step, counted from the shapes
(configs/tdmpc2_317m.json; reference/tdmpc2.py's flat dict): 2 x rows x in
x out for each dense layer and 2 x outputs x in x k^2 for each conv, as
the step runs them.  LayerNorm, Mish, SimNorm, the softmaxes and the
planner's statistics are not counted.  The shares are against
dtxbench.flops' bfloat16 peak: the dense layers take bf16-rounded operands
into float32 sums, which a bf16 tensor-core GEMM computes exactly.
"""

from __future__ import annotations

CONVS = ((7, 2), (5, 2), (3, 2), (3, 1))


def mlp_flops(m: dict, d_in: int, d_out: int) -> int:
    """One row through an MLP: d_in -> mlp_dim -> mlp_dim -> d_out."""
    h = m["mlp_dim"]
    return 2 * (d_in * h + h * h + h * d_out)


def encoder_flops(m: dict) -> int:
    """One stack of frames through the pixel encoder and its Linear to the
    latent."""
    total, c_in, side = 0, 3 * m["frames"], m["image_size"]
    for k, s in CONVS:
        side = (side - k) // s + 1
        total += 2 * side * side * m["num_channels"] * c_in * k * k
        c_in = m["num_channels"]
    return total + 2 * c_in * side * side * m["latent_dim"]


def step_flops(m: dict) -> int:
    """One control step: the encode; the prior's H policy calls and H - 1
    dynamics calls on num_pi_trajs rows; each round's H rewards and
    dynamics calls, the terminal policy call and the two Q heads on
    num_samples rows."""
    h = m["horizon"]
    zta = m["latent_dim"] + m["task_dim"] + m["action_dim"]
    zt = m["latent_dim"] + m["task_dim"]
    dyn = mlp_flops(m, zta, m["latent_dim"])
    head = mlp_flops(m, zta, m["num_bins"])
    pi = mlp_flops(m, zt, 2 * m["action_dim"])
    prior = m["num_pi_trajs"] * (h * pi + (h - 1) * dyn)
    rounds = m["iterations"] * m["num_samples"] * (h * (dyn + head) + pi
                                                   + 2 * head)
    return encoder_flops(m) + prior + rounds

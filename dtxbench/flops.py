"""Operations and bytes of the work, counted from the shapes, and the
published peaks they are held to.

Peaks: one NVIDIA H100 SXM (the data sheet's dense rates, at its 700 W
limit): 989e12 FLOP/s in bfloat16 on the tensor cores, 3.35e12 B/s of
HBM3.  The visual-MPC model's dense layers take bfloat16-rounded operands
into float32 sums, which a bfloat16 tensor-core GEMM with float32
accumulation computes exactly, so its shares are against the bfloat16
peak.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# A BC7 block is 16 bytes in; an RGBA8 block is 64 bytes out.
BC7_BLOCK_BYTES = 16
RGBA8_BLOCK_BYTES = 64


def encoder_flops(d: dict) -> int:
    """One image through the encoder: each stride-2 3x3 conv (2 x outputs
    x input channels x 9) and proj (2 x flat x latent)."""
    total, c_in, size = 0, d["channels"], d["image_size"]
    for c_out in d["conv_features"]:
        size //= 2
        total += 2 * size * size * c_out * c_in * 9
        c_in = c_out
    return total + 2 * size * size * c_in * d["latent_dim"]


def dynamics_flops(d: dict) -> int:
    """One transition through the dynamics MLP."""
    dims = ([d["latent_dim"] + d["action_dim"]]
            + [d["hidden_dim"]] * d["n_dynamics_layers"] + [d["latent_dim"]])
    return sum(2 * a * b for a, b in zip(dims, dims[1:]))


def rollout_flops(d: dict, m: dict) -> int:
    """The MPPI rollouts of one control step: K x H dynamics steps."""
    return m["n_rollouts"] * m["horizon"] * dynamics_flops(d)


def control_step_flops(d: dict, m: dict) -> int:
    """One control step: the observation's encode and the rollouts."""
    return encoder_flops(d) + rollout_flops(d, m)


def train_flops_per_sample(d: dict) -> int:
    """One transition of a train step: both encodes and the dynamics
    forward, and twice the forward of what gets gradients (the obs encode
    and the dynamics) backward."""
    fwd = 2 * encoder_flops(d) + dynamics_flops(d)
    return fwd + 2 * (encoder_flops(d) + dynamics_flops(d))


def texture_least_s(n_blocks: int) -> float:
    """The least time a BC7 -> RGBA8 texture of n_blocks can take: each
    block read once and its pixels written once, at HBM's rate."""
    return n_blocks * (BC7_BLOCK_BYTES + RGBA8_BLOCK_BYTES) / HBM_BYTES_PER_S

"""Visual-MPC runtime: decode -> encode -> plan control step.

Counterpart of detex_tpu/mpc/runtime.py.  Observations arrive as BC7
blocks; one control step decodes them on the device (the CUDA BC7 kernel
for CUDA tensors), encodes the image to the latent and runs one MPPI
update, with no host round trip inside the step.

Not ported yet: iLQR refinement (n_ilqr_iterations > 0 raises), the
sharded rollouts (ControllerConfig has no rollout_axis), PipelinedController
and the batched decode (decode_obs_batch, unpack_rgba8_images).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import mppi as mppi_mod
from detex_tpu_torch.ops import bptc


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    dynamics: D.DynamicsConfig = D.DynamicsConfig()
    mppi: mppi_mod.MPPIConfig = mppi_mod.MPPIConfig()
    n_ilqr_iterations: int = 0     # iLQR is not ported: must stay 0
    goal_weight: float = 1.0
    control_weight: float = 0.1


def unpack_rgba8_image(packed: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """(N_blocks, 16) packed RGBA8 int32 -> (H, W, 4) int32 0..255.
    Blocks are in row-major block order, pixels row-major in a block."""
    hb, wb = height // 4, width // 4
    img = packed.reshape(hb, wb, 4, 4).permute(0, 2, 1, 3) \
        .reshape(height, width)
    # `>>` is arithmetic on int32; the mask drops the copied sign bits.
    return torch.stack([img & 0xFF, (img >> 8) & 0xFF, (img >> 16) & 0xFF,
                        (img >> 24) & 0xFF], dim=-1)


def decode_obs(words: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """BC7 block words (N, 4) -> (H, W, 4) int32 image with values
    0..255, decoded on the words' device."""
    pix, _ = bptc.decode_bptc(words)
    return unpack_rgba8_image(pix, height, width)


def latent_cost_fn(goal_z: torch.Tensor, cfg: ControllerConfig):
    """Quadratic latent-goal cost for the planner."""
    def cost(z, u, t):
        return (cfg.goal_weight * torch.sum((z - goal_z[None]) ** 2, dim=-1)
                + cfg.control_weight * torch.sum(u ** 2, dim=-1))
    return cost


def _check_supported(cfg: ControllerConfig) -> None:
    if cfg.n_ilqr_iterations > 0:
        raise NotImplementedError("iLQR refinement is not ported yet")


def control_step(params, nominal, generator, obs_words, goal_z,
                 cfg: ControllerConfig, *, eps=None):
    """One full control step: decode BC7 obs -> encode -> MPPI update ->
    (action u_0 (A,), shifted nominal (H, A), diagnostics).

    The MPPI noise comes from `generator` unless `eps` (K, H, A) is
    given."""
    _check_supported(cfg)
    dcfg = cfg.dynamics
    img = decode_obs(obs_words, dcfg.image_size, dcfg.image_size)
    z0 = D.encode(params, img[None].to(torch.uint8), dcfg)[0]

    def dyn_batched(z, u):
        return D.dynamics_apply(params, z, u, dcfg)

    new_nominal, diag = mppi_mod.mppi_step(
        nominal, z0, dyn_batched, latent_cost_fn(goal_z, cfg), cfg.mppi,
        eps=eps, generator=generator)
    action = new_nominal[0]
    shifted = mppi_mod.receding_horizon_shift(new_nominal)
    return action, shifted, diag


class Controller:
    """Serves control_step one observation at a time on `device`, keeping
    the nominal plan and a seeded generator between steps."""

    def __init__(self, params, goal_z: torch.Tensor, cfg: ControllerConfig,
                 seed: int = 0, device="cpu"):
        _check_supported(cfg)
        self.device = torch.device(device)
        self.params = params
        self.goal_z = goal_z.to(self.device)
        self.cfg = cfg
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                                   dtype=torch.float32, device=self.device)
        self.diag = None

    @torch.inference_mode()
    def step(self, obs_words) -> np.ndarray:
        """(N_blocks, 4) int32 BC7 words (numpy or tensor) -> (A,) action."""
        words = torch.as_tensor(obs_words, dtype=torch.int32) \
            .to(self.device).contiguous()
        action, self.nominal, self.diag = control_step(
            self.params, self.nominal, self.generator, words, self.goal_z,
            self.cfg)
        return action.cpu().numpy()

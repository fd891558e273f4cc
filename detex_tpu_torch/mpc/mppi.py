"""MPPI (Model Predictive Path Integral) sampling MPC, single device.

Counterpart of detex_tpu/mpc/mppi.py.  K rollouts of horizon H are
evaluated as one batch per time step:

    u*_t = sum_k w_k c_k,t / sum_k w_k,   w_k = exp(-(S_k - min S)/T)

The JAX package's sharded paths (rollout_axis, mesh) are not ported yet;
asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    n_rollouts: int = 8192
    horizon: int = 32
    action_dim: int = 8
    temperature: float = 1.0
    noise_sigma: float = 0.3
    action_low: float = -1.0
    action_high: float = 1.0


def rollout_costs(dynamics: Callable, cost: Callable, z0: torch.Tensor,
                  controls: torch.Tensor,
                  terminal_cost: Optional[Callable] = None) -> torch.Tensor:
    """Per-rollout trajectory costs.

    dynamics: (z, u) -> z'       batched over the leading axis
    cost:     (z, u, t) -> (K,)  stage costs
    z0: (latent,) or (K, latent); controls: (K, H, action_dim).
    Returns (K,) float32 total costs."""
    k, h = controls.shape[:2]
    z = z0.expand(k, -1) if z0.dim() == 1 else z0
    total = torch.zeros((k,), dtype=torch.float32, device=controls.device)
    for t in range(h):
        u = controls[:, t]
        total = total + cost(z, u, t)
        z = dynamics(z, u)
    if terminal_cost is not None:
        total = total + terminal_cost(z)
    return total


def _mppi_update(eps, nominal, z0, dynamics, cost, cfg: MPPIConfig,
                 terminal_cost, n_total: int):
    """MPPI update of `nominal` (H, A) from the noise `eps` (K, H, A);
    n_total is the rollout count the mean cost divides by.  Returns
    (new_nominal (H, A), diagnostics dict of 0-d tensors)."""
    controls = torch.clamp(nominal[None] + eps, cfg.action_low,
                           cfg.action_high)
    costs = rollout_costs(dynamics, cost, z0, controls, terminal_cost)
    beta = torch.min(costs)
    w = torch.exp(-(costs - beta) / cfg.temperature)
    # Weighted average of the *clipped* perturbed controls.
    weighted = torch.einsum("k,kha->ha", w, controls)
    w_sum = torch.sum(w)
    w2_sum = torch.sum(w * w)
    new_nominal = weighted / w_sum
    diagnostics = {
        "min_cost": beta,
        "mean_cost": torch.sum(costs) / n_total,
        "ess": (w_sum * w_sum) / w2_sum,
    }
    return new_nominal, diagnostics


def mppi_step(nominal: torch.Tensor, z0: torch.Tensor, dynamics: Callable,
              cost: Callable, cfg: MPPIConfig, *,
              terminal_cost: Optional[Callable] = None,
              eps: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              rollout_axis=None, mesh=None):
    """One MPPI update of the nominal control sequence (H, A).

    The noise is `eps` (K, H, A) when given, else randn(K, H, A) * sigma
    drawn from `generator` on nominal's device.  Returns (new_nominal,
    diagnostics)."""
    if rollout_axis is not None or mesh is not None:
        raise NotImplementedError(
            "sharded MPPI (rollout_axis / mesh) is not ported yet")
    h, a = nominal.shape
    if eps is None:
        eps = torch.randn((cfg.n_rollouts, h, a), generator=generator,
                          dtype=torch.float32,
                          device=nominal.device) * cfg.noise_sigma
    return _mppi_update(eps, nominal, z0, dynamics, cost, cfg,
                        terminal_cost, cfg.n_rollouts)


def receding_horizon_shift(nominal: torch.Tensor) -> torch.Tensor:
    """Shift the plan one step: drop u_0, repeat the last action."""
    return torch.cat([nominal[1:], nominal[-1:]], dim=0)

"""MPPI (Model Predictive Path Integral) sampling MPC, batched and sharded.

Counterpart of detex_tpu/mpc/mppi.py.  K rollouts of horizon H are
evaluated as one batch per time step:

    u*_t = sum_k w_k c_k,t / sum_k w_k,   w_k = exp(-(S_k - min S)/T)

Multi-rank (`mppi_step(..., rollout_axis="dp", mesh=mesh)`, the JAX
package's shard_map path): every rank rolls out its K/n shard of the
rollouts; the baseline min S is an all_reduce MIN over the axis, and the
weighted controls and the three weight and cost sums go in one
all_reduce SUM of H*A + 3 floats.  A tuple axis such as ("dcn", "ici")
reduces innermost first.  The noise is always drawn whole from the
caller's generator (seeded alike on every rank), so the plan does not
depend on the rank count (only the reduction order differs).  JAX's
GSPMD form (rollout_axis without a mesh) has no counterpart: the port
needs the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from detex_tpu_torch.parallel import mesh as mesh_mod


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


def draw_noise(eps: torch.Tensor, generator, sigma: float) -> torch.Tensor:
    """The rollouts' noise randn(K, H, A) * sigma from `generator`, drawn
    into `eps` in place: mppi_step draws it so, and the captured step
    (runtime._StepProgram) into its static buffer before each step."""
    torch.randn(eps.shape, generator=generator, out=eps)
    return eps.mul_(sigma)


def _mppi_update(eps, nominal, z0, dynamics, cost, cfg: MPPIConfig,
                 terminal_cost, n_total: int, axis=None, mesh=None):
    """MPPI update of `nominal` (H, A) from the noise `eps` (K, H, A);
    n_total is the rollout count the mean cost divides by.  Returns
    (new_nominal (H, A), diagnostics dict of 0-d tensors).

    With `axis` (a mesh axis name or a tuple of them) eps holds this rank's
    rollouts, and every reduction pairs with a collective over `axis` of
    `mesh`, innermost axis first."""
    controls = torch.clamp(nominal[None] + eps, cfg.action_low,
                           cfg.action_high)
    costs = rollout_costs(dynamics, cost, z0, controls, terminal_cost)
    beta = torch.min(costs)
    if axis is not None:
        beta = mesh_mod.all_reduce(beta, mesh, axis, "min")
    w = torch.exp(-(costs - beta) / cfg.temperature)
    # Weighted average of the *clipped* perturbed controls.
    weighted = torch.einsum("k,kha->ha", w, controls)
    w_sum = torch.sum(w)
    w2_sum = torch.sum(w * w)
    cost_sum = torch.sum(costs)
    if axis is not None:
        packed = mesh_mod.all_reduce(torch.cat([
            weighted.reshape(-1), torch.stack([w_sum, w2_sum, cost_sum])]),
            mesh, axis)
        weighted = packed[:-3].reshape(weighted.shape)
        w_sum, w2_sum, cost_sum = packed[-3:].unbind()
    new_nominal = weighted / w_sum
    diagnostics = {
        "min_cost": beta,
        "mean_cost": cost_sum / n_total,
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
    diagnostics).

    rollout_axis=None     : one rank's program (a mesh is not used).
    rollout_axis + mesh   : each rank rolls out its K/n rows of the noise
                            along `rollout_axis` of `mesh` (a name or a
                            tuple such as ("dcn", "ici")) and the
                            reductions are collectives; every rank
                            returns the same update.  K not divisible by
                            the axes' size raises ValueError.
    rollout_axis, no mesh : ValueError (JAX's GSPMD form needs an ambient
                            mesh, which torch has not)."""
    h, a = nominal.shape
    if rollout_axis is not None:
        if mesh is None:
            raise ValueError(
                f"rollout_axis={rollout_axis!r} needs a mesh: the port has "
                "no counterpart of the JAX package's GSPMD form (pass "
                "mesh=parallel.make_mesh(...))")
        n_shards = mesh_mod.axis_size(mesh, rollout_axis)
        if cfg.n_rollouts % n_shards:
            raise ValueError(
                f"n_rollouts={cfg.n_rollouts} not divisible by mesh axes "
                f"{rollout_axis!r} total size {n_shards}")
    if eps is None:
        eps = draw_noise(torch.empty((cfg.n_rollouts, h, a),
                                     dtype=torch.float32,
                                     device=nominal.device),
                         generator, cfg.noise_sigma)
    if rollout_axis is None:
        return _mppi_update(eps, nominal, z0, dynamics, cost, cfg,
                            terminal_cost, cfg.n_rollouts)
    return _mppi_update(mesh_mod.shard_batch(eps, mesh, rollout_axis),
                        nominal, z0, dynamics, cost, cfg, terminal_cost,
                        cfg.n_rollouts, axis=rollout_axis, mesh=mesh)


def receding_horizon_shift(nominal: torch.Tensor) -> torch.Tensor:
    """Shift the plan one step: drop u_0, repeat the last action."""
    return torch.cat([nominal[1:], nominal[-1:]], dim=0)

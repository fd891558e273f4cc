"""iLQR trajectory optimizer.

Counterpart of detex_tpu/mpc/ilqr.py:30-163.  Refines an MPPI plan with a
few Gauss-Newton iterations:

  linearize : per-step jacobians and cost derivatives along the
              trajectory, by torch.func (vmap of jacfwd, grad, hessian)
  backward  : Riccati recursion, either a reverse loop over the horizon
              (Cholesky of quu + reg I) or the log-depth parallel LQT of
              parallel_lqr.py (parallel=True)
  forward   : every line-search step length rolls out together, as one
              batch of len(alphas) trajectories

Nothing reads a value back to the host: the accept/reject test and the
regularisation update are tensor selects, and the factorisations use the
`_ex` forms (a failed Cholesky gives NaN gains, as jax.scipy's cho_factor
does, and so a rejected step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad, hessian, jacfwd, vmap

from detex_tpu_torch.mpc import parallel_lqr as PL


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    n_iterations: int = 5
    reg_init: float = 1e-6
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)
    # Solve each Gauss-Newton subproblem with the log-depth parallel LQT
    # instead of the sequential reverse loop.
    parallel: bool = False


def _rollout(dynamics, x0, us):
    """States (H+1, n) of the controls us (H, m) from x0."""
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(dynamics(xs[-1], us[t]))
    return torch.stack(xs)


def trajectory_cost(cost, terminal_cost, xs, us):
    ts = torch.arange(us.shape[0], device=us.device)
    return torch.sum(vmap(cost)(xs[:-1], us, ts)) + terminal_cost(xs[-1])


def linearize(dynamics, cost, terminal_cost, xs, us):
    """Jacobians and cost derivatives along (xs (H+1, n), us (H, m)):
    (fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T), in the states' dtype
    (torch's forward mode gives a float64 tangent where a Python float
    scales a 0-d tensor)."""
    ts = torch.arange(us.shape[0], device=us.device)
    x = xs[:-1]
    fx, fu = vmap(jacfwd(dynamics, argnums=(0, 1)))(x, us)
    lx, lu = vmap(grad(cost, argnums=(0, 1)))(x, us, ts)
    lxx = vmap(hessian(cost, argnums=0))(x, us, ts)
    luu = vmap(hessian(cost, argnums=1))(x, us, ts)
    lux = vmap(jacfwd(grad(cost, argnums=1), argnums=0))(x, us, ts)
    vx_t = grad(terminal_cost)(xs[-1])
    vxx_t = hessian(terminal_cost)(xs[-1])
    return tuple(d.to(xs.dtype) for d in (fx, fu, lx, lu, lxx, luu, lux,
                                          vx_t, vxx_t))


def backward(fx, fu, lx, lu, lxx, luu, lux, vx_t, vxx_t, reg):
    """Sequential Riccati backward pass: gains (ks (H, m), bigks (H, m, n))
    of u = u_ref + alpha k + K (x - x_ref).  `reg` is a 0-d tensor."""
    h, _, m = fu.shape
    eye = torch.eye(m, dtype=fu.dtype, device=fu.device)
    vx, vxx = vx_t, vxx_t
    ks, bigks = [None] * h, [None] * h
    for t in reversed(range(h)):
        fx_t, fu_t = fx[t], fu[t]
        qx = lx[t] + fx_t.T @ vx
        qu = lu[t] + fu_t.T @ vx
        qxx = lxx[t] + fx_t.T @ vxx @ fx_t
        quu = luu[t] + fu_t.T @ vxx @ fu_t
        qux = lux[t] + fu_t.T @ vxx @ fx_t
        chol, info = torch.linalg.cholesky_ex(quu + reg * eye)
        chol = torch.where(info == 0, chol, torch.nan)
        k_t = -torch.cholesky_solve(qu[:, None], chol)[:, 0]
        bigk_t = -torch.cholesky_solve(qux, chol)
        vx = qx + bigk_t.T @ quu @ k_t + bigk_t.T @ qu + qux.T @ k_t
        vxx = qxx + bigk_t.T @ quu @ bigk_t + bigk_t.T @ qux \
            + qux.T @ bigk_t
        vxx = 0.5 * (vxx + vxx.T)
        ks[t], bigks[t] = k_t, bigk_t
    return torch.stack(ks), torch.stack(bigks)


def backward_parallel(fx, fu, lx, lu, lxx, luu, lux, vx_t, vxx_t, reg):
    """Log-depth backward: the subproblem is an LQT with Q=lxx, q=lx,
    R=luu+reg I, r=lu, M=lux, c=0 in deviation variables.  Same gains as
    `backward`."""
    h, n, m = fu.shape
    r_reg = luu + reg * torch.eye(m, dtype=fu.dtype, device=fu.device)
    zeros_c = fx.new_zeros((h, n))
    p_all, eta_all = PL.lqt_backward_parallel(
        fx, fu, zeros_c, lxx, lx, r_reg, lu, lux, vxx_t, vx_t)
    bigk, kff = PL.lqt_gains(fx, fu, zeros_c, r_reg, lu, lux, p_all[1:],
                             eta_all[1:])
    return -kff, -bigk


def _forward(dynamics_v, x0, xs_ref, us_ref, ks, bigks, alphas):
    """Roll out every step length at once: (A, H+1, n) states and
    (A, H, m) controls for the A entries of `alphas`."""
    x = x0.expand(alphas.shape[0], -1)
    xs, us = [x], []
    for t in range(us_ref.shape[0]):
        u = us_ref[t] + alphas[:, None] * ks[t] \
            + (x - xs_ref[t]) @ bigks[t].T
        x = dynamics_v(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def ilqr_solve(dynamics: Callable, cost: Callable, terminal_cost: Callable,
               x0: torch.Tensor, us_init: torch.Tensor,
               cfg: ILQRConfig = ILQRConfig()):
    """Iterative LQR.

    dynamics: (x, u) -> x'        (single trajectory, unbatched)
    cost: (x, u, t) -> scalar;    terminal_cost: (x,) -> scalar
    Returns (xs (H+1, n), us (H, m), total_cost 0-d tensor)."""
    dynamics_v = vmap(dynamics)
    traj_cost_v = vmap(lambda xs, us: trajectory_cost(cost, terminal_cost,
                                                      xs, us))
    bwd = backward_parallel if cfg.parallel else backward

    def const(v):
        # A fill kernel, not torch.tensor(v, device=...): a copy from the
        # host would wait for the device.
        return us_init.new_full((), v)

    alphas = torch.stack([const(a) for a in cfg.alphas])
    xs = _rollout(dynamics, x0, us_init)
    us = us_init
    total = trajectory_cost(cost, terminal_cost, xs, us)
    reg = const(cfg.reg_init)
    for _ in range(cfg.n_iterations):
        ks, bigks = bwd(*linearize(dynamics, cost, terminal_cost, xs, us),
                        reg)
        xs_all, us_all = _forward(dynamics_v, x0, xs, us, ks, bigks, alphas)
        costs = traj_cost_v(xs_all, us_all)
        # index_select keeps the pick on the device, with no host read.
        best = torch.argmin(costs).reshape(1)
        best_cost = costs.index_select(0, best)[0]
        improved = best_cost < total
        xs = torch.where(improved, xs_all.index_select(0, best)[0], xs)
        us = torch.where(improved, us_all.index_select(0, best)[0], us)
        total = torch.where(improved, best_cost, total)
        reg = torch.where(improved, torch.clamp(reg * 0.5, min=1e-9),
                          reg * 10.0)
    return xs, us, total

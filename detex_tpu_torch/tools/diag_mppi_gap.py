"""The sharded against the unsharded MPPI step at one rank: the
counterpart of tools/diag_mppi_gap.py.

    python -m detex_tpu_torch.tools.diag_mppi_gap [--device cpu]

Times the same MPPI solve (8192 rollouts x H = 32 over the latent-128,
hidden-512 bf16 dynamics) as

  unsharded : mppi_step(rollout_axis=None)
  sharded   : mppi_step(rollout_axis="dp", mesh=a one-rank mesh)

by the same method (tools.time_ms: CUDA events on a card).  At one rank
the two do the same arithmetic, so any gap is the sharded program's own
overhead: the noise slice, the packed all_reduce buffer and the
collectives (NCCL on a card).  The JAX tool's third row, GSPMD, has no
counterpart.  Prints one JSON line per variant.
"""

from __future__ import annotations

import argparse
import json

import torch

from detex_tpu_torch import graphs, tools
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import mppi
from detex_tpu_torch.parallel import mesh as mesh_mod

VARIANTS = ("unsharded", "sharded")


def solve(device: torch.device, variant: str, n_rollouts: int = 8192,
          horizon: int = 32, program: str = "eager"):
    """A function that runs one MPPI solve of `variant` and returns the
    new nominal; on a mesh of every rank for "sharded".  program="graph"
    (a card; for "sharded" an NCCL mesh): the solve is captured once as a
    CUDA graph (graphs.Graph) on a static noise buffer, and each call
    draws the noise into it from the same generator (mppi.draw_noise, as
    mppi_step draws it) and replays; the result is the graph's output,
    which the next call overwrites."""
    cfg = mppi.MPPIConfig(n_rollouts=n_rollouts, horizon=horizon,
                          action_dim=8)
    dcfg = D.DynamicsConfig(latent_dim=128, action_dim=8, hidden_dim=512)
    generator = torch.Generator(device=device).manual_seed(0)
    params = D.init_params(dcfg, generator, device)
    z0 = torch.zeros((dcfg.latent_dim,), device=device)
    goal = torch.ones((dcfg.latent_dim,), device=device)
    nominal = torch.zeros((cfg.horizon, cfg.action_dim), device=device)
    mesh = (mesh_mod.make_mesh(device=device) if variant == "sharded"
            else None)

    def dyn(z, u):
        return D.dynamics_apply(params, z, u, dcfg)

    def cost(z, u, t):
        return torch.sum((z - goal) ** 2, dim=-1) \
            + 0.1 * torch.sum(u ** 2, dim=-1)

    @torch.no_grad()
    def run(eps=None):
        return mppi.mppi_step(nominal, z0, dyn, cost, cfg, eps=eps,
                              generator=generator,
                              rollout_axis="dp" if mesh else None,
                              mesh=mesh)[0]
    if program == "eager":
        return run
    eps = torch.zeros((cfg.n_rollouts, cfg.horizon, cfg.action_dim),
                      device=device)
    graph = graphs.Graph(device)
    graph.capture(lambda: run(eps))

    def replay():
        mppi.draw_noise(eps, generator, cfg.noise_sigma)
        return graph.replay()
    return replay


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tools.device_arg(ap)
    ap.add_argument("--rollouts", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    rows = []
    for variant in args.variants:
        fn = solve(device, variant, args.rollouts, args.horizon)
        ms = tools.time_ms(fn, device, reps=args.reps, inner=5)
        row = {"variant": variant, "ms_per_solve": ms,
               "solves_per_s": 1e3 / ms, "n_rollouts": args.rollouts,
               "horizon": args.horizon, "device": tools.device_name(device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

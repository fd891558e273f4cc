"""MPPI solves/s against the rank count: the counterpart of
tools/bench_scaling.py.

    python -m detex_tpu_torch.tools.bench_scaling [--ranks 1,2,4]
        [--device cpu] [--lqt]

Launches 1, 2 and 4 ranks (parallel.launch.run_ranks) with the SAME global
batch (strong scaling): the rollout-sharded MPPI step (8192 rollouts,
H = 32, latent-128 MLP dynamics, bf16 on a card) over "dp", or with
--lqt the horizon-sharded parallel-LQT backward over "sp".  Each rank
times the step with tools.time_ms (CUDA events on a card); rank 0's time
is reported, with solves/s and the efficiency against linear scaling.

Ranks take one card each over NCCL while there are cards enough; more
ranks than cards share them over gloo (NCCL takes one rank per card).
So on one card, as the JAX tool says of its virtual CPU mesh, the ranks
share one device and solves/s cannot improve with n: the run measures
the overhead of partitioning (efficiency 1.0 means the sharded program
wastes nothing against the unsharded one on equal silicon), with gloo's
host copies in it.  NCCL rows are timed twice, with a "program" key as
the other benches have: "graph", the step captured as one CUDA graph with
its collectives (graphs.Graph; the MPPI noise drawn outside it, the LQT's
LU on cuSOLVER/cuBLAS, runtime._capturable_linalg), and "eager"; gloo
rows, which a capture cannot hold, are "eager" only.  Prints one JSON line
per row, then a summary.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detex_tpu_torch import graphs, tools
from detex_tpu_torch.mpc import parallel_lqr as plqr
from detex_tpu_torch.mpc import runtime
from detex_tpu_torch.parallel import launch
from detex_tpu_torch.parallel import mesh as mesh_mod
from detex_tpu_torch.tools import diag_mppi_gap


def _lqt_problem(h: int, n: int, m: int, device):
    rng = np.random.default_rng(0)
    arrays = (np.eye(n) + 0.02 * rng.standard_normal((h, n, n)),
              0.2 * rng.standard_normal((h, n, m)),
              0.1 * rng.standard_normal((h, n)),
              np.broadcast_to(np.eye(n), (h, n, n)),
              rng.standard_normal((h, n)),
              np.broadcast_to(np.eye(m), (h, m, m)),
              rng.standard_normal((h, m)), np.zeros((h, m, n)),
              2.0 * np.eye(n), rng.standard_normal(n))
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                              device=device) for a in arrays)


def _lqt(device, args: dict, program: str):
    """One horizon-sharded LQT backward over "sp", eager or as the replay
    of its captured graph."""
    prob = _lqt_problem(args["lqt_horizon"], args["state_dim"],
                        args["action_dim"], device)
    mesh = mesh_mod.make_mesh(None, ("sp",), device=device)

    def fn():
        return plqr.lqt_backward_parallel_sharded(*prob, mesh=mesh,
                                                  axis="sp")
    if program == "eager":
        return fn
    graph = graphs.Graph(device)
    with runtime._capturable_linalg():
        graph.capture(fn)
    return graph.replay


def _rank(rank, device_name: str, args: dict, programs) -> dict:
    """This rank's ms and collective bytes a call, by program."""
    device = tools.open_device(device_name)
    out = {}
    for program in programs:
        if args["lqt"]:
            fn = _lqt(device, args, program)
        else:
            fn = diag_mppi_gap.solve(device, "sharded", args["rollouts"],
                                     args["horizon"], program)
        mesh_mod.reset_collective_bytes()
        fn()
        per_call = sum(mesh_mod.COLLECTIVE_BYTES.values())
        out[program] = {
            "ms": tools.time_ms(fn, device, reps=args["reps"], inner=5),
            "collective_bytes_per_call": per_call}
    return out


def run(counts, device: str, args: dict) -> list:
    """Rank 0's results at each rank count: on NCCL a "graph" and an
    "eager" row, on gloo an "eager" row."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    rows = []
    for n in counts:
        backend = "nccl" if 0 < n <= cards else "gloo"
        programs = ("graph", "eager") if backend == "nccl" else ("eager",)
        out = launch.run_ranks(_rank, n, (device, args, programs),
                               device=device, backend=backend,
                               timeout=args["timeout"])[0]
        rows += [dict(out[p], ranks=n, backend=backend, program=p)
                 for p in programs]
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tools.device_arg(ap)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--rollouts", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--lqt", action="store_true",
                    help="the horizon-sharded parallel-LQT backward "
                         "instead of MPPI")
    ap.add_argument("--lqt-horizon", type=int, default=4096)
    ap.add_argument("--state-dim", type=int, default=16)
    ap.add_argument("--action-dim", type=int, default=8)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    device = tools.open_device(a.device)
    args = vars(a)
    rows = run([int(c) for c in a.ranks.split(",")], device.type, args)
    t1 = {}         # by program: its first row's ms x ranks
    for row in rows:
        t1.setdefault(row["program"], row["ms"] * row["ranks"])
        row["solves_per_s"] = 1e3 / row["ms"]
        row["efficiency_vs_linear"] = t1[row["program"]] / (
            row["ms"] * row["ranks"])
        print(json.dumps(row), flush=True)
    size = ({"horizon": a.lqt_horizon, "state_dim": a.state_dim} if a.lqt
            else {"n_rollouts": a.rollouts, "horizon": a.horizon})
    print(json.dumps({
        "device": tools.device_name(device),
        "metric": "lqt_backward_horizon_sharded" if a.lqt else "mppi_step",
        **size, "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()

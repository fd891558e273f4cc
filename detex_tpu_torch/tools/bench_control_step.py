"""The full control step in the steady state, against the 10 ms budget: the
counterpart of tools/bench_control_step.py (BASELINE.md config 5).

    python -m detex_tpu_torch.tools.bench_control_step [--ilqr 0 2]
        [--rollouts 8192] [--horizon 32] [--wallclock] [--device cpu]

Times the control step at ControllerConfig()'s width -- the BC7
observation decode (csrc/bc7.cu), the conv encoder, MPPI (8192 rollouts x
H = 32, bf16) and, with --ilqr N > 0, N iLQR iterations with the
sequential and then the parallel-LQT backward -- in two programs: "graph",
the Controller's captured CUDA graph (the counterpart of the jitted
program the JAX tool times), captured before the timing starts; and
"eager", runtime.control_step launching op by op (the CPU has only this
one).  The steps run back to back as the JAX tool's fori_loop runs them:
the observation changes on the card each step (words ^ i, no host copy;
the graph's step copies it into the program's words buffer), the nominal
plan is carried from step to step, the noise comes from a torch.Generator
on the card, no action is read back, and nothing waits for the card
before the end.  Each step's time is read from CUDA events recorded
between steps (tools.step_times) after --warmup steps; a row gives the
median, p10 and p90 over --steps steps, with the host's enqueue median
beside them.  The JAX tool's two-point fori_loop marginal method is a TPU
workaround and is left out.

--wallclock: a Controller against a PipelinedController (graphed on a
card), host clock, 100 steps after 4 warm-ups, each observation uploaded
from the host (tools/bench_control_step.py:84-107).

Each row checks itself: the first step's action against a fresh Controller
(graphed on a card) on the same seed and observation (atol 1e-6: the same
ops on the same device, the parallel LQT's LU on one library eager or
graphed, mpc/parallel_lqr._lu_library), and --wallclock's pipelined actions against the synchronous ones one step
later.  Prints one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from detex_tpu_torch import tools
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import mppi as M
from detex_tpu_torch.mpc import runtime as R
from detex_tpu_torch.ops import bptc

BUDGET_MS = 10.0
ATOL = 1e-6          # same ops, same device: only a reduction order may move
WALLCLOCK_STEPS, WALLCLOCK_WARMUP = 100, 4
_SEED = 0


def _setup(cfg: R.ControllerConfig, device: torch.device):
    """Random parameters from seed 0 on `device`, one observation of random
    BC7 words (invalid blocks among them) and a zero goal."""
    dcfg = cfg.dynamics
    generator = torch.Generator(device=device)
    generator.manual_seed(_SEED)
    params = D.init_params(dcfg, generator, device)
    n_blocks = (dcfg.image_size // 4) ** 2
    obs = np.random.default_rng(_SEED).integers(
        -2**31, 2**31, (n_blocks, 4), np.int64).astype(np.int32)
    return params, obs, torch.zeros((dcfg.latent_dim,), device=device)


@torch.no_grad()
def bench(cfg: R.ControllerConfig, device: torch.device, warmup: int,
          steps: int, program: str = "eager", mesh=None) -> dict:
    """Per-step card and host ms of `steps` control steps after `warmup` in
    `program` ("graph" or "eager"), the BC7 launches per step, the
    graph's capture seconds and the first action's distance from a fresh
    Controller's; raises if that is over ATOL or not finite.  With `mesh`
    (and cfg.rollout_axis) the step is the sharded one, its graph holding
    the collectives (an NCCL mesh: runtime.Controller)."""
    params, obs, goal = _setup(cfg, device)
    words = torch.from_numpy(obs).to(device)
    carry, capture_s = {}, None
    if program == "graph":
        ctl = R.Controller(params, goal, cfg, seed=_SEED, device=device,
                           mesh=mesh)
        prog = ctl._program
        prog.load(words)
        prog.capture()      # the generator and the nominal stay untouched
        capture_s = prog.capture_s

        def step(i):
            prog.load(words ^ i)
            action, _ = prog(ctl.generator)
            if i == 0:
                carry["first"] = action
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(_SEED)
        carry["nominal"] = torch.zeros(
            (cfg.mppi.horizon, cfg.mppi.action_dim), device=device)

        def step(i):
            action, carry["nominal"], _ = R.control_step(
                params, carry["nominal"], generator, words ^ i, goal, cfg,
                mesh=mesh)
            if i == 0:
                carry["first"] = action

    launches = bptc.KERNEL_LAUNCHES
    card_ms, host_ms = tools.step_times(step, device, warmup, steps)
    launches = bptc.KERNEL_LAUNCHES - launches
    first = carry["first"].cpu().numpy()
    ctl = R.Controller(params, goal, cfg, seed=_SEED, device=device,
                       mesh=mesh)
    want = ctl.step(obs)
    diff = float(np.abs(first - want).max())
    if not np.isfinite(first).all() or not diff <= ATOL:
        raise AssertionError(f"first action {first} != a Controller's "
                             f"{want} (max diff {diff:.3g} > {ATOL})")
    return {"card_ms": card_ms, "host_ms": host_ms,
            "bc7_launches_per_step": launches / (warmup + steps),
            "capture_s": capture_s, "first_action": first,
            "first_action_max_diff": diff, "first_action_atol": ATOL}


def bench_wallclock(cfg: R.ControllerConfig, device: torch.device,
                    pipelined: bool) -> tuple:
    """Host-in-the-loop ms per Controller.step (or PipelinedController.step,
    which returns the previous step's action), each step uploading one of
    8 observations; and the actions, in order (a pipelined controller's
    first is None, its last comes from flush())."""
    params, _, goal = _setup(cfg, device)
    rng = np.random.default_rng(_SEED)
    n_blocks = (cfg.dynamics.image_size // 4) ** 2
    obs = [rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64)
           .astype(np.int32) for _ in range(8)]
    cls = R.PipelinedController if pipelined else R.Controller
    ctl = cls(params, goal, cfg, seed=_SEED, device=device)
    actions = [ctl.step(obs[i % 8]) for i in range(WALLCLOCK_WARMUP)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(WALLCLOCK_STEPS):
        actions.append(ctl.step(obs[i % 8]))
    if pipelined:
        actions.append(ctl.flush())
    return ((time.perf_counter() - t0) * 1e3 / WALLCLOCK_STEPS, actions,
            "graph" if ctl.graphed else "eager")


def _mppi(args) -> M.MPPIConfig:
    return M.MPPIConfig(n_rollouts=args.rollouts, horizon=args.horizon,
                        action_dim=8)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tools.device_arg(ap)
    ap.add_argument("--ilqr", type=int, nargs="*", default=[0, 2])
    ap.add_argument("--rollouts", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--wallclock", action="store_true",
                    help="host-in-the-loop synchronous vs pipelined steps")
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    card = tools.card(device)
    rows = []

    def emit(row):
        row.update(platform=device.type, device=card)
        print(json.dumps(row), flush=True)
        rows.append(row)

    programs = ("graph", "eager") if device.type == "cuda" else ("eager",)
    for n_ilqr in args.ilqr:
        for parallel in ((False,) if n_ilqr == 0 else (False, True)):
            cfg = R.ControllerConfig(mppi=_mppi(args),
                                     n_ilqr_iterations=n_ilqr,
                                     ilqr_parallel=parallel)
            for program in programs:
                out = bench(cfg, device, args.warmup, args.steps, program)
                ms = tools.spread(out["card_ms"])
                emit({
                    "metric": "control_step_ms", "program": program,
                    "ilqr_iterations": n_ilqr,
                    "backward": ("parallel-lqt" if parallel else "seq")
                    if n_ilqr else "n/a",
                    "ms_per_step": ms["median"], "p10_ms": ms["p10"],
                    "p90_ms": ms["p90"],
                    "host_ms_per_step":
                        tools.spread(out["host_ms"])["median"],
                    "solves_per_s": 1e3 / ms["median"],
                    "within_10ms_budget": ms["median"] <= BUDGET_MS,
                    "warmup": args.warmup, "steps": args.steps,
                    "n_rollouts": args.rollouts, "horizon": args.horizon,
                    "bc7_launches_per_step": out["bc7_launches_per_step"],
                    "capture_s": out["capture_s"],
                    "first_action": out["first_action"].tolist(),
                    "first_action_max_diff": out["first_action_max_diff"],
                    "first_action_atol": out["first_action_atol"]})

    if args.wallclock:
        cfg = R.ControllerConfig(mppi=_mppi(args))
        out = {p: bench_wallclock(cfg, device, p) for p in (False, True)}
        sync, piped = out[False][1], out[True][1]
        if piped[0] is not None or len(piped) != len(sync) + 1:
            raise AssertionError("the pipelined controller's actions are "
                                 "not one step behind")
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(piped[1:], sync))
        if not diff <= ATOL:
            raise AssertionError(f"pipelined actions differ from the "
                                 f"synchronous ones by {diff:.3g}")
        for pipelined in (False, True):
            ms, _, program = out[pipelined]
            emit({"metric": "control_step_wallclock_ms",
                  "program": program, "pipelined": pipelined,
                  "ms_per_step": ms,
                  "steps_per_s": 1e3 / ms,
                  "steps": WALLCLOCK_STEPS, "warmup": WALLCLOCK_WARMUP,
                  "n_rollouts": args.rollouts, "horizon": args.horizon,
                  "pipelined_vs_sync_max_diff": diff})
    return rows


if __name__ == "__main__":
    main()

"""Closed-loop control: `Controller.step` from BC7 words on the host to the
action on the host, the next step sent when the last returns.

Traffic parameters (workloads/<cell>.json "params"):
  obs_pool       frames of 64x64 BC7 made from the seed, sent in turn;
  warmup_steps   steps in set-up (the first captures the step's graph);
  checked_steps  steps of the window judged against the reference;
  trace_seconds  the first part of the window that --trace 1 profiles;
  ranks          processes, one card each; more than 1 shards the
                 rollouts over a mesh axis "dp" of that many ranks (NCCL
                 on cards), each rank serving the same observations;
  rollout_axis   null, or "dp" with ranks > 1.

One rank runs the window for --seconds; several run the number of steps
that rank 0's warm-up rate gives for --seconds, so that their collectives
stay in step.  Rank 0 times every step.

`correct`: the reference (reference/visual_mpc.py, reference/bptc.py) makes
the same weights, goal, observations and noise from the seed and follows
  * the start: the first set-up step from the zero plan;
  * every later set-up step and each checked step of the window from the
    plan the program held before it (read from `Controller.nominal`
    between steps), so that it runs 32 steps and not every step of the
    window.  It cannot follow the program on its own chain: where few
    rollouts carry the weight, a rounding's worth of difference in a plan
    moves the next weights, and two chains part within a few steps.  What
    this skips, the plan carried from step to step, is checked by itself:
    the kept plan against the reference's shift of its own update.
Each compared step gives the action, the shifted plan the program keeps
for the next step, and min_cost (the best rollout's cost, from the
program's diagnostics).  The numbers judged are the widest gap, over the
compared steps, of the action and the kept plan (`plan_gap_max`) and of
min_cost relative to the reference's (`min_cost_rel_gap_max`).  The
served weights keep the rollouts bounded (configs/visual_mpc_64.json,
`served_out_scale`), so MPPI's weights are soft: the median effective
sample size of the compared steps is printed beside the checks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dtxbench import common, flops, traffic
from dtxbench.common import Check, Outcome, span
from dtxbench.reference import bptc as ref_bc7
from dtxbench.reference import visual_mpc as ref
from dtxbench.trace import Tracer, merge

TIMED_WARMUP = 4          # the last set-up steps, timed for the window's rate


def controller_config(config: dict, params: dict):
    """The program's ControllerConfig for the configuration file."""
    from detex_tpu_torch.mpc import dynamics as D
    from detex_tpu_torch.mpc import mppi
    from detex_tpu_torch.mpc import runtime as R
    d = dict(config["dynamics"])
    d["conv_features"] = tuple(d["conv_features"])
    d["compute_dtype"] = getattr(torch, d["compute_dtype"])
    c = config["controller"]
    return R.ControllerConfig(
        dynamics=D.DynamicsConfig(**d), mppi=mppi.MPPIConfig(**config["mppi"]),
        n_ilqr_iterations=c["n_ilqr_iterations"],
        goal_weight=c["goal_weight"], control_weight=c["control_weight"],
        rollout_axis=params.get("rollout_axis"))


def _inputs(ctx: common.Context, device: torch.device):
    """The served weights and goal (on `device`, from the seed's stream 1),
    the observation pool (host words, stream 2) and the noise seed."""
    d = ctx.config["dynamics"]
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.derived_seed(1))
    params = ref.init_params(d, gen, ctx.config["served_out_scale"])
    goal = torch.randn((d["latent_dim"],), generator=gen, device=device)
    pool = traffic.observation_pool(ctx.rng(2), ctx.traffic["obs_pool"],
                                    d["image_size"])
    return params, goal, pool, ctx.derived_seed(3)


def serve(rank: int, args: dict) -> dict:
    """One process's part: set-up, the window, and what the judge needs
    (rank 0's; every rank returns its timings and trace)."""
    ctx = common.Context.from_args(args)
    marks = common.Marks(ctx.wall0)
    marks("started")
    common.call_prepare(ctx.prepare)
    from detex_tpu_torch.mpc import runtime as R
    from detex_tpu_torch.parallel import mesh as mesh_mod
    marks("imported")
    device = ctx.device
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    common.set_precision(device)
    p = ctx.traffic
    ranks = p.get("ranks", 1)
    mesh = (mesh_mod.make_mesh((ranks,), ("dp",), device=device)
            if ranks > 1 else None)
    cfg = controller_config(ctx.config, p)
    params, goal, pool, noise_seed = _inputs(ctx, device)
    frames = pool.shape[0]
    ctl = R.Controller(params, goal, cfg, seed=noise_seed, device=device,
                       mesh=mesh)
    marks("inputs")

    start, warm_s = [], []
    for i in range(p["warmup_steps"]):
        before = ctl.nominal.detach().cpu().clone() if i else None
        t = time.perf_counter()
        action = ctl.step(pool[i % frames])
        warm_s.append(time.perf_counter() - t)
        start.append({"step": i, "before": before,
                      "action": torch.from_numpy(action),
                      "min_cost": float(ctl.diag["min_cost"]),
                      "after": ctl.nominal.detach().cpu().clone()})
        if i == 0:
            marks("captured")
    step_s = float(np.mean(warm_s[-TIMED_WARMUP:]))
    n_fixed = None
    if ranks > 1:
        box = [int(np.ceil(ctx.seconds / step_s))]
        torch.distributed.broadcast_object_list(box, src=0)
        n_fixed = box[0]
    expected = n_fixed or int(ctx.seconds / step_s)
    checked = common.pick(ctx.rng(4), expected, p["checked_steps"])
    marks("warm")

    collective0 = sum(mesh_mod.COLLECTIVE_BYTES.values())
    tracer = Tracer(ctx.trace, device)
    traced_work = None
    records, times, failed = [], [], 0
    warm = p["warmup_steps"]
    common.sync(device)
    tracer.start()
    window = common.Window(ctx.seconds)
    window.open()
    wall_open = time.time()
    j = 0
    while not (window.over() if n_fixed is None else j >= n_fixed):
        obs = pool[(warm + j) % frames]
        before = ctl.nominal.clone() if j in checked else None
        t = time.perf_counter()
        if tracer.running:
            with span("dtxbench.step"):
                action = ctl.step(obs)
        else:
            action = ctl.step(obs)
        times.append(time.perf_counter() - t)
        if before is not None:
            records.append({"step": warm + j, "before": before,
                            "action": torch.from_numpy(action),
                            "min_cost": ctl.diag["min_cost"],
                            "ess": ctl.diag["ess"],
                            "after": ctl.nominal.clone()})
        if not np.all(np.isfinite(action)):
            failed += 1
        j += 1
        if tracer.running and tracer.due(p["trace_seconds"]):
            tracer.stop()
            traced_work = {
                "steps": j, "stopped_at": time.perf_counter(),
                "collective_bytes": sum(mesh_mod.COLLECTIVE_BYTES.values())
                - collective0}
    common.sync(device)
    window.close()
    if tracer.running:
        tracer.stop()
        traced_work = {"steps": j, "stopped_at": window.t_close,
                       "collective_bytes": sum(
                           mesh_mod.COLLECTIVE_BYTES.values()) - collective0}
    if traced_work:
        # The steps after the traced part, which the profiler slows.
        traced_work["untraced_units"] = j - traced_work["steps"]
        traced_work["untraced_s"] = window.t_close - traced_work.pop(
            "stopped_at")
    peak = common.peak_bytes(device)
    for r in records:
        r["before"] = r["before"].cpu()
        r["after"] = r["after"].cpu()
        r["min_cost"] = float(r["min_cost"])
        r["ess"] = float(r["ess"])
    del ctl, params
    common.free(device)
    summary = tracer.finish(traced_work) if ctx.trace else None
    return {"rank": rank, "steps": j, "failed": failed,
            "window_s": window.length, "wall_open": wall_open,
            "step_s": times, "start": start, "records": records,
            "memory_peak_bytes": peak, "trace": summary,
            "forbidden": common.forbidden_modules(), "marks": marks.at}


def _rank(rank: int, args: dict) -> dict:
    return serve(rank, args)


def _reference_side(ctx: common.Context, device, steps: list, prec):
    """The reference's (action, kept plan, min_cost) for each of `steps`
    (dicts with "step" and "before"): from each step's "before", the plan
    the program held, or from the zero plan where "before" is None (the
    first step)."""
    d, m, c = (ctx.config["dynamics"], ctx.config["mppi"],
               ctx.config["controller"])
    params, goal, pool, noise_seed = _inputs(ctx, device)
    frames = pool.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    shape = (m["n_rollouts"], m["horizon"], m["action_dim"])
    if not steps:
        return []
    wanted = {s["step"] for s in steps}
    noise = {}
    for i in range(max(wanted) + 1):
        eps = torch.randn(shape, generator=gen, device=device)
        if i in wanted:
            noise[i] = eps * m["noise_sigma"]
    side = d["image_size"]
    out = []
    zero = torch.zeros((m["horizon"], m["action_dim"]), device=device)
    with torch.no_grad():
        for s in steps:
            i = s["step"]
            blocks = torch.from_numpy(traffic.blocks_of(pool[i % frames]))
            pix, _ = ref_bc7.decode(blocks.to(device))
            image = ref_bc7.assemble(pix, side, side)
            z0 = ref.encode(params, image[None], prec)[0]
            nominal = zero if s["before"] is None else s["before"].to(device)
            plan, shifted, beta = ref.mppi_update(params, z0, goal, nominal,
                                                  noise[i], m, c, prec)
            out.append((plan[0].cpu(), shifted.cpu(), float(beta)))
    return out


def numbers(ctx: common.Context, device, start: list,
            records: list) -> dict:
    """The numbers that decide `correct`: the program's start and checked
    steps against the reference's (the control's in their place where
    ctx.variant is "control")."""
    want = _reference_side(ctx, device, start + records, ref.BF16)
    if ctx.variant == "control":
        got = _reference_side(ctx, device, start + records, ref.FP8)
    else:
        got = [(s["action"], s["after"], s["min_cost"])
               for s in start + records]
    plan_gaps, cost_gaps = [], []
    for (a, kept, cost), (ra, rkept, rcost) in zip(got, want, strict=True):
        plan_gaps.append(max(float((a.float() - ra).abs().max()),
                             float((kept.float() - rkept).abs().max())))
        cost_gaps.append(abs(cost - rcost) / max(abs(rcost), 1e-30))
    return {"plan_gap_max": max(plan_gaps),
            "min_cost_rel_gap_max": max(cost_gaps)}


def judge(ctx: common.Context, device, start: list, records: list) -> list:
    """The checks of one run: the numbers its workload file gives a
    limit."""
    limits = ctx.cell["limits"]
    return [Check(name, value, limits[name])
            for name, value in numbers(ctx, device, start, records).items()
            if name in limits]


def run(ctx: common.Context) -> Outcome:
    p = ctx.traffic
    ranks = p.get("ranks", 1)
    if ranks == 1:
        served = [serve(0, ctx.to_args())]
    else:
        from detex_tpu_torch.parallel import launch
        served = launch.run_ranks(
            _rank, ranks, (ctx.to_args(),), device=ctx.device.type,
            backend="nccl" if ctx.device.type == "cuda" else "gloo",
            timeout=ctx.seconds + 300.0)
    lead = served[0]
    device = (torch.device("cuda", 0) if ctx.device.type == "cuda"
              else ctx.device)
    common.set_precision(device)
    checks = judge(ctx, device, lead["start"], lead["records"])
    steps, length = lead["steps"], lead["window_s"]
    step_ms = np.asarray(lead["step_s"]) * 1e3
    trace = merge([s["trace"] for s in served]) if ctx.trace else None
    if trace:
        d, m = ctx.config["dynamics"], ctx.config["mppi"]
        untraced = step_ms[trace["work"]["steps"]:]
        trace["work"].update(
            units=trace["work"]["steps"],
            flops_per_unit=flops.control_step_flops(d, m),
            step_p95_ms=float(np.percentile(
                untraced if untraced.size else step_ms, 95)))
    return Outcome(
        attempted=steps, failed=lead["failed"],
        metrics={"control_step_ms": length / steps * 1e3,
                 "setup_s": lead["wall_open"] - ctx.wall0},
        checks=checks,
        memory_peak_bytes=max(s["memory_peak_bytes"] for s in served),
        chips=ranks, trace=trace,
        notes={"forbidden": sorted({f for s in served
                                    for f in s["forbidden"]}),
               "marks": lead["marks"],
               "info": {"ess_median": float(np.median(
                   [r["ess"] for r in lead["records"]] or [np.nan]))}})

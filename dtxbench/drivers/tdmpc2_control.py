"""Closed-loop TD-MPC2 control: `Controller.step` with a TD-MPC2
configuration (configs/tdmpc2_317m.json) from BC7 words on the host to the
action on the host, the next step sent when the last returns.

Traffic parameters (workloads/<cell>.json "params"):
  obs_pool       frames of 64x64 BC7 made from the seed, sent in turn;
  warmup_steps   steps in set-up (the first captures the step's graph);
  checked_steps  steps of the window judged against the reference;
  trace_seconds  the first part of the window that --trace 1 profiles.

One card, one process.  A program without TD-MPC2 (no
detex_tpu_torch.mpc.tdmpc2) stops at this module's import: no result.

`correct`: the reference (reference/tdmpc2.py, reference/bptc.py) makes
the same weights, frames and draws from the seed and follows the first
set-up step from the episode's start (zero mean, the frame stack filled
with the first frame), and every later set-up step and each checked step
of the window from the state the program held before it: its warm-start
mean and its frame stack (read from the Controller between steps).  The
numbers, each the widest over the compared steps:
  * value_rel_gap_max: the first planning round's num_samples trajectory
    values against the reference's, over the largest of the reference's;
  * mean_gap_max: the last round's mean, and the warm start the program
    keeps for the next step against the reference's shift of that mean;
  * std_gap_max: the last round's std;
  * action_gap_max: the action;
  * frames_differing: entries of the frame stack the program keeps that
    differ from the reference's.
A top-k or a Gumbel choice on values that agree within the value
tolerance (the limit of value_rel_gap_max times the round's largest
value) can fall either way with rounding.  Where the program's elite set
differs from the reference's only by trajectories within that tolerance
of the reference's k-th value, or its chosen elite's Gumbel key is within
temperature times it of the reference's best, the reference follows the
program's choice and counts it; the count is printed beside the checks
("info choices_followed").  A choice outside the tolerance is not
followed, and the mean, std and action then show it.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from detex_tpu_torch.mpc import tdmpc2 as T  # a program without it stops here
from dtxbench import common, flops_tdmpc2, traffic
from dtxbench.common import Check, Outcome, span
from dtxbench.reference import bptc as ref_bc7
from dtxbench.reference import tdmpc2 as ref
from dtxbench.trace import Tracer, merge

TIMED_WARMUP = 4          # the last set-up steps, timed for the window's rate
# What a non-finite number is printed as: the largest float, never NaN.
NOT_FINITE = float(np.finfo(np.float64).max)


def model_config(config: dict) -> T.TDMPC2Config:
    """The program's TDMPC2Config for the configuration file."""
    m = ref.flat_config(config)
    names = {f.name for f in dataclasses.fields(T.TDMPC2Config)}
    return T.TDMPC2Config(
        **{k: v for k, v in m.items() if k in names},
        compute_dtype=getattr(torch, config["precision"]["compute_dtype"]))


def _inputs(ctx: common.Context, device: torch.device):
    """The served weights (on `device`, from the seed's stream 1), the
    observation pool (host words, stream 2) and the draws' seed (3)."""
    m = ref.flat_config(ctx.config)
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.derived_seed(1))
    params = ref.init_params(m, gen)
    pool = traffic.observation_pool(ctx.rng(2), ctx.traffic["obs_pool"],
                                    m["image_size"])
    return params, pool, ctx.derived_seed(3)


def _state(ctl) -> dict:
    return {"nominal": ctl.nominal.clone(), "frames": ctl.frames.clone()}


def _record(step: int, before, action, ctl) -> dict:
    return dict(ctl.diag, step=step, before=before,
                action=torch.from_numpy(action), after=_state(ctl))


def _to_cpu(x):
    if isinstance(x, list):
        return [_to_cpu(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x.cpu() if isinstance(x, torch.Tensor) else x


def serve(ctx: common.Context) -> dict:
    """Set-up, the window, and what the judge needs."""
    marks = common.Marks(ctx.wall0)
    marks("started")
    common.call_prepare(ctx.prepare)
    from detex_tpu_torch.mpc import runtime as R
    marks("imported")
    device = ctx.device
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    common.set_precision(device)
    p = ctx.traffic
    cfg = R.ControllerConfig(tdmpc2=model_config(ctx.config))
    params, pool, draw_seed = _inputs(ctx, device)
    frames = pool.shape[0]
    ctl = R.Controller(params, ctx.config["task"]["index"], cfg,
                       seed=draw_seed, device=device)
    marks("inputs")

    start, warm_s = [], []
    for i in range(p["warmup_steps"]):
        before = _state(ctl) if i else None
        t = time.perf_counter()
        action = ctl.step(pool[i % frames])
        warm_s.append(time.perf_counter() - t)
        start.append(_record(i, before, action, ctl))
        if i == 0:
            marks("captured")
    step_s = float(np.mean(warm_s[-TIMED_WARMUP:]))
    expected = int(ctx.seconds / step_s)
    checked = common.pick(ctx.rng(4), expected, p["checked_steps"])
    marks("warm")

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
    while not window.over():
        obs = pool[(warm + j) % frames]
        before = _state(ctl) if j in checked else None
        t = time.perf_counter()
        if tracer.running:
            with span("dtxbench.step"):
                action = ctl.step(obs)
        else:
            action = ctl.step(obs)
        times.append(time.perf_counter() - t)
        if before is not None:
            records.append(_record(warm + j, before, action, ctl))
        if not np.all(np.isfinite(action)):
            failed += 1
        j += 1
        if tracer.running and tracer.due(p["trace_seconds"]):
            tracer.stop()
            traced_work = {"steps": j, "stopped_at": time.perf_counter()}
    common.sync(device)
    window.close()
    if tracer.running:
        tracer.stop()
        traced_work = {"steps": j, "stopped_at": window.t_close}
    if traced_work:
        # The steps after the traced part, which the profiler slows.
        traced_work["untraced_units"] = j - traced_work["steps"]
        traced_work["untraced_s"] = window.t_close - traced_work.pop(
            "stopped_at")
    peak = common.peak_bytes(device)
    start, records = _to_cpu(start), _to_cpu(records)
    del ctl, params
    common.free(device)
    summary = tracer.finish(traced_work) if ctx.trace else None
    return {"steps": j, "failed": failed, "window_s": window.length,
            "wall_open": wall_open, "step_s": times, "start": start,
            "records": records, "memory_peak_bytes": peak, "trace": summary,
            "forbidden": common.forbidden_modules(), "marks": marks.at}


class _Follow:
    """The reference's selections for one compared step, following the
    compared side's (`got`) where the values they rest on agree within
    the value tolerance (module docstring); counts the choices it
    followed that differ from the reference's own."""

    def __init__(self, got: dict, rel_tol: float, temperature: float):
        self.got, self.rel_tol, self.temperature = got, rel_tol, temperature
        self.followed = 0
        self.tol = 0.0

    def elites(self, i: int, values: torch.Tensor, own: torch.Tensor):
        self.tol = self.rel_tol * float(values.abs().max())
        if i >= len(self.got["elites"]):
            return own
        theirs = self.got["elites"][i].to(own.device, torch.long)
        mine, other = set(own.tolist()), set(theirs.tolist())
        if mine == other:
            return theirs
        boundary = values[own[-1]]
        apart = torch.tensor(sorted(mine ^ other), device=own.device)
        if float((values[apart] - boundary).abs().max()) <= self.tol:
            self.followed += 1
            return theirs
        return own

    def choice(self, keys: torch.Tensor, own: int) -> int:
        theirs = int(self.got["choice"])
        if theirs == own or not 0 <= theirs < keys.shape[0]:
            return own
        if float(keys[own] - keys[theirs]) <= self.temperature * self.tol:
            self.followed += 1
            return theirs
        return own


def _reference_side(ctx: common.Context, device, steps: list, prec,
                    got=None):
    """The reference's planner outputs, state after and frames for each of
    `steps` (dicts with "step" and "before"): from the episode's start
    where "before" is None, else from the state the program held.  With
    `got` (the compared side's outputs, one a step) the reference follows
    its selections within the tolerance (_Follow).  Returns (outputs,
    choices followed)."""
    if not steps:
        return [], 0
    m = ref.flat_config(ctx.config)
    params, pool, draw_seed = _inputs(ctx, device)
    n_frames = pool.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed)
    wanted = {s["step"] for s in steps}
    draws = {}
    for i in range(max(wanted) + 1):
        d = ref.draws(gen, m)
        if i in wanted:
            draws[i] = d
    side, task = m["image_size"], ctx.config["task"]["index"]
    rel_tol = ctx.cell["limits"]["value_rel_gap_max"]
    out, followed = [], 0
    with torch.no_grad():
        for k, s in enumerate(steps):
            i = s["step"]
            blocks = torch.from_numpy(traffic.blocks_of(pool[i % n_frames]))
            pix, _ = ref_bc7.decode(blocks.to(device))
            rgb = ref_bc7.assemble(pix, side, side)[..., :3].to(torch.int32)
            before = s["before"]
            if before is None:
                frames = rgb[None].repeat(m["frames"], 1, 1, 1)
                warm = torch.zeros((m["horizon"], m["action_dim"]),
                                   device=device)
            else:
                frames = torch.cat([before["frames"].to(device)[1:],
                                    rgb[None]])
                warm = before["nominal"].to(device)
            follow = (_Follow(got[k], rel_tol, m["temperature"])
                      if got is not None else None)
            z = ref.encode(params, frames, m, prec)
            r = ref.plan(params, z, warm, draws[i], task, m, prec,
                         follow and follow.elites, follow and follow.choice)
            followed += follow.followed if follow else 0
            r = {k2: torch.as_tensor(v).cpu() for k2, v in r.items()}
            r["after"] = {"nominal": ref.warm_start(r["mean"]),
                          "frames": frames.cpu()}
            out.append(r)
    return out, followed


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def numbers(ctx: common.Context, device, start: list, records: list):
    """The numbers that decide `correct` (module docstring), and how many
    choices the reference followed: the program's set-up and checked
    steps against the reference's (the control's in their place where
    ctx.variant is "control")."""
    steps = start + records
    if ctx.variant == "control":
        got, _ = _reference_side(ctx, device, steps, ref.FP8)
    else:
        got = steps
    want, followed = _reference_side(ctx, device, steps, ref.BF16, got)
    gaps = {"value_rel_gap_max": [], "mean_gap_max": [], "std_gap_max": [],
            "action_gap_max": [], "frames_differing": []}
    for g, w in zip(got, want, strict=True):
        scale = max(float(w["values"].abs().max()), 1e-30)
        gaps["value_rel_gap_max"].append(
            float((g["values"] - w["values"]).abs().max()) / scale)
        gaps["mean_gap_max"].append(max(
            float((g["mean"] - w["mean"]).abs().max()),
            float((g["after"]["nominal"] - w["after"]["nominal"])
                  .abs().max())))
        gaps["std_gap_max"].append(float((g["std"] - w["std"]).abs().max()))
        gaps["action_gap_max"].append(
            float((g["action"].float() - w["action"]).abs().max()))
        gaps["frames_differing"].append(float(
            (g["after"]["frames"] != w["after"]["frames"]).sum()))
    return ({k: _finite(max(v)) for k, v in gaps.items()}, followed)


def run(ctx: common.Context) -> Outcome:
    served = serve(ctx)
    device = (torch.device("cuda", 0) if ctx.device.type == "cuda"
              else ctx.device)
    common.set_precision(device)
    values, followed = numbers(ctx, device, served["start"],
                               served["records"])
    limits = ctx.cell["limits"]
    checks = [Check(k, v, limits[k]) for k, v in values.items()
              if k in limits]
    steps, length = served["steps"], served["window_s"]
    step_ms = np.asarray(served["step_s"]) * 1e3
    trace = merge([served["trace"]]) if ctx.trace else None
    if trace:
        untraced = step_ms[trace["work"]["steps"]:]
        trace["work"].update(
            units=trace["work"]["steps"],
            flops_per_unit=flops_tdmpc2.step_flops(
                ref.flat_config(ctx.config)),
            step_p95_ms=float(np.percentile(
                untraced if untraced.size else step_ms, 95)))
    return Outcome(
        attempted=steps, failed=served["failed"],
        metrics={"control_step_ms": length / steps * 1e3,
                 "setup_s": served["wall_open"] - ctx.wall0},
        checks=checks, memory_peak_bytes=served["memory_peak_bytes"],
        chips=1, trace=trace,
        notes={"forbidden": served["forbidden"], "marks": served["marks"],
               "info": {"choices_followed": followed,
                        "compared_steps": len(served["start"])
                        + len(served["records"])}})

"""Replay training: `train_loop.train(TrainConfig(...), env=...)` on batches
of BC7 observations, host batch in to optimizer step done, one step after
another for as long as the window lasts.

Traffic parameters (workloads/<cell>.json "params"):
  batches        batches made at set-up from the seed, served in turn;
  pool_blocks    the random BC7 blocks (modes cycling 0..7) each
                 observation's blocks are drawn from;
  warmup_steps   steps before the window opens (the first captures the
                 step's graph);
  trace_seconds  the first part of the window --trace 1 profiles.

The env is the benchmark's own.  It hands train() the next batch at each
step, and the window is closed from inside train()'s loop: the first call
past --seconds raises StopWindow, which this driver catches, and the
device is waited for before the window's clock stops.  train() logs its
loss to this driver's logger, not to stdout.

`correct`: train() makes its parameters from TrainConfig.seed and an
AdamW over them; the benchmark finds that optimizer through torch's
optimizer-step hook at the graph's warm-ups, and reads, before step 2 and
before step 4 (between steps, the device waited for), the optimizer's
first moments and the parameters.  The reference (reference/
visual_mpc.py, reference/bptc.py) makes the same parameters from the seed,
decodes the same batches and takes three AdamW steps.  Compared:
  * step 1's loss (train() logs it), relative gap;
  * the first gradient as the optimizer got it (its first moment after
    one step over 1 - beta1): by the worst leaf, the gap of the norms over
    the reference's norm of that leaf or of the median leaf, the larger;
  * the parameters' change over three steps, by the same rule, leaving
    out the leaves whose reference gradient is under a thousandth of the
    median leaf's (Adam moves those by round-off alone).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from dtxbench import common, traffic
from dtxbench.common import Check, Outcome, StopWindow, span
from dtxbench.reference import bptc as ref_bc7
from dtxbench.reference import visual_mpc as ref
from dtxbench.trace import Tracer

BETA1 = 0.9
CHANGE_STEPS = 3


class LossLog:
    """The logger train() is given: keeps each logged loss by step."""

    def __init__(self):
        self.loss = {}

    def log(self, step: int, **values) -> None:
        self.loss[step] = float(values["loss"])


class ReplayEnv:
    """Serves the set-up's batches in turn; reads the program's state
    before steps 2 and 4; opens the window before step warmup_steps + 1
    and raises StopWindow at the first call past its end."""

    def __init__(self, batches, warmup_steps, seconds, tracer, trace_seconds,
                 device, optimizers, marks):
        self.marks = marks
        self.batches = batches
        self.warmup_steps = warmup_steps
        self.window = common.Window(seconds)
        self.tracer, self.trace_seconds = tracer, trace_seconds
        self.device = device
        self.optimizers = optimizers
        self.calls = 0
        self.opened_at = None
        self.wall_open = None
        self.traced_steps = self.trace_stopped = None
        self.first_moment = self.params_after = None

    def _state(self) -> list:
        opt = self.optimizers[0]
        return [p for group in opt.param_groups for p in group["params"]]

    def sample_batch(self, rng, batch_size):
        k = self.calls            # steps done before this one
        if k < self.warmup_steps:
            self.marks(f"step{k}")
        if k == 1:
            # An optimizer that has not stepped has no moments: zero.
            common.sync(self.device)
            state = self.optimizers[0].state
            self.first_moment = [
                state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach()
                .cpu().clone() for p in self._state()]
        if k == CHANGE_STEPS:
            common.sync(self.device)
            self.params_after = [p.detach().cpu().clone()
                                 for p in self._state()]
        if k == self.warmup_steps:
            common.sync(self.device)
            self.tracer.start()
            self.window.open()
            self.wall_open = time.time()
            self.opened_at = k
        elif self.opened_at is not None:
            if self.tracer.running and self.tracer.due(self.trace_seconds):
                self.tracer.stop()
                self.traced_steps = k - self.opened_at
                self.trace_stopped = time.perf_counter()
            if self.window.over():
                self.steps = k - self.opened_at
                raise StopWindow
        self.calls += 1
        batch = self.batches[k % len(self.batches)]
        if batch["action"].shape[0] != batch_size:
            raise ValueError(f"batch of {batch['action'].shape[0]}, "
                             f"train() asks for {batch_size}")
        if self.tracer.running:
            with span("dtxbench.env"):
                return batch
        return batch


def _train_config(ctx: common.Context):
    from detex_tpu_torch.mpc import dynamics as D
    from detex_tpu_torch.mpc import train_loop as TL
    d = dict(ctx.config["dynamics"])
    d["conv_features"] = tuple(d["conv_features"])
    d["compute_dtype"] = getattr(torch, d["compute_dtype"])
    t = ctx.config["train"]
    return TL.TrainConfig(dynamics=D.DynamicsConfig(**d),
                          batch_size=t["batch_size"], n_steps=1 << 62,
                          lr=t["lr"], seed=ctx.derived_seed(1),
                          checkpoint_every=0, compressed_obs=True)


def _batches(ctx: common.Context) -> list:
    d, p = ctx.config["dynamics"], ctx.traffic
    return traffic.replay_batches(ctx.rng(2), p["batches"],
                                  ctx.config["train"]["batch_size"],
                                  d["image_size"], p["pool_blocks"],
                                  d["action_dim"])


def run(ctx: common.Context) -> Outcome:
    marks = common.Marks(ctx.wall0)
    marks("started")
    common.call_prepare(ctx.prepare)
    from detex_tpu_torch.mpc import train_loop as TL
    marks("imported")
    p = ctx.traffic
    device = ctx.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    common.set_precision(device)
    cfg = _train_config(ctx)
    optimizers = []
    hook = register_optimizer_step_post_hook(
        lambda opt, args, kwargs: optimizers or optimizers.append(opt))
    tracer = Tracer(ctx.trace, device)
    env = ReplayEnv(_batches(ctx), p["warmup_steps"], ctx.seconds, tracer,
                    p["trace_seconds"], device, optimizers, marks)
    marks("inputs")
    log = LossLog()
    try:
        TL.train(cfg, metrics=log, env=env, device=device)
        raise RuntimeError("train() ended before the window closed")
    except StopWindow:
        common.sync(device)
        env.window.close()
    finally:
        hook.remove()
    if tracer.running:
        tracer.stop()
        env.traced_steps, env.trace_stopped = env.steps, env.window.t_close
    peak = common.peak_bytes(device)
    optimizers.clear()
    common.free(device)
    batch = cfg.batch_size
    summary = None
    if ctx.trace:
        from dtxbench import flops
        summary = tracer.finish({
            "units": env.traced_steps * batch,
            "untraced_units": (env.steps - env.traced_steps) * batch,
            "untraced_s": env.window.t_close - env.trace_stopped,
            "flops_per_unit": flops.train_flops_per_sample(
                ctx.config["dynamics"])})
        summary["chips"] = 1
    checks = judge(ctx, device, log.loss.get(0), env.first_moment,
                   env.params_after)
    return Outcome(
        attempted=env.steps, failed=0,
        metrics={"train_samples_per_s": env.steps * batch
                 / env.window.length,
                 "setup_s": env.wall_open - ctx.wall0},
        checks=checks, memory_peak_bytes=peak, chips=1, trace=summary,
        notes={"forbidden": common.forbidden_modules(), "marks": marks.at})


def reference_steps(ctx: common.Context, device, prec):
    """The reference's three AdamW steps from the seed's parameters on the
    first three batches: (step 1's loss, the first gradients, each leaf's
    change over the three steps), leaves in sorted-key order."""
    d, t = ctx.config["dynamics"], ctx.config["train"]
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.derived_seed(1))
    params = ref.init_params(d, gen)
    names_tensors = ref.leaves(params)
    start = [x.detach().clone() for _, x in names_tensors]
    tensors = [x.requires_grad_(True) for _, x in names_tensors]
    state = [[torch.zeros_like(x), torch.zeros_like(x)] for x in tensors]
    side = d["image_size"]
    first_loss = first_grads = None
    for step, batch in enumerate(_batches(ctx)[:CHANGE_STEPS]):
        images = {}
        for key in ("obs_words", "next_obs_words"):
            words = batch[key]
            blocks = torch.from_numpy(traffic.blocks_of(words.reshape(-1, 4)))
            pix, _ = ref_bc7.decode(blocks.to(device))
            n = words.shape[0]
            images[key] = pix.reshape(n, -1, 16, 4).reshape(
                n, side // 4, side // 4, 4, 4, 4).permute(0, 1, 3, 2, 4, 5) \
                .reshape(n, side, side, 4)
        action = torch.from_numpy(batch["action"]).to(device)
        loss = ref.loss(params, images["obs_words"], action,
                        images["next_obs_words"], prec)
        grads = torch.autograd.grad(loss, tensors)
        if step == 0:
            first_loss = float(loss.detach())
            first_grads = [g.detach().clone() for g in grads]
        ref.adamw_step(tensors, grads, state, step + 1, t["lr"])
    change = [x.detach() - s for x, s in zip(tensors, start)]
    return first_loss, first_grads, change, start


def _worst_leaf(got: list, want: list, keep=None) -> float:
    """Over the leaves (those where keep is true), the largest gap between
    the norms of `got` and `want`, over the larger of the leaf's reference
    norm and the median leaf's."""
    norms = [float(w.norm()) for w in want]
    median = float(np.median(norms))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if keep is not None and not keep[i]:
            continue
        gap = abs(float(g.float().norm()) - norms[i])
        worst = max(worst, gap / max(norms[i], median, 1e-30))
    return worst


def judge(ctx: common.Context, device, loss0, first_moment,
          params_after) -> list:
    loss_ref, grads_ref, change_ref, start = reference_steps(
        ctx, device, ref.BF16)
    if ctx.variant == "control":
        loss0, grads, change, _ = reference_steps(ctx, device, ref.FP8)
        grads = [g.cpu() for g in grads]
        change = [c.cpu() for c in change]
    else:
        grads = [m / (1 - BETA1) for m in first_moment]
        change = [a - s.cpu() for a, s in zip(params_after, start)]
    gnorms = [float(g.norm()) for g in grads_ref]
    moved = [n >= 1e-3 * float(np.median(gnorms)) for n in gnorms]
    limits = ctx.cell["limits"]
    return [
        Check("loss_rel_gap", abs(loss0 - loss_ref) / abs(loss_ref),
              limits["loss_rel_gap"]),
        Check("first_grad_norm_gap",
              _worst_leaf(grads, [g.cpu() for g in grads_ref]),
              limits["first_grad_norm_gap"]),
        Check("change_norm_gap",
              _worst_leaf(change, [c.cpu() for c in change_ref], moved),
              limits["change_norm_gap"])]

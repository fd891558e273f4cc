"""The compressed-observation training step in the steady state: the
counterpart of tools/bench_train_step.py.

    python -m detex_tpu_torch.tools.bench_train_step [--batch 64]
        [--image-size 64] [--steps 100] [--device cpu]

Shapes: batch 64 of 64x64 BC7-compressed observations (256 blocks each),
the latent-128 / hidden-512 dynamics model, bf16 on a card (float32 on the
CPU, as the JAX tool computes in float32 off the TPU).  Three timings, each
--steps steps after --warmup, back to back with nothing waiting for the
card (tools.step_times: CUDA events between steps, the host's enqueue time
beside them), in one row per program: "graph" (on a card; each step one
replay of its captured CUDA graph, train_loop._TrainGraph, the
counterpart of the jitted step the JAX tool times, captured before the
timing) and "eager" (launched op by op; the CPU has only this one):

  * the compressed-obs step: obs and next_obs decoded by
    runtime.decode_obs_batch (one csrc/bc7.cu launch each), then
    dynamics.train_step;
  * the raw-obs step: the same model on uint8 observations,
    (obs + i) & 0xFF;
  * decode only: the two decode_obs_batch calls.

The words are changed on the card each step (words ^ i), so the env's
numpy BC7 encode stays out of the rows; they come from
train_loop.CorpusReplayEnv(cfg, seed=0)._draw_words, whose pool is then
its 1,024 random blocks behind a valid mode prefix.  The decode share of
the compressed step is (compressed - raw) / compressed, cross-checked
against decode-only.  Each row's step gets parameters and an optimizer
of its own, from the same seed.

The compressed step checks itself: its loss on the first step against
dynamics.train_step called directly on the same parameters and batch,
decoded by the plain BC7 version on the CPU (rtol 1e-5: cuDNN's gradient
convs may sum in another order).  Prints one JSON line per program.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detex_tpu_torch import graphs, tools
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import train_loop as TL
from detex_tpu_torch.mpc.runtime import decode_obs_batch
from detex_tpu_torch.mpc.train_loop import CorpusReplayEnv
from detex_tpu_torch.ops import bptc

RTOL = 1e-5
_SEED = 0


def _model(dcfg: D.DynamicsConfig, device: torch.device) -> tuple:
    generator = torch.Generator(device=device)
    generator.manual_seed(_SEED)
    params = D.init_params(dcfg, generator, device)
    return params, D.make_optimizer(params)


def bench(dcfg: D.DynamicsConfig, b: int, device: torch.device,
          warmup: int, steps: int, program: str = "eager") -> dict:
    """The three rows' steps in `program` ("graph": each step one replay
    of its captured CUDA graph, train_loop._TrainGraph for the train steps
    and graphs.Graph for the decodes, captured before the timing starts;
    "eager": launched op by op): their card and host ms, the compressed
    step's BC7 launches per step and first loss, the captures' seconds."""
    s = dcfg.image_size
    env = CorpusReplayEnv(dcfg, seed=_SEED)
    rng = np.random.default_rng(_SEED)
    words = torch.from_numpy(env._draw_words(rng, b)).to(device)
    words2 = torch.from_numpy(env._draw_words(rng, b)).to(device)
    action = torch.from_numpy(rng.standard_normal((b, dcfg.action_dim))
                              .astype(np.float32)).to(device)
    obs_raw = torch.from_numpy(rng.integers(
        0, 256, (b, s, s, dcfg.channels), np.int64).astype(np.uint8)) \
        .to(device)
    obs_raw2 = torch.from_numpy(rng.integers(
        0, 256, (b, s, s, dcfg.channels), np.int64).astype(np.uint8)) \
        .to(device)
    graph = program == "graph"
    capture_s = 0.0 if graph else None
    first = {}

    params, opt = _model(dcfg, device)
    if graph:
        cgraph = TL._TrainGraph(params, opt, dcfg, b, True)
        cgraph.batch["action"].copy_(action)

    def compressed(i):
        if graph:
            cgraph.batch["obs_words"].copy_(words ^ i)
            cgraph.batch["next_obs_words"].copy_(words2 ^ i)
            loss = cgraph()
        else:
            batch = {"obs": decode_obs_batch(words ^ i, s, s),
                     "next_obs": decode_obs_batch(words2 ^ i, s, s),
                     "action": action}
            loss = D.train_step(params, opt, batch, dcfg)[1]
        if i == 0:
            first["loss"] = loss

    raw_params, raw_opt = _model(dcfg, device)
    if graph:
        rgraph = TL._TrainGraph(raw_params, raw_opt, dcfg, b, False)
        rgraph.batch["action"].copy_(action)

    def raw(i):
        obs = (obs_raw.to(torch.int32) + i) & 0xFF
        obs2 = (obs_raw2.to(torch.int32) + i) & 0xFF
        if graph:
            # copy_ casts into the static uint8 buffers (values 0-255).
            rgraph.batch["obs"].copy_(obs)
            rgraph.batch["next_obs"].copy_(obs2)
            rgraph()
        else:
            D.train_step(raw_params, raw_opt,
                         {"obs": obs, "next_obs": obs2, "action": action},
                         dcfg)

    acc = torch.zeros((), dtype=torch.int32, device=device)
    wbuf, wbuf2 = words.clone(), words2.clone()

    def decodes(w, w2):
        a = decode_obs_batch(w, s, s)
        c = decode_obs_batch(w2, s, s)
        return a.reshape(-1)[0] + c.reshape(-1)[0]
    if graph:
        dgraph = graphs.Graph(device)

    def decode_only(i):
        nonlocal acc
        if graph:
            wbuf.copy_(words ^ i)
            wbuf2.copy_(words2 ^ i)
            acc = acc + dgraph.replay()
        else:
            acc = acc + decodes(words ^ i, words2 ^ i)

    if graph:
        # Captured before the timing, on the first step's inputs; the
        # capture's warm-ups train, and the state is put back after them.
        for g in (cgraph, rgraph):
            g.capture()
            capture_s += g.capture_s
        dgraph.capture(lambda: decodes(wbuf, wbuf2))
        capture_s += dgraph.capture_s
    launches = bptc.KERNEL_LAUNCHES
    times = {"compressed": tools.step_times(compressed, device, warmup,
                                            steps)}
    launches = bptc.KERNEL_LAUNCHES - launches
    times["raw"] = tools.step_times(raw, device, warmup, steps)
    times["decode"] = tools.step_times(decode_only, device, warmup, steps)
    return {"times": times, "first_loss": first["loss"],
            "launches_per_step": launches / (warmup + steps),
            "capture_s": capture_s, "words": words, "words2": words2,
            "action": action}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tools.device_arg(ap)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    b, s = args.batch, args.image_size
    dcfg = D.DynamicsConfig(
        image_size=s, latent_dim=128, action_dim=8, hidden_dim=512,
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32)
    n_blocks = (s // 4) ** 2
    programs = ("graph", "eager") if device.type == "cuda" else ("eager",)
    rows = []
    for program in programs:
        out = bench(dcfg, b, device, args.warmup, args.steps, program)
        times = out["times"]
        # The first compressed step against train_step called directly.
        ref_params, ref_opt = _model(dcfg, device)
        ref_batch = {"obs": decode_obs_batch(out["words"].cpu(), s, s)
                     .to(device),
                     "next_obs": decode_obs_batch(out["words2"].cpu(), s, s)
                     .to(device), "action": out["action"]}
        want = float(D.train_step(ref_params, ref_opt, ref_batch, dcfg)[1])
        got = float(out["first_loss"])
        if not np.isfinite(got) or not abs(got - want) <= RTOL * abs(want):
            raise AssertionError(f"{program}: first compressed step's loss "
                                 f"{got!r} != train_step's {want!r} (rtol "
                                 f"{RTOL})")
        ms = {k: tools.spread(v[0])["median"] for k, v in times.items()}
        host = {k: tools.spread(v[1])["median"] for k, v in times.items()}
        row = {
            "metric": "compressed_obs_train_step", "program": program,
            "batch": b,
            "obs": f"{s}x{s} BC7 ({n_blocks} blocks), replay corpus pool",
            "model": f"latent-{dcfg.latent_dim}/hidden-{dcfg.hidden_dim} "
                     + ("bf16" if dcfg.compute_dtype == torch.bfloat16
                        else "f32"),
            "ms_per_step_compressed": ms["compressed"],
            "ms_per_step_raw_obs": ms["raw"],
            "steps_per_s": 1e3 / ms["compressed"],
            "decode_overhead_ms": ms["compressed"] - ms["raw"],
            "decode_only_ms": ms["decode"],
            "decode_share_pct": 100 * (ms["compressed"] - ms["raw"])
            / ms["compressed"],
            "decode_blocks_per_step": 2 * b * n_blocks,
            "host_enqueue_ms_compressed": host["compressed"],
            "host_enqueue_ms_raw_obs": host["raw"],
            "host_enqueue_ms_decode_only": host["decode"],
            "p10_p90_ms_compressed": [
                tools.spread(times["compressed"][0])[k]
                for k in ("p10", "p90")],
            "warmup": args.warmup, "steps": args.steps,
            "bc7_launches_per_step": out["launches_per_step"],
            "capture_s": out["capture_s"],
            "first_loss": got, "first_loss_train_step": want,
            "platform": device.type, "device": tools.card(device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

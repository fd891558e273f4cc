"""The compressed-observation training step in the steady state: the
counterpart of tools/bench_train_step.py.

    python -m detex_tpu_torch.tools.bench_train_step [--batch 64]
        [--image-size 64] [--steps 100] [--device cpu]

Shapes: batch 64 of 64x64 BC7-compressed observations (256 blocks each),
the latent-128 / hidden-512 dynamics model, bf16 on a card (float32 on the
CPU, as the JAX tool computes in float32 off the TPU).  Three rows, each
--steps steps after --warmup, back to back with nothing waiting for the
card (tools.step_times: CUDA events between steps, the host's enqueue time
beside them):

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
convs may sum in another order).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detex_tpu_torch import tools
from detex_tpu_torch.mpc import dynamics as D
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

    env = CorpusReplayEnv(dcfg, seed=_SEED)
    rng = np.random.default_rng(_SEED)
    words = torch.from_numpy(env._draw_words(rng, b)).to(device)
    words2 = torch.from_numpy(env._draw_words(rng, b)).to(device)
    action = torch.from_numpy(rng.standard_normal((b, 8)).astype(
        np.float32)).to(device)
    obs_raw = torch.from_numpy(rng.integers(
        0, 256, (b, s, s, dcfg.channels), np.int64).astype(np.uint8)) \
        .to(device)
    obs_raw2 = torch.from_numpy(rng.integers(
        0, 256, (b, s, s, dcfg.channels), np.int64).astype(np.uint8)) \
        .to(device)

    params, opt = _model(dcfg, device)
    first = {}

    def compressed(i):
        batch = {"obs": decode_obs_batch(words ^ i, s, s),
                 "next_obs": decode_obs_batch(words2 ^ i, s, s),
                 "action": action}
        loss = D.train_step(params, opt, batch, dcfg)[1]
        if i == 0:
            first["loss"] = loss

    raw_params, raw_opt = _model(dcfg, device)

    def raw(i):
        batch = {"obs": (obs_raw.to(torch.int32) + i) & 0xFF,
                 "next_obs": (obs_raw2.to(torch.int32) + i) & 0xFF,
                 "action": action}
        D.train_step(raw_params, raw_opt, batch, dcfg)

    acc = torch.zeros((), dtype=torch.int32, device=device)

    def decode_only(i):
        nonlocal acc
        a = decode_obs_batch(words ^ i, s, s)
        c = decode_obs_batch(words2 ^ i, s, s)
        acc = acc + a.reshape(-1)[0] + c.reshape(-1)[0]

    launches = bptc.KERNEL_LAUNCHES
    times = {"compressed": tools.step_times(compressed, device, args.warmup,
                                            args.steps)}
    launches = bptc.KERNEL_LAUNCHES - launches
    times["raw"] = tools.step_times(raw, device, args.warmup, args.steps)
    times["decode"] = tools.step_times(decode_only, device, args.warmup,
                                       args.steps)

    # The first compressed step against train_step called directly.
    ref_params, ref_opt = _model(dcfg, device)
    ref_batch = {"obs": decode_obs_batch(words.cpu(), s, s).to(device),
                 "next_obs": decode_obs_batch(words2.cpu(), s, s)
                 .to(device), "action": action}
    want = float(D.train_step(ref_params, ref_opt, ref_batch, dcfg)[1])
    got = float(first["loss"])
    if not np.isfinite(got) or not abs(got - want) <= RTOL * abs(want):
        raise AssertionError(f"first compressed step's loss {got!r} != "
                             f"train_step's {want!r} (rtol {RTOL})")

    ms = {k: tools.spread(v[0])["median"] for k, v in times.items()}
    host = {k: tools.spread(v[1])["median"] for k, v in times.items()}
    row = {
        "metric": "compressed_obs_train_step", "batch": b,
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
        "p10_p90_ms_compressed": [tools.spread(times["compressed"][0])[k]
                                  for k in ("p10", "p90")],
        "warmup": args.warmup, "steps": args.steps,
        "bc7_launches_per_step": launches / (args.warmup + args.steps),
        "first_loss": got, "first_loss_train_step": want,
        "platform": device.type, "device": tools.card(device)}
    print(json.dumps(row), flush=True)
    return [row]


if __name__ == "__main__":
    main()

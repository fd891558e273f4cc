"""Texture pipelines with their words already on the card: the counterpart
of tools/bench_pipelines.py (BASELINE.md configs 2 and 4).

    python -m detex_tpu_torch.tools.bench_pipelines [etc] [bc6h]
        [--side 1024] [--batch 64] [--image-size 64] [--device cpu]

etc  (config 2): a 1024^2 ETC2_EAC texture (65,536 blocks) -> RGBA8
     through engine._device_pipeline: the etc2_eac kernel
     (csrc/etc_eac.cu), the zeroing of invalid blocks and the assembly, on
     the card, with no host copy.  Each step decodes words ^ i and its
     image replaces the last one (the JAX tool carries the image so that
     XLA cannot drop the assembly; torch runs every op anyway).  One row
     per program: "graph" (on a card; each step one replay of the
     pipeline's captured CUDA graph, the counterpart of the jitted
     pipeline the JAX tool times, captured before the timing) and "eager"
     (the same body launched op by op; the CPU has only this one).
bc6h (config 4): BC6H HDR blocks (csrc/bc6h.cu) -> FLOAT_RGB16 -> float32
     (convert_device.f16_bits_to_f32_bits) -> dynamics.encode at
     DynamicsConfig(image_size=64, channels=3), batch 64; beside it the
     decode and unpack alone (decode_unpack_standalone_ms) and the kernel
     alone (decode_kernel_only_ms): the JAX tool's run_fn,
     run_decode_only and run_kernel_only.  Rows as for etc: "graph" (on
     a card; each of the three bodies captured as one CUDA graph,
     graphs.Graph, before the timing; the step index lives on the card
     as an int32 that each replay xors into the words and then advances,
     its last op, so that a step is one replay, as the JAX tool's w ^ i
     lies inside its program) and "eager" (the bodies launched op by
     op, words ^ i on the host's i; the CPU has only this one).

Times come from tools.step_times (CUDA events between steps, --steps
steps after --warmup, nothing waiting for the card in between); a row's
ms is the median, with p10, p90 and the host's enqueue median beside it.

Each row checks itself: the ETC2_EAC image of the first step byte-equal to
engine.decompress_texture_linear(tex, RGBA8, backend="native"), and the
BC6H step's images and latents equal to the same step with the plain BC6H
version swapped in; the BC6H graph row's first images also bit-equal to
the eager step's and its latents within LATENT_RTOL of them.  Prints one
JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from detex_tpu_torch import convert_device as CD
from detex_tpu_torch import engine, graphs, tools
from detex_tpu_torch import formats as F
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.ops import bptc_float, etc
from detex_tpu_torch.texture import Texture

_FULL = 0xFFFFFFFF
LATENT_RTOL = 1e-6   # of the largest latent: the same ops on equal images


def _timed(step, device, args) -> dict:
    card_ms, host_ms = tools.step_times(step, device, args.warmup,
                                        args.steps)
    ms = tools.spread(card_ms)
    return {"ms": ms["median"], "p10_ms": ms["p10"], "p90_ms": ms["p90"],
            "host_ms": tools.spread(host_ms)["median"]}


def bench_etc_pipeline(device: torch.device, args,
                       program: str = "eager") -> dict:
    """Config 2: ETC2_EAC texture -> RGBA8 on the card, in `program`:
    "graph", engine._device_pipeline (one replay of its captured CUDA
    graph a step, captured before the timing), or "eager", its body
    (engine._pipeline_body) launched op by op."""
    side = args.side
    wb = hb = side // 4
    n_blocks = wb * hb
    words_np = np.random.default_rng(1).integers(
        -2**31, 2**31, (n_blocks, 4), np.int64).astype(np.int32)
    words = torch.from_numpy(words_np).to(device)
    capture_s = None
    if program == "graph":
        pipeline = engine._device_pipeline(F.ETC2_EAC, F.RGBA8, wb, hb, side,
                                           side)
        pipeline(words, _FULL, 0)           # the key's first call: eager
        t0 = time.perf_counter()
        pipeline(words, _FULL, 0)           # its second: the capture
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - t0
    else:
        body = engine._pipeline_body(F.ETC2_EAC, F.RGBA8, wb, hb, side,
                                     side, False, _FULL, 0)

        def pipeline(w, mode_mask, flags):
            return body(w)
    carry = {}

    def step(i):
        carry["img"] = pipeline(words ^ i, _FULL, 0)
        if i == 0:
            # A graph's output is overwritten by the next step's.
            carry["first"] = carry["img"].clone()

    launches = etc.KERNEL_LAUNCHES["etc2_eac"]
    t = _timed(step, device, args)
    launches = etc.KERNEL_LAUNCHES["etc2_eac"] - launches
    tex = Texture.new(F.ETC2_EAC, words_np.view(np.uint8), side, side)
    want = engine.decompress_texture_linear(tex, F.RGBA8, backend="native")
    if not np.array_equal(CD.to_bytes(carry["first"]), want):
        raise AssertionError(f"{program}: the ETC2_EAC pipeline's image "
                             f"differs from the native decode's")
    return {"metric": "etc2_eac_texture_to_rgba8_blocks_per_s",
            "program": program,
            "value": n_blocks / t["ms"] * 1e3, "unit": "blocks/s",
            "ms_per_1024sq_texture": t["ms"], "side": side,
            "p10_ms": t["p10_ms"], "p90_ms": t["p90_ms"],
            "host_ms_per_step": t["host_ms"],
            "etc2_eac_launches_per_step":
                launches / (args.warmup + args.steps),
            "capture_s": capture_s,
            "bytes_equal_native": True}


def decode_to_img(words: torch.Tensor, batch: int,
                  image_size: int) -> torch.Tensor:
    """(batch * n_blocks, 4) BC6H words -> (batch, H, W, 3) float32 images:
    decode (FLOAT_RGBX16), drop X (FLOAT_RGB16), half -> float32 bits,
    invalid blocks zero, blocks to rows."""
    pix, valid = bptc_float.decode_bptc_float(words)
    half = pix.view(torch.int16).reshape(-1, 4)[:, :3]
    f = CD.f16_bits_to_f32_bits(half).view(torch.float32)
    hb = wb = image_size // 4
    f = f.reshape(batch, hb * wb, 16, 3)
    f = torch.where(valid.reshape(batch, hb * wb)[..., None, None], f, 0.0)
    return f.reshape(batch, hb, wb, 4, 4, 3).permute(0, 1, 3, 2, 4, 5) \
        .reshape(batch, image_size, image_size, 3)


def _latent_diff(z: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Max |z - want|; raises unless z is finite and within LATENT_RTOL of
    the largest latent of `want` (at least 1)."""
    scale = max(1.0, float(want.abs().max()))
    diff = float((z - want).abs().max())
    if not torch.isfinite(z).all() or not diff <= LATENT_RTOL * scale:
        raise AssertionError(f"BC6H latents differ from {what} by "
                             f"{diff:.3g} (largest {scale:.3g})")
    return diff


def _graphed(fn, words: torch.Tensor) -> tuple:
    """fn(words ^ i) as one captured CUDA graph: i is an int32 on the card
    that each replay xors into the words and then advances, its last op,
    so that replay k runs fn(words ^ k), as the JAX tool's fori_loop body
    runs step(w ^ i).  The warm-ups' advances are undone before the
    capture.  Returns (the graph, i).  The graph holds i's address, not
    the tensor: the caller keeps i as long as it replays, or the allocator
    hands its memory to another tensor."""
    i_dev = torch.zeros((), dtype=torch.int32, device=words.device)

    @torch.no_grad()
    def body():
        out = fn(words ^ i_dev)
        i_dev.add_(1)
        return out
    graph = graphs.Graph(words.device)
    graph.capture(body, i_dev.zero_)
    return graph, i_dev


def bench_bc6h_encoder(device: torch.device, args,
                       program: str = "eager") -> dict:
    """Config 4: BC6H -> FLOAT_RGB16 -> float32 -> latent encoder, in
    `program`: "graph", the full step, the decode and unpack, and the
    kernel each one replay of its captured CUDA graph (captured before the
    timing), or "eager", the same bodies launched op by op."""
    batch, size = args.batch, args.image_size
    dcfg = D.DynamicsConfig(image_size=size, channels=3)
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = D.init_params(dcfg, generator, device)
    n_blocks = (size // 4) ** 2
    words = torch.from_numpy(np.random.default_rng(2).integers(
        -2**31, 2**31, (batch * n_blocks, 4), np.int64).astype(np.int32)) \
        .to(device)

    def encoded(w):
        img = decode_to_img(w, batch, size)
        return img, D.encode(params, img, dcfg)

    def unpacked(w):
        return decode_to_img(w, batch, size)

    capture_s, carry, programs = None, {}, {}
    if program == "graph":
        programs = {"full": _graphed(encoded, words),
                    "unpack": _graphed(unpacked, words),
                    "kernel": _graphed(bptc_float.decode_bptc_float, words)}
        capture_s = programs["full"][0].capture_s

        def full(i):
            out = programs["full"][0].replay()
            if i == 0:
                # A graph's output is overwritten by the next replay's.
                carry["first"] = tuple(t.clone() for t in out)

        def unpack(i):
            programs["unpack"][0].replay()

        def kernel(i):
            programs["kernel"][0].replay()
    else:
        acc = {"z": torch.zeros((), device=device)}

        @torch.no_grad()
        def full(i):
            _, z = encoded(words ^ i)
            acc["z"] = acc["z"] + z[0, 0]

        def unpack(i):
            acc["img"] = unpacked(words ^ i)

        def kernel(i):
            acc["pix"] = bptc_float.decode_bptc_float(words ^ i)

    launches = bptc_float.KERNEL_LAUNCHES["bptc_float"]
    t = _timed(full, device, args)
    launches = bptc_float.KERNEL_LAUNCHES["bptc_float"] - launches
    t_dec = _timed(unpack, device, args)
    t_k = _timed(kernel, device, args)
    for name, (_, i_dev) in programs.items():
        if int(i_dev) != args.warmup + args.steps:
            raise AssertionError(f"the {name} graph's step index reads "
                                 f"{int(i_dev)} after "
                                 f"{args.warmup + args.steps} replays")

    # The full step with the plain BC6H version swapped in.
    out = []
    kernel_decode = bptc_float.decode_bptc_float
    for decode in (kernel_decode, bptc_float.decode_bptc_float_plain):
        bptc_float.decode_bptc_float = decode
        try:
            img = decode_to_img(words, batch, size)
        finally:
            bptc_float.decode_bptc_float = kernel_decode
        with torch.no_grad():
            out.append((img, D.encode(params, img, dcfg)))
    (img_k, z_k), (img_p, z_p) = out
    if not torch.equal(img_k, img_p):
        raise AssertionError("BC6H images differ between the kernel and "
                             "the plain version")
    diff = _latent_diff(z_k, z_p, "the plain version's")
    row = {"metric": "bc6h_hdr_to_latent_images_per_s",
           "program": program,
           "value": batch / t["ms"] * 1e3, "unit": "images/s",
           "ms_per_batch64": t["ms"], "batch": batch,
           "image_size": size, "p10_ms": t["p10_ms"],
           "p90_ms": t["p90_ms"], "host_ms_per_step": t["host_ms"],
           "decode_kernel_only_ms": t_k["ms"],
           "decode_kernel_share_pct": 100 * t_k["ms"] / t["ms"],
           "decode_unpack_standalone_ms": t_dec["ms"],
           "blocks_per_s": batch * n_blocks / t["ms"] * 1e3,
           "bc6h_launches_per_step": launches / (args.warmup + args.steps),
           "capture_s": capture_s,
           "latent_max_diff_vs_plain": diff}
    if program == "graph":
        # The graph's first step (words ^ 0) against the eager step's.
        img_g, z_g = carry["first"]
        if not torch.equal(img_g, img_k):
            raise AssertionError("BC6H images differ between the graph and "
                                 "the eager step")
        row["latent_max_diff_vs_eager"] = _latent_diff(z_g, z_k,
                                                       "the eager step's")
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tools.device_arg(ap)
    ap.add_argument("which", nargs="*", default=["etc", "bc6h"],
                    help="etc, bc6h or both (the default)")
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    if set(args.which) - {"etc", "bc6h"}:
        ap.error(f"unknown pipelines {set(args.which) - {'etc', 'bc6h'}}")
    device = tools.open_device(args.device)
    card = tools.card(device)
    programs = ("graph", "eager") if device.type == "cuda" else ("eager",)
    runs = []
    if "etc" in args.which:
        runs += [lambda p=p: bench_etc_pipeline(device, args, p)
                 for p in programs]
    if "bc6h" in args.which:
        runs += [lambda p=p: bench_bc6h_encoder(device, args, p)
                 for p in programs]
    rows = []
    for run in runs:
        row = dict(run(), warmup=args.warmup, steps=args.steps,
                   platform=device.type, device=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

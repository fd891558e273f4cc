"""Texture calls back to back: `engine.decompress_texture_linear(tex,
pixel_format, backend="device")` from the texture's bytes on the host to
the image's bytes on the host, on a pool of textures of one size made from
the seed, in turn.  The key repeats, as for a renderer streaming one size,
so from the second call every call replays the key's captured graph.

Traffic parameters (workloads/<cell>.json "params"):
  format, pixel_format  the compressed format and the target (format
                        names of detex_tpu_torch.formats);
  pool                  textures in the pool;
  invalid_share         the share of each texture's blocks made invalid
                        (the reference decodes them to zeros);
  warmup_calls          calls in set-up (the second captures the graph);
  checked_calls         calls of the window whose bytes are judged;
  trace_seconds         the first part of the window --trace 1 profiles.

`correct`: the checked calls' bytes against the plain decoder of the
format (reference/<format>.py, found by name) on the same texture: the number
of bytes that differ (the configuration states bit-exact output) and the
number of checked calls whose output has the wrong length.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from dtxbench import common
from dtxbench.common import Check, Outcome, span
from dtxbench.trace import Tracer


def _reference(ctx: common.Context):
    """The cell's format's reference module, reference/<format>.py: its
    random valid blocks and its plain decode."""
    return importlib.import_module(
        f"dtxbench.reference.{ctx.traffic['format'].lower()}")


def _pool(ctx: common.Context) -> list:
    """The cell's textures, flat bytes, from the seed."""
    c, rng = ctx.config, ctx.rng(1)
    n = (c["width"] // 4) * (c["height"] // 4)
    share = ctx.traffic.get("invalid_share", 0.0)
    return [_reference(ctx).random_blocks(rng, n, invalid_share=share).ravel()
            for _ in range(ctx.traffic["pool"])]


def run(ctx: common.Context) -> Outcome:
    marks = common.Marks(ctx.wall0)
    marks("started")
    common.call_prepare(ctx.prepare)
    from detex_tpu_torch import engine
    from detex_tpu_torch import formats as F
    from detex_tpu_torch.texture import Texture
    marks("imported")
    p, c = ctx.traffic, ctx.config
    device = ctx.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    common.set_precision(device)
    fmt, pf = getattr(F, p["format"]), getattr(F, p["pixel_format"])
    width, height = c["width"], c["height"]
    n_blocks = (width // 4) * (height // 4)
    pool = [Texture.new(fmt, data, width, height) for data in _pool(ctx)]
    size = width * height * F.pixel_size(pf)
    marks("inputs")

    def call(i):
        return engine.decompress_texture_linear(
            pool[i % len(pool)], pf, backend="device", device=device)

    warm_s = []
    for i in range(p["warmup_calls"]):
        t = time.perf_counter()
        call(i)
        warm_s.append(time.perf_counter() - t)
        marks(f"call{i}")
    expected = int(ctx.seconds / warm_s[-1])
    checked = common.pick(ctx.rng(2), expected, p["checked_calls"])

    tracer = Tracer(ctx.trace, device)
    kept, failed, traced = {}, 0, None
    common.sync(device)
    tracer.start()
    window = common.Window(ctx.seconds)
    window.open()
    wall_open = time.time()
    j = 0
    while not window.over():
        i = p["warmup_calls"] + j
        if tracer.running:
            with span("dtxbench.call"):
                out = call(i)
        else:
            out = call(i)
        if out.size != size:
            failed += 1
        if j in checked:
            kept[i] = out
        j += 1
        if tracer.running and tracer.due(p["trace_seconds"]):
            tracer.stop()
            traced = j
    window.close()
    if tracer.running:
        tracer.stop()
        traced = j
    peak = common.peak_bytes(device)
    common.free(device)
    summary = None
    if ctx.trace:
        summary = tracer.finish({"calls": traced, "blocks_per_call": n_blocks})
        summary["chips"] = 1
    checks = judge(ctx, device, kept)
    return Outcome(
        attempted=j, failed=failed,
        metrics={"texture_blocks_per_s": j * n_blocks / window.length,
                 "setup_s": wall_open - ctx.wall0},
        checks=checks, memory_peak_bytes=peak, chips=1, trace=summary,
        notes={"forbidden": common.forbidden_modules(), "marks": marks.at})


def judge(ctx: common.Context, device, kept: dict) -> list:
    """Bytes of the checked calls that differ from the reference's image
    (the control's image in their place where ctx.variant is "control"),
    and checked calls of the wrong length."""
    c, p = ctx.config, ctx.traffic
    reference = _reference(ctx)
    pool = _pool(ctx)
    differing, wrong_length = 0, 0
    for i, out in sorted(kept.items()):
        blocks = torch.from_numpy(pool[i % len(pool)].reshape(-1, 16))

        def image(control):
            return reference.texture(blocks.to(device), c["width"],
                                     c["height"], p["pixel_format"],
                                     control).cpu().numpy()
        want = image(False)
        got = image(True) if ctx.variant == "control" else out
        if got.size != want.size:
            wrong_length += 1
            continue
        differing += int(np.count_nonzero(got != want))
    limits = ctx.cell["limits"]
    return [Check("texture_bytes_differing", differing,
                  limits["texture_bytes_differing"]),
            Check("texture_wrong_length", wrong_length,
                  limits["texture_wrong_length"])]

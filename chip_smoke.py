"""Smoke run of the PyTorch port (detex_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the BC7 CUDA kernel from detex_tpu_torch/csrc, holds it bit-exact
against its plain PyTorch version and the golden vectors, times both,
then serves 5 requests through the full-width control step
(ControllerConfig(): 64x64 BC7 observation, 8192 x 32 MPPI rollouts,
bf16 compute) with a Controller on the card.  Every phase raises on
failure, so any failure exits non-zero.  Last line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports no JAX.  Needs a CUDA card; without one it exits non-zero before
printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from detex_tpu_torch import _build
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import runtime as R
from detex_tpu_torch.ops import bptc

_REPO = Path(__file__).resolve().parent
_GOLDEN = _REPO / "tests" / "golden" / "BPTC.npz"
_FULL = 0xFFFFFFFF
_SEED = 0


def _device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script only "
                         "runs on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    # TF32 off, as in the tests: float32 matmuls and convs stay float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    return smi


def _build_kernels() -> float:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    print(f"build: {path.relative_to(_REPO)} in {seconds:.2f} s")
    for line in (path.parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return seconds


def _words(blocks_u8: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(blocks_u8).view(np.int32)
                            .copy()).cuda()


def _test_blocks(rng) -> np.ndarray:
    """65,536 random blocks, then 64 for each of the 8 mode prefixes and
    64 with byte 0 == 0 (no mode)."""
    parts = [rng.integers(0, 256, (65536, 16), np.uint8)]
    for mode in range(9):
        b = rng.integers(0, 256, (64, 16), np.uint8)
        b[:, 0] = 0 if mode == 8 else \
            (b[:, 0] | (1 << mode)) & (0xFF ^ ((1 << mode) - 1))
        parts.append(b)
    return np.concatenate(parts)


def _compare(words: torch.Tensor, mode_mask: int, flags: int) -> int:
    """Kernel vs plain version on the card, every pixel and valid flag.
    Returns the largest absolute difference of the packed words (0)."""
    p_k, v_k = bptc.decode_bptc(words, mode_mask, flags)
    p_p, v_p = bptc.decode_bptc_plain(words, mode_mask, flags)
    torch.cuda.synchronize()
    err = int((p_k.long() - p_p.long()).abs().max())
    if err or not torch.equal(v_k, v_p):
        bad = int(((p_k != p_p).any(1) | (v_k != v_p)).sum())
        raise AssertionError(f"BC7 kernel != plain version on {bad} of "
                             f"{len(words)} blocks (mask {mode_mask:#x}, "
                             f"flags {flags})")
    return err


def _check_golden() -> int:
    """Kernel vs tests/golden/BPTC.npz (valid blocks; the reference leaves
    invalid blocks' pixels unwritten, so the goldens hold zeros there) and
    vs the plain version on every block."""
    g = np.load(_GOLDEN)
    cases = [("corpus", "corpus_blocks", _FULL, 0, "corpus_out",
              "corpus_valid"),
             ("random", "random_blocks", _FULL, 0, "random_out",
              "random_valid")]
    vi = 0
    while f"variant{vi}_out" in g:
        mm, fl = int(g[f"variant{vi}_mask"]), int(g[f"variant{vi}_flags"])
        cases.append((f"variant{vi}", "random_blocks", mm, fl,
                      f"variant{vi}_out", f"variant{vi}_valid"))
        cases.append((f"variant{vi}_corpus", "corpus_blocks", mm, fl,
                      f"variant{vi}_corpus_out",
                      f"variant{vi}_corpus_valid"))
        vi += 1
    err = 0
    for name, blocks, mm, fl, out_key, valid_key in cases:
        words = _words(g[blocks])
        pix, valid = bptc.decode_bptc(words, mm, fl)
        valid = valid.cpu().numpy()
        out = pix.cpu().numpy().view(np.uint8).reshape(len(valid), -1)
        out = np.where(valid[:, None], out, 0)
        if not (np.array_equal(valid, g[valid_key])
                and np.array_equal(out, g[out_key])):
            raise AssertionError(f"BC7 kernel != golden vectors ({name})")
        err = max(err, _compare(words, mm, fl))
    print(f"golden: BC7 kernel bit-exact on {len(cases)} golden sets "
          f"(corpus, random, {vi} mask/flags variants)")
    return err


def _time_ms(fn, reps: int = 21, inner: int = 20) -> float:
    """Median over reps of the mean time per call of `inner` back-to-back
    calls, by CUDA events (host enqueue included where it is slower than
    the device)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _kernel_phase(rng) -> dict:
    err = _check_golden()
    blocks = _test_blocks(rng)
    words = _words(blocks)
    for mm, fl in ((_FULL, 0), (0x55, 2), (0xAA, 4), (0, 0)):
        err = max(err, _compare(words, mm, fl))
    # The main path's shape: one 64x64 observation, 256 blocks.
    err = max(err, _compare(words[:256].contiguous(), _FULL, 0))
    print(f"bits: BC7 kernel bit-exact (tolerance 0) vs plain version on "
          f"the card, {len(blocks)} blocks x 4 mask/flags settings and "
          f"N=256, invalid blocks included")
    times = {}
    for n in (256, 65536):
        w = words[:n].contiguous()
        # Alternate kernel and plain version so drift hits both.
        k1 = _time_ms(lambda: bptc.decode_bptc(w))
        p1 = _time_ms(lambda: bptc.decode_bptc_plain(w), inner=5)
        p2 = _time_ms(lambda: bptc.decode_bptc_plain(w), inner=5)
        k2 = _time_ms(lambda: bptc.decode_bptc(w))
        times[n] = (min(k1, k2), min(p1, p2))
        print(f"time: N={n}: kernel {k1:.5f} / {k2:.5f} ms, plain "
              f"{p1:.5f} / {p2:.5f} ms per call")
    return {"max_abs_err": err, "ms": times[256][0],
            "plain_ms": times[256][1], "ms_65536": times[65536][0],
            "plain_ms_65536": times[65536][1]}


def _main_path(rng, smi: str) -> int:
    cfg = R.ControllerConfig()
    dcfg, mcfg = cfg.dynamics, cfg.mppi
    gen = torch.Generator(device="cuda")
    gen.manual_seed(_SEED)
    params = D.init_params(dcfg, gen, "cuda")
    goal_z = torch.zeros(dcfg.latent_dim, device="cuda")
    ctl = R.Controller(params, goal_z, cfg, seed=_SEED, device="cuda")
    n_blocks = (dcfg.image_size // 4) ** 2
    requests = [rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64)
                .astype(np.int32) for _ in range(5)]

    bptc.KERNEL_LAUNCHES = 0
    step_ms = []
    for words in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        action = ctl.step(words)          # returns on the host: synced
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if action.shape != (mcfg.action_dim,) or not np.isfinite(action).all():
            raise AssertionError(f"bad action {action!r}")
        if (action < mcfg.action_low).any() or \
                (action > mcfg.action_high).any():
            raise AssertionError(f"action out of bounds {action!r}")
        if not np.isfinite(float(ctl.diag["min_cost"])):
            raise AssertionError("min_cost is not finite")
    launches = bptc.KERNEL_LAUNCHES
    if launches != len(requests):
        raise AssertionError(f"BC7 kernel launched {launches} times in "
                             f"{len(requests)} control steps")
    print(f"main path: {len(requests)} control steps (64x64 BC7 obs, "
          f"{mcfg.n_rollouts} x {mcfg.horizon} MPPI, {dcfg.compute_dtype}); "
          f"BC7 kernel launches {launches}; last action "
          f"{np.array2string(action, precision=4)}; min_cost "
          f"{float(ctl.diag['min_cost']):.6g}, ess "
          f"{float(ctl.diag['ess']):.6g}")
    print(f"step ms: median {statistics.median(step_ms):.3f} "
          f"(each: {', '.join(f'{t:.3f}' for t in step_ms)}) on {smi}")

    # The same step with the kernel's decode and with the plain version's,
    # on the same injected noise: the image must be equal bit for bit, and
    # so the whole step (same ops on the same card; tolerance 1e-6 only
    # guards against a nondeterministic reduction order).
    words = torch.from_numpy(requests[0]).cuda()
    nominal = torch.zeros((mcfg.horizon, mcfg.action_dim), device="cuda")
    eps = torch.randn((mcfg.n_rollouts, mcfg.horizon, mcfg.action_dim),
                      generator=gen, device="cuda") * mcfg.noise_sigma
    img_k = R.decode_obs(words, dcfg.image_size, dcfg.image_size)
    out_k = R.control_step(params, nominal, None, words, goal_z, cfg,
                           eps=eps)
    kernel_decode = bptc.decode_bptc
    bptc.decode_bptc = bptc.decode_bptc_plain
    try:
        img_p = R.decode_obs(words, dcfg.image_size, dcfg.image_size)
        out_p = R.control_step(params, nominal, None, words, goal_z, cfg,
                               eps=eps)
    finally:
        bptc.decode_bptc = kernel_decode
    if not torch.equal(img_k, img_p):
        raise AssertionError("images differ between kernel and plain decode")
    for a, b in zip(out_k[:2], out_p[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    print("main path: kernel decode and plain decode give equal images and "
          f"actions (max action diff "
          f"{float((out_k[0] - out_p[0]).abs().max()):.3g})")
    return launches


def main() -> None:
    smi = _device()
    _build_kernels()
    rng = np.random.default_rng(_SEED)
    timing = _kernel_phase(rng)
    launches = _main_path(rng, smi)
    print(json.dumps({"kernels": [{
        "name": "bc7_decode", "route": "cuda",
        "source": "detex_tpu_torch/csrc/bc7.cu",
        "replaces": "detex_tpu/ops/pallas/bptc_pallas.py:240",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "ms_n65536": timing["ms_65536"],
        "plain_ms_n65536": timing["plain_ms_65536"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port (detex_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from detex_tpu_torch/csrc (one nvcc per source,
all at once) and drives the port's two paths:

  * the control step: the BC7 kernel held bit-exact against its plain
    PyTorch version and the golden vectors, timed, then 5 requests served
    through the full-width control step (ControllerConfig(): 64x64 BC7
    observation, 8192 x 32 MPPI rollouts, bf16) by a Controller;
  * the texture engine: the BC1/BC1A, BC2/BC3, RGTC1 and RGTC2 (signed
    and unsigned) kernels, the ETC1/ETC2/ETC2 punchthrough, ETC2_EAC,
    EAC R11 and RG11 (signed and unsigned) kernels and the BC6H kernel
    (BPTC_FLOAT, signed and unsigned) held bit-exact against the goldens
    and against their plain versions on 1,048,576 blocks with forced
    branches under 4 flag settings (ETC/EAC also under 6 mode masks, BC6H
    under 5 mode masks), then one 4096x4096 texture per format (a 4K mip,
    1,048,576 blocks) through engine.decompress_texture_linear(
    backend="device"), which decodes, converts the pixels and assembles on
    the card, and a BC3, an ETC2_EAC, an EAC_RG11 and a BPTC_FLOAT .ktx
    through the dtx-convert CLI, each byte-equal to the same call with the
    plain versions swapped in; the calls that convert (BC6H to half float,
    16-bit, 8-bit and HDR targets, RGTC1 and ETC2_EAC to other formats)
    also byte-equal to the torch backend, which converts on the host; and
    every kernel timed against its plain version, and the BC6H kernel on
    mode-mixed, mode-sorted and single-mode batches.

Each path's launch counts are set to 0 just before it and read just
after.  Every phase raises on failure, so any failure exits non-zero.
Last lines: the kernels JSON, the card's name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports no JAX.  Needs a CUDA card; without one it exits non-zero before
printing a result.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from detex_tpu import convert as C
from detex_tpu import formats as F
from detex_tpu import hdr
from detex_tpu import io as tio
from detex_tpu.texture import Texture
from detex_tpu_torch import _build, engine
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch.cli import convert as cli_convert
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import runtime as R
from detex_tpu_torch.ops import bc, bptc, bptc_float, eac, etc, rgtc
from detex_tpu_torch.ops.bitops import words_from_bytes

_REPO = Path(__file__).resolve().parent
_GOLDEN_DIR = _REPO / "tests" / "golden"
_GOLDEN = _GOLDEN_DIR / "BPTC.npz"
_FULL = 0xFFFFFFFF
_SEED = 0
_TEX = 4096                 # texture side: a 4K mip
_N_BIG = (_TEX // 4) ** 2   # its blocks, 1,048,576
_FLAGS = (0, 0x1, 0x2, 0x4)
# ETC/EAC: the flags at the full mode mask, then mode masks at flags 0.
_ETC_SETTINGS = tuple((_FULL, fl) for fl in _FLAGS) + tuple(
    (mm, 0) for mm in (0x1, 0x2, 0x4, 0x8, 0x10, 0x1A))
# BC6H: all 14 modes, every other mode (two ways), one mode of each size.
_BC6H_SETTINGS = tuple((mm, 0) for mm in (0x3FFF, 0x2AAA, 0x1555, 0x1000,
                                          0x2000))
# The HDR parameters of the HDR texture call: gamma 2.2, range [0, 4].
_HDR = (2.2, 0.0, 4.0)

# The texture path's variants: kernel, module, wrapper, golden family,
# block bytes.
_VARIANTS = {
    "bc1": ("bc1_decode", bc, "decode_bc1", "BC1", 8),
    "bc1a": ("bc1_decode", bc, "decode_bc1a", "BC1A", 8),
    "bc2": ("bc23_decode", bc, "decode_bc2", "BC2", 16),
    "bc3": ("bc23_decode", bc, "decode_bc3", "BC3", 16),
    "rgtc1": ("rgtc1_decode", rgtc, "decode_rgtc1", "RGTC1", 8),
    "signed_rgtc1": ("rgtc1_decode", rgtc, "decode_signed_rgtc1",
                     "SIGNED_RGTC1", 8),
    "rgtc2": ("rgtc2_decode", rgtc, "decode_rgtc2", "RGTC2", 16),
    "signed_rgtc2": ("rgtc2_decode", rgtc, "decode_signed_rgtc2",
                     "SIGNED_RGTC2", 16),
    "etc1": ("etc_decode", etc, "decode_etc1", "ETC1", 8),
    "etc2": ("etc_decode", etc, "decode_etc2", "ETC2", 8),
    "etc2_punchthrough": ("etc_decode", etc, "decode_etc2_punchthrough",
                          "ETC2_PUNCHTHROUGH", 8),
    "etc2_eac": ("etc2_eac_decode", etc, "decode_etc2_eac", "ETC2_EAC", 16),
    "eac_r11": ("eac_r11_decode", eac, "decode_eac_r11", "EAC_R11", 8),
    "eac_signed_r11": ("eac_r11_decode", eac, "decode_eac_signed_r11",
                       "EAC_SIGNED_R11", 8),
    "eac_rg11": ("eac_rg11_decode", eac, "decode_eac_rg11", "EAC_RG11", 16),
    "eac_signed_rg11": ("eac_rg11_decode", eac, "decode_eac_signed_rg11",
                        "EAC_SIGNED_RG11", 16),
    "bptc_float": ("bc6h_decode", bptc_float, "decode_bptc_float",
                   "BPTC_FLOAT", 16),
    "bptc_signed_float": ("bc6h_decode", bptc_float,
                          "decode_bptc_signed_float", "BPTC_SIGNED_FLOAT",
                          16),
}
# kernel -> (its source, the TPU kernel it replaces)
_BC_CU = "detex_tpu_torch/csrc/bc.cu"
_ETC_CU = "detex_tpu_torch/csrc/etc_eac.cu"
_ETC_PALLAS = "detex_tpu/ops/pallas/etc_eac_pallas.py"
_REPLACES = {
    "bc1_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:228"),
    "bc23_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:247"),
    "rgtc1_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:279"),
    "rgtc2_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:305"),
    "etc_decode": (_ETC_CU, f"{_ETC_PALLAS}:490, :509, :518"),
    "etc2_eac_decode": (_ETC_CU, f"{_ETC_PALLAS}:533"),
    "eac_r11_decode": (_ETC_CU, f"{_ETC_PALLAS}:546"),
    "eac_rg11_decode": (_ETC_CU, f"{_ETC_PALLAS}:559"),
    "bc6h_decode": ("detex_tpu_torch/csrc/bc6h.cu",
                    "detex_tpu/ops/pallas/bptc_float_pallas.py:128"),
}


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
    kernel = "?"
    for line in (path.parent / "nvcc.log").read_text().splitlines():
        m = re.search(r"Function properties for .*?((?:bc7|bc1|bc23|rgtc1|"
                      r"rgtc2|etc|etc2_eac|eac_r11|eac_rg11|bc6h)_kernel)"
                      r"(?:IL([bi])(\d+)E)?", line)
        if m:
            flag = "" if not m.group(2) else \
                f"<{m.group(3)}>" if m.group(2) == "i" else \
                f"<{'true' if m.group(3) == '1' else 'false'}>"
            kernel = m.group(1) + flag
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.strip()}")
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


def _compare(words: torch.Tensor, mode_mask: int, flags: int,
             kernel=bptc.decode_bptc, plain=bptc.decode_bptc_plain,
             name: str = "BC7") -> int:
    """Kernel vs plain version on the card, every pixel and valid flag.
    Returns the largest absolute difference of the packed words (0)."""
    p_k, v_k = kernel(words, mode_mask, flags)
    p_p, v_p = plain(words, mode_mask, flags)
    torch.cuda.synchronize()
    err = int((p_k.long() - p_p.long()).abs().max())
    if err or not torch.equal(v_k, v_p):
        bad = int(((p_k != p_p).any(1) | (v_k != v_p)).sum())
        raise AssertionError(f"{name} kernel != plain version on {bad} of "
                             f"{len(words)} blocks (mask {mode_mask:#x}, "
                             f"flags {flags})")
    return err


def _check_golden(golden: Path = _GOLDEN, kernel=bptc.decode_bptc,
                  plain=bptc.decode_bptc_plain, name: str = "BC7") -> int:
    """Kernel vs a golden npz (valid blocks; the reference leaves invalid
    blocks' pixels unwritten, so the goldens hold zeros there) and vs the
    plain version on every block."""
    g = np.load(golden)
    cases = [(s, f"{s}_blocks", _FULL, 0, f"{s}_out", f"{s}_valid")
             for s in ("corpus", "random") if f"{s}_blocks" in g]
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
    for case, blocks, mm, fl, out_key, valid_key in cases:
        words = _words(g[blocks])
        pix, valid = kernel(words, mm, fl)
        valid = valid.cpu().numpy()
        out = pix.cpu().numpy().view(np.uint8).reshape(len(valid), -1)
        out = np.where(valid[:, None], out, 0)
        if not (np.array_equal(valid, g[valid_key])
                and np.array_equal(out, g[out_key])):
            raise AssertionError(f"{name} kernel != golden vectors ({case})")
        err = max(err, _compare(words, mm, fl, kernel, plain, name))
    print(f"golden: {name} kernel bit-exact on {len(cases)} golden sets of "
          f"{golden.name} ({', '.join(c[0] for c in cases)})")
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


# --- the texture engine ------------------------------------------------------


def _branch_blocks(variant: str, n: int, rng) -> np.ndarray:
    """n random blocks of `variant`, with eighths forced into the branches
    random bytes rarely reach: colour endpoints c0 <= c1 and c0 == c1
    (BC1's 3-colour mode, the 0x1 flag of BC2/BC3), channel endpoints
    l0 <= l1 (as int8 when signed) and l0 == l1 (BC3 alpha and RGTC's
    5-step palette), and for signed RGTC the invalid (-127, -128) pair and
    -128 endpoints.  tests/test_torch_bc.py:branch_blocks does the same."""
    b = rng.integers(0, 256, (n, _VARIANTS[variant][4]), np.uint8)
    e = [slice(k * n // 8, (k + 1) * n // 8) for k in range(8)]
    color = {"bc1": 0, "bc1a": 0, "bc2": 8, "bc3": 8}.get(variant)
    if color is not None:
        c = b[:, color:color + 4].view(np.uint16)
        c[e[1]] = np.sort(c[e[1]], axis=1)
        c[e[2], 1] = c[e[2], 0]
    signed = variant.startswith("signed")
    for off in {"bc3": [0], "rgtc1": [0], "signed_rgtc1": [0],
                "rgtc2": [0, 8], "signed_rgtc2": [0, 8]}.get(variant, []):
        pair = b[:, off:off + 2].view(np.int8 if signed else np.uint8)
        pair[e[3]] = np.sort(pair[e[3]], axis=1)
        pair[e[4], 1] = pair[e[4], 0]
        if signed:
            b[e[5], off:off + 2] = (0x81, 0x80)       # (-127, -128)
            b[e[6], off] = 0x80
            b[e[7], off + 1] = 0x80
    return b


def _overflow_bytes():
    """(overflowing, other) byte values of an ETC colour channel: the
    differential sum (b & 0xF8) + delta * 8 has bits in 0xFF07 set."""
    b = np.arange(256)
    d = b & 7
    raw = (b & 0xF8) + np.where(d >= 4, d - 8, d) * 8
    ovf = (raw & 0xFF07) != 0
    return b[ovf].astype(np.uint8), b[~ovf].astype(np.uint8)


def etc_branch_blocks(variant: str, n: int, rng) -> np.ndarray:
    """n random blocks of an ETC/EAC variant, with eighths forced into the
    branches random bytes rarely reach (T, H and planar each come up in
    about 3% of random ETC2 blocks, a signed EAC base of -128 in 1/256).
    Colour blocks (ETC variants; ETC2_EAC's at byte 8): eighth 1 individual
    (the differential bit 0; non-opaque differential in punchthrough), 2
    differential without overflow, 3 T (R overflows; ETC1's differential
    overflow), 4 H (G), 5 planar (B), 6 T, H or planar with the
    differential bit 0 (non-opaque ones in punchthrough); half of the H
    blocks have equal base colours (the tie of H's distance bit).  EAC
    channels
    (ETC2_EAC's alpha, R11 and RG11): eighths 1 and 7 multiplier 0, 6 base
    byte 0x80 (-128 when signed) in the first channel, 5 in the last, 4
    base 0x7F.  The flip bit and every other field stay random.
    tests/test_torch_etc.py draws its blocks here too."""
    wide = variant in ("etc2_eac", "eac_rg11", "eac_signed_rg11")
    b = rng.integers(0, 256, (n, 16 if wide else 8), np.uint8)
    e = [np.arange(k * n // 8, (k + 1) * n // 8) for k in range(8)]
    ovf, ok = _overflow_bytes()

    def force_mode(rows, c, mode):
        # The first overflowing channel R, G, B makes mode 2, 3, 4; none, 1.
        for ch in range(3 if mode == 1 else mode - 1):
            vals = ovf if ch == mode - 2 else ok
            b[rows, c + ch] = rng.choice(vals, len(rows))

    if variant.startswith("etc"):
        c = 8 if variant == "etc2_eac" else 0
        b[e[1], c + 3] &= 0xFD
        for k, mode in ((2, 1), (3, 2), (4, 3), (5, 4)):
            b[e[k], c + 3] |= 2
            force_mode(e[k], c, mode)
        b[e[6], c + 3] &= 0xFD
        for rows, mode in zip(np.array_split(e[6], 3), (2, 3, 4)):
            force_mode(rows, c, mode)
        # H with the second base colour equal to the first
        # (decompress-etc.c:253-260): copy its 4-bit R, G, B into the
        # fields of the second.
        tie = e[4][::2]
        b0, b1, b2 = (b[tie, c + k].astype(np.int32) for k in range(3))
        r = (b0 & 0x78) >> 3
        g = ((b0 & 0x07) << 1) | ((b1 & 0x10) >> 4)
        bl = (b1 & 0x08) | ((b1 & 0x03) << 1) | ((b2 & 0x80) >> 7)
        b[tie, c + 2] = (b2 & 0x80) | (r << 3) | (g >> 1)
        b[tie, c + 3] = (b[tie, c + 3] & 0x07) | ((g & 1) << 7) | (bl << 3)
    if "eac" in variant:
        offs = [0, 8] if variant.endswith("rg11") else [0]
        for k in (1, 7):
            b[e[k], 1] &= 0x0F
            b[e[k], offs[-1] + 1] &= 0x0F
        b[e[6], offs[0]] = 0x80
        b[e[5], offs[-1]] = 0x80
        b[e[4], offs[0]] = 0x7F
    return b


# Low bits of byte 0 of each BC6H mode (decompress-bptc-float.c:23-33):
# modes 0 and 1 by their 2-bit code, 2-13 by their 5-bit one, then the 4
# reserved 5-bit codes.
_BC6H_CODES = ((0, 2), (1, 2)) + tuple((c, 5) for c in (
    2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31))


def bc6h_mode_blocks(n: int, rng) -> np.ndarray:
    """n random BC6H blocks whose mode code is drawn uniformly from the 14
    modes and the 4 reserved codes (random bytes put half the blocks in
    modes 0 and 1).  tests/test_torch_bptc_float.py draws its blocks here
    too."""
    b = rng.integers(0, 256, (n, 16), np.uint8)
    pick = rng.integers(0, len(_BC6H_CODES), n)
    code = np.array([c for c, _ in _BC6H_CODES], np.uint8)[pick]
    keep = np.array([0xFF ^ ((1 << w) - 1) for _, w in _BC6H_CODES],
                    np.uint8)[pick]
    b[:, 0] = (b[:, 0] & keep) | code
    return b


def _bc6h_code_key(blocks: np.ndarray) -> np.ndarray:
    """Each BC6H block's mode code: the 2-bit one for modes 0 and 1, else
    the 5-bit one."""
    b0 = blocks[:, 0]
    return np.where((b0 & 2) == 0, b0 & 1, b0 & 0x1F)


def _wrapper(variant: str):
    _, module, name, _, _ = _VARIANTS[variant]
    return getattr(module, name)


def _plain(variant: str):
    _, module, name, _, _ = _VARIANTS[variant]
    return getattr(module, name + "_plain")


@contextlib.contextmanager
def _plain_versions():
    """Swap every texture-path wrapper for its plain version."""
    saved = {v: _wrapper(v) for v in _VARIANTS}
    try:
        for v in _VARIANTS:
            setattr(_VARIANTS[v][1], _VARIANTS[v][2], _plain(v))
        yield
    finally:
        for v, fn in saved.items():
            setattr(_VARIANTS[v][1], _VARIANTS[v][2], fn)


_TEXTURE_MODULES = (bc, rgtc, etc, eac, bptc_float)


def _reset_counts() -> None:
    for module in _TEXTURE_MODULES:
        for k in module.KERNEL_LAUNCHES:
            module.KERNEL_LAUNCHES[k] = 0


def _counts() -> dict:
    return {k: v for m in _TEXTURE_MODULES
            for k, v in m.KERNEL_LAUNCHES.items()}


def _blocks(variant: str, n: int, rng) -> np.ndarray:
    """n blocks of a texture-path variant with forced branches."""
    if _VARIANTS[variant][1] in (etc, eac):
        return etc_branch_blocks(variant, n, rng)
    if _VARIANTS[variant][1] is bptc_float:
        return bc6h_mode_blocks(n, rng)
    return _branch_blocks(variant, n, rng)


def _settings(variant: str):
    """(mode_mask, flags) settings a variant's kernel is checked under."""
    if _VARIANTS[variant][1] in (etc, eac):
        return _ETC_SETTINGS
    if _VARIANTS[variant][1] is bptc_float:
        return _BC6H_SETTINGS
    return tuple((_FULL, fl) for fl in _FLAGS)


def _bc_golden_phase() -> dict:
    """Each variant's kernel vs tests/golden/<FAMILY>.npz: corpus, random
    and every mask/flags variant set."""
    return {v: _check_golden(_GOLDEN_DIR / f"{_VARIANTS[v][3]}.npz",
                             _wrapper(v), _plain(v), v) for v in _VARIANTS}


def _bc_compare_phase(blocks: dict) -> dict:
    errs = {}
    for variant, b in blocks.items():
        words = _words(b)
        errs[variant] = max(_compare(words, mm, fl, _wrapper(variant),
                                     _plain(variant), variant)
                            for mm, fl in _settings(variant))
    print(f"bits: the {len(set(v[0] for v in _VARIANTS.values()))} texture "
          f"kernels bit-exact (tolerance 0) vs their plain versions on the "
          f"card, {_N_BIG} blocks for each of the {len(blocks)} variants, "
          f"forced branches and invalid blocks included, x flags "
          f"{list(_FLAGS)} (BC/RGTC), x (mode_mask, flags) "
          f"{[(hex(m), f) for m, f in _ETC_SETTINGS]} (ETC/EAC), x mode "
          f"masks {[hex(m) for m, _ in _BC6H_SETTINGS]} (BC6H)")
    return errs


def _texture_calls(variant: str, blocks: np.ndarray):
    """(label, texture, pixel format, HDR parameters) of the texture path
    for a variant: the 4096 x 4096 texture in its native format, to BGRA8
    for the RGBA8 and RGBX8 families, RGTC1 to RGBA8, ETC2_EAC to RGB8,
    BPTC_FLOAT to FLOAT_RGB16, RGBX16, RGBA8 and, read as FLOAT_RGBX16_HDR
    at gamma 2.2 and range [0, 4], to RGBX16; and cropped to 4093 x 4090
    for BC1, RGTC2, ETC2_EAC, EAC_R11 and BPTC_FLOAT."""
    fmt = F.BY_NAME[_VARIANTS[variant][3]].fmt
    tex = Texture.new(fmt, blocks, _TEX, _TEX)
    calls = [("native", tex, None, None)]
    if F.texture_pixel_format(fmt) in (F.RGBA8, F.RGBX8):
        calls.append(("BGRA8", tex, F.BGRA8, None))
    if variant == "rgtc1":
        calls.append(("RGBA8", tex, F.RGBA8, None))
    if variant == "etc2_eac":
        calls.append(("RGB8", tex, F.RGB8, None))
    if variant == "bptc_float":
        for pf in (F.FLOAT_RGB16, F.RGBX16, F.RGBA8):
            calls.append((F.format_name(pf), tex, pf, None))
        calls.append(("HDR RGBX16", Texture.new(fmt | F.HDR, blocks, _TEX,
                                                _TEX), F.RGBX16, _HDR))
    if variant in ("bc1", "rgtc2", "etc2_eac", "eac_r11", "bptc_float"):
        # (_TEX - 3) x (_TEX - 6) takes _TEX/4 x (_TEX/4 - 1) blocks.
        crop = Texture.new(fmt, blocks[:_N_BIG - _TEX // 4], _TEX - 3,
                           _TEX - 6)
        calls.append(("cropped", crop, None, None))
    return calls


@contextlib.contextmanager
def _hdr_parameters(params):
    """detex_tpu.hdr's parameters set to `params` (gamma, range min, range
    max) inside the block, and back to the defaults after it."""
    if params is None:
        yield
        return
    hdr.set_hdr_parameters(*params)
    try:
        yield
    finally:
        hdr.set_hdr_parameters(1.0, 0.0, 1.0)


def _host_converted(tex: Texture, pf: int, params) -> np.ndarray:
    """The torch backend's bytes for a texture call: decode on the card,
    convert on the host with detex_tpu.convert.  At gamma != 1 the host
    converter calls glibc powf once per lane (minutes for 67M lanes), so
    there the converter runs once on each of the 65,536 half-float values
    and the texture's lanes are looked up in its result: the same bytes,
    since the conversion maps each 16-bit lane on its own."""
    with _hdr_parameters(params):
        if params is None or params[0] == 1.0:
            return engine.decompress_texture_linear(tex, pf, backend="torch",
                                                    device="cuda")
        halves = np.arange(65536, dtype=np.uint16).view(np.uint8)
        lut = C.convert_pixels(halves, 65536 // 4,
                               F.texture_pixel_format(tex.format), pf) \
            .view(np.uint16)
    native, valid = engine.decode_blocks(
        tex.format, tex.data.reshape(tex.n_blocks, tex.block_size),
        device="cuda")
    px = lut[native.view(np.uint16)].view(np.uint8)
    tiles = np.where(valid[:, None], px, 0).astype(np.uint8)
    return CD.to_bytes(engine._assemble(
        torch.from_numpy(tiles).reshape(tex.n_blocks, 16, -1), tex))


# Labels of the texture calls that convert other than by the identity or
# an R/B swap; they are held to the torch backend too.
_CONVERTING = ("RGBA8", "RGB8", "FLOAT_RGB16", "RGBX16", "HDR RGBX16")


def _texture_path(blocks: dict, smi: str) -> dict:
    """The texture path: every variant's 4096^2 texture calls through
    engine.decompress_texture_linear(backend="device"), each launching its
    variant's kernel once and no other, byte-equal to the same calls with
    the plain versions (which launch nothing); the BC6H calls and the
    converting ones also byte-equal to the torch backend.  Returns the
    launch counts."""
    calls = {v: _texture_calls(v, b) for v, b in blocks.items()}
    _reset_counts()
    outs, wall = {}, {}
    for variant, cs in calls.items():
        for label, tex, pf, params in cs:
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _hdr_parameters(params):
                out = engine.decompress_texture_linear(
                    tex, pf, backend="device", device="cuda")
            wall[(variant, label)] = time.perf_counter() - t0
            outs[(variant, label)] = out
            if engine.LAST_BACKEND != "device":
                raise AssertionError("texture call did not run on device")
            want = tex.width * tex.height * F.pixel_size(
                pf or F.texture_pixel_format(tex.format))
            if out.dtype != np.uint8 or out.shape != (want,):
                raise AssertionError(f"{variant} {label}: bad output "
                                     f"{out.dtype} {out.shape}")
            added = {k: n - before[k] for k, n in _counts().items()}
            if added[variant] != 1 or sum(added.values()) != 1:
                raise AssertionError(f"{variant} {label}: launches {added}")
    launches = _counts()
    with _plain_versions():
        for variant, cs in calls.items():
            for label, tex, pf, params in cs:
                with _hdr_parameters(params):
                    plain = engine.decompress_texture_linear(
                        tex, pf, backend="device", device="cuda")
                if not np.array_equal(plain, outs[(variant, label)]):
                    raise AssertionError(f"{variant} {label}: kernel and "
                                         "plain texture bytes differ")
    if _counts() != launches:
        raise AssertionError("the plain versions launched kernels")
    host_s = {}
    for variant, cs in calls.items():
        for label, tex, pf, params in cs:
            if _VARIANTS[variant][1] is bptc_float or label in _CONVERTING:
                t0 = time.perf_counter()
                host = _host_converted(tex, pf, params)
                host_s[(variant, label)] = time.perf_counter() - t0
                if not np.array_equal(host, outs[(variant, label)]):
                    raise AssertionError(f"{variant} {label}: device and "
                                         "torch backends differ")
    print(f"main path (texture engine): {sum(map(len, calls.values()))} "
          f"decompress_texture_linear(backend='device') calls on "
          f"{_TEX}x{_TEX} textures, one launch of their kernel each, "
          f"byte-equal to the plain versions (no launches); {len(host_s)} "
          f"of them byte-equal to the torch backend "
          f"({', '.join(f'{v} {lb}' for v, lb in host_s)}); launches "
          f"{launches}")
    for (variant, label), sec in wall.items():
        if label == "cropped":
            continue
        host = host_s.get((variant, label))
        print(f"texture wall: {variant} {_TEX}x{_TEX} -> {label}: "
              f"{sec * 1e3:.3f} ms host bytes in to host bytes out, "
              f"{_N_BIG / sec:.4g} blocks/s (first call of its kind "
              f"included)" + ("" if host is None else
                              f"; torch backend {host * 1e3:.1f} ms")
              + f" on {smi}")
    return launches


def _cli_path(blocks: dict) -> None:
    """dtx-convert -d (the device backend) on a 4096^2 BC3, ETC2_EAC,
    EAC_RG11 and BPTC_FLOAT .ktx written with save_ktx, each against the
    same run with the plain versions and with one launch of its kernel and
    no other; BPTC_FLOAT (written as FLOAT_RGB16) also against
    --backend torch."""
    for variant in ("bc3", "etc2_eac", "eac_rg11", "bptc_float"):
        family = _VARIANTS[variant][3]
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "in.ktx"
            tio.save_ktx([Texture.new(F.BY_NAME[family].fmt, blocks[variant],
                                      _TEX, _TEX)], str(src))
            _reset_counts()
            cli_convert.main(["-q", "-d", str(src),
                              str(Path(tmp) / "k.ktx")])
            launches = _counts()
            with _plain_versions():
                cli_convert.main(["-q", "-d", str(src),
                                  str(Path(tmp) / "p.ktx")])
            k = (Path(tmp) / "k.ktx").read_bytes()
            p = (Path(tmp) / "p.ktx").read_bytes()
            host = k
            if variant == "bptc_float":
                cli_convert.main(["-q", "-d", "--backend", "torch", str(src),
                                  str(Path(tmp) / "h.ktx")])
                host = (Path(tmp) / "h.ktx").read_bytes()
        if launches[variant] != 1 or sum(launches.values()) != 1 or k != p \
                or k != host:
            raise AssertionError(f"CLI {family}: launches {launches}, "
                                 f"outputs equal {k == p} {k == host}")
        print(f"cli: dtx-convert -d on a {_TEX}x{_TEX} {family} .ktx "
              f"({len(k)} B out) byte-equal to the plain run"
              + (" and to --backend torch" if variant == "bptc_float"
                 else "") + f"; {variant} kernel launches 1")


def _bc_timing(blocks: dict) -> dict:
    """Kernel vs plain version per variant at N = 4096 and 1,048,576, by
    CUDA events, alternating (kernel, plain, plain, kernel)."""
    times = {}
    for variant, b in blocks.items():
        words = _words(b)
        k_fn, p_fn = _wrapper(variant), _plain(variant)
        for n in (4096, _N_BIG):
            w = words[:n].contiguous()
            reps, inner = (21, 20) if n == 4096 else (7, 3)
            k1 = _time_ms(lambda: k_fn(w))
            p1 = _time_ms(lambda: p_fn(w), reps=reps, inner=inner)
            p2 = _time_ms(lambda: p_fn(w), reps=reps, inner=inner)
            k2 = _time_ms(lambda: k_fn(w))
            times[(variant, n)] = (min(k1, k2), min(p1, p2))
            out_words = k_fn(w[:1])[0].shape[1]
            moved = n * (4 * w.shape[1] + 4 * out_words + 1)
            print(f"time: {variant} N={n}: kernel {k1:.5f} / {k2:.5f} ms, "
                  f"plain {p1:.5f} / {p2:.5f} ms per call; kernel "
                  f"{moved / (min(k1, k2) * 1e6):.4g} GB/s moved")
    return times


def _device_us(blocks: dict) -> dict:
    """Device time per launch of each variant's kernel at N = 1,048,576,
    from torch.profiler's CUDA activity over 10 launches (None where the
    profiler records no kernel)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for variant, b in blocks.items():
        words, fn = _words(b), _wrapper(variant)
        fn(words)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(words)
            torch.cuda.synchronize()
        kernel = _VARIANTS[variant][0].replace("_decode", "_kernel")
        us = [getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0)
              for e in prof.key_averages() if kernel + "<" in e.key
              or kernel + "(" in e.key]
        out[variant] = sum(us) / 10 if us and sum(us) else None
        out_words = fn(words[:1])[0].shape[1]
        moved = _N_BIG * (4 * words.shape[1] + 4 * out_words + 1)
        print(f"device: {variant} N={_N_BIG}: " + (
            "not measured (no kernel in the profile)" if out[variant] is None
            else f"{out[variant]:.2f} us per launch, "
                 f"{moved / out[variant] / 1e6:.3f} TB/s moved"))
    return out


def _texture_breakdown(blocks: dict, smi: str) -> None:
    """Where the time of one warm 4096^2 texture call goes, stage by stage
    (host clock, synchronised after each stage), for a 64 B, a 16 B and a
    128 B output per block in the native format, for BC1 to BGRA8 (an R/B
    swap) and for BPTC_FLOAT to RGBA8 (the viewer's format, three
    conversion steps); then the whole call, median of 5."""
    for variant, pf in (("bc1", None), ("bc1", F.BGRA8), ("rgtc1", None),
                        ("bptc_float", None), ("bptc_float", F.RGBA8)):
        tex = _texture_calls(variant, blocks[variant])[0][1]
        src = F.texture_pixel_format(tex.format)
        dst = pf or src
        stages = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0) * 1e3
            return out

        for _ in range(2):                           # the second is warm
            raw = tex.data.reshape(tex.n_blocks, tex.block_size)
            w = stage("words_from_bytes", lambda: torch.from_numpy(
                words_from_bytes(raw)))
            w = stage("host_to_device", lambda: w.cuda())
            pix, valid = stage("kernel", lambda: _wrapper(variant)(w))
            conv = stage("convert", lambda: CD.convert_pixels_device(
                pix.view(CD.repr_dtype(src)).reshape(
                    _N_BIG * 16, CD.repr_lanes(src)), src, dst)
                .reshape(_N_BIG, 16, -1))
            tiles = stage("zero_invalid", lambda: torch.where(
                valid[:, None, None], conv, 0))
            img = stage("assemble", lambda: engine._assemble(tiles, tex))
            stage("device_to_host", lambda: CD.to_bytes(img))
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.decompress_texture_linear(tex, pf, backend="device",
                                             device="cuda")
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        print(f"texture breakdown: {variant} {_TEX}x{_TEX} -> "
              f"{F.format_name(dst)}, warm, ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; whole call median of 5 {wall:.3f} ms "
              f"({_N_BIG / wall * 1e3:.4g} blocks/s) on {smi}")


def _bc6h_mode_timing(blocks: np.ndarray, smi: str, rounds: int = 7) -> dict:
    """Mode-sorted decode, measured for BC6H: each variant's kernel time
    per call (CUDA events, _time_ms) on the 1,048,576 texture blocks
    (modes mixed), on the same blocks sorted by mode code, and on each of
    14 batches that keep those blocks' bits but force one mode code.  Each
    round times every batch once in a fresh random order, so clock and
    power drift fall on all batches alike; a batch's time is its median
    over the rounds.  Returns {variant: {batch: ms}}."""
    batches = {"mixed": blocks,
               "sorted": blocks[np.argsort(_bc6h_code_key(blocks),
                                           kind="stable")]}
    for m, (code, width) in enumerate(_BC6H_CODES[:14]):
        b = blocks.copy()
        b[:, 0] = (b[:, 0] & (0xFF ^ ((1 << width) - 1))) | code
        batches[f"mode{m}"] = b
    words = {k: _words(b) for k, b in batches.items()}
    order = np.random.default_rng(_SEED)
    out = {}
    for variant in ("bptc_float", "bptc_signed_float"):
        fn = _wrapper(variant)
        ms = {k: [] for k in words}
        for _ in range(rounds):
            for k in order.permutation(list(words)):
                w = words[k]
                ms[k].append(_time_ms(lambda: fn(w), reps=5, inner=10))
        out[variant] = {k: statistics.median(v) for k, v in ms.items()}
        single = [out[variant][f"mode{m}"] for m in range(14)]
        print(f"bc6h modes: {variant} N={_N_BIG}, ms per call, median of "
              f"{rounds} shuffled rounds: mixed {out[variant]['mixed']:.5f} "
              f"(rounds {min(ms['mixed']):.5f}-{max(ms['mixed']):.5f}), "
              f"sorted {out[variant]['sorted']:.5f}, single modes "
              f"{min(single):.5f}-{max(single):.5f} ("
              + ", ".join(f"{m} {t:.5f}" for m, t in enumerate(single))
              + f") on {smi}")
    return out


def _phase(name: str, fn, *args):
    """fn(*args), printing its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return out


def _texture_phase(rng, smi: str):
    """Goldens, kernel vs plain at N = 1,048,576, the texture path, the
    CLI and the timings.  Returns the kernels' JSON entries."""
    errs = _phase("texture goldens", _bc_golden_phase)
    blocks = _phase("texture blocks", lambda: {
        v: _blocks(v, _N_BIG, rng) for v in _VARIANTS})
    for v, e in _phase("texture kernel vs plain", _bc_compare_phase,
                       blocks).items():
        errs[v] = max(errs[v], e)
    launches = _phase("texture path", _texture_path, blocks, smi)
    _phase("cli", _cli_path, blocks)
    _phase("texture breakdown", _texture_breakdown, blocks, smi)
    times = _phase("texture timing", _bc_timing, blocks)
    _phase("bc6h mode batches", _bc6h_mode_timing, blocks["bptc_float"], smi)
    device_us = _phase("texture device time", _device_us, blocks)
    entries = []
    for kernel, (source, replaces) in _REPLACES.items():
        variants = [v for v in _VARIANTS if _VARIANTS[v][0] == kernel]
        first = variants[0]
        entries.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches[v] for v in variants),
            "max_abs_err": max(errs[v] for v in variants),
            "ms": times[(first, _N_BIG)][0],
            "plain_ms": times[(first, _N_BIG)][1],
            "variants": {v: {
                "launches": launches[v], "max_abs_err": errs[v],
                "ms": times[(v, _N_BIG)][0],
                "plain_ms": times[(v, _N_BIG)][1],
                "device_us": device_us[v],
                "ms_n4096": times[(v, 4096)][0],
                "plain_ms_n4096": times[(v, 4096)][1]} for v in variants}})
    return entries


def main() -> None:
    t0 = time.perf_counter()
    smi = _device()
    _phase("build", _build_kernels)
    rng = np.random.default_rng(_SEED)
    timing = _phase("bc7 kernel", _kernel_phase, rng)
    launches = _phase("control step", _main_path, rng, smi)
    texture_kernels = _texture_phase(rng, smi)
    print(f"phase all: {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": [{
        "name": "bc7_decode", "route": "cuda",
        "source": "detex_tpu_torch/csrc/bc7.cu",
        "replaces": "detex_tpu/ops/pallas/bptc_pallas.py:240",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "ms_n65536": timing["ms_65536"],
        "plain_ms_n65536": timing["plain_ms_65536"]}, *texture_kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

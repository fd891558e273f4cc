"""Smoke run of the PyTorch port (detex_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from detex_tpu_torch/csrc (one nvcc per source,
all at once) and drives the port's three paths:

  * the control step: the BC7 kernel held bit-exact against its plain
    PyTorch version and the golden vectors, timed (also at the train
    step's 64 x 256 blocks), then 5 requests served through the
    full-width control step (ControllerConfig(): 64x64 BC7 observation,
    8192 x 32 MPPI rollouts, bf16) by a Controller, whose steps on the
    card are replays of one captured CUDA graph (runtime._StepGraph, the
    counterpart of jax.jit); each phase's BC7 count takes a Controller's
    GRAPH_WARMUP eager steps before its capture and one launch a replay;
  * the rest of the control loop at the same width: 12 steps with 2 iLQR
    iterations (sequential backward) and 5 with the parallel-LQT backward;
    the parallel gains held to the sequential ones on one linearisation
    (float32 on damped dynamics, float64 on the random weights); iLQR on
    the card held to the port's on the CPU, and 3 steps served, on damped
    dynamics toward a random goal; a PipelinedController held to a Controller one step later;
    "graphed control step": 5 steps of graphed Controllers (MPPI, iLQR
    sequential and parallel LQT, 2 iterations; iLQR on damped dynamics)
    against the eager control_step on the same noise (the parallel LQT
    bit-equal: its LU on cuSOLVER/cuBLAS both ways), the generators'
    states, a graphed PipelinedController one step behind, a replay under
    sync debug mode "error", BC7 launches per replay, the capture's wall
    time, the graphed and the eager step's period and host enqueue
    (bench_control_step's rows) and the peak device memory of each;
    20 dynamics training steps on BC7-compressed observations through
    train_loop.train, each step one replay of the captured train graph
    (_TrainGraph; batch 64, two BC7 launches a replay and GRAPH_WARMUP
    eager warm-up steps before the capture; the kernel's decode bit-equal
    to the plain version's and one step's loss within rtol 1e-5), then 3
    iLQR steps served with the trained parameters; "graphed train step":
    5 graphed steps against the eager card step on the same batches (bit-
    equal with deterministic cuDNN; at the defaults the differences
    printed, the losses held at rtol 1e-5), launches a replay, capture s,
    peak memory, a replay under sync debug mode "error", the graphed and
    the eager step's period and host enqueue; and the dtx-train CLI;
  * the multi-device layer ("multi-device" phases): at one rank over NCCL
    in this process, 5 full-width control steps sharded over "dp" held to
    the unsharded Controller (atol 1e-6) and both timed by CUDA events,
    decode_blocks_sharded for all 19 variants at 1,048,576 blocks
    (bit-exact, no collective byte), the horizon-sharded LQT (H = 32, 128
    states) and a (1, 1) train step; "graphed multi-device 1 rank", in a
    fresh NCCL world of one: 5 full-width steps each of graphed sharded
    Controllers (MPPI, iLQR sequential and parallel LQT on damped
    dynamics), each replay holding the step's NCCL collectives, against
    the eager sharded step on the same noise, bit-equal (the LQT's LU on
    cuSOLVER/cuBLAS eager and captured, parallel_lqr._lu_library; torch's
    LU setting read the same before and after), and the unsharded graphed
    Controller (atol 1e-6), BC7
    launches and collective bytes a replay against the eager step's,
    capture s and peak memory, a graphed sharded PipelinedController one
    step behind with a step under sync debug "error", the graphed and
    eager sharded step's period and host enqueue, and train() on the
    (1, 1) mesh through its graph against the eager sharded train step
    (bit-equal, deterministic cuDNN) with both timed; then 2 and 4 ranks
    spawned on the one card over gloo (NCCL takes one rank per card; a
    Controller there stays eager): the sharded control
    step flat over "dp" and over (2, 2) ("dcn", "ici"), the BC7 and BC6H
    sharded decode, the sharded LQT, a (2, 2) dp x tp train step and
    entry.dryrun_multichip, each held to the unsharded result on the card;
  * the texture engine: the BC1/BC1A, BC2/BC3, RGTC1 and RGTC2 (signed
    and unsigned) kernels, the ETC1/ETC2/ETC2 punchthrough, ETC2_EAC,
    EAC R11 and RG11 (signed and unsigned) kernels and the BC6H kernel
    (BPTC_FLOAT, signed and unsigned) held bit-exact against the goldens
    and against their plain versions on 1,048,576 blocks with forced
    branches under 4 flag settings (ETC/EAC also under 6 mode masks, BC6H
    under 5 mode masks), then one 4096x4096 texture per format (a 4K mip,
    1,048,576 blocks) through engine.decompress_texture_linear(
    backend="device"), which decodes, converts the pixels and assembles on
    the card (each call the first of its key, which runs eagerly: a key is
    captured as a CUDA graph at its second call), BPTC (BC7) among them, and a BC3, an ETC2_EAC, an EAC_RG11 and a
    BPTC_FLOAT .ktx through the dtx-convert CLI, each byte-equal to the
    same call with the plain versions swapped in, run eagerly; the calls that
    convert (BC6H to half float, 16-bit, 8-bit and HDR targets, RGTC1 and
    ETC2_EAC to other formats) also byte-equal to the torch backend, which
    converts on the host; every kernel timed against its plain version,
    its device time per launch read by CUDA events (torch.profiler's
    reading beside it), and stage breakdowns of the texture calls;
    "graphed texture pipelines": all 19 variants' 4096^2 textures through
    their pipelines, linear and tiled, eager, captured and replayed,
    against the eager pipeline and the native runtime, one launch a
    replay; a BPTC_FLOAT -> RGBA8 call's one-shot (eager), capturing and
    replayed wall time and peak memory, and the reserve its graph keeps;
    dtx-convert -d on a whole mip chain, which captures nothing; a BC6H
    pipeline and a conversion replayed under sync debug mode "error"; the
    1024^2 ETC2_EAC pipeline's graphed and eager period and host enqueue;
    "conversion sweep": every one of the 449 format pairs with a
    conversion path (tools.convert_sweep: NaN, inf, denormal and signed-
    zero lanes, two HDR settings) on the card, bit-equal to the host
    converter;
  * the tools (detex_tpu_torch/tools/): the BC7 pre-gathered-partition,
    lane-interleave and ALU mix-probe kernels held bit-exact against their
    plain versions at the tools' 65,536 blocks (bc7_pre also against the
    production BC7 kernel), timed beside their plain versions and (for the
    interleave) the PyTorch call that computes the same function, then
    each tool's main() run once;
  * "mode batches", last, so that it cannot move the device times read
    before it: the device time of the tile kernels (BC7, BC6H, the ETC
    colour kernel for ETC1/ETC2/punchthrough, ETC2_EAC, BC2/BC3, BC1/BC1A,
    EAC RG11) on blocks of mixed modes, the same blocks sorted by mode and
    one-mode batches (ETC and ETC2_EAC: the texture path's blocks, their
    row-shuffled copy, sorted, one-mode; BC2/BC3: the texture path's
    blocks; BC1/BC1A and EAC RG11: those and their row-shuffled copy),
    each kernel held to its plain version there and at its tile's edge
    sizes, and the profiler's reading of each kernel before and after
    those rounds;
  * "bench decode", after it, so that its back-to-back launches cannot
    move those device times: tools.bench_decode, the counterpart of the
    root bench.py, as a user runs it: BC7's rate at bench.py's 65,536
    blocks with all 19 families', then BC7's at 1,048,576, each from
    replays of a captured graph of back-to-back launches on copies that
    span twice the L2 cache, beside the device time per launch, and each
    witnessed inside the tool against the native runtime and the plain
    version on the card;
  * then the last modules of the port: dtx-validate on a corpus written
    from the goldens' corpus_blocks (the 17 compressed files, each
    BIT-EXACT) with --fuzz 65,536 (19 families against the native
    oracle, BC6H drawing all 18 mode codes) and dtx-view on the BPTC and
    BPTC_FLOAT files (PNG equal to the CPU's); tools.mass_fuzz at 262,144
    blocks per family; and the three benches at their defaults:
    bench_pipelines (a 1024^2 ETC2_EAC texture to RGBA8 through
    engine._device_pipeline, graphed and eager, byte-equal to the native
    decode; BC6H to the latent encoder, batch 64, graphed and eager, equal
    to the plain BC6H version's and the graph's to the eager step's),
    bench_control_step --ilqr 0 2 --wallclock (each row's first action
    within 1e-6 of a fresh Controller's) and bench_train_step (graph and
    eager rows, each first loss within rtol 1e-5 of dynamics.train_step's);
    each phase requires
    its kernels' launch counts to rise.

Every kernel's time is printed beside its bound: the larger of its bytes
over HBM's rate and, for a kernel without a conditional branch, its
integer instructions in the built library's SASS (cuobjdump -sass) over
the SMs' issue rate.  Each path's
launch counts are set to 0 just before it and read just after.  Every
phase raises on failure, so any failure exits non-zero.
Last lines: the kernels JSON, the card's name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports no JAX.  Needs a CUDA card; without one it exits non-zero before
printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from detex_tpu_torch import _build, engine, entry, graphs, hdr, tools
from detex_tpu_torch import convert as C
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch import formats as F
from detex_tpu_torch import io as tio
from detex_tpu_torch.cli import convert as cli_convert
from detex_tpu_torch.cli import train as cli_train
from detex_tpu_torch.cli import validate as cli_validate
from detex_tpu_torch.cli import view as cli_view
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import ilqr as ILQR
from detex_tpu_torch.mpc import parallel_lqr as PL
from detex_tpu_torch.mpc import runtime as R
from detex_tpu_torch.mpc import train_loop as TL
from detex_tpu_torch.ops import bc, bptc, bptc_float, eac, etc, rgtc
from detex_tpu_torch.ops.bitops import words_from_bytes
from detex_tpu_torch.parallel import launch
from detex_tpu_torch.parallel import mesh as PM
from detex_tpu_torch.texture import Texture
from detex_tpu_torch.tools import bench_control_step as BCS
from detex_tpu_torch.tools import bench_decode as BD
from detex_tpu_torch.tools import bench_pipelines as BPL
from detex_tpu_torch.tools import bench_train_step as BTS
from detex_tpu_torch.tools import convert_sweep as CSW
from detex_tpu_torch.tools import interleave_probe as IP
from detex_tpu_torch.tools import mass_fuzz
from detex_tpu_torch.tools import mxu_probe as MP
from detex_tpu_torch.tools import profile_sections as PS
from detex_tpu_torch.utils.metrics import MetricsLogger

_REPO = Path(__file__).resolve().parent
_GOLDEN_DIR = _REPO / "tests" / "golden"
_GOLDEN = _GOLDEN_DIR / "BPTC.npz"
_FULL = 0xFFFFFFFF
_SEED = 0
_TEX = 4096                 # texture side: a 4K mip
_N_BIG = (_TEX // 4) ** 2   # its blocks, 1,048,576
_FLAGS = (0, 0x1, 0x2, 0x4)
_TRAIN_BATCH = 64
_TRAIN_BLOCKS = _TRAIN_BATCH * 256   # one decode_obs_batch call, 64x64 obs
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
_REPLACES = {
    "bc1_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:228"),
    "bc23_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:247"),
    "rgtc1_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:279"),
    "rgtc2_decode": (_BC_CU, "detex_tpu/ops/pallas/bc_pallas.py:305"),
    "etc_decode": (_ETC_CU, "detex_tpu/ops/pallas/etc_eac_pallas.py:490, "
                   ":509, :518"),
    "etc2_eac_decode": (_ETC_CU, "detex_tpu/ops/pallas/etc_eac_pallas.py:533"),
    "eac_r11_decode": (_ETC_CU, "detex_tpu/ops/pallas/etc_eac_pallas.py:546"),
    "eac_rg11_decode": (_ETC_CU, "detex_tpu/ops/pallas/etc_eac_pallas.py:559"),
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


# Every kernel of libdtx_cuda.so, by name.
_KERNEL_NAMES = ("bc7_kernel", "bc7_pre_kernel", "bc1_kernel", "bc23_kernel",
                 "rgtc1_kernel", "rgtc2_kernel", "etc_kernel",
                 "etc2_eac_kernel", "eac_r11_kernel", "eac_rg11_kernel",
                 "bc6h_kernel", "planar_add1_kernel",
                 "rows_interleave_kernel", "mix_probe_kernel")


def _kernel_id(mangled: str):
    """(kernel name, template argument or None) of a mangled kernel name
    (an int for bool, int and enum arguments, the family for
    mix_probe_kernel), or None for no kernel of ours."""
    for name in _KERNEL_NAMES:
        i = mangled.find(f"{len(name)}{name}")
        if i < 0:
            continue
        rest = mangled[i + len(str(len(name))) + len(name):]
        m = re.match(r"IL(?:b|i|j|N\w*?E)(\d+)E", rest)
        if m:
            return name, int(m.group(1))
        m = re.match(r"IN3dtx\d+MixSched(\w+?)EE", rest)
        return name, (m.group(1) if m else None)
    return None


def _label(kid) -> str:
    return kid[0] + ("" if kid[1] is None else f"<{kid[1]}>")


def _build_kernels() -> float:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    print(f"build: {path.relative_to(_REPO)} in {seconds:.2f} s")
    kernel = "?"
    for line in (path.parent / "nvcc.log").read_text().splitlines():
        m = re.search(r"Function properties for (_Z\w+)", line)
        if line.startswith("nvcc wall"):
            print(f"  {line}")
        elif m:
            kid = _kernel_id(m.group(1))
            kernel = "?" if kid is None else _label(kid)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.strip()}")
    return seconds


# Integer ALU opcodes of sm_90a SASS (moves, memory, control, uniform-path
# and float instructions are not counted).
_INT_OPS = frozenset(
    "IADD3 IADD IADD32I IMAD IMAD32I IMADSP IMUL IMUL32I IMNMX VIMNMX "
    "VIMNMX3 VIADD VIADDMNMX IABS ISETP ICMP ISCADD LEA LOP3 LOP LOP32I SHF "
    "SHL SHR SEL PRMT FLO POPC BREV BMSK SGXT IDP I2I I2IP PLOP3".split())
# The H100 SXM at its 1.98 GHz boost clock: HBM3 at 3.35 TB/s (NVIDIA's
# data sheet); 132 SMs, each issuing at most one warp instruction per clock
# from each of its 4 schedulers: 128 lanes a clock, 33.4 T
# thread-instructions per second.  (Its 64 INT32 lanes, 16.7 Tops/s, are no
# floor: IMAD issues to the FMA pipe, and the BC7 kernel runs faster than
# its integer instructions over 16.7 Tops/s would allow.)
_HBM_BYTES_PER_S = 3.35e12
_ISSUE_PER_S = 132 * 128 * 1.98e9


# Kernels whose static SASS count, over every branch path, is what their
# divergent warps issue on this run's random modes (BC6H blocks draw their
# mode codes at random, so a warp holds many).  That count is what this
# design issues, not what the function needs: a block decodes one mode.
# It is printed as the time this design's instructions take, never used
# as a bound; until an executed per-block count exists these kernels are
# bound by their bytes.  BC7 and bc7_pre are not listed: their tile
# decodes blocks ordered by mode, so a warp issues about one mode's case
# of the 8 the static count covers, and the "mode batches" phase measures
# them instead.
_EVERY_PATH = (("bc6h_kernel", 0), ("bc6h_kernel", 1))


def _sass_census() -> dict:
    """Integer ALU instructions in each kernel's SASS (cuobjdump -sass of
    the built library): {(kernel, template argument): (all, IMAD,
    conditional branches)}.  A thread decodes one block with every loop
    unrolled, so where a warp takes every path the count is the
    instructions a thread issues."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(_build.build())], check=True,
                          capture_output=True, text=True).stdout
    counts, kid = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            kid = _kernel_id(line.split("Function : ")[1].strip())
            if kid is not None:
                counts[kid] = [0, 0, 0]
        elif kid is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9]*)", line)
            if m and m.group(2) in _INT_OPS:
                counts[kid][0] += 1
                counts[kid][1] += m.group(2) == "IMAD"
            elif m and m.group(1) and m.group(2) == "BRA":
                counts[kid][2] += 1
    if {k for k, _ in counts} != set(_KERNEL_NAMES):
        raise AssertionError(f"kernels missing from the SASS: "
                             f"{set(_KERNEL_NAMES) - {k for k, _ in counts}}")
    print("sass: integer instructions per thread (of them IMAD; "
          "conditional branches): " + ", ".join(
              f"{_label(k)} {n} ({m}; {b})"
              for k, (n, m, b) in sorted(counts.items(), key=str)))
    print(f"sass: issued by this design at N={_N_BIG} (static count over "
          f"every branch path / issue rate; not a bound): " + ", ".join(
              f"{_label(k)} {_N_BIG * counts[k][0] / _ISSUE_PER_S * 1e3:.5f}"
              f" ms" for k in _EVERY_PATH))
    return {k: tuple(v) for k, v in counts.items()}


def _bound(nbytes: float, threads: int, kid, sass: dict):
    """(least time in ms, "bytes" or "operations") of a launch of kernel
    `kid` moving `nbytes` with `threads` threads: the larger of the bytes
    over HBM's rate and, for a kernel without a conditional branch (whose
    SASS count is what each thread executes), its integer instructions
    over the issue rate.  A branchy kernel's static count covers paths a
    block does not take, so its bound is its bytes alone."""
    n_int, _, n_branch = sass[kid]
    t_bytes = nbytes / _HBM_BYTES_PER_S
    t_ops = 0.0
    if n_branch == 0:
        t_ops = threads * n_int / _ISSUE_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    for n in (256, _TRAIN_BLOCKS, 65536):
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
            "plain_ms_65536": times[65536][1],
            "ms_train": times[_TRAIN_BLOCKS][0],
            "plain_ms_train": times[_TRAIN_BLOCKS][1]}


def _main_path(rng, smi: str) -> tuple:
    cfg = R.ControllerConfig()
    dcfg, mcfg = cfg.dynamics, cfg.mppi
    gen = torch.Generator(device="cuda")
    gen.manual_seed(_SEED)
    params = D.init_params(dcfg, gen, "cuda")
    goal_z = torch.zeros(dcfg.latent_dim, device="cuda")
    ctl = R.Controller(params, goal_z, cfg, seed=_SEED, device="cuda")
    if not ctl.graphed:
        raise AssertionError("the Controller on the card is not graphed")
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
    if launches != len(requests) + R.GRAPH_WARMUP or \
            ctl._program.launches_per_replay != 1:
        raise AssertionError(f"BC7 kernel launched {launches} times in "
                             f"{len(requests)} graphed control steps and "
                             f"{R.GRAPH_WARMUP} warm-ups")
    print(f"main path: {len(requests)} control steps (64x64 BC7 obs, "
          f"{mcfg.n_rollouts} x {mcfg.horizon} MPPI, {dcfg.compute_dtype}), "
          f"each a replay of the graph captured at the first in "
          f"{ctl._program.capture_s:.3f} s after {R.GRAPH_WARMUP} eager "
          f"warm-up steps; BC7 kernel launches {launches} (1 a replay); "
          f"last action "
          f"{np.array2string(action, precision=4)}; min_cost "
          f"{float(ctl.diag['min_cost']):.6g}, ess "
          f"{float(ctl.diag['ess']):.6g}")
    print(f"step ms: median {statistics.median(step_ms):.3f} "
          f"(each: {', '.join(f'{t:.3f}' for t in step_ms)}; the first "
          f"includes the capture) on {smi}")

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
    return launches, statistics.median(step_ms)


# --- the rest of the control loop: iLQR, pipelining, training ---------------


def _requests(rng, n: int, dcfg) -> list:
    """n observations of random BC7 words (invalid blocks among them)."""
    n_blocks = (dcfg.image_size // 4) ** 2
    return [rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64)
            .astype(np.int32) for _ in range(n)]


def _check_action(action, mcfg, diag, bounds: bool = True) -> None:
    if action.shape != (mcfg.action_dim,) or not np.isfinite(action).all():
        raise AssertionError(f"bad action {action!r}")
    if bounds and ((action < mcfg.action_low).any()
                   or (action > mcfg.action_high).any()):
        raise AssertionError(f"action out of bounds {action!r}")
    for k, v in diag.items():
        if not np.isfinite(float(v)):
            raise AssertionError(f"{k} is not finite: {float(v)}")


def _serve(ctl, requests, mcfg, bounds: bool = True) -> tuple:
    """Serve `requests` through ctl, checking each action: (host ms per
    step, the action ending on the host; the actions)."""
    step_ms, actions = [], []
    for words in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actions.append(ctl.step(words))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _check_action(actions[-1], mcfg, ctl.diag, bounds)
    return step_ms, actions


def _damped(params, damp: float = 0.05):
    """params with the dynamics' output layer scaled by `damp`.  Random
    weights make the latent dynamics expand about 2.4x a step, so a plan's
    cost grows without bound over the horizon; damped by 0.05 (as the CPU
    tests damp theirs) a trajectory stays bounded and iLQR's refined cost
    means something."""
    p = {part: {name: dict(layer) for name, layer in layers.items()}
         for part, layers in params.items()}
    p["dyn"]["out"]["w"] = params["dyn"]["out"]["w"] * damp
    return p


def _ilqr_problem(params, dcfg, cfg, words, goal):
    """(dyn1, cost1, terminal, z0) of the control step's iLQR on one
    observation, with `params` on their own device."""
    img = R.decode_obs(words, dcfg.image_size, dcfg.image_size)
    cost = R.latent_cost_fn(goal, cfg)

    def dyn1(x, u):
        return D.dynamics_apply(params, x[None], u[None], dcfg)[0]

    def cost1(x, u, t):
        return cost(x[None], u[None], t)[0]

    def terminal(x):
        return x.new_zeros(())

    z0 = D.encode(params, img[None].to(torch.uint8), dcfg)[0]
    return dyn1, cost1, terminal, z0


def _rel_err(a, b) -> tuple:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale, scale


def _gains_check(params, cfg, words, us) -> None:
    """The parallel-LQT backward's gains against the sequential
    backward's on one float32 linearisation at the full width, along the
    plan `us`.  On the damped dynamics (_damped) the float32 gains are held
    within rtol 1e-4.  On the random weights themselves the value
    matrices grow without bound and the two float32 recursions part; the
    same linearisation, cast to float64, is the witness that the scan is
    right there: at reg 0 both solve the same Riccati recursion and are
    held within 1e-6 of the largest gain.  At reg_init they differ by
    construction, as in the JAX package (the sequential pass propagates
    the value with the unregularised quu, the LQT with R + reg I): that
    reading is printed."""
    dcfg = dataclasses.replace(cfg.dynamics, compute_dtype=torch.float32)
    goal = torch.zeros(dcfg.latent_dim, device="cuda")
    reg_init = ILQR.ILQRConfig().reg_init
    for damp in (0.05, 1.0):
        dyn1, cost1, terminal, z0 = _ilqr_problem(
            _damped(params, damp), dcfg, cfg, words, goal)
        xs = ILQR._rollout(dyn1, z0, us)
        lin = ILQR.linearize(dyn1, cost1, terminal, xs, us)
        runs = [(torch.float32, reg_init)]
        if damp == 1.0:
            runs += [(torch.float64, 0.0), (torch.float64, reg_init)]
        for dtype, reg_v in runs:
            lin_d = [d.to(dtype) for d in lin]
            reg = torch.tensor(reg_v, dtype=dtype, device="cuda")
            seq = ILQR.backward(*lin_d, reg)
            par = ILQR.backward_parallel(*lin_d, reg)
            errs, worst = [], 0.0
            for name, a, b in zip(("k", "K"), par, seq):
                err, scale = _rel_err(a, b)
                worst = max(worst, err)
                errs.append(f"{name}: max |par - seq| / max |seq| {err:.3g} "
                            f"(max |seq| {scale:.3g})")
                if damp != 1.0:
                    torch.testing.assert_close(a, b, rtol=1e-4,
                                               atol=1e-4 * scale)
            checked = " (not checked)"
            if damp != 1.0:
                checked = " (rtol 1e-4, atol 1e-4 max |seq|: ok)"
            elif dtype == torch.float64 and reg_v == 0.0:
                if not worst <= 1e-6:
                    raise AssertionError(
                        f"float64 gains at reg 0 part by {worst:.3g} of the "
                        "largest gain (limit 1e-6)")
                checked = " (within 1e-6 of max |seq|: ok)"
            print(f"ilqr gains, {str(dtype)[6:]}, reg {reg_v:g}, output "
                  f"layer x {damp}, |x_H| {float(xs[-1].norm()):.4g}: "
                  f"{'; '.join(errs)}{checked}")


def _ilqr_reference_check(params, cfg, words, rng) -> None:
    """iLQR refinement on the card against the port's own on the CPU
    (which the CPU tests hold to the JAX package's), at the full width in
    float32, on the damped dynamics with a random latent goal and plan,
    both backwards; held at the CPU tests' ilqr_solve tolerances (xs, us,
    total cost rtol 1e-4, atol 1e-5), and the refinement must lower the
    plan's cost."""
    dcfg = dataclasses.replace(cfg.dynamics, compute_dtype=torch.float32)
    mcfg = cfg.mppi
    p = _damped(params)
    goal = torch.from_numpy((0.5 * rng.standard_normal(dcfg.latent_dim))
                            .astype(np.float32))
    us0 = torch.from_numpy(rng.uniform(
        -0.5, 0.5, (mcfg.horizon, mcfg.action_dim)).astype(np.float32))
    p_cpu = {part: {name: {k: v.cpu() for k, v in layer.items()}
                    for name, layer in layers.items()}
             for part, layers in p.items()}
    for parallel in (False, True):
        icfg = ILQR.ILQRConfig(n_iterations=cfg.n_ilqr_iterations,
                               parallel=parallel)
        out = []
        for dev, prm in (("cuda", p), ("cpu", p_cpu)):
            dyn1, cost1, terminal, z0 = _ilqr_problem(
                prm, dcfg, cfg, words.to(dev), goal.to(dev))
            if out:
                z0 = out[0][3].cpu()    # the card's start on both sides
            start = ILQR.trajectory_cost(
                cost1, terminal, ILQR._rollout(dyn1, z0, us0.to(dev)),
                us0.to(dev))
            xs, us, total = ILQR.ilqr_solve(dyn1, cost1, terminal, z0,
                                            us0.to(dev), icfg)
            out.append((xs, us, total, z0, start))
        (xs_c, us_c, tot_c, _, start_c), (xs_h, us_h, tot_h, _, _) = out
        for name, a, b in (("xs", xs_c, xs_h), ("us", us_c, us_h),
                           ("total", tot_c, tot_h)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, n=name: f"{n}: {m}")
        if not float(tot_c) < float(start_c):
            raise AssertionError(f"iLQR did not lower the cost: "
                                 f"{float(start_c)} -> {float(tot_c)}")
        print(f"ilqr {'parallel LQT' if parallel else 'sequential'}, "
              f"float32, output layer x 0.05, random goal: cost "
              f"{float(start_c):.6g} -> {float(tot_c):.6g} on the card, "
              f"{float(tot_h):.6g} on the CPU; max |us card - CPU| "
              f"{float((us_c.cpu() - us_h).abs().max()):.3g}, max |xs| "
              f"diff {float((xs_c.cpu() - xs_h).abs().max()):.3g} "
              f"(rtol 1e-4, atol 1e-5: ok)")


def _ilqr_stages(params, cfg, words, goal) -> str:
    """One eager control_step on `words` (a graphed Controller's replay
    runs no Python, so it cannot be timed by stage) with the card
    synchronised around each iLQR stage: host ms per stage over the
    step's iterations (the line search's rollouts in `_forward`; its costs
    and the selects in the rest)."""
    names = ("linearize", "backward", "backward_parallel", "_forward")
    spent = dict.fromkeys(names, 0.0)
    saved = {n: getattr(ILQR, n) for n in names}

    def timed(name):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*args)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(_SEED)
    words = torch.from_numpy(words).cuda()
    for n in names:
        setattr(ILQR, n, timed(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            action = R.control_step(params, nominal, gen, words, goal,
                                    cfg)[0]
        action.cpu()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for n in names:
            setattr(ILQR, n, saved[n])
    parts = ", ".join(f"{n} {t:.3f}" for n, t in spent.items() if t)
    return f"{parts}, rest {total - sum(spent.values()):.3f} of {total:.3f}"


def _ilqr_path(rng, smi: str, mppi_median: float) -> int:
    """12 full-width control steps with 2 iLQR iterations (sequential
    backward; 2 warm-ups, 10 timed), the gains check, then 5 steps with
    the parallel-LQT backward.  Returns the BC7 launches."""
    cfg = R.ControllerConfig(n_ilqr_iterations=2)
    dcfg, mcfg = cfg.dynamics, cfg.mppi
    gen = torch.Generator(device="cuda")
    gen.manual_seed(_SEED)
    params = D.init_params(dcfg, gen, "cuda")
    goal_z = torch.zeros(dcfg.latent_dim, device="cuda")
    requests = _requests(rng, 17, dcfg)
    # iLQR refines the MPPI plan without the action bounds, as the JAX
    # package does (a refined action may leave them): finiteness is held,
    # and how far the actions went is printed.
    bptc.KERNEL_LAUNCHES = 0
    ctl = R.Controller(params, goal_z, cfg, seed=_SEED, device="cuda")
    seq_ms, seq_actions = _serve(ctl, requests[:12], mcfg, bounds=False)
    seq_ms = seq_ms[2:]
    seq_launches = bptc.KERNEL_LAUNCHES
    print(f"ilqr: {len(requests[:12])} steps, sequential backward; last "
          f"ilqr_cost {float(ctl.diag['ilqr_cost']):.6g}, MPPI min_cost "
          f"{float(ctl.diag['min_cost']):.6g}")
    pcfg = dataclasses.replace(cfg, ilqr_parallel=True)
    pctl = R.Controller(params, goal_z, pcfg, seed=_SEED, device="cuda")
    par_ms, par_actions = _serve(pctl, requests[12:], mcfg, bounds=False)
    launches = bptc.KERNEL_LAUNCHES
    for name, actions in (("sequential", seq_actions),
                          ("parallel", par_actions)):
        outside = sum(bool((a < mcfg.action_low).any()
                           or (a > mcfg.action_high).any()) for a in actions)
        print(f"ilqr {name}: max |action| "
              f"{max(float(np.abs(a).max()) for a in actions):.4g}; "
              f"{outside} of {len(actions)} actions outside "
              f"[{mcfg.action_low}, {mcfg.action_high}]")
    if seq_launches != 12 + R.GRAPH_WARMUP or \
            launches != len(requests) + 2 * R.GRAPH_WARMUP:
        raise AssertionError(f"BC7 kernel launched {seq_launches} / "
                             f"{launches} times in 12 / {len(requests)} "
                             "graphed iLQR control steps and their warm-ups")
    with torch.no_grad():
        _gains_check(params, cfg, torch.from_numpy(requests[0]).cuda(),
                     ctl.nominal)
        _ilqr_reference_check(params, cfg,
                              torch.from_numpy(requests[1]).cuda(), rng)
    # Served on the damped dynamics toward a random goal, where the
    # refined cost is well conditioned: each step's ilqr_cost must lie
    # below MPPI's best sampled cost.
    goal = torch.from_numpy((0.5 * rng.standard_normal(dcfg.latent_dim))
                            .astype(np.float32)).cuda()
    dctl = R.Controller(_damped(params), goal, cfg, seed=_SEED,
                        device="cuda")
    costs = []
    for words in requests[:3]:
        dctl.step(words)
        costs.append((float(dctl.diag["ilqr_cost"]),
                      float(dctl.diag["min_cost"])))
    if not all(np.isfinite(c).all() and c[0] < c[1] for c in costs):
        raise AssertionError(f"damped iLQR steps: (ilqr_cost, min_cost) "
                             f"{costs}")
    print(f"ilqr, output layer x 0.05, random goal, 3 steps "
          f"({dcfg.compute_dtype}): (ilqr_cost, MPPI min_cost) "
          f"{', '.join(f'({a:.6g}, {b:.6g})' for a, b in costs)}")
    print(f"ilqr stages, host ms with the card synchronised around each "
          f"(one eager control_step, 2 iterations): sequential: "
          f"{_ilqr_stages(params, cfg, requests[0], goal_z)}; parallel LQT: "
          f"{_ilqr_stages(params, pcfg, requests[0], goal_z)}")
    print(f"ilqr step ms: median {statistics.median(seq_ms):.3f} sequential "
          f"(10 after 2 warm-ups: {', '.join(f'{t:.3f}' for t in seq_ms)}), "
          f"{statistics.median(par_ms):.3f} parallel LQT (5: "
          f"{', '.join(f'{t:.3f}' for t in par_ms)}; the first includes "
          f"the capture), MPPI only {mppi_median:.3f} (control step phase); "
          f"graphed steps, host clock to the action on the host, on {smi}")
    return launches


def _pipelined_path(rng, smi: str) -> int:
    """A Controller and a PipelinedController, same seed, 6 requests each:
    the pipelined actions equal the synchronous ones one step later.
    Returns the BC7 launches."""
    cfg = R.ControllerConfig()
    dcfg, mcfg = cfg.dynamics, cfg.mppi
    gen = torch.Generator(device="cuda")
    gen.manual_seed(_SEED)
    params = D.init_params(dcfg, gen, "cuda")
    goal_z = torch.zeros(dcfg.latent_dim, device="cuda")
    requests = _requests(rng, 6, dcfg)
    bptc.KERNEL_LAUNCHES = 0
    sync = R.Controller(params, goal_z, cfg, seed=_SEED, device="cuda")
    pipe = R.PipelinedController(params, goal_z, cfg, seed=_SEED,
                                 device="cuda")
    sync_ms, sync_actions = _serve(sync, requests, mcfg)
    pipe_actions, pipe_ms = [], []
    torch.cuda.synchronize()
    for words in requests:
        t0 = time.perf_counter()
        pipe_actions.append(pipe.step(words))
        pipe_ms.append((time.perf_counter() - t0) * 1e3)
    pipe_actions.append(pipe.flush())
    launches = bptc.KERNEL_LAUNCHES
    if not (sync.graphed and pipe.graphed) or \
            launches != 2 * (len(requests) + R.GRAPH_WARMUP):
        raise AssertionError(f"BC7 kernel launched {launches} times in "
                             f"{2 * len(requests)} graphed control steps "
                             "and their warm-ups")
    if pipe_actions[0] is not None:
        raise AssertionError("the first pipelined step returned an action")
    for t, action in enumerate(pipe_actions[1:]):
        _check_action(action, mcfg, pipe.diag)
        np.testing.assert_allclose(action, sync_actions[t], rtol=0,
                                   atol=1e-6)
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(pipe_actions[1:], sync_actions))
    print(f"pipelined: {len(requests)} requests, actions equal the "
          f"synchronous controller's one step later (atol 1e-6; max diff "
          f"{diff:.3g})")
    print(f"pipelined host ms per step call: median "
          f"{statistics.median(pipe_ms[1:]):.3f} (each: "
          f"{', '.join(f'{t:.3f}' for t in pipe_ms)}); synchronous "
          f"{statistics.median(sync_ms):.3f} (each: "
          f"{', '.join(f'{t:.3f}' for t in sync_ms)}) on {smi}")
    return launches


# --- the control step as one captured CUDA graph ------------------------------

_GRAPH_STEPS = 5
# (label, iLQR iterations, parallel LQT, action atol): MPPI replays the
# eager step's own kernels; sequential iLQR is held at
# test_cuda_ilqr_step_matches_cpu's atol 1e-5; the parallel LQT bit-equal,
# its LU on cuSOLVER/cuBLAS eager and captured (parallel_lqr._lu_library).
_GRAPH_CASES = (("MPPI", 0, False, 1e-6), ("iLQR sequential", 2, False, 1e-5),
                ("iLQR parallel LQT", 2, True, 0.0))


def _eager_serve(params, goal, cfg, requests, mesh=None) -> tuple:
    """control_step (on `mesh`) served eagerly over `requests`, the nominal
    carried and the noise drawn from a generator seeded as a Controller
    seeds its own: ([action], [diagnostics as floats], the generator)."""
    gen = torch.Generator(device="cuda").manual_seed(_SEED)
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          device="cuda")
    actions, diags = [], []
    with torch.no_grad():
        for words in requests:
            action, nominal, diag = R.control_step(
                params, nominal, gen, torch.from_numpy(words).cuda(), goal,
                cfg, mesh=mesh)
            actions.append(action.cpu().numpy())
            diags.append({k: float(v) for k, v in diag.items()})
    return actions, diags, gen


def _peak_mib(fn) -> tuple:
    """(fn(), peak device MiB allocated while it ran above what was
    allocated before it)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 2**20


def _graphed_path(smi: str) -> int:
    """Graphed Controllers at ControllerConfig()'s full width held to the
    eager control_step on the same noise (MPPI on the random weights; iLQR,
    2 iterations, on the damped dynamics toward a random goal, where the
    refinement is accepted: on the random weights every refined step is
    rejected and the plan stays MPPI's), with the generators' states, BC7
    launches per replay, the capture's wall time and peak memory; a
    graphed PipelinedController one step behind the graphed Controller
    and a replay under sync debug mode "error"; then the graphed and the
    eager step's period and host enqueue from bench_control_step.bench.
    Returns the BC7 launches."""
    base = R.ControllerConfig()
    dcfg, mcfg = base.dynamics, base.mppi
    rng = np.random.default_rng([_SEED, 13])
    params = D.init_params(dcfg, torch.Generator(device="cuda").manual_seed(
        _SEED), "cuda")
    zero = torch.zeros(dcfg.latent_dim, device="cuda")
    goal = torch.from_numpy((0.5 * rng.standard_normal(dcfg.latent_dim))
                            .astype(np.float32)).cuda()
    requests = _requests(rng, _GRAPH_STEPS, dcfg)
    bptc.KERNEL_LAUNCHES = 0
    mppi_actions = None
    library = torch.backends.cuda.preferred_linalg_library()
    for label, n_ilqr, parallel, atol in _GRAPH_CASES:
        cfg = dataclasses.replace(base, n_ilqr_iterations=n_ilqr,
                                  ilqr_parallel=parallel)
        prm, g = (_damped(params), goal) if n_ilqr else (params, zero)
        launches = bptc.KERNEL_LAUNCHES
        ctl = R.Controller(prm, g, cfg, seed=_SEED, device="cuda")

        def serve():
            return [(ctl.step(w), {k: float(v) for k, v in ctl.diag.items()})
                    for w in requests]
        got, graph_mib = _peak_mib(serve)
        launches = bptc.KERNEL_LAUNCHES - launches
        (want, want_d, gen), eager_mib = _peak_mib(
            lambda: _eager_serve(prm, g, cfg, requests))
        prog = ctl._program
        if not ctl.graphed or prog.launches_per_replay != 1 or \
                launches != len(requests) + R.GRAPH_WARMUP:
            raise AssertionError(f"graphed {label}: BC7 launched {launches} "
                                 f"times in {len(requests)} steps")
        diffs = [float(np.abs(a - w).max()) for (a, _), w in zip(got, want)]
        bit = all(np.array_equal(a, w) for (a, _), w in zip(got, want))
        if not max(diffs) <= atol:
            raise AssertionError(f"graphed {label}: actions differ from the "
                                 f"eager step's by {diffs} (atol {atol})")
        rel = max(abs(d[k] - w[k]) / abs(w[k]) if w[k] else abs(d[k])
                  for (_, d), w in zip(got, want_d) for k in w)
        if not rel <= 1e-5 or any(set(d) != set(w)
                                  for (_, d), w in zip(got, want_d)):
            raise AssertionError(f"graphed {label}: diagnostics differ by "
                                 f"{rel:.3g} (rtol 1e-5)")
        if not torch.equal(ctl.generator.get_state(), gen.get_state()):
            raise AssertionError(f"graphed {label}: generator state differs")
        left = torch.backends.cuda.preferred_linalg_library()
        if left != library:
            raise AssertionError(f"graphed {label}: torch's LU setting left "
                                 f"as {left}, not {library}")
        refined = sum(d.get("ilqr_cost", np.inf) < d["min_cost"]
                      for _, d in got)
        if n_ilqr and not refined:
            raise AssertionError(f"graphed {label}: every refinement was "
                                 f"rejected: {[d for _, d in got]}")
        if not n_ilqr:
            mppi_actions = [a for a, _ in got]
        print(f"graphed control step, {label}: {len(requests)} full-width "
              f"steps against the eager control_step on the same noise: max "
              f"|action diff| per step {diffs} (atol {atol}), bit-equal "
              f"{bit}; diagnostics within rtol 1e-5 (max {rel:.3g}); "
              + (f"{refined} steps refined below MPPI's best cost; "
                 if n_ilqr else "") +
              f"generator state equal to the eager one's; torch's LU "
              f"setting {library} before and after; BC7 launches "
              f"{launches} ({R.GRAPH_WARMUP} warm-ups, "
              f"{prog.launches_per_replay} a replay); capture "
              f"{prog.capture_s:.3f} s (warm-ups included); peak device "
              f"memory above what was allocated before: graphed "
              f"{graph_mib:.1f} MiB (capture included), eager "
              f"{eager_mib:.1f} MiB, on {smi}")
        del ctl, prog

    launches = bptc.KERNEL_LAUNCHES
    pipe = R.PipelinedController(params, zero, base, seed=_SEED,
                                 device="cuda")
    piped = [pipe.step(w) for w in requests] + [pipe.flush()]
    if piped[0] is not None:
        raise AssertionError("the first pipelined step returned an action")
    pdiff = max(float(np.abs(a - b).max())
                for a, b in zip(piped[1:], mppi_actions))
    if not pipe.graphed or not pdiff <= 1e-6:
        raise AssertionError(f"graphed pipelined actions differ from the "
                             f"graphed Controller's by {pdiff}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = pipe.step(requests[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    last = pipe.flush()
    if first is not None or last is None:
        raise AssertionError("the sync-debug pipelined step")
    _check_action(last, mcfg, pipe.diag)
    if bptc.KERNEL_LAUNCHES - launches != len(requests) + 1 + R.GRAPH_WARMUP:
        raise AssertionError("graphed pipelined: BC7 launch count")
    print(f"graphed control step, pipelined: {len(requests)} requests, "
          f"actions equal to the graphed Controller's one step later (max "
          f"diff {pdiff:.3g}, atol 1e-6); one replay enqueued under "
          f"torch.cuda.set_sync_debug_mode('error') without a "
          f"synchronising call, on {smi}")

    rows = []
    for label, n_ilqr, parallel, _ in _GRAPH_CASES:
        cfg = dataclasses.replace(base, n_ilqr_iterations=n_ilqr,
                                  ilqr_parallel=parallel)
        for program in ("graph", "eager"):
            out = BCS.bench(cfg, torch.device("cuda"), 5, 20, program)
            rows.append((label, program, statistics.median(out["card_ms"]),
                         statistics.median(out["host_ms"])))
    print("graphed control step, period by CUDA events between "
          "back-to-back steps and the host's enqueue (bench_control_step."
          "bench, median of 20 after 5; random weights): " + "; ".join(
              f"{label} {program} {card:.3f} ms (host {host:.3f} ms)"
              for label, program, card, host in rows) + f", on {smi}")
    return bptc.KERNEL_LAUNCHES


def _clone(params):
    return {part: {name: {k: v.detach().clone() for k, v in layer.items()}
                   for name, layer in layers.items()}
            for part, layers in params.items()}


def _train_compare(params, optimizer, cfg) -> None:
    """One batch decoded by the kernel and by the plain version: equal
    images, and one train step's loss from the same params and optimizer
    state within rtol 1e-5 (cuDNN's weight-gradient convs may reduce in
    another order, so not bit-equal)."""
    dcfg = cfg.dynamics
    env = TL.SyntheticVisualEnv(dcfg, cfg.seed, compressed=True)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0]))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in env.sample_batch(rng, cfg.batch_size).items()}
    out = []
    kernel_decode = bptc.decode_bptc
    for decode in (kernel_decode, bptc.decode_bptc_plain):
        bptc.decode_bptc = decode
        try:
            images = TL.decode_batch(batch, dcfg.image_size)
        finally:
            bptc.decode_bptc = kernel_decode
        p = _clone(params)
        opt = D.make_optimizer(p, cfg.lr)
        opt.load_state_dict(optimizer.state_dict())
        _, loss = D.train_step(p, opt, images, dcfg)
        out.append((images, float(loss)))
    (img_k, loss_k), (img_p, loss_p) = out
    for k in ("obs", "next_obs"):
        if not torch.equal(img_k[k], img_p[k]):
            raise AssertionError(f"train batch {k}: kernel and plain "
                                 "decode differ")
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-5)
    print(f"train: kernel and plain decode give equal images "
          f"({cfg.batch_size} x 2 observations) and losses {loss_k:.9g} / "
          f"{loss_p:.9g}")


def _train_path(rng, smi: str) -> tuple:
    """20 full-width training steps on BC7-compressed observations through
    train_loop.train, each step one replay of the captured train graph
    (_TrainGraph) after GRAPH_WARMUP eager warm-ups, then 3 iLQR control
    steps with the trained params.  Returns the BC7 launches of the two."""
    cfg = TL.TrainConfig(dynamics=D.DynamicsConfig(), batch_size=_TRAIN_BATCH,
                         n_steps=20, compressed_obs=True)
    env = TL.SyntheticVisualEnv(cfg.dynamics, cfg.seed, compressed=True)
    stream = io.StringIO()
    timings = []
    call = TL._TrainGraph.__call__

    def timed(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = call(self)
        end.record()
        timings.append((start, end, time.perf_counter() - t0))
        return out

    bptc.KERNEL_LAUNCHES = 0
    TL._TrainGraph.__call__ = timed
    try:
        params, optimizer, last = TL.train(cfg, MetricsLogger(stream), env,
                                           device="cuda")
    finally:
        TL._TrainGraph.__call__ = call
    launches = bptc.KERNEL_LAUNCHES
    torch.cuda.synchronize()
    losses = [json.loads(x)["loss"] for x in stream.getvalue().splitlines()]
    if launches != 2 * (cfg.n_steps + R.GRAPH_WARMUP) or \
            len(timings) != cfg.n_steps:
        raise AssertionError(f"BC7 kernel launched {launches} times in "
                             f"{len(timings)} graphed train steps and "
                             f"{R.GRAPH_WARMUP} warm-ups")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}")
    step_ms = [s.elapsed_time(e) for s, e, _ in timings][-10:]
    host_ms = [h * 1e3 for _, _, h in timings][-10:]
    t0 = time.perf_counter()
    env.sample_batch(np.random.default_rng(1), cfg.batch_size)
    data_ms = (time.perf_counter() - t0) * 1e3
    side = cfg.dynamics.image_size
    print(f"train: {cfg.n_steps} steps, batch {cfg.batch_size} of "
          f"{side}x{side} BC7 observations (DynamicsConfig(), "
          f"{cfg.dynamics.compute_dtype}), each a replay of the train "
          f"graph; BC7 kernel launches {launches} (2 a step, "
          f"{R.GRAPH_WARMUP} warm-up steps); logged losses {losses}")
    print(f"graphed train step ms (CUDA events, last 10): median "
          f"{statistics.median(step_ms):.3f} (each: "
          f"{', '.join(f'{t:.3f}' for t in step_ms)}); host enqueue median "
          f"{statistics.median(host_ms):.3f} ms, "
          f"{statistics.median(host_ms) / statistics.median(step_ms):.1%} of "
          f"the step; the env's host batch (BC7 encode of "
          f"{2 * cfg.batch_size} images) {data_ms:.1f} ms, outside the "
          f"step; on {smi}")
    _train_compare(params, optimizer, cfg)

    ccfg = R.ControllerConfig(n_ilqr_iterations=2)
    bptc.KERNEL_LAUNCHES = 0
    ctl = R.Controller(params, torch.zeros(ccfg.dynamics.latent_dim,
                                           device="cuda"), ccfg,
                       seed=_SEED, device="cuda")
    served_ms = _serve(ctl, _requests(rng, 3, ccfg.dynamics), ccfg.mppi,
                       bounds=False)[0]
    served = bptc.KERNEL_LAUNCHES
    if served != 3 + R.GRAPH_WARMUP:
        raise AssertionError(f"BC7 kernel launched {served} times in 3 "
                             "graphed control steps and their warm-ups")
    print(f"trained params: 3 iLQR control steps, ms "
          f"{', '.join(f'{t:.3f}' for t in served_ms)}; last ilqr_cost "
          f"{float(ctl.diag['ilqr_cost']):.6g}")
    return launches, served


# --- the train step as one captured CUDA graph -------------------------------

_GRAPH_TRAIN_STEPS = 5


class _Batches:
    """An env that serves the given batches in turn (train's per-step rng
    is not used): the graphed and the eager runs see the same bytes."""

    def __init__(self, batches):
        self.batches = iter(batches)

    def sample_batch(self, rng, batch_size):
        return next(self.batches)


def _eager_train(cfg, batches, mesh=None) -> tuple:
    """train()'s loop run eagerly on the card (make_train_step) over
    `batches`, on `mesh` (the parameters its tp shards, each batch its dp
    rows): (losses, params, optimizer)."""
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    params = D.init_params(cfg.dynamics, gen, "cuda")
    if mesh is not None:
        params = D.shard_params(params, mesh)
    opt = D.make_optimizer(params, cfg.lr)
    step = TL.make_train_step(cfg.dynamics, opt, cfg.compressed_obs, mesh)
    losses = []
    for b in batches:
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        if mesh is not None:
            b = {k: PM.shard_batch(v, mesh, "dp") for k, v in b.items()}
        params, loss = step(params, {k: v.cuda() for k, v in b.items()})
        losses.append(float(loss))
    return losses, params, opt


def _graphed_train(cfg, batches) -> tuple:
    """train() on the card (one graph replay a step) over `batches`:
    (losses, params, optimizer, the _TrainGraph)."""
    call, seen = TL._TrainGraph.__call__, []

    def recorded(self):
        loss = call(self)
        seen.append((self, float(loss)))
        return loss
    TL._TrainGraph.__call__ = recorded
    try:
        params, opt, _ = TL.train(cfg, MetricsLogger(io.StringIO()),
                                  _Batches(batches), device="cuda")
    finally:
        TL._TrainGraph.__call__ = call
    return [x for _, x in seen], params, opt, seen[0][0]


def _state_diff(a, b) -> tuple:
    """(bit-equal, max |difference|) of two trainings' parameters, moments
    and step counts."""
    pairs = list(zip(TL._step_state(*a), TL._step_state(*b), strict=True))
    return (all(torch.equal(x, y) for x, y in pairs),
            max(float((x.float() - y.float()).abs().max()) for x, y in pairs))


def _graphed_train_path(smi: str) -> int:
    """train() on the card, each step one replay of the captured train
    graph, against the eager card step (make_train_step) on the same
    batches: batch 64 of 64x64 BC7 observations, DynamicsConfig(), bf16,
    _GRAPH_TRAIN_STEPS steps from the same seed.  With cuDNN held to its
    deterministic algorithms the losses, parameters, moments and step
    counts must be bit-equal; at the default settings they are printed
    and the losses held at rtol 1e-5 (cuDNN may pick weight-gradient
    algorithms that sum in another order from run to run).  Also: 2 BC7
    launches a replay, the capture's seconds, the peak device memory of
    each, a replay under sync debug mode "error", and the graphed and the
    eager step's period and host enqueue (bench_train_step.bench).
    Returns the BC7 launches."""
    cfg = TL.TrainConfig(dynamics=D.DynamicsConfig(), batch_size=_TRAIN_BATCH,
                         n_steps=_GRAPH_TRAIN_STEPS, compressed_obs=True)
    env = TL.SyntheticVisualEnv(cfg.dynamics, cfg.seed, compressed=True)
    batches = [env.sample_batch(np.random.default_rng(
        np.random.SeedSequence([cfg.seed, i])), cfg.batch_size)
        for i in range(cfg.n_steps)]
    bptc.KERNEL_LAUNCHES = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g_losses, g_params, g_opt, prog = _graphed_train(cfg, batches)
        e_losses, e_params, e_opt = _eager_train(cfg, batches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = bptc.KERNEL_LAUNCHES
    bit, diff = _state_diff((g_params, g_opt), (e_params, e_opt))
    if g_losses != e_losses or not bit:
        raise AssertionError(f"graphed train step (deterministic cuDNN): "
                             f"losses {g_losses} against {e_losses}, state "
                             f"max diff {diff}")
    if prog.launches_per_replay != 2 or launches != 2 * (
            2 * cfg.n_steps + R.GRAPH_WARMUP):
        raise AssertionError(f"graphed train step: BC7 launches {launches}, "
                             f"{prog.launches_per_replay} a replay")
    print(f"graphed train step: {cfg.n_steps} steps of train() (batch "
          f"{cfg.batch_size}, 64x64 BC7, DynamicsConfig(), bf16), each a "
          f"replay, against the eager card step on the same batches with "
          f"cuDNN deterministic: losses and parameters, moments and step "
          f"counts bit-equal; losses {g_losses}; BC7 launches {launches} "
          f"({R.GRAPH_WARMUP} warm-ups and {prog.launches_per_replay} a "
          f"replay, then the eager steps' 2 each); capture "
          f"{prog.capture_s:.3f} s (warm-ups included), on {smi}")

    (g_losses, g_params, g_opt, _), graph_mib = _peak_mib(
        lambda: _graphed_train(cfg, batches))
    (e_losses, e_params, e_opt), eager_mib = _peak_mib(
        lambda: _eager_train(cfg, batches))
    bit, diff = _state_diff((g_params, g_opt), (e_params, e_opt))
    np.testing.assert_allclose(g_losses, e_losses, rtol=1e-5)
    print(f"graphed train step, default cuDNN settings: losses "
          f"{'bit-equal' if g_losses == e_losses else 'within rtol 1e-5'} "
          f"(graphed {g_losses}, eager {e_losses}); state bit-equal {bit}, "
          f"max |diff| {diff:.3g}; peak device memory above what was "
          f"allocated before: graphed {graph_mib:.1f} MiB (capture "
          f"included), eager {eager_mib:.1f} MiB, on {smi}")

    params = D.init_params(cfg.dynamics, torch.Generator(
        device="cuda").manual_seed(1), "cuda")
    graph = TL._TrainGraph(params, D.make_optimizer(params), cfg.dynamics,
                           cfg.batch_size, True)
    graph.load(batches[0])
    graph()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.load(batches[1])
        loss = graph()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not np.isfinite(float(loss)):
        raise AssertionError("the sync-debug train replay's loss")
    rows = []
    for program in ("graph", "eager"):
        out = BTS.bench(cfg.dynamics, cfg.batch_size, torch.device("cuda"),
                        5, 20, program)
        card, host = out["times"]["compressed"]
        rows.append((program, statistics.median(card),
                     statistics.median(host), out["launches_per_step"]))
    if any(r[3] != 2.0 for r in rows):
        raise AssertionError(f"graphed train step bench rows: {rows}")
    print("graphed train step: one replay with its batch's upload enqueued "
          "under torch.cuda.set_sync_debug_mode('error'); period by CUDA "
          "events between back-to-back steps and the host's enqueue "
          "(bench_train_step.bench, median of 20 after 5; batch 64, "
          "DynamicsConfig(), bf16): " + "; ".join(
              f"{program} {card:.3f} ms (host {host:.3f} ms)"
              for program, card, host, _ in rows) + f", on {smi}")
    return bptc.KERNEL_LAUNCHES


def _cli_train_path() -> int:
    """python -m detex_tpu_torch.cli.train --steps 5, in process, on the
    card by default (its default config decodes no BC7)."""
    bptc.KERNEL_LAUNCHES = 0
    if cli_train.main(["--steps", "5"]) != 0:
        raise AssertionError("dtx-train returned non-zero")
    return bptc.KERNEL_LAUNCHES


# --- the multi-device layer: one rank over NCCL, two and four over gloo -----

_MD_LQT = (32, 128, 8)      # H, state and control sizes of the sharded LQT
_MD_DECODE_N = 65536        # blocks of the multi-rank decode check
_MD_TIMEOUT = 300.0         # each spawn of ranks, start-up included
# The multi-rank train step: the full-width model at float32 (the ranks'
# tensor-parallel sums run in another order; float32 keeps the loss within
# rtol 1e-5), batch 8 of 64x64 BC7 observations.
_MD_TRAIN = TL.TrainConfig(dynamics=D.DynamicsConfig(
    compute_dtype=torch.float32), batch_size=8, compressed_obs=True)


def _md_lqt_problem() -> tuple:
    """A contractive float32 LQT problem at H = 32 and 128 states on the
    card (spectral radius about 0.95, so float32 keeps 1e-5 of the f64
    value)."""
    h, n, m = _MD_LQT
    rng = np.random.default_rng([_SEED, h])
    arrays = (0.95 * np.eye(n) + 0.05 / math.sqrt(n)
              * rng.standard_normal((h, n, n)),
              0.1 * rng.standard_normal((h, n, m)),
              0.1 * rng.standard_normal((h, n)),
              np.broadcast_to(np.eye(n), (h, n, n)),
              rng.standard_normal((h, n)),
              np.broadcast_to(np.eye(m), (h, m, m)),
              rng.standard_normal((h, m)),
              0.05 * rng.standard_normal((h, m, n)), 2.0 * np.eye(n),
              rng.standard_normal(n))
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                              device="cuda") for a in arrays)


def _md_bytes() -> dict:
    return {f"{op}/{axis}": v for (op, axis), v in
            PM.COLLECTIVE_BYTES.items()}


def _md_control(params, words, cfg, mesh=None):
    """One full-width control step on the generator seed _SEED + 1: (action,
    shifted nominal, host ms to the end of the step)."""
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(_SEED + 1)
    goal = torch.zeros(cfg.dynamics.latent_dim, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        action, shifted, _ = R.control_step(params, nominal, gen, words,
                                            goal, cfg, mesh=mesh)
    torch.cuda.synchronize()
    return action.cpu(), shifted.cpu(), (time.perf_counter() - t0) * 1e3


def _md_train_loss(batch, mesh=None) -> float:
    """The first step's loss of the _MD_TRAIN model from seed _SEED's
    parameters on `batch` (whole; cut to this rank's dp rows on a mesh)."""
    dcfg = _MD_TRAIN.dynamics
    params = D.init_params(dcfg, torch.Generator(device="cuda").manual_seed(
        _SEED), "cuda")
    if mesh is not None:
        params = D.shard_params(params, mesh)
        batch = {k: PM.shard_batch(v, mesh, "dp") for k, v in batch.items()}
    step = TL.make_train_step(dcfg, D.make_optimizer(params), True, mesh)
    return float(step(params, {k: torch.as_tensor(v).cuda()
                               for k, v in batch.items()})[1])


def _md_steps(params, words, cfg, mesh) -> tuple:
    """_md_control 6 times (the first warms up the rank's CUDA libraries):
    the last step's action and nominal, the median host ms of the last 5,
    and the collective bytes of one step."""
    runs = []
    for _ in range(6):
        PM.reset_collective_bytes()
        runs.append(_md_control(params, words, cfg, mesh))
    return (*runs[-1][:2], statistics.median(r[2] for r in runs[1:]),
            _md_bytes())


def _md_rank(rank: int, inputs: dict) -> dict:
    """One rank of the spawned groups (gloo, every rank on card 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = dist.get_world_size()
    cfg = R.ControllerConfig(rollout_axis="dp")
    params = D.init_params(cfg.dynamics, torch.Generator(
        device="cuda").manual_seed(_SEED), "cuda")
    words = torch.as_tensor(inputs["words"], device="cuda")
    out, launches = {}, {}
    mesh = PM.make_mesh((n, 1), device="cuda")
    if PM.capturable(mesh) or R.Controller(
            params, torch.zeros(cfg.dynamics.latent_dim, device="cuda"), cfg,
            device="cuda", mesh=mesh).graphed:
        raise AssertionError("a Controller on a gloo mesh is graphed")
    bptc.KERNEL_LAUNCHES = 0
    out["control"] = _md_steps(params, words, cfg, mesh)
    launches["sharded control step"] = bptc.KERNEL_LAUNCHES
    if n == 4:
        hmesh = PM.make_mesh((2, 2), ("dcn", "ici"), device="cuda")
        bptc.KERNEL_LAUNCHES = 0
        out["hier"] = _md_steps(params, words, dataclasses.replace(
            cfg, rollout_axis=("dcn", "ici")), hmesh)
        launches["hierarchical (dcn, ici) control step"] = \
            bptc.KERNEL_LAUNCHES
    bptc.KERNEL_LAUNCHES = 0
    out["decode"] = {fmt: tuple(t.cpu() for t in engine.decode_blocks_sharded(
        fmt, torch.as_tensor(blocks, device="cuda"), mesh))
        for fmt, blocks in inputs["blocks"].items()}
    launches["sharded decode"] = bptc.KERNEL_LAUNCHES
    sp = PM.make_mesh((n,), ("sp",), device="cuda")
    out["lqt"] = tuple(t.cpu() for t in PL.lqt_backward_parallel_sharded(
        *_md_lqt_problem(), mesh=sp, axis="sp"))
    if n == 4:
        bptc.KERNEL_LAUNCHES = 0
        out["train_loss"] = _md_train_loss(
            inputs["train_batch"], PM.make_mesh((2, 2), device="cuda"))
        launches["dp x tp train step"] = bptc.KERNEL_LAUNCHES
        bptc.KERNEL_LAUNCHES = 0
        out["dryrun"] = entry.dryrun_multichip(inputs["corpus"],
                                               device="cuda")
        launches["dryrun_multichip"] = bptc.KERNEL_LAUNCHES
    out["launches"] = launches
    return out


def _md_one_rank(rng, smi: str) -> dict:
    """The sharded paths at one rank over NCCL in this process, each held
    to its unsharded path on the card.  Returns BC7's launches by path and
    each texture variant's sharded-decode launches."""
    mesh = PM.make_mesh(device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"one-rank backend {dist.get_backend()}")
    cfg = R.ControllerConfig()
    scfg = dataclasses.replace(cfg, rollout_axis="dp")
    params = D.init_params(cfg.dynamics, torch.Generator(
        device="cuda").manual_seed(_SEED), "cuda")
    goal = torch.zeros(cfg.dynamics.latent_dim, device="cuda")
    sharded = R.Controller(params, goal, scfg, seed=_SEED, device="cuda",
                           mesh=mesh)
    plain = R.Controller(params, goal, cfg, seed=_SEED, device="cuda")
    requests = _requests(rng, 5, cfg.dynamics)
    bc7 = {}
    bptc.KERNEL_LAUNCHES = 0
    PM.reset_collective_bytes()
    s_ms, s_actions = _serve(sharded, requests, cfg.mppi)
    bc7["sharded control step (1 rank)"] = bptc.KERNEL_LAUNCHES
    # The sharded Controller on NCCL is graphed too: its
    # GRAPH_WARMUP eager steps and one replay a request, each counted.
    n_steps = len(requests) + R.GRAPH_WARMUP
    if not sharded.graphed or bptc.KERNEL_LAUNCHES != n_steps:
        raise AssertionError(f"BC7 launched {bptc.KERNEL_LAUNCHES} times in "
                             f"{len(requests)} sharded steps")
    per_step = {k: v // n_steps for k, v in _md_bytes().items()}
    u_ms, u_actions = _serve(plain, requests, cfg.mppi)
    diff = max(float(np.abs(s - u).max()) for s, u in zip(s_actions,
                                                          u_actions))
    if diff > 1e-6:
        raise AssertionError(f"sharded and unsharded actions differ by "
                             f"{diff}")
    print(f"multi-device: {len(requests)} full-width control steps sharded "
          f"over 'dp' at 1 rank (NCCL; both Controllers graphed) against the "
          f"unsharded Controller on "
          f"the same seed: max action diff {diff:.3g} (atol 1e-6); BC7 "
          f"launches {bc7['sharded control step (1 rank)']}; collective "
          f"bytes per step {per_step}; on {smi}")

    # The diag_mppi_gap counterpart: one step each, CUDA events, median
    # of 20 after 5 warm-ups, in turns.
    words = torch.as_tensor(requests[0], device="cuda")
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(_SEED)
    times = {"unsharded": [], "sharded": []}
    for i in range(25):
        for name, c, m in (("unsharded", cfg, None), ("sharded", scfg, mesh)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.no_grad():
                R.control_step(params, nominal, gen, words, goal, c, mesh=m)
            end.record()
            end.synchronize()
            if i >= 5:
                times[name].append(start.elapsed_time(end))
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"multi-device step ms (CUDA events, median of 20 after 5 "
          f"warm-ups): unsharded {med['unsharded']:.3f}, sharded 1 rank "
          f"{med['sharded']:.3f} ({med['sharded'] / med['unsharded'] - 1:+.1%})"
          f"; served host ms median unsharded "
          f"{statistics.median(u_ms):.3f}, sharded "
          f"{statistics.median(s_ms):.3f}; on {smi}")

    # decode_blocks_sharded, every variant, at 1,048,576 blocks.
    drng = np.random.default_rng([_SEED, 19])
    variants = {"bptc": F.BPTC, **{v: getattr(F, _VARIANTS[v][3])
                                   for v in _VARIANTS}}
    _reset_counts()
    bptc.KERNEL_LAUNCHES = 0
    PM.reset_collective_bytes()
    sharded_counts = {}
    for v, fmt in variants.items():
        words = _words(drng.integers(0, 256, (_N_BIG, F.block_size_bytes(fmt)),
                                     np.uint8))
        before = dict(_counts(), bptc=bptc.KERNEL_LAUNCHES)
        got = engine.decode_blocks_sharded(fmt, words, mesh)
        sharded_counts[v] = dict(_counts(), bptc=bptc.KERNEL_LAUNCHES)[v] \
            - before[v]
        want = engine.decode_blocks_device(fmt, words)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{v}: sharded decode differs")
    if PM.COLLECTIVE_BYTES or set(sharded_counts.values()) != {1}:
        raise AssertionError(f"sharded decode: bytes "
                             f"{dict(PM.COLLECTIVE_BYTES)}, launches "
                             f"{sharded_counts}")
    bc7["sharded decode (1 rank)"] = sharded_counts["bptc"]
    print(f"multi-device: decode_blocks_sharded bit-exact to "
          f"decode_blocks_device for all {len(variants)} variants at "
          f"{_N_BIG} blocks, one launch each, 0 collective bytes")

    # The horizon-sharded LQT at one rank.
    prob = _md_lqt_problem()
    sp = PM.make_mesh(None, ("sp",), device="cuda")
    PM.reset_collective_bytes()
    got = PL.lqt_backward_parallel_sharded(*prob, mesh=sp, axis="sp")
    lqt_bytes = _md_bytes()
    for g, w in zip(got, PL.lqt_backward_parallel(*prob)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
    print(f"multi-device: lqt_backward_parallel_sharded at H={_MD_LQT[0]}, "
          f"n={_MD_LQT[1]} (1 rank) within rtol 2e-4 of "
          f"lqt_backward_parallel; collective bytes {lqt_bytes}")

    # One (1, 1) train step against the unsharded one (bf16, full width).
    tcfg = TL.TrainConfig(dynamics=D.DynamicsConfig(), batch_size=16,
                          compressed_obs=True)
    env = TL.SyntheticVisualEnv(tcfg.dynamics, tcfg.seed, compressed=True)
    batch = {k: torch.as_tensor(v).cuda() for k, v in env.sample_batch(
        np.random.default_rng(_SEED), tcfg.batch_size).items()}
    tmesh = PM.make_mesh((1, 1), device="cuda")
    base = D.init_params(tcfg.dynamics, torch.Generator(
        device="cuda").manual_seed(_SEED), "cuda")
    results = []
    # Deterministic cuDNN: AdamW's first update is about lr * sign(g), so a
    # weight gradient reduced in another order could flip a sign.
    torch.backends.cudnn.deterministic = True
    try:
        for m in (None, tmesh):
            p = _clone(base)
            step = TL.make_train_step(tcfg.dynamics, D.make_optimizer(p),
                                      True, m)
            bptc.KERNEL_LAUNCHES = 0
            _, loss = step(p, batch)
            results.append((p, float(loss), bptc.KERNEL_LAUNCHES))
    finally:
        torch.backends.cudnn.deterministic = False
    (p_u, loss_u, _), (p_s, loss_s, launches) = results
    bc7["sharded train step (1 rank)"] = launches
    np.testing.assert_allclose(loss_s, loss_u, rtol=1e-6)
    for a, b in zip(D.param_leaves(p_s), D.param_leaves(p_u)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    print(f"multi-device: (1, 1) train step loss {loss_s:.9g} (unsharded "
          f"{loss_u:.9g}), parameters within 1e-6; BC7 launches {launches}")
    # The graphs that hold the group's communicators go before the group.
    del sharded, plain
    _destroy_world()
    return {"bc7": bc7, "decode": sharded_counts}


def _destroy_world() -> None:
    """Destroy the process group once nothing holds its communicators: the
    graphs captured on it are freed first."""
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()


# (label, iLQR iterations, parallel LQT).
_MD_GRAPH_CASES = (("MPPI", 0, False), ("iLQR sequential", 2, False),
                   ("iLQR parallel LQT", 2, True))


def _md_graph_case(params, goal, cfg, requests, mesh, label: str,
                   smi: str) -> int:
    """A graphed sharded Controller on `mesh` over `requests`, held to the
    eager sharded control_step on the same noise, bit-equal: the graph
    replays the eager step's kernels and collectives, and the parallel
    LQT's LU runs on cuSOLVER/cuBLAS in both (parallel_lqr._lu_library),
    with torch's LU setting as it was before the steps.  Also held to the
    unsharded graphed Controller (atol 1e-6), with its BC7 launches and
    collective bytes a replay against the eager step's.  Returns the
    graphed sharded Controller's BC7 launches."""
    library = torch.backends.cuda.preferred_linalg_library()
    launches = bptc.KERNEL_LAUNCHES
    PM.reset_collective_bytes()
    ctl = R.Controller(params, goal, cfg, seed=_SEED, device="cuda",
                       mesh=mesh)
    got, graph_mib = _peak_mib(lambda: [ctl.step(w) for w in requests])
    launches = bptc.KERNEL_LAUNCHES - launches
    graph_bytes = _md_bytes()
    prog = ctl._program
    PM.reset_collective_bytes()
    (want, _, gen), eager_mib = _peak_mib(
        lambda: _eager_serve(params, goal, cfg, requests, mesh))
    eager_step = {k: v // len(requests) for k, v in _md_bytes().items()}
    per_replay = {f"{op}/{axis}": v for (op, axis), v in
                  prog._graph.collective_bytes.items()}
    n_steps = len(requests) + R.GRAPH_WARMUP
    if not ctl.graphed or prog.launches_per_replay != 1 or launches != n_steps:
        raise AssertionError(f"graphed sharded {label}: BC7 launched "
                             f"{launches} times in {len(requests)} steps")
    if per_replay != eager_step or graph_bytes != {
            k: v * n_steps for k, v in eager_step.items()}:
        raise AssertionError(f"graphed sharded {label}: collective bytes a "
                             f"replay {per_replay}, in all {graph_bytes}, "
                             f"against the eager step's {eager_step}")
    diffs = [float(np.abs(a - w).max()) for a, w in zip(got, want)]
    if not all(np.array_equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"graphed sharded {label}: actions differ from "
                             f"the eager sharded step's by {diffs}")
    left = torch.backends.cuda.preferred_linalg_library()
    if left != library:
        raise AssertionError(f"graphed sharded {label}: torch's LU setting "
                             f"left as {left}, not {library}")
    if not torch.equal(ctl.generator.get_state(), gen.get_state()):
        raise AssertionError(f"graphed sharded {label}: generator state")
    plain = R.Controller(params, goal, dataclasses.replace(
        cfg, rollout_axis=None), seed=_SEED, device="cuda")
    unsharded = [plain.step(w) for w in requests]
    udiff = max(float(np.abs(a - u).max()) for a, u in zip(got, unsharded))
    ubit = all(np.array_equal(a, u) for a, u in zip(got, unsharded))
    if not plain.graphed or not udiff <= 1e-6:
        raise AssertionError(f"graphed sharded {label}: actions differ from "
                             f"the unsharded graphed Controller's by {udiff}")
    print(f"graphed multi-device, {label}: {len(requests)} full-width steps "
          f"of a Controller sharded over 'dp' at 1 NCCL rank, each a graph "
          f"replay, against the eager sharded control_step on the same "
          f"noise: bit-equal (max |action diff| per step {diffs}); torch's "
          f"LU setting {library} before and after; generator state equal; "
          f"against the unsharded "
          f"graphed Controller: max diff {udiff:.3g} (atol 1e-6), bit-equal "
          f"{ubit}; BC7 launches {launches} ({R.GRAPH_WARMUP} warm-ups, "
          f"{prog.launches_per_replay} a replay); collective bytes a replay "
          f"{per_replay}, the eager step's {eager_step}; capture "
          f"{prog.capture_s:.3f} s (warm-ups included); peak device memory "
          f"above what was allocated before: graphed {graph_mib:.1f} MiB "
          f"(capture included), eager {eager_mib:.1f} MiB, on {smi}")
    return launches


def _md_train_times(mesh, batch) -> list:
    """[(program, card ms, host ms)]: medians of 20 train steps on `mesh`
    after 5 (tools.step_times: CUDA events between back-to-back steps),
    "graph" (a _TrainGraph replay, its capture among the warm-ups) and
    "eager" (train_body), batch 64 of 64x64 BC7, DynamicsConfig(), bf16,
    each step's words xor'd on the card with the step index, as
    bench_train_step does."""
    dcfg = D.DynamicsConfig()
    words = {k: torch.as_tensor(batch[k]).cuda()
             for k in ("obs_words", "next_obs_words")}
    action = torch.as_tensor(batch["action"]).cuda()
    rows = []
    for program in ("graph", "eager"):
        params = D.init_params(dcfg, torch.Generator(
            device="cuda").manual_seed(_SEED), "cuda")
        opt = D.make_optimizer(params)
        graph = None
        if program == "graph":
            graph = TL._TrainGraph(params, opt, dcfg, _TRAIN_BATCH, True,
                                   mesh)
            graph.batch["action"].copy_(action)

        def step(i, graph=graph, params=params, opt=opt):
            if graph is not None:
                for k, w in words.items():
                    graph.batch[k].copy_(w ^ i)
                graph()
            else:
                TL.train_body(params, opt, dict(
                    {k: w ^ i for k, w in words.items()}, action=action),
                    dcfg, True, mesh)
        card, host = tools.step_times(step, torch.device("cuda"), 5, 20)
        rows.append((program, statistics.median(card),
                     statistics.median(host)))
        del graph, step
    return rows


def _md_graphed_one_rank(smi: str) -> dict:
    """The sharded steps' one-program form at one rank over NCCL, in a fresh
    world of one (the phase before destroys its own): graphed sharded
    Controllers (rollouts over "dp"; _GRAPH_STEPS full-width steps each for
    MPPI on the random weights and for 2 iLQR iterations, sequential and
    parallel LQT, on damped dynamics toward a random goal), each held to
    the eager sharded step and the unsharded graphed Controller
    (_md_graph_case); a graphed sharded PipelinedController one step
    behind, with a step under sync debug "error"; the graphed and the
    eager sharded step's period and host enqueue (bench_control_step.bench
    on the mesh, median of 20 after 5); and train() on the (1, 1) mesh,
    each step a replay, against the eager sharded train step over
    _GRAPH_TRAIN_STEPS full-width steps (batch 64 of 64x64 BC7,
    DynamicsConfig(), bf16) with deterministic cuDNN: bit-equal.  Returns
    BC7's launches by path."""
    mesh = PM.make_mesh((1, 1), device="cuda")
    if dist.get_backend() != "nccl" or not PM.capturable(mesh):
        raise AssertionError(f"graphed one-rank backend "
                             f"{dist.get_backend()}")
    base = R.ControllerConfig(rollout_axis="dp")
    dcfg, mcfg = base.dynamics, base.mppi
    rng = np.random.default_rng([_SEED, 15])
    params = D.init_params(dcfg, torch.Generator(device="cuda").manual_seed(
        _SEED), "cuda")
    zero = torch.zeros(dcfg.latent_dim, device="cuda")
    goal = torch.from_numpy((0.5 * rng.standard_normal(dcfg.latent_dim))
                            .astype(np.float32)).cuda()
    requests = _requests(rng, _GRAPH_STEPS, dcfg)
    bc7 = {"graphed sharded control step (1 rank)": 0}
    for label, n_ilqr, parallel in _MD_GRAPH_CASES:
        cfg = dataclasses.replace(base, n_ilqr_iterations=n_ilqr,
                                  ilqr_parallel=parallel)
        prm, g = (_damped(params), goal) if n_ilqr else (params, zero)
        bc7["graphed sharded control step (1 rank)"] += _md_graph_case(
            prm, g, cfg, requests, mesh, label, smi)

    ctl = R.Controller(params, zero, base, seed=_SEED, device="cuda",
                       mesh=mesh)
    launches = bptc.KERNEL_LAUNCHES
    pipe = R.PipelinedController(params, zero, base, seed=_SEED,
                                 device="cuda", mesh=mesh)
    piped = [pipe.step(w) for w in requests] + [pipe.flush()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = pipe.step(requests[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    last = pipe.flush()
    bc7["graphed sharded pipelined (1 rank)"] = \
        bptc.KERNEL_LAUNCHES - launches
    want = [ctl.step(w) for w in requests]
    if (not pipe.graphed or piped[0] is not None or first is not None
            or last is None or bc7["graphed sharded pipelined (1 rank)"]
            != len(requests) + 1 + R.GRAPH_WARMUP
            or not all(np.array_equal(a, w)
                       for a, w in zip(piped[1:], want))):
        raise AssertionError("graphed sharded PipelinedController")
    _check_action(last, mcfg, pipe.diag)
    print(f"graphed multi-device, pipelined: {len(requests)} requests through "
          f"a PipelinedController sharded over 'dp' at 1 NCCL rank, graphed: "
          f"actions bit-equal to the graphed sharded Controller's one step "
          f"later; one step enqueued under torch.cuda.set_sync_debug_mode("
          f"'error') without a synchronising call, on {smi}")
    del ctl, pipe

    rows = []
    for label, n_ilqr, parallel in _MD_GRAPH_CASES:
        cfg = dataclasses.replace(base, n_ilqr_iterations=n_ilqr,
                                  ilqr_parallel=parallel)
        for program in ("graph", "eager"):
            out = BCS.bench(cfg, torch.device("cuda"), 5, 20, program,
                            mesh=mesh)
            rows.append((label, program, statistics.median(out["card_ms"]),
                         statistics.median(out["host_ms"])))
    print("graphed multi-device, sharded step period by CUDA events between "
          "back-to-back steps and the host's enqueue (bench_control_step."
          "bench on the (1, 1) NCCL mesh, median of 20 after 5; random "
          "weights): " + "; ".join(
              f"{label} {program} {card:.3f} ms (host {host:.3f} ms)"
              for label, program, card, host in rows) + f", on {smi}")

    tcfg = TL.TrainConfig(dynamics=D.DynamicsConfig(),
                          batch_size=_TRAIN_BATCH, n_steps=_GRAPH_TRAIN_STEPS,
                          compressed_obs=True, mesh_shape=(1, 1))
    env = TL.SyntheticVisualEnv(tcfg.dynamics, tcfg.seed, compressed=True)
    batches = [env.sample_batch(np.random.default_rng(
        np.random.SeedSequence([tcfg.seed, i])), tcfg.batch_size)
        for i in range(tcfg.n_steps)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches = bptc.KERNEL_LAUNCHES
        g_losses, g_params, g_opt, tprog = _graphed_train(tcfg, batches)
        bc7["graphed sharded train step (1 rank)"] = \
            bptc.KERNEL_LAUNCHES - launches
        PM.reset_collective_bytes()
        e_losses, e_params, e_opt = _eager_train(tcfg, batches, mesh)
        eager_step = {k: v // tcfg.n_steps for k, v in _md_bytes().items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bit, diff = _state_diff((g_params, g_opt), (e_params, e_opt))
    per_replay = {f"{op}/{axis}": v for (op, axis), v in
                  tprog._graph.collective_bytes.items()}
    if (tprog.mesh is None or tprog.launches_per_replay != 2
            or bc7["graphed sharded train step (1 rank)"]
            != 2 * (tcfg.n_steps + R.GRAPH_WARMUP)
            or per_replay != eager_step):
        raise AssertionError(f"graphed sharded train step: launches "
                             f"{bc7['graphed sharded train step (1 rank)']}"
                             f", bytes a replay {per_replay} against "
                             f"{eager_step}")
    if g_losses != e_losses or not bit:
        raise AssertionError(f"graphed sharded train step: losses {g_losses} "
                             f"against {e_losses}, state max diff {diff}")
    print(f"graphed multi-device, train: {tcfg.n_steps} steps of train() on "
          f"the (1, 1) NCCL mesh (batch {tcfg.batch_size}, 64x64 BC7, "
          f"DynamicsConfig(), bf16), each a replay holding the dp "
          f"all_reduce, against the eager sharded train step on the same "
          f"batches with cuDNN deterministic: losses and parameters, moments "
          f"and step counts bit-equal; losses {g_losses}; BC7 launches "
          f"{bc7['graphed sharded train step (1 rank)']} ({R.GRAPH_WARMUP} "
          f"warm-ups, {tprog.launches_per_replay} a replay); collective bytes "
          f"a replay {per_replay}, the eager step's {eager_step}; capture "
          f"{tprog.capture_s:.3f} s (warm-ups included), on {smi}")
    del tprog, g_params, g_opt
    rows = _md_train_times(mesh, batches[0])
    print("graphed multi-device, train step period by CUDA events between "
          "back-to-back steps and the host's enqueue on the (1, 1) NCCL mesh "
          "(median of 20 after 5; batch 64, DynamicsConfig(), bf16): "
          + "; ".join(f"{program} {card:.3f} ms (host {host:.3f} ms)"
                      for program, card, host in rows) + f", on {smi}")
    _destroy_world()
    return bc7


def _md_ranks(smi: str) -> dict:
    """Two and four ranks on the one card over gloo (NCCL takes one rank
    per card), spawned; each result held to the unsharded one on the card.
    Returns BC7's launches by path, summed over the ranks."""
    cfg = R.ControllerConfig()
    rng = np.random.default_rng([_SEED, 4])
    words = rng.integers(-2**31, 2**31, ((cfg.dynamics.image_size // 4) ** 2,
                                         4), np.int64).astype(np.int32)
    blocks = {fmt: words_from_bytes(rng.integers(
        0, 256, (_MD_DECODE_N, 16), np.uint8)) for fmt in (F.BPTC,
                                                          F.BPTC_FLOAT)}
    env = TL.SyntheticVisualEnv(_MD_TRAIN.dynamics, _SEED, compressed=True)
    train_batch = {k: torch.as_tensor(v) for k, v in env.sample_batch(
        rng, _MD_TRAIN.batch_size).items()}
    corpus_dir = tempfile.mkdtemp()
    corpus = Path(corpus_dir) / "test-texture-BPTC.ktx"
    tio.save_ktx([Texture.new(F.BPTC, np.load(_GOLDEN)["corpus_blocks"],
                              64, 64)], str(corpus))
    inputs = {"words": words, "blocks": blocks, "train_batch": train_batch,
              "corpus": str(corpus)}

    params = D.init_params(cfg.dynamics, torch.Generator(
        device="cuda").manual_seed(_SEED), "cuda")
    want_a, want_s, _ = _md_control(params, torch.as_tensor(
        words, device="cuda"), cfg)
    want_decode = {fmt: tuple(t.cpu() for t in engine.decode_blocks_device(
        fmt, torch.as_tensor(b, device="cuda"))) for fmt, b in blocks.items()}
    want_lqt = tuple(t.cpu() for t in PL.lqt_backward_parallel(
        *_md_lqt_problem()))
    want_loss = _md_train_loss(train_batch)

    bc7 = {}
    try:
        for n in (2, 4):
            t0 = time.perf_counter()
            outs = launch.run_ranks(_md_rank, n, (inputs,), device="cuda",
                                    backend="gloo", timeout=_MD_TIMEOUT)
            wall = time.perf_counter() - t0
            for r, out in enumerate(outs):
                for key in ("control", "hier") if n == 4 else ("control",):
                    a, s = out[key][:2]
                    torch.testing.assert_close(a, want_a, rtol=3e-5,
                                               atol=3e-6)
                    torch.testing.assert_close(s, want_s, rtol=3e-5,
                                               atol=3e-6)
                for fmt, (pix, valid) in out["decode"].items():
                    m = _MD_DECODE_N // n
                    if not (torch.equal(pix, want_decode[fmt][0][r * m:
                                                                (r + 1) * m])
                            and torch.equal(valid, want_decode[fmt][1]
                                            [r * m:(r + 1) * m])):
                        raise AssertionError(f"{n} ranks: decode {fmt:#x}")
                for g, w in zip(out["lqt"], want_lqt):
                    torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
                if n == 4:
                    np.testing.assert_allclose(out["train_loss"], want_loss,
                                               rtol=1e-5)
                    d = out["dryrun"]
                    if (d["loss"] != outs[0]["dryrun"]["loss"]
                            or not torch.equal(d["hier_action"],
                                               outs[0]["dryrun"]
                                               ["hier_action"])):
                        raise AssertionError("dryrun ranks disagree")
            for path in outs[0]["launches"]:
                bc7[f"{path} ({n} ranks)"] = sum(o["launches"][path]
                                                 for o in outs)
            control = outs[0]["control"]
            print(f"multi-device: {n} ranks on one card (gloo; a Controller "
                  f"there is eager, graphed False): full-width "
                  f"sharded control step within rtol 3e-5 / atol 3e-6 of "
                  f"the unsharded one on the card (6 steps a rank; host ms, "
                  f"rank 0, median of the last 5: {control[2]:.3f}; "
                  f"collective bytes a step {control[3]})"
                  + (f", ('dcn', 'ici') step likewise (ms "
                     f"{outs[0]['hier'][2]:.3f}, bytes {outs[0]['hier'][3]})"
                     f", (2, 2) dp x tp train step loss "
                     f"{outs[0]['train_loss']:.9g} vs {want_loss:.9g} "
                     f"(rtol 1e-5), dryrun_multichip loss "
                     f"{outs[0]['dryrun']['loss']:.6g} on mesh "
                     f"{outs[0]['dryrun']['mesh']}" if n == 4 else "")
                  + f"; BPTC and BPTC_FLOAT decode bit-exact at "
                  f"{_MD_DECODE_N} blocks; LQT within rtol 2e-4; wall "
                  f"{wall:.2f} s (spawn included) on {smi}")
    finally:
        shutil.rmtree(corpus_dir, ignore_errors=True)
    return bc7


def _multi_device_phase(rng, smi: str) -> tuple:
    one = _phase("multi-device 1 rank", _md_one_rank, rng, smi)
    bc7 = dict(one["bc7"], **_phase("graphed multi-device 1 rank",
                                   _md_graphed_one_rank, smi))
    bc7.update(_phase("multi-device 2 and 4 ranks", _md_ranks, smi))
    return bc7, one["decode"]


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


# Whether each value of an ETC colour byte overflows (_overflow_bytes).
_ETC_OVERFLOWS = np.isin(np.arange(256), _overflow_bytes()[0])


def _force_etc_mode(b: np.ndarray, rows: np.ndarray, c: int, mode: int,
                    rng) -> None:
    """Draws the colour bytes (at byte c) of `rows` so that a differential
    ETC2 block decodes in `mode` 1-4: the first overflowing channel R, G, B
    makes mode 2, 3, 4; none, 1."""
    ovf, ok = _overflow_bytes()
    for ch in range(3 if mode == 1 else mode - 1):
        vals = ovf if ch == mode - 2 else ok
        b[rows, c + ch] = rng.choice(vals, len(rows))


def _etc_colour_byte(variant: str) -> int:
    """Offset of an ETC variant's colour block in its block: ETC2_EAC's
    follows its 8 B alpha block."""
    return 8 if variant == "etc2_eac" else 0


def etc_mode_key(variant: str, blocks: np.ndarray) -> np.ndarray:
    """Each ETC colour block's mode, as csrc/etc_eac.cuh:etc_mode gives it:
    0 individual, 1 differential, 2 T, 3 H, 4 planar (ETC1: 0 or 1;
    punchthrough's differential bit is its opacity, so never 0; ETC2_EAC's
    colour block is ETC2's)."""
    c = _etc_colour_byte(variant)
    diff = (blocks[:, c + 3] & 2) != 0
    if variant == "etc1":
        return diff.astype(np.int64)
    r, g, b = (_ETC_OVERFLOWS[blocks[:, c + k]] for k in range(3))
    mode = np.where(r, 2, np.where(g, 3, np.where(b, 4, 1)))
    return mode if variant == "etc2_punchthrough" else np.where(diff, mode, 0)


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
    if variant.startswith("etc"):
        c = _etc_colour_byte(variant)
        b[e[1], c + 3] &= 0xFD
        for k, mode in ((2, 1), (3, 2), (4, 3), (5, 4)):
            b[e[k], c + 3] |= 2
            _force_etc_mode(b, e[k], c, mode, rng)
        b[e[6], c + 3] &= 0xFD
        for rows, mode in zip(np.array_split(e[6], 3), (2, 3, 4)):
            _force_etc_mode(b, rows, c, mode, rng)
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


# The BC6H draw (cli/validate.py, shared with the fuzz): mode codes uniform
# over the 14 modes and the 4 reserved codes.  tests/test_torch_bptc_float.py
# draws its blocks here too.
_BC6H_CODES = cli_validate.BC6H_CODES
bc6h_mode_blocks = cli_validate.bc6h_mode_blocks


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
def _eager_programs():
    """The texture programs (graphs.Program: the engine's pipelines and
    the uncompressed conversion) run their bodies eagerly inside the block,
    with no graph kept from before it or made in it: the reference runs of
    the plain versions, which a graph of the kernels' must not answer."""
    call = graphs.Program.__call__
    graphs._PROGRAMS.clear()
    graphs.Program.__call__ = lambda self, x: self.fn(x)
    try:
        yield
    finally:
        graphs.Program.__call__ = call
        graphs._PROGRAMS.clear()


@contextlib.contextmanager
def _plain_versions():
    """Swap every texture-path wrapper for its plain version, run eagerly
    (_eager_programs)."""
    saved = {v: _wrapper(v) for v in _VARIANTS}
    try:
        for v in _VARIANTS:
            setattr(_VARIANTS[v][1], _VARIANTS[v][2], _plain(v))
        with _eager_programs():
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
    """The port's hdr parameters set to `params` (gamma, range min, range
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
    convert on the host with the port's copy of the host converter.  At
    gamma != 1 the host converter calls glibc powf once per lane (minutes
    for 67M lanes), so there the converter runs once on each of the 65,536
    half-float values and the texture's lanes are looked up in its result:
    the same bytes,
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
        torch.from_numpy(tiles).reshape(tex.n_blocks, 16, -1),
        tex.width_in_blocks, tex.height_in_blocks, tex.width, tex.height))


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
    graphs._PROGRAMS.clear()
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
            # Each call is its key's first, which runs eagerly: one launch.
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
          f"{_TEX}x{_TEX} textures, each the first of its key, run eagerly "
          f"(one launch of its kernel), byte-equal to the plain versions "
          f"(no launches); {len(host_s)} "
          f"of them byte-equal to the torch backend "
          f"({', '.join(f'{v} {lb}' for v, lb in host_s)}); launches "
          f"{launches}")
    for (variant, label), sec in wall.items():
        if label == "cropped":
            continue
        host = host_s.get((variant, label))
        print(f"texture wall: {variant} {_TEX}x{_TEX} -> {label}: "
              f"{sec * 1e3:.3f} ms host bytes in to host bytes out, "
              f"{_N_BIG / sec:.4g} blocks/s (its key's first call, "
              f"eager)" + ("" if host is None else
                              f"; torch backend {host * 1e3:.1f} ms")
              + f" on {smi}")
    return launches


def _graphed_texture_path(blocks: dict, smi: str) -> dict:
    """Every variant's 4096^2 texture (BPTC's of the tools' blocks, modes
    uniform) in its native format through its pipeline
    (engine._device_pipeline), linear and tiled, three times: the key's
    first call (eager), its second (warm-ups, capture, replay) and a third
    (a replay), each byte-equal to the eager pipeline
    (engine._pipeline_body) on the same words and to the native runtime,
    one kernel launch a replay.  Then a 4096^2 BPTC_FLOAT -> RGBA8
    decompress_texture_linear(backend="device") called three times: the
    one-shot (eager) call against the capturing call and a replay, by wall
    time and peak device memory, and the reserve the kept graph holds;
    dtx-convert -d on a BPTC_FLOAT .ktx with its whole mip chain (4096^2
    down to 1x1; every level a key called once) and the graphs and reserve
    the cache keeps after it; a BC6H -> RGBA8 replay and a u16 -> f16
    conversion replay under sync debug mode "error"; and the 1024^2
    ETC2_EAC -> RGBA8 pipeline's period and host enqueue, graphed and
    eager (bench_pipelines.bench_etc_pipeline).  Returns the launch
    counts."""
    _reset_all_counts()
    graphs._PROGRAMS.clear()
    checked = 0
    textures = [(v, _texture_calls(v, b)[0][1]) for v, b in blocks.items()]
    textures.append(("bptc", Texture.new(F.BY_NAME["BPTC"].fmt,
                                         MP.tool_blocks(_N_BIG), _TEX, _TEX)))
    for variant, tex in textures:
        pf = F.texture_pixel_format(tex.format)
        words = engine._texture_words(tex, "cuda")
        for tiled, native_fn in ((False, engine.decompress_texture_linear),
                                 (True, engine.decompress_texture_tiled)):
            pipeline = engine._device_pipeline(
                tex.format, pf, tex.width_in_blocks, tex.height_in_blocks,
                tex.width, tex.height, tiled)
            before = _all_counts()
            outs = [CD.to_bytes(pipeline(words)) for _ in range(3)]
            added = {k: n - before[k] for k, n in _all_counts().items()}
            eager = CD.to_bytes(engine._pipeline_body(
                tex.format, pf, tex.width_in_blocks, tex.height_in_blocks,
                tex.width, tex.height, tiled, _FULL, 0)(words))
            native = native_fn(tex, None, backend="native")
            prog = graphs._PROGRAMS[next(reversed(graphs._PROGRAMS))]
            if prog.graph is None or prog.graph.launches != {variant: 1} or \
                    added[variant] != R.GRAPH_WARMUP + 3 or \
                    sum(added.values()) != added[variant]:
                raise AssertionError(f"graphed {variant} tiled={tiled}: "
                                     f"launches {added}, a replay "
                                     f"{prog.graph and prog.graph.launches}")
            if not (all(np.array_equal(o, eager) for o in outs) and
                    np.array_equal(outs[0], native)):
                raise AssertionError(f"graphed {variant} tiled={tiled}: "
                                     f"differs from the eager pipeline or "
                                     f"the native runtime")
            checked += 1
    launches = _all_counts()
    print(f"graphed texture pipelines: {checked} pipelines ({len(textures)} "
          f"variants x linear and tiled, {_TEX}x{_TEX}, native format), "
          f"each called three times (eager, capture, replay), each call "
          f"byte-equal to the eager pipeline and to the native runtime; "
          f"one launch a replay (the eager check's launch beside it); "
          f"launches {launches}")

    tex = _texture_calls("bptc_float", blocks["bptc_float"])[0][1]
    graphs._PROGRAMS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, mib = _peak_mib(lambda: engine.decompress_texture_linear(
            tex, F.RGBA8, backend="device", device="cuda"))
        calls.append((time.perf_counter() - t0, mib, out))
    if not all(np.array_equal(c[2], calls[0][2]) for c in calls):
        raise AssertionError("the BPTC_FLOAT -> RGBA8 calls differ")
    (prog,) = graphs._PROGRAMS.values()
    capture_s = prog.graph.capture_s
    del prog                # the cache holds the program's only reference
    torch.cuda.empty_cache()
    kept_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    graphs._PROGRAMS.clear()
    torch.cuda.empty_cache()
    freed_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    print(f"graphed texture pipelines: {_TEX}x{_TEX} BPTC_FLOAT -> RGBA8, "
          f"decompress_texture_linear(backend='device'), host bytes in to "
          f"host bytes out: one-shot (the key's first call, eager) "
          f"{calls[0][0] * 1e3:.3f} ms, peak {calls[0][1]:.1f} MiB above "
          f"what was allocated before; second call (warm-ups, capture "
          f"{capture_s * 1e3:.3f} ms, replay) "
          f"{calls[1][0] * 1e3:.3f} ms, peak {calls[1][1]:.1f} MiB; "
          f"replay {calls[2][0] * 1e3:.3f} ms, peak {calls[2][1]:.1f} MiB; "
          f"the kept graph's reserve after empty_cache "
          f"{kept_mib:.1f} MiB ({freed_mib:.1f} MiB once dropped), on {smi}")

    mips, side = [], _TEX
    fmt = F.BY_NAME["BPTC_FLOAT"].fmt
    while side >= 1:
        n = (-(-side // 4)) ** 2
        mips.append(Texture.new(fmt, blocks["bptc_float"][:n], side, side))
        side //= 2
    graphs._PROGRAMS.clear()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "mips.ktx"
        tio.save_ktx(mips, str(src))
        t0 = time.perf_counter()
        cli_convert.main(["-q", "-d", str(src), str(Path(tmp) / "k.ktx")])
        wall = time.perf_counter() - t0
        kept = len(graphs._PROGRAMS)
        captured = sum(p.graph is not None
                       for p in graphs._PROGRAMS.values())
        torch.cuda.empty_cache()
        kept_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
        cli_convert.main(["-q", "-d", "--backend", "native", str(src),
                          str(Path(tmp) / "n.ktx")])
        same = (Path(tmp) / "k.ktx").read_bytes() == \
            (Path(tmp) / "n.ktx").read_bytes()
    if not same or captured:
        raise AssertionError(f"mip chain: equal to the native run {same}, "
                             f"graphs captured {captured}")
    print(f"graphed texture pipelines: dtx-convert -d on a {_TEX}x{_TEX} "
          f"BPTC_FLOAT .ktx with {len(mips)} mip levels -> FLOAT_RGB16, "
          f"byte-equal to --backend native: {wall * 1e3:.1f} ms, "
          f"{kept} programs cached, {captured} graphs captured, reserve "
          f"after empty_cache {kept_mib:.1f} MiB above before, on {smi}")
    graphs._PROGRAMS.clear()

    words = engine._texture_words(tex, "cuda")
    pipeline = engine._device_pipeline(tex.format, F.RGBA8,
                                       tex.width_in_blocks,
                                       tex.height_in_blocks, tex.width,
                                       tex.height)
    arr = torch.from_numpy(np.random.default_rng(3).integers(
        -2**15, 2**15, (1 << 20, 4), np.int64).astype(np.int16)).cuda()
    for _ in range(2):      # each key's eager call, then its capture
        pipeline(words)
        CD.convert_pixels_graphed(arr, F.RGBX16, F.FLOAT_RGBX16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = pipeline(words)
        half = CD.convert_pixels_graphed(arr, F.RGBX16, F.FLOAT_RGBX16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = CD.convert_pixels_device(arr, F.RGBX16, F.FLOAT_RGBX16)
    if not torch.equal(half, want) or not np.array_equal(
            CD.to_bytes(img), engine.decompress_texture_linear(
                tex, F.RGBA8, backend="native")):
        raise AssertionError("the sync-debug replays differ")
    graphs._PROGRAMS.clear()

    args = argparse.Namespace(side=1024, warmup=10, steps=100)
    rows = [BPL.bench_etc_pipeline(torch.device("cuda"), args, program)
            for program in ("graph", "eager")]
    if any(r["etc2_eac_launches_per_step"] != 1.0 for r in rows):
        raise AssertionError(f"graphed texture pipelines: bench rows {rows}")
    print("graphed texture pipelines: a BC6H -> RGBA8 replay and a "
          "RGBX16 -> FLOAT_RGBX16 conversion replay enqueued under "
          "torch.cuda.set_sync_debug_mode('error'), byte-equal; 1024^2 "
          "ETC2_EAC -> RGBA8 period by CUDA events between back-to-back "
          "steps and the host's enqueue (bench_pipelines, median of 100 "
          "after 10): " + "; ".join(
              f"{r['program']} {r['ms_per_1024sq_texture']:.4f} ms (p10 "
              f"{r['p10_ms']:.4f}, p90 {r['p90_ms']:.4f}; host "
              f"{r['host_ms_per_step']:.4f} ms)" for r in rows)
          + f"; capture {rows[0]['capture_s']:.3f} s, on {smi}")
    return launches


def _conversion_sweep(smi: str) -> None:
    """tools.convert_sweep on the card: every pair of formats the host
    converter allows (449), each source's buffer with NaN, +-inf, denormal
    and signed-zero lanes (0 and the limits in integer lanes) and 257
    random pixels, under the default HDR parameters and gamma 2.2 on
    [0, 4], through convert_pixels_torch (each key's first, eager call),
    bit-equal to the port's host converter."""
    graphs._PROGRAMS.clear()
    t0 = time.perf_counter()
    out = CSW.sweep("cuda")
    wall = time.perf_counter() - t0
    graphs._PROGRAMS.clear()
    print(f"conversion sweep: {out['pairs']} pairs checked ({out['runs']} "
          f"conversions: {len(CSW.HDR_SETTINGS)} HDR settings) on the card "
          f"against the host converter, {len(out['differing'])} differing"
          f"{' ' + json.dumps(out['differing']) if out['differing'] else ''}"
          f", in {wall:.2f} s on {smi}")
    if out["differing"] or out["pairs"] != len(CSW.pairs()):
        raise AssertionError(f"conversion sweep: {out}")


def _cli_path(blocks: dict) -> None:
    """dtx-convert -d (the device backend) on a 4096^2 BC3, ETC2_EAC,
    EAC_RG11 and BPTC_FLOAT .ktx written with save_ktx, each against the
    same run with the plain versions and with its kernel's launches alone
    (every call its key's first: one eager launch); BPTC_FLOAT
    (written as FLOAT_RGB16) also against --backend torch."""
    for variant in ("bc3", "etc2_eac", "eac_rg11", "bptc_float"):
        family = _VARIANTS[variant][3]
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "in.ktx"
            tio.save_ktx([Texture.new(F.BY_NAME[family].fmt, blocks[variant],
                                      _TEX, _TEX)], str(src))
            _reset_counts()
            graphs._PROGRAMS.clear()
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
                 else "") + f"; {variant} kernel launches "
              f"{launches[variant]} (the key's first call, eager)")


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


def _device_us(blocks: dict, smi: str) -> dict:
    """Device time per launch of each variant's kernel at N = 1,048,576:
    {variant: (CUDA events, torch.profiler)}.  The events
    (tools.device_ms, median of 5 windows of 20 launches) are the reading;
    torch.profiler's median per launch record over 10 launches (None where
    it records no kernel) is printed beside them, flagged where the two
    differ by more than 3%."""
    out = {}
    for variant, b in blocks.items():
        words, fn = _words(b), _wrapper(variant)
        kernel = _VARIANTS[variant][0].replace("_decode", "_kernel")
        events = 1e3 * statistics.median(
            tools.device_ms(lambda: fn(words)) for _ in range(5))
        prof = _profile_us(lambda: fn(words), kernel + "<", kernel + "(")
        out[variant] = (events, prof)
        out_words = fn(words[:1])[0].shape[1]
        moved = _N_BIG * (4 * words.shape[1] + 4 * out_words + 1)
        if prof is None:
            second = "not measured (no kernel in the profile)"
        else:
            off = prof / events - 1
            second = f"{prof:.2f} us ({off:+.1%}" + (
                ", off by more than 3%)" if abs(off) > 0.03 else ")")
        print(f"device: {variant} N={_N_BIG}: {events:.2f} us per launch by "
              f"CUDA events, {moved / events / 1e6:.3f} TB/s moved; "
              f"torch.profiler {second} on {smi}")
    return out


def _profile(fn, keys, calls: int) -> dict:
    """{kernel: [device us of each launch record]} of the CUDA kernels
    whose name contains one of `keys`, from torch.profiler's CUDA activity
    over `calls` calls of fn(); the window is run up to 3 times until it
    records one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if any(k in e.name for k in keys) \
                    and str(e.device_type).endswith("CUDA"):
                out.setdefault(e.name, []).append(e.device_time_total)
        if out:
            break
    return out


def _profile_us(fn, *keys: str, calls: int = 10):
    """Device time per call of fn() in the CUDA kernels whose name contains
    one of `keys` (None where the profiler records none).  The profiler
    may drop some of a window's launch records and misread a few (the
    "mode batches" phase prints what it kept), so a kernel's time per call
    is the median of its records times its launches per call, records /
    calls rounded."""
    us = sum(statistics.median(d) * max(1, round(len(d) / calls))
             for d in _profile(fn, keys, calls).values())
    return us or None


def _breakdown(label: str, tex: Texture, pf, decode, smi: str) -> None:
    """Where the time of one warm 4096^2 texture call goes, stage by stage
    (host clock, synchronised after each stage), with `decode` the format's
    wrapper; then the whole call, median of 5."""
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

    for _ in range(2):                               # the second is warm
        raw = tex.data.reshape(tex.n_blocks, tex.block_size)
        w = stage("words_from_bytes", lambda: torch.from_numpy(
            words_from_bytes(raw)))
        w = stage("host_to_device", lambda: w.cuda())
        pix, valid = stage("kernel", lambda: decode(w))
        conv = stage("convert", lambda: CD.convert_pixels_device(
            pix.view(CD.repr_dtype(src)).reshape(
                tex.n_blocks * 16, CD.repr_lanes(src)), src, dst)
            .reshape(tex.n_blocks, 16, -1))
        tiles = stage("zero_invalid", lambda: torch.where(
            valid[:, None, None], conv, 0))
        img = stage("assemble", lambda: engine._assemble(
            tiles, tex.width_in_blocks, tex.height_in_blocks, tex.width,
            tex.height))
        stage("device_to_host", lambda: CD.to_bytes(img))
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decompress_texture_linear(tex, pf, backend="device",
                                         device="cuda")
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    print(f"texture breakdown: {label} {tex.width}x{tex.height} -> "
          f"{F.format_name(dst)}, warm, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; whole call median of 5 {wall:.3f} ms "
          f"({tex.n_blocks / wall * 1e3:.4g} blocks/s) on {smi}")


def _texture_breakdown(blocks: dict, smi: str) -> None:
    """The breakdown (_breakdown) for a 64 B, a 16 B and a 128 B output per
    block in the native format, for BC1 to BGRA8 (an R/B swap) and for
    BPTC_FLOAT to RGBA8 (the viewer's format, three conversion steps)."""
    for variant, pf in (("bc1", None), ("bc1", F.BGRA8), ("rgtc1", None),
                        ("bptc_float", None), ("bptc_float", F.RGBA8)):
        tex = _texture_calls(variant, blocks[variant])[0][1]
        _breakdown(variant, tex, pf, _wrapper(variant), smi)


def _bptc_texture(smi: str) -> int:
    """A 4096^2 BPTC (BC7) texture of the tool's blocks (modes uniform over
    0-7) through engine.decompress_texture_linear(backend="device"): its
    key's first call, eager (one launch of the BC7 kernel), bytes equal
    to the same call with the plain version swapped in (no launch); then
    its stage breakdown.  Returns the launches of
    the call."""
    tex = Texture.new(F.BY_NAME["BPTC"].fmt, MP.tool_blocks(_N_BIG), _TEX,
                      _TEX)
    bptc.KERNEL_LAUNCHES = 0
    graphs._PROGRAMS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.decompress_texture_linear(tex, None, backend="device",
                                           device="cuda")
    wall = time.perf_counter() - t0
    launches = bptc.KERNEL_LAUNCHES
    if engine.LAST_BACKEND != "device" or launches != 1:
        raise AssertionError(f"BPTC texture call: backend "
                             f"{engine.LAST_BACKEND}, launches {launches}")
    if out.dtype != np.uint8 or out.shape != (_TEX * _TEX * 4,):
        raise AssertionError(f"BPTC texture call: bad output {out.dtype} "
                             f"{out.shape}")
    kernel_decode = bptc.decode_bptc
    bptc.decode_bptc = bptc.decode_bptc_plain
    try:
        with _eager_programs():
            plain = engine.decompress_texture_linear(tex, None,
                                                     backend="device",
                                                     device="cuda")
    finally:
        bptc.decode_bptc = kernel_decode
    if bptc.KERNEL_LAUNCHES != launches or not np.array_equal(out, plain):
        raise AssertionError("BPTC texture call: kernel and plain bytes "
                             "differ, or the plain run launched")
    print(f"main path (texture engine, BPTC): decompress_texture_linear("
          f"backend='device') on a {_TEX}x{_TEX} BPTC texture, "
          f"{launches} launch of bc7_kernel (the key's first call, "
          f"eager), byte-equal to the plain version; "
          f"{wall * 1e3:.3f} ms host bytes in to host bytes out (first "
          f"call) on {smi}")
    _breakdown("bptc", tex, None, bptc.decode_bptc, smi)
    return launches


# Mode of each value of a BC7 block's byte 0 (its lowest set bit; 0 has
# none and decodes as mode 0).
_BC7_MODE = np.array([0 if b == 0 else (b & -b).bit_length() - 1
                      for b in range(256)])
# Tiles, 128 threads x kRounds blocks: bc7.cu's 256; bc6h.cu's, etc_eac.cu's
# (etc_kernel, etc2_eac_kernel, eac_rg11_kernel) and bc.cu's (bc1_kernel,
# bc23_kernel) 128.
_BC7_TILE, _BC6H_TILE, _ETC_TILE, _BC_TILE = 256, 128, 128, 128


def _mode_batches(blocks: np.ndarray, key: np.ndarray, codes) -> dict:
    """The blocks (modes mixed), the same blocks sorted by their mode key,
    and one batch per (code, width) that keeps the blocks' bits but sets
    byte 0's low `width` bits to `code`."""
    batches = {"mixed": blocks,
               "sorted": blocks[np.argsort(key, kind="stable")]}
    for m, (code, width) in enumerate(codes):
        b = blocks.copy()
        b[:, 0] = (b[:, 0] & (0xFF ^ ((1 << width) - 1))) | code
        batches[f"mode{m}"] = b
    return batches


# The modes of each ETC variant's one-mode batches.
_ETC_MODES = {"etc1": (0, 1), "etc2": (0, 1, 2, 3, 4),
              "etc2_punchthrough": (1, 2, 3, 4), "etc2_eac": (0, 1, 2, 3, 4)}


def etc_mode_batches(variant: str, blocks: np.ndarray, rng) -> dict:
    """An ETC variant's blocks as the texture path draws them
    (etc_branch_blocks: forced eighths in contiguous row ranges, so most
    warps see one mode), their row-shuffled copy (modes mixed in every
    warp), that copy sorted by colour mode, and one batch per mode that
    keeps the blocks' other bits (ETC1, ETC2 and ETC2_EAC through the
    differential bit, the last two and punchthrough modes 1-4 through the
    colour bytes; punchthrough keeps its opacity bits, ETC2_EAC its alpha
    block)."""
    c = _etc_colour_byte(variant)
    mixed = blocks[rng.permutation(len(blocks))]
    batches = {"texture": blocks, "mixed": mixed,
               "sorted": mixed[np.argsort(etc_mode_key(variant, mixed),
                                          kind="stable")]}
    for m in _ETC_MODES[variant]:
        b = blocks.copy()
        if variant != "etc2_punchthrough":
            b[:, c + 3] = (b[:, c + 3] & 0xFD) | (2 if m else 0)
        if variant != "etc1" and m:
            _force_etc_mode(b, np.arange(len(b)), c, m, rng)
        if not (etc_mode_key(variant, b) == m).all():
            raise AssertionError(f"{variant} mode{m} batch has other modes")
        batches[f"mode{m}"] = b
    return batches


def _mode_batch_timing(smi: str, tex_blocks: dict, rounds: int = 11) -> dict:
    """Mode divergence and the tile kernels, measured: device time per call
    (tools.device_ms) of the BC7 kernel on 1,048,576 of the tool's blocks
    (modes uniform over 0-7), on the same blocks sorted by mode and on 8
    batches that keep those bits but force one mode; of the BC6H kernel (both
    signs) on 1,048,576 blocks drawn as the texture path draws them (mode
    codes uniform over the 14 modes and the 4 reserved codes), sorted, and
    forced to each of the 14 modes; of the ETC colour kernel (etc1, etc2,
    punchthrough) and the ETC2_EAC kernel on the texture path's blocks
    (`tex_blocks`), their row-shuffled copy, that sorted by colour mode
    and one batch per mode
    (etc_mode_batches); of the BC2/BC3 kernel on the texture path's
    blocks; and of the BC1/BC1A and EAC RG11 (both signs) kernels on the
    texture path's blocks and their row-shuffled copy (their forced
    eighths lie in contiguous rows; shuffled, every warp mixes them).
    Each round times every (kernel, batch) once in a fresh random
    order, so clock and power drift fall on all alike; the result is the
    median over the rounds.  Every batch's output is first held bit-exact
    to the plain version, and each kernel at the edge sizes of its tile.
    torch.profiler reads each kernel on its first batch before and after
    the rounds, with the launch records it kept: the two methods side by
    side, and whether the rounds move a later reading.  Each kernel's line
    ends with its share of its byte bound on its first batch.  Returns
    {(kernel, batch): ms}."""
    rng = np.random.default_rng(_SEED)
    bc7_blocks = MP.tool_blocks(_N_BIG)
    bc6h_blocks = bc6h_mode_blocks(_N_BIG, rng)
    # family -> (batches, the first the reference; tile; bytes per block)
    fams = {
        "bc7": (_mode_batches(bc7_blocks, _BC7_MODE[bc7_blocks[:, 0]],
                              [(1 << m, m + 1) for m in range(8)]),
                _BC7_TILE, 16 + 64 + 1),
        "bc6h": (_mode_batches(bc6h_blocks, _bc6h_code_key(bc6h_blocks),
                               _BC6H_CODES[:14]), _BC6H_TILE, 16 + 128 + 1),
        **{v: (etc_mode_batches(v, tex_blocks[v], rng), _ETC_TILE,
               _VARIANTS[v][4] + 64 + 1) for v in _ETC_MODES},
        **{v: ({"texture": tex_blocks[v]}, _BC_TILE, 16 + 64 + 1)
           for v in ("bc2", "bc3")},
        **{v: ({"texture": tex_blocks[v],
                "mixed": tex_blocks[v][rng.permutation(_N_BIG)]}, tile, nbytes)
           for v, tile, nbytes in (
               ("bc1", _BC_TILE, 8 + 64 + 1), ("bc1a", _BC_TILE, 8 + 64 + 1),
               ("eac_rg11", _ETC_TILE, 16 + 64 + 1),
               ("eac_signed_rg11", _ETC_TILE, 16 + 64 + 1))}}
    words = {(fam, k): _words(b) for fam, (bs, _, _) in fams.items()
             for k, b in bs.items()}
    fns = {"bc7_kernel": ("bc7", bptc.decode_bptc, bptc.decode_bptc_plain),
           "bc6h_kernel<0>": ("bc6h", bptc_float.decode_bptc_float,
                              bptc_float.decode_bptc_float_plain),
           "bc6h_kernel<1>": ("bc6h", bptc_float.decode_bptc_signed_float,
                              bptc_float.decode_bptc_signed_float_plain),
           **{_label((_VARIANTS[v][0].replace("_decode", "_kernel"),
                      _TEMPLATE_ARG[v])): (v, _wrapper(v), _plain(v))
              for v in ("etc1", "etc2", "etc2_punchthrough", "etc2_eac",
                        "bc2", "bc3", "bc1", "bc1a", "eac_rg11",
                        "eac_signed_rg11")}}
    first = {fam: next(iter(bs)) for fam, (bs, _, _) in fams.items()}
    for name, (fam, fn, plain) in fns.items():
        batches, tile, _ = fams[fam]
        for k in batches:
            _compare(words[(fam, k)], _FULL, 0, fn, plain, f"{name} {k}")
        edge = "mixed" if "mixed" in batches else first[fam]
        # BC1A's flags 0x2 and 0x4 keep only 3- or only 4-colour blocks;
        # ETC2_EAC's 0x1 rejects an alpha multiplier of 0.
        settings = ((_FULL, 0), (0x55, 2)) + (
            ((_FULL, 4),) if fam.startswith("bc1") else ()) + (
            ((_FULL, 1),) if fam == "etc2_eac" else ())
        for n in (1, tile - 1, tile, tile + 1, 256, 3 * tile + 5):
            for mm, fl in settings:
                _compare(words[(fam, edge)][:n].contiguous(), mm, fl, fn,
                         plain, f"{name} N={n}")
    torch.cuda.synchronize()
    print(f"bits: {', '.join(fns)} bit-exact (tolerance 0) vs their plain "
          f"versions on every batch and at N = 1, T - 1, T, T + 1, 256, "
          f"3T + 5 (T = {_BC7_TILE} for BC7, {_BC6H_TILE} for BC6H, "
          f"{_ETC_TILE} for ETC and EAC RG11, {_BC_TILE} for BC1/BC1A and "
          f"BC2/BC3) under (mode_mask, flags) (0x{_FULL:x}, 0) and (0x55, 2), "
          f"BC1/BC1A also (0x{_FULL:x}, 4), ETC2_EAC also (0x{_FULL:x}, 1)")

    def profiled():
        """{kernel: (launch records of 10 calls, their min, median and
        max us)}."""
        out = {}
        for name, (fam, fn, _) in fns.items():
            d = sum(_profile(lambda: fn(words[(fam, first[fam])]),
                             (name.split("<")[0],), 10).values(), [])
            out[name] = (len(d), min(d), statistics.median(d), max(d)) \
                if d else (0, math.nan, math.nan, math.nan)
        return out

    before = profiled()
    jobs = [(name, fam, fn, k) for name, (fam, fn, _) in fns.items()
            for k in fams[fam][0]]
    order = np.random.default_rng(_SEED)
    ms = {(name, k): [] for name, _, _, k in jobs}
    for _ in range(rounds):
        for i in order.permutation(len(jobs)):
            name, fam, fn, k = jobs[i]
            w = words[(fam, k)]
            ms[(name, k)].append(tools.device_ms(lambda: fn(w)))
    out = {key: statistics.median(v) for key, v in ms.items()}
    after = profiled()
    for name, (fam, _, _) in fns.items():
        ks = [k for n, k in out if n == name]
        single = [k for k in ks if k.startswith("mode")]
        line = ", ".join(f"{k} {out[(name, k)] * 1e3:.2f} (rounds "
                         f"{min(ms[(name, k)]) * 1e3:.2f}-"
                         f"{max(ms[(name, k)]) * 1e3:.2f})"
                         for k in ks if not k.startswith("mode"))
        if single:
            line += (", single modes " + ", ".join(
                f"{k[4:]} {out[(name, k)] * 1e3:.2f}" for k in single))
        bound_us = _N_BIG * fams[fam][2] / _HBM_BYTES_PER_S * 1e6
        share = bound_us / (out[(name, first[fam])] * 1e3)
        print(f"mode batches: {name} N={_N_BIG}, device us per call, median "
              f"of {rounds} shuffled rounds: {line}; {first[fam]} at "
              f"{share:.0%} of its {bound_us:.1f} us byte bound "
              f"({fams[fam][2]} B per block) on {smi}")
        print(f"mode batches: {name} N={_N_BIG} {first[fam]}, torch.profiler "
              f"over 10 calls, launch records and their min / median / max "
              f"us: "
              + "; ".join(f"{when} the rounds {r[0]}, {r[1]:.2f} / "
                          f"{r[2]:.2f} / {r[3]:.2f}"
                          for when, r in (("before", before[name]),
                                          ("after", after[name])))
              + f" on {smi}")
    return out


def _phase(name: str, fn, *args):
    """fn(*args), printing its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return out


# Template argument of each texture variant's kernel instantiation.
_TEMPLATE_ARG = {"bc1": 0, "bc1a": 1, "bc2": 0, "bc3": 1, "rgtc1": 0,
                 "signed_rgtc1": 1, "rgtc2": 0, "signed_rgtc2": 1, "etc1": 0,
                 "etc2": 1, "etc2_punchthrough": 2, "etc2_eac": None,
                 "eac_r11": 0, "eac_signed_r11": 1, "eac_rg11": 0,
                 "eac_signed_rg11": 1, "bptc_float": 0,
                 "bptc_signed_float": 1}


def _variant_bound(variant: str, n: int, sass: dict):
    """Bound of a texture variant's kernel on n blocks: its bytes (block,
    pixels, 1 B valid) and its SASS integer instructions per block."""
    kernel = _VARIANTS[variant][0].replace("_decode", "_kernel")
    words_out = _wrapper(variant)(torch.zeros(
        (1, _VARIANTS[variant][4] // 4), dtype=torch.int32,
        device="cuda"))[0].shape[1]
    nbytes = n * (_VARIANTS[variant][4] + 4 * words_out + 1)
    return _bound(nbytes, n, (kernel, _TEMPLATE_ARG[variant]), sass)


def _texture_phase(rng, smi: str, sass: dict):
    """Goldens, kernel vs plain at N = 1,048,576, the texture path, the
    CLI and the timings.  Returns the kernels' JSON entries and each
    variant's blocks."""
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
    device_us = _phase("texture device time", _device_us, blocks, smi)
    bounds = {v: _variant_bound(v, _N_BIG, sass) for v in _VARIANTS}
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
            "bound_ms": bounds[first][0], "bound_by": bounds[first][1],
            "library_ms": None,
            "variants": {v: {
                "launches": launches[v], "max_abs_err": errs[v],
                "ms": times[(v, _N_BIG)][0],
                "plain_ms": times[(v, _N_BIG)][1],
                "bound_ms": bounds[v][0], "bound_by": bounds[v][1],
                "device_us": device_us[v][0],
                "device_us_profiler": device_us[v][1],
                "ms_n4096": times[(v, 4096)][0],
                "plain_ms_n4096": times[(v, 4096)][1]} for v in variants}})
    return entries, blocks


# --- the tools: the BC7 pre-gathered probe, lane interleave, ALU mix ------

_TOOL_N = MP.N              # the tools' block count, 65,536
_TOOLS_SOURCE = "detex_tpu_torch/csrc/"


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _tool_kernels_vs_plain() -> dict:
    """Each tool kernel against its plain version at the tool's size (and
    bc7_pre against the production BC7 kernel); raises on any difference.
    Returns the inputs, for the timings."""
    words = _words(MP.tool_blocks(_TOOL_N))
    pre = MP.pregather(words)
    if not torch.equal(pre.cpu(), MP.pregather(words.cpu())):
        raise AssertionError("pregather on the card != on the CPU")
    err = {}
    for mm, fl in ((_FULL, 0), (_FULL, 2), (_FULL, 4), (0x0F, 0)):
        p_k, v_k = MP.decode_bc7_pre(words, pre, mm, fl)
        p_p, v_p = MP.decode_bc7_pre_plain(words, pre, mm, fl)
        p_b, v_b = bptc.decode_bptc(words, mm, fl)
        e = max(_max_err(p_k, p_p), _max_err(p_k, p_b))
        if e or not (torch.equal(v_k, v_p) and torch.equal(v_k, v_b)):
            raise AssertionError(f"bc7_pre differs (mask {mm:#x}, flags "
                                 f"{fl})")
        err["bc7_pre_decode"] = max(err.get("bc7_pre_decode", 0), e)
    x = torch.from_numpy(IP.tool_input(_TOOL_N)).cuda()
    for name, fn, plain in (
            ("interleave_planar", IP.planar_add1, IP.planar_add1_plain),
            ("interleave_rows", IP.rows_interleave,
             IP.rows_interleave_plain)):
        err[name] = _max_err(fn(x), plain(x))
        if err[name]:
            raise AssertionError(f"{name} kernel != plain version")
    if not np.array_equal(IP.rows_interleave(x).cpu().numpy(),
                          IP.numpy_rows(x.cpu().numpy())):
        raise AssertionError("rows_interleave != numpy")
    mix_x = torch.from_numpy(np.random.default_rng(7).integers(
        -2**31, 2**31, (_TOOL_N, 4), np.int64).astype(np.int32)).cuda()
    err["mix_probe"] = 0
    for family in PS.FAMILIES:
        e = _max_err(PS.mix_probe(mix_x, family),
                     PS.mix_probe_plain(mix_x, family))
        if e:
            raise AssertionError(f"mix_probe {family} != plain version")
    torch.cuda.synchronize()
    print(f"bits: bc7_pre_kernel bit-exact (tolerance 0) vs its plain "
          f"version and the production BC7 kernel on the tool's {_TOOL_N} "
          f"blocks x 4 mask/flags settings; planar_add1 and rows_interleave "
          f"vs plain and numpy on (16, 8, {_TOOL_N // 8}); mix_probe vs "
          f"plain for the {len(PS.FAMILIES)} families on {_TOOL_N} blocks")
    return {"err": err, "words": words, "pre": pre, "x": x, "mix_x": mix_x}


def _tool_timing(inp: dict, sass: dict, smi: str) -> dict:
    """Kernel, plain version and (interleave) library call per tool
    kernel at the tool's size, CUDA events, alternating (kernel, plain,
    plain, kernel); with each kernel's bound.  {name: entry fields}."""
    words, pre, x, mix_x = inp["words"], inp["pre"], inp["x"], inp["mix_x"]
    n, lanes = _TOOL_N, _TOOL_N // 8

    def pair(k_fn, p_fn, reps=21, inner=20):
        k1 = _time_ms(k_fn)
        p1 = _time_ms(p_fn, reps=reps, inner=inner)
        p2 = _time_ms(p_fn, reps=reps, inner=inner)
        k2 = _time_ms(k_fn)
        return min(k1, k2), min(p1, p2)

    out = {}
    ms, plain = pair(lambda: MP.decode_bc7_pre(words, pre),
                     lambda: MP.decode_bc7_pre_plain(words, pre), 7, 3)
    out["bc7_pre_decode"] = (ms, plain, None, _bound(
        n * (16 + 8 + 64 + 1), n, ("bc7_pre_kernel", None), sass))
    for name, fn, p_fn, lib, kernel in (
            ("interleave_planar", IP.planar_add1, IP.planar_add1_plain,
             IP.library_planar, "planar_add1_kernel"),
            ("interleave_rows", IP.rows_interleave, IP.rows_interleave_plain,
             IP.library_rows, "rows_interleave_kernel")):
        ms, plain = pair(lambda: fn(x), lambda: p_fn(x))
        lib_ms = _time_ms(lambda: lib(x))
        out[name] = (ms, plain, lib_ms, _bound(
            2 * 128 * lanes * 4, 32 * lanes, (kernel, None), sass))
    for family in PS.FAMILIES:
        ms, plain = pair(lambda: PS.mix_probe(mix_x, family),
                         lambda: PS.mix_probe_plain(mix_x, family), 3, 1)
        out[("mix_probe", family)] = (ms, plain, None, _bound(
            n * (16 + 4), n, ("mix_probe_kernel", family), sass))
    for key, (ms, plain, lib_ms, (bound, by)) in out.items():
        name = key if isinstance(key, str) else f"mix_probe {key[1]}"
        print(f"time: {name} N={n}: kernel {ms:.5f} ms, plain {plain:.5f} "
              f"ms" + ("" if lib_ms is None else f", library {lib_ms:.5f} ms")
              + f"; bound {bound:.5f} ms ({by}) on {smi}")
    return out


def _tool_device_us(smi: str, sass: dict) -> dict:
    """Device time per launch at N = 1,048,576 blocks of the production BC7
    kernel and bc7_pre_kernel on the tool's blocks, of the two interleave
    kernels and their library yardsticks, and of mix_probe_kernel per
    family, with each one's TB/s or Tops/s."""
    n = _N_BIG
    words = _words(MP.tool_blocks(n))
    pre = MP.pregather(words)
    x = torch.from_numpy(IP.tool_input(n)).cuda()
    mix_x = torch.from_numpy(np.random.default_rng(7).integers(
        -2**31, 2**31, (n, 4), np.int64).astype(np.int32)).cuda()
    out = {
        "bc7_decode": _profile_us(lambda: bptc.decode_bptc(words),
                                  "bc7_kernel("),
        "bc7_pre_decode": _profile_us(lambda: MP.decode_bc7_pre(words, pre),
                                      "bc7_pre_kernel("),
        "interleave_planar": _profile_us(lambda: IP.planar_add1(x),
                                         "planar_add1_kernel("),
        "interleave_rows": _profile_us(lambda: IP.rows_interleave(x),
                                       "rows_interleave_kernel("),
        # Every CUDA kernel the library calls launch.
        "library_planar": _profile_us(lambda: IP.library_planar(x), ""),
        "library_rows": _profile_us(lambda: IP.library_rows(x), ""),
    }
    for family in PS.FAMILIES:
        out[f"mix_probe {family}"] = _profile_us(
            lambda: PS.mix_probe(mix_x, family), f"MixSched{family}>(")
    for name, us in out.items():
        if us is None:
            print(f"device: {name} N={n}: not measured (no kernel in the "
                  "profile)")
            continue
        if name.startswith("mix_probe"):
            kid = ("mix_probe_kernel", name.split()[1])
            steps = len(PS._schedule(kid[1]))
            bound, by = _bound(n * (16 + 4), n, kid, sass)
            rate = (f"{n * steps / us / 1e6:.3f} Tops/s of the TPU census; "
                    f"bound {bound * 1e3:.2f} us ({by}: {sass[kid][0]} "
                    f"integer instructions a thread, {sass[kid][2]} "
                    f"conditional branches), {bound * 1e3 / us:.0%} of it")
        else:
            moved = n * (16 + 64 + 1 + (8 if name == "bc7_pre_decode" else 0)) \
                if name.startswith("bc7") else 2 * x.numel() * 4
            rate = f"{moved / us / 1e6:.3f} TB/s moved"
        print(f"device: {name} N={n}: {us:.2f} us per launch, {rate} on "
              f"{smi}")
    return out


def _tool_paths() -> dict:
    """Each tool's main() once on the card, its launch counts set to 0 just
    before and read just after; each must launch its kernels."""
    for counts in (MP.KERNEL_LAUNCHES, IP.KERNEL_LAUNCHES,
                   PS.KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0
    _phase("tool mxu_probe", MP.main, [])
    _phase("tool interleave_probe", IP.main, [])
    _phase("tool profile_sections", PS.main, list(PS.FAMILIES))
    launches = {**MP.KERNEL_LAUNCHES, **IP.KERNEL_LAUNCHES,
                **PS.KERNEL_LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a tool kernel was not launched: {launches}")
    print(f"main path (tools): launches {launches}")
    return launches


def _tools_phase(smi: str, sass: dict) -> list:
    """The tool kernels vs plain, their timings, then the three tools'
    paths.  Returns the kernels' JSON entries."""
    inp = _phase("tools kernel vs plain", _tool_kernels_vs_plain)
    times = _phase("tools timing", _tool_timing, inp, sass, smi)
    device_us = _phase("tools device time", _tool_device_us, smi, sass)
    launches = _tool_paths()
    err = inp["err"]
    entries = []
    for name, source, replaces in (
            ("bc7_pre_decode", "bc7_pre.cu", "tools/mxu_probe.py:107"),
            ("interleave_planar", "interleave.cu",
             "tools/interleave_probe.py:58"),
            ("interleave_rows", "interleave.cu",
             "tools/interleave_probe.py:79, :86")):
        ms, plain, lib_ms, (bound, by) = times[name]
        entries.append({"name": name, "route": "cuda",
                        "source": _TOOLS_SOURCE + source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain, "bound_ms": bound,
                        "bound_by": by, "library_ms": lib_ms,
                        "device_us_n1048576": device_us[name]})
    fam = {f: times[("mix_probe", f)] for f in PS.FAMILIES}
    entries.append({
        "name": "mix_probe", "route": "cuda",
        "source": _TOOLS_SOURCE + "mix_probe.cu",
        "replaces": "tools/profile_sections.py:186",
        "launches": launches["mix_probe"], "max_abs_err": err["mix_probe"],
        "ms": fam["BC7"][0], "plain_ms": fam["BC7"][1],
        "bound_ms": fam["BC7"][3][0], "bound_by": fam["BC7"][3][1],
        "library_ms": None,
        "families": {f: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[3][0],
                         "bound_by": t[3][1],
                         "device_us_n1048576": device_us[f"mix_probe {f}"]}
                     for f, t in fam.items()}})
    return entries


# --- the last modules: dtx-validate, dtx-view, the mass fuzz, the benches ---

_FUZZ_N = 65536            # dtx-validate --fuzz: blocks per family
_MASS_FUZZ_N = 262144      # tools.mass_fuzz --blocks: blocks per family


def _all_counts() -> dict:
    """The launch counts of all 19 decode variants, BC7 ("bptc") among
    them."""
    return dict(_counts(), bptc=bptc.KERNEL_LAUNCHES)


def _reset_all_counts() -> None:
    _reset_counts()
    bptc.KERNEL_LAUNCHES = 0


def _launched_every_variant(what: str) -> dict:
    counts = _all_counts()
    if not all(counts.values()):
        raise AssertionError(f"{what}: a decode kernel was not launched: "
                             f"{counts}")
    return counts


def _validate_path() -> dict:
    """dtx-validate on the card over a corpus written from the goldens'
    corpus_blocks (validate.c's 17 compressed files) with --fuzz, then
    dtx-view on the BPTC and BPTC_FLOAT files, whose PNGs must equal the
    CPU's.  Returns the launch counts of the validate run."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        names = cli_validate.write_golden_corpus(d)
        _reset_all_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_validate.main(["--corpus", str(d), "--fuzz",
                                    str(_FUZZ_N), "-o", str(d / "s.png")])
        launches = _launched_every_variant("validate")
        lines = out.getvalue().splitlines()
        print("\n".join(f"validate: {x}" for x in lines))
        if rc != 0:
            raise AssertionError(f"dtx-validate returned {rc}")
        for name in names:
            if not any(name in x and x.endswith("BIT-EXACT")
                       for x in lines):
                raise AssertionError(f"dtx-validate: {name} not BIT-EXACT")
        fuzz = [x for x in lines if x.strip().startswith("fuzz ")
                and x.endswith(f"{_FUZZ_N:,d} blocks BIT-EXACT")]
        if len(fuzz) != len(cli_validate.FUZZ_FAMILIES):
            raise AssertionError(f"dtx-validate: {len(fuzz)} fuzz families "
                                 "BIT-EXACT, not 19")
        for family in ("BPTC", "BPTC_FLOAT"):
            pngs = []
            for extra in ([], ["--device", "cpu"]):
                png = d / f"view{len(pngs)}.png"
                argv = [str(d / f"test-texture-{family}.ktx"), "-o",
                        str(png), "-z", "2", *extra]
                with contextlib.redirect_stdout(io.StringIO()):
                    if cli_view.main(argv) != 0:
                        raise AssertionError("dtx-view returned non-zero")
                pngs.append(png.read_bytes())
            if pngs[0] != pngs[1]:
                raise AssertionError(f"dtx-view {family}: the card's PNG "
                                     "differs from the CPU's")
    print(f"validate: exit 0, {len(names)} corpus files BIT-EXACT against "
          f"the goldens, {len(fuzz)} families x {_FUZZ_N} fuzz blocks "
          f"BIT-EXACT against native; dtx-view PNGs of BPTC and BPTC_FLOAT "
          f"equal to the CPU's; launches {launches}")
    return launches


def _mass_fuzz_path(smi: str) -> dict:
    """tools.mass_fuzz on the card at _MASS_FUZZ_N blocks per family, all
    19 families; returns the launch counts."""
    _reset_all_counts()
    t0 = time.perf_counter()
    rc = mass_fuzz.main(["--blocks", str(_MASS_FUZZ_N)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"mass_fuzz returned {rc}")
    launches = _launched_every_variant("mass fuzz")
    n = _MASS_FUZZ_N * len(mass_fuzz.FAMILIES)
    print(f"mass fuzz: {n} blocks ({len(mass_fuzz.FAMILIES)} families x "
          f"{_MASS_FUZZ_N}) bit-exact against native in {wall:.2f} s, "
          f"{n / wall:.4g} blocks/s (decode on the card, oracle on the "
          f"host's threads, both included) on {smi}; launches {launches}")
    return launches


def _bench_rows(name: str, rows: list) -> None:
    for row in rows:
        print(f"{name}: {json.dumps(row)}")


def _bench_control_path(smi: str) -> int:
    """tools.bench_control_step --ilqr 0 2 --wallclock at ControllerConfig()'s
    width, graph and eager rows; each row's first action is held (inside
    the bench) to a fresh graphed Controller's on the same seed and
    observation (atol 1e-6, the eager parallel-LQT row too).  Returns the
    BC7 launches."""
    bptc.KERNEL_LAUNCHES = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rows = BCS.main(["--ilqr", "0", "2", "--wallclock"])
    launches = bptc.KERNEL_LAUNCHES
    _bench_rows("bench control step", rows)
    steps = [r for r in rows if r["metric"] == "control_step_ms"]
    if [(r["ilqr_iterations"], r["backward"], r["program"]) for r in steps] \
            != [(n, b, p) for n, b in ((0, "n/a"), (2, "seq"),
                                       (2, "parallel-lqt"))
                for p in ("graph", "eager")]:
        raise AssertionError("bench control step: rows missing")
    for r in steps:
        if r["bc7_launches_per_step"] != 1.0 or \
                not r["first_action_max_diff"] <= r["first_action_atol"]:
            raise AssertionError(f"bench control step: {r}")
    print("bench control step: "
          + "; ".join(f"iLQR {r['ilqr_iterations']} {r['backward']} "
                      f"{r['program']}: median "
                      f"{r['ms_per_step']:.3f} ms (p10 {r['p10_ms']:.3f}, "
                      f"p90 {r['p90_ms']:.3f}; host {r['host_ms_per_step']:.3f})"
                      f" over {r['steps']} steps after {r['warmup']}"
                      for r in steps)
          + "; wallclock " + ", ".join(
              f"{'pipelined' if r['pipelined'] else 'sync'} "
              f"{r['program']} {r['ms_per_step']:.3f} ms" for r in rows
              if r["metric"] == "control_step_wallclock_ms")
          + f"; first actions within atol {BCS.ATOL} of a graphed "
          f"Controller's (max diffs "
          f"{[r['first_action_max_diff'] for r in steps]}); BC7 "
          f"launches {launches} on {smi}")
    return launches


def _bench_train_path(smi: str) -> int:
    """tools.bench_train_step at batch 64 of 64x64 BC7 observations, a
    "graph" and an "eager" row; each row's first compressed loss is held
    (inside the bench) to dynamics.train_step called directly, rtol 1e-5.
    Returns the BC7 launches."""
    bptc.KERNEL_LAUNCHES = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rows = BTS.main([])
    launches = bptc.KERNEL_LAUNCHES
    _bench_rows("bench train step", rows)
    if [r["program"] for r in rows] != ["graph", "eager"] or \
            any(r["bc7_launches_per_step"] != 2.0 for r in rows):
        raise AssertionError(f"bench train step: {rows}")
    print("bench train step: " + "; ".join(
        f"{r['program']}: compressed {r['ms_per_step_compressed']:.3f} ms, "
        f"raw obs {r['ms_per_step_raw_obs']:.3f}, decode only "
        f"{r['decode_only_ms']:.3f} (decode share "
        f"{r['decode_share_pct']:.1f}%); host enqueue "
        f"{r['host_enqueue_ms_compressed']:.3f} / "
        f"{r['host_enqueue_ms_raw_obs']:.3f} / "
        f"{r['host_enqueue_ms_decode_only']:.3f} ms; first loss "
        f"{r['first_loss']:.9g} against train_step's "
        f"{r['first_loss_train_step']:.9g}" for r in rows)
        + f"; BC7 launches {launches} on {smi}")
    return launches


def _bench_pipelines_path(smi: str) -> dict:
    """tools.bench_pipelines etc bc6h: config 2's image, in a "graph" and
    an "eager" row, byte-equal (inside the bench) to the native decode;
    config 4 in a "graph" row (its three bodies captured, one replay and
    one BC6H launch a step) and an "eager" row, images and latents equal
    to the plain BC6H version's, the graph's first images bit-equal to the
    eager step's and its latents within LATENT_RTOL of them.  Returns the
    launch counts."""
    _reset_all_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = BPL.main([])
    launches = _all_counts()
    _bench_rows("bench pipelines", rows)
    etc_rows, bc6h_rows = rows[:2], rows[2:]
    if [r["program"] for r in etc_rows] != ["graph", "eager"] or \
            [r["program"] for r in bc6h_rows] != ["graph", "eager"] or \
            any(r["etc2_eac_launches_per_step"] != 1.0 for r in etc_rows) \
            or any(r["bc6h_launches_per_step"] != 1.0 for r in bc6h_rows):
        raise AssertionError("bench pipelines: a step did not launch its "
                             "kernel once")
    print("bench pipelines: ETC2_EAC 1024^2 -> RGBA8 " + ", ".join(
        f"{r['program']} {r['ms_per_1024sq_texture']:.4f} ms "
        f"({r['value']:.4g} blocks/s, host {r['host_ms_per_step']:.4f})"
        for r in etc_rows) + ", byte-equal to native; BC6H -> latent batch "
          "64 " + "; ".join(
              f"{r['program']} {r['ms_per_batch64']:.4f} ms (p10 "
              f"{r['p10_ms']:.4f}, p90 {r['p90_ms']:.4f}; host "
              f"{r['host_ms_per_step']:.4f}), decode + unpack "
              f"{r['decode_unpack_standalone_ms']:.4f}, kernel "
              f"{r['decode_kernel_only_ms']:.4f}, BC6H launches "
              f"{r['bc6h_launches_per_step']} a step" for r in bc6h_rows)
          + f"; graph capture {bc6h_rows[0]['capture_s']:.3f} s; latents "
          f"equal to the plain version's (max diff "
          f"{bc6h_rows[1]['latent_max_diff_vs_plain']:.3g}); the graph's "
          f"first images bit-equal to the eager step's, latents max diff "
          f"{bc6h_rows[0]['latent_max_diff_vs_eager']:.3g} (rtol "
          f"{BPL.LATENT_RTOL} of the largest) on {smi}")
    return launches


def _bench_decode_path(smi: str) -> dict:
    """tools.bench_decode on the card as a user runs it: the headline at
    bench.py's 65,536 blocks with the 19 families at 65,536, then the
    headline alone at 1,048,576; every line is witnessed inside the tool
    (native and the plain version on the card; a miscompare raises).
    Returns the launch counts."""
    _reset_all_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = BD.main(["--n-blocks", str(BD.N_BLOCKS)])
        rows += BD.main(["--n-blocks", str(_N_BIG), "--no-families"])
    launches = _launched_every_variant("bench decode")
    _bench_rows("bench decode", rows)
    heads = [r for r in rows if "metric" in r]
    families = [r["families"] for r in rows if "families" in r]
    if [h["n_blocks"] for h in heads] != [BD.N_BLOCKS, _N_BIG] or \
            len(families) != 1 or list(families[0]) != list(BD.FAMILIES):
        raise AssertionError("bench decode: lines missing")
    measured = [(f"BC7 headline N={h['n_blocks']}", h["value"], h)
                for h in heads] + [
        (f"{name} N={n}", row["blocks_per_s"], row)
        for name, by_n in families[0].items() for n, row in by_n.items()]
    for label, rate, row in measured:
        if row["correctness"] != "ok":
            raise AssertionError(f"bench decode: {label} {row}")
        n = row["n_blocks"]
        us = row["device_us"]
        print(f"bench decode: {label}: {rate:.6g} blocks/s (graph of "
              f"{row['launches_per_replay']} launches on {row['copies']} "
              f"copies, spread {row['spread_pct']}%), device {us:.3f} us a "
              f"launch ({n / us * 1e6:.6g} blocks/s), L2-resident "
              f"{row['l2_resident']}, correctness {row['correctness']} on "
              f"{smi}")
    print(f"bench decode: vs native 1 thread "
          f"({heads[0]['baseline_blocks_per_s']:.6g} blocks/s): "
          + ", ".join(f"N={h['n_blocks']} {h['vs_baseline']}" for h in heads)
          + f"; launches {launches}")
    return launches


def _last_modules_phase(smi: str) -> tuple:
    """The phases of the last modules.  Returns BC7's launches by path and
    the other variants' launches by path."""
    by_path = {
        "validate": _phase("validate", _validate_path),
        "mass fuzz": _phase("mass fuzz", _mass_fuzz_path, smi),
        "bench pipelines": _phase("bench pipelines", _bench_pipelines_path,
                                  smi)}
    bc7 = {path: c.pop("bptc") for path, c in by_path.items()}
    bc7["bench control step"] = _phase("bench control step",
                                       _bench_control_path, smi)
    bc7["bench train step"] = _phase("bench train step", _bench_train_path,
                                     smi)
    return bc7, by_path


def main() -> None:
    t0 = time.perf_counter()
    smi = _device()
    _phase("build", _build_kernels)
    sass = _phase("sass", _sass_census)
    rng = np.random.default_rng(_SEED)
    timing = _phase("bc7 kernel", _kernel_phase, rng)
    launches, mppi_median = _phase("control step", _main_path, rng, smi)
    bc7_paths = {"control step": launches}
    bc7_paths["ilqr control step"] = _phase(
        "ilqr control step", _ilqr_path, rng, smi, mppi_median)
    bc7_paths["pipelined controller"] = _phase(
        "pipelined controller", _pipelined_path, rng, smi)
    bc7_paths["graphed control step"] = _phase(
        "graphed control step", _graphed_path, smi)
    bc7_paths["train"], bc7_paths["trained ilqr steps"] = _phase(
        "train", _train_path, rng, smi)
    bc7_paths["graphed train step"] = _phase(
        "graphed train step", _graphed_train_path, smi)
    bc7_paths["cli train"] = _phase("cli train", _cli_train_path)
    md_bc7, md_decode = _multi_device_phase(rng, smi)
    bc7_paths.update(md_bc7)
    texture_kernels, tex_blocks = _texture_phase(rng, smi, sass)
    graphed = _phase("graphed texture pipelines", _graphed_texture_path,
                     tex_blocks, smi)
    bc7_paths["graphed texture pipelines"] = graphed.pop("bptc")
    _phase("conversion sweep", _conversion_sweep, smi)
    for k in texture_kernels:
        k["launches_by_path"] = {
            "texture path": k["launches"],
            "sharded decode (1 rank)": sum(md_decode[v] for v in k["variants"]),
            "graphed texture pipelines": sum(graphed[v]
                                             for v in k["variants"])}
    tool_kernels = _tools_phase(smi, sass)
    _phase("bptc texture", _bptc_texture, smi)
    # Last: its rounds of back-to-back launches are not to move the device
    # times read before it.
    _phase("mode batches", _mode_batch_timing, smi, tex_blocks)
    bench_decode = _phase("bench decode", _bench_decode_path, smi)
    bc7_paths["bench decode"] = bench_decode.pop("bptc")
    last_bc7, last_paths = _last_modules_phase(smi)
    last_paths["bench decode"] = bench_decode
    bc7_paths.update(last_bc7)
    for k in texture_kernels:
        k["launches_by_path"].update({
            path: sum(counts[v] for v in k["variants"])
            for path, counts in last_paths.items()})
    print(f"phase all: {time.perf_counter() - t0:.2f} s")
    bound, by = _bound(256 * (16 + 64 + 1), 256, ("bc7_kernel", None), sass)
    bound_train, _ = _bound(_TRAIN_BLOCKS * (16 + 64 + 1), _TRAIN_BLOCKS,
                            ("bc7_kernel", None), sass)
    print(json.dumps({"kernels": [{
        "name": "bc7_decode", "route": "cuda",
        "source": "detex_tpu_torch/csrc/bc7.cu",
        "replaces": "detex_tpu/ops/pallas/bptc_pallas.py:240",
        "launches": bc7_paths["control step"],
        "launches_by_path": bc7_paths,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        f"ms_n{_TRAIN_BLOCKS}": timing["ms_train"],
        f"plain_ms_n{_TRAIN_BLOCKS}": timing["plain_ms_train"],
        f"bound_ms_n{_TRAIN_BLOCKS}": bound_train,
        "ms_n65536": timing["ms_65536"],
        "plain_ms_n65536": timing["plain_ms_65536"]},
        *texture_kernels, *tool_kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

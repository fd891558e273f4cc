"""BC7 with pre-gathered partition words on an NVIDIA card: the counterpart
of tools/mxu_probe.py.

    python -m detex_tpu_torch.tools.mxu_probe [--rounds 3] [--device cpu]

On the TPU the tool asked whether the idle matrix unit could take the BC7
kernel's partition and anchor select trees: a one-hot matrix product
gathers each block's subset word and anchor positions ahead of the
kernel (`pregather`), and a kernel variant reads them as an extra input.
Here `pregather` is the same product (torch.matmul of the (N, 192) one-hot
by the (192, 6) byte table, exact in float32: one nonzero term of bytes
<= 255), and `decode_bc7_pre` launches bc7_pre_kernel (csrc/bc7_pre.cu,
which replaces tools/mxu_probe.py:_bc7_kernel_pre, L107).

main() draws the tool's blocks (seed 42, N = 65,536, a forced mode bit
0-7), checks the pre-gathered decode (pregather included) bit-exact
against the production BC7 decode, then prints one JSON line per round:
the production kernel's time, the pre-gathered kernel's with and without
the pregather, and the rate ratios.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from detex_tpu_torch import tools
from detex_tpu_torch.ops import _cuda, bptc
from detex_tpu_torch.ops.bitops import shr

N = 1 << 16
_FULL = 0xFFFFFFFF

# Launches of bc7_pre_kernel in this process (plain-version calls are not
# counted).
KERNEL_LAUNCHES = {"bc7_pre_decode": 0}


@functools.cache
def _np_table() -> np.ndarray:
    """(192, 6) uint8, row q = (ns - 1) * 64 + psid: the 4 bytes of the
    subset word (2 bits per pixel; 0 for one subset) and the 2 bytes of
    the anchors a0 | a1 << 4 | a2 << 8 (the second of two subsets, the
    second and third of three; by psid alone, repeated for each ns), as
    tools/mxu_probe.py:59-70 builds it."""
    t = bptc._np_tables()
    shifts = 2 * np.arange(16, dtype=np.uint64)
    sub32 = (t["subset"].astype(np.uint64) << shifts).sum(axis=2)  # (3, 64)
    anch = t["anchors"].astype(np.uint32)
    pos = anch[:, 0] | (anch[:, 1] << 4) | (anch[:, 2] << 8)
    table = np.zeros((192, 6), np.uint8)
    for i in range(4):
        table[:, i] = (sub32.reshape(192) >> np.uint64(8 * i)) & 0xFF
    table[:, 4] = np.tile(pos & 0xFF, 3)
    table[:, 5] = np.tile(pos >> 8, 3)
    return table


@functools.cache
def _table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_np_table(), dtype=torch.float32, device=device)


def _mode_of(w0: torch.Tensor) -> torch.Tensor:
    """Lowest set bit of byte 0; 0 where byte 0 is 0 (the kernel decodes
    such blocks as mode 0)."""
    b0 = w0 & 0xFF
    mode = torch.zeros_like(b0)
    for i in range(7, -1, -1):
        mode = torch.where(b0 & (1 << i) != 0, i, mode)
    return mode


def pregather(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 words -> (N, 2) int32 [sub32, pos] by a one-hot matrix
    product (tools/mxu_probe.py:84-99)."""
    w0 = words[:, 0]
    mode = _mode_of(w0).long()
    t = bptc._tables(words.device)
    ns, pb = t["ns"][mode], t["pb"][mode]
    psid = shr(w0, mode + 1) & ((1 << pb) - 1)
    q = (ns - 1) * 64 + psid
    onehot = (q[:, None] == torch.arange(192, dtype=torch.int32,
                                         device=words.device)[None, :])
    by = torch.matmul(onehot.float(), _table(words.device)).int()
    sub32 = by[:, 0] | (by[:, 1] << 8) | (by[:, 2] << 16) | (by[:, 3] << 24)
    pos = by[:, 4] | (by[:, 5] << 8)
    return torch.stack([sub32, pos], dim=1)


def decode_bc7_pre_plain(words: torch.Tensor, pre: torch.Tensor,
                         mode_mask: int = _FULL, flags: int = 0):
    """Plain PyTorch version of decode_bc7_pre on any device."""
    return bptc.decode_bptc_plain(words, mode_mask, flags, pre=pre)


def decode_bc7_pre(words: torch.Tensor, pre: torch.Tensor,
                   mode_mask: int = _FULL, flags: int = 0):
    """BC7 decode with the partition words `pre` ((N, 2) int32, from
    `pregather`) in place of the partition tables: (N, 4) int32 words ->
    ((N, 16) int32 packed RGBA8, (N,) bool valid), as bptc.decode_bptc.
    A CUDA tensor launches bc7_pre_kernel, a CPU tensor runs
    decode_bc7_pre_plain."""
    if words.device.type == "cpu":
        return decode_bc7_pre_plain(words, pre, mode_mask, flags)
    if words.device.type != "cuda":
        raise ValueError(f"no BC7_PRE decoder for device {words.device}")
    _cuda.check_rows("BC7_PRE", "pre", pre, 2)
    if pre.shape[0] != words.shape[0] or pre.device != words.device:
        raise ValueError("BC7_PRE pre must have one row per block, on the "
                         "words' device")
    out = _cuda.launch("BC7_PRE", "dtx_bc7_pre_decode", words, 4, 16,
                       mode_mask, flags, pre=pre)
    if words.shape[0]:
        KERNEL_LAUNCHES["bc7_pre_decode"] += 1
    return out


def decode_mxu(words: torch.Tensor, mode_mask: int = _FULL, flags: int = 0):
    """pregather, then decode_bc7_pre (tools/mxu_probe.py:decode_mxu)."""
    return decode_bc7_pre(words, pregather(words), mode_mask, flags)


def tool_blocks(n: int = N, seed: int = 42) -> np.ndarray:
    """The tool's blocks (tools/mxu_probe.py:352-356): random bytes with
    byte 0's lowest set bit forced to a random mode 0-7."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 16), np.uint8)
    modes = rng.integers(0, 8, n)
    blocks[:, 0] = ((1 << modes)
                    | (blocks[:, 0] & (0xFF << (modes + 1)))).astype(np.uint8)
    return blocks


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=N, help="blocks")
    tools.device_arg(ap)
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    words = torch.from_numpy(tool_blocks(args.n).view(np.int32).copy()) \
        .to(device)

    pix_a, val_a = bptc.decode_bptc(words)
    pix_b, val_b = decode_mxu(words)
    if not (torch.equal(val_a, val_b) and torch.equal(pix_a, pix_b)):
        raise AssertionError("pre-gathered BC7 differs from the production "
                             "decode")
    print("bit-exact: ok", flush=True)

    pre = pregather(words)
    rows = []
    for r in range(args.rounds):
        prod = tools.time_ms(lambda: bptc.decode_bptc(words), device)
        full = tools.time_ms(lambda: decode_mxu(words), device)
        kern = tools.time_ms(lambda: decode_bc7_pre(words, pre), device)
        row = {"round": r, "n": args.n, "device": tools.device_name(device),
               "production_ms": prod, "pre_ms": full, "pre_kernel_ms": kern,
               "ratio": prod / full, "ratio_kernel_only": prod / kern}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

"""Mass randomized bit-exactness sweep of every decode family, the card's
kernels against the independent C++ oracle: the counterpart of
tools/mass_fuzz.py.

    python -m detex_tpu_torch.tools.mass_fuzz [--blocks 1048576]
        [--chunk 262144] [--device cpu] [FAMILY ...]

Default scale 1,048,576 blocks per family (19 families, about 20M
blocks).  Random blocks from cli.validate.fuzz_blocks (a valid mode prefix
where a random one would mostly be invalid: the BC7 mode byte; BC6H mode
codes uniform over the 14 modes and the 4 reserved codes) go through
engine.decode_blocks on --device (the CUDA kernels on a card) and through
the threaded native oracle (detex_tpu_torch.native); validity masks are
compared everywhere and pixel bytes on valid blocks (an invalid block's
pixels are unspecified; callers zero them in the target format,
texture.c:90-93).

Prints one line per family and a summary; exits 1 on any miscompare.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from detex_tpu_torch import tools
from detex_tpu_torch.cli import validate

FAMILIES = validate.FUZZ_FAMILIES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--blocks", type=int, default=1 << 20)
    ap.add_argument("--chunk", type=int, default=1 << 18)
    tools.device_arg(ap)
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)

    rng = np.random.default_rng(validate.FUZZ_SEED)
    total = 0
    bad = []
    t_all = time.perf_counter()
    for name in args.families:
        n_done = 0
        t0 = time.perf_counter()
        while n_done < args.blocks:
            n = min(args.chunk, args.blocks - n_done)
            blocks = validate.fuzz_blocks(name, n, rng)
            n_valid, n_pixels, wv = validate.fuzz_compare(name, blocks,
                                                          device)
            if n_valid:
                bad.append((name, "valid-mask", n_valid))
                break
            if n_pixels:
                bad.append((name, "pixels", n_pixels))
                break
            n_done += n
        total += n_done
        failed = bool(bad) and bad[-1][0] == name
        print(f"  {name:20s} {n_done:>9,d} blocks "
              f"({int(np.sum(~wv)):,d} invalid in last chunk) "
              f"{'MISCOMPARE' if failed else 'BIT-EXACT'} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        if failed:
            break
    dt = time.perf_counter() - t_all
    if bad:
        print(f"FAILED: {bad}")
        return 1
    print(f"ALL BIT-EXACT: {total:,d} random blocks across "
          f"{len(args.families)} families in {dt:.0f}s "
          f"({total / dt:.4g} blocks/s; device={tools.card(device)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from: the numbers that decide
`correct`, on many seeds, at the cell's own size, in one process (one
spawn of ranks for a cell on several cards), so that set-up is paid once.

    python3 -m dtxbench.tests.readings --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--variant control] \\
        [--prepare dtxbench.tests.faults:<fault>]

Prints one JSON line a seed: every number the cell's driver computes (for
the control cells also those its workload file gives no limit), with the
median effective sample size of MPPI's weights where the cell has one.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from dtxbench import common, run


def _serve_all(rank: int, args_list: list) -> list:
    from dtxbench.drivers import control
    return [control.serve(rank, args) for args in args_list]


def control_readings(contexts: list) -> list:
    """Each context's numbers and median ESS (control driver)."""
    import numpy as np
    from dtxbench.drivers import control
    ctx0 = contexts[0]
    ranks = ctx0.traffic.get("ranks", 1)
    args = [c.to_args() for c in contexts]
    if ranks == 1:
        served = _serve_all(0, args)
    else:
        from detex_tpu_torch.parallel import launch
        served = launch.run_ranks(
            _serve_all, ranks, (args,), device=ctx0.device.type,
            backend="nccl" if ctx0.device.type == "cuda" else "gloo",
            timeout=len(args) * (ctx0.seconds + 120.0))[0]
    device = (torch.device("cuda", 0) if ctx0.device.type == "cuda"
              else ctx0.device)
    common.set_precision(device)
    out = []
    for ctx, lead in zip(contexts, served, strict=True):
        out.append({
            "numbers": control.numbers(ctx, device, lead["start"],
                                       lead["records"]),
            "ess_median": float(np.median([r["ess"]
                                           for r in lead["records"]])),
            "steps": lead["steps"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variant", choices=("program", "control"),
                    default="program")
    ap.add_argument("--prepare", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cell, config = run.cell_files(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    head = {"workload": args.workload, "variant": args.variant,
            "prepare": args.prepare}
    if cell["driver"] == "control":
        contexts = [common.Context(cell=cell, config=config, seed=s,
                                   seconds=args.seconds, trace=False,
                                   device=device, wall0=time.time(),
                                   variant=args.variant,
                                   prepare=args.prepare) for s in seeds]
        for s, r in zip(seeds, control_readings(contexts), strict=True):
            print(json.dumps(dict(head, seed=s, **r)), flush=True)
    else:
        for s in seeds:
            r = run.measure(args.workload, s, args.seconds, False, device,
                            args.variant, args.prepare)
            print(json.dumps(dict(head, seed=s, numbers={
                k: c["value"] for k, c in r["checks"].items()},
                correct=r["correct"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

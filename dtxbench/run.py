"""The benchmark of detex_tpu_torch, the PyTorch/CUDA port, on NVIDIA cards.

    python3 -m dtxbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run is one process (and, for a cell on several cards, one spawned
process a card): make the inputs from the seed, warm up the cell's shapes,
measure for --seconds, judge what the timed path produced against the
plain reference, and print one JSON line as the last line of standard
output:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "checks"}

With --trace 0 the metrics are the cell's end-to-end metrics (BENCHMARK.json
"end_to_end"), with --trace 1 its per-layer metrics ("per_layer"), each
read by dtxbench/metrics/<name up to its first dot>.py from the traced part
of the window.
Every number that decides `correct` is printed beside its limit, in the
line's "checks" and as the last lines of standard error.

Everything belonging to one cell is found by name: workloads/<cell>.json
(its configuration, driver, cards, traffic parameters and limits),
configs/<config>.json and drivers/<driver>.py.  A run with no card, fewer
cards than the cell asks for, or with jax or the JAX package (detex_tpu)
loaded when the window has closed exits non-zero and prints no result.

--variant control puts the reference, one precision lower, in the
program's place in what is judged: the check that the comparison can fail.
--prepare plants a fault of tests/faults.py under the timed path.
"""

import time

WALL0 = time.time()     # setup_s counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from dtxbench import common  # noqa: E402


def benchmark_file() -> dict:
    return common.load_json(common.ROOT.parent / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_files(workload: str):
    """(the cell's workload file, its configuration file), by name."""
    cell = common.load_json(common.ROOT / "workloads" / f"{workload}.json")
    config = common.load_json(common.ROOT / "configs"
                              / f"{cell['config']}.json")
    return cell, config


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out[0].strip() if out else "nvidia-smi gave nothing"


def measure(workload: str, seed: int, seconds: float, trace: bool,
            device: torch.device, variant: str = "program",
            prepare=None, config_override=None, cell_override=None) -> dict:
    """One run of the cell on `device`, returned as the result line's dict
    (without printing).  The overrides replace entries of the
    configuration and the cell's parameters: the CPU tests' small sizes."""
    cell, config = cell_files(workload)
    if config_override:
        config = dict(config, **config_override)
    if cell_override:
        cell = dict(cell, params=dict(cell["params"], **cell_override))
    ctx = common.Context(cell=cell, config=config,
                         seed=seed, seconds=seconds, trace=trace,
                         device=device, wall0=WALL0, variant=variant,
                         prepare=prepare)
    driver = importlib.import_module(f"dtxbench.drivers.{cell['driver']}")
    outcome = driver.run(ctx)
    bench = benchmark_file()
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if _applies(m, workload):
                metrics[m["name"]] = {"value": outcome.metrics[m["name"]],
                                      "unit": m["unit"]}
    else:
        summary = outcome.trace
        for m in bench["per_layer"]:
            if not _applies(m, workload):
                continue
            reader = importlib.import_module(
                f"dtxbench.metrics.{m['name'].split('.')[0]}")
            value = reader.read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else "cpu"),
           "count": outcome.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": all(c.ok for c in outcome.checks),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": dev}
    if trace and outcome.trace and outcome.trace.get("window_s"):
        dev["busy_s"] = outcome.trace["busy_s"]
        dev["window_s"] = outcome.trace["window_s"]
        result["breakdown"] = {"device_ops": outcome.trace["device_ops"],
                               "idle_gaps": outcome.trace["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    result["_forbidden"] = outcome.notes.get("forbidden", [])
    result["_marks"] = outcome.notes.get("marks", {})
    result["_info"] = outcome.notes.get("info", {})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", choices=("program", "control"),
                    default="program")
    ap.add_argument("--prepare", default=None,
                    help="module:function called before the program runs "
                         "(a fault of dtxbench/tests/faults.py, to read "
                         "what it does to the checks at the cell's size)")
    args = ap.parse_args(argv)
    cell, _ = cell_files(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"dtxbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda"), args.variant,
                     args.prepare)
    forbidden = sorted(set(result.pop("_forbidden"))
                       | set(common.forbidden_modules()))
    if forbidden:
        print(f"dtxbench: modules of jax or the JAX package were loaded: "
              f"{forbidden}", file=sys.stderr)
        return 3
    marks = result.pop("_marks")
    print("setup (s since the process started): " + ", ".join(
        f"{k} {v}" for k, v in marks.items()), file=sys.stderr)
    print(f"card: {card()}", file=sys.stderr)
    for name, value in result.pop("_info").items():
        print(f"info {name}: {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

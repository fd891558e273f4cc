"""Run a function on several ranks of a fresh process group, each rank a
spawned process on this host; the launcher of the port's multi-rank tests,
chip_smoke.py's multi-device phase and tools/bench_scaling.

    results = run_ranks(fn, world=4, args=(...))          # on the cards
    results = run_ranks(fn, world=4, args=(...), device="cpu")

Each rank joins the group through a FileStore in a private directory
(no TCP port to pick), with `timeout` on every collective, then returns
fn(rank, *args).  The results (tensors and plain values) come back in rank
order.  A rank's `timeout` runs from when it has joined the group (it
leaves a rank<r>.joined file then), so a rank still starting, importing
torch on a loaded host, is not charged for it; start-up has its own
allowance, START_TIMEOUT.  A rank that fails, overruns its time or never
joins fails the call by name, and every rank still running is killed.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from detex_tpu_torch import resolve_device
from detex_tpu_torch.parallel import distributed

# Seconds from the spawn for every rank to join its group: spawning,
# importing torch and the rank's module on a loaded host, and the
# rendezvous.
START_TIMEOUT = 300.0


def _rank_main(fn, rank: int, world: int, workdir: str, device: str,
               backend: Optional[str], env: dict, timeout_s: float) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    work = Path(workdir)
    out = work / f"rank{rank}.pt"
    try:
        # The launcher's own file (see run_ranks).
        args = pickle.loads((work / "args.pkl").read_bytes())
        # Join together: the group's start waits on the slowest rank within
        # the collectives' limit, which must not pay for a rank's start-up.
        (work / f"rank{rank}.ready").touch()
        while not all((work / f"rank{r}.ready").exists()
                      for r in range(world)):
            time.sleep(0.01)
        distributed.initialize(
            f"file://{work / 'store'}", world, rank, device=device,
            backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
        (work / f"rank{rank}.joined").touch()
        result = fn(rank, *args)
        torch.save(result, out.with_suffix(".tmp"))
        out.with_suffix(".tmp").replace(out)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _wait(procs, workdir: Path, timeout: float) -> list:
    """Wait for every rank to end, killing each rank that has not joined
    START_TIMEOUT s after the spawn (at once where a rank has failed
    before joining: the group cannot form) or still runs `timeout` s after
    it joined.  Returns the ranks that never joined and were killed."""
    spawned = time.monotonic()
    joined = [None] * len(procs)
    unjoined = []
    while True:
        now = time.monotonic()
        running = []
        for r, p in enumerate(procs):
            if joined[r] is None and (workdir / f"rank{r}.joined").exists():
                joined[r] = now
        orphaned = any(p.exitcode not in (None, 0) and joined[r] is None
                       for r, p in enumerate(procs))
        for r, p in enumerate(procs):
            if p.exitcode is not None:
                continue
            if joined[r] is None and (orphaned or
                                      now > spawned + START_TIMEOUT):
                unjoined.append(r)
                p.kill()
            elif joined[r] is not None and now > joined[r] + timeout:
                p.kill()
            else:
                running.append(p)
        if not running:
            return unjoined
        multiprocessing.connection.wait([p.sentinel for p in running], 0.05)


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              device="cuda", backend: Optional[str] = None,
              timeout: float = 120.0, env: Optional[dict] = None) -> list:
    """fn(rank, *args) on `world` spawned ranks; their results in rank
    order.  `fn` must be importable (a module-level function).  `env` is
    set in each rank before it joins; `device` (the card unless
    device="cpu"; a CUDA device where there is none raises before any rank
    starts) and `backend` go to distributed.initialize (a CUDA device puts
    rank r on card r modulo the card count).  Each rank has `timeout`
    seconds from when it has joined the group (every collective's limit
    too) and START_TIMEOUT seconds from the spawn to join it.  Raises
    RuntimeError naming the ranks that failed, ran past `timeout` or did
    not join within START_TIMEOUT."""
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        # The arguments go by file: a spawn pipe holds 64 KiB, and a rank
        # reads it only after importing, so larger arguments would start
        # the ranks one after another.
        (Path(tmp) / "args.pkl").write_bytes(pickle.dumps(tuple(args)))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world, tmp, device, backend, env or {}, timeout))
            for rank in range(world)]
        for p in procs:
            p.start()
        try:
            unjoined = _wait(procs, Path(tmp), timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [Path(tmp) / f"rank{r}.err" for r in failed]
            detail = "\n".join(e.read_text() for e in errs if e.exists())
            late = (f"; ranks {unjoined} did not join within "
                    f"{START_TIMEOUT} s" if unjoined else "")
            raise RuntimeError(
                f"ranks {failed} of {world} failed or ran past {timeout} s "
                f"after joining{late} (exit codes "
                f"{[procs[r].exitcode for r in failed]}):\n{detail}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True)
                for r in range(world)]

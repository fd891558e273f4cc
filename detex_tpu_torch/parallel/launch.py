"""Run a function on several ranks of a fresh process group, each rank a
spawned process on this host; the launcher of the port's multi-rank tests,
chip_smoke.py's multi-device phase and tools/bench_scaling.

    results = run_ranks(fn, world=4, args=(...))          # on the cards
    results = run_ranks(fn, world=4, args=(...), device="cpu")

Each rank joins the group through a FileStore in a private directory
(no TCP port to pick), with `timeout` on every collective, then returns
fn(rank, *args).  The results (tensors and plain values) come back in rank
order.  Each rank is joined with the time left of `timeout`; a rank that
fails or overruns fails the call, and every rank still running is killed.
"""

from __future__ import annotations

import datetime
import multiprocessing
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


def _rank_main(fn, rank: int, world: int, workdir: str, device: str,
               backend: Optional[str], env: dict, timeout_s: float) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    out = Path(workdir) / f"rank{rank}.pt"
    try:
        # The launcher's own file (see run_ranks).
        args = pickle.loads((Path(workdir) / "args.pkl").read_bytes())
        distributed.initialize(
            f"file://{Path(workdir) / 'store'}", world, rank, device=device,
            backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(rank, *args)
        torch.save(result, out.with_suffix(".tmp"))
        out.with_suffix(".tmp").replace(out)
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              device="cuda", backend: Optional[str] = None,
              timeout: float = 120.0, env: Optional[dict] = None) -> list:
    """fn(rank, *args) on `world` spawned ranks; their results in rank
    order.  `fn` must be importable (a module-level function).  `env` is
    set in each rank before it joins; `device` (the card unless
    device="cpu"; a CUDA device where there is none raises before any rank
    starts) and `backend` go to distributed.initialize (a CUDA device puts
    rank r on card r modulo the card count).  Raises RuntimeError naming
    the ranks that failed or ran past `timeout` seconds."""
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
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [Path(tmp) / f"rank{r}.err" for r in failed]
            detail = "\n".join(e.read_text() for e in errs if e.exists())
            raise RuntimeError(
                f"ranks {failed} of {world} failed or ran past {timeout} s "
                f"(exit codes {[procs[r].exitcode for r in failed]}):\n"
                f"{detail}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True)
                for r in range(world)]

"""Multi-process runtime: process-group start-up and the (dcn, ici) mesh.

Counterpart of detex_tpu/parallel/distributed.py.  The scaling model is
the JAX package's, on torch.distributed:

  * one process per card, started by a launcher (torchrun, or
    parallel.launch.run_ranks) and joined with initialize();
  * a 2D ("dcn", "ici") mesh: the leading axis spans hosts (traffic
    crosses the data-center network), the trailing axis spans each host's
    cards (traffic stays on the host's links);
  * collectives are the helpers of parallel/mesh.py over the mesh's
    groups: NCCL on cards, gloo on the CPU.

Shardings keep heavy reductions (MPPI weight normalisation, the LQT's
chunk combine) on "ici" and cross "dcn" only with the final small partial
(mesh.all_reduce reduces the innermost axis first).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from detex_tpu_torch import resolve_device
from detex_tpu_torch.parallel import mesh as mesh_mod

TIMEOUT = datetime.timedelta(seconds=60)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None,
               timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join this process to the process group.

    A no-op where a group exists, and for a single process with no
    coordinator given and no launcher environment (so the same entry point
    runs on one card and on many).  The arguments default to torchrun's
    environment: MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK, and
    LOCAL_RANK for the card.  `coordinator_address` is "host:port" (TCP)
    or an init_method URL such as "file:///path/to/store".

    The backend is NCCL for a CUDA device and gloo for the CPU unless
    `backend` says otherwise (NCCL takes one rank per card: ranks that
    share a card use gloo).  On a CUDA device the rank's card is
    cuda:LOCAL_RANK (rank modulo the card count without LOCAL_RANK); a
    CUDA device where there is none raises.  Collectives give up after
    `timeout`.  An NCCL group needs no setting for a CUDA graph to hold its
    collectives (mesh.capturable, graphs.Graph): each rank's warm-ups make
    the communicators, and every rank captures and replays in the same
    order."""
    if dist.is_initialized():
        return
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and "MASTER_ADDR" not in env and "WORLD_SIZE" not in env):
        return
    device = resolve_device(device)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    world = (int(env["WORLD_SIZE"]) if num_processes is None
             else int(num_processes))
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)


def rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_host_mesh(axis_names: Sequence[str] = ("dcn", "ici"),
                   device="cuda") -> DeviceMesh:
    """Mesh with hosts on the leading (DCN) axis and each host's ranks on
    the trailing (ICI) axis: (world / per_host, per_host), where per_host
    is LOCAL_WORLD_SIZE (torchrun's ranks per host; the whole world when
    unset).  A single process gets (1, 1): the same program shape runs
    anywhere."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host < 1 or n % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_host} does not divide the "
                         f"world size {n}")
    return mesh_mod.make_mesh((n // per_host, per_host), axis_names, device)

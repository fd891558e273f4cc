"""The port's process groups, meshes and collectives
(detex_tpu_torch/parallel/) against the JAX package's parallel/ and
tests/test_train_loop.py::test_host_mesh_psum.

Ranks are spawned processes joined in a gloo group over a FileStore
(parallel.launch.run_ranks, with its own time limit; a rank that fails or
overruns fails the test and the rest are killed).  Every comparison is
exact: the collectives move integers held in float32, and the shards are
slices.  The card's machine has no JAX, so the JAX package is imported
only inside the `jx` fixture; the ranks import this module without it.
"""

import datetime
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from detex_tpu_torch.parallel import distributed as PD
from detex_tpu_torch.parallel import launch
from detex_tpu_torch.parallel import mesh as PM
from detex_tpu_torch.tools import bench_scaling, diag_mppi_gap

_TIMEOUT = 90.0
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(scope="module")
def jx():
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    return SimpleNamespace(jax=jax, Mesh=Mesh, NamedSharding=NamedSharding,
                           P=P)


@pytest.fixture
def no_group(monkeypatch):
    """No launcher environment, and no process group left behind."""
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# --- one process -----------------------------------------------------------


def test_make_mesh_world_of_one(no_group):
    mesh = PM.make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp")
    assert tuple(mesh.shape) == (1, 1)
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert PM.axis_size(mesh, ("dp", "tp")) == 1
    assert PM.axis_index(mesh, "dp") == 0
    x = torch.arange(6.0)
    assert torch.equal(PM.shard_batch(x, mesh), x)
    assert PM.replicated(x, mesh) is x
    PM.reset_collective_bytes()
    assert torch.equal(PM.all_reduce(x, mesh, "dp"), x)
    assert PM.COLLECTIVE_BYTES == {("all_reduce_sum", "dp"): 24}


@pytest.mark.parametrize("shape", [(2, 1), (1, 3), (2,)])
def test_make_mesh_shape_not_the_world_raises(no_group, shape):
    with pytest.raises(ValueError, match="world size 1"):
        PM.make_mesh(shape, device="cpu")
    assert not dist.is_initialized()


def test_make_host_mesh_single_process(no_group):
    PD.initialize(device="cpu")              # no-op: one process
    assert not dist.is_initialized()
    mesh = PD.make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("dcn", "ici")
    assert tuple(mesh.shape) == (1, 1)


def _capture_init(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_initialize_reads_the_launcher_env(no_group, monkeypatch):
    calls = _capture_init(monkeypatch)
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29511"),
                 ("RANK", "3"), ("WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    PD.initialize(device="cpu")
    assert calls == [(("gloo",), dict(init_method="tcp://localhost:29511",
                                      rank=3, world_size=4,
                                      timeout=PD.TIMEOUT))]


@pytest.mark.parametrize("address, method", [
    ("node0:1234", "tcp://node0:1234"),
    ("file:///tmp/store", "file:///tmp/store")])
def test_initialize_coordinator_address(no_group, monkeypatch, address,
                                        method):
    calls = _capture_init(monkeypatch)
    timeout = datetime.timedelta(seconds=5)
    PD.initialize(address, 2, 1, device="cpu", timeout=timeout)
    assert calls == [(("gloo",), dict(init_method=method, rank=1,
                                      world_size=2, timeout=timeout))]


def test_initialize_on_a_card_needs_one(no_group, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.initialize("node0:1", 2, 0)


# --- four ranks ------------------------------------------------------------


def _four_ranks(rank):
    out = {}
    host = PD.make_host_mesh(device="cpu")      # LOCAL_WORLD_SIZE=2
    out["host_shape"] = tuple(host.shape)
    out["host_names"] = host.mesh_dim_names
    out["groups"] = {a: dist.get_process_group_ranks(host.get_group(a))
                     for a in ("dcn", "ici")}
    # tests/test_train_loop.py::test_host_mesh_psum: each rank sums its
    # row of arange(n * 4), on-host ("ici") first, then across ("dcn").
    PM.reset_collective_bytes()
    local = torch.arange(rank * 4, rank * 4 + 4, dtype=torch.float32).sum()
    out["psum"] = PM.all_reduce(local, host, ("dcn", "ici"))
    out["psum_bytes"] = dict(PM.COLLECTIVE_BYTES)
    out["min_ici"] = PM.all_reduce(torch.tensor(10.0 - rank), host, "ici",
                                   "min")
    out["min_dcn"] = PM.all_reduce(torch.tensor(float(rank)), host, "dcn",
                                   "min")
    out["gather_dcn"] = PM.all_gather(torch.tensor([rank, -rank]), host,
                                      "dcn")
    out["default_shape"] = tuple(PM.make_mesh(device="cpu").shape)
    try:
        PM.make_mesh((3, 1), device="cpu")
        out["bad_shape"] = "no error"
    except ValueError as e:
        out["bad_shape"] = str(e)
    mesh = PM.make_mesh((2, 2), device="cpu")
    rows = torch.arange(16).reshape(8, 2)
    out["rows"] = {a: PM.shard_batch(rows, mesh, a)
                   for a in ("dp", "tp")}
    out["rows_both"] = PM.shard_batch(rows, mesh, ("dp", "tp"))
    try:
        PM.shard_batch(rows[:6], mesh, ("dp", "tp"))
        out["bad_rows"] = "no error"
    except ValueError as e:
        out["bad_rows"] = str(e)
    # The autograd pairs on "tp": the loss is replicated; every rank's
    # gradient of a replicated input is the whole gradient.
    x = torch.arange(1.0, 5.0, requires_grad=True)
    scale = float(PM.axis_index(mesh, "tp") + 1)
    piece = PM.split_over_axis(x, mesh, "tp", 0) * scale
    whole = PM.gather_over_axis(piece, mesh, "tp", 0)
    (whole * whole).sum().backward()
    out["split_gather"] = (whole.detach(), x.grad.clone())
    y = torch.arange(1.0, 4.0, requires_grad=True)
    z = PM.reduce_over_axis(PM.copy_to_axis(y, mesh, "tp") * scale, mesh,
                            "tp")
    (z * z).sum().backward()
    out["copy_reduce"] = (z.detach(), y.grad.clone())
    return out


@pytest.fixture(scope="module")
def four():
    return launch.run_ranks(_four_ranks, 4, env={"LOCAL_WORLD_SIZE": "2"},
                            device="cpu", timeout=_TIMEOUT)


def test_host_mesh_layout(four):
    """(n_hosts, per_host) from LOCAL_WORLD_SIZE: "ici" groups the ranks of
    a host, "dcn" the same rank across hosts."""
    for rank, out in enumerate(four):
        assert out["host_shape"] == (2, 2)
        assert out["host_names"] == ("dcn", "ici")
        host = rank // 2
        assert out["groups"]["ici"] == [2 * host, 2 * host + 1]
        assert out["groups"]["dcn"] == [rank % 2, rank % 2 + 2]


def test_host_mesh_psum(four):
    """SUM over "ici" then "dcn" (test_host_mesh_psum): the whole sum, and
    one 4-byte reduction on each axis."""
    for out in four:
        assert float(out["psum"]) == float(np.arange(16).sum())
        assert out["psum_bytes"] == {("all_reduce_sum", "ici"): 4,
                                     ("all_reduce_sum", "dcn"): 4}


def test_min_and_gather(four):
    for rank, out in enumerate(four):
        host = rank // 2
        assert float(out["min_ici"]) == 10.0 - (2 * host + 1)
        assert float(out["min_dcn"]) == float(rank % 2)
        want = torch.tensor([[rank % 2, -(rank % 2)],
                             [rank % 2 + 2, -(rank % 2 + 2)]])
        assert torch.equal(out["gather_dcn"], want)


def test_make_mesh_default_and_errors(four):
    for out in four:
        assert out["default_shape"] == (4, 1)
        assert "(3, 1) != world size 4" in out["bad_shape"]
        assert "not divisible" in out["bad_rows"]


@pytest.mark.parametrize("axis", ["dp", "tp", ("dp", "tp")])
def test_shard_batch_is_jax_named_sharding(four, jx, axis):
    """Each rank's rows are the shard JAX's NamedSharding(mesh, P(axis))
    puts on the device at the same (dp, tp) place."""
    devices = np.array(jx.jax.devices()[:4]).reshape(2, 2)
    mesh = jx.Mesh(devices, ("dp", "tp"))
    rows = np.arange(16).reshape(8, 2)
    arr = jx.jax.device_put(rows, jx.NamedSharding(mesh, jx.P(axis)))
    by_device = {s.device: np.asarray(s.data) for s in
                 arr.addressable_shards}
    for rank, out in enumerate(four):
        got = out["rows_both"] if axis == ("dp", "tp") else out["rows"][axis]
        np.testing.assert_array_equal(got.numpy(),
                                      by_device[devices.ravel()[rank]])


def test_tensor_parallel_autograd_pairs(four):
    """split -> scale by (tp index + 1) -> gather: the replicated whole and
    the whole gradient on every rank; copy -> scale -> reduce likewise."""
    x = torch.arange(1.0, 5.0)
    w = torch.tensor([1.0, 1.0, 2.0, 2.0])
    y = torch.arange(1.0, 4.0)
    for out in four:
        whole, grad = out["split_gather"]
        assert torch.equal(whole, x * w)
        assert torch.equal(grad, 2 * x * w * w)
        z, ygrad = out["copy_reduce"]
        assert torch.equal(z, 3 * y)
        assert torch.equal(ygrad, 2 * 3 * y * 3)


def _raises(rank):
    raise ValueError(f"rank {rank} fails on purpose")


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        launch.run_ranks(_raises, 2, device="cpu", timeout=_TIMEOUT)


def _hangs(rank):
    if rank == 1:
        import time
        time.sleep(600)
    return rank


def test_run_ranks_kills_a_rank_past_its_time():
    with pytest.raises(RuntimeError, match=r"ranks \[1\] of 2"):
        launch.run_ranks(_hangs, 2, device="cpu", timeout=10.0)


# A rank function whose module takes _SLOW_START_S to import in a spawned
# rank (and no time in this process): a rank slow to start.
_SLOW_START_S = 12.0
_SLOW_MODULE = f"""
import multiprocessing
import time

if multiprocessing.parent_process() is not None:
    time.sleep({_SLOW_START_S})


def rank_fn(rank):
    return rank
"""


@pytest.fixture
def slow_start(tmp_path, monkeypatch):
    """rank_fn of a module that sleeps on import in each spawned rank (a
    rank unpickles its function, importing its module, before it joins)."""
    import importlib
    (tmp_path / "dtx_slow_start_rank.py").write_text(_SLOW_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    module = importlib.import_module("dtx_slow_start_rank")
    yield module.rank_fn
    import sys
    sys.modules.pop("dtx_slow_start_rank", None)


def test_run_ranks_times_a_rank_from_its_join(slow_start):
    """Ranks that take longer than `timeout` to start, and finish well
    inside it once joined, succeed: the time runs from the join."""
    assert launch.run_ranks(slow_start, 2, device="cpu",
                            timeout=_SLOW_START_S / 2) == [0, 1]


def test_run_ranks_names_ranks_that_never_join(slow_start, monkeypatch):
    """Start-up has its own bounded allowance: ranks still starting when it
    ends are killed and named."""
    monkeypatch.setattr(launch, "START_TIMEOUT", 2.0)
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] of 2 .*ranks "
                       r"\[0, 1\] did not join within 2.0 s"):
        launch.run_ranks(slow_start, 2, device="cpu", timeout=_TIMEOUT)


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """Without `device` the ranks go on the cards; where there is none the
    call raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(launch.multiprocessing, "get_context",
                        lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run_ranks(_raises, 2, timeout=_TIMEOUT)
    assert started == []


# --- the tools ---------------------------------------------------------------


def test_diag_mppi_gap_on_the_cpu(no_group, capsys):
    """Both rows, timed by the same method, at a small size."""
    rows = diag_mppi_gap.main(["--device", "cpu", "--rollouts", "64",
                               "--horizon", "2", "--reps", "1"])
    assert [r["variant"] for r in rows] == ["unsharded", "sharded"]
    assert all(r["ms_per_solve"] > 0 and r["device"] == "cpu" for r in rows)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows


@pytest.mark.parametrize("lqt", [False, True], ids=["mppi", "lqt"])
def test_bench_scaling_on_the_cpu(lqt, capsys):
    """1 and 2 ranks of the same global problem; rank 0's time, the
    collective bytes per call (MPPI: MIN 4 B + SUM (H*A + 3) * 4 B), the
    efficiency against linear (1.0 at one rank)."""
    args = ["--device", "cpu", "--ranks", "1,2", "--reps", "1"]
    args += (["--lqt", "--lqt-horizon", "15", "--state-dim", "4",
              "--action-dim", "2"] if lqt else
             ["--rollouts", "64", "--horizon", "2"])
    rows = bench_scaling.main(args)
    assert [(r["ranks"], r["backend"], r["program"]) for r in rows] == [
        (1, "gloo", "eager"), (2, "gloo", "eager")]
    assert rows[0]["efficiency_vs_linear"] == 1.0
    if not lqt:
        assert {r["collective_bytes_per_call"] for r in rows} == {
            4 + (2 * 8 + 3) * 4}
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["rows"] == rows and summary["device"] == "cpu"

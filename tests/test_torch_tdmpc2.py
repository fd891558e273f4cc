"""TD-MPC2 on the port's control path (mpc/tdmpc2.py; mpc/runtime.py's
_StepProgram behind Controller.step) against the benchmark's plain
reference (dtxbench/reference/tdmpc2.py), at small widths on the CPU with
seeded weights; the cell tdmpc2_317m.control's driver, limits, planted
faults, readers and BENCHMARK.json entries; and, marked `cuda`, the
graphed step against the eager one on a card.

Tolerances: on the CPU the program and the reference run the same torch
operations on the same shapes in the same order, so they are held bit for
bit (torch.equal).  On a card the graph replays the eager step's own
kernels: bit for bit as well.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from detex_tpu_torch.mpc import runtime as R
from detex_tpu_torch.mpc import tdmpc2 as T
from detex_tpu_torch.utils import trace
from dtxbench import flops_tdmpc2, run, traffic
from dtxbench.drivers import tdmpc2_control as driver
from dtxbench.reference import bptc as ref_bc7
from dtxbench.reference import tdmpc2 as ref

REPO = Path(__file__).resolve().parents[1]
CELL = "tdmpc2_317m.control"
SEED = 2**31 + 977
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NEW_METRICS = {"mfu_pct.tdmpc2", "device_idle_pct.tdmpc2",
               "control_step_p95_ms.tdmpc2", "control_host_ms.tdmpc2",
               "device_ops_per_step.tdmpc2", "tdmpc2_draw_ms"}

# Small widths; the published image side (the conv stack needs it), frame
# count, bins range, horizon and planner weights; a task with one of its
# three action dims masked.
TINY_MODEL = {"obs": "rgb", "image_size": 64, "frames": 3, "num_channels": 8,
              "mlp_dim": 32, "latent_dim": 16, "simnorm_dim": 8,
              "num_bins": 11, "vmin": -10, "vmax": 10, "num_q": 4,
              "task_dim": 8, "n_tasks": 4, "action_dim": 3,
              "log_std_min": -10, "log_std_max": 2}
TINY_PLANNER = {"horizon": 3, "iterations": 3, "num_samples": 32,
                "num_elites": 8, "num_pi_trajs": 4, "temperature": 0.5,
                "min_std": 0.05, "max_std": 2}
TINY_TASK = {"name": "tiny", "index": 2, "action_dim": 2,
             "episode_length": 500, "discount": 0.99}
TINY_CONFIG = {"model": TINY_MODEL, "planner": TINY_PLANNER,
               "task": TINY_TASK,
               "precision": {"compute_dtype": "bfloat16"}}
TINY_TRAFFIC = {"checked_steps": 6, "trace_seconds": 0.2}
M = ref.flat_config(TINY_CONFIG)
CFG = driver.model_config(TINY_CONFIG)


def _leaves(d, prefix=""):
    for k in sorted(d):
        if isinstance(d[k], dict):
            yield from _leaves(d[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", d[k]


def _params(seed=1):
    return ref.init_params(M, torch.Generator().manual_seed(seed))


def _frames(seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (3, 64, 64, 3), generator=gen,
                         dtype=torch.int32)


def _measure(seconds=0.5, trace_on=False, variant="program", prepare=None):
    return run.measure(CELL, SEED, seconds, trace_on, torch.device("cpu"),
                       variant, prepare, TINY_CONFIG, TINY_TRAFFIC)


# -- the model against the reference ------------------------------------------

def test_init_params_equal_the_references():
    mine = dict(_leaves(T.init_params(CFG, torch.Generator().manual_seed(4))))
    theirs = dict(_leaves(_params(4)))
    assert mine.keys() == theirs.keys()
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    assert mine["q/fc0/w"].shape == (4, 16 + 8 + 3, 32)
    assert mine["enc/proj/w"].shape == (8 * 4 * 4, 16)


def test_published_widths_and_counts():
    cfg = T.TDMPC2Config()
    assert (cfg.mlp_dim, cfg.latent_dim, cfg.num_q, cfg.simnorm_dim,
            cfg.num_bins, cfg.task_dim) == (4096, 1376, 8, 8, 101, 96)
    assert T.conv_side(cfg) == 4                     # 64 -> 29 -> 13 -> 6 -> 4
    # prior 24 x (3 policy + 2 dynamics); 6 x 512 x (3 x 2 + 1 + 2)
    assert T.mlp_rows(cfg) == 24 * 5 + 6 * 512 * 9 == 27_768


def test_simnorm_and_two_hot_inverse_equal_the_references():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((5, 16), generator=gen) * 3
    assert torch.equal(T.simnorm(x, 8), ref.simnorm(x, 8))
    groups = T.simnorm(x, 8).reshape(5, 2, 8).sum(-1)
    torch.testing.assert_close(groups, torch.ones(5, 2))
    logits = torch.randn((5, 11), generator=gen)
    bins = torch.linspace(-10, 10, 11)
    assert torch.equal(T.two_hot_inv(logits, bins),
                       ref.two_hot_inv(logits, M))
    # A one-hot on bin b reads symexp(b's centre).
    onehot = torch.full((1, 11), -1e9)
    onehot[0, 7] = 0.0
    torch.testing.assert_close(T.two_hot_inv(onehot, bins),
                               torch.tensor([[np.expm1(4.0)]],
                                            dtype=torch.float32))


def test_each_mlp_equals_the_references():
    params = _params()
    ctx = T.task_context(params, 2, CFG)
    gen = torch.Generator().manual_seed(7)
    z = T.simnorm(torch.randn((6, 16), generator=gen), 8)
    a = torch.rand((6, 3), generator=gen) * 2 - 1
    eps = torch.randn((6, 3), generator=gen)
    za = torch.cat([z, ctx["emb"].expand(6, -1), a], -1)
    assert torch.equal(T.next_latent(params, za, CFG),
                       ref.next_latent(params, z, a, 2, M, ref.BF16))
    assert torch.equal(T.reward(params, za, ctx["bins"], CFG),
                       ref.reward(params, z, a, 2, M, ref.BF16))
    zt = torch.cat([z, ctx["emb"].expand(6, -1)], -1)
    pi = T.policy(params, zt, eps, ctx["mask"], CFG)
    assert torch.equal(pi, ref.pi(params, z, 2, eps, M, ref.BF16))
    assert not pi[:, 2].any() and pi[:, :2].abs().max() <= 1
    q = [T.q_value(params, za, torch.tensor(k), ctx["bins"], CFG)
         for k in (1, 3)]
    assert torch.equal((q[0] + q[1]) / 2,
                       ref.q_avg(params, z, a, 2, [1, 3], M, ref.BF16))
    frames = _frames(8)
    assert torch.equal(T.encode(params, frames, CFG),
                       ref.encode(params, frames, M, ref.BF16))


def test_the_draws_equal_the_references():
    draws = T.empty_draws(CFG, "cpu")
    T.draw(draws, torch.Generator().manual_seed(9))
    theirs = ref.draws(torch.Generator().manual_seed(9), M)
    for k, v in theirs.items():
        assert torch.equal(draws[k], v), k
    pairs = T.q_pairs(draws["q_keys"])
    assert pairs.shape == (3, 2) and (pairs[:, 0] != pairs[:, 1]).all()


@pytest.mark.parametrize("warm_seed", [None, 11])
def test_one_planning_step_with_injected_draws(warm_seed):
    params = _params()
    z = T.encode(params, _frames(10), CFG)
    warm = torch.zeros((3, 3))
    if warm_seed is not None:
        warm = torch.rand((3, 3), generator=torch.Generator().manual_seed(
            warm_seed)) * 2 - 1
        warm[:, 2] = 0
    draws = T.empty_draws(CFG, "cpu")
    T.draw(draws, torch.Generator().manual_seed(12))
    mine = T.plan(params, z, warm, draws, T.task_context(params, 2, CFG),
                  CFG)
    theirs = ref.plan(params, z, warm, ref.draws(
        torch.Generator().manual_seed(12), M), 2, M, ref.BF16)
    for k in ("action", "values", "mean", "std", "elites"):
        assert torch.equal(mine[k], theirs[k]), k
    assert int(mine["choice"]) == theirs["choice"]
    assert mine["values"].shape == (32,) and mine["elites"].shape == (3, 8)
    assert (mine["std"][:, :2] >= 0.05).all() and not mine["std"][:, 2].any()
    assert torch.equal(T.warm_start(mine["mean"]),
                       ref.warm_start(theirs["mean"]))


def test_the_planner_reads_nothing_on_the_host():
    """A captured step holds no host read: under FakeTensorMode a read of
    a tensor's value (an .item(), an index by a 0-d tensor) raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    params = _params()
    ctx = T.task_context(params, 2, CFG)
    draws = T.empty_draws(CFG, "cpu")
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        def fake(tree):
            return {k: fake(v) if isinstance(v, dict) else mode.from_tensor(v)
                    for k, v in tree.items()}
        z = T.encode(fake(params), mode.from_tensor(_frames(1)), CFG)
        out = T.plan(fake(params), z, mode.from_tensor(torch.zeros(3, 3)),
                     fake(draws), fake(ctx), CFG)
    assert tuple(out["action"].shape) == (3,)


def _reference_step(params, words, before, draws):
    """The reference's step from the state `before` (None: the episode's
    start)."""
    pix, _ = ref_bc7.decode(torch.from_numpy(traffic.blocks_of(words)))
    rgb = ref_bc7.assemble(pix, 64, 64)[..., :3].to(torch.int32)
    if before is None:
        frames, warm = rgb[None].repeat(3, 1, 1, 1), torch.zeros((3, 3))
    else:
        frames = torch.cat([before["frames"][1:], rgb[None]])
        warm = before["nominal"]
    z = ref.encode(params, frames, M, ref.BF16)
    return ref.plan(params, z, warm, draws, 2, M, ref.BF16), frames


def test_three_controller_steps_each_from_the_held_state():
    params = _params()
    cfg = R.ControllerConfig(tdmpc2=CFG)
    ctl = R.Controller(params, 2, cfg, seed=13, device="cpu")
    assert not ctl.graphed
    pool = traffic.observation_pool(np.random.default_rng(14), 3, 64)
    gen = torch.Generator().manual_seed(13)
    before = None
    for i in range(3):
        action = ctl.step(pool[i])
        want, frames = _reference_step(params, pool[i], before,
                                       ref.draws(gen, M))
        assert torch.equal(torch.from_numpy(action), want["action"])
        for k in ("values", "mean", "std"):
            assert torch.equal(ctl.diag[k], want[k]), (i, k)
        assert torch.equal(ctl.diag["elites"].long(), want["elites"])
        assert int(ctl.diag["choice"]) == want["choice"]
        assert torch.equal(ctl.frames, frames)
        assert torch.equal(ctl.nominal, ref.warm_start(want["mean"]))
        before = {"nominal": ctl.nominal.clone(),
                  "frames": ctl.frames.clone()}
    # The first step filled the stack with its frame; the third holds all.
    assert not torch.equal(ctl.frames[0], ctl.frames[2])


def test_the_pipelined_controller_serves_tdmpc2_one_step_behind():
    params = _params()
    cfg = R.ControllerConfig(tdmpc2=CFG)
    pool = traffic.observation_pool(np.random.default_rng(15), 3, 64)
    sync = R.Controller(params, 2, cfg, seed=16, device="cpu")
    pipe = R.PipelinedController(params, 2, cfg, seed=16, device="cpu")
    want = [sync.step(w) for w in pool]
    got = [pipe.step(w) for w in pool] + [pipe.flush()]
    assert got[0] is None
    for a, b in zip(got[1:], want, strict=True):
        assert np.array_equal(a, b)


def test_tdmpc2_is_served_on_one_card_only():
    cfg = R.ControllerConfig(tdmpc2=CFG, rollout_axis="dp")
    with pytest.raises(ValueError, match="one card"):
        R.Controller(_params(), 2, cfg, device="cpu")
    assert R.ControllerConfig().tdmpc2 is None


def test_the_rows_counter_and_the_draw_span():
    ctl = R.Controller(_params(), 2, R.ControllerConfig(tdmpc2=CFG),
                       seed=17, device="cpu")
    pool = traffic.observation_pool(np.random.default_rng(18), 2, 64)
    trace.reset()
    trace.enable(True)
    try:
        for w in pool:
            ctl.step(w)
        snap = trace.snapshot()
    finally:
        trace.enable(False)
        trace.reset()
    # prior 4 x (3 + 2) rows; 3 rounds x 32 samples x (3 x 2 + 1 + 2)
    assert T.mlp_rows(CFG) == 4 * 5 + 3 * 32 * 9
    assert snap["counts"]["dtx.tdmpc2.rows"] == 2 * T.mlp_rows(CFG)
    assert snap["spans"]["dtx.tdmpc2.draw"]["count"] == 2
    assert snap["spans"]["dtx.control.plan"]["count"] == 2


# -- the cell -----------------------------------------------------------------

def test_flop_count_equals_the_hand_count():
    m = ref.flat_config(json.loads(
        (REPO / "dtxbench/configs/tdmpc2_317m.json").read_text()))
    # convs 2 x (29^2 x 32 x 9 x 49 + 13^2 x 32 x 32 x 25 + 6^2 x 32 x 32 x
    # 9 + 4^2 x 32 x 32 x 9), proj 2 x 512 x 1376
    assert flops_tdmpc2.encoder_flops(m) == 2 * (
        841 * 32 * 441 + 169 * 32 * 800 + 36 * 32 * 288 + 16 * 32 * 288
        + 512 * 1376) == 34_756_672
    dyn = 2 * (1478 * 4096 + 4096 * 4096 + 4096 * 1376)
    head = 2 * (1478 * 4096 + 4096 * 4096 + 4096 * 101)
    pi = 2 * (1472 * 4096 + 4096 * 4096 + 4096 * 12)
    assert 3 * (dyn + head) + pi + 2 * head == 2 * 224_481_280
    assert flops_tdmpc2.step_flops(m) == (
        34_756_672 + 24 * (3 * pi + 2 * dyn)
        + 6 * 512 * (3 * (dyn + head) + pi + 2 * head)) \
        == 1_385_271_810_112


def test_the_cell_is_correct_at_a_small_size():
    result = _measure()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"control_step_ms", "setup_s"}
    checks = result["checks"]
    assert set(checks) == {"value_rel_gap_max", "mean_gap_max",
                           "std_gap_max", "action_gap_max",
                           "frames_differing"}
    assert all(np.isfinite(c["value"]) for c in checks.values())


def test_a_traced_run_reports_the_new_metrics_it_can_read_here():
    result = _measure(seconds=0.6, trace_on=True)
    assert result["correct"]
    # The device's readers find no device records in a CPU trace.
    assert set(result["metrics"]) == {
        "mfu_pct.tdmpc2", "control_step_p95_ms.tdmpc2",
        "control_host_ms.tdmpc2", "tdmpc2_draw_ms"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_the_control_is_not_correct():
    result = _measure(variant="control")
    assert not result["correct"]
    assert all(np.isfinite(c["value"]) for c in result["checks"].values())


FAULTS = ["iteration_left_out", "half_samples", "simnorm_left_out",
          "q_one_head", "prior_left_out"]


def _child(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO), **env),
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    # In a child process: a fault patches the program for good.
    proc = _child(
        "import json, math\n"
        "from tests import test_torch_tdmpc2 as X\n"
        f"r = X._measure(prepare='dtxbench.tests.faults_tdmpc2:{fault}')\n"
        "assert all(math.isfinite(c['value']) for c in r['checks'].values())\n"
        "print('CORRECT', r['correct'], json.dumps(r['checks']))\n")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CORRECT False" in proc.stdout, proc.stdout


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    """Every cell at a small size, the harness's own cells at its sizes
    (dtxbench/tests/test_dtxbench_harness.TINY) and this one at the sizes
    above, in one process: then nothing of jax is loaded."""
    proc = _child(
        "from tests import test_torch_tdmpc2 as X\n"
        "from dtxbench import common\n"
        "from dtxbench.tests import test_dtxbench_harness as H\n"
        "for cell in H.CELLS:\n"
        "    if cell == X.CELL:\n"
        "        r = X._measure(seconds=0.3)\n"
        "    else:\n"
        "        r = H.measure(cell, seconds=0.3,\n"
        "                      trace=cell.endswith('control'))\n"
        "    assert r['correct'], cell\n"
        "print('FORBIDDEN', common.forbidden_modules())\n")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_the_cell_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "dtxbench.run", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_program_without_tdmpc2_stops_at_the_drivers_import(monkeypatch):
    import detex_tpu_torch.mpc
    monkeypatch.delitem(sys.modules, "dtxbench.drivers.tdmpc2_control")
    monkeypatch.delattr(detex_tpu_torch.mpc, "tdmpc2")
    monkeypatch.setitem(sys.modules, "detex_tpu_torch.mpc.tdmpc2", None)
    with pytest.raises(ImportError):
        importlib.import_module("dtxbench.drivers.tdmpc2_control")


def _module_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_the_reference_imports_nothing_of_the_program_or_jax():
    names = _module_imports(REPO / "dtxbench/reference/tdmpc2.py")
    assert not {n for n in names if n.split(".")[0] in
                ("jax", "jaxlib", "detex_tpu", "detex_tpu_torch")}, names
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        ref.no_tf32()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- the benchmark's entries, safe for a program without TD-MPC2 --------------

NEW_FILES = {"drivers/tdmpc2_control.py", "reference/tdmpc2.py",
             "flops_tdmpc2.py", "metrics/device_ops_per_step.py",
             "metrics/tdmpc2_draw_ms.py", "tests/faults_tdmpc2.py"}


def test_the_new_entries_name_the_new_cell_only():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert NEW_METRICS <= set(per_layer)
    for m in BENCH["per_layer"]:
        if CELL in m["workloads"]:
            assert m["name"] in NEW_METRICS and m["workloads"] == [CELL]
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "control_step_ms"
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["control_step_ms"]["workloads"][-1] == CELL
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "tdmpc2_317m", "control", 1)
    assert BENCH["workloads"][-1] == cell
    assert BENCH["configs"][-1]["name"] == "tdmpc2_317m"
    assert BENCH["configs"][-1]["reduced"] == ["obs"]


def test_no_other_benchmark_file_imports_a_new_module():
    new_modules = {"tdmpc2_control", "flops_tdmpc2", "device_ops_per_step",
                   "tdmpc2_draw_ms", "faults_tdmpc2", "reference.tdmpc2",
                   "detex_tpu_torch.mpc.tdmpc2"}
    for path in (REPO / "dtxbench").rglob("*.py"):
        rel = path.relative_to(REPO / "dtxbench").as_posix()
        if rel in NEW_FILES:
            continue
        text = path.read_text()
        assert not [n for n in new_modules if n in text], rel


@pytest.mark.parametrize("name", ["device_ops_per_step", "tdmpc2_draw_ms"])
@pytest.mark.parametrize("summary", [None, {}, {"window_s": None},
                                     {"window_s": 2.0, "work": {}},
                                     {"window_s": 2.0, "n_device_ops": 0,
                                      "work": {"steps": 3}}])
def test_a_new_reader_reads_nothing_without_its_data(name, summary):
    trace.reset()
    reader = importlib.import_module(f"dtxbench.metrics.{name}")
    assert reader.read(summary) is None


def test_the_new_readers_read_their_data():
    from dtxbench.metrics import device_ops_per_step, tdmpc2_draw_ms
    summary = {"window_s": 2.0, "n_device_ops": 900, "work": {"steps": 3}}
    assert device_ops_per_step.read(summary) == 300
    trace.reset()
    trace.enable(True)
    try:
        with trace.span("dtx.tdmpc2.draw"):
            pass
        spans = trace.snapshot()["spans"]
        assert tdmpc2_draw_ms.read(summary) == pytest.approx(
            1e3 * spans["dtx.tdmpc2.draw"]["total_s"])
    finally:
        trace.enable(False)
        trace.reset()


# -- on a card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graphed_tdmpc2_step_equals_the_eager_one(cuda):
    params = ref.init_params(M, torch.Generator(cuda).manual_seed(19))
    ctl = R.Controller(params, 2, R.ControllerConfig(tdmpc2=CFG), seed=20,
                       device=cuda)
    assert ctl.graphed
    pool = traffic.observation_pool(np.random.default_rng(21), 4, 64)
    state = [t.clone() for t in ctl._program.state]
    for w in pool:
        action = ctl.step(w)
        step = ctl._program
        ctx = T.task_context(params, 2, CFG)
        want = R.tdmpc2_step_body(
            params, *state, torch.as_tensor(w).to(cuda),
            {k: v.clone() for k, v in step.draws.items()}, ctx, CFG)
        assert torch.equal(torch.from_numpy(action), want["action"].cpu())
        for k in ("values", "mean", "std"):
            assert torch.equal(ctl.diag[k], want[k]), k
        assert torch.equal(ctl.diag["elites"].long(), want["elites"])
        for mine, theirs in zip(step.state, state, strict=True):
            assert torch.equal(mine, theirs)
    assert ctl._program.launches_per_replay == 1


def _device_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.cuda
def test_cuda_the_visual_step_replays_its_eager_operations(cuda):
    from detex_tpu_torch.mpc import dynamics as D
    from detex_tpu_torch.mpc import mppi
    cfg = R.ControllerConfig(
        dynamics=D.DynamicsConfig(image_size=16, conv_features=(8, 16),
                                  latent_dim=32, hidden_dim=64),
        mppi=mppi.MPPIConfig(n_rollouts=256, horizon=8))
    params = D.init_params(cfg.dynamics, torch.Generator(cuda).manual_seed(
        22), cuda)
    goal = torch.zeros(32, device=cuda)
    ctl = R.Controller(params, goal, cfg, seed=23, device=cuda)
    words = traffic.observation_pool(np.random.default_rng(24), 1, 16)[0]
    ctl.step(words)
    program = ctl._program
    replayed = _device_ops(program._graph.replay)
    eager = _device_ops(program._body)
    assert program.launches_per_replay == 1
    assert replayed == eager > 0

"""The benchmark's own tests, on the CPU at small sizes (the card-only one
is marked `cuda` and skips where there is no card).

    python -m pytest dtxbench/tests -q
    # on a card (the root conftest imports jax):
    python -m pytest --noconftest -p no:cacheprovider -m cuda dtxbench/tests

They hold the files to the benchmark's rules (every cell found by name,
names and units in the allowed characters), the FLOP and byte counts to
hand counts, the references to the port, the harness to importing nothing
of jax or the JAX package, and `correct` to failing where it must: under
the control (the reference one precision lower in the program's place)
and under each planted fault of tests/faults.py.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dtxbench import common, flops, run, traffic
from dtxbench.reference import bptc as ref_bc7
from dtxbench.reference import visual_mpc as ref

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 977

TINY_DYNAMICS = {"image_size": 16, "channels": 4, "conv_features": [8, 16],
                 "latent_dim": 32, "action_dim": 8, "hidden_dim": 64,
                 "n_dynamics_layers": 2, "compute_dtype": "bfloat16"}
# The cells' horizon and weights (the configuration's served_out_scale):
# the rollouts stay bounded and MPPI's weights soft, as at the cells' widths.
TINY_MPPI = {"n_rollouts": 256, "horizon": 32, "action_dim": 8,
             "temperature": 1.0, "noise_sigma": 0.3, "action_low": -1.0,
             "action_high": 1.0}
# Per cell: (configuration entries, traffic parameters) at a size a test
# run holds.
TINY = {
    "visual_mpc_64.control": (
        {"dynamics": TINY_DYNAMICS, "mppi": TINY_MPPI},
        {"checked_steps": 24, "trace_seconds": 0.3}),
    "visual_mpc_64.control_dp4": (
        {"dynamics": TINY_DYNAMICS, "mppi": TINY_MPPI},
        {"checked_steps": 24, "trace_seconds": 0.3}),
    "texture_4k.bc7_rgba8": ({"width": 256, "height": 128},
                             {"trace_seconds": 0.3}),
    "visual_mpc_64.train_replay": (
        {"dynamics": TINY_DYNAMICS,
         "train": {"batch_size": 8, "lr": 3e-4, "weight_decay": 1e-5}},
        {"batches": 4, "pool_blocks": 64, "trace_seconds": 0.3}),
}


def measure(cell, seconds=1.0, trace=False, variant="program", prepare=None):
    config, params = TINY[cell]
    return run.measure(cell, SEED, seconds, trace, torch.device("cpu"),
                       variant, prepare, config, params)


# -- the files ---------------------------------------------------------------

def test_every_cell_is_found_by_name():
    for w in BENCH["workloads"]:
        cell, config = run.cell_files(w["name"])
        assert cell["config"] == w["config"] == config["name"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert (common.ROOT / "drivers" / f"{cell['driver']}.py").exists()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).exists()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for m in BENCH["per_layer"]:
        reader = m["name"].split(".")[0]
        assert (common.ROOT / "metrics" / f"{reader}.py").exists()


def test_names_units_and_keys_keep_to_the_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for w in CELLS:
        reported = [m for m in BENCH["end_to_end"]
                    if w in m.get("workloads", CELLS)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", CELLS) for m in BENCH["per_layer"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)


# -- the counts --------------------------------------------------------------

def test_flop_and_byte_counts_equal_hand_counts():
    config = json.loads((common.ROOT / "configs" / "visual_mpc_64.json")
                        .read_text())
    d, m = config["dynamics"], config["mppi"]
    # 2 x 8192 x 32 x (136*512 + 512*512 + 512*128)
    assert flops.rollout_flops(d, m) == 208_305_913_856
    # convs 2*32^2*32*4*9 + 3 * 9,437,184, proj 2*4096*128
    assert flops.encoder_flops(d) == 31_719_424
    assert flops.dynamics_flops(d) == 794_624
    assert flops.control_step_flops(d, m) == 208_305_913_856 + 31_719_424
    assert flops.train_flops_per_sample(d) == (
        2 * 31_719_424 + 794_624 + 2 * (31_719_424 + 794_624))
    assert flops.texture_least_s(1_048_576) == pytest.approx(25.04e-6,
                                                             rel=1e-3)


# -- the references against the port -------------------------------------------

def test_bc7_reference_equals_the_ports_plain_decoder():
    from detex_tpu_torch.ops import bptc
    rng = np.random.default_rng(5)
    blocks = traffic.bc7_blocks(rng, 4096)
    blocks[:64, 0] = 0                              # no mode: invalid
    pix, valid = ref_bc7.decode(torch.from_numpy(blocks))
    words = torch.from_numpy(traffic.words(blocks))
    port, port_valid = bptc.decode_bptc(words)
    port_bytes = port.numpy().view(np.uint8).reshape(-1, 16, 4)
    assert np.array_equal(valid.numpy(), port_valid.numpy())
    ok = valid.numpy()
    assert np.array_equal(pix.numpy()[ok], port_bytes[ok])
    assert not pix.numpy()[~ok].any()


def test_the_texture_traffic_holds_invalid_blocks():
    share = json.loads((common.ROOT / "workloads" / "texture_4k.bc7_rgba8.json")
                       .read_text())["params"]["invalid_share"]
    blocks = traffic.bc7_blocks(np.random.default_rng(8), 4096, None, share)
    assert (blocks[:, 0] == 0).sum() == round(4096 * share) > 0
    valid = traffic.bc7_blocks(np.random.default_rng(8), 4096)
    assert (valid[:, 0] != 0).all()
    pix, ok = ref_bc7.decode(torch.from_numpy(blocks))
    assert (~ok).sum() == round(4096 * share) and not pix[~ok].any()


def test_bc7_control_breaks_bit_exactness():
    blocks = torch.from_numpy(traffic.bc7_blocks(np.random.default_rng(6),
                                                 128))
    exact = ref_bc7.texture(blocks, 64, 32, "RGBA8")
    low = ref_bc7.texture(blocks, 64, 32, "RGBA8", control=True)
    assert exact.shape == low.shape and (exact != low).sum() > 0


def _port_params(params):
    return {part: {n: {k: v.clone() for k, v in layer.items()}
                   for n, layer in layers.items()}
            for part, layers in params.items()}


def test_visual_mpc_reference_equals_the_port():
    from detex_tpu_torch.mpc import dynamics as D
    from detex_tpu_torch.mpc import mppi
    from dtxbench.drivers import control
    gen = torch.Generator().manual_seed(3)
    d = TINY_DYNAMICS
    params = ref.init_params(d, gen)
    cfg = control.controller_config({"dynamics": d, "mppi": TINY_MPPI,
                                     "controller": {
                                         "n_ilqr_iterations": 0,
                                         "goal_weight": 1.0,
                                         "control_weight": 0.1}}, {})
    port_gen = torch.Generator().manual_seed(3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        ref.leaves(params), ref.leaves(D.init_params(cfg.dynamics, port_gen))))
    images = torch.randint(0, 256, (3, 16, 16, 4), generator=gen)
    z = ref.encode(params, images.to(torch.uint8), ref.BF16)
    assert torch.equal(z, D.encode(_port_params(params), images.to(torch.int32),
                                   cfg.dynamics))
    u = torch.rand((3, 8), generator=gen)
    assert torch.equal(ref.dynamics(params, z, u, ref.BF16),
                       D.dynamics_apply(params, z, u, cfg.dynamics))
    m = TINY_MPPI
    goal = torch.randn((d["latent_dim"],), generator=gen)
    eps = torch.randn((m["n_rollouts"], m["horizon"], 8), generator=gen) * 0.3
    nominal = torch.rand((m["horizon"], 8), generator=gen) - 0.5
    plan, _, beta = ref.mppi_update(params, z[0], goal, nominal, eps,
                                    TINY_MPPI, {"goal_weight": 1.0,
                                                "control_weight": 0.1},
                                    ref.BF16)

    def cost(zz, uu, t):
        return (torch.sum((zz - goal) ** 2, dim=-1)
                + 0.1 * torch.sum(uu ** 2, dim=-1))
    port_plan, diag = mppi.mppi_step(
        nominal, z[0], lambda zz, uu: D.dynamics_apply(params, zz, uu,
                                                       cfg.dynamics),
        cost, cfg.mppi, eps=eps)
    torch.testing.assert_close(plan, port_plan, rtol=0, atol=1e-6)
    torch.testing.assert_close(beta, diag["min_cost"], rtol=1e-6, atol=0)
    batch = {"obs": images[:2].to(torch.int32),
             "next_obs": images[1:].to(torch.int32),
             "action": u[:2]}
    want = ref.loss(params, images[:2].to(torch.uint8), u[:2],
                    images[1:].to(torch.uint8), ref.BF16)
    got = D.loss_fn(params, batch, cfg.dynamics)
    torch.testing.assert_close(want, got, rtol=1e-6, atol=0)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_at_a_small_size(cell):
    result = measure(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_traced_run_reports_per_layer_metrics_only():
    result = measure("visual_mpc_64.control", trace=True)
    assert result["correct"]
    names = {m["name"] for m in BENCH["per_layer"]}
    assert set(result["metrics"]) <= names
    assert "control_step_p95_ms" in result["metrics"]
    assert result["device"]["window_s"] > 0


# -- what must come out not correct --------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    assert not measure(cell, variant="control")["correct"]


FAULTS = [
    ("visual_mpc_64.control", "control_state_unchanged"),
    ("visual_mpc_64.control", "control_half_batch"),
    ("visual_mpc_64.control", "control_answer_altered"),
    ("visual_mpc_64.control_dp4", "exchange_left_out"),
    ("visual_mpc_64.control_dp4", "control_half_batch"),
    ("texture_4k.bc7_rgba8", "texture_half_batch"),
    ("texture_4k.bc7_rgba8", "texture_invalid_not_zeroed"),
    ("texture_4k.bc7_rgba8", "texture_answer_altered"),
    ("visual_mpc_64.train_replay", "train_state_unchanged"),
    ("visual_mpc_64.train_replay", "train_half_batch"),
    ("visual_mpc_64.train_replay", "train_answer_altered"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    # In a child process: a fault patches the program for good.
    code = (
        "import sys, torch\n"
        "from dtxbench.tests import test_dtxbench_harness as T\n"
        f"r = T.measure({cell!r}, prepare='dtxbench.tests.faults:{fault}')\n"
        "print('CORRECT', r['correct'], r['checks'])\n")
    out = _child(code)
    assert "CORRECT False" in out, out


# -- nothing of jax ------------------------------------------------------------

def _child(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["detex_tpu_torch_x"] = sys.modules["dtxbench"]
        assert "detex_tpu_torch_x" not in common.forbidden_modules()
        sys.modules["detex_tpu.sub"] = sys.modules["dtxbench"]
        assert "detex_tpu.sub" in common.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    code = (
        "import sys, torch\n"
        "from dtxbench.tests import test_dtxbench_harness as T\n"
        "from dtxbench import common\n"
        "for cell in T.CELLS:\n"
        "    r = T.measure(cell, seconds=0.3, trace=cell.endswith('control'))\n"
        "    assert r['correct'], cell\n"
        "print('FORBIDDEN', common.forbidden_modules())\n")
    out = _child(code)
    assert "FORBIDDEN []" in out, out


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "dtxbench.run", "--workload",
         "visual_mpc_64.control", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run(
        [sys.executable, "-m", "dtxbench.run", "--workload",
         "visual_mpc_64.control", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]

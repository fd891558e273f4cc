"""The port's benches (detex_tpu_torch/tools/bench_{control_step,
train_step,pipelines}.py) on the CPU at a tiny size: each main prints JSON
lines whose keys include those of the JAX tool's rows (read from
tools/bench_*.py's dict literals), and its built-in correctness check
passes, and fails when the path it checks is broken.

Tests marked `cuda` run the benches on a card and skip here.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from detex_tpu_torch import tools
from detex_tpu_torch.mpc import runtime as R
from detex_tpu_torch.ops import etc
from detex_tpu_torch.tools import bench_control_step as BC
from detex_tpu_torch.tools import bench_pipelines as BP
from detex_tpu_torch.tools import bench_train_step as BT

_REPO = Path(__file__).resolve().parent.parent

_CONTROL = ["--rollouts", "64", "--horizon", "4", "--warmup", "2",
            "--steps", "5"]
_TRAIN = ["--batch", "2", "--image-size", "16", "--warmup", "1",
          "--steps", "3"]
_PIPELINES = ["--side", "16", "--batch", "2", "--image-size", "16",
              "--warmup", "1", "--steps", "3"]


def _jax_keys(tool: str) -> dict:
    """metric -> the keys of each dict literal with a "metric" key in
    tools/<tool>.py (its JSON rows)."""
    tree = ast.parse((_REPO / "tools" / f"{tool}.py").read_text())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            names = [k.value for k in node.keys
                     if isinstance(k, ast.Constant)]
            if "metric" in names:
                metric = node.values[names.index("metric")].value
                keys[metric] = set(names)
    return keys


def _rows(capsys, main, argv) -> list:
    rows = main(argv)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert rows and printed == json.loads(json.dumps(rows))
    return rows


def _has_jax_keys(rows, tool):
    want = _jax_keys(tool)
    assert {r["metric"] for r in rows} == set(want)
    for r in rows:
        assert want[r["metric"]] <= set(r), (r["metric"],
                                             want[r["metric"]] - set(r))
        assert r["platform"] == "cpu" and r["device"] == "cpu"


def test_jax_keys_are_read():
    assert _jax_keys("bench_control_step")["control_step_ms"] >= {
        "ms_per_step", "within_10ms_budget", "backward"}
    assert "decode_share_pct" in _jax_keys("bench_train_step")[
        "compressed_obs_train_step"]
    assert set(_jax_keys("bench_pipelines")) == {
        "etc2_eac_texture_to_rgba8_blocks_per_s",
        "bc6h_hdr_to_latent_images_per_s"}


def test_bench_control_step_cpu(capsys):
    rows = _rows(capsys, BC.main, ["--device", "cpu", *_CONTROL,
                                   "--wallclock"])
    _has_jax_keys(rows, "bench_control_step")
    steps = [r for r in rows if r["metric"] == "control_step_ms"]
    assert [(r["ilqr_iterations"], r["backward"]) for r in steps] == [
        (0, "n/a"), (2, "seq"), (2, "parallel-lqt")]
    for r in steps:
        # The CPU has only the eager program (a CUDA graph needs a card).
        assert r["program"] == "eager" and r["capture_s"] is None
        assert r["first_action_atol"] == BC.ATOL
        assert r["p10_ms"] <= r["ms_per_step"] <= r["p90_ms"]
        assert r["steps"] == 5 and r["first_action_max_diff"] <= BC.ATOL
        assert r["within_10ms_budget"] == (r["ms_per_step"] <= 10.0)
        assert np.isfinite(r["first_action"]).all()
    # MPPI's action stays within its bounds; iLQR's need not (ROADMAP).
    assert np.abs(steps[0]["first_action"]).max() <= 1.0
    assert [(r["pipelined"], r["program"]) for r in rows[3:]] == [
        (False, "eager"), (True, "eager")]


def test_bench_control_step_check_bites(monkeypatch):
    """The first action is held to a fresh Controller's: a Controller that
    answers otherwise fails the bench."""
    step = R.Controller.step
    monkeypatch.setattr(R.Controller, "step",
                        lambda self, obs: step(self, obs) + 1e-3)
    with pytest.raises(AssertionError, match="Controller"):
        BC.main(["--device", "cpu", *_CONTROL, "--ilqr", "0"])


def test_bench_train_step_cpu(capsys):
    rows = _rows(capsys, BT.main, ["--device", "cpu", *_TRAIN])
    _has_jax_keys(rows, "bench_train_step")
    r = rows[0]
    assert r["batch"] == 2 and r["decode_blocks_per_step"] == 2 * 2 * 16
    assert r["model"] == "latent-128/hidden-512 f32"
    assert abs(r["first_loss"] - r["first_loss_train_step"]) <= \
        BT.RTOL * abs(r["first_loss_train_step"])
    assert r["decode_overhead_ms"] == pytest.approx(
        r["ms_per_step_compressed"] - r["ms_per_step_raw_obs"])


def test_bench_pipelines_cpu(capsys):
    rows = _rows(capsys, BP.main, ["--device", "cpu", *_PIPELINES])
    _has_jax_keys(rows, "bench_pipelines")
    etc_row, bc6h_row = rows
    assert etc_row["side"] == 16 and etc_row["bytes_equal_native"]
    assert bc6h_row["latent_max_diff_vs_plain"] == 0.0
    assert [r["metric"] for r in _rows(capsys, BP.main, [
        "--device", "cpu", *_PIPELINES, "bc6h"])] == [
        "bc6h_hdr_to_latent_images_per_s"]


def test_bench_pipelines_check_bites(monkeypatch):
    """The ETC2_EAC image is held to the native decode: a decoder with one
    bit flipped fails the bench."""
    decode = etc.decode_etc2_eac

    def wrong(words, mode_mask=0xFFFFFFFF, flags=0):
        pix, valid = decode(words, mode_mask, flags)
        return pix ^ 0x100, valid
    monkeypatch.setattr(etc, "decode_etc2_eac", wrong)
    with pytest.raises(AssertionError, match="native"):
        BP.main(["--device", "cpu", *_PIPELINES, "etc"])


def test_step_times_and_spread():
    calls = []
    card, host = tools.step_times(calls.append, torch.device("cpu"), 2, 4)
    assert calls == list(range(6)) and len(card) == len(host) == 4
    s = tools.spread([1.0, 2.0, 3.0, 4.0, 100.0])
    assert s["median"] == 3.0 and s["p10"] < 2.0 and s["p90"] > 4.0


@pytest.mark.parametrize("main", [BC.main, BT.main, BP.main])
def test_benches_default_to_the_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("main,argv", [
    (BC.main, [*_CONTROL, "--wallclock"]),
    (BT.main, _TRAIN), (BP.main, _PIPELINES)])
def test_cuda_benches(cuda, capsys, main, argv):
    rows = _rows(capsys, main, argv)
    for r in rows:
        assert r["platform"] == "cuda" and "W" in r["device"]
        for k, v in r.items():
            if k.endswith("launches_per_step"):
                assert v >= 1, (k, v)

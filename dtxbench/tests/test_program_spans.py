"""The readers of the program's own spans (metrics/program_spans.py and the
six `*_host_*_ms`, `control_wait_ms` readers): each leaves its metric out
where there is nothing to read (no summary, no window, a program without
detex_tpu_torch/utils/trace.py, no such span), a traced CPU run of each
one-card cell reports its own, and the four-card cell, whose readers run
where no rank's totals are, reports none of them.  The card-only case
(marked `cuda`) holds the program's spans off the device's records.

    python -m pytest dtxbench/tests/test_program_spans.py -q
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import types

import pytest
import torch

from dtxbench.tests.test_dtxbench_harness import BENCH, REPO, SEED, measure

NEW = {"control_host_ms": "visual_mpc_64.control",
       "control_wait_ms": "visual_mpc_64.control",
       "texture_host_words_ms": "texture_4k.bc7_rgba8",
       "texture_host_upload_ms": "texture_4k.bc7_rgba8",
       "texture_host_copy_out_ms": "texture_4k.bc7_rgba8",
       "train_host_stage_ms": "visual_mpc_64.train_replay"}
TRACE = "detex_tpu_torch.utils.trace"
WINDOW = {"window_s": 2.0, "work": {}}


def _reader(name):
    return importlib.import_module(f"dtxbench.metrics.{name}")


@pytest.fixture
def recorded():
    """Totals of every span the six readers read, as a traced part leaves
    them."""
    trace = importlib.import_module(TRACE)
    trace.reset()
    trace.enable(True)
    for name in ("dtx.control.step", "dtx.control.wait", "dtx.texture.words",
                 "dtx.texture.upload", "dtx.texture.copy_out",
                 "dtx.train.stage"):
        with trace.span(name):
            pass
    trace.enable(False)
    yield trace
    trace.reset()


def test_the_entries_name_one_card_cells_and_their_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["workloads"] == [cell]
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower",
                                                         "host_clock")
        assert _reader(name).read is not None
    four = {w["name"] for w in BENCH["workloads"] if w["chips"] == 4}
    assert not any(c in four for c in NEW.values())


@pytest.mark.parametrize("name", sorted(NEW))
@pytest.mark.parametrize("summary", [None, {}, {"window_s": None},
                                     {"work": {"steps": 3}}])
def test_no_window_reads_nothing(name, summary, recorded):
    assert _reader(name).read(summary) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_the_module_reads_nothing(name, recorded,
                                                    monkeypatch):
    assert _reader(name).read(WINDOW) is not None
    monkeypatch.setitem(sys.modules, TRACE, None)
    assert _reader(name).read(WINDOW) is None
    monkeypatch.setitem(sys.modules, TRACE, types.ModuleType(TRACE))
    assert _reader(name).read(WINDOW) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_empty_totals_read_nothing(name):
    importlib.import_module(TRACE).reset()
    assert _reader(name).read(WINDOW) is None


def test_the_readers_read_a_mean_a_span(recorded):
    spans = recorded.snapshot()["spans"]
    assert _reader("control_wait_ms").read(WINDOW) == pytest.approx(
        1e3 * spans["dtx.control.wait"]["total_s"])
    assert _reader("control_host_ms").read(WINDOW) == pytest.approx(
        1e3 * (spans["dtx.control.step"]["total_s"]
               - spans["dtx.control.wait"]["total_s"]))


@pytest.mark.parametrize("cell", sorted(set(NEW.values())))
def test_a_traced_cpu_run_reports_its_new_metrics(cell):
    result = measure(cell, seconds=0.6, trace=True)
    assert result["correct"], result["checks"]
    mine = {n for n, c in NEW.items() if c == cell}
    assert mine <= set(result["metrics"])
    assert not (set(NEW) - mine) & set(result["metrics"])
    for name in mine:
        assert result["metrics"][name]["value"] > 0
        assert result["metrics"][name]["unit"] == "ms"


@pytest.mark.parametrize("cell", sorted(set(NEW.values())))
def test_a_traced_run_of_a_program_without_spans_leaves_them_out(
        cell, monkeypatch):
    # The program's modules are loaded first: only the readers' import of
    # the tracing module fails, as in a program that has none.
    for module in ("engine", "mpc.runtime", "mpc.train_loop"):
        importlib.import_module(f"detex_tpu_torch.{module}")
    monkeypatch.setitem(sys.modules, TRACE, None)
    result = measure(cell, seconds=0.6, trace=True)
    assert result["correct"]
    assert not set(NEW) & set(result["metrics"])


def test_the_four_card_cell_reports_none_of_them():
    code = (
        "from dtxbench.tests import test_dtxbench_harness as T\n"
        "import json\n"
        "r = T.measure('visual_mpc_64.control_dp4', seconds=0.6, "
        "trace=True)\n"
        "print('METRICS', json.dumps(sorted(r['metrics'])), r['correct'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("METRICS "))
    names = json.loads(line.split(" ", 1)[1].rsplit(" ", 1)[0])
    assert line.endswith(" True")
    assert not set(NEW) & set(names)
    assert "control_step_p95_ms" in names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CPU trace holds no device "
                    "records)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(set(NEW.values())))
def test_cuda_no_program_span_among_the_device_records(card, cell):
    proc = subprocess.run(
        [sys.executable, "-m", "dtxbench.run", "--workload", cell, "--seed",
         str(SEED), "--seconds", "4", "--trace", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"]
    ops = [n for n, _ in result["breakdown"]["device_ops"]]
    assert not [n for n in ops if n.startswith("dtx.")], ops
    assert {n for n, c in NEW.items() if c == cell} <= set(result["metrics"])
    if cell == "texture_4k.bc7_rgba8":
        gaps = [n for n, _ in result["breakdown"]["idle_gaps"]]
        assert any(n.startswith("dtx.texture.") for n in gaps), gaps

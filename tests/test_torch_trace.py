"""The port's spans and copy counters (detex_tpu_torch/utils/trace.py): off
unless a profiler runs or enable() asks; decided when a span is entered;
recorded by an exception and past a profiler stopped inside; the stages
of Controller.step, the texture engine and train() on the CPU, none inside
a captured body; snapshot() beside the existing counters.  Tests marked
`cuda` count the bytes each way at the benchmark cells' shapes and the
captures a key makes, and skip here.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detex_tpu_torch import engine, graphs
from detex_tpu_torch import formats as F
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.mpc import train_loop as TT
from detex_tpu_torch.parallel import mesh as mesh_mod
from detex_tpu_torch.texture import Texture
from detex_tpu_torch.utils import trace
from detex_tpu_torch.utils.metrics import MetricsLogger

_DYN = TD.DynamicsConfig(image_size=16, conv_features=(8, 16), latent_dim=32,
                         action_dim=8, hidden_dim=64,
                         compute_dtype=torch.float32)
_CTL = TR.ControllerConfig(dynamics=_DYN, mppi=TM.MPPIConfig(
    n_rollouts=64, horizon=4, action_dim=8))


@pytest.fixture(autouse=True)
def fresh():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _spans():
    return trace.snapshot()["spans"]


def _counts(prefix):
    return {k: v["count"] for k, v in _spans().items()
            if k.startswith(prefix)}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _words(n_blocks, seed):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, (n_blocks, 4), np.int64).astype(np.int32)


def _controller(cls=TR.Controller):
    gen = torch.Generator().manual_seed(0)
    params = TD.init_params(_DYN, gen)
    return cls(params, torch.zeros(_DYN.latent_dim), _CTL, seed=1,
               device="cpu")


def _bc7_texture(side, seed):
    blocks = np.random.default_rng(seed).integers(
        0, 256, ((side // 4) ** 2, 16), np.uint8)
    blocks[:, 0] |= 0x40                      # mode 6: every block valid
    return Texture.new(F.BPTC, blocks.ravel(), side, side)


# -- the module --------------------------------------------------------------

def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    a, b = trace.span("dtx.test.a"), trace.span("dtx.test.b")
    assert a is b is trace._NO_SPAN
    with a:
        trace.count("dtx.test.n", 5)
        trace.count_copy(torch.zeros(4), "cpu")
    assert trace.snapshot()["spans"] == {} and trace.snapshot()["counts"] == {}


def test_under_the_profiler_a_span_is_a_host_range_and_counted():
    with _cpu_profile() as prof:
        with trace.span("dtx.test.a"):
            torch.ones(3).add_(1)
        with trace.span("dtx.test.a"):
            pass
        trace.count("dtx.test.n", 3)
    names = [e.name for e in prof.events()]
    assert names.count("dtx.test.a") == 2
    # A host operation's range: not a user annotation, which the profiler
    # would also draw on a card's timeline.
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "dtx.test.a")
    total = _spans()["dtx.test.a"]
    assert total["count"] == 2
    assert 0 < total["max_s"] <= total["total_s"]
    assert trace.snapshot()["counts"] == {"dtx.test.n": 3}


def test_a_span_entered_before_the_profiler_records_nothing():
    with trace.span("dtx.test.before"):
        with _cpu_profile() as prof:
            with trace.span("dtx.test.inside"):
                pass
    assert set(_spans()) == {"dtx.test.inside"}
    assert "dtx.test.before" not in [e.name for e in prof.events()]


def test_a_span_the_profiler_stops_inside_is_recorded():
    prof = _cpu_profile()
    prof.__enter__()
    with trace.span("dtx.test.outer"):
        prof.__exit__(None, None, None)
        with trace.span("dtx.test.after"):
            pass
    assert set(_spans()) == {"dtx.test.outer"}


def test_a_span_left_by_an_exception_is_recorded():
    with _cpu_profile():
        with pytest.raises(KeyError):
            with trace.span("dtx.test.raised"):
                raise KeyError("stop")
    assert _spans()["dtx.test.raised"]["count"] == 1


def test_enable_records_without_a_profiler_and_reset_forgets():
    trace.enable(True)
    with trace.span("dtx.test.a"):
        trace.count("dtx.test.n", 2)
    trace.count_copy(torch.zeros(4), "cpu")      # host to host: no count
    assert _spans()["dtx.test.a"]["count"] == 1
    assert trace.snapshot()["counts"] == {"dtx.test.n": 2}
    trace.reset()
    assert trace.snapshot()["spans"] == {} and trace.snapshot()["counts"] == {}


def test_snapshot_carries_the_existing_counters_unchanged():
    before = dict(mesh_mod.COLLECTIVE_BYTES)
    mesh_mod.COLLECTIVE_BYTES[("all_reduce_sum", "dp")] += 40
    try:
        snap = trace.snapshot()
        assert snap["launches"] == graphs.launch_counts()
        assert snap["collective_bytes"] == dict(mesh_mod.COLLECTIVE_BYTES)
    finally:
        mesh_mod.COLLECTIVE_BYTES.clear()
        mesh_mod.COLLECTIVE_BYTES.update(before)


# -- the program's stages on the CPU --------------------------------------------

@pytest.mark.parametrize("cls", [TR.Controller, TR.PipelinedController])
def test_a_cpu_controller_records_its_stages_once_a_step(cls):
    ctl = _controller(cls)
    obs = [_words(16, i) for i in range(3)]
    ctl.step(obs[0])                        # off: nothing recorded
    with _cpu_profile() as prof:
        for w in obs:
            ctl.step(w)
    names = [e.name for e in prof.events()]
    assert names.count("dtx.control.step") == 3
    assert _counts("dtx.control.") == {
        "dtx.control.step": 3, "dtx.control.load": 3,
        "dtx.control.plan": 3, "dtx.control.wait": 3}
    assert "dtx.h2d_bytes" not in trace.snapshot()["counts"]


def test_a_cpu_texture_call_records_its_stages_and_counts_no_bytes():
    tex = _bc7_texture(32, 4)
    want = engine.decompress_texture_linear(tex, F.RGBA8, backend="device",
                                            device="cpu")
    with _cpu_profile():
        for _ in range(2):
            got = engine.decompress_texture_linear(
                tex, F.RGBA8, backend="device", device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _counts("dtx.texture.") == {
        "dtx.texture.words": 2, "dtx.texture.upload": 2,
        "dtx.texture.copy_out": 2}
    assert trace.snapshot()["counts"] == {}


def test_cpu_train_records_its_loop():
    cfg = TT.TrainConfig(dynamics=dataclasses.replace(_DYN), batch_size=2,
                         n_steps=3, compressed_obs=True)
    trace.enable(True)
    TT.train(cfg, metrics=MetricsLogger(io.StringIO()), device="cpu")
    counts = _counts("dtx.train.")
    assert counts["dtx.train.step"] == counts["dtx.train.env"] == 3
    assert counts["dtx.train.stage"] == counts["dtx.train.launch"] == 3
    assert counts["dtx.train.wait"] == 2          # the loss read at steps 0, 2
    assert "dtx.train.checkpoint" not in counts


def test_no_span_sits_inside_a_captured_body():
    """The bodies a graph captures (the control step's, the train step's,
    the texture pipeline's) run with recording on and record nothing."""
    trace.enable(True)
    gen = torch.Generator().manual_seed(0)
    params = TD.init_params(_DYN, gen)
    nominal = torch.zeros((_CTL.mppi.horizon, _CTL.mppi.action_dim))
    eps = torch.zeros((_CTL.mppi.n_rollouts, _CTL.mppi.horizon,
                       _CTL.mppi.action_dim))
    TR.step_body(params, nominal, torch.from_numpy(_words(16, 1)),
                 torch.zeros(_DYN.latent_dim), eps, _CTL)
    opt = TD.make_optimizer(params, 1e-3)
    batch = {"obs_words": torch.from_numpy(np.stack([_words(16, 2)] * 2)),
             "next_obs_words": torch.from_numpy(np.stack([_words(16, 3)] * 2)),
             "action": torch.zeros((2, _DYN.action_dim))}
    TT.train_body(params, opt, batch, _DYN, True)
    body = engine._pipeline_body(F.BPTC, F.RGBA8, 4, 4, 16, 16, False,
                                 0xFFFFFFFF, 0)
    body(torch.from_numpy(_words(16, 4)))
    assert trace.snapshot()["spans"] == {}


# -- on a card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the byte counters count host <-> "
                    "card copies; CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")


@pytest.mark.cuda
def test_cuda_a_4096_bc7_call_counts_its_bytes_each_way(cuda):
    tex = _bc7_texture(4096, 7)
    for _ in range(3):                      # eager, captured, replayed
        engine.decompress_texture_linear(tex, F.RGBA8, backend="device",
                                         device=cuda)
    trace.enable(True)
    out = engine.decompress_texture_linear(tex, F.RGBA8, backend="device",
                                           device=cuda)
    assert out.size == 4096 * 4096 * 4
    snap = trace.snapshot()
    assert snap["counts"] == {"dtx.h2d_bytes": 16_777_216,
                              "dtx.d2h_bytes": 67_108_864,
                              "dtx.pinned_copies": 2,
                              "dtx.pinned_bytes": 83_886_080}
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        "dtx.texture.words": 1, "dtx.texture.upload": 1,
        "dtx.texture.run": 1, "dtx.texture.copy_out": 1}


@pytest.mark.cuda
def test_cuda_a_control_step_counts_its_bytes_each_way(cuda):
    cfg = TR.ControllerConfig()
    gen = torch.Generator(device=cuda).manual_seed(0)
    ctl = TR.Controller(TD.init_params(cfg.dynamics, gen, cuda),
                        torch.zeros(cfg.dynamics.latent_dim, device=cuda),
                        cfg, seed=1, device=cuda)
    words = _words((cfg.dynamics.image_size // 4) ** 2, 5)
    ctl.step(words)                         # the capture
    trace.enable(True)
    for _ in range(2):
        ctl.step(words)
    snap = trace.snapshot()
    assert snap["counts"] == {"dtx.h2d_bytes": 2 * 4_096,
                              "dtx.d2h_bytes": 2 * 32}
    assert _counts("dtx.control.") == {
        "dtx.control.step": 2, "dtx.control.load": 2,
        "dtx.control.plan": 2, "dtx.control.wait": 2}


@pytest.mark.cuda
def test_cuda_a_train_step_counts_its_batch(cuda):
    dcfg = TD.DynamicsConfig(image_size=32, conv_features=(16, 32),
                             latent_dim=32, action_dim=4, hidden_dim=64)
    cfg = TT.TrainConfig(dynamics=dcfg, batch_size=16, n_steps=3,
                         compressed_obs=True)
    trace.enable(True)
    TT.train(cfg, metrics=MetricsLogger(io.StringIO()), device=cuda)
    words = 16 * (32 // 4) ** 2 * 4 * 4
    assert trace.snapshot()["counts"] == {
        "dtx.h2d_bytes": 3 * (2 * words + 16 * 4 * 4),
        "dtx.graph.captures": 1}
    assert _counts("dtx.train.stage") == {"dtx.train.stage": 3}


@pytest.mark.cuda
def test_cuda_one_capture_per_captured_key(cuda):
    graphs._PROGRAMS.clear()
    trace.enable(True)
    for side in (64, 128):
        tex = _bc7_texture(side, side)
        for _ in range(4):
            engine.decompress_texture_linear(tex, F.RGBA8, backend="device",
                                             device=cuda)
    snap = trace.snapshot()
    assert snap["counts"]["dtx.graph.captures"] == 2
    assert snap["spans"]["dtx.graph.capture"]["count"] == 2
    assert snap["spans"]["dtx.texture.run"]["count"] == 8

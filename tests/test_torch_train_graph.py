"""The train step's one-program form (mpc/train_loop.py: train_body,
_TrainGraph, save_step_state / restore_step_state; graphs.py; dynamics.
make_optimizer): on the CPU, the body the CUDA graph captures, run eagerly
on its batch, against the JAX package's jitted visual_step
(detex_tpu/mpc/train_loop.py:218-233); the state put back around the
capture's warm-ups; the CPU trainer staying eager; the launch counts and
the program cache of graphs.py.  Tests marked `cuda` hold the graphed
train() to the eager card step and skip here.

Tolerances (float32 compute; the BC7 decode is bit-exact), as
tests/test_torch_train.py states them for three steps from a non-fresh
optimizer state: loss rtol 1e-5, parameters rtol 1e-5 / atol 1e-6.  The
state restored after the warm-ups is bit-equal to the state saved before
them.  On the card the graph replays the eager step's own kernels with
cuDNN held to its deterministic algorithms: graphed and eager losses and
parameters bit-equal.
"""

import collections
import copy
import dataclasses
import gc
import io
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detex_tpu_torch import graphs
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import train_loop as TT
from detex_tpu_torch.ops import bc, bptc
from detex_tpu_torch.utils.metrics import MetricsLogger

_SHAPE = dict(image_size=16, conv_features=(8, 16), latent_dim=16,
              action_dim=4, hidden_dim=32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's training modules."""
    import jax
    import jax.numpy as jnp

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import train_loop
    return SimpleNamespace(jax=jax, jnp=jnp, JD=dynamics, JT=train_loop)


def _tcfg():
    return TD.DynamicsConfig(compute_dtype=torch.float32, **_SHAPE)


def _word_batches(n, batch_size=8, seed=3):
    """n BC7-compressed batches of the port's SyntheticVisualEnv (byte-equal
    to the JAX env's, tests/test_torch_train.py)."""
    env = TT.SyntheticVisualEnv(_tcfg(), 0, compressed=True)
    rng = np.random.default_rng(seed)
    return [env.sample_batch(rng, batch_size) for _ in range(n)]


def _tensors(batch, device="cpu"):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def test_train_body_vs_jax_visual_step(jx):
    """From the same parameters and the same non-fresh optimizer state
    (two JAX steps on raw images first), three train_body steps on BC7
    words against JAX's make_train_step(..., compressed_obs=True): the
    losses and the final parameters."""
    jax, jnp, JD, JT = jx.jax, jx.jnp, jx.JD, jx.JT
    jcfg = JD.DynamicsConfig(compute_dtype=jnp.float32, **_SHAPE)
    jp = JD.init_params(jax.random.PRNGKey(9), jcfg)
    opt = JD.make_optimizer()
    state = opt.init(jp)
    raw = jax.jit(lambda p, s, b: JD.train_step(p, s, b, jcfg, opt))
    rng = np.random.default_rng(4)
    for _ in range(2):
        b = {"obs": rng.integers(0, 256, (8, 16, 16, 4)).astype(np.uint8),
             "action": rng.uniform(-1, 1, (8, 4)).astype(np.float32),
             "next_obs": rng.integers(0, 256, (8, 16, 16, 4))
             .astype(np.uint8)}
        jp, state, _ = raw(jp, state, jax.tree.map(jnp.asarray, b))
    tp = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    topt = TD.make_optimizer(tp)
    TD.opt_state_from_jax(topt, jax.tree.map(np.asarray, state[0]))
    visual = JT.make_train_step(jcfg, opt, compressed_obs=True)
    tcfg = _tcfg()
    for b in _word_batches(3):
        jp, state, jloss = visual(jp, state, jax.tree.map(jnp.asarray, b))
        tloss = TT.train_body(tp, topt, _tensors(b), tcfg, True)
        assert tloss.shape == ()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    for got, ref in zip(TD.param_leaves(tp), TD.param_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)


def _model(seed=0):
    params = TD.init_params(_tcfg(), torch.Generator().manual_seed(seed),
                            "cpu")
    return params, TD.make_optimizer(params)


def _clone_model(params, optimizer):
    p = {part: {n: {k: v.detach().clone() for k, v in layer.items()}
                for n, layer in layers.items()}
         for part, layers in params.items()}
    opt = TD.make_optimizer(p)
    # A deep copy: load_state_dict keeps tensors already of the right
    # dtype and device, so the two optimizers would share their moments.
    opt.load_state_dict(copy.deepcopy(optimizer.state_dict()))
    return p, opt


@pytest.mark.parametrize("fresh", [True, False])
def test_restore_after_warmups_is_bit_equal(fresh):
    """The capture's reset: two train steps (the warm-ups) then
    restore_step_state leave the parameters, the moments and the step
    count bit-equal to what save_step_state saw (zero where the optimizer
    was fresh), in the same tensors; the step after it equals the first
    step of an untouched copy, bit for bit."""
    params, opt = _model()
    batches = [_tensors(b) for b in _word_batches(4)]
    if not fresh:
        TT.train_body(params, opt, batches[3], _tcfg(), True)
    ref_params, ref_opt = _clone_model(params, opt)
    saved = TT.save_step_state(params, opt)
    for b in batches[:2]:
        TT.train_body(params, opt, b, _tcfg(), True)
    before = TT._step_state(params, opt)
    assert len(before) == 4 * len(TD.param_leaves(params))
    TT.restore_step_state(params, opt, saved)
    after = TT._step_state(params, opt)
    assert all(a is b for a, b in zip(after, before))
    n = len(TD.param_leaves(params))
    want = saved if not fresh else saved + [
        torch.zeros_like(t) for t in after[n:]]
    for got, ref in zip(after, want, strict=True):
        assert torch.equal(got, ref)
    loss = TT.train_body(params, opt, batches[2], _tcfg(), True)
    ref_loss = TT.train_body(ref_params, ref_opt, batches[2], _tcfg(), True)
    assert torch.equal(loss, ref_loss)
    for got, ref in zip(TT._step_state(params, opt),
                        TT._step_state(ref_params, ref_opt), strict=True):
        assert torch.equal(got, ref)


def test_make_optimizer_is_not_capturable_on_the_cpu():
    _, opt = _model()
    assert all(g["capturable"] is False for g in opt.param_groups)


def test_cpu_train_stays_eager(monkeypatch):
    """The CPU trainer steps through make_train_step, never a graph."""
    def refuse(*a, **k):
        raise AssertionError("a graph on the CPU")
    monkeypatch.setattr(TT, "_TrainGraph", refuse)
    calls = []
    make = TT.make_train_step

    def counted(*a, **k):
        calls.append(a)
        return make(*a, **k)
    monkeypatch.setattr(TT, "make_train_step", counted)
    cfg = TT.TrainConfig(dynamics=_tcfg(), batch_size=4, n_steps=2,
                         compressed_obs=True)
    _, _, loss = TT.train(cfg, MetricsLogger(io.StringIO()), device="cpu")
    assert len(calls) == 1 and np.isfinite(loss)


def test_graphs_refuse_the_cpu():
    params, opt = _model()
    with pytest.raises(ValueError, match="CUDA"):
        TT._TrainGraph(params, opt, _tcfg(), 4, True)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.Graph("cpu")


def test_launch_counts_round_trip(monkeypatch):
    monkeypatch.setattr(bptc, "KERNEL_LAUNCHES", 5)
    monkeypatch.setattr(bc, "KERNEL_LAUNCHES", dict(bc.KERNEL_LAUNCHES,
                                                    bc3=7))
    counts = graphs.launch_counts()
    assert counts["bptc"] == 5 and counts["bc3"] == 7
    assert len(counts) == 19
    graphs.add_launches({"bptc": 2, "bc3": -7, "etc2_eac": 1})
    assert bptc.KERNEL_LAUNCHES == 7 and bc.KERNEL_LAUNCHES["bc3"] == 0
    assert graphs.launch_counts()["etc2_eac"] == counts["etc2_eac"] + 1
    graphs.add_launches({"etc2_eac": -1})
    with pytest.raises(KeyError):
        graphs.add_launches({"bc7": 1})


def test_program_cache_keeps_the_last_few(monkeypatch):
    monkeypatch.setattr(graphs, "_PROGRAMS", collections.OrderedDict())
    made = []

    def make(key):
        made.append(key)
        return object()
    n = graphs.PROGRAMS_KEPT
    first = [graphs.program(k, lambda k=k: make(k)) for k in range(n)]
    assert graphs.program(0, lambda: make("again")) is first[0]
    graphs.program(n, lambda: make(n))          # drops key 1, the oldest
    assert list(graphs._PROGRAMS) == [*range(2, n), 0, n]
    graphs.program(1, lambda: make(1))
    assert made == [*range(n), n, 1]


# --- on a card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


_CARD_CFG = TT.TrainConfig(
    dynamics=TD.DynamicsConfig(image_size=32, conv_features=(16, 32),
                               latent_dim=32, action_dim=4, hidden_dim=64),
    batch_size=16, n_steps=5, compressed_obs=True)


def _graph_losses(monkeypatch):
    """Record each replay's loss of the graphed train()."""
    losses = []
    call = TT._TrainGraph.__call__

    def recorded(self):
        loss = call(self)
        losses.append(float(loss))
        return loss
    monkeypatch.setattr(TT._TrainGraph, "__call__", recorded)
    return losses


def _eager_train(cfg, device):
    """train()'s loop, eagerly through make_train_step on the card:
    (losses, params, optimizer)."""
    env = TT.SyntheticVisualEnv(cfg.dynamics, cfg.seed,
                                compressed=cfg.compressed_obs)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    params = TD.init_params(cfg.dynamics, generator, device)
    opt = TD.make_optimizer(params, cfg.lr)
    step = TT.make_train_step(cfg.dynamics, opt, cfg.compressed_obs)
    losses = []
    for i in range(cfg.n_steps):
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, i]))
        batch = _tensors(env.sample_batch(rng, cfg.batch_size), device)
        params, loss = step(params, batch)
        losses.append(float(loss))
    return losses, params, opt


def _state_equal(a_params, a_opt, b_params, b_opt):
    for x, y in zip(TT._step_state(a_params, a_opt),
                    TT._step_state(b_params, b_opt), strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [True, False])
def test_cuda_graphed_train_matches_eager(cuda, monkeypatch, compressed):
    """Five graphed steps against five eager ones on the same batches:
    losses, parameters, moments and step counts bit-equal; two BC7
    launches a replay with compressed observations."""
    cfg = dataclasses.replace(_CARD_CFG, compressed_obs=compressed)
    losses = _graph_losses(monkeypatch)
    launches = bptc.KERNEL_LAUNCHES
    params, opt, last = TT.train(cfg, MetricsLogger(io.StringIO()),
                                 device=cuda)
    launched = bptc.KERNEL_LAUNCHES - launches
    assert opt.param_groups[0]["capturable"]
    want, eager_params, eager_opt = _eager_train(cfg, cuda)
    assert losses == want and last == want[-1]
    _state_equal(params, opt, eager_params, eager_opt)
    assert launched == (2 * (cfg.n_steps + graphs.GRAPH_WARMUP)
                        if compressed else 0)


@pytest.mark.cuda
def test_cuda_graphed_resume_matches_straight_run(cuda, tmp_path,
                                                  monkeypatch):
    straight = _graph_losses(monkeypatch)
    p1, o1, _ = TT.train(_CARD_CFG, MetricsLogger(io.StringIO()),
                         device=cuda)
    ck = str(tmp_path / "ck")
    TT.train(dataclasses.replace(_CARD_CFG, n_steps=3, checkpoint_every=3,
                                 checkpoint_dir=ck),
             MetricsLogger(io.StringIO()), device=cuda)
    p2, o2, _ = TT.train(dataclasses.replace(_CARD_CFG, checkpoint_every=0,
                                             checkpoint_dir=ck),
                         MetricsLogger(io.StringIO()), device=cuda)
    # The straight run's 5 losses, the first 3 again, then the resumed 2.
    assert straight[5:8] == straight[:3] and straight[8:] == straight[3:5]
    _state_equal(p1, o1, p2, o2)


@pytest.mark.cuda
def test_cuda_train_replay_counts_and_sync_debug(cuda):
    """Two BC7 launches a replay (and GRAPH_WARMUP eager steps' before
    the capture); a replay, with its batch's upload, enqueued under sync
    debug mode "error"."""
    dcfg = _CARD_CFG.dynamics
    params = TD.init_params(dcfg, torch.Generator(cuda).manual_seed(0), cuda)
    opt = TD.make_optimizer(params)
    g = TT._TrainGraph(params, opt, dcfg, 16, True)
    env = TT.SyntheticVisualEnv(dcfg, 0, compressed=True)
    rng = np.random.default_rng(0)
    launches = bptc.KERNEL_LAUNCHES
    g.load(env.sample_batch(rng, 16))
    g()
    assert g.launches_per_replay == 2
    assert bptc.KERNEL_LAUNCHES == launches + 2 * (1 + graphs.GRAPH_WARMUP)
    batch = env.sample_batch(rng, 16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.load(batch)
        loss = g()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bptc.KERNEL_LAUNCHES == launches + 2 * (2 + graphs.GRAPH_WARMUP)
    assert np.isfinite(float(loss))


@pytest.mark.cuda
def test_cuda_no_collection_inside_a_capture(cuda):
    """A garbage collection inside a capture could free another graph
    (cudaGraphExecDestroy), which invalidates the capture: on the card an
    owner in a reference cycle, collected mid-capture, failed the next
    capture with cudaErrorStreamCaptureInvalidated.  Graph.capture holds
    automatic collection off inside the capture; such an owner is freed
    by a collection after it, and the new graph still replays."""
    class Owner:
        pass
    x = torch.arange(4.0, device=cuda)
    old = Owner()
    old.me, old.graph = old, graphs.Graph(cuda)
    old.graph.capture(lambda: x + 1)
    dropped = weakref.ref(old)
    del old
    seen = []

    def body():
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return x * 2
    g = graphs.Graph(cuda)
    g.capture(body)
    assert seen == [False] and gc.isenabled()
    gc.collect()
    assert dropped() is None
    assert torch.equal(g.replay(), x * 2)

"""The sharded step's one-program form (mpc/runtime.py: step_body and
_StepProgram with a mesh; mpc/train_loop.py: train_body and _TrainGraph with
a mesh; parallel/mesh.py: capturable; graphs.py: snapshot / take_back /
add_back): on the CPU, the bodies the CUDA graphs capture, run eagerly on
a gloo world of one in this process, against the JAX package's steps
jitted on a one-device mesh (detex_tpu/mpc/runtime.py:158-160 with
`mesh`, the shard_map path with rollout_axis="dp"; detex_tpu/mpc/
train_loop.py:218-233 on the mesh's shardings); the decision to capture,
made from the groups' backends; and the counters a capture moves to its
replays.  Tests marked `cuda` hold the graphed sharded Controller,
PipelinedController and train() to the eager sharded steps at one NCCL
rank on a card, and the capture at 2 and 4 NCCL ranks on as many cards;
they skip here.

Tolerances, as tests/test_torch_step_graph.py and test_torch_train_graph.py
state them (float32; the decode is bit-exact):
  * the control step against JAX: action and the nominal left atol 1e-5,
    the diagnostics rtol 1e-5;
  * the train step against JAX, three steps: loss rtol 1e-5, parameters
    rtol 1e-5 / atol 1e-6;
  * against the port's own unsharded bodies: bit-equal (one rank's SUM and
    MIN are the identity);
  * on the card at one NCCL rank: graphed MPPI, sequential iLQR and
    parallel-LQT actions bit-equal to the eager sharded step (the LQT's LU
    on cuSOLVER/cuBLAS both ways, mpc/parallel_lqr._lu_library), and
    within atol 1e-6 of the unsharded graphed Controller; the (1, 1)
    train step bit-equal with deterministic cuDNN; at 2 and 4 NCCL ranks
    atol 1e-6 (NCCL may sum in another order inside a graph).
"""

import collections
import dataclasses
import functools
import gc
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from detex_tpu_torch import entry as tentry
from detex_tpu_torch import graphs
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.mpc import train_loop as TT
from detex_tpu_torch.ops import bptc
from detex_tpu_torch.parallel import launch
from detex_tpu_torch.parallel import mesh as PM
from detex_tpu_torch.utils.metrics import MetricsLogger

_ILQR = [(0, False), (2, False), (2, True)]   # iterations, parallel LQT
_TRAIN_SHAPE = dict(image_size=16, conv_features=(8, 16), latent_dim=16,
                    action_dim=4, hidden_dim=32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's steps and a one-device mesh (the card's machine
    has no JAX: it is imported here only)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import runtime
    from detex_tpu.mpc import train_loop
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    return SimpleNamespace(jax=jax, jnp=jnp, JD=dynamics, JR=runtime,
                           JT=train_loop, mesh=mesh,
                           batch=NamedSharding(mesh, PartitionSpec("dp")))


@pytest.fixture(scope="module")
def world():
    """A gloo world of one in this process and its (1, 1) mesh, destroyed
    after the module."""
    assert not dist.is_initialized()
    mesh = PM.make_mesh((1, 1), device="cpu")
    yield mesh
    dist.destroy_process_group()


def _cfg(cfg, n_ilqr, parallel, dtype, axis="dp"):
    return dataclasses.replace(
        cfg, n_ilqr_iterations=n_ilqr, ilqr_parallel=parallel,
        rollout_axis=axis,
        dynamics=dataclasses.replace(cfg.dynamics, compute_dtype=dtype))


def _obs_words(n_blocks, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64) \
        .astype(np.int32)


# --- the control step ------------------------------------------------------


@pytest.mark.parametrize("n_ilqr,parallel", _ILQR)
def test_step_body_on_a_mesh_vs_jax_sharded_control_step(jx, world, n_ilqr,
                                                         parallel):
    """step_body with rollout_axis="dp" on the gloo world of one against
    JAX's control_step jitted with a one-device mesh (shard_map over "dp")
    on the same params, words, goal, nominal and noise, those of
    tests/test_torch_step_graph.py::test_step_body_parity_small_cfg_f32
    (whose unsharded parity this extends to the mesh; under iLQR the
    output layer damped by 0.05); and bit-equal to the unsharded
    step_body.  The diagnostics' rtol 1e-5 needs a well-conditioned ESS:
    where one rollout takes nearly all the weight (ESS about 1), float32
    rounding of the costs moves the ESS by more (1.9e-5 at an ESS of 1.08
    on other seeds, unsharded as much as sharded)."""
    jax, jnp, JD, JR = jx.jax, jx.jnp, jx.JD, jx.JR
    jcfg = _cfg(graft._small_cfg(), n_ilqr, parallel, jnp.float32)
    tcfg = _cfg(tentry._small_cfg(), n_ilqr, parallel, torch.float32)
    dcfg, mcfg = jcfg.dynamics, jcfg.mppi
    jp = JD.init_params(jax.random.PRNGKey(5), dcfg)
    if n_ilqr:
        jp["dyn"]["out"]["w"] = jp["dyn"]["out"]["w"] * 0.05
    host = jax.tree.map(np.asarray, jp)
    words = _obs_words((dcfg.image_size // 4) ** 2, 50)
    rng = np.random.default_rng(51)
    goal = (0.5 * rng.standard_normal(dcfg.latent_dim)).astype(np.float32)
    nominal = rng.uniform(-0.5, 0.5, (mcfg.horizon, mcfg.action_dim)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(52)
    eps = np.array(jax.random.normal(
        key, (mcfg.n_rollouts, mcfg.horizon, mcfg.action_dim),
        jnp.float32) * mcfg.noise_sigma)
    step = jax.jit(functools.partial(JR.control_step, cfg=jcfg,
                                     mesh=jx.mesh))
    with jx.mesh:
        ja, js, jd = step(jax.device_put(jp, JD.param_shardings(jx.mesh,
                                                               dcfg)),
                          jnp.asarray(nominal), key, jnp.asarray(words),
                          jnp.asarray(goal))

    def body(cfg, mesh):
        nominal_buf = torch.from_numpy(nominal.copy())
        with torch.no_grad():
            packed, layout = TR.step_body(
                TD.params_from_jax(host, mesh=mesh), nominal_buf,
                torch.from_numpy(words), torch.from_numpy(goal),
                torch.from_numpy(eps), cfg, mesh)
        return packed, layout, nominal_buf

    PM.reset_collective_bytes()
    packed, layout, left = body(tcfg, world)
    nbytes = dict(PM.COLLECTIVE_BYTES)
    diag = TR.unpack_outputs(packed, layout)
    action = diag.pop("action")
    assert set(diag) == set(jd)
    np.testing.assert_allclose(action.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(left.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    for k in diag:
        np.testing.assert_allclose(float(diag[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)
    # MIN of the baseline, then one SUM of H*A + 3 floats, over "dp".
    assert nbytes == {("all_reduce_min", "dp"): 4,
                      ("all_reduce_sum", "dp"):
                      (mcfg.horizon * mcfg.action_dim + 3) * 4}
    want, want_layout, want_left = body(
        dataclasses.replace(tcfg, rollout_axis=None), None)
    assert layout == want_layout
    assert torch.equal(packed, want) and torch.equal(left, want_left)


def _params(cfg, device="cpu", seed=7, damp=1.0):
    params = TD.init_params(cfg.dynamics,
                            torch.Generator(device=device).manual_seed(seed),
                            device)
    params["dyn"]["out"]["w"] = params["dyn"]["out"]["w"] * damp
    return params


# --- the train step --------------------------------------------------------


def _word_batches(n, batch_size=8, seed=5):
    env = TT.SyntheticVisualEnv(
        TD.DynamicsConfig(compute_dtype=torch.float32, **_TRAIN_SHAPE), 0,
        compressed=True)
    rng = np.random.default_rng(seed)
    return [env.sample_batch(rng, batch_size) for _ in range(n)]


def test_train_body_on_a_mesh_vs_jax_sharded_visual_step(jx, world):
    """Three train_body steps on the (1, 1) gloo mesh (parameters carried
    across with params_from_jax, batches cut to the rank's dp rows) against
    JAX's compressed-observation train step jitted on a one-device mesh's
    shardings (parameters by param_shardings, the batch by P("dp")): the
    losses and the final parameters; and bit-equal to the unsharded
    train_body."""
    jax, jnp, JD, JT = jx.jax, jx.jnp, jx.JD, jx.JT
    jcfg = JD.DynamicsConfig(compute_dtype=jnp.float32, **_TRAIN_SHAPE)
    tcfg = TD.DynamicsConfig(compute_dtype=torch.float32, **_TRAIN_SHAPE)
    jp = JD.init_params(jax.random.PRNGKey(19), jcfg)
    host = jax.tree.map(np.asarray, jp)
    opt = JD.make_optimizer()
    jp = jax.device_put(jp, JD.param_shardings(jx.mesh, jcfg))
    state = opt.init(jp)
    visual = JT.make_train_step(jcfg, opt, compressed_obs=True)
    batches = _word_batches(3)
    jlosses = []
    with jx.mesh:
        for b in batches:
            jp, state, loss = visual(jp, state, {
                k: jax.device_put(v, jx.batch) for k, v in b.items()})
            jlosses.append(float(loss))

    def train(mesh):
        params = TD.params_from_jax(host, mesh=mesh)
        optimizer = TD.make_optimizer(params)
        losses = []
        for b in batches:
            b = {k: torch.as_tensor(v) for k, v in b.items()}
            if mesh is not None:
                b = {k: PM.shard_batch(v, mesh, "dp") for k, v in b.items()}
            losses.append(TT.train_body(params, optimizer, b, tcfg, True,
                                        mesh))
        return losses, params, optimizer

    PM.reset_collective_bytes()
    losses, params, optimizer = train(world)
    n_grad = sum(p.numel() for p in TD.param_leaves(params))
    assert dict(PM.COLLECTIVE_BYTES) == {
        ("all_reduce_sum", "dp"): 3 * (n_grad + 1) * 4}
    assert all(loss.shape == () for loss in losses)
    np.testing.assert_allclose([float(x) for x in losses], jlosses,
                               rtol=1e-5)
    want = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    for got, ref in zip(TD.param_leaves(params), TD.param_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
    plain_losses, plain_params, plain_opt = train(None)
    assert all(torch.equal(a, b) for a, b in zip(losses, plain_losses))
    for a, b in zip(TT._step_state(params, optimizer),
                    TT._step_state(plain_params, plain_opt), strict=True):
        assert torch.equal(a, b)


# --- the decision to capture -----------------------------------------------


def test_capturable_is_false_for_a_gloo_mesh(world):
    assert world.device_type == "cpu"
    assert dist.get_backend(world.get_group("dp")) == "gloo"
    assert PM.capturable(world) is False


@pytest.mark.parametrize("device_type,backends,want", [
    ("cuda", {"dp": "nccl", "tp": "nccl"}, True),
    ("cuda", {"dp": "nccl", "tp": "gloo"}, False),
    ("cuda", {"dp": "gloo", "tp": "gloo"}, False),
    ("cpu", {"dp": "nccl", "tp": "nccl"}, False),
])
def test_capturable_reads_every_axis_backend(monkeypatch, device_type,
                                             backends, want):
    """True only on a CUDA mesh whose every axis group is NCCL (a mesh
    stand-in: the groups' backends come from dist.get_backend)."""
    mesh = SimpleNamespace(device_type=device_type,
                           mesh_dim_names=tuple(backends),
                           get_group=lambda axis: axis)
    monkeypatch.setattr(PM.dist, "get_backend", lambda group: backends[group])
    assert PM.capturable(mesh) is want


@pytest.mark.parametrize("pipelined", [False, True])
def test_cpu_controller_on_a_mesh_stays_eager(world, pipelined):
    """A CPU Controller with a mesh steps eagerly, through control_step on
    its mesh, and serves the unsharded Controller's actions."""
    cfg = _cfg(tentry._small_cfg(), 0, False, torch.float32)
    params, goal = _params(cfg), torch.zeros(64)
    cls = TR.PipelinedController if pipelined else TR.Controller
    ctl = cls(params, goal, cfg, seed=3, device="cpu", mesh=world)
    plain = cls(params, goal, dataclasses.replace(cfg, rollout_axis=None),
                seed=3, device="cpu")
    assert ctl.graphed is False and ctl._program.graph is None
    for i in range(2):
        words = _obs_words(64, 70 + i)
        got, want = ctl.step(words), plain.step(words)
        assert (got is None) == (want is None) == (pipelined and i == 0)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert ctl.mesh is world


def test_cpu_train_on_a_mesh_stays_eager(monkeypatch, world):
    """train() with mesh_shape (1, 1) on the CPU steps through
    make_train_step on its mesh, never a graph."""
    def refuse(*a, **k):
        raise AssertionError("a graph on the CPU")
    monkeypatch.setattr(TT, "_TrainGraph", refuse)
    meshes = []
    make = TT.make_train_step

    def counted(*a, **k):
        meshes.append(a[3] if len(a) > 3 else k.get("mesh"))
        return make(*a, **k)
    monkeypatch.setattr(TT, "make_train_step", counted)
    cfg = TT.TrainConfig(
        dynamics=TD.DynamicsConfig(compute_dtype=torch.float32,
                                   **_TRAIN_SHAPE),
        batch_size=4, n_steps=2, compressed_obs=True, mesh_shape=(1, 1))
    _, _, loss = TT.train(cfg, MetricsLogger(io.StringIO()), device="cpu")
    assert len(meshes) == 1 and meshes[0] is not None
    assert tuple(meshes[0].shape) == (1, 1) and np.isfinite(loss)


# --- the counters a capture moves to its replays -----------------------------


@pytest.fixture
def counters(monkeypatch):
    """Fresh launch counts and collective bytes, put back after the test."""
    monkeypatch.setattr(bptc, "KERNEL_LAUNCHES", 3)
    monkeypatch.setattr(PM, "COLLECTIVE_BYTES", collections.Counter(
        {("all_gather", "tp"): 64}))


def test_take_back_moves_capture_counts_to_replay(world, counters):
    """What ran between snapshot() and take_back() (here: a BC7 launch
    counted by hand and two real collectives on the gloo mesh) is taken
    back, leaving the counters as they were, key for key; add_back adds
    one replay's counts."""
    before = graphs.snapshot()
    bptc.KERNEL_LAUNCHES += 1
    PM.all_reduce(torch.zeros(5), world, "dp")
    PM.all_reduce(torch.zeros(()), world, "dp", "min")
    PM.all_gather(torch.zeros(2), world, "tp")
    launches, nbytes = graphs.take_back(before)
    assert launches == {"bptc": 1}
    assert nbytes == {("all_reduce_sum", "dp"): 20,
                      ("all_reduce_min", "dp"): 4, ("all_gather", "tp"): 8}
    assert bptc.KERNEL_LAUNCHES == 3
    assert PM.COLLECTIVE_BYTES == collections.Counter(
        {("all_gather", "tp"): 64})
    assert list(PM.COLLECTIVE_BYTES) == [("all_gather", "tp")]
    for n in (1, 2):
        graphs.add_back((launches, nbytes))
        assert bptc.KERNEL_LAUNCHES == 3 + n
        assert PM.COLLECTIVE_BYTES == {
            ("all_gather", "tp"): 64 + 8 * n,
            ("all_reduce_sum", "dp"): 20 * n,
            ("all_reduce_min", "dp"): 4 * n}


def test_take_back_of_nothing(counters):
    before = graphs.snapshot()
    assert graphs.take_back(before) == ({}, {})
    graphs.add_back(({}, {}))
    assert bptc.KERNEL_LAUNCHES == 3
    assert PM.COLLECTIVE_BYTES == {("all_gather", "tp"): 64}


# --- on a card, one rank over NCCL -------------------------------------------


@pytest.fixture
def nccl_world():
    """A world of one over NCCL on the card and its (1, 1) mesh, destroyed
    after the test, once every graph that holds its communicators is
    gone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (NCCL and CUDA graphs have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = PM.make_mesh((1, 1), device="cuda")
    assert dist.get_backend() == "nccl" and PM.capturable(mesh)
    yield mesh
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _eager_sharded(params, goal, cfg, obs, seed, mesh):
    """control_step on `mesh` served eagerly over `obs`, the nominal
    carried and the noise drawn from a generator seeded as a Controller
    seeds its own: ([action], [diagnostics as floats], collective bytes of
    one step)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          device="cuda")
    actions, diags = [], []
    PM.reset_collective_bytes()
    with torch.no_grad():
        for w in obs:
            a, nominal, d = TR.control_step(
                params, nominal, gen, torch.as_tensor(w, device="cuda"),
                goal, cfg, mesh=mesh)
            actions.append(a.cpu().numpy())
            diags.append({k: float(v) for k, v in d.items()})
    per_step = {k: v // len(obs) for k, v in PM.COLLECTIVE_BYTES.items()}
    return actions, diags, per_step


def _graphed_sharded(cuda_mesh, n_ilqr, parallel, n=5, pipelined=False):
    """A graphed Controller (or PipelinedController, flushed at the end) on
    the NCCL mesh and the eager sharded step over n observations, same
    seed, at _small_cfg() (bf16), the output layer damped under iLQR: the
    controller, its actions, the eager actions, the observations, the
    params, the goal and the config."""
    cfg = _cfg(tentry._small_cfg(), n_ilqr, parallel, torch.bfloat16)
    params = _params(cfg, "cuda", damp=0.05 if n_ilqr else 1.0)
    goal = torch.zeros(64, device="cuda")
    obs = [_obs_words(64, 130 + i) for i in range(n)]
    cls = TR.PipelinedController if pipelined else TR.Controller
    ctl = cls(params, goal, cfg, seed=11, device="cuda", mesh=cuda_mesh)
    assert ctl.graphed
    got = [ctl.step(w) for w in obs]
    if pipelined:
        got.append(ctl.flush())
    want, _, _ = _eager_sharded(params, goal, cfg, obs, 11, cuda_mesh)
    return SimpleNamespace(ctl=ctl, got=got, want=want, obs=obs,
                           params=params, goal=goal, cfg=cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ilqr,parallel", _ILQR)
def test_cuda_graphed_sharded_matches_eager_sharded(nccl_world, n_ilqr,
                                                    parallel):
    """MPPI, sequential iLQR and the parallel LQT (its LU on cuSOLVER/
    cuBLAS eager and captured) bit-equal to the eager sharded step on the
    same noise; the generator where the eager one leaves its own; and
    within atol 1e-6 of the unsharded graphed Controller."""
    r = _graphed_sharded(nccl_world, n_ilqr, parallel)
    for a, w in zip(r.got, r.want):
        np.testing.assert_array_equal(a, w)
    unsharded = TR.Controller(r.params, r.goal, dataclasses.replace(
        r.cfg, rollout_axis=None), seed=11, device="cuda")
    assert unsharded.graphed
    for w, a in zip(r.obs, r.got):
        np.testing.assert_allclose(unsharded.step(w), a, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_replay_counts_bc7_and_collective_bytes(nccl_world):
    """The capture records one BC7 launch and the step's collectives and
    counts neither; each replay adds 1 launch and the eager sharded step's
    bytes (MIN 4 B + SUM (H*A + 3) * 4 B over "dp")."""
    cfg = _cfg(tentry._small_cfg(), 0, False, torch.bfloat16)
    ctl = TR.Controller(_params(cfg, "cuda"), torch.zeros(64, device="cuda"),
                        cfg, device="cuda", mesh=nccl_world)
    launches = bptc.KERNEL_LAUNCHES
    ctl.step(_obs_words(64, 1))
    prog = ctl._program
    assert prog.launches_per_replay == 1
    assert bptc.KERNEL_LAUNCHES == launches + 1 + TR.GRAPH_WARMUP
    h, a = cfg.mppi.horizon, cfg.mppi.action_dim
    want = {("all_reduce_min", "dp"): 4,
            ("all_reduce_sum", "dp"): (h * a + 3) * 4}
    assert prog._graph.collective_bytes == want
    for i in range(3):
        launches = bptc.KERNEL_LAUNCHES
        PM.reset_collective_bytes()
        ctl.step(_obs_words(64, 2 + i))
        assert bptc.KERNEL_LAUNCHES == launches + 1
        assert dict(PM.COLLECTIVE_BYTES) == want
    _, _, per_step = _eager_sharded(ctl.params, ctl.goal_z, cfg,
                                    [_obs_words(64, 9)], 0, nccl_world)
    assert per_step == want


@pytest.mark.cuda
def test_cuda_graphed_sharded_pipelined_one_step_behind(nccl_world):
    """A graphed PipelinedController on the NCCL mesh returns the eager
    sharded step's actions one call later; one of its steps enqueues
    under sync debug mode "error"."""
    r = _graphed_sharded(nccl_world, 0, False, n=4, pipelined=True)
    assert r.got[0] is None
    for a, w in zip(r.got[1:], r.want):
        np.testing.assert_array_equal(a, w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = r.ctl.step(r.obs[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert first is None and np.isfinite(r.ctl.flush()).all()


@pytest.mark.cuda
def test_cuda_sharded_replay_under_sync_debug(nccl_world):
    """A sharded step's load, noise draw and replay (its collectives
    inside) enqueue without a synchronising call."""
    cfg = _cfg(tentry._small_cfg(), 0, False, torch.bfloat16)
    ctl = TR.Controller(_params(cfg, "cuda"), torch.zeros(64, device="cuda"),
                        cfg, device="cuda", mesh=nccl_world)
    ctl.step(_obs_words(64, 1))
    words = torch.from_numpy(_obs_words(64, 2)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctl._program.load(words)
        action, _ = ctl._program(ctl.generator)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(action).all()


_CARD_TRAIN = TT.TrainConfig(
    dynamics=TD.DynamicsConfig(image_size=32, conv_features=(16, 32),
                               latent_dim=32, action_dim=4, hidden_dim=64),
    batch_size=16, n_steps=5, compressed_obs=True, mesh_shape=(1, 1))


@pytest.mark.cuda
def test_cuda_graphed_train_on_a_mesh_matches_eager_sharded(nccl_world,
                                                            monkeypatch):
    """train() with mesh_shape (1, 1) steps through the graph (2 BC7
    launches a replay, the dp all_reduce's bytes a replay) and is bit-equal
    to the eager sharded train step over 5 steps, deterministic cuDNN."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    seen = []
    call = TT._TrainGraph.__call__

    def recorded(self):
        loss = call(self)
        seen.append((self, float(loss)))
        return loss
    monkeypatch.setattr(TT._TrainGraph, "__call__", recorded)
    cfg, dcfg = _CARD_TRAIN, _CARD_TRAIN.dynamics
    try:
        launches = bptc.KERNEL_LAUNCHES
        params, opt, _ = TT.train(cfg, MetricsLogger(io.StringIO()),
                                  device="cuda")
        launched = bptc.KERNEL_LAUNCHES - launches
        prog = seen[0][0]
        assert prog.mesh is not None and prog.launches_per_replay == 2
        n_grad = sum(p.numel() for p in TD.param_leaves(params))
        assert prog._graph.collective_bytes == {
            ("all_reduce_sum", "dp"): (n_grad + 1) * 4}
        assert launched == 2 * (cfg.n_steps + graphs.GRAPH_WARMUP)
        env = TT.SyntheticVisualEnv(dcfg, cfg.seed, compressed=True)
        e_params = TD.shard_params(TD.init_params(
            dcfg, torch.Generator("cuda").manual_seed(cfg.seed), "cuda"),
            nccl_world)
        e_opt = TD.make_optimizer(e_params, cfg.lr)
        step = TT.make_train_step(dcfg, e_opt, True, nccl_world)
        want = []
        for i in range(cfg.n_steps):
            rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, i]))
            b = {k: PM.shard_batch(torch.as_tensor(v), nccl_world, "dp")
                 .cuda() for k, v in env.sample_batch(
                     rng, cfg.batch_size).items()}
            e_params, loss = step(e_params, b)
            want.append(float(loss))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert [x for _, x in seen] == want
    for a, b in zip(TT._step_state(params, opt),
                    TT._step_state(e_params, e_opt), strict=True):
        assert torch.equal(a, b)


# --- on 2 and 4 cards, NCCL ------------------------------------------------


def _nccl_train(mesh) -> tuple:
    """3 steps of the _TrainGraph on `mesh` (tp-sharded parameters, this
    rank's dp rows) against the eager sharded train step from the same
    parameters, deterministic cuDNN: (graphed losses, eager losses, the
    largest state difference)."""
    torch.backends.cudnn.deterministic = True
    dcfg, b = _CARD_TRAIN.dynamics, _CARD_TRAIN.batch_size
    env = TT.SyntheticVisualEnv(dcfg, 0, compressed=True)
    batches = [env.sample_batch(np.random.default_rng(i), b)
               for i in range(3)]

    def model():
        params = TD.shard_params(TD.init_params(
            dcfg, torch.Generator("cuda").manual_seed(0), "cuda"), mesh)
        return params, TD.make_optimizer(params)
    params, opt = model()
    graph = TT._TrainGraph(params, opt, dcfg, b, True, mesh)
    losses = []
    for batch in batches:
        graph.load(batch)
        losses.append(float(graph()))
    e_params, e_opt = model()
    step = TT.make_train_step(dcfg, e_opt, True, mesh)
    e_losses = []
    for batch in batches:
        e_params, loss = step(e_params, {
            k: PM.shard_batch(torch.as_tensor(v), mesh, "dp").cuda()
            for k, v in batch.items()})
        e_losses.append(float(loss))
    pairs = zip(TT._step_state(params, opt), TT._step_state(e_params, e_opt),
                strict=True)
    diff = max(float((x.detach() - y.detach()).float().abs().max())
               for x, y in pairs)
    return torch.tensor(losses), torch.tensor(e_losses), diff


def _nccl_rank(rank, shape):
    """One rank of an NCCL world on its own card: a graphed sharded
    Controller (MPPI, then 2 sequential iLQR iterations, which gather the
    tp-sharded parameters inside the graph) against the eager sharded step
    on the same noise; and the train graph against the eager sharded train
    step (_nccl_train)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = PM.make_mesh(shape, device="cuda")
    assert PM.capturable(mesh)
    out = {"train": _nccl_train(mesh)}
    for n_ilqr in (0, 2):
        cfg = _cfg(tentry._small_cfg(), n_ilqr, False, torch.bfloat16)
        params = TD.shard_params(_params(cfg, "cuda", damp=0.05), mesh)
        goal = torch.zeros(64, device="cuda")
        obs = [_obs_words(64, 150 + i) for i in range(3)]
        ctl = TR.Controller(params, goal, cfg, seed=5, device="cuda",
                            mesh=mesh)
        got = [ctl.step(w) for w in obs]
        want, _, _ = _eager_sharded(params, goal, cfg, obs, 5, mesh)
        # A rank returns tensors and plain values (run_ranks).
        out[n_ilqr] = (ctl.graphed, torch.from_numpy(np.stack(got)),
                       torch.from_numpy(np.stack(want)))
        del ctl
    gc.collect()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_cuda_capture_at_n_nccl_ranks(n):
    """n ranks, one a card, on an (n / 2, 2) NCCL mesh (tp = 2): the
    graphed sharded Controller within atol 1e-6 of the eager sharded step
    (MPPI and sequential iLQR), and the train graph's losses within rtol
    1e-5 and its state within 1e-6 of the eager sharded train step's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA cards: NCCL takes one rank per card, "
                    f"so the capture at {n} NCCL ranks needs {n}")
    shape = (n // 2, 2)
    for out in launch.run_ranks(_nccl_rank, n, (shape,), device="cuda",
                                backend="nccl", timeout=300.0):
        losses, want_losses, diff = out.pop("train")
        np.testing.assert_allclose(losses.numpy(), want_losses.numpy(),
                                   rtol=1e-5)
        assert diff <= 1e-6
        for graphed, got, want in out.values():
            assert graphed
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6)

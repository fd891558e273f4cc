"""The whole slice: the port's control step (BC7 decode -> encode -> MPPI)
against the JAX package's, at __graft_entry__._small_cfg() with float32
compute, on the same parameters, observation words and noise; and the
port's Controller and entry() serving steps on the CPU.

Tolerances (float32; the decode is bit-exact, so differences come only
from the summation order of convs, matmuls and the cost sums):
  * action and shifted nominal: atol 1e-5 (controls lie in [-1, 1]);
  * min_cost and mean_cost: rtol 1e-5;
  * ess: rtol 1e-5.

Tests marked `cuda` run the step on a card and skip here.  The card's
machine has no JAX, so the JAX package is imported only inside the `jx`
fixture (see tests/test_torch_bptc.py for the card's command).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from detex_tpu_torch import entry as tentry
from detex_tpu_torch import formats as F
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.ops import bptc


@pytest.fixture(scope="module")
def jx():
    """The JAX package's control step and its modules."""
    import jax
    import jax.numpy as jnp

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import runtime
    return SimpleNamespace(jax=jax, jnp=jnp, JD=dynamics, JR=runtime)


def _f32(cfg, jnp=None):
    """cfg with float32 compute; pass jax.numpy for a JAX config."""
    return dataclasses.replace(cfg, dynamics=dataclasses.replace(
        cfg.dynamics,
        compute_dtype=torch.float32 if jnp is None else jnp.float32))


def _obs_words(n_blocks, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64) \
        .astype(np.int32)


def test_small_cfg_matches_graft_entry():
    j, t = graft._small_cfg(), tentry._small_cfg()
    for part in ("dynamics", "mppi"):
        jd = dataclasses.asdict(getattr(j, part))
        td = dataclasses.asdict(getattr(t, part))
        jd.pop("compute_dtype", None)
        td.pop("compute_dtype", None)
        assert jd == td
    assert (j.goal_weight, j.control_weight) == (t.goal_weight,
                                                 t.control_weight)


@pytest.mark.parametrize("seed", [0, 1])
def test_control_step_parity_small_cfg_f32(jx, seed):
    jax, jnp, JD, JR = jx.jax, jx.jnp, jx.JD, jx.JR
    jcfg, tcfg = _f32(graft._small_cfg(), jnp), _f32(tentry._small_cfg())
    dcfg, mcfg = jcfg.dynamics, jcfg.mppi
    jp = JD.init_params(jax.random.PRNGKey(seed), dcfg)
    tp = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    words = _obs_words((dcfg.image_size // 4) ** 2, seed)
    rng = np.random.default_rng(100 + seed)
    goal = rng.standard_normal(dcfg.latent_dim).astype(np.float32)
    nominal = rng.uniform(-0.5, 0.5, (mcfg.horizon, mcfg.action_dim)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(10 + seed)
    # The noise JAX's mppi_step draws from `key` (mppi.py:141-142),
    # handed to the port.
    eps = np.array(jax.random.normal(
        key, (mcfg.n_rollouts, mcfg.horizon, mcfg.action_dim),
        jnp.float32) * mcfg.noise_sigma)

    step = jax.jit(lambda *a: JR.control_step(*a, cfg=jcfg))
    ja, js, jd = step(jp, jnp.asarray(nominal), key, jnp.asarray(words),
                      jnp.asarray(goal))
    ta, ts, td = TR.control_step(tp, torch.from_numpy(nominal), None,
                                 torch.from_numpy(words),
                                 torch.from_numpy(goal), tcfg,
                                 eps=torch.from_numpy(eps))
    assert tuple(ta.shape) == (mcfg.action_dim,)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    for k in ("min_cost", "mean_cost", "ess"):
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)


def test_decode_obs_parity(jx):
    """The observation image is bit-exact, invalid blocks included (the
    random words hold blocks without a mode)."""
    words = _obs_words(64, 3)
    words[:5, 0] &= ~0xFF
    want = jx.jax.jit(jx.JR.decode_obs, static_argnums=(1, 2))(
        jx.jnp.asarray(words), 32, 32)
    got = TR.decode_obs(torch.from_numpy(words), 32, 32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (32, 32, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_rgba8_image_parity(jx):
    """Packed words with alpha >= 128 are negative int32; the arithmetic
    shift then masks to the right byte."""
    packed = _obs_words(16 * 16 * 4, 4).reshape(256, 16)
    want = jx.JR.unpack_rgba8_image(jx.jnp.asarray(packed), 64, 64)
    got = TR.unpack_rgba8_image(torch.from_numpy(packed), 64, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _controller(cfg, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(7)
    params = TD.init_params(cfg.dynamics, gen, device)
    goal = torch.zeros(cfg.dynamics.latent_dim, device=device)
    return TR.Controller(params, goal, cfg, seed=seed, device=device)


def _serve(ctl, same, cfg, n=3):
    """n requests through `ctl`, each checked and repeated on `same`, a
    controller built alike."""
    for i in range(n):
        words = _obs_words((cfg.dynamics.image_size // 4) ** 2, 20 + i)
        action = ctl.step(words)
        assert action.shape == (cfg.mppi.action_dim,)
        assert np.isfinite(action).all()
        assert (action >= cfg.mppi.action_low).all()
        assert (action <= cfg.mppi.action_high).all()
        assert tuple(ctl.nominal.shape) == (cfg.mppi.horizon,
                                            cfg.mppi.action_dim)
        assert all(np.isfinite(float(v)) for v in ctl.diag.values())
        # Same seed, same observations: the same plan.
        np.testing.assert_array_equal(same.step(words), action)


def test_controller_serves_requests_on_cpu():
    cfg = _f32(tentry._small_cfg())
    launches = bptc.KERNEL_LAUNCHES
    _serve(_controller(cfg), _controller(cfg), cfg)
    # CPU tensors go through the plain decode, never the kernel.
    assert bptc.KERNEL_LAUNCHES == launches


def test_unpack_rgba8_images_parity(jx):
    packed = _obs_words(3 * 8 * 8 * 4, 5).reshape(3, 64, 16)
    want = jx.JR.unpack_rgba8_images(jx.jnp.asarray(packed), 32, 32)
    got = TR.unpack_rgba8_images(torch.from_numpy(packed), 32, 32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 32, 32, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(3):      # each image as the unbatched unpack gives it
        np.testing.assert_array_equal(
            got[b].numpy(),
            TR.unpack_rgba8_image(torch.from_numpy(packed[b]), 32, 32)
            .numpy())


@pytest.mark.parametrize("size", [16, 32])
def test_decode_obs_batch_parity(jx, size):
    """Bit-exact to JAX's, invalid blocks included, with one decode call
    for the whole batch."""
    nb = (size // 4) ** 2
    words = _obs_words(4 * nb, 6 + size).reshape(4, nb, 4)
    words[1, :3, 0] &= ~0xFF
    want = jx.jax.jit(jx.JR.decode_obs_batch, static_argnums=(1, 2))(
        jx.jnp.asarray(words), size, size)
    calls = []
    decode = bptc.decode_bptc

    def counted(w, *a):
        calls.append(tuple(w.shape))
        return decode(w, *a)

    bptc.decode_bptc = counted
    try:
        got = TR.decode_obs_batch(torch.from_numpy(words), size, size)
    finally:
        bptc.decode_bptc = decode
    assert calls == [(4 * nb, 4)]
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, size, size, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pipeline_cfg():
    """tests/test_mpc.py's pipelined-controller configuration."""
    dcfg = TD.DynamicsConfig(image_size=16, conv_features=(8, 16),
                             latent_dim=16, action_dim=4, hidden_dim=32)
    return TR.ControllerConfig(
        dynamics=dcfg, mppi=TM.MPPIConfig(n_rollouts=32, horizon=4,
                                          action_dim=4))


def _pipelined_vs_sync(cfg, device, n=4):
    """PipelinedController returns the synchronous controller's actions
    with exactly one step of lag (the port's copy of tests/test_mpc.py's
    test)."""
    params = TD.init_params(cfg.dynamics,
                            torch.Generator(device=device).manual_seed(0),
                            device)
    goal = torch.zeros(cfg.dynamics.latent_dim, device=device)
    obs = [_obs_words((cfg.dynamics.image_size // 4) ** 2, 40 + i)
           for i in range(n)]
    sync = TR.Controller(params, goal, cfg, seed=7, device=device)
    pipe = TR.PipelinedController(params, goal, cfg, seed=7, device=device)
    sync_actions = [sync.step(o) for o in obs]
    pipe_actions = [pipe.step(o) for o in obs]
    assert pipe_actions[0] is None
    return sync_actions, pipe_actions, pipe


def test_pipelined_controller_matches_synchronous():
    sync_actions, pipe_actions, pipe = _pipelined_vs_sync(_pipeline_cfg(),
                                                          "cpu")
    for t in range(1, len(sync_actions)):
        np.testing.assert_array_equal(pipe_actions[t], sync_actions[t - 1])
    np.testing.assert_array_equal(pipe.flush(), sync_actions[-1])
    assert pipe.flush() is None
    # Each returned action is the caller's own copy.
    assert pipe_actions[1] is not pipe_actions[3]
    assert not np.shares_memory(pipe_actions[1], pipe_actions[3])


def test_pipelined_controller_with_ilqr():
    cfg = dataclasses.replace(_pipeline_cfg(), n_ilqr_iterations=1)
    sync_actions, pipe_actions, pipe = _pipelined_vs_sync(cfg, "cpu", 3)
    for t in range(1, 3):
        np.testing.assert_array_equal(pipe_actions[t], sync_actions[t - 1])
    assert "ilqr_cost" in pipe.diag


def test_entry_points_default_to_the_card(monkeypatch):
    """entry() and Controller() run on the card unless asked for the CPU,
    and raise where there is none rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    cfg = tentry._small_cfg()
    params = TD.init_params(cfg.dynamics, torch.Generator().manual_seed(0))
    for cls in (TR.Controller, TR.PipelinedController):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(params, torch.zeros(cfg.dynamics.latent_dim), cfg)


@pytest.mark.parametrize("fmt", ["BC1", "ETC2_EAC", "BPTC_FLOAT"])
def test_obs_format_other_than_bc7_raises(fmt):
    """Observations are decoded as BC7 only: any other obs_format raises
    in control_step and in the controllers rather than decode BC7."""
    cfg = dataclasses.replace(tentry._small_cfg(), obs_format=getattr(F, fmt))
    params = TD.init_params(cfg.dynamics, torch.Generator().manual_seed(0))
    goal = torch.zeros(cfg.dynamics.latent_dim)
    words = torch.from_numpy(_obs_words(
        (cfg.dynamics.image_size // 4) ** 2, 0))
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim))
    with pytest.raises(ValueError, match="obs_format"):
        TR.control_step(params, nominal, torch.Generator(), words, goal, cfg)
    for cls in (TR.Controller, TR.PipelinedController):
        with pytest.raises(ValueError, match="obs_format"):
            cls(params, goal, cfg, device="cpu")


def test_entry_runs():
    fn, args = tentry.entry("cpu")
    action, shifted, diag = fn(*args)
    cfg = tentry._small_cfg()
    assert tuple(action.shape) == (cfg.mppi.action_dim,)
    assert tuple(shifted.shape) == (cfg.mppi.horizon, cfg.mppi.action_dim)
    assert torch.isfinite(action).all()
    assert np.isfinite(float(diag["min_cost"]))


# --- on a card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_controller_launches_kernel_each_step(cuda, dtype):
    cfg = tentry._small_cfg()
    cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(
        cfg.dynamics, compute_dtype=dtype))
    ctl, same = _controller(cfg, cuda), _controller(cfg, cuda)
    assert ctl.graphed and same.graphed
    launches = bptc.KERNEL_LAUNCHES
    _serve(ctl, same, cfg)
    # One launch a step, which each replay counts, and each controller's
    # GRAPH_WARMUP eager steps before its capture.
    assert bptc.KERNEL_LAUNCHES == launches + 6 + 2 * TR.GRAPH_WARMUP


@pytest.mark.cuda
def test_cuda_control_step_kernel_vs_plain_decode(cuda, monkeypatch):
    """The step with the kernel's decode equals the step with the plain
    decode on the card, on the same noise (same ops, same card)."""
    fn, args = tentry.entry(cuda)
    cfg = tentry._small_cfg()
    eps = torch.randn((cfg.mppi.n_rollouts, cfg.mppi.horizon,
                       cfg.mppi.action_dim), device=cuda) * 0.3
    out_k = fn(*args, eps=eps)
    monkeypatch.setattr(bptc, "decode_bptc", bptc.decode_bptc_plain)
    out_p = fn(*args, eps=eps)
    for a, b in zip(out_k[:2], out_p[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("ilqr", [0, 1])
def test_cuda_pipelined_controller_matches_synchronous(cuda, ilqr):
    """On the card: the pipelined actions equal the synchronous ones one
    step later, and no step waits on the card while it enqueues (sync
    debug mode raises on any synchronising call; the step is a replay of
    the captured graph), with iLQR too."""
    cfg = dataclasses.replace(_pipeline_cfg(), n_ilqr_iterations=ilqr)
    sync_actions, pipe_actions, pipe = _pipelined_vs_sync(cfg, cuda, 5)
    assert pipe.graphed and pipe._program.graph is not None
    for t in range(1, 5):
        np.testing.assert_allclose(pipe_actions[t], sync_actions[t - 1],
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(pipe.flush(), sync_actions[-1], rtol=0,
                               atol=1e-6)
    words = _obs_words((cfg.dynamics.image_size // 4) ** 2, 60)
    pipe.step(words)
    torch.cuda.synchronize()
    pipe._pending = None            # nothing for the next step to wait on
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert pipe.step(words) is None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pipe.flush() is not None


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True])
def test_cuda_ilqr_step_finite(cuda, parallel):
    """iLQR steps on the card, captured: finite actions and costs, one BC7
    launch a step.  The refined plan is not clipped to the MPPI action
    bounds (nor is it in the JAX package), so the bounds are not held."""
    cfg = dataclasses.replace(tentry._small_cfg(), n_ilqr_iterations=2,
                              ilqr_parallel=parallel)
    ctl = _controller(cfg, cuda)
    assert ctl.graphed
    launches = bptc.KERNEL_LAUNCHES
    for i in range(3):
        action = ctl.step(_obs_words((cfg.dynamics.image_size // 4) ** 2,
                                     70 + i))
        assert action.shape == (cfg.mppi.action_dim,)
        assert np.isfinite(action).all()
        assert all(np.isfinite(float(v)) for v in ctl.diag.values())
    # One launch a replay, and the GRAPH_WARMUP eager steps of the capture.
    assert bptc.KERNEL_LAUNCHES == launches + 3 + TR.GRAPH_WARMUP


def _ilqr_step_inputs(parallel, seed):
    """A small float32 iLQR control step (latent 16, H 8, 2 iterations;
    the shapes of tests/test_torch_ilqr.py) on params whose output layer
    is damped by 0.05, so that the refined cost is well conditioned, and
    its words, goal, nominal and injected noise, all on the CPU."""
    cfg = TR.ControllerConfig(
        dynamics=TD.DynamicsConfig(
            image_size=16, conv_features=(8, 16), latent_dim=16,
            action_dim=4, hidden_dim=32, compute_dtype=torch.float32),
        mppi=TM.MPPIConfig(n_rollouts=64, horizon=8, action_dim=4),
        n_ilqr_iterations=2, ilqr_parallel=parallel)
    params = TD.init_params(cfg.dynamics,
                            torch.Generator().manual_seed(seed))
    params["dyn"]["out"]["w"] = params["dyn"]["out"]["w"] * 0.05
    rng = np.random.default_rng(300 + seed)
    mcfg = cfg.mppi
    words = torch.from_numpy(_obs_words(16, 310 + seed))
    goal = torch.from_numpy((0.5 * rng.standard_normal(16))
                            .astype(np.float32))
    nominal = torch.from_numpy(rng.uniform(
        -0.5, 0.5, (mcfg.horizon, mcfg.action_dim)).astype(np.float32))
    eps = torch.from_numpy((rng.standard_normal(
        (mcfg.n_rollouts, mcfg.horizon, mcfg.action_dim))
        * mcfg.noise_sigma).astype(np.float32))
    return cfg, params, (nominal, words, goal, eps)


def _to(params, device):
    return {part: {name: {k: v.to(device) for k, v in layer.items()}
                   for name, layer in layers.items()}
            for part, layers in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("parallel", [False, True])
def test_cuda_ilqr_step_matches_cpu(cuda, parallel, seed):
    """The iLQR control step on the card against the port's CPU step
    (which tests/test_torch_ilqr.py holds to JAX's) on the same damped
    params, words, goal, nominal and noise, at the CPU tests' tolerances:
    action and shifted nominal atol 1e-5, ilqr_cost and the MPPI costs
    rtol 1e-5; and the refinement lowered the cost below MPPI's best."""
    cfg, params, (nominal, words, goal, eps) = _ilqr_step_inputs(parallel,
                                                                  seed)
    with torch.no_grad():
        want = TR.control_step(params, nominal, None, words, goal, cfg,
                               eps=eps)
        got = TR.control_step(_to(params, cuda), nominal.to(cuda), None,
                              words.to(cuda), goal.to(cuda), cfg,
                              eps=eps.to(cuda))
    (ta, ts, td), (wa, ws, wd) = got, want
    assert float(td["ilqr_cost"]) < float(td["min_cost"])   # it refined
    np.testing.assert_allclose(ta.cpu().numpy(), wa.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ts.cpu().numpy(), ws.numpy(), rtol=0,
                               atol=1e-5)
    for k in ("ilqr_cost", "min_cost", "mean_cost", "ess"):
        np.testing.assert_allclose(float(td[k]), float(wd[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.cuda
def test_cuda_decode_obs_batch_one_launch(cuda):
    words = torch.from_numpy(_obs_words(8 * 256, 80).reshape(8, 256, 4))
    want = TR.decode_obs_batch(words, 64, 64)
    launches = bptc.KERNEL_LAUNCHES
    got = TR.decode_obs_batch(words.to(cuda), 64, 64)
    assert bptc.KERNEL_LAUNCHES == launches + 1
    assert torch.equal(got.cpu(), want)

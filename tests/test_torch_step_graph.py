"""The control step's one-program form (mpc/runtime.py: step_body,
_StepProgram; mpc/mppi.py: draw_noise): on the CPU, the body the CUDA graph
captures, run eagerly on its static buffers, against the JAX package's
control_step (which jax.jit serves as one program,
detex_tpu/mpc/runtime.py:158-160); the noise drawn into the static buffer
against the draw inside mppi_step; and the CPU Controller, which runs
the same body eagerly.  Tests marked `cuda` hold the graphed Controller
to the eager step on a card and skip here.

Tolerances (float32; the decode is bit-exact, so differences come only
from the summation order of convs, matmuls, the cost sums and iLQR's
jacobians and solves), as tests/test_torch_control_step.py and
tests/test_torch_ilqr.py state them:
  * action and the nominal the body leaves: atol 1e-5;
  * the diagnostics (min_cost, mean_cost, ess, ilqr_cost): rtol 1e-5.
On the card the graph replays the eager step's own kernels: MPPI is held
at atol 1e-6, iLQR at test_cuda_ilqr_step_matches_cpu's atol 1e-5; at
ControllerConfig()'s full width the parallel LQT bit-equal, its LU on
cuSOLVER/cuBLAS eager and captured (mpc/parallel_lqr._lu_library).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from detex_tpu_torch import entry as tentry
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.ops import bptc

_ILQR = [(0, False), (2, False), (2, True)]   # iterations, parallel LQT


@pytest.fixture(scope="module")
def jx():
    """The JAX package's control step and its modules."""
    import jax
    import jax.numpy as jnp

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import runtime
    return SimpleNamespace(jax=jax, jnp=jnp, JD=dynamics, JR=runtime)


def _cfg(cfg, n_ilqr, parallel, dtype):
    """cfg with `n_ilqr` iLQR iterations and the compute dtype `dtype`."""
    return dataclasses.replace(
        cfg, n_ilqr_iterations=n_ilqr, ilqr_parallel=parallel,
        dynamics=dataclasses.replace(cfg.dynamics, compute_dtype=dtype))


def _obs_words(n_blocks, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64) \
        .astype(np.int32)


@pytest.mark.parametrize("n_ilqr,parallel", _ILQR)
def test_step_body_parity_small_cfg_f32(jx, n_ilqr, parallel):
    """step_body on static buffers against JAX's control_step on the same
    params, words, goal, nominal and noise: the packed action and
    diagnostics, and the nominal it leaves in place, which is JAX's
    shifted plan.  With iLQR the output layer is damped by 0.05, as
    tests/test_torch_ilqr.py damps it, so the refined cost is well
    conditioned."""
    jax, jnp, JD, JR = jx.jax, jx.jnp, jx.JD, jx.JR
    jcfg = _cfg(graft._small_cfg(), n_ilqr, parallel, jnp.float32)
    tcfg = _cfg(tentry._small_cfg(), n_ilqr, parallel, torch.float32)
    dcfg, mcfg = jcfg.dynamics, jcfg.mppi
    jp = JD.init_params(jax.random.PRNGKey(5), dcfg)
    if n_ilqr:
        jp["dyn"]["out"]["w"] = jp["dyn"]["out"]["w"] * 0.05
    tp = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    words = _obs_words((dcfg.image_size // 4) ** 2, 50)
    rng = np.random.default_rng(51)
    goal = (0.5 * rng.standard_normal(dcfg.latent_dim)).astype(np.float32)
    nominal = rng.uniform(-0.5, 0.5, (mcfg.horizon, mcfg.action_dim)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(52)
    eps = np.array(jax.random.normal(
        key, (mcfg.n_rollouts, mcfg.horizon, mcfg.action_dim),
        jnp.float32) * mcfg.noise_sigma)
    ja, js, jd = jax.jit(lambda *a: JR.control_step(*a, cfg=jcfg))(
        jp, jnp.asarray(nominal), key, jnp.asarray(words), jnp.asarray(goal))

    nominal_buf = torch.from_numpy(nominal.copy())
    words_buf = torch.from_numpy(words)
    eps_buf = torch.from_numpy(eps)
    with torch.no_grad():
        packed, layout = TR.step_body(tp, nominal_buf, words_buf,
                                      torch.from_numpy(goal), eps_buf, tcfg)
    diag = TR.unpack_outputs(packed, layout)
    action = diag.pop("action")
    assert packed.dtype == torch.float32
    assert set(diag) == set(jd) == (
        {"min_cost", "mean_cost", "ess"} | ({"ilqr_cost"} if n_ilqr
                                            else set()))
    np.testing.assert_allclose(action.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(nominal_buf.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    for k in diag:
        np.testing.assert_allclose(float(diag[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)
    # The body is control_step itself: equal to it on the CPU bit for bit.
    with torch.no_grad():
        want_a, want_s, want_d = TR.control_step(
            tp, torch.from_numpy(nominal), None, words_buf,
            torch.from_numpy(goal), tcfg, eps=eps_buf)
    assert torch.equal(action, want_a) and torch.equal(nominal_buf, want_s)
    assert all(torch.equal(diag[k], want_d[k]) for k in diag)


@pytest.mark.parametrize("sigma", [0.3, 1.0, 0.07])
def test_draw_noise_is_mppi_steps_draw(sigma):
    """randn(out=..., generator=g) scaled in place is bit-equal to
    randn(shape, generator=g) * sigma, and leaves g in the same state."""
    shape = (64, 4, 3)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    buf = torch.full(shape, 7.0)
    got = TM.draw_noise(buf, g1, sigma)
    want = torch.randn(shape, generator=g2, dtype=torch.float32) * sigma
    assert got is buf and torch.equal(buf, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    # The next draw from each generator is the same too.
    assert torch.equal(torch.randn(5, generator=g1),
                       torch.randn(5, generator=g2))


def test_draw_noise_matches_the_noise_mppi_step_draws():
    """mppi_step drawing from a generator and mppi_step given the buffer
    that draw_noise filled from a generator seeded alike plan the same."""
    cfg = TM.MPPIConfig(n_rollouts=32, horizon=4, action_dim=3,
                        noise_sigma=0.4)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5 + 3, 5)).astype(np.float32))

    def dyn(z, u):
        return torch.tanh(torch.cat([z, u], -1) @ w)

    def cost(z, u, t):
        return (z ** 2).sum(-1) + 0.1 * (u ** 2).sum(-1)

    z0, nominal = torch.ones(5), torch.zeros((4, 3))
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    want, want_d = TM.mppi_step(nominal, z0, dyn, cost, cfg, generator=g1)
    eps = TM.draw_noise(torch.empty((32, 4, 3)), g2, cfg.noise_sigma)
    got, got_d = TM.mppi_step(nominal, z0, dyn, cost, cfg, eps=eps)
    assert torch.equal(got, want)
    assert all(torch.equal(got_d[k], want_d[k]) for k in want_d)
    assert torch.equal(g1.get_state(), g2.get_state())


def _params(cfg, device="cpu", seed=7, damp=1.0):
    params = TD.init_params(cfg.dynamics,
                            torch.Generator(device=device).manual_seed(seed),
                            device)
    params["dyn"]["out"]["w"] = params["dyn"]["out"]["w"] * damp
    return params


def _eager_steps(params, goal, cfg, obs, seed, device):
    """control_step served eagerly over `obs`, the nominal carried and the
    noise drawn from a generator seeded as a Controller seeds its own:
    ([(action, diagnostics as floats)], the generator)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          device=device)
    out = []
    with torch.no_grad():
        for w in obs:
            a, nominal, d = TR.control_step(
                params, nominal, gen, torch.as_tensor(w, device=device),
                goal, cfg)
            out.append((a.cpu().numpy(), {k: float(v) for k, v in d.items()}))
    return out, gen


@pytest.mark.parametrize("n_ilqr,parallel", _ILQR)
def test_cpu_controller_is_eager_and_matches_control_step(n_ilqr, parallel):
    cfg = _cfg(tentry._small_cfg(), n_ilqr, parallel, torch.float32)
    params, goal = _params(cfg, damp=0.05), torch.zeros(64)
    obs = [_obs_words(64, 90 + i) for i in range(3)]
    ctl = TR.Controller(params, goal, cfg, seed=3, device="cpu")
    assert ctl.graphed is False and ctl._program.graph is None
    with pytest.raises(AttributeError):
        ctl.graphed = True
    want, gen = _eager_steps(params, goal, cfg, obs, 3, "cpu")
    for w, (action, diag) in zip(obs, want):
        np.testing.assert_array_equal(ctl.step(w), action)
        assert {k: float(v) for k, v in ctl.diag.items()} == diag
    assert torch.equal(ctl.generator.get_state(), gen.get_state())
    assert ctl._program.graph is None


def test_step_program_refuses_the_cpu():
    """The step program's graph is built only for a card: asked to graph
    CPU buffers it raises rather than run eagerly under the graph's
    name."""
    cfg = tentry._small_cfg()
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim))
    words = torch.zeros((cfg.dynamics.image_size // 4) ** 2, 4,
                        dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TR._StepProgram(words, (nominal,), {}, None, None, graphed=True)


# --- on a card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graphed_vs_eager(cuda, n_ilqr, parallel, n=5):
    """A graphed Controller and the eager step over n observations, same
    seed, at _small_cfg() (bf16) with the output layer damped under iLQR:
    (controller, its [(action, diag)], the eager [(action, diag)], the
    eager generator)."""
    cfg = _cfg(tentry._small_cfg(), n_ilqr, parallel, torch.bfloat16)
    params = _params(cfg, cuda, damp=0.05 if n_ilqr else 1.0)
    goal = torch.zeros(64, device=cuda)
    obs = [_obs_words(64, 100 + i) for i in range(n)]
    ctl = TR.Controller(params, goal, cfg, seed=11, device=cuda)
    assert ctl.graphed
    got = []
    for w in obs:
        got.append((ctl.step(w), {k: float(v) for k, v in ctl.diag.items()}))
    want, gen = _eager_steps(params, goal, cfg, obs, 11, cuda)
    return ctl, got, want, gen


@pytest.mark.cuda
@pytest.mark.parametrize("n_ilqr,parallel", _ILQR)
def test_cuda_graphed_matches_eager(cuda, n_ilqr, parallel):
    _, got, want, _ = _graphed_vs_eager(cuda, n_ilqr, parallel)
    atol = 1e-5 if n_ilqr else 1e-6
    for (a, d), (wa, wd) in zip(got, want):
        np.testing.assert_allclose(a, wa, rtol=0, atol=atol)
        assert set(d) == set(wd)
        for k in d:
            np.testing.assert_allclose(d[k], wd[k], rtol=1e-5, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ilqr,parallel", _ILQR)
def test_cuda_graphed_generator_state(cuda, n_ilqr, parallel):
    """After k steps the graphed controller's generator is where the eager
    step's is: the capture drew nothing from it."""
    ctl, _, _, gen = _graphed_vs_eager(cuda, n_ilqr, parallel, n=3)
    assert torch.equal(ctl.generator.get_state(), gen.get_state())


@pytest.mark.cuda
def test_cuda_replay_counts_its_bc7_launch(cuda):
    """The capture records one BC7 launch and counts none; each replay
    counts the one it runs; the warm-ups count their own."""
    cfg = tentry._small_cfg()
    ctl = TR.Controller(_params(cfg, cuda), torch.zeros(64, device=cuda),
                        cfg, device=cuda)
    launches = bptc.KERNEL_LAUNCHES
    ctl.step(_obs_words(64, 1))
    assert ctl._program.launches_per_replay == 1
    assert bptc.KERNEL_LAUNCHES == launches + 1 + TR.GRAPH_WARMUP
    for i in range(3):
        launches = bptc.KERNEL_LAUNCHES
        ctl.step(_obs_words(64, 2 + i))
        assert bptc.KERNEL_LAUNCHES == launches + 1


@pytest.mark.cuda
def test_cuda_diag_holds_its_step(cuda):
    """Controller.diag after step k keeps step k's values through step
    k + 1's replay, equal to the eager step's."""
    ctl, _, want, _ = _graphed_vs_eager(cuda, 0, False, n=1)
    diag = ctl.diag
    ctl.step(_obs_words(64, 120))
    assert ctl.diag is not diag
    for k, v in diag.items():
        np.testing.assert_allclose(float(v), want[0][1][k], rtol=1e-5)
    assert float(diag["min_cost"]) != float(ctl.diag["min_cost"])


@pytest.mark.cuda
def test_cuda_full_width_parallel_lqt_eager_bit_equal_to_graph(cuda):
    """ControllerConfig() at full width, 2 iLQR iterations with the
    parallel LQT on damped dynamics toward a random goal, 5 steps: the
    eager control_step on the same noise gives the graphed Controller's
    actions bit for bit (both run the LQT's LU on cuSOLVER/cuBLAS; on
    torch's default routing, MAGMA, the eager step parted from the graph
    by up to 0.022 in 5 steps), and torch's LU setting reads after the
    steps as it did before them."""
    cfg = dataclasses.replace(TR.ControllerConfig(), n_ilqr_iterations=2,
                              ilqr_parallel=True)
    library = torch.backends.cuda.preferred_linalg_library()
    params = _params(cfg, cuda, damp=0.05)
    rng = np.random.default_rng(13)
    goal = torch.from_numpy((0.5 * rng.standard_normal(
        cfg.dynamics.latent_dim)).astype(np.float32)).to(cuda)
    n_blocks = (cfg.dynamics.image_size // 4) ** 2
    obs = [_obs_words(n_blocks, 200 + i) for i in range(5)]
    ctl = TR.Controller(params, goal, cfg, seed=11, device=cuda)
    got = [ctl.step(w) for w in obs]
    assert ctl.graphed
    want, gen = _eager_steps(params, goal, cfg, obs, 11, cuda)
    for a, (w, _) in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert torch.equal(ctl.generator.get_state(), gen.get_state())
    assert torch.backends.cuda.preferred_linalg_library() == library

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
from detex_tpu_torch.mpc import dynamics as TD
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


def test_controller_rejects_ilqr():
    cfg = dataclasses.replace(tentry._small_cfg(), n_ilqr_iterations=1)
    params = TD.init_params(cfg.dynamics, torch.Generator().manual_seed(0))
    goal = torch.zeros(cfg.dynamics.latent_dim)
    with pytest.raises(NotImplementedError):
        TR.Controller(params, goal, cfg)
    with pytest.raises(NotImplementedError):
        TR.control_step(params, torch.zeros(16, 8), None,
                        torch.zeros((64, 4), dtype=torch.int32), goal, cfg)


def test_entry_runs():
    fn, args = tentry.entry()
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
    launches = bptc.KERNEL_LAUNCHES
    _serve(ctl, same, cfg)
    assert bptc.KERNEL_LAUNCHES == launches + 6


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

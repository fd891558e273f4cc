"""Encoder, latent dynamics and MPPI in the PyTorch port against the JAX
package, on the same parameters (carried over by params_from_jax), the
same inputs and the same injected noise, made from numpy seeds.

Tolerances:
  * float32 compute: rtol 1e-5, atol 1e-5.  Both sides compute the same
    float32 products; only the summation order inside a conv or matmul
    differs.
  * bf16 compute: atol 1e-2 times the largest reference value (between
    two and three bf16 ulps).  Both sides round to bf16 at the same
    places, but a float32 sum that lands on the other side of a bf16
    rounding boundary moves that activation by one ulp downstream.
  * MPPI: rtol 1e-5 on the new nominal and the diagnostics, for the same
    summation-order reason; the weights exp(-(S - min S)/T) amplify cost
    differences by at most |dS|/T, which stays below 1e-5 here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detex_tpu.mpc import dynamics as JD
from detex_tpu.mpc import mppi as JM
from detex_tpu.mpc import runtime as JR
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import runtime as TR

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype, **kw):
    jdt, tdt = _DTYPES[dtype]
    shape = dict(dict(image_size=32, conv_features=(16, 32, 64),
                      latent_dim=64, action_dim=8, hidden_dim=256), **kw)
    return (JD.DynamicsConfig(compute_dtype=jdt, **shape),
            TD.DynamicsConfig(compute_dtype=tdt, **shape))


def _params(jcfg, seed=0):
    jp = JD.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, TD.params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


def test_init_params_shapes_and_scales():
    jcfg, tcfg = _cfgs("f32")
    jp = JD.init_params(jax.random.PRNGKey(0), jcfg)
    g = torch.Generator().manual_seed(0)
    tp = TD.init_params(tcfg, g)
    assert tp.keys() == jp.keys()
    for part in jp:
        assert tp[part].keys() == jp[part].keys()
        for name, p in jp[part].items():
            w = tp[part][name]["w"]
            want_shape = p["w"].shape
            if name.startswith("conv"):                 # HWIO -> OIHW
                want_shape = tuple(want_shape[i] for i in (3, 2, 0, 1))
                fan_in = w.shape[1] * 9
            else:
                fan_in = w.shape[0]
            assert tuple(w.shape) == want_shape and w.dtype == torch.float32
            assert tuple(tp[part][name]["b"].shape) == p["b"].shape
            assert not tp[part][name]["b"].any()
            # He-normal: std sqrt(2 / fan_in), within sampling error.
            assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.15


def test_params_from_jax_layouts():
    jcfg, _ = _cfgs("f32")
    jp, tp = _params(jcfg)
    w = np.asarray(jp["enc"]["conv1"]["w"])                 # (3,3,I,O)
    np.testing.assert_array_equal(tp["enc"]["conv1"]["w"][5, 2, 0, 1].item(),
                                  w[0, 1, 2, 5])
    np.testing.assert_array_equal(tp["dyn"]["fc0"]["w"].numpy(),
                                  np.asarray(jp["dyn"]["fc0"]["w"]))


@pytest.mark.parametrize("size", [8, 9, 16])
def test_conv_same_padding_stride2(size):
    """XLA's SAME for a 3x3 stride-2 conv pads 0 before and 1 after on an
    even size; torch's padding=1 would pad both sides and shift every
    output."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, window_strides=(2, 2), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ph = TD._same_pad(size)
    assert ph == ((0, 1) if size % 2 == 0 else (1, 1))
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                (ph[0], ph[1], ph[0], ph[1])),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=2)
    _close(got.permute(0, 2, 3, 1), want, "f32")


def test_dense_keeps_f32_accumulation():
    """JAX's bf16 dots with preferred_element_type=float32 return an
    unrounded float32 sum; the port's _dot_f32 does too, where a bf16
    torch.matmul would round its output to bf16."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 136)).astype(np.float32)
    w = rng.standard_normal((136, 96)).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    got = TD._dot_f32(torch.from_numpy(x), torch.from_numpy(w),
                      torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got, want, "f32")
    rounded = (torch.from_numpy(x).bfloat16() @ torch.from_numpy(w)
               .bfloat16()).float().numpy()
    assert np.abs(rounded - want).max() > 1e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("obs_dtype", ["uint8", "float32"])
def test_encode_parity(dtype, obs_dtype):
    """uint8 observations are scaled by a compute-dtype 1/255 after the
    cast (dynamics.py:99-101); float observations are not scaled."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 256, (3, 32, 32, 4)).astype(obs_dtype)
    if obs_dtype == "float32":
        obs /= 255.0
    want = JD.encode(jp, jnp.asarray(obs), jcfg)
    got = TD.encode(tp, torch.from_numpy(obs), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 64)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dynamics_apply_parity(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((128, 64)).astype(np.float32)
    u = rng.uniform(-1, 1, (128, 8)).astype(np.float32)
    want = JD.dynamics_apply(jp, jnp.asarray(z), jnp.asarray(u), jcfg)
    got = TD.dynamics_apply(tp, torch.from_numpy(z), torch.from_numpy(u),
                            tcfg)
    assert got.dtype == torch.float32
    _close(got, want, dtype)


def _mppi_problem(kind):
    """A small MPPI problem whose costs spread over a few units, so many
    rollouts carry weight (ESS well above 1)."""
    rng = np.random.default_rng(5)
    k, h, a, d = 256, 12, 8, 16
    cfg_kw = dict(n_rollouts=k, horizon=h, action_dim=a,
                  temperature=2.0, noise_sigma=0.3)
    jcfg, tcfg = JM.MPPIConfig(**cfg_kw), TM.MPPIConfig(**cfg_kw)
    eps = (rng.standard_normal((k, h, a)) * 0.3).astype(np.float32)
    nominal = rng.uniform(-0.5, 0.5, (h, a)).astype(np.float32)
    z0 = (0.3 * rng.standard_normal(d)).astype(np.float32)
    goal = (0.3 * rng.standard_normal(d)).astype(np.float32)
    if kind == "linear":
        am = (np.eye(d) * 0.9 + 0.02 * rng.standard_normal((d, d))) \
            .astype(np.float32)
        bm = (0.1 * rng.standard_normal((a, d))).astype(np.float32)
        jdyn = lambda z, u: z @ am + u @ bm               # noqa: E731
        tdyn = lambda z, u: z @ torch.from_numpy(am) \
            + u @ torch.from_numpy(bm)                      # noqa: E731
    else:
        jdc, tdc = _cfgs("f32", latent_dim=d, hidden_dim=64)
        jp, tp = _params(jdc, seed=3)
        # Shrink the residual so trajectories stay bounded over h steps.
        jp["dyn"]["out"]["w"] = jp["dyn"]["out"]["w"] * 0.05
        tp["dyn"]["out"]["w"] = tp["dyn"]["out"]["w"] * 0.05
        jdyn = lambda z, u: JD.dynamics_apply(jp, z, u, jdc)  # noqa: E731
        tdyn = lambda z, u: TD.dynamics_apply(tp, z, u, tdc)  # noqa: E731
    ccfg = dict(goal_weight=1.0, control_weight=0.1)
    jcost = JR.latent_cost_fn(jnp.asarray(goal),
                              JR.ControllerConfig(**ccfg))
    tcost = TR.latent_cost_fn(torch.from_numpy(goal),
                              TR.ControllerConfig(**ccfg))
    return (jcfg, tcfg, eps, nominal, z0, jdyn, tdyn, jcost, tcost)


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_mppi_update_parity(kind):
    jcfg, tcfg, eps, nominal, z0, jdyn, tdyn, jcost, tcost = \
        _mppi_problem(kind)
    want_nom, want_diag = JM._mppi_update(
        jnp.asarray(eps), jnp.asarray(nominal), jnp.asarray(z0), jdyn,
        jcost, jcfg, None, jcfg.n_rollouts)
    got_nom, got_diag = TM._mppi_update(
        torch.from_numpy(eps), torch.from_numpy(nominal),
        torch.from_numpy(z0), tdyn, tcost, tcfg, None, tcfg.n_rollouts)
    assert float(want_diag["ess"]) > 5          # the weights matter
    np.testing.assert_allclose(got_nom.numpy(), np.asarray(want_nom),
                               rtol=1e-5, atol=1e-6)
    for key in ("min_cost", "mean_cost", "ess"):
        np.testing.assert_allclose(float(got_diag[key]),
                                   float(want_diag[key]), rtol=1e-5,
                                   err_msg=key)


def test_rollout_costs_parity_with_terminal_cost():
    jcfg, tcfg, eps, nominal, z0, jdyn, tdyn, jcost, tcost = \
        _mppi_problem("linear")
    controls = np.clip(nominal[None] + eps, -1, 1)
    want = JM.rollout_costs(jdyn, jcost, jnp.asarray(z0),
                            jnp.asarray(controls),
                            terminal_cost=lambda z: jnp.sum(z * z, -1))
    got = TM.rollout_costs(tdyn, tcost, torch.from_numpy(z0),
                           torch.from_numpy(controls),
                           terminal_cost=lambda z: torch.sum(z * z, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_mppi_step_draws_eps_from_generator():
    """Without eps, mppi_step draws randn(K, H, A) * sigma from the
    generator: the same as handing it that noise."""
    _, tcfg, _, nominal, z0, _, tdyn, _, tcost = _mppi_problem("linear")
    nom = torch.from_numpy(nominal)
    z = torch.from_numpy(z0)
    drawn = TM.mppi_step(nom, z, tdyn, tcost, tcfg,
                         generator=torch.Generator().manual_seed(11))
    eps = torch.randn((tcfg.n_rollouts, tcfg.horizon, tcfg.action_dim),
                      generator=torch.Generator().manual_seed(11)) \
        * tcfg.noise_sigma
    given = TM.mppi_step(nom, z, tdyn, tcost, tcfg, eps=eps)
    assert torch.equal(drawn[0], given[0])
    other = TM.mppi_step(nom, z, tdyn, tcost, tcfg,
                         generator=torch.Generator().manual_seed(12))
    assert not torch.equal(drawn[0], other[0])


@pytest.mark.parametrize("kw", [{"rollout_axis": "dp"}, {"mesh": object()}])
def test_mppi_step_rejects_sharding(kw):
    _, tcfg, eps, nominal, z0, _, tdyn, _, tcost = _mppi_problem("linear")
    with pytest.raises(NotImplementedError):
        TM.mppi_step(torch.from_numpy(nominal), torch.from_numpy(z0), tdyn,
                     tcost, tcfg, eps=torch.from_numpy(eps), **kw)


def test_receding_horizon_shift():
    nominal = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.testing.assert_array_equal(
        TM.receding_horizon_shift(torch.from_numpy(nominal)).numpy(),
        np.asarray(JM.receding_horizon_shift(jnp.asarray(nominal))))


def test_config_defaults_match_jax():
    """The full-width slice is ControllerConfig()'s defaults on both
    sides (64x64 obs, features 32-256, latent 128, hidden 512, 8192 x 32
    rollouts)."""
    for jc, tc in ((JD.DynamicsConfig(), TD.DynamicsConfig()),
                   (JM.MPPIConfig(), TM.MPPIConfig())):
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        jd.pop("compute_dtype", None)
        assert td.pop("compute_dtype", torch.bfloat16) == torch.bfloat16
        assert jd == td

"""iLQR (sequential and parallel-LQT backward) and the control step with
iLQR refinement in the PyTorch port, against the JAX package and against
float64 Riccati references, on inputs made with numpy from seeds.

Tolerances (float32 unless stated):
  * ilqr_solve on the LQR problem of tests/test_mpc.py: total cost rtol
    1e-5 against JAX's and against the float64 Riccati solution;
  * ilqr_solve on the small latent dynamics (latent 16, H 8), 2
    iterations: xs, us, total cost rtol 1e-4, atol 1e-5.  Both sides
    compute the same float32 products; the summation order inside the
    jacobians, the batched line search and the solves differs;
  * the parallel LQT backward and its gains against JAX's (whose
    associative scan combines in another order) and against the
    sequential backward: rtol 1e-4, atol 1e-4 times the largest
    reference value;
  * the control step with n_ilqr_iterations=2 on the same noise: action
    atol 1e-5, ilqr_cost rtol 1e-5; at bf16 atol 1e-2 times the largest
    reference value, as tests/test_torch_mpc.py allows;
  * the float64 references of tests/test_parallel_lqr.py: 3e-4 and 2e-3,
    as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detex_tpu.mpc import dynamics as JD
from detex_tpu.mpc import ilqr as JI
from detex_tpu.mpc import mppi as JM
from detex_tpu.mpc import parallel_lqr as JPL
from detex_tpu.mpc import runtime as JR
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import ilqr as TI
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import parallel_lqr as TPL
from detex_tpu_torch.mpc import runtime as TR

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in arrays)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_scaled(got, want, rtol=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# --- the LQR problem of tests/test_mpc.py -------------------------------------


def _lqr_problem():
    n, m, h = 4, 2, 20
    rng = np.random.default_rng(0)
    a = (np.eye(n) + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
    b = (0.1 * rng.standard_normal((n, m))).astype(np.float32)
    q = np.eye(n, dtype=np.float32)
    r = (0.1 * np.eye(m)).astype(np.float32)
    x0 = rng.standard_normal(n).astype(np.float32)
    return a, b, q, r, x0, h


def _riccati_cost(a, b, q, r, x0, h):
    an, bn, qn, rn = (np.asarray(v, np.float64) for v in (a, b, q, r))
    p = qn.copy()
    gains = []
    for _ in range(h):
        k = np.linalg.solve(rn + bn.T @ p @ bn, bn.T @ p @ an)
        p = qn + an.T @ p @ (an - bn @ k)
        gains.append(k)
    x = np.asarray(x0, np.float64)
    total = 0.0
    for k in gains[::-1]:
        u = -k @ x
        total += 0.5 * (x @ qn @ x + u @ rn @ u)
        x = an @ x + bn @ u
    return total + 0.5 * x @ qn @ x


@pytest.mark.parametrize("parallel", [False, True])
def test_ilqr_matches_lqr(parallel):
    """Linear dynamics, quadratic costs: iLQR lands on the Riccati
    solution, as JAX's does."""
    a, b, q, r, x0, h = _lqr_problem()
    cfg_kw = dict(n_iterations=3, parallel=parallel)
    ja, jb, jq, jr = map(jnp.asarray, (a, b, q, r))
    _, jus, jtotal = jax.jit(lambda x, u: JI.ilqr_solve(
        lambda x, u: ja @ x + jb @ u,
        lambda x, u, t: 0.5 * (x @ jq @ x + u @ jr @ u),
        lambda x: 0.5 * x @ jq @ x, x, u, JI.ILQRConfig(**cfg_kw)))(
        jnp.asarray(x0), jnp.zeros((h, 2), jnp.float32))
    ta, tb, tq, tr = _t(a, b, q, r)
    txs, tus, ttotal = TI.ilqr_solve(
        lambda x, u: ta @ x + tb @ u,
        lambda x, u, t: 0.5 * (x @ tq @ x + u @ tr @ u),
        lambda x: 0.5 * x @ tq @ x, torch.from_numpy(x0),
        torch.zeros((h, 2)), TI.ILQRConfig(**cfg_kw))
    assert tuple(txs.shape) == (h + 1, 4) and tuple(tus.shape) == (h, 2)
    want = _riccati_cost(a, b, q, r, x0, h)
    np.testing.assert_allclose(float(ttotal), want, rtol=1e-5)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)
    _close(tus.numpy(), jus)


# --- the small latent dynamics -----------------------------------------------


def _latent_problem(dtype="f32", seed=0, damp=0.05):
    """The residual-MLP latent dynamics at latent 16, action 4, hidden 32,
    with the output layer scaled by `damp` so that trajectories stay
    bounded over the horizon (as tests/test_torch_mpc.py's MLP problem
    does), the latent goal cost and a plan of H = 8 controls."""
    jdt, tdt = _DTYPES[dtype]
    shape = dict(image_size=16, conv_features=(8, 16), latent_dim=16,
                 action_dim=4, hidden_dim=32)
    jdc = JD.DynamicsConfig(compute_dtype=jdt, **shape)
    tdc = TD.DynamicsConfig(compute_dtype=tdt, **shape)
    jp = JD.init_params(jax.random.PRNGKey(seed), jdc)
    jp["dyn"]["out"]["w"] = jp["dyn"]["out"]["w"] * damp
    tp = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(50 + seed)
    x0 = rng.standard_normal(16).astype(np.float32)
    goal = (0.5 * rng.standard_normal(16)).astype(np.float32)
    us0 = rng.uniform(-0.5, 0.5, (8, 4)).astype(np.float32)
    ccfg = dict(goal_weight=1.0, control_weight=0.1)
    jcost = JR.latent_cost_fn(jnp.asarray(goal), JR.ControllerConfig(**ccfg))
    tcost = TR.latent_cost_fn(torch.from_numpy(goal),
                              TR.ControllerConfig(**ccfg))
    return dict(
        jdyn=lambda x, u: JD.dynamics_apply(jp, x[None], u[None], jdc)[0],
        tdyn=lambda x, u: TD.dynamics_apply(tp, x[None], u[None], tdc)[0],
        jcost=lambda x, u, t: jcost(x[None], u[None], t)[0],
        tcost=lambda x, u, t: tcost(x[None], u[None], t)[0],
        x0=x0, us0=us0, jp=jp, tp=tp, jdc=jdc, tdc=tdc, goal=goal)


def _jterm(x):
    return jnp.float32(0.0)


def _tterm(x):
    return x.new_zeros(())


@pytest.mark.parametrize("parallel", [False, True])
def test_ilqr_solve_parity_latent_f32(parallel):
    pr = _latent_problem()
    cfg_kw = dict(n_iterations=2, parallel=parallel)
    jxs, jus, jtotal = jax.jit(lambda x, u: JI.ilqr_solve(
        pr["jdyn"], pr["jcost"], _jterm, x, u, JI.ILQRConfig(**cfg_kw)))(
        jnp.asarray(pr["x0"]), jnp.asarray(pr["us0"]))
    txs, tus, ttotal = TI.ilqr_solve(
        pr["tdyn"], pr["tcost"], _tterm, torch.from_numpy(pr["x0"]),
        torch.from_numpy(pr["us0"]), TI.ILQRConfig(**cfg_kw))
    start = TI.trajectory_cost(pr["tcost"], _tterm, TI._rollout(
        pr["tdyn"], torch.from_numpy(pr["x0"]),
        torch.from_numpy(pr["us0"])), torch.from_numpy(pr["us0"]))
    assert float(ttotal) < float(start)        # a step was taken
    _close(txs.numpy(), jxs)
    _close(tus.numpy(), jus)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4,
                               atol=1e-5)


def _linearisation():
    """The port's linearisation of the latent problem along its initial
    plan, as float32 tensors, and the same as numpy arrays."""
    pr = _latent_problem()
    x0, us0 = torch.from_numpy(pr["x0"]), torch.from_numpy(pr["us0"])
    xs = TI._rollout(pr["tdyn"], x0, us0)
    lin = TI.linearize(pr["tdyn"], pr["tcost"], _tterm, xs, us0)
    return lin, [v.numpy() for v in lin]


def test_linearize_parity():
    """Jacobians and cost derivatives of the port against JAX's
    vmap(jacfwd) / grad / hessian (ilqr.py:64-75) on one trajectory."""
    pr = _latent_problem()
    x0, us0 = torch.from_numpy(pr["x0"]), torch.from_numpy(pr["us0"])
    xs = TI._rollout(pr["tdyn"], x0, us0)
    got = TI.linearize(pr["tdyn"], pr["tcost"], _tterm, xs, us0)
    jx, ju = jnp.asarray(xs.numpy()[:-1]), jnp.asarray(pr["us0"])
    ts = jnp.arange(8)
    fx, fu = jax.vmap(jax.jacfwd(pr["jdyn"], argnums=(0, 1)))(jx, ju)
    lx, lu = jax.vmap(jax.grad(pr["jcost"], argnums=(0, 1)))(jx, ju, ts)
    lxx = jax.vmap(jax.hessian(pr["jcost"], argnums=0))(jx, ju, ts)
    luu = jax.vmap(jax.hessian(pr["jcost"], argnums=1))(jx, ju, ts)
    lux = jax.vmap(jax.jacfwd(jax.grad(pr["jcost"], argnums=1),
                              argnums=0))(jx, ju, ts)
    for g, w in zip(got, (fx, fu, lx, lu, lxx, luu, lux)):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, rtol=1e-5, atol=1e-6)
    assert not got[7].any() and not got[8].any()     # terminal cost 0


@pytest.mark.parametrize("reg", [1e-6, 1e-2])
def test_parallel_backward_parity_on_linearisation(reg):
    """The log-depth LQT backward and its gains on an iLQR linearisation:
    the port's against JAX's lqt_backward_parallel / lqt_gains and, at the
    starting regularisation, against its own sequential backward.  (The
    sequential pass adds reg only to the gains' solve, the parallel one to
    the subproblem's R, so the two part as reg grows, in both
    packages.)"""
    lin, npl = _linearisation()
    fx, fu, lx, lu, lxx, luu, lux, vx_t, vxx_t = npl
    h, n, m = fu.shape
    r_reg = luu + reg * np.eye(m, dtype=np.float32)[None]
    zeros_c = np.zeros((h, n), np.float32)
    jargs = tuple(map(jnp.asarray, (fx, fu, zeros_c, lxx, lx, r_reg, lu,
                                    lux, vxx_t, vx_t)))
    jp_all, jeta = jax.jit(JPL.lqt_backward_parallel)(*jargs)
    jk, jkff = jax.jit(JPL.lqt_gains)(jargs[0], jargs[1], jargs[2], jargs[5],
                                      jargs[6], jargs[7], jp_all[1:],
                                      jeta[1:])
    targs = _t(fx, fu, zeros_c, lxx, lx, r_reg, lu, lux, vxx_t, vx_t)
    tp_all, teta = TPL.lqt_backward_parallel(*targs)
    tk, tkff = TPL.lqt_gains(targs[0], targs[1], targs[2], targs[5],
                             targs[6], targs[7], tp_all[1:], teta[1:])
    _close_scaled(tp_all.numpy(), jp_all)
    _close_scaled(teta.numpy(), jeta)
    _close_scaled(tk.numpy(), jk)
    _close_scaled(tkff.numpy(), jkff)
    regt = torch.tensor(reg, dtype=torch.float32)
    ks_p, bigks_p = TI.backward_parallel(*lin, regt)
    _close_scaled(ks_p.numpy(), -np.asarray(jkff))
    _close_scaled(bigks_p.numpy(), -np.asarray(jk))
    if reg == TI.ILQRConfig().reg_init:
        ks, bigks = TI.backward(*lin, regt)
        _close_scaled(ks_p.numpy(), ks.numpy())
        _close_scaled(bigks_p.numpy(), bigks.numpy())


@pytest.mark.parametrize("horizon", [8, 32])
def test_parallel_backward_matches_sequential_undamped_f64(horizon):
    """On undamped random latent dynamics (latent 32, hidden 64) the
    trajectory grows without bound and the value matrices with it, so the
    float32 recursions part; the same linearisation in float64 at reg 0,
    where both backwards solve the same Riccati recursion, gives the same
    gains within 1e-9 of the largest one, ill-conditioned elements and
    all."""
    dcfg = TD.DynamicsConfig(image_size=16, conv_features=(8, 16),
                             latent_dim=32, action_dim=4, hidden_dim=64,
                             compute_dtype=torch.float32)
    params = TD.init_params(dcfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(60)
    x0 = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    us = torch.from_numpy(rng.uniform(-0.5, 0.5, (horizon, 4))
                          .astype(np.float32))
    cost = TR.latent_cost_fn(torch.zeros(32), TR.ControllerConfig())

    def dyn(x, u):
        return TD.dynamics_apply(params, x[None], u[None], dcfg)[0]

    def cost1(x, u, t):
        return cost(x[None], u[None], t)[0]

    with torch.no_grad():
        xs = TI._rollout(dyn, x0, us)
        lin = [d.double() for d in TI.linearize(dyn, cost1, _tterm, xs, us)]
        reg = torch.zeros((), dtype=torch.float64)
        seq = TI.backward(*lin, reg)
        par = TI.backward_parallel(*lin, reg)
    assert float(xs[-1].norm()) > 1e3            # the growth is real
    for a, b in zip(par, seq):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-9 * float(b.abs().max()))


# --- the float64 references of tests/test_parallel_lqr.py ----------------------


def _random_lqr(h, n, m, seed=0, time_varying=True):
    rng = np.random.default_rng(seed)
    if time_varying:
        f = np.eye(n) + 0.05 * rng.standard_normal((h, n, n))
        lm = 0.2 * rng.standard_normal((h, n, m))
    else:
        f = np.broadcast_to(np.eye(n) + 0.05 * rng.standard_normal((n, n)),
                            (h, n, n)).copy()
        lm = np.broadcast_to(0.2 * rng.standard_normal((n, m)),
                             (h, n, m)).copy()
    c = 0.1 * rng.standard_normal((h, n))
    q = np.broadcast_to(np.eye(n), (h, n, n)).copy()
    r = np.broadcast_to(0.5 * np.eye(m), (h, m, m)).copy()
    qt = 2.0 * np.eye(n)
    return tuple(np.asarray(a, np.float32) for a in (f, lm, c, q, r, qt))


def _sequential_value(f, lm, c, q, r, qt):
    """Float64 Riccati recursion with linear terms: (P, v) per time."""
    f, lm, c, q, r = (np.asarray(a, np.float64) for a in (f, lm, c, q, r))
    p = np.asarray(qt, np.float64)
    v = np.zeros(f.shape[1])
    ps, vs = [p], [v]
    for t in range(f.shape[0] - 1, -1, -1):
        quu = r[t] + lm[t].T @ p @ lm[t]
        qux = lm[t].T @ p @ f[t]
        qu = lm[t].T @ (p @ c[t] + v)
        k = np.linalg.solve(quu, qux)
        kff = np.linalg.solve(quu, qu)
        p_new = q[t] + f[t].T @ p @ f[t] - qux.T @ k
        v = f[t].T @ (p @ c[t] + v) - qux.T @ kff
        p = 0.5 * (p_new + p_new.T)
        ps.append(p)
        vs.append(v)
    return np.stack(ps[::-1]), np.stack(vs[::-1])


def test_parallel_value_matches_riccati():
    prob = _random_lqr(32, 4, 2)
    p_par, eta_par = TPL.lqr_backward_parallel(*_t(*prob))
    p_seq, v_seq = _sequential_value(*prob)
    np.testing.assert_allclose(p_par.numpy(), p_seq, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(-eta_par.numpy(), v_seq, rtol=2e-4,
                               atol=2e-4)
    jp_par, jeta = jax.jit(JPL.lqr_backward_parallel)(
        *map(jnp.asarray, prob))
    _close_scaled(p_par.numpy(), jp_par)
    _close_scaled(eta_par.numpy(), jeta)


def test_parallel_solve_trajectory_optimal():
    f, lm, c, q, r, qt = prob = _random_lqr(16, 4, 2, seed=3)
    x0 = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    xs, us = TPL.lqr_solve_parallel(*_t(*prob), torch.from_numpy(x0))
    jxs, jus = jax.jit(JPL.lqr_solve_parallel)(*map(jnp.asarray, prob),
                                               jnp.asarray(x0))
    _close(xs.numpy(), jxs, rtol=1e-4, atol=1e-5)
    _close(us.numpy(), jus, rtol=1e-4, atol=1e-5)
    p_seq, v_seq = _sequential_value(*prob)
    f64, l64, c64, r64 = (np.asarray(a, np.float64) for a in (f, lm, c, r))
    x = np.asarray(x0, np.float64)
    for t in range(16):
        quu = r64[t] + l64[t].T @ p_seq[t + 1] @ l64[t]
        u = -np.linalg.solve(quu, l64[t].T @ (
            p_seq[t + 1] @ (f64[t] @ x + c64[t]) + v_seq[t + 1]))
        np.testing.assert_allclose(us[t].numpy(), u, rtol=2e-3, atol=2e-3)
        x = f64[t] @ x + l64[t] @ u + c64[t]
        np.testing.assert_allclose(xs[t + 1].numpy(), x, rtol=2e-3,
                                   atol=2e-3)


def test_parallel_long_horizon_stable():
    """H = 512: ten levels of combines stay finite and symmetric."""
    prob = _random_lqr(512, 4, 2, seed=5, time_varying=False)
    p_par, _ = TPL.lqr_backward_parallel(*_t(*prob))
    p0 = p_par[0].numpy()
    assert np.isfinite(p0).all()
    np.testing.assert_allclose(p0, p0.T, atol=1e-3)


def _random_lqt(h, n, m, seed=0):
    rng = np.random.default_rng(seed)
    f = np.eye(n) + 0.05 * rng.standard_normal((h, n, n))
    lm = 0.2 * rng.standard_normal((h, n, m))
    c = 0.1 * rng.standard_normal((h, n))
    qh = rng.standard_normal((h, n, n))
    q = 0.1 * qh @ qh.transpose(0, 2, 1) + np.eye(n)
    qv = rng.standard_normal((h, n))
    rh = rng.standard_normal((h, m, m))
    r = 0.1 * rh @ rh.transpose(0, 2, 1) + np.eye(m)
    rv = rng.standard_normal((h, m))
    mm = 0.2 * rng.standard_normal((h, m, n))
    pt = 2.0 * np.eye(n)
    pv = rng.standard_normal(n)
    return tuple(np.asarray(a, np.float32)
                 for a in (f, lm, c, q, qv, r, rv, mm, pt, pv))


def _sequential_lqt(f, lm, c, q, qv, r, rv, mm, pt, pv):
    """Float64 Riccati with linear and cross terms: P, p, K, kff."""
    f, lm, c, q, qv, r, rv, mm = (np.asarray(a, np.float64)
                                  for a in (f, lm, c, q, qv, r, rv, mm))
    p, pv_ = np.asarray(pt, np.float64), np.asarray(pv, np.float64)
    ps, pvs, ks, kffs = [p], [pv_], [], []
    for t in range(f.shape[0] - 1, -1, -1):
        quu = r[t] + lm[t].T @ p @ lm[t]
        qux = mm[t] + lm[t].T @ p @ f[t]
        qu = rv[t] + lm[t].T @ (p @ c[t] + pv_)
        qx = qv[t] + f[t].T @ (p @ c[t] + pv_)
        qxx = q[t] + f[t].T @ p @ f[t]
        k = np.linalg.solve(quu, qux)
        kff = np.linalg.solve(quu, qu)
        p = qxx - qux.T @ k
        p = 0.5 * (p + p.T)
        pv_ = qx - qux.T @ kff
        ps.insert(0, p)
        pvs.insert(0, pv_)
        ks.insert(0, k)
        kffs.insert(0, kff)
    return np.stack(ps), np.stack(pvs), np.stack(ks), np.stack(kffs)


@pytest.mark.parametrize("h", [1, 7, 24, 32])
def test_lqt_backward_matches_sequential(h):
    """Every horizon length: the scan's ragged last level (H + 1 not a
    power of two) and the single-stage case."""
    prob = _random_lqt(h, 5, 3, seed=11 + h)
    f, lm, c, q, qv, r, rv, mm, pt, pv = targs = _t(*prob)
    p_par, eta = TPL.lqt_backward_parallel(*targs)
    p_seq, pv_seq, k_seq, kff_seq = _sequential_lqt(*prob)
    np.testing.assert_allclose(p_par.numpy(), p_seq, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(-eta.numpy(), pv_seq, rtol=3e-4, atol=3e-4)
    k_par, kff_par = TPL.lqt_gains(f, lm, c, r, rv, mm, p_par[1:], eta[1:])
    np.testing.assert_allclose(k_par.numpy(), k_seq, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(kff_par.numpy(), kff_seq, rtol=3e-4,
                               atol=3e-4)
    jp, jeta = jax.jit(JPL.lqt_backward_parallel)(*map(jnp.asarray, prob))
    _close_scaled(p_par.numpy(), jp)
    _close_scaled(eta.numpy(), jeta)


def test_combine_identity_and_associativity():
    prob = _random_lqt(3, 4, 2, seed=2)
    elems = TPL._lqt_elements(*_t(*prob))
    e = [tuple(x[i:i + 1] for x in elems) for i in range(4)]
    ident = TPL._identity_elements(1, 4)
    for a, b in zip(TPL._combine(e[0], ident), e[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(TPL._combine(ident, e[1]), e[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    left = TPL._combine(TPL._combine(e[0], e[1]), e[2])
    right = TPL._combine(e[0], TPL._combine(e[1], e[2]))
    for a, b in zip(left, right):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    jcomb = JPL._combine(tuple(jnp.asarray(x[0].numpy()) for x in e[0]),
                         tuple(jnp.asarray(x[0].numpy()) for x in e[1]))
    for a, b in zip(TPL._combine(e[0], e[1]), jcomb):
        _close(a[0].numpy(), b, rtol=1e-5, atol=1e-5)


def test_ilqr_parallel_matches_sequential_pendulum():
    """ilqr_solve(parallel=True) == the sequential backward on a
    nonlinear pendulum-like problem (tests/test_parallel_lqr.py)."""
    def dyn(x, u):
        omega2 = x[1] + 0.1 * (u[0] - torch.sin(x[0]) - 0.1 * x[1])
        return torch.stack([x[0] + 0.1 * omega2, omega2])

    def cost(x, u, t):
        return torch.sum(x ** 2) + 0.1 * torch.sum(u ** 2)

    def term(x):
        return 10.0 * torch.sum(x ** 2)

    x0 = torch.tensor([1.5, 0.0])
    us0 = torch.zeros((20, 1))
    _, us_a, c_a = TI.ilqr_solve(dyn, cost, term, x0, us0,
                                 TI.ILQRConfig(n_iterations=8))
    _, us_b, c_b = TI.ilqr_solve(dyn, cost, term, x0, us0,
                                 TI.ILQRConfig(n_iterations=8, parallel=True))
    c_init = TI.trajectory_cost(cost, term, TI._rollout(dyn, x0, us0), us0)
    assert float(c_a) < float(c_init)
    np.testing.assert_allclose(float(c_b), float(c_a), rtol=1e-3)
    np.testing.assert_allclose(us_b.numpy(), us_a.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_ilqr_rejects_a_failed_factorisation():
    """A quu that is not positive definite gives NaN gains, whose
    rollouts cost NaN: the step is rejected and the plan kept, with no
    error raised and no value read back."""
    def dyn(x, u):
        return x + u

    def cost(x, u, t):
        return torch.sum(x ** 2) - torch.sum(u ** 2)      # concave in u

    x0 = torch.ones(2)
    us0 = torch.full((4, 2), 0.1)
    xs, us, total = TI.ilqr_solve(dyn, cost, lambda x: x.new_zeros(()), x0,
                                  us0, TI.ILQRConfig(n_iterations=2))
    assert torch.equal(us, us0)
    assert torch.equal(xs, TI._rollout(dyn, x0, us0))
    assert torch.isfinite(total)


# --- the control step with iLQR ------------------------------------------------


def _step_cfgs(dtype, parallel):
    jdt, tdt = _DTYPES[dtype]
    shape = dict(image_size=16, conv_features=(8, 16), latent_dim=16,
                 action_dim=4, hidden_dim=32)
    mppi = dict(n_rollouts=64, horizon=8, action_dim=4)
    kw = dict(n_ilqr_iterations=2, ilqr_parallel=parallel)
    return (JR.ControllerConfig(dynamics=JD.DynamicsConfig(
                compute_dtype=jdt, **shape), mppi=JM.MPPIConfig(**mppi),
                **kw),
            TR.ControllerConfig(dynamics=TD.DynamicsConfig(
                compute_dtype=tdt, **shape), mppi=TM.MPPIConfig(**mppi),
                **kw))


def _control_steps(dtype, parallel, seed):
    """The JAX and the port's control step with 2 iLQR iterations on the
    same params (output layer damped as in _latent_problem), words, goal,
    nominal and noise."""
    jcfg, tcfg = _step_cfgs(dtype, parallel)
    mcfg = jcfg.mppi
    jp = JD.init_params(jax.random.PRNGKey(seed), jcfg.dynamics)
    jp["dyn"]["out"]["w"] = jp["dyn"]["out"]["w"] * 0.05
    tp = TD.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(200 + seed)
    words = rng.integers(-2**31, 2**31, (16, 4), np.int64).astype(np.int32)
    goal = (0.5 * rng.standard_normal(16)).astype(np.float32)
    nominal = rng.uniform(-0.5, 0.5, (mcfg.horizon, mcfg.action_dim)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(30 + seed)
    eps = np.array(jax.random.normal(
        key, (mcfg.n_rollouts, mcfg.horizon, mcfg.action_dim),
        jnp.float32) * mcfg.noise_sigma)
    want = jax.jit(lambda *a: JR.control_step(*a, cfg=jcfg))(
        jp, jnp.asarray(nominal), key, jnp.asarray(words), jnp.asarray(goal))
    with torch.no_grad():
        got = TR.control_step(tp, torch.from_numpy(nominal), None,
                              torch.from_numpy(words),
                              torch.from_numpy(goal), tcfg,
                              eps=torch.from_numpy(eps))
    return want, got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("parallel", [False, True])
def test_control_step_ilqr_parity_f32(parallel, seed):
    (ja, js, jd), (ta, ts, td) = _control_steps("f32", parallel, seed)
    assert float(td["ilqr_cost"]) < float(td["min_cost"])   # it refined
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    for k in ("ilqr_cost", "min_cost", "mean_cost", "ess"):
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("parallel", [False, True])
def test_control_step_ilqr_parity_bf16(parallel):
    (ja, js, jd), (ta, ts, td) = _control_steps("bf16", parallel, 0)
    for got, want in ((ta, ja), (ts, js)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
    np.testing.assert_allclose(float(td["ilqr_cost"]), float(jd["ilqr_cost"]),
                               rtol=1e-2)


def test_controller_serves_ilqr_steps_on_cpu():
    """Controller.step runs under torch.no_grad; torch.func's jacobians
    and hessians work there."""
    _, tcfg = _step_cfgs("f32", False)
    params = TD.init_params(tcfg.dynamics, torch.Generator().manual_seed(0))
    ctl = TR.Controller(params, torch.zeros(16), tcfg, seed=1, device="cpu")
    for i in range(2):
        words = np.random.default_rng(i).integers(
            -2**31, 2**31, (16, 4), np.int64).astype(np.int32)
        action = ctl.step(words)
        assert action.shape == (4,) and np.isfinite(action).all()
        assert np.isfinite(float(ctl.diag["ilqr_cost"]))


def test_mppi_improves_and_lands_near_ilqr_optimum():
    """The port of tests/test_mpc.py's MPPI convergence test: 30 MPPI
    updates on a 2-D double integrator come within 15% of the iLQR
    optimum."""
    dt = 0.1

    def dyn(z, u):
        vel2 = z[:, 2:] + dt * u
        return torch.cat([z[:, :2] + dt * vel2, vel2], dim=-1)

    def cost(z, u, t):
        return torch.sum(z[:, :2] ** 2, -1) + 0.1 * torch.sum(u ** 2, -1)

    cfg = TM.MPPIConfig(n_rollouts=1024, horizon=16, action_dim=2,
                        noise_sigma=1.0, temperature=0.1, action_low=-10.0,
                        action_high=10.0)
    z0 = torch.tensor([2.0, -1.0, 0.0, 0.0])
    nominal = torch.zeros((16, 2))
    gen = torch.Generator().manual_seed(0)

    def plan_cost(nom):
        return float(TM.rollout_costs(dyn, cost, z0, nom[None])[0])

    c0 = plan_cost(nominal)
    for _ in range(30):
        nominal, diag = TM.mppi_step(nominal, z0, dyn, cost, cfg,
                                     generator=gen)
    c1 = plan_cost(nominal)
    assert np.isfinite(float(diag["ess"]))
    _, _, opt = TI.ilqr_solve(lambda x, u: dyn(x[None], u[None])[0],
                              lambda x, u, t: cost(x[None], u[None], t)[0],
                              lambda x: x.new_zeros(()), z0, nominal,
                              TI.ILQRConfig(n_iterations=5))
    assert c1 < c0
    assert c1 < 1.15 * float(opt), (c1, float(opt))


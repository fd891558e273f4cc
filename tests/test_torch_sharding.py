"""The port's sharded paths against the JAX package's shard_map paths and
against the port's own unsharded functions: rollout-sharded MPPI (flat
over "dp" and hierarchical over ("dcn", "ici")), the control step on a
dp x tp mesh, decode_blocks_sharded, the horizon-sharded LQT, and the
collective volume of MPPI and the LQT (counterparts of
tests/test_mppi_sharding.py, test_parallel_lqr.py::
test_lqt_sharded_matches_unsharded, test_collective_volume.py and
test_mpc.py::test_mppi_sharded_over_mesh).

The port's ranks are spawned processes in a gloo group
(parallel.launch.run_ranks: one spawn per world size, 2, 4 and 8, with
its own time limit); the JAX references run in the test process on its 8
virtual CPU devices, on the same inputs (the noise is JAX's, drawn from
its key).  Tolerances:
  * MPPI against the port's unsharded step, on the toy problem of
    tests/test_mppi_sharding.py: JAX's own, nominal rtol 2e-5 / atol
    2e-6, min_cost, mean_cost and ess rtol 2e-5;
  * MPPI against JAX's shard_map step: the port's unsharded parity
    tolerance (tests/test_torch_mpc.py), rtol 1e-5 / atol 1e-6, on that
    test's linear problem.  (The toy problem's costs are about 1.8e4 at
    an ESS of 1.02, so float32 rounding in the rollout sums moves the
    plan by 8e-5 between the two packages even unsharded.)
  * the control step against the port's unsharded step rtol 3e-5 /
    atol 3e-6; against JAX's sharded step, and the controllers' served
    steps (each from the last one's plan) against the unsharded ones, atol
    1e-5 (the tolerance of the port's unsharded parity test,
    tests/test_torch_control_step.py);
  * the LQT rtol 2e-4 / atol 2e-4;
  * the decode bit-exact, with no collective bytes.
The collective volume is exact: the port counts the bytes of each
collective's result (parallel/mesh.py COLLECTIVE_BYTES), as the JAX test
sums the result shapes of the compiled collectives.

Tests marked `cuda` run at one rank over NCCL on a card and skip here.
The card's machine has no JAX, so the JAX package is imported only inside
the `jx` fixture, and the ranks import this module without it.
"""

import dataclasses
import functools
import gc
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from detex_tpu_torch import engine
from detex_tpu_torch import entry
from detex_tpu_torch import formats as F
from detex_tpu_torch import io as PIO
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import parallel_lqr as TPL
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.ops import bptc
from detex_tpu_torch.parallel import launch
from detex_tpu_torch.parallel import mesh as PM
from detex_tpu_torch.texture import Texture

_TIMEOUT = 150.0
K, H, A, N_STATE = 64, 8, 4, 6
_MPPI = dict(n_rollouts=K, horizon=H, action_dim=A, noise_sigma=0.5,
             temperature=0.7)
_LQT_H = (31, 32, 64)
_LQT_N, _LQT_M = 5, 3
_DECODE_N = 256
_FORMATS = (F.BC1, F.BC1A, F.BC2, F.BC3, F.RGTC1, F.SIGNED_RGTC1, F.RGTC2,
            F.SIGNED_RGTC2, F.BPTC_FLOAT, F.BPTC_SIGNED_FLOAT, F.BPTC,
            F.ETC1, F.ETC2, F.ETC2_PUNCHTHROUGH, F.ETC2_EAC, F.EAC_R11,
            F.EAC_SIGNED_R11, F.EAC_RG11, F.EAC_SIGNED_RG11)
# tests/test_mppi_sharding.py::test_control_step_sharded_matches, at f32.
_SHAPE = dict(image_size=16, conv_features=(8, 16), latent_dim=32,
              action_dim=4, hidden_dim=64)
_CTRL_MPPI = dict(n_rollouts=64, horizon=4, action_dim=4)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's sharded functions, on its virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import mppi
    from detex_tpu.mpc import parallel_lqr
    from detex_tpu.mpc import runtime
    return SimpleNamespace(jax=jax, jnp=jnp, Mesh=Mesh, JD=dynamics,
                           JM=mppi, JPL=parallel_lqr, JR=runtime)


# --- problems (numpy, so the ranks need no JAX) ----------------------------


def _toy():
    """tests/test_mppi_sharding.py:_toy_problem's arrays."""
    rng = np.random.default_rng(7)
    f = (rng.standard_normal((N_STATE, N_STATE)) * 0.3
         + np.eye(N_STATE)).astype(np.float32)
    l = (rng.standard_normal((N_STATE, A)) * 0.2).astype(np.float32)
    goal = rng.standard_normal(N_STATE).astype(np.float32)
    z0 = rng.standard_normal(N_STATE).astype(np.float32)
    nominal = (rng.standard_normal((H, A)) * 0.1).astype(np.float32)
    return f, l, goal, z0, nominal


def _toy_torch(k=K):
    """(dyn, cost, z0, nominal, cfg) of the toy problem in the port."""
    f, l, goal, z0, nominal = (torch.from_numpy(x) for x in _toy())
    cfg = TM.MPPIConfig(**dict(_MPPI, n_rollouts=k))

    def dyn(z, u):
        return z @ f.T + u @ l.T

    def cost(z, u, t):
        return torch.sum((z - goal) ** 2, dim=-1) + 0.1 * torch.sum(
            u ** 2, dim=-1)
    return dyn, cost, z0, nominal, cfg


def _linear():
    """tests/test_torch_mpc.py:_mppi_problem("linear")'s arrays (its noise
    is drawn and dropped: the noise here is JAX's)."""
    rng = np.random.default_rng(5)
    k, h, a, d = 256, 12, 8, 16
    rng.standard_normal((k, h, a))
    nominal = rng.uniform(-0.5, 0.5, (h, a)).astype(np.float32)
    z0 = (0.3 * rng.standard_normal(d)).astype(np.float32)
    goal = (0.3 * rng.standard_normal(d)).astype(np.float32)
    am = (np.eye(d) * 0.9 + 0.02 * rng.standard_normal((d, d))) \
        .astype(np.float32)
    bm = (0.1 * rng.standard_normal((a, d))).astype(np.float32)
    cfg = dict(n_rollouts=k, horizon=h, action_dim=a, temperature=2.0,
               noise_sigma=0.3)
    return am, bm, goal, z0, nominal, cfg


def _linear_torch():
    am, bm, goal, z0, nominal, cfg = _linear()
    am, bm, goal = (torch.from_numpy(x) for x in (am, bm, goal))

    def dyn(z, u):
        return z @ am + u @ bm

    def cost(z, u, t):
        return torch.sum((z - goal) ** 2, dim=-1) + 0.1 * torch.sum(
            u ** 2, dim=-1)
    return (dyn, cost, torch.from_numpy(z0), torch.from_numpy(nominal),
            TM.MPPIConfig(**cfg))


def _random_lqt(h, n=_LQT_N, m=_LQT_M, seed=0):
    """tests/test_parallel_lqr.py:_random_lqt's problem, as float32."""
    rng = np.random.default_rng(seed)
    f = np.eye(n) + 0.05 * rng.standard_normal((h, n, n))
    l = 0.2 * rng.standard_normal((h, n, m))
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
                 for a in (f, l, c, q, qv, r, rv, mm, pt, pv))


def _tensors(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _blocks(fmt):
    rng = np.random.default_rng(fmt & 0xFFFF)
    blocks = rng.integers(0, 256, (_DECODE_N, F.block_size_bytes(fmt)),
                          np.uint8)
    return np.ascontiguousarray(blocks).view(np.int32).reshape(
        _DECODE_N, -1)


def _ctrl_cfg(rollout_axis=None):
    return TR.ControllerConfig(
        dynamics=TD.DynamicsConfig(compute_dtype=torch.float32, **_SHAPE),
        mppi=TM.MPPIConfig(**_CTRL_MPPI), rollout_axis=rollout_axis)


def _bytes():
    return {f"{op}/{axis}": v for (op, axis), v in
            PM.COLLECTIVE_BYTES.items()}


# --- the ranks -------------------------------------------------------------


def _mppi(mesh, axis, eps=None, seed=None, k=K):
    dyn, cost, z0, nominal, cfg = _toy_torch(k)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return TM.mppi_step(nominal, z0, dyn, cost, cfg, eps=eps,
                        generator=gen, rollout_axis=axis, mesh=mesh)


def _linear_mppi(mesh, axis, eps):
    dyn, cost, z0, nominal, cfg = _linear_torch()
    return TM.mppi_step(nominal, z0, dyn, cost, cfg,
                        eps=torch.tensor(eps), rollout_axis=axis,
                        mesh=mesh)


def _rank(rank, inputs):
    n = dist.get_world_size()
    out = {}
    mesh = PM.make_mesh((n, 1), device="cpu")
    out["mppi"] = _mppi(mesh, "dp", eps=torch.tensor(inputs["eps"]))
    out["mppi_gen"] = _mppi(mesh, "dp", seed=5)
    out["linear"] = _linear_mppi(mesh, "dp", inputs["linear_eps"])
    sp = PM.make_mesh((n,), ("sp",), device="cpu")
    out["lqt"] = {h: TPL.lqt_backward_parallel_sharded(
        *_tensors(_random_lqt(h, seed=h)), mesh=sp, axis="sp")
        for h in _LQT_H}
    if n != 4:
        return out
    hmesh = PM.make_mesh((2, 2), ("dcn", "ici"), device="cpu")
    PM.reset_collective_bytes()
    out["hier"] = _mppi(hmesh, ("dcn", "ici"),
                        eps=torch.tensor(inputs["eps"]))
    out["hier_bytes"] = _bytes()
    out["hier_linear"] = _linear_mppi(hmesh, ("dcn", "ici"),
                                      inputs["linear_eps"])
    try:
        _mppi(mesh, "dp", seed=0, k=66)
        out["k_66"] = "no error"
    except ValueError as e:
        out["k_66"] = str(e)
    out["mppi_bytes"] = {}
    for k in (64, 256):
        PM.reset_collective_bytes()
        _mppi(mesh, "dp", seed=0, k=k)
        out["mppi_bytes"][k] = _bytes()
    out["lqt_bytes"], out["lqt_local"] = {}, {}
    for h in (64, 256):
        PM.reset_collective_bytes()
        p, eta = TPL.lqt_backward_parallel_sharded(
            *_tensors(_random_lqt(h, seed=1)), mesh=sp, axis="sp",
            gather_output=False)
        out["lqt_bytes"][h] = _bytes()
        out["lqt_local"][h] = (p, eta)
    # The control step on a (2, 2) dp x tp mesh, JAX's params cut to this
    # rank's tp shards.
    dtp = PM.make_mesh((2, 2), device="cpu")
    params = TD.params_from_jax(inputs["jparams"], mesh=dtp)
    out["param_shards"] = params
    cfg = _ctrl_cfg("dp")
    with torch.no_grad():
        out["control"] = TR.control_step(
            params, torch.zeros(4, 4), None,
            torch.tensor(inputs["words"]), torch.zeros(32), cfg,
            eps=torch.tensor(inputs["ctrl_eps"]), mesh=dtp)[:2]
    out["served"] = _serve_both(params, cfg, inputs["words"], dtp)
    with torch.no_grad():
        out["ilqr"] = TR.control_step(
            params, torch.zeros(4, 4), None,
            torch.from_numpy(inputs["words"]), torch.zeros(32),
            dataclasses.replace(cfg, n_ilqr_iterations=1),
            eps=torch.tensor(inputs["ctrl_eps"]), mesh=dtp)[:2]
    PM.reset_collective_bytes()
    out["decode"] = {fmt: engine.decode_blocks_sharded(
        fmt, torch.from_numpy(_blocks(fmt)), mesh) for fmt in _FORMATS}
    out["decode_bytes"] = _bytes()
    try:
        engine.decode_blocks_sharded(
            F.BPTC, torch.from_numpy(_blocks(F.BPTC)[:6]), mesh)
        out["decode_6"] = "no error"
    except ValueError as e:
        out["decode_6"] = str(e)
    out["dryrun"] = entry.dryrun_multichip(inputs["corpus"], device="cpu")
    return out


def _serve_both(params, cfg, words, mesh=None):
    """Two steps of a Controller and three of a PipelinedController (its
    first returns nothing, then the Controller's actions one step late),
    and the pipeline's flush."""
    goal = torch.zeros(cfg.dynamics.latent_dim)
    ctl = TR.Controller(params, goal, cfg, seed=3, device="cpu", mesh=mesh)
    pipe = TR.PipelinedController(params, goal, cfg, seed=3, device="cpu",
                                  mesh=mesh)
    served = [ctl.step(words), ctl.step(words)]
    piped = [pipe.step(words), pipe.step(words), pipe.flush()]
    return ([torch.from_numpy(a) for a in served],
            [None if a is None else torch.from_numpy(a) for a in piped])


@pytest.fixture(scope="module")
def inputs(jx, tmp_path_factory):
    """The noise (JAX's, from its keys), JAX's control-step parameters and
    an observation, as numpy arrays; and a BC7 KTX of the 256 corpus blocks
    of tests/golden/BPTC.npz (the C reference's test-texture-BPTC.ktx)."""
    jax, jnp = jx.jax, jx.jnp
    blocks = np.load(Path(__file__).parent / "golden" / "BPTC.npz")[
        "corpus_blocks"]
    corpus = tmp_path_factory.mktemp("corpus") / "test-texture-BPTC.ktx"
    PIO.save_ktx([Texture.new(F.BPTC, blocks, 64, 64)], str(corpus))
    jcfg = jx.JD.DynamicsConfig(compute_dtype=jnp.float32, **_SHAPE)
    jparams = jx.JD.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    return {
        "eps": np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                            (K, H, A), jnp.float32)
                          * _MPPI["noise_sigma"]),
        "linear_eps": np.asarray(jax.random.normal(
            jax.random.PRNGKey(11), (256, 12, 8), jnp.float32) * 0.3),
        "ctrl_eps": np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (64, 4, 4), jnp.float32) * 0.3),
        "jparams": jax.tree.map(np.asarray, jparams),
        "words": rng.integers(-2**31, 2**31, (16, 4), np.int64)
        .astype(np.int32),
        "corpus": str(corpus),
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """ranks(n): every rank's results at world size n (one spawn each)."""
    return functools.lru_cache(maxsize=None)(
        lambda n: launch.run_ranks(_rank, n, (inputs,), device="cpu",
                                   timeout=_TIMEOUT))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _jax_mesh(jx, shape, names):
    devices = np.array(jx.jax.devices()[:int(np.prod(shape))])
    return jx.Mesh(devices.reshape(shape), names)


def _jax_linear_mppi(jx, mesh, axis):
    """JAX's shard_map step on _linear(), with the noise of PRNGKey(11)."""
    am, bm, goal, z0, nominal, cfg = (
        x if isinstance(x, dict) else jx.jnp.asarray(x) for x in _linear())

    def dyn(z, u):
        return z @ am + u @ bm

    def cost(z, u, t):
        return jx.jnp.sum((z - goal) ** 2, axis=-1) + 0.1 * jx.jnp.sum(
            u ** 2, axis=-1)
    step = jx.jax.jit(functools.partial(
        jx.JM.mppi_step, dynamics=dyn, cost=cost,
        cfg=jx.JM.MPPIConfig(**cfg), rollout_axis=axis, mesh=mesh))
    return step(jx.jax.random.PRNGKey(11), nominal=nominal, z0=z0)


def _check_mppi(got, want, rtol=2e-5, atol=2e-6):
    _close(got[0], want[0], rtol, atol)
    for key in ("ess", "min_cost", "mean_cost"):
        np.testing.assert_allclose(float(got[1][key]), float(want[1][key]),
                                   rtol=rtol, err_msg=key)


# --- MPPI -----------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mppi_sharded_matches_unsharded(ranks, inputs, n):
    """The port's rollout-sharded step at n ranks against its unsharded
    step, on JAX's noise for the toy problem; every rank the same plan."""
    dyn, cost, z0, nominal, cfg = _toy_torch()
    unsharded = TM.mppi_step(nominal, z0, dyn, cost, cfg,
                             eps=torch.tensor(inputs["eps"]))
    for out in ranks(n):
        _check_mppi(out["mppi"], unsharded)
        assert torch.equal(out["mppi"][0], ranks(n)[0]["mppi"][0])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mppi_sharded_matches_jax_shard_map(ranks, jx, n):
    """The port's rollout-sharded step at n ranks against JAX's shard_map
    step on n devices, on the same noise."""
    want = _jax_linear_mppi(jx, _jax_mesh(jx, (n, 1), ("dp", "tp")), "dp")
    for out in ranks(n):
        _check_mppi(out["linear"], want, 1e-5, 1e-6)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mppi_sharded_draws_the_whole_noise(ranks, n):
    """Every rank draws the whole (K, H, A) noise from a generator seeded
    alike and keeps its rows: the plan is the unsharded one's."""
    dyn, cost, z0, nominal, cfg = _toy_torch()
    want = TM.mppi_step(nominal, z0, dyn, cost, cfg,
                        generator=torch.Generator().manual_seed(5))
    for out in ranks(n):
        _check_mppi(out["mppi_gen"], want)


def test_hierarchical_dcn_ici_matches(ranks, jx, inputs):
    """Rollouts over a (2, 2) ("dcn", "ici") mesh: the unsharded step and
    JAX's hierarchical step; MIN and SUM each ran on "ici", then on "dcn",
    and "dcn" carried only the H*A + 3 float partial."""
    dyn, cost, z0, nominal, cfg = _toy_torch()
    unsharded = TM.mppi_step(nominal, z0, dyn, cost, cfg,
                             eps=torch.tensor(inputs["eps"]))
    want = _jax_linear_mppi(jx, _jax_mesh(jx, (2, 2), ("dcn", "ici")),
                            ("dcn", "ici"))
    for out in ranks(4):
        _check_mppi(out["hier"], unsharded)
        _check_mppi(out["hier_linear"], want, 1e-5, 1e-6)
        assert out["hier_bytes"] == {
            f"all_reduce_{op}/{axis}": nbytes
            for axis in ("ici", "dcn")
            for op, nbytes in (("min", 4), ("sum", (H * A + 3) * 4))}


def test_rollout_axis_without_a_mesh_raises():
    dyn, cost, z0, nominal, cfg = _toy_torch()
    with pytest.raises(ValueError, match="needs a mesh"):
        TM.mppi_step(nominal, z0, dyn, cost, cfg, rollout_axis="dp")
    with pytest.raises(ValueError, match="needs a mesh"):
        TR.control_step(
            TD.init_params(_ctrl_cfg().dynamics, torch.Generator()),
            torch.zeros(4, 4), torch.Generator(),
            torch.zeros((16, 4), dtype=torch.int32), torch.zeros(32),
            _ctrl_cfg("dp"))


def test_rollouts_not_divisible_raise(ranks):
    for out in ranks(4):
        assert "n_rollouts=66 not divisible" in out["k_66"]


def test_mppi_collective_bytes_independent_of_k(ranks):
    """One MIN of the baseline and one SUM of H*A + 3 floats, whatever K
    (tests/test_collective_volume.py bounds: under 4 * H*A*4 + 256 bytes,
    nowhere near the K-proportional volume)."""
    for out in ranks(4):
        small, big = out["mppi_bytes"][64], out["mppi_bytes"][256]
        assert small == big == {"all_reduce_min/dp": 4,
                                "all_reduce_sum/dp": (H * A + 3) * 4}
        assert sum(small.values()) < 4 * H * A * 4 + 256


# --- the control step on a dp x tp mesh --------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_param_shardings_is_jax_layout(jx, shape):
    """Each leaf's dim split over "tp" is the dim JAX's param_shardings
    names "tp" (conv weights in the port's OIHW order); nothing is split
    on a mesh whose "tp" has one rank."""
    jcfg = jx.JD.DynamicsConfig(compute_dtype=jx.jnp.float32, **_SHAPE)
    want = jx.JD.param_shardings(_jax_mesh(jx, shape, ("dp", "tp")), jcfg)

    class FakeMesh:
        mesh_dim_names = ("dp", "tp")

        def size(self, dim):
            return shape[dim]
    got = TD.param_shardings(FakeMesh(), _ctrl_cfg().dynamics)
    for part, layers in want.items():
        assert got[part].keys() == layers.keys()
        for name, layer in layers.items():
            for k, sharding in layer.items():
                spec = tuple(sharding.spec) + (None,) * 4
                dim = spec.index("tp") if "tp" in spec else None
                if dim is not None and name.startswith("conv") and k == "w":
                    dim = (2, 3, 1, 0)[dim]            # HWIO -> OIHW
                assert got[part][name][k] == (dim if shape[1] > 1
                                              else None), (name, k)


def test_params_from_jax_cuts_jax_shards(ranks, jx, inputs):
    """params_from_jax(mesh=) holds exactly the shard of each leaf that
    JAX's param_shardings puts on the device at the rank's (dp, tp)
    place."""
    jax = jx.jax
    jcfg = jx.JD.DynamicsConfig(compute_dtype=jx.jnp.float32, **_SHAPE)
    jmesh = _jax_mesh(jx, (2, 2), ("dp", "tp"))
    placed = jax.device_put(inputs["jparams"],
                            jx.JD.param_shardings(jmesh, jcfg))
    devices = jmesh.devices.ravel()
    for rank, out in enumerate(ranks(4)):
        for part, layers in placed.items():
            for name, layer in layers.items():
                for k, arr in layer.items():
                    shard = {s.device: np.asarray(s.data)
                             for s in arr.addressable_shards}[devices[rank]]
                    got = out["param_shards"][part][name][k].numpy()
                    if name.startswith("conv") and k == "w":
                        got = np.transpose(got, (2, 3, 1, 0))  # OIHW->HWIO
                    np.testing.assert_array_equal(got, shard,
                                                  err_msg=f"{name}/{k}")


def test_control_step_dp_tp_matches(ranks, jx, inputs):
    """decode -> encode -> MPPI on a (2, 2) dp x tp mesh with tp-sharded
    params: JAX's step on its (2, 2) mesh, and the port's unsharded step
    (tests/test_mppi_sharding.py::test_control_step_sharded_matches)."""
    jax, jnp = jx.jax, jx.jnp
    jcfg = jx.JR.ControllerConfig(
        dynamics=jx.JD.DynamicsConfig(compute_dtype=jnp.float32, **_SHAPE),
        mppi=jx.JM.MPPIConfig(**_CTRL_MPPI), rollout_axis="dp")
    jmesh = _jax_mesh(jx, (2, 2), ("dp", "tp"))
    jparams = jax.device_put(inputs["jparams"],
                             jx.JD.param_shardings(jmesh, jcfg.dynamics))
    step = jax.jit(functools.partial(jx.JR.control_step, cfg=jcfg,
                                     mesh=jmesh))
    with jmesh:
        ja, jnom, _ = step(jparams, jnp.zeros((4, 4), jnp.float32),
                           jax.random.PRNGKey(0), jnp.asarray(inputs["words"]),
                           jnp.zeros((32,), jnp.float32))
    with torch.no_grad():
        ta, tnom, _ = TR.control_step(
            TD.params_from_jax(inputs["jparams"]), torch.zeros(4, 4), None,
            torch.tensor(inputs["words"]), torch.zeros(32), _ctrl_cfg(),
            eps=torch.tensor(inputs["ctrl_eps"]))
    for out in ranks(4):
        a, nom = out["control"]
        _close(a, ja, 0, 1e-5)
        _close(nom, jnom, 0, 1e-5)
        _close(a, ta, 3e-5, 3e-6)
        _close(nom, tnom, 3e-5, 3e-6)


def test_controllers_and_ilqr_on_a_dp_tp_mesh(ranks, inputs):
    """Controller and PipelinedController with mesh= on the (2, 2) dp x tp
    mesh serve the unsharded controllers' actions (atol 1e-5, the port's
    control-step tolerance: each step starts from the plan the last one
    left, so the first step's rounding carries on); with iLQR the step
    runs on the parameters gathered whole and gives the unsharded plan."""
    params = TD.params_from_jax(inputs["jparams"])
    served, piped = _serve_both(params, _ctrl_cfg(), inputs["words"])
    with torch.no_grad():
        ilqr = TR.control_step(
            params, torch.zeros(4, 4), None,
            torch.from_numpy(inputs["words"]), torch.zeros(32),
            dataclasses.replace(_ctrl_cfg(), n_ilqr_iterations=1),
            eps=torch.tensor(inputs["ctrl_eps"]))[:2]
    for out in ranks(4):
        got_served, got_piped = out["served"]
        assert got_piped[0] is None
        for got, want in zip(got_served + got_piped[1:],
                             served + piped[1:]):
            _close(got, want, 0, 1e-5)
        for got, want in zip(out["ilqr"], ilqr):
            _close(got, want, 3e-5, 3e-6)


# --- decode ----------------------------------------------------------------


@pytest.mark.parametrize("fmt", _FORMATS,
                         ids=[F.BY_FORMAT[f].name for f in _FORMATS])
def test_decode_blocks_sharded_bit_exact(ranks, fmt):
    """Each rank's shard is its rows of the unsharded decode, bit for bit,
    and the sharded decode moved no collective byte."""
    pix, valid = engine.decode_blocks_device(fmt,
                                             torch.from_numpy(_blocks(fmt)))
    m = _DECODE_N // 4
    for rank, out in enumerate(ranks(4)):
        got_pix, got_valid = out["decode"][fmt]
        assert torch.equal(got_pix, pix[rank * m:(rank + 1) * m])
        assert torch.equal(got_valid, valid[rank * m:(rank + 1) * m])
        assert out["decode_bytes"] == {}


def test_decode_blocks_sharded_not_divisible_raises(ranks):
    for out in ranks(4):
        assert "N=6 not divisible by mesh axis 'dp' size 4" in out["decode_6"]


# --- the multi-chip dry run ---------------------------------------------------


def test_dryrun_multichip_four_ranks(ranks):
    """dryrun_multichip at 4 ranks, full width on the corpus and all 8 BC7
    modes: a (2, 2) train step with a finite loss, the dp-sharded step and
    the (2, 2) ("dcn", "ici") step (which checks its groups and both
    reduction stages itself); every rank the same results, and the two
    steps the same plan (the same noise; only the reduction order
    differs)."""
    outs = [out["dryrun"] for out in ranks(4)]
    for out in outs:
        assert out["mesh"] == (2, 2) and np.isfinite(out["loss"])
        assert out["loss"] == outs[0]["loss"]
        assert torch.equal(out["action"], outs[0]["action"])
        assert torch.equal(out["hier_action"], outs[0]["hier_action"])
        _close(out["hier_action"], out["action"], 3e-5, 3e-6)
        assert out["hier_bytes"] == {
            f"all_reduce_{op}/{axis}": nbytes for axis in ("ici", "dcn")
            for op, nbytes in (("min", 4), ("sum", (32 * 8 + 3) * 4))}


# --- the horizon-sharded LQT -----------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("h", _LQT_H)
def test_lqt_sharded_matches(ranks, jx, h, n):
    """Horizon-sharded block scan == the port's unsharded scan and JAX's
    sharded one, the identity-padding path included ((H+1) % n != 0)."""
    prob = _random_lqt(h, seed=h)
    want_p, want_eta = TPL.lqt_backward_parallel(*_tensors(prob))
    jmesh = _jax_mesh(jx, (n,), ("sp",))
    jp, jeta = jx.jax.jit(lambda *a: jx.JPL.lqt_backward_parallel_sharded(
        *a, mesh=jmesh, axis="sp"))(*(jx.jnp.asarray(x) for x in prob))
    for out in ranks(n):
        p, eta = out["lqt"][h]
        assert tuple(p.shape) == (h + 1, _LQT_N, _LQT_N)
        _close(p, want_p, 2e-4, 2e-4)
        _close(eta, want_eta, 2e-4, 2e-4)
        _close(p, jp, 2e-4, 2e-4)
        _close(eta, jeta, 2e-4, 2e-4)


def test_lqt_collective_bytes_independent_of_h(ranks):
    """gather_output=False: one all_gather of the n chunk totals, the same
    bytes at H = 64 and 256 (tests/test_collective_volume.py bound:
    2 * n * 4 * (3 n_x^2 + 2 n_x)); each rank keeps its padded chunk."""
    sp, per_elem = 4, 4 * (3 * _LQT_N ** 2 + 2 * _LQT_N)
    want_p, want_eta = TPL.lqt_backward_parallel(
        *_tensors(_random_lqt(256, seed=1)))
    for rank, out in enumerate(ranks(4)):
        small, big = out["lqt_bytes"][64], out["lqt_bytes"][256]
        assert small == big == {"all_gather/sp": sp * per_elem}
        assert sum(small.values()) <= 2 * sp * per_elem
        chunk = -(-257 // sp)
        p, eta = out["lqt_local"][256]
        assert tuple(p.shape) == (chunk, _LQT_N, _LQT_N)
        stop = min(257, (rank + 1) * chunk)
        _close(p[:stop - rank * chunk], want_p[rank * chunk:stop], 2e-4, 2e-4)
        _close(eta[:stop - rank * chunk], want_eta[rank * chunk:stop],
               2e-4, 2e-4)


# --- on a card, one rank over NCCL -------------------------------------------


@pytest.fixture
def cuda_world():
    """A world of one over NCCL on the card, left behind for no other
    test."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (NCCL and the CUDA kernels have "
                    "no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    # Graphs that hold the group's communicators go before the group.
    gc.collect()
    torch.cuda.synchronize()
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_sharded_control_step_one_rank(cuda_world):
    """The full-width control step sharded over "dp" at one NCCL rank
    equals the unsharded step on the same generator seed (atol 1e-6), and
    a sharded step waits for the card nowhere (sync debug mode raises on
    any synchronising call)."""
    cfg = TR.ControllerConfig()
    sharded_cfg = dataclasses.replace(cfg, rollout_axis="dp")
    mesh = PM.make_mesh(device=cuda_world)
    assert dist.get_backend() == "nccl"
    params = TD.init_params(cfg.dynamics,
                            torch.Generator(cuda_world).manual_seed(0),
                            cuda_world)
    goal = torch.zeros(cfg.dynamics.latent_dim, device=cuda_world)
    ctl = TR.Controller(params, goal, cfg, seed=0, device=cuda_world)
    sharded = TR.Controller(params, goal, sharded_cfg, seed=0,
                            device=cuda_world, mesh=mesh)
    rng = np.random.default_rng(0)
    launches = bptc.KERNEL_LAUNCHES
    for _ in range(3):
        words = rng.integers(-2**31, 2**31, (256, 4), np.int64) \
            .astype(np.int32)
        np.testing.assert_allclose(sharded.step(words), ctl.step(words),
                                   rtol=0, atol=1e-6)
    # One launch a step each; both controllers' steps are replays of their
    # graphs (the sharded one's holds its NCCL collectives), each captured
    # after GRAPH_WARMUP eager steps.
    assert ctl.graphed and sharded.graphed
    assert bptc.KERNEL_LAUNCHES == launches + 6 + 2 * TR.GRAPH_WARMUP
    words = torch.as_tensor(words, device=cuda_world)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TR.control_step(params, sharded.nominal, sharded.generator,
                              words, goal, sharded_cfg, mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_cuda_decode_blocks_sharded_one_rank(cuda_world):
    mesh = PM.make_mesh(device=cuda_world)
    PM.reset_collective_bytes()
    for fmt in _FORMATS:
        words = torch.from_numpy(_blocks(fmt)).to(cuda_world)
        got = engine.decode_blocks_sharded(fmt, words, mesh)
        want = engine.decode_blocks_device(fmt, words)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not PM.COLLECTIVE_BYTES

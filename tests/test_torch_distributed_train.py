"""Data- and tensor-parallel training in the port against the JAX
package's sharded train step and the port's single-process step
(counterparts of tests/test_distributed_loopback.py and
tests/test_train_loop.py), and the training loop, its checkpoints and
its CLI on a mesh.

The port's ranks are spawned processes in a gloo group
(parallel.launch.run_ranks, its own time limit; one spawn of 2 ranks for
(2, 1) and one of 4 for (2, 2)); the JAX reference runs in the test
process on a (2, 2) mesh of its virtual CPU devices, built as
tests/test_distributed_loopback.py:130-148 builds its reference.  Both
take the same parameters (JAX's, cut into this rank's shards by
params_from_jax) and the same BC7-compressed batches, at float32 compute.

Tolerances:
  * losses rtol 1e-5 (tests/test_distributed_loopback.py:148);
  * each leaf's gradient against the single-process one: rtol 1e-5, atol
    1e-6 times the largest gradient of that leaf.  A gradient entry that
    is a small sum of large terms keeps only the large terms' absolute
    precision, and the ranks sum the batch in other groupings (per-rank
    means, then the average): with gradients up to 65 an entry moves by a
    few 1e-6 between the two.
  * checkpoint resumes against a straight run: rtol 2e-4 / atol 2e-5
    (tests/test_torch_train.py::test_train_resume_matches_straight_run);
  * the CLI's printed loss (6 decimals): rtol 1e-5, atol 2e-6.

The card's machine has no JAX, so the JAX package is imported only inside
the `jx` fixture, and the ranks import this module without it.
"""

import contextlib
import dataclasses
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from detex_tpu_torch.cli import train as cli_train
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import train_loop as TT
from detex_tpu_torch.parallel import launch
from detex_tpu_torch.parallel import mesh as PM
from detex_tpu_torch.utils.metrics import MetricsLogger

_TIMEOUT = 180.0
_STEPS = 2
# TrainConfig()'s model and batch (tests/test_distributed_loopback.py), at
# float32 compute, on BC7-compressed observations.
_CFG = TT.TrainConfig(compressed_obs=True)
_DCFG = dataclasses.replace(_CFG.dynamics, compute_dtype=torch.float32)
# tests/test_torch_train.py's loop configuration, for the checkpoints.
_LOOP = TT.TrainConfig(
    dynamics=TD.DynamicsConfig(image_size=16, conv_features=(8, 16),
                               latent_dim=32, action_dim=4, hidden_dim=64),
    batch_size=32, n_steps=6)
_CKPT_STEP = 4
# One step: the printed loss is the first, before any update (after one
# AdamW step, whose update is about lr * sign(g), a gradient entry near 0
# that the ranks round to the other sign moves the loss by 2e-4).
_CLI = ["--steps", "1", "--batch-size", "8", "--image-size", "16",
        "--latent-dim", "8", "--device", "cpu"]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import train_loop
    return SimpleNamespace(jax=jax, jnp=jnp, Mesh=Mesh,
                           NamedSharding=NamedSharding, P=P, JD=dynamics,
                           JT=train_loop)


def _batches():
    env = TT.SyntheticVisualEnv(_DCFG, _CFG.seed, compressed=True)
    return [env.sample_batch(np.random.default_rng(
        np.random.SeedSequence([_CFG.seed, step])), _CFG.batch_size)
        for step in range(_STEPS)]


def _grads(params):
    return {part: {name: {k: v.grad.clone() for k, v in layer.items()}
                   for name, layer in layers.items()}
            for part, layers in params.items()}


def _steps(params, batches, mesh=None):
    """_STEPS train steps; (losses, the first step's gradients)."""
    optimizer = TD.make_optimizer(params, _CFG.lr)
    step = TT.make_train_step(_DCFG, optimizer, compressed_obs=True,
                              mesh=mesh)
    losses, grads = [], None
    for b in batches:
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if mesh is not None:
            b = {k: PM.shard_batch(v, mesh, "dp") for k, v in b.items()}
        params, loss = step(params, b)
        losses.append(float(loss))
        grads = grads or _grads(params)
    return losses, grads


def _losses(stream):
    import json
    return [json.loads(x)["loss"] for x in stream.getvalue().splitlines()]


def _loop_cfg(**kw):
    return dataclasses.replace(_LOOP, **kw)


def _rank(rank, inputs):
    n = dist.get_world_size()
    shape = (2, n // 2)
    mesh = PM.make_mesh(shape, device="cpu")
    out = {}
    params = TD.params_from_jax(inputs["jparams"], mesh=mesh)
    out["losses"], out["grads"] = _steps(params, inputs["batches"], mesh)
    # Checkpoint written on this mesh (rank 0 writes), to resume without.
    stream = io.StringIO()
    TT.train(_loop_cfg(n_steps=_CKPT_STEP, checkpoint_every=_CKPT_STEP,
                       checkpoint_dir=inputs["mesh_ckpt"], mesh_shape=shape),
             metrics=MetricsLogger(stream), device="cpu")
    out["logged"] = stream.getvalue()
    # Resume on this mesh from the checkpoint written without one.
    _, _, out["resumed"] = TT.train(
        _loop_cfg(checkpoint_every=0, checkpoint_dir=inputs["plain_ckpt"],
                  mesh_shape=shape), metrics=MetricsLogger(io.StringIO()),
        device="cpu")
    if n == 2:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out["cli_rc"] = cli_train.main(_CLI + ["--mesh", "2x1"])
        out["cli"] = text.getvalue()
    return out


@pytest.fixture(scope="module")
def jparams(jx):
    jcfg = jx.JD.DynamicsConfig(
        **dict(dataclasses.asdict(_DCFG), compute_dtype=jx.jnp.float32))
    return jcfg, jx.jax.tree.map(
        np.asarray, jx.JD.init_params(jx.jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def straight():
    """The single-process loop of _LOOP.n_steps steps: its last loss."""
    return TT.train(_LOOP, metrics=MetricsLogger(io.StringIO()),
                    device="cpu")[2]


@pytest.fixture(scope="module")
def ranks(jparams, tmp_path_factory, straight):
    """ranks[n]: every rank's results at n = 2 ((2, 1)) and 4 ((2, 2))."""
    batches = _batches()
    out = {}
    for n in (2, 4):
        root = tmp_path_factory.mktemp(f"ranks{n}")
        plain = str(root / "plain")
        TT.train(_loop_cfg(n_steps=_CKPT_STEP, checkpoint_every=_CKPT_STEP,
                           checkpoint_dir=plain),
                 metrics=MetricsLogger(io.StringIO()), device="cpu")
        inputs = {"jparams": jparams[1], "batches": batches,
                  "plain_ckpt": plain, "mesh_ckpt": str(root / "mesh")}
        out[n] = (launch.run_ranks(_rank, n, (inputs,), device="cpu",
                                   timeout=_TIMEOUT),
                  inputs)
    return out


@pytest.fixture(scope="module")
def single(jparams):
    """The single-process port's losses and first gradients."""
    return _steps(TD.params_from_jax(jparams[1]), _batches())


@pytest.fixture(scope="module")
def jax_losses(jx, jparams):
    """JAX's train step on a (2, 2) dp x tp mesh of its virtual devices."""
    jax = jx.jax
    jcfg, params = jparams
    mesh = jx.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    params = jax.device_put(params, jx.JD.param_shardings(mesh, jcfg))
    opt = jx.JD.make_optimizer(_CFG.lr)
    opt_state = opt.init(params)
    step = jx.JT.make_train_step(jcfg, opt, compressed_obs=True)
    losses = []
    with mesh:
        for b in _batches():
            b = {k: jax.device_put(v, jx.NamedSharding(mesh, jx.P("dp")))
                 for k, v in b.items()}
            params, opt_state, loss = step(params, opt_state, b)
            losses.append(float(loss))
    return losses


@pytest.mark.parametrize("n", [2, 4], ids=["2x1", "2x2"])
def test_sharded_losses_match_jax_and_single(ranks, single, jax_losses, n):
    for out in ranks[n][0]:
        np.testing.assert_allclose(out["losses"], jax_losses, rtol=1e-5)
        np.testing.assert_allclose(out["losses"], single[0], rtol=1e-5)


def _whole_grad(shards, name, k):
    """A leaf's gradient from the ranks' shards: tp ranks 0 and 1 are
    ranks 0 and 1 of the first dp row."""
    dim = TD._tp_dim(name, k)
    if len(shards) == 1 or dim is None:
        return shards[0]
    return torch.cat(shards, dim)


@pytest.mark.parametrize("n", [2, 4], ids=["2x1", "2x2"])
def test_sharded_gradients_match_single(ranks, single, n):
    """Every leaf's gradient after the dp average (its tp shards joined)
    against the single-process gradient; the dp ranks hold the same."""
    outs = ranks[n][0]
    tp = n // 2
    want = single[1]
    for part, layers in want.items():
        for name, layer in layers.items():
            for k, g in layer.items():
                for row in range(2):
                    got = _whole_grad([outs[row * tp + j]["grads"][part]
                                       [name][k] for j in range(tp)],
                                      name, k)
                    np.testing.assert_allclose(
                        got.numpy(), g.numpy(), rtol=1e-5,
                        atol=1e-6 * float(g.abs().max()),
                        err_msg=f"{part}/{name}/{k}")


@pytest.mark.parametrize("n", [2, 4], ids=["2x1", "2x2"])
def test_checkpoint_from_a_mesh_resumes_without(ranks, straight, n):
    """Written at (2, n/2) by rank 0 alone, in the single-process format;
    resumed with no mesh it ends where the straight run ends."""
    outs, inputs = ranks[n]
    assert outs[0]["logged"] and not any(o["logged"] for o in outs[1:])
    _, _, resumed = TT.train(
        _loop_cfg(checkpoint_every=0, checkpoint_dir=inputs["mesh_ckpt"]),
        metrics=MetricsLogger(io.StringIO()), device="cpu")
    np.testing.assert_allclose(resumed, straight, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4], ids=["2x1", "2x2"])
def test_checkpoint_without_a_mesh_resumes_on_one(ranks, straight, n):
    for out in ranks[n][0]:
        np.testing.assert_allclose(out["resumed"], straight, rtol=2e-4,
                                   atol=2e-5)


def test_cli_train_mesh_under_two_ranks(ranks, capsys):
    """python -m detex_tpu_torch.cli.train --mesh 2x1 under 2 ranks: rank
    0 alone prints, the loss of the single-process run."""
    outs = ranks[2][0]
    assert [o["cli_rc"] for o in outs] == [0, 0]
    assert outs[1]["cli"] == ""
    assert cli_train.main(_CLI) == 0
    single = capsys.readouterr().out.splitlines()[-1]
    got = outs[0]["cli"].splitlines()[-1]
    assert got.startswith("final loss: ")
    np.testing.assert_allclose(float(got.split(": ")[1]),
                               float(single.split(": ")[1]), rtol=1e-5,
                               atol=2e-6)


def test_train_on_a_world_of_one(monkeypatch):
    """mesh_shape (1, 1) in a single process: a world of one, the same
    losses as no mesh; the mesh that does not fit raises."""
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    try:
        s1, s2 = io.StringIO(), io.StringIO()
        cfg = _loop_cfg(n_steps=3)
        TT.train(cfg, metrics=MetricsLogger(s1), device="cpu")
        TT.train(dataclasses.replace(cfg, mesh_shape=(1, 1)),
                 metrics=MetricsLogger(s2), device="cpu")
        np.testing.assert_allclose(_losses(s2), _losses(s1), rtol=1e-6)
        with pytest.raises(ValueError, match="world size 1"):
            TT.train(dataclasses.replace(cfg, mesh_shape=(2, 1)),
                     device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

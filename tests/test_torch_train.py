"""The training side of the PyTorch port against the JAX package: the loss,
AdamW against optax.adamw, the train step, the environments' batches, and
the training loop and its CLI on the CPU.

Tolerances (float32 compute):
  * loss_fn: rtol 1e-5 (the same float32 products in another summation
    order);
  * the gradients and AdamW's first moment: rtol 1e-4, atol 1e-6 (a
    gradient entry that is a small sum of large terms keeps only the
    large terms' relative precision);
  * AdamW against optax.adamw on the same gradients: rtol 2.4e-6, two
    float32 ulps (2 x 1.2e-7) a step over five steps: the same update,
    but torch decays the parameter by a product and optax by a sum (see
    dynamics.make_optimizer);
  * three train steps from the same parameters and the same non-fresh
    optimizer state: loss rtol 1e-5, parameters rtol 1e-5 / atol 1e-6;
  * the environments' batches: byte-equal;
  * the training loop: the tests of tests/test_train_loop.py, at their
    tolerances (the resumed run's loss rtol 2e-4 / atol 2e-5, the
    compressed run's losses equal to the pre-decoded run's).

Tests marked `cuda` run on a card and skip here; the card's machine has
no JAX, so JAX is imported only inside the `jx` fixture.
"""

import dataclasses
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detex_tpu_torch import formats as PF
from detex_tpu_torch import io as PIO
from detex_tpu_torch.cli import train as cli_train
from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.mpc import train_loop as TT
from detex_tpu_torch.ops import bptc
from detex_tpu_torch.texture import Texture
from detex_tpu_torch.utils.metrics import MetricsLogger

_SHAPE = dict(image_size=16, conv_features=(8, 16), latent_dim=16,
              action_dim=4, hidden_dim=32)
# tests/test_train_loop.py's configuration, on one device.
_CFG = TT.TrainConfig(
    dynamics=TD.DynamicsConfig(image_size=16, conv_features=(8, 16),
                               latent_dim=32, action_dim=4, hidden_dim=64),
    batch_size=32, n_steps=30)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's training modules."""
    import jax
    import jax.numpy as jnp
    import optax

    from detex_tpu.mpc import dynamics
    from detex_tpu.mpc import train_loop
    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, JD=dynamics,
                           JT=train_loop)


def _jcfg(jx, **kw):
    return jx.JD.DynamicsConfig(compute_dtype=jx.jnp.float32,
                                **dict(_SHAPE, **kw))


def _tcfg(**kw):
    return TD.DynamicsConfig(compute_dtype=torch.float32,
                             **dict(_SHAPE, **kw))


def _batch(seed, n=8, size=16, action_dim=4):
    rng = np.random.default_rng(seed)
    return {"obs": rng.integers(0, 256, (n, size, size, 4)).astype(np.uint8),
            "action": rng.uniform(-1, 1, (n, action_dim)).astype(np.float32),
            "next_obs": rng.integers(0, 256, (n, size, size, 4))
            .astype(np.uint8)}


def _tensors(batch, device="cpu"):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _params_close(tp, jp_np):
    want = TD.params_from_jax(jp_np)
    for got, ref in zip(TD.param_leaves(tp), TD.param_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)


# --- loss, optimizer, train step -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_fn_parity(jx, seed):
    jcfg, tcfg = _jcfg(jx), _tcfg()
    jp = jx.JD.init_params(jx.jax.random.PRNGKey(seed), jcfg)
    tp = TD.params_from_jax(jx.jax.tree.map(np.asarray, jp))
    batch = _batch(seed)
    want = jx.JD.loss_fn(jp, jx.jax.tree.map(jx.jnp.asarray, batch), jcfg)
    got = TD.loss_fn(tp, _tensors(batch), tcfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_fn_stops_the_target_gradient(jx):
    """next_obs's latent is a constant of the loss (stop_gradient there,
    detach here): the gradients equal JAX's."""
    jcfg, tcfg = _jcfg(jx), _tcfg()
    jp = jx.JD.init_params(jx.jax.random.PRNGKey(4), jcfg)
    tp = TD.params_from_jax(jx.jax.tree.map(np.asarray, jp))
    batch = _batch(4)
    jgrad = jx.jax.grad(jx.JD.loss_fn)(
        jp, jx.jax.tree.map(jx.jnp.asarray, batch), jcfg)
    for p in TD.param_leaves(tp):
        p.requires_grad_(True)
    TD.loss_fn(tp, _tensors(batch), tcfg).backward()
    want = TD.params_from_jax(jx.jax.tree.map(np.asarray, jgrad))
    for p, g in zip(TD.param_leaves(tp), TD.param_leaves(want)):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_adamw_matches_optax(jx):
    """The update algebra (make_optimizer's docstring), on the same
    parameters and gradients for five steps, biases decayed too."""
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 3), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    opt = jx.optax.adamw(1e-2, weight_decay=0.1)
    jp = jx.jax.tree.map(jx.jnp.asarray, params)
    state = opt.init(jp)
    tp = {"layer": {"fc": {k: torch.tensor(v) for k, v in params.items()}}}
    topt = torch.optim.AdamW(TD.param_leaves(tp), lr=1e-2, betas=(0.9,
                             0.999), eps=1e-8, weight_decay=0.1)
    for g in grads:
        updates, state = opt.update(jx.jax.tree.map(jx.jnp.asarray, g),
                                    state, jp)
        jp = jx.optax.apply_updates(jp, updates)
        for leaf, k in zip(TD.param_leaves(tp), sorted(shapes)):
            leaf.grad = torch.tensor(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp["layer"]["fc"][k].numpy(),
                                       np.asarray(jp[k]), rtol=2.4e-6,
                                       atol=0)
    assert float(np.abs(np.asarray(jp["b"]) - params["b"]).max()) > 0


def test_make_optimizer_covers_every_leaf():
    tcfg = _tcfg()
    params = TD.init_params(tcfg, torch.Generator().manual_seed(0))
    opt = TD.make_optimizer(params, 1e-3)
    leaves = TD.param_leaves(params)
    group = opt.param_groups[0]
    assert len(group["params"]) == len(leaves) == 12      # 6 w, 6 b
    assert all(a is b for a, b in zip(group["params"], leaves))
    assert all(p.requires_grad for p in leaves)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-5)
    # Weight decay reaches a bias whose gradient is zero.
    bias = params["dyn"]["out"]["b"]
    with torch.no_grad():
        bias.fill_(1.0)
    for p in leaves:
        p.grad = torch.zeros_like(p)
    opt.step()
    torch.testing.assert_close(bias, torch.full_like(bias, 1 - 1e-3 * 1e-5),
                               rtol=0, atol=1e-9)


def test_param_leaves_order_is_insertion_free():
    tcfg = _tcfg()
    params = TD.init_params(tcfg, torch.Generator().manual_seed(0))
    shuffled = {part: {name: dict(reversed(list(layer.items())))
                       for name, layer in reversed(list(params[part]
                                                        .items()))}
                for part in reversed(list(params))}
    assert all(a is b for a, b in zip(TD.param_leaves(params),
                                      TD.param_leaves(shuffled)))


def test_train_steps_parity_from_jax_state(jx):
    """Two JAX steps give a non-fresh optimizer state; from those params
    and that state both packages take three more steps."""
    jcfg, tcfg = _jcfg(jx), _tcfg()
    jp = jx.JD.init_params(jx.jax.random.PRNGKey(7), jcfg)
    opt = jx.JD.make_optimizer()
    state = opt.init(jp)
    step = jx.jax.jit(lambda p, s, b: jx.JD.train_step(p, s, b, jcfg, opt))
    batches = [_batch(20 + i) for i in range(5)]
    for b in batches[:2]:
        jp, state, _ = step(jp, state, jx.jax.tree.map(jx.jnp.asarray, b))
    tp = TD.params_from_jax(jx.jax.tree.map(np.asarray, jp))
    topt = TD.make_optimizer(tp)
    TD.opt_state_from_jax(topt, jx.jax.tree.map(np.asarray, state[0]))
    assert float(topt.state[TD.param_leaves(tp)[0]]["step"]) == 2.0
    for b in batches[2:]:
        jp, state, jloss = step(jp, state,
                                jx.jax.tree.map(jx.jnp.asarray, b))
        tp, tloss = TD.train_step(tp, topt, _tensors(b), tcfg)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        _params_close(tp, jx.jax.tree.map(np.asarray, jp))
    count, mu, nu = jx.jax.tree.map(np.asarray, state[0])
    assert float(topt.state[TD.param_leaves(tp)[0]]["step"]) == float(count)
    for p, m in zip(TD.param_leaves(tp),
                    TD.param_leaves(TD.params_from_jax(mu))):
        np.testing.assert_allclose(topt.state[p]["exp_avg"].numpy(),
                                   m.numpy(), rtol=1e-4, atol=1e-6)


def test_dynamics_train_step_learns():
    """tests/test_mpc.py's: 20 steps on one batch cut the loss by 10%."""
    cfg = TD.DynamicsConfig(image_size=16, conv_features=(8, 16),
                            latent_dim=16, action_dim=4, hidden_dim=32)
    params = TD.init_params(cfg, torch.Generator().manual_seed(0))
    opt = TD.make_optimizer(params, 1e-3)
    rng = np.random.default_rng(0)
    batch = {"obs": torch.from_numpy(rng.integers(0, 256, (8, 16, 16, 4))
                                     .astype(np.uint8)),
             "action": torch.from_numpy(rng.standard_normal((8, 4))
                                        .astype(np.float32)),
             "next_obs": torch.from_numpy(rng.integers(0, 256, (8, 16, 16, 4))
                                          .astype(np.uint8))}
    losses = []
    for _ in range(20):
        params, loss = TD.train_step(params, opt, batch, cfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]


# --- the environments --------------------------------------------------------------


def _batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("compressed", [False, True])
def test_synthetic_env_batches_equal_jax(jx, compressed):
    cfg = TT.TrainConfig().dynamics
    jcfg = jx.JT.TrainConfig().dynamics
    for seed in (0, 3):
        t_env = TT.SyntheticVisualEnv(cfg, seed, compressed=compressed)
        j_env = jx.JT.SyntheticVisualEnv(jcfg, seed, compressed=compressed)
        for step in range(2):
            ss = np.random.SeedSequence([seed, step])
            _batches_equal(t_env.sample_batch(np.random.default_rng(ss), 6),
                           j_env.sample_batch(np.random.default_rng(ss), 6))


@pytest.fixture(scope="module")
def corpus_ktx(tmp_path_factory):
    """A BC7 KTX of the 256 corpus blocks of tests/golden/BPTC.npz (the
    blocks of the C reference's test-texture-BPTC.ktx)."""
    from pathlib import Path
    golden = Path(__file__).parent / "golden" / "BPTC.npz"
    blocks = np.load(golden)["corpus_blocks"]
    assert blocks.shape == (256, 16)
    path = tmp_path_factory.mktemp("corpus") / "test-texture-BPTC.ktx"
    PIO.save_ktx([Texture.new(PF.BPTC, blocks, 64, 64)], str(path))
    return str(path)


def test_corpus_env_batches_equal_jax(jx, corpus_ktx):
    cfg = TT.TrainConfig(compressed_obs=True).dynamics
    jcfg = jx.JT.TrainConfig(compressed_obs=True).dynamics
    t_env = TT.CorpusReplayEnv(cfg, seed=2, corpus_path=corpus_ktx)
    j_env = jx.JT.CorpusReplayEnv(jcfg, seed=2, corpus_path=corpus_ktx)
    assert t_env.pool.shape == (256 + 1024, 4)
    np.testing.assert_array_equal(t_env.pool, j_env.pool)
    for step in range(2):
        ss = np.random.SeedSequence([2, step])
        _batches_equal(t_env.sample_batch(np.random.default_rng(ss), 5),
                       j_env.sample_batch(np.random.default_rng(ss), 5))
        np.testing.assert_array_equal(
            t_env.obs_words(np.random.default_rng(ss)),
            j_env.obs_words(np.random.default_rng(ss)))


def test_corpus_replay_env_mode_diversity(corpus_ktx):
    """tests/test_train_loop.py's: every BC7 mode in the pool and in one
    sampled batch; the train step and the control step both run over
    replay observations."""
    cfg = TT.TrainConfig(compressed_obs=True)
    dcfg = cfg.dynamics
    env = TT.CorpusReplayEnv(dcfg, seed=0, corpus_path=corpus_ktx)
    assert env.modes_present == set(range(8)), env.modes_present
    rng = np.random.default_rng(0)
    batch = env.sample_batch(rng, 16)
    assert batch["obs_words"].shape == (16, env.n_blocks, 4)
    b0 = batch["obs_words"][:, :, 0].astype(np.int64) & 0xFF
    seen = {m for m in range(8)
            if np.any((b0 & ((1 << (m + 1)) - 1)) == (1 << m))}
    assert seen == set(range(8)), seen

    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    opt = TD.make_optimizer(params, cfg.lr)
    step_fn = TT.make_train_step(dcfg, opt, compressed_obs=True)
    params, loss = step_fn(params, _tensors(batch))
    assert np.isfinite(float(loss))

    ccfg = TR.ControllerConfig(
        dynamics=dcfg, mppi=TM.MPPIConfig(n_rollouts=32, horizon=4,
                                          action_dim=dcfg.action_dim))
    with torch.no_grad():
        action, _, diag = TR.control_step(
            params, torch.zeros((4, dcfg.action_dim)),
            torch.Generator().manual_seed(1),
            torch.from_numpy(env.obs_words(rng)), torch.zeros(dcfg.latent_dim),
            ccfg)
    assert np.isfinite(float(diag["min_cost"]))
    assert tuple(action.shape) == (dcfg.action_dim,)


def test_corpus_replay_env_without_corpus_file(tmp_path):
    cfg = TT.TrainConfig(compressed_obs=True)
    for path in (None, str(tmp_path / "nope.ktx")):
        env = TT.CorpusReplayEnv(cfg.dynamics, seed=1, corpus_path=path)
        assert env.modes_present == set(range(8))
        assert env.pool.shape == (1024, 4)
    bad = tmp_path / "bad.ktx"
    bad.write_bytes(b"not a ktx file at all")
    env = TT.CorpusReplayEnv(cfg.dynamics, seed=1, corpus_path=str(bad))
    assert env.pool.shape == (1024, 4)


def test_corpus_replay_state_dependent_loss_decreases():
    """tests/test_train_loop.py's: observations are a function of the
    hidden state, and 30 steps on them cut the loss by 10%."""
    cfg = TT.TrainConfig(compressed_obs=True)
    dcfg = cfg.dynamics
    env = TT.CorpusReplayEnv(dcfg, seed=0)
    z = np.random.default_rng(1).standard_normal(
        (4, env.state_dim)).astype(np.float32)
    np.testing.assert_array_equal(env.words_of_state(z),
                                  env.words_of_state(z.copy()))
    assert not np.array_equal(env.words_of_state(z),
                              env.words_of_state(z + 1.0))
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    opt = TD.make_optimizer(params, 1e-3)
    step_fn = TT.make_train_step(dcfg, opt, compressed_obs=True)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(30):
        params, loss = step_fn(params, _tensors(env.sample_batch(rng, 16)))
        losses.append(float(loss))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.9, (first, last)


# --- the training loop and its CLI --------------------------------------------------


def _losses(stream):
    return [json.loads(x)["loss"] for x in stream.getvalue().splitlines()]


@pytest.mark.parametrize("compressed", [False, True])
def test_train_loss_decreases(tmp_path, compressed):
    stream = io.StringIO()
    cfg = dataclasses.replace(_CFG, compressed_obs=compressed,
                              checkpoint_dir=str(tmp_path / "ck"))
    _, opt, last = TT.train(cfg, metrics=MetricsLogger(stream),
                            device="cpu")
    losses = _losses(stream)
    assert len(losses) == 4                 # steps 0, 10, 20 and 29
    assert np.isfinite(last) and last == losses[-1]
    assert last < losses[0], (losses[0], last)
    assert isinstance(opt, torch.optim.AdamW)


def test_train_compressed_matches_predecoded():
    """Training on BC7 words == training on the images of those words
    decoded before the step: the decode is exact, so the losses are
    identical."""
    cfg = dataclasses.replace(_CFG, n_steps=6, compressed_obs=True)
    s = cfg.dynamics.image_size
    env_words = TT.SyntheticVisualEnv(cfg.dynamics, cfg.seed,
                                      compressed=True)

    class PreDecodedEnv:
        def sample_batch(self, rng, batch_size):
            b = env_words.sample_batch(rng, batch_size)
            return {"obs": TR.decode_obs_batch(
                        torch.from_numpy(b["obs_words"]), s, s).numpy(),
                    "next_obs": TR.decode_obs_batch(
                        torch.from_numpy(b["next_obs_words"]), s, s).numpy(),
                    "action": b["action"]}

    s1, s2 = io.StringIO(), io.StringIO()
    TT.train(cfg, metrics=MetricsLogger(s1), env=env_words, device="cpu")
    TT.train(dataclasses.replace(cfg, compressed_obs=False),
             metrics=MetricsLogger(s2), env=PreDecodedEnv(), device="cpu")
    assert _losses(s1) == _losses(s2)


def test_train_resume_matches_straight_run(tmp_path):
    _, _, straight = TT.train(_CFG, metrics=MetricsLogger(io.StringIO()),
                              device="cpu")
    ck = str(tmp_path / "ck")
    TT.train(dataclasses.replace(_CFG, n_steps=20, checkpoint_every=20,
                                 checkpoint_dir=ck),
             metrics=MetricsLogger(io.StringIO()), device="cpu")
    _, _, resumed = TT.train(dataclasses.replace(_CFG, checkpoint_every=0,
                                                 checkpoint_dir=ck),
                             metrics=MetricsLogger(io.StringIO()),
                             device="cpu")
    np.testing.assert_allclose(resumed, straight, rtol=2e-4, atol=2e-5)


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train(_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(["--steps", "1"])


def test_cli_train(tmp_path, capsys):
    args = ["--steps", "3", "--batch-size", "4", "--image-size", "16",
            "--latent-dim", "8", "--device", "cpu", "--checkpoint-every",
            "3", "--checkpoint-dir", str(tmp_path / "ck")]
    assert cli_train.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["step"] for x in out[:-1]] == [0, 2]
    assert out[-1].startswith("final loss: ")
    assert np.isfinite(float(out[-1].split(": ")[1]))
    assert (tmp_path / "ck" / "latest").exists()
    # A mesh that does not match the world size (one process) raises.
    with pytest.raises(ValueError, match="world size 1"):
        cli_train.main(["--steps", "1", "--device", "cpu", "--mesh", "2x1"])


# --- on a card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_train_step_kernel_vs_plain_decode(cuda, monkeypatch):
    """One compressed train step on the card: the kernel's decode gives
    the plain decode's images bit for bit (two launches a step), and the
    loss from the same params agrees."""
    cfg = TT.TrainConfig(compressed_obs=True)
    dcfg = cfg.dynamics
    env = TT.SyntheticVisualEnv(dcfg, 0, compressed=True)
    batch = _tensors(env.sample_batch(np.random.default_rng(0), 16), cuda)
    params = TD.init_params(dcfg, torch.Generator(cuda).manual_seed(0), cuda)
    launches = bptc.KERNEL_LAUNCHES
    kernel = TT.decode_batch(batch, dcfg.image_size)
    assert bptc.KERNEL_LAUNCHES == launches + 2
    with torch.no_grad():
        loss_k = TD.loss_fn(params, kernel, dcfg)
    monkeypatch.setattr(bptc, "decode_bptc", bptc.decode_bptc_plain)
    plain = TT.decode_batch(batch, dcfg.image_size)
    assert bptc.KERNEL_LAUNCHES == launches + 2
    for k in ("obs", "next_obs"):
        assert torch.equal(kernel[k], plain[k])
    with torch.no_grad():
        loss_p = TD.loss_fn(params, plain, dcfg)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)

"""The port's checkpoint and NaN-guard utilities (utils/checkpoint.py,
utils/guards.py): copies of tests/test_utils.py's and tests/test_guards.py's
tests on the port, and the behaviour the torch versions add (the guard
names the op; the checkpoint reads back with torch.load(weights_only=True)).
"""

import numpy as np
import pytest
import torch

from detex_tpu_torch.mpc import dynamics as TD
from detex_tpu_torch.mpc import mppi as TM
from detex_tpu_torch.mpc import runtime as TR
from detex_tpu_torch.utils import checkpoint as ckpt
from detex_tpu_torch.utils import guards


def _small_dcfg():
    return TD.DynamicsConfig(image_size=16, conv_features=(8, 16),
                             latent_dim=16, action_dim=4, hidden_dim=32)


# --- checkpoint ------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    cfg = TD.DynamicsConfig(image_size=16, conv_features=(8,), latent_dim=8,
                            action_dim=2, hidden_dim=16)
    gen = torch.Generator().manual_seed(3)
    params = TD.init_params(cfg, gen)
    opt = TD.make_optimizer(params)
    rng = np.random.default_rng(0)
    batch = {"obs": torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 4))
                                     .astype(np.uint8)),
             "action": torch.zeros((2, 2)),
             "next_obs": torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 4))
                                          .astype(np.uint8))}
    TD.train_step(params, opt, batch, cfg)       # a non-empty state
    state = ckpt.controller_state(params, opt.state_dict(),
                                  torch.ones((4, 2)), gen.get_state(), 17)
    path = tmp_path / "ck"
    ckpt.save(str(path), state)
    restored = ckpt.restore(str(path))
    assert restored["step"] == 17
    assert guards.tree_equal(restored["params"], state["params"])
    assert guards.tree_equal(restored["nominal"], state["nominal"])
    assert torch.equal(restored["generator"], state["generator"])
    assert restored["opt_state"]["param_groups"] == \
        state["opt_state"]["param_groups"]
    for i, s in state["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(restored["opt_state"]["state"][i][k], v)
    # Loadable into a fresh optimizer over fresh params.
    params2 = TD.init_params(cfg, torch.Generator().manual_seed(9))
    TD.make_optimizer(params2).load_state_dict(restored["opt_state"])
    assert not any(p.requires_grad for p in
                   TD.param_leaves(restored["params"]))


def test_checkpoint_save_replaces_whole(tmp_path):
    path = tmp_path / "latest"
    ckpt.save(str(path), {"step": 1, "x": torch.zeros(3)})
    ckpt.save(str(path), {"step": 2, "x": torch.ones(3)})
    got = ckpt.restore(str(path))
    assert got["step"] == 2 and torch.equal(got["x"], torch.ones(3))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["latest"]


def test_checkpoint_deterministic_resume(tmp_path):
    """The restored generator state gives the same MPPI plan."""
    def dyn(z, u):
        return z + 0.1 * torch.nn.functional.pad(u, (0, 2))

    def cost(z, u, t):
        return torch.sum(z ** 2, dim=-1)

    cfg = TM.MPPIConfig(n_rollouts=64, horizon=4, action_dim=2)
    z0 = torch.ones(4)
    nominal = torch.zeros((4, 2))
    gen = torch.Generator().manual_seed(5)
    ckpt.save(str(tmp_path / "s"),
              ckpt.controller_state({}, None, nominal, gen.get_state(), 0))
    r = ckpt.restore(str(tmp_path / "s"))
    out2, _ = TM.mppi_step(nominal, z0, dyn, cost, cfg, generator=gen)
    gen1 = torch.Generator()
    gen1.set_state(r["generator"])
    out1, _ = TM.mppi_step(r["nominal"], z0, dyn, cost, cfg, generator=gen1)
    assert torch.equal(out1, out2)


def test_checkpoint_refuses_pickled_code(tmp_path):
    """restore() loads with weights_only=True: a file holding an arbitrary
    object does not load."""
    path = tmp_path / "evil"
    torch.save({"step": 1, "obj": object()}, path)
    with pytest.raises(Exception, match="(?i)weights_only|unsupported"):
        ckpt.restore(str(path))


# --- guards -------------------------------------------------------------------


def test_checked_raises_on_nan():
    @guards.checked
    def bad(x):
        return torch.log(x)            # log(-1) -> nan

    with pytest.raises(FloatingPointError, match="log"):
        bad(torch.tensor(-1.0))


def test_checked_raises_on_inf():
    @guards.checked
    def bad(x):
        return 1.0 / x + 1.0

    with pytest.raises(FloatingPointError):
        bad(torch.zeros(3))


def test_checked_passes_finite():
    @guards.checked
    def good(x):
        return torch.log(x) + 1.0

    assert np.isfinite(float(good(torch.tensor(2.0))))


def test_checked_leaves_integer_ops_alone():
    @guards.checked
    def ints(x):
        return (x >> 1) & 0xFF

    assert torch.equal(ints(torch.arange(4)), torch.tensor([0, 0, 1, 1]))


def test_maybe_checked(monkeypatch):
    def bad(x):
        return torch.log(x)

    monkeypatch.delenv("DETEX_DEBUG_NANS", raising=False)
    assert guards.maybe_checked(bad) is bad
    assert torch.isnan(guards.maybe_checked(bad)(torch.tensor(-1.0)))
    monkeypatch.setenv("DETEX_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError):
        guards.maybe_checked(bad)(torch.tensor(-1.0))


def test_assert_all_finite():
    guards.assert_all_finite({"a": torch.ones(3), "b": [np.zeros(2)]})
    guards.assert_all_finite({"i": torch.tensor([1, 2])})
    with pytest.raises(FloatingPointError, match=r"params\['a'\]"):
        guards.assert_all_finite({"a": torch.tensor([1.0, float("nan")])},
                                 "params")
    with pytest.raises(FloatingPointError, match=r"x\['b'\]\[1\]"):
        guards.assert_all_finite(
            {"b": [np.zeros(2), np.array([np.inf], np.float32)]}, "x")


def test_tree_equal():
    a = {"w": torch.arange(4.0), "n": [np.int32(3), torch.zeros(2)]}
    b = {"w": torch.arange(4.0), "n": [np.int32(3), torch.zeros(2)]}
    assert guards.tree_equal(a, b)
    assert not guards.tree_equal(a, {"w": torch.arange(4.0),
                                     "n": [np.int32(3), torch.ones(2)]})
    assert not guards.tree_equal(a, {"w": torch.arange(4.0)})
    assert not guards.tree_equal({"x": torch.zeros(2)},
                                 {"x": torch.zeros(2, dtype=torch.float64)})
    assert not guards.tree_equal({"x": torch.tensor([0.0])},
                                 {"x": torch.tensor([-0.0])})     # bitwise
    assert guards.tree_equal({"x": torch.ones(2, dtype=torch.bfloat16)},
                             {"x": torch.ones(2, dtype=torch.bfloat16)})


def test_controller_same_seed_determinism():
    """Two controllers with the same seed give bitwise identical action
    sequences."""
    dcfg = _small_dcfg()
    cfg = TR.ControllerConfig(
        dynamics=dcfg, mppi=TM.MPPIConfig(n_rollouts=32, horizon=4,
                                          action_dim=4))
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    goal = torch.zeros(dcfg.latent_dim)
    rng = np.random.default_rng(0)
    obs = [rng.integers(-2**31, 2**31, (16, 4), np.int64).astype(np.int32)
           for _ in range(3)]
    runs = []
    for _ in range(2):
        ctl = TR.Controller(params, goal, cfg, seed=3, device="cpu")
        runs.append([ctl.step(o) for o in obs])
    assert guards.tree_equal(runs[0], runs[1])


def test_mppi_step_nan_guarded():
    """The MPPI update stays finite with every op checked."""
    cfg = TM.MPPIConfig(n_rollouts=16, horizon=4, action_dim=2)

    def dyn(z, u):
        return z * 0.9 + u.sum(-1, keepdim=True) * 0.1

    def cost(z, u, t):
        return (z ** 2).sum(-1) + (u ** 2).sum(-1)

    @guards.checked
    def run(gen):
        nominal = torch.zeros((cfg.horizon, cfg.action_dim))
        return TM.mppi_step(nominal, torch.ones(1), dyn, cost, cfg,
                            generator=gen)[0]

    out = run(torch.Generator().manual_seed(0))
    guards.assert_all_finite(out, "mppi nominal")

"""Entry point of the port's main path, the counterpart of
__graft_entry__.py:20-55.

entry(device) -> (fn, example_args): the control step (BC7 decode ->
latent encode -> MPPI update) at a small configuration, with the port's
own random parameters and generator; `fn(*example_args)` runs one step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import mppi as M
from detex_tpu_torch.mpc.runtime import ControllerConfig, control_step


def _small_cfg() -> ControllerConfig:
    dcfg = D.DynamicsConfig(image_size=32, conv_features=(16, 32, 64),
                            latent_dim=64, action_dim=8, hidden_dim=256)
    mcfg = M.MPPIConfig(n_rollouts=512, horizon=16, action_dim=8)
    return ControllerConfig(dynamics=dcfg, mppi=mcfg)


def entry(device="cpu"):
    """Control step at _small_cfg() on `device`."""
    device = torch.device(device)
    cfg = _small_cfg()
    dcfg = cfg.dynamics
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = D.init_params(dcfg, generator, device)
    n_blocks = (dcfg.image_size // 4) ** 2
    rng = np.random.default_rng(0)
    obs_words = torch.as_tensor(
        rng.integers(-2**31, 2**31, size=(n_blocks, 4), dtype=np.int64)
        .astype(np.int32), device=device)
    nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                          dtype=torch.float32, device=device)
    goal_z = torch.zeros((dcfg.latent_dim,), dtype=torch.float32,
                         device=device)
    fn = functools.partial(control_step, cfg=cfg)
    example_args = (params, nominal, generator, obs_words, goal_z)
    return fn, example_args

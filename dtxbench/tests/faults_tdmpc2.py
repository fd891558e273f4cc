"""Faults planted in the TD-MPC2 planner for the tests and the limits'
readings: each function, named to run.measure as
prepare="dtxbench.tests.faults_tdmpc2:<name>", patches the program's
mpc/tdmpc2.py in the process that runs it, before the step is captured,
so that one thing the tdmpc2_317m.control cell must catch goes wrong."""

from __future__ import annotations

import dataclasses

import torch


def iteration_left_out() -> None:
    """The planner runs one round fewer than configured."""
    from detex_tpu_torch.mpc import tdmpc2 as T
    real = T.plan

    def plan(params, z, warm, draws, ctx, cfg):
        return real(params, z, warm, draws, ctx,
                    dataclasses.replace(cfg, iterations=cfg.iterations - 1))
    T.plan = plan


def half_samples() -> None:
    """Each round values the first half of its samples and gives the second
    half the first half's values."""
    from detex_tpu_torch.mpc import tdmpc2 as T
    real = T.estimate_value

    def estimate_value(params, z, actions, *args):
        h = z.shape[0] // 2
        value = real(params, z[:h], actions[:, :h], *args[:2],
                     args[2][:h], *args[3:])
        return torch.cat([value, value])
    T.estimate_value = estimate_value


def simnorm_left_out() -> None:
    """The latents are not SimNorm-ed (encoder and dynamics)."""
    from detex_tpu_torch.mpc import tdmpc2 as T
    T.simnorm = lambda x, dim: x


def q_one_head() -> None:
    """Q is read from one head twice, not from the drawn pair."""
    from detex_tpu_torch.mpc import tdmpc2 as T
    real = T.q_pairs

    def q_pairs(keys):
        first = real(keys)[:, :1]
        return torch.cat([first, first], dim=1)
    T.q_pairs = q_pairs


def prior_left_out() -> None:
    """The policy prior's trajectories are zero actions."""
    from detex_tpu_torch.mpc import tdmpc2 as T

    def policy_prior(params, z, emb, eps, mask, cfg):
        return torch.zeros_like(eps)
    T.policy_prior = policy_prior

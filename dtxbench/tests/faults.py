"""Faults planted under the timed path for the tests: each function, named
to run.measure as prepare="dtxbench.tests.faults:<name>", patches the
program in the process that runs it (the spawned ranks too) so that one
thing the benchmark must catch goes wrong."""

from __future__ import annotations

import torch


def control_state_unchanged() -> None:
    """Controller.step leaves its plan as it found it."""
    from detex_tpu_torch.mpc import runtime as R
    real = R.control_step

    def step(params, nominal, *args, **kwargs):
        action, _, diag = real(params, nominal, *args, **kwargs)
        return action, nominal, diag
    R.control_step = step


def control_half_batch() -> None:
    """MPPI rolls out half of its noise and weighs the rest alone."""
    from detex_tpu_torch.mpc import mppi
    real = mppi._mppi_update

    def update(eps, nominal, z0, dynamics, cost, cfg, terminal_cost, n_total,
               axis=None, mesh=None):
        half = eps[: eps.shape[0] // 2]
        return real(half, nominal, z0, dynamics, cost, cfg, terminal_cost,
                    half.shape[0], axis, mesh)
    mppi._mppi_update = update


def control_answer_altered() -> None:
    """The action is altered where it is produced."""
    from detex_tpu_torch.mpc import runtime as R
    real = R.control_step

    def step(*args, **kwargs):
        action, nominal, diag = real(*args, **kwargs)
        return action + 0.01, nominal, diag
    R.control_step = step


def exchange_left_out() -> None:
    """The collectives between ranks return each rank's own part."""
    from detex_tpu_torch.parallel import mesh as mesh_mod

    def all_reduce(x, mesh, axis, op="sum"):
        return x.clone()
    mesh_mod.all_reduce = all_reduce


def texture_answer_altered() -> None:
    """One byte of every texture call's output is altered."""
    from detex_tpu_torch import convert_device as CD
    real = CD.to_bytes

    def to_bytes(t):
        out = real(t).copy()
        out[len(out) // 3] ^= 1
        return out
    CD.to_bytes = to_bytes


def texture_invalid_not_zeroed() -> None:
    """Invalid blocks keep what the decoder left in its output (here 0xFF)
    and are not zeroed: every block is flagged valid."""
    from detex_tpu_torch import engine
    real = engine._decoder

    def decoder(tex_fmt):
        decode = real(tex_fmt)

        def run(words, mode_mask, flags):
            pix, valid = decode(words, mode_mask, flags)
            pix = pix.clone()
            pix[~valid] = 0xFF
            return pix, torch.ones_like(valid)
        return run
    engine._decoder = decoder


def texture_half_batch() -> None:
    """The second half of each texture's blocks is not decoded."""
    from detex_tpu_torch import engine
    real = engine._device_tiles

    def tiles(tex_fmt, pixel_format, words, mode_mask, flags):
        out = real(tex_fmt, pixel_format, words, mode_mask, flags)
        out[out.shape[0] // 2:] = 0
        return out
    engine._device_tiles = tiles


def train_state_unchanged() -> None:
    """The optimizer's step leaves the parameters as they were."""
    torch.optim.AdamW.step = lambda self, closure=None: None


def train_half_batch() -> None:
    """The loss is the mean over the first half of the batch."""
    from detex_tpu_torch.mpc import dynamics as D
    real = D.loss_fn

    def loss_fn(params, batch, cfg, mesh=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(params, half, cfg, mesh)
    D.loss_fn = loss_fn


def train_answer_altered() -> None:
    """The step's loss is altered where it is produced."""
    from detex_tpu_torch.mpc import dynamics as D
    real = D.train_step

    def train_step(*args, **kwargs):
        params, loss = real(*args, **kwargs)
        return params, loss * 1.01
    D.train_step = train_step

"""Entry points of the port's main path, the counterparts of
__graft_entry__.py.

entry(device) -> (fn, example_args): the control step (BC7 decode ->
latent encode -> MPPI update) at a small configuration, with the port's
own random parameters and generator; `fn(*example_args)` runs one step.

dryrun_multichip(corpus_path, device): run by every rank of a process
group, one sharded train step and the full-width sharded control step
(and, at an even world of 4 or more, the hierarchical one).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from detex_tpu_torch import resolve_device
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import mppi as M
from detex_tpu_torch.mpc.runtime import ControllerConfig, control_step
from detex_tpu_torch.parallel import mesh as mesh_mod


def _small_cfg() -> ControllerConfig:
    dcfg = D.DynamicsConfig(image_size=32, conv_features=(16, 32, 64),
                            latent_dim=64, action_dim=8, hidden_dim=256)
    mcfg = M.MPPIConfig(n_rollouts=512, horizon=16, action_dim=8)
    return ControllerConfig(dynamics=dcfg, mppi=mcfg)


def entry(device="cuda"):
    """Control step at _small_cfg() on `device` (the card unless
    device="cpu"; raises where CUDA is asked for and absent)."""
    device = resolve_device(device)
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


def dryrun_multichip(corpus_path=None, device="cuda") -> dict:
    """The counterpart of __graft_entry__.dryrun_multichip, run once by
    every rank of the process group (parallel.distributed.initialize or a
    launcher; a single process is a world of one) on `device`:

      * one train step on a (dp, tp) mesh (tp = 2 on an even world) of
        the full-width model on BC7-compressed observations of all 8 BC7
        modes (train_loop.CorpusReplayEnv over the corpus file the caller
        names, if any), decoded on the device;
      * the full-width control step (8192 x 32 rollouts on a 64x64 BC7
        observation) with the rollouts sharded over "dp";
      * on an even world of 4 or more, the same step on a (2, n/2)
        ("dcn", "ici") mesh, where the collective counter must show both
        reduction stages on their groups ("ici" within a row, "dcn" across
        rows), as JAX reads the replica groups from HLO.

    The model computes in bf16 on a card and in float32 on the CPU (bf16
    matmuls are slow there), as the JAX dry run does off the TPU.  Returns
    the loss, the actions and the collective bytes by (op, axis)."""
    from detex_tpu_torch.mpc.train_loop import (CorpusReplayEnv,
                                                make_train_step)

    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = mesh_mod.make_mesh((dp, tp), device=device)
    dcfg = D.DynamicsConfig(
        image_size=64, latent_dim=128, action_dim=8, hidden_dim=512,
        compute_dtype=(torch.bfloat16 if device.type == "cuda"
                       else torch.float32))
    generator = torch.Generator(device=device).manual_seed(0)
    params = D.shard_params(D.init_params(dcfg, generator, device), mesh)
    optimizer = D.make_optimizer(params)

    replay = CorpusReplayEnv(dcfg, seed=0, corpus_path=corpus_path)
    if replay.modes_present != set(range(8)):
        raise AssertionError(f"BC7 modes {sorted(replay.modes_present)}")
    rng = np.random.default_rng(0)
    batch = {k: mesh_mod.shard_batch(torch.as_tensor(v), mesh, "dp")
             .to(device) for k, v in
             replay.sample_batch(rng, max(dp * 2, 4)).items()}
    step = make_train_step(dcfg, optimizer, compressed_obs=True, mesh=mesh)
    params, loss = step(params, batch)
    if not np.isfinite(float(loss)):
        raise AssertionError("training step produced a non-finite loss")

    ccfg = ControllerConfig(
        dynamics=dcfg, mppi=M.MPPIConfig(n_rollouts=8192, horizon=32,
                                         action_dim=8), rollout_axis="dp")
    n_blocks = (dcfg.image_size // 4) ** 2
    obs_words = torch.as_tensor(
        rng.integers(-2**31, 2**31, (n_blocks, 4), np.int64)
        .astype(np.int32), device=device)
    nominal = torch.zeros((32, 8), dtype=torch.float32, device=device)
    goal_z = torch.zeros((dcfg.latent_dim,), dtype=torch.float32,
                         device=device)
    with torch.no_grad():
        action, _, diag = control_step(
            params, nominal, torch.Generator(device=device).manual_seed(0),
            obs_words, goal_z, ccfg, mesh=mesh)
    if tuple(action.shape) != (8,) or not np.isfinite(
            float(diag["min_cost"])):
        raise AssertionError(f"bad sharded control step: {action}")
    out = {"mesh": (dp, tp), "loss": float(loss), "action": action.cpu()}

    if world % 2 == 0 and world >= 4:
        n_ici = world // 2
        hmesh = mesh_mod.make_mesh((2, n_ici), ("dcn", "ici"), device=device)
        whole = D.gather_params(params, mesh)
        hcfg = dataclasses.replace(ccfg, rollout_axis=("dcn", "ici"))
        mesh_mod.reset_collective_bytes()
        with torch.no_grad():
            haction, _, hdiag = control_step(
                whole, nominal,
                torch.Generator(device=device).manual_seed(0), obs_words,
                goal_z, hcfg, mesh=hmesh)
        if not np.isfinite(float(hdiag["min_cost"])):
            raise AssertionError("hierarchical step: min_cost not finite")
        rank = dist.get_rank()
        groups = {a: dist.get_process_group_ranks(hmesh.get_group(a))
                  for a in ("dcn", "ici")}
        row, col = divmod(rank, n_ici)
        want = {"ici": list(range(row * n_ici, (row + 1) * n_ici)),
                "dcn": [col, col + n_ici]}
        if groups != want:
            raise AssertionError(f"groups {groups}, expected {want}")
        for axis in ("ici", "dcn"):
            for op in ("all_reduce_min", "all_reduce_sum"):
                if not mesh_mod.COLLECTIVE_BYTES[(op, axis)]:
                    raise AssertionError(f"no {op} over {axis!r}: "
                                         f"{dict(mesh_mod.COLLECTIVE_BYTES)}")
        out["hier_action"] = haction.cpu()
        out["hier_bytes"] = {f"{op}/{axis}": v for (op, axis), v in
                             mesh_mod.COLLECTIVE_BYTES.items()}
    return out

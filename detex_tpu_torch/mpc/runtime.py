"""Visual-MPC runtime: decode -> encode -> plan control step.

Counterpart of detex_tpu/mpc/runtime.py.  Observations arrive as BC7
blocks; one control step decodes them on the device (the CUDA BC7 kernel
for CUDA tensors), encodes the image to the latent, runs one MPPI update
and, with n_ilqr_iterations > 0, refines the plan with iLQR, with no host
round trip inside the step.  The training step decodes its batches with
the same kernel (decode_obs_batch).

On a card a Controller serves the step as one captured CUDA graph
(_StepGraph), the counterpart of the JAX Controller's jitted step: with no
mesh, and with a mesh whose groups are all NCCL, whose collectives the
graph holds (jax.jit with a mesh).  A gloo mesh and the CPU stay eager.

Multi-rank: with ControllerConfig.rollout_axis and a mesh
(parallel/mesh.py), every rank decodes the observation, encodes it and
rolls out its shard of the MPPI rollouts (mppi.mppi_step); the reductions
are collectives over the axis, and every rank computes the same action.
Parameters split over the mesh's "tp" axis (dynamics.shard_params) make
the encoder and the dynamics tensor-parallel; iLQR then runs on the
parameters gathered whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from detex_tpu_torch import formats as F
from detex_tpu_torch import graphs
from detex_tpu_torch import resolve_device
from detex_tpu_torch.graphs import GRAPH_WARMUP  # noqa: F401 (re-exported)
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc import ilqr as ilqr_mod
from detex_tpu_torch.mpc import mppi as mppi_mod
from detex_tpu_torch.ops import bptc
from detex_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    dynamics: D.DynamicsConfig = D.DynamicsConfig()
    mppi: mppi_mod.MPPIConfig = mppi_mod.MPPIConfig()
    obs_format: int = F.BPTC       # the only one decoded: BC7
    n_ilqr_iterations: int = 0     # 0 disables iLQR refinement
    ilqr_parallel: bool = False    # log-depth parallel-LQT backward
    goal_weight: float = 1.0
    control_weight: float = 0.1
    # Mesh axis (or tuple of axes) to shard the MPPI rollout batch over;
    # None is one rank's program.  The mesh goes to control_step or the
    # Controller: the port has no ambient mesh (JAX's GSPMD form).
    rollout_axis: Optional[object] = None


def unpack_rgba8_images(packed: torch.Tensor, height: int,
                        width: int) -> torch.Tensor:
    """(B, N_blocks, 16) packed RGBA8 int32 -> (B, H, W, 4) int32 0..255.
    Blocks are in row-major block order, pixels row-major in a block."""
    b = packed.shape[0]
    hb, wb = height // 4, width // 4
    img = packed.reshape(b, hb, wb, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(b, height, width)
    # `>>` is arithmetic on int32; the mask drops the copied sign bits.
    return torch.stack([img & 0xFF, (img >> 8) & 0xFF, (img >> 16) & 0xFF,
                        (img >> 24) & 0xFF], dim=-1)


def unpack_rgba8_image(packed: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """(N_blocks, 16) packed RGBA8 int32 -> (H, W, 4) int32 0..255."""
    return unpack_rgba8_images(packed[None], height, width)[0]


def decode_obs_batch(words: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """Batched BC7 observation decode: (B, N_blocks, 4) words -> (B, H, W,
    4) int32 images, one decode call (one kernel launch on a card) for
    the whole batch.  The control step's decode_obs is its B = 1 case:
    training and control share the perception path."""
    b, nb, _ = words.shape
    pix, _ = bptc.decode_bptc(words.reshape(b * nb, 4))
    return unpack_rgba8_images(pix.reshape(b, nb, 16), height, width)


def decode_obs(words: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """BC7 block words (N, 4) -> (H, W, 4) int32 image with values
    0..255, decoded on the words' device."""
    return decode_obs_batch(words[None], height, width)[0]


def _check_obs_format(cfg: ControllerConfig) -> None:
    if cfg.obs_format != F.BPTC:
        raise ValueError(f"observations are decoded as BC7 (F.BPTC); "
                         f"obs_format {cfg.obs_format} is not supported")


def latent_cost_fn(goal_z: torch.Tensor, cfg: ControllerConfig):
    """Quadratic latent-goal cost for the planner."""
    def cost(z, u, t):
        return (cfg.goal_weight * torch.sum((z - goal_z[None]) ** 2, dim=-1)
                + cfg.control_weight * torch.sum(u ** 2, dim=-1))
    return cost


def control_step(params, nominal, generator, obs_words, goal_z,
                 cfg: ControllerConfig, *, eps=None, mesh=None):
    """One full control step: decode BC7 obs -> encode -> MPPI update ->
    (optional iLQR) -> (action u_0 (A,), shifted nominal (H, A),
    diagnostics: 0-d tensors, ilqr_cost among them with iLQR).

    The MPPI noise comes from `generator` unless `eps` (K, H, A) is
    given.  Observations are BC7 words: an obs_format other than F.BPTC
    raises.  With cfg.rollout_axis the rollouts shard over that axis of
    `mesh` (which is then required), and with `mesh` the params are this
    rank's tensor-parallel shards where the mesh has a "tp" axis."""
    _check_obs_format(cfg)
    dcfg = cfg.dynamics
    img = decode_obs(obs_words, dcfg.image_size, dcfg.image_size)
    z0 = D.encode(params, img[None].to(torch.uint8), dcfg, mesh)[0]

    def dyn_batched(z, u):
        return D.dynamics_apply(params, z, u, dcfg, mesh)

    cost = latent_cost_fn(goal_z, cfg)
    new_nominal, diag = mppi_mod.mppi_step(
        nominal, z0, dyn_batched, cost, cfg.mppi, eps=eps,
        generator=generator, rollout_axis=cfg.rollout_axis, mesh=mesh)

    if cfg.n_ilqr_iterations > 0:
        # iLQR's torch.func transforms take no collectives: on a "tp" mesh
        # it runs on the parameters gathered whole.
        whole = D.gather_params(params, mesh) if mesh is not None \
            else params

        def dyn1(x, u):
            return D.dynamics_apply(whole, x[None], u[None], dcfg)[0]

        def cost1(x, u, t):
            return cost(x[None], u[None], t)[0]

        def terminal(x):
            return x.new_zeros(())

        _, new_nominal, refined_cost = ilqr_mod.ilqr_solve(
            dyn1, cost1, terminal, z0, new_nominal,
            ilqr_mod.ILQRConfig(n_iterations=cfg.n_ilqr_iterations,
                                parallel=cfg.ilqr_parallel))
        diag = dict(diag, ilqr_cost=refined_cost)

    action = new_nominal[0]
    shifted = mppi_mod.receding_horizon_shift(new_nominal)
    return action, shifted, diag


def step_body(params, nominal: torch.Tensor, words: torch.Tensor,
              goal_z: torch.Tensor, eps: torch.Tensor,
              cfg: ControllerConfig, mesh=None) -> tuple:
    """The body of the captured step on its static buffers: control_step
    with the noise `eps` (whole; on a mesh each rank keeps its rows) on
    `mesh`, its action and diagnostics packed into one (A + n_diag,)
    float32 tensor, then the shifted plan copied into `nominal`, the last
    op.  That copy is the port's form of JAX's donate_argnums=(1,): the
    next run plans from the plan this one left.  Returns (packed, the
    diagnostics' names); unpack_step undoes the packing."""
    action, shifted, diag = control_step(params, nominal, None, words, goal_z,
                                         cfg, eps=eps, mesh=mesh)
    packed = torch.cat([action, torch.stack(list(diag.values()))])
    nominal.copy_(shifted)
    return packed, tuple(diag)


def unpack_step(packed: torch.Tensor, names: tuple, action_dim: int):
    """step_body's packed output -> (action (A,), diagnostics dict of 0-d
    tensors), views of `packed`."""
    return packed[:action_dim], dict(zip(names,
                                         packed[action_dim:].unbind()))


class _StepGraph:
    """control_step as one captured CUDA graph on a card: the counterpart of
    jax.jit(partial(control_step, mesh=mesh), donate_argnums=(1,)) at
    detex_tpu/mpc/runtime.py:158-160.  With a mesh (NCCL groups only,
    mesh.capturable) the graph holds the step's collectives too: the
    warm-ups make the groups' communicators, and each replay counts the
    collectives' bytes (graphs.Graph).

    Static device buffers hold the observation words (N_blocks, 4), the
    MPPI noise (K, H, A) and the nominal plan (H, A), which every replay
    updates in place; the graph's output packs the action and the
    diagnostics (step_body).  A run loads the words, draws the noise
    outside the graph from the caller's generator with mppi_step's own
    draw (mppi.draw_noise), and replays.  The graph is captured at the first
    run, as jit compiles at the first call (graphs.Graph): GRAPH_WARMUP
    eager steps on a side stream, with zero noise and the nominal restored
    after them, then the capture on that stream.  A failed capture or
    replay raises; there is no eager fallback."""

    def __init__(self, params, nominal: torch.Tensor, goal_z: torch.Tensor,
                 cfg: ControllerConfig, mesh=None):
        if nominal.device.type != "cuda":
            raise ValueError(f"a captured step needs a CUDA device, not "
                             f"{nominal.device}")
        mcfg, side = cfg.mppi, cfg.dynamics.image_size
        self.params, self.nominal, self.goal_z, self.cfg, self.mesh = (
            params, nominal, goal_z, cfg, mesh)
        self.words = torch.zeros(((side // 4) ** 2, 4), dtype=torch.int32,
                                 device=nominal.device)
        self.eps = torch.zeros((mcfg.n_rollouts, mcfg.horizon,
                                mcfg.action_dim), dtype=torch.float32,
                               device=nominal.device)
        self._saved = None
        self._graph = graphs.Graph(nominal.device)

    def load(self, words: torch.Tensor, non_blocking: bool = False) -> None:
        """Copy an observation's (N_blocks, 4) int32 words into the words
        buffer, on the current stream."""
        if tuple(words.shape) != tuple(self.words.shape):
            raise ValueError(f"observation words of shape "
                             f"{tuple(words.shape)}, expected "
                             f"{tuple(self.words.shape)}")
        self.words.copy_(words, non_blocking=non_blocking)

    def capture(self) -> None:
        """Warm up and capture, once; the generator is not touched and the
        nominal is left as it was found."""
        if self._graph.graph is not None:
            return
        self._saved = self.nominal.clone()
        self._graph.capture(self._body, self._restore)
        self._saved = None
        self._packed, self._names = self._graph.out

    def _restore(self) -> None:
        self.nominal.copy_(self._saved)

    @property
    def graph(self):
        """The captured torch.cuda.CUDAGraph, None before the capture."""
        return self._graph.graph

    @property
    def capture_s(self):
        """The capture's wall time in s, warm-ups included."""
        return self._graph.capture_s

    @property
    def launches_per_replay(self):
        """BC7 launches a replay (None before the capture)."""
        if self._graph.graph is None:
            return None
        return self._graph.launches.get("bptc", 0)

    def _body(self):
        return step_body(self.params, self.nominal, self.words, self.goal_z,
                         self.eps, self.cfg, self.mesh)

    def __call__(self, generator) -> tuple:
        """Draw the noise, replay, and return (action, diagnostics) from a
        copy of the output that later replays do not overwrite."""
        self.capture()
        mppi_mod.draw_noise(self.eps, generator, self.cfg.mppi.noise_sigma)
        self._graph.replay()
        return unpack_step(self._packed.clone(), self._names,
                           self.cfg.mppi.action_dim)


class Controller:
    """Serves control_step one observation at a time on `device` (the card
    unless device="cpu"), keeping the nominal plan and a seeded generator
    between steps.  On a card every step is one replay of a captured CUDA
    graph (`graphed`; `nominal` is then the graph's buffer, updated in
    place) with no mesh and with a mesh whose groups are all NCCL
    (mesh.capturable, decided here from the backends); on the CPU and on a
    gloo mesh, whose collectives copy through the host, which a capture
    cannot hold, the step runs eagerly.  With a mesh, every rank of it runs
    its own Controller on the same observations and seed (control_step's
    `mesh`); on NCCL every rank captures at its first step and replays at
    each step after, so the ranks' collectives stay in step."""

    def __init__(self, params, goal_z: torch.Tensor, cfg: ControllerConfig,
                 seed: int = 0, device="cuda", mesh=None):
        _check_obs_format(cfg)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.goal_z = goal_z.to(self.device)
        self.cfg = cfg
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.nominal = torch.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                                   dtype=torch.float32, device=self.device)
        self.diag = None
        self._program = None
        if self.device.type == "cuda" and (mesh is None
                                           or mesh_mod.capturable(mesh)):
            self._program = _StepGraph(params, self.nominal, self.goal_z,
                                       cfg, mesh)

    @property
    def graphed(self) -> bool:
        """True where each step is one replay of a captured CUDA graph."""
        return self._program is not None

    # no_grad, not inference_mode: on torch 2.11, iLQR's vmap(jacfwd(...))
    # over inference tensors raises (no batching rule for _make_dual).
    @torch.no_grad()
    def step(self, obs_words) -> np.ndarray:
        """(N_blocks, 4) int32 BC7 words (numpy or tensor) -> (A,) action."""
        words = torch.as_tensor(obs_words, dtype=torch.int32)
        if self._program is not None:
            self._program.load(words)
            action, self.diag = self._program(self.generator)
            return action.cpu().numpy()
        action, self.nominal, self.diag = control_step(
            self.params, self.nominal, self.generator,
            words.to(self.device).contiguous(), self.goal_z, self.cfg,
            mesh=self.mesh)
        return action.cpu().numpy()


class PipelinedController(Controller):
    """One-step software pipeline over the control loop (counterpart of
    detex_tpu/mpc/runtime.py:169-205).

    `step` enqueues the whole control step on the card and returns the
    action planned from the PREVIOUS observation: while the caller
    actuates it and produces the next observation, the card decodes,
    encodes and plans on the current one.  The observation goes up from a
    reused pinned host buffer (into the captured step's words buffer) and
    the action comes down into one, both with non_blocking=True on the
    current stream; with the step one graph replay, the host's part is a
    few calls and nothing on it waits for the card.  A CUDA event
    recorded after the action's copy is what the next call waits on.  The
    returned action lags one control period; the plans equal the
    synchronous controller's, since both draw from the same generator
    stream.

    Two buffers of each kind alternate: the one a step writes was last
    used two steps before, and the previous call waited on that step's
    event.  On the CPU the same code runs eagerly with plain buffers, and
    the copies are synchronous.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        pin = self.device.type == "cuda"
        n_blocks = (self.cfg.dynamics.image_size // 4) ** 2
        self._words_host = [torch.empty((n_blocks, 4), dtype=torch.int32,
                                        pin_memory=pin) for _ in range(2)]
        self._action_host = [torch.empty((self.cfg.mppi.action_dim,),
                                         dtype=torch.float32,
                                         pin_memory=pin) for _ in range(2)]
        self._slot = 0
        self._pending = None

    @torch.no_grad()
    def step(self, obs_words) -> Optional[np.ndarray]:
        """Enqueue planning on `obs_words`; return the action from the
        previous observation (None on the first call: nothing is in
        flight yet)."""
        slot, self._slot = self._slot, self._slot ^ 1
        host = self._words_host[slot]
        host.copy_(torch.as_tensor(obs_words, dtype=torch.int32))
        if self._program is not None:
            self._program.load(host, non_blocking=True)
            action, self.diag = self._program(self.generator)
        else:
            action, self.nominal, self.diag = control_step(
                self.params, self.nominal, self.generator,
                host.to(self.device, non_blocking=True), self.goal_z,
                self.cfg, mesh=self.mesh)
        out = self._action_host[slot]
        out.copy_(action, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        prev, self._pending = self._pending, (out, event)
        return self._collect(prev)

    def flush(self) -> Optional[np.ndarray]:
        """Drain the pipeline: wait for the action in flight."""
        prev, self._pending = self._pending, None
        return self._collect(prev)

    @staticmethod
    def _collect(pending) -> Optional[np.ndarray]:
        if pending is None:
            return None
        out, event = pending
        if event is not None:
            event.synchronize()
        return out.numpy().copy()

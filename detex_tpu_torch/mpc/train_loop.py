"""Dynamics-model training loop: mesh-sharded, checkpointed, metered.

Counterpart of detex_tpu/mpc/train_loop.py.  The environments are
the same numpy code, so one seed gives the same batches, byte for byte,
in both packages.  With compressed observations the training step decodes
the BC7 batches on the device with the control step's decode
(runtime.decode_obs_batch: one BC7 kernel launch per batch of words).
On a card the step is one captured CUDA graph (_TrainGraph), the
counterpart of the JAX loop's jitted step: with no mesh, and with a mesh
whose groups are all NCCL, whose gradient all_reduce the graph holds.
Checkpoints are written every `checkpoint_every` steps and a run resumes
deterministically from `checkpoint_dir/latest`: the data stream is
re-seeded from the restored step counter.

With TrainConfig.mesh_shape = (dp, tp) every rank of the process group
(parallel/distributed.initialize; a single process is a world of one)
samples the same deterministic batch and keeps its dp rows, holds its tp
shards of the parameters and the optimizer state (dynamics.shard_params),
and averages the gradients over dp (dynamics.train_step).  Rank 0 alone
logs metrics and writes checkpoints, in the single-process format (the
shards gathered whole), so a checkpoint written with a mesh resumes
without one, and the reverse.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from detex_tpu_torch import graphs
from detex_tpu_torch import resolve_device
from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc.runtime import decode_obs_batch
from detex_tpu_torch.parallel import mesh as mesh_mod
from detex_tpu_torch.utils import checkpoint as ckpt
from detex_tpu_torch.utils import trace
from detex_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dynamics: D.DynamicsConfig = D.DynamicsConfig(
        image_size=32, conv_features=(16, 32, 64), latent_dim=64,
        action_dim=4, hidden_dim=256)
    batch_size: int = 64
    n_steps: int = 100
    lr: float = 3e-4
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    mesh_shape: Optional[tuple] = None      # (dp, tp); None: no mesh
    # Observations arrive as BC7 blocks and are decoded on the device by
    # the control step's kernel; the env must emit obs_words and
    # next_obs_words.
    compressed_obs: bool = False


class SyntheticVisualEnv:
    """Hidden linear system z' = A z + B u rendered to uint8 images.

    compressed=True emits observations as BC7 texture blocks
    (ops/bptc_encode.py mode-6 grayscale) instead of raw images, which
    the training step decodes on the device."""

    def __init__(self, cfg: D.DynamicsConfig, seed: int = 0,
                 state_dim: int = 8, compressed: bool = False):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        self.state_dim = state_dim
        self.compressed = compressed
        a = rng.standard_normal((state_dim, state_dim))
        # stable transition
        self.A = (0.95 * a / max(1e-6, np.abs(np.linalg.eigvals(a)).max())
                  ).astype(np.float32)
        self.B = (0.3 * rng.standard_normal(
            (state_dim, cfg.action_dim))).astype(np.float32)
        n_pix = cfg.image_size * cfg.image_size * cfg.channels
        self.render_w = rng.standard_normal(
            (state_dim, n_pix)).astype(np.float32)
        n_gray = cfg.image_size * cfg.image_size
        self.render_w_gray = rng.standard_normal(
            (state_dim, n_gray)).astype(np.float32)

    def render(self, z: np.ndarray) -> np.ndarray:
        flat = np.tanh(z @ self.render_w)
        img = ((flat * 0.5 + 0.5) * 255.0).astype(np.uint8)
        s = self.cfg.image_size
        return img.reshape(z.shape[0], s, s, self.cfg.channels)

    def render_words(self, z: np.ndarray) -> np.ndarray:
        """(B, state) -> (B, n_blocks, 4) int32 BC7 block words."""
        from detex_tpu_torch.ops import bptc_encode as E
        s = self.cfg.image_size
        flat = np.tanh(z @ self.render_w_gray)
        img = ((flat * 0.5 + 0.5) * 255.0).astype(np.uint8) \
            .reshape(z.shape[0], s, s)
        return np.stack([E.encode_bc7_mode6_gray(im) for im in img])

    def sample_batch(self, rng: np.random.Generator,
                     batch_size: int) -> Dict[str, np.ndarray]:
        z = rng.standard_normal((batch_size, self.state_dim)) \
            .astype(np.float32)
        u = rng.uniform(-1, 1, (batch_size, self.cfg.action_dim)) \
            .astype(np.float32)
        z_next = z @ self.A.T + u @ self.B.T
        if self.compressed:
            return {"obs_words": self.render_words(z), "action": u,
                    "next_obs_words": self.render_words(z_next)}
        return {"obs": self.render(z), "action": u,
                "next_obs": self.render(z_next)}


class CorpusReplayEnv:
    """Replay env serving real BC7 corpus blocks as observations, drawn
    from a pool of

      * every block of the BC7 texture at `corpus_path` (the C reference's
        test-texture-BPTC.ktx holds 256 mode-3 two-subset blocks), when
        one is given and readable, and
      * a deterministic set of random blocks behind a uniform mode prefix,
        every BC7 mode 0-7 (any bitstring behind a valid mode prefix is a
        valid BC7 block),

    so the trained path decodes multi-subset, rotated and dual-stream
    blocks, not just the encoder's two modes.

    sample_batch's observations are state-dependent: the same hidden
    linear system z' = A z + B u as SyntheticVisualEnv drives block
    selection (each block position j quantizes tanh(z . w_j) into a pool
    index).  obs_words and _draw_words draw state-independently, for
    throughput runs.

    Unlike the JAX package's env, which looks for the corpus inside a
    checkout of the C reference by default, this one reads a corpus only
    where the caller names its file."""

    def __init__(self, cfg: D.DynamicsConfig, seed: int = 0,
                 corpus_path: Optional[str] = None, pool_random: int = 1024,
                 state_dim: int = 8):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        self.state_dim = state_dim
        pool = []
        from detex_tpu_torch.io import ktx as ktx_io
        try:
            if corpus_path is not None:
                tex = ktx_io.load_ktx(corpus_path)[0]
                pool.append(np.ascontiguousarray(
                    tex.data.reshape(tex.n_blocks, 16)).view(np.uint32)
                    .astype(np.int64).astype(np.int32))
        except (OSError, ValueError, ktx_io.TextureFileError):
            pass          # missing OR corrupt corpus: random pool only
        rand = rng.integers(0, 256, (pool_random, 16), np.uint8)
        modes = np.arange(pool_random) % 8
        rand[:, 0] = ((1 << modes)
                      | (rand[:, 0].astype(np.int64)
                         & (0xFF << (modes + 1)))).astype(np.uint8)
        pool.append(np.ascontiguousarray(rand).view(np.uint32)
                    .astype(np.int64).astype(np.int32))
        self.pool = np.concatenate(pool)        # (P, 4) int32 words
        self.n_blocks = (cfg.image_size // 4) ** 2
        a = rng.standard_normal((state_dim, state_dim))
        self.A = (0.95 * a / max(1e-6, np.abs(np.linalg.eigvals(a)).max())
                  ).astype(np.float32)
        self.B = (0.3 * rng.standard_normal(
            (state_dim, cfg.action_dim))).astype(np.float32)
        self.sel_w = rng.standard_normal(
            (state_dim, self.n_blocks)).astype(np.float32)

    def words_of_state(self, z: np.ndarray) -> np.ndarray:
        """(B, state_dim) -> (B, n_blocks, 4) int32 block words, a
        deterministic function of the hidden state."""
        t = np.tanh(z @ self.sel_w / np.sqrt(self.state_dim))
        idx = ((t * 0.5 + 0.5) * (self.pool.shape[0] - 1)) \
            .astype(np.int64)
        return self.pool[idx]

    @property
    def modes_present(self) -> set:
        b0 = self.pool[:, 0].astype(np.int64) & 0xFF
        present = set()
        for m in range(8):
            if np.any((b0 & ((1 << (m + 1)) - 1)) == (1 << m)):
                present.add(m)
        return present

    def _draw_words(self, rng: np.random.Generator,
                    batch_size: int) -> np.ndarray:
        idx = rng.integers(0, self.pool.shape[0],
                           (batch_size, self.n_blocks))
        return self.pool[idx]                   # (B, n_blocks, 4)

    def obs_words(self, rng: np.random.Generator) -> np.ndarray:
        """(n_blocks, 4) int32: one observation for control_step."""
        return self._draw_words(rng, 1)[0]

    def sample_batch(self, rng: np.random.Generator,
                     batch_size: int) -> Dict[str, np.ndarray]:
        z = rng.standard_normal((batch_size, self.state_dim)) \
            .astype(np.float32)
        u = rng.uniform(-1, 1, (batch_size, self.cfg.action_dim)) \
            .astype(np.float32)
        z_next = z @ self.A.T + u @ self.B.T
        return {"obs_words": self.words_of_state(z),
                "action": u,
                "next_obs_words": self.words_of_state(z_next)}


def decode_batch(batch: Dict[str, torch.Tensor],
                 size: int) -> Dict[str, torch.Tensor]:
    """A batch of BC7 words (obs_words, next_obs_words, action) -> the
    batch of images (obs, next_obs, action) the loss takes: one decode
    call each for obs_words and next_obs_words."""
    return {"obs": decode_obs_batch(batch["obs_words"], size, size),
            "next_obs": decode_obs_batch(batch["next_obs_words"], size,
                                         size),
            "action": batch["action"]}


def make_train_step(dcfg: D.DynamicsConfig, optimizer,
                    compressed_obs: bool = False, mesh=None):
    """step(params, batch) -> (params, loss): one AdamW step of
    `optimizer`; with compressed_obs the batch carries obs_words and
    next_obs_words, decoded on the device first (decode_batch).  With a
    mesh, the batch is this rank's dp rows and the params its tp shards
    (dynamics.train_step)."""
    if not compressed_obs:
        def step(params, batch):
            return D.train_step(params, optimizer, batch, dcfg, mesh)
        return step

    def visual_step(params, batch):
        return D.train_step(params, optimizer,
                            decode_batch(batch, dcfg.image_size), dcfg, mesh)

    return visual_step


def train_body(params, optimizer, batch: Dict[str, torch.Tensor],
               dcfg: D.DynamicsConfig, compressed_obs: bool, mesh=None
               ) -> torch.Tensor:
    """The body of the captured train step on its static buffers:
    make_train_step's step (visual_step's decode_batch then
    dynamics.train_step with compressed_obs; train_step alone without) on
    `mesh` (`batch` is then this rank's dp rows and the parameters its tp
    shards), returning the loss, a 0-d tensor (the global batch's on a
    mesh).  The parameters and the optimizer's state are updated in place:
    the port's form of JAX's donate_argnums=(0, 1)
    (detex_tpu/mpc/train_loop.py:218-233)."""
    if compressed_obs:
        batch = decode_batch(batch, dcfg.image_size)
    return D.train_step(params, optimizer, batch, dcfg, mesh)[1]


def _step_state(params, optimizer) -> list:
    """Every tensor a train step updates in place: the parameters, then
    each one's optimizer state (exp_avg, exp_avg_sq, step) where it has
    one (a fresh optimizer has none before its first step)."""
    leaves = D.param_leaves(params)
    return leaves + [t for p in leaves
                     for _, t in sorted(optimizer.state.get(p, {}).items())]


@torch.no_grad()
def save_step_state(params, optimizer) -> list:
    """Copies of _step_state's tensors."""
    return [t.clone() for t in _step_state(params, optimizer)]


@torch.no_grad()
def restore_step_state(params, optimizer, saved: list) -> None:
    """Put the state that save_step_state copied back in place, into the
    same tensors.  Where the optimizer was fresh then and has stepped
    since, its moments and step count go back to zero, as torch makes them
    at a first step."""
    state = _step_state(params, optimizer)
    n = len(D.param_leaves(params))
    if len(saved) == n:
        saved = saved + [torch.zeros_like(t) for t in state[n:]]
    for t, s in zip(state, saved, strict=True):
        t.copy_(s)


class _TrainGraph:
    """The train step as one captured CUDA graph on a card: the
    counterpart of jax.jit(visual_step, donate_argnums=(0, 1)) at
    detex_tpu/mpc/train_loop.py:218-233, and with a mesh (NCCL groups
    only, mesh.capturable) of that step jitted on the mesh's shardings,
    its gradient all_reduce over "dp" inside the graph.

    Static device buffers hold the batch, this rank's dp rows of it on a
    mesh (B = batch_size // dp): obs_words and next_obs_words
    ((B, N_blocks, 4) int32) with compressed observations, else obs and
    next_obs ((B, H, W, C) uint8), and action ((B, A) float32).  load()
    cuts a host batch to this rank's rows (mesh.shard_batch) and copies
    them in through one of two reused pinned buffers, on the current
    stream and without waiting for the replay before it; a call replays
    train_body on them, updating the parameters and the optimizer's
    moments and step count in place, and returns a copy of the loss.  The
    graph is captured at the first call (graphs.Graph): GRAPH_WARMUP eager
    steps on a side stream, which train, so the parameters and the
    optimizer's state are saved before them and put back in place after
    them; the first replay is then step 1 of the
    trajectory the eager loop takes.  The optimizer must be capturable
    (dynamics.make_optimizer on a card).  A failed capture or replay
    raises; there is no eager fallback."""

    def __init__(self, params, optimizer, dcfg: D.DynamicsConfig,
                 batch_size: int, compressed_obs: bool, mesh=None):
        leaves = D.param_leaves(params)
        device = leaves[0].device
        if device.type != "cuda":
            raise ValueError(f"a captured train step needs a CUDA device, "
                             f"not {device}")
        self.params, self.optimizer, self.dcfg = params, optimizer, dcfg
        self.compressed_obs, self.mesh = compressed_obs, mesh
        s, b = dcfg.image_size, batch_size
        if mesh is not None:
            b //= mesh_mod.axis_size(mesh, "dp")
        obs = (((b, (s // 4) ** 2, 4), torch.int32) if compressed_obs
               else ((b, s, s, dcfg.channels), torch.uint8))
        names = (("obs_words", "next_obs_words") if compressed_obs
                 else ("obs", "next_obs"))
        shapes = {names[0]: obs, names[1]: obs,
                  "action": ((b, dcfg.action_dim), torch.float32)}
        self.batch = {k: torch.zeros(shape, dtype=dtype, device=device)
                      for k, (shape, dtype) in shapes.items()}
        self._host = [{k: torch.empty(shape, dtype=dtype, pin_memory=True)
                       for k, (shape, dtype) in shapes.items()}
                      for _ in range(2)]
        self._uploaded = [None, None]
        self._slot = 0
        self._saved = None
        self._graph = graphs.Graph(device)

    def load(self, batch: Dict[str, np.ndarray]) -> None:
        """Copy a host batch (numpy arrays or CPU tensors; the global batch
        on a mesh, of which this rank's dp rows are kept) into the static
        buffers: into a pinned buffer on the host, then up with
        non_blocking=True on the current stream.  The pinned buffer was
        last read by the upload two loads before, which the card has
        finished unless it is that far behind; only then does this wait."""
        slot, self._slot = self._slot, self._slot ^ 1
        event = self._uploaded[slot]
        if event is not None and not event.query():
            with trace.span("dtx.train.wait"):
                event.synchronize()
        host = self._host[slot]
        with trace.span("dtx.train.stage"):
            for k, buf in self.batch.items():
                src = torch.as_tensor(batch[k])
                if self.mesh is not None:
                    src = mesh_mod.shard_batch(src, self.mesh, "dp")
                if tuple(src.shape) != tuple(buf.shape) or \
                        src.dtype != buf.dtype:
                    raise ValueError(f"batch {k} of shape "
                                     f"{tuple(src.shape)} {src.dtype}, "
                                     f"expected {tuple(buf.shape)} "
                                     f"{buf.dtype}")
                host[k].copy_(src)
                trace.count_copy(host[k], buf.device)
                buf.copy_(host[k], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._uploaded[slot] = event

    def capture(self) -> None:
        """Save the state, warm up, put the state back, capture; once."""
        if self._graph.graph is not None:
            return
        self._saved = save_step_state(self.params, self.optimizer)
        self._graph.capture(self._body, self._restore)
        self._saved = None

    def _restore(self) -> None:
        restore_step_state(self.params, self.optimizer, self._saved)

    def _body(self) -> torch.Tensor:
        return train_body(self.params, self.optimizer, self.batch, self.dcfg,
                          self.compressed_obs, self.mesh)

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

    def __call__(self) -> torch.Tensor:
        """One train step on the loaded batch: the loss before the step,
        a 0-d tensor that later steps do not overwrite."""
        self.capture()
        return self._graph.replay().clone()


def _opt_state(state_dict: dict, leaf, names) -> dict:
    """An optimizer state dict with each moment passed through
    leaf(tensor, layer name, leaf name)."""
    state = {i: dict(st, **{k: leaf(st[k], *names[i])
                            for k in ("exp_avg", "exp_avg_sq") if k in st})
             for i, st in state_dict["state"].items()}
    return dict(state_dict, state=state)


def _leaf_names(params) -> list:
    """(layer name, leaf name) of each leaf, in param_leaves order."""
    return [(name, k) for part in sorted(params)
            for name in sorted(params[part])
            for k in sorted(params[part][name])]


def train(cfg: TrainConfig, metrics: Optional[MetricsLogger] = None,
          env=None, device="cuda"):
    """Run the training loop on `device` (the card unless device="cpu");
    returns (params, optimizer, last_loss): with a mesh, this rank's
    shards and the global batch's loss.

    On a card every step is one replay of a captured CUDA graph
    (_TrainGraph), captured at the first step, after the restore, with no
    mesh and with a mesh whose groups are all NCCL (mesh.capturable,
    decided from the backends before any capture); on the CPU and on a
    gloo mesh (gloo's collectives copy through the host, which a capture
    cannot hold) each step runs eagerly (make_train_step).  Checkpoints
    read the live parameters and optimizer state, which the graph updates
    in place; on a mesh their gathers run eagerly between replays, on the
    communicators the graph's all_reduce uses.  NCCL runs a communicator's
    collectives in the order each rank issues them, so every rank must
    replay and gather in the same order: every rank runs this same loop
    (same n_steps, checkpoint_every and resume point), as a launcher that
    starts them all with one config does.  Resumes from
    cfg.checkpoint_dir/latest if present."""
    device = resolve_device(device)
    mesh = (None if cfg.mesh_shape is None
            else mesh_mod.make_mesh(cfg.mesh_shape, device=device))
    lead = mesh is None or mesh.get_rank() == 0
    dcfg = cfg.dynamics
    env = env or SyntheticVisualEnv(dcfg, cfg.seed,
                                    compressed=cfg.compressed_obs)
    metrics = metrics or MetricsLogger()

    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    params = D.init_params(dcfg, generator, device)
    names = _leaf_names(params)
    start_step = 0
    opt_state = None

    ckpt_path = (Path(cfg.checkpoint_dir) / "latest"
                 if cfg.checkpoint_dir else None)
    if ckpt_path is not None and ckpt_path.exists():
        state = ckpt.restore(str(ckpt_path), map_location="cpu")
        with torch.no_grad():
            for p, saved in zip(D.param_leaves(params),
                                D.param_leaves(state["params"])):
                p.copy_(saved)
        opt_state = state["opt_state"]
        start_step = int(state["step"])
    if mesh is not None:
        params = D.shard_params(params, mesh)
    optimizer = D.make_optimizer(params, cfg.lr)
    if opt_state is not None:
        if mesh is not None:
            opt_state = _opt_state(opt_state, lambda x, n, k: D.shard_leaf(
                x, mesh, n, k), names)
        optimizer.load_state_dict(opt_state)

    graph = step_fn = None
    if device.type == "cuda" and (mesh is None
                                  or mesh_mod.capturable(mesh)):
        graph = _TrainGraph(params, optimizer, dcfg, cfg.batch_size,
                            cfg.compressed_obs, mesh)
    else:
        step_fn = make_train_step(dcfg, optimizer, cfg.compressed_obs, mesh)
    loss = torch.zeros(())
    for step in range(start_step, cfg.n_steps):
        with trace.span("dtx.train.step"):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step]))
            with trace.span("dtx.train.env"):
                batch = env.sample_batch(rng, cfg.batch_size)
            if graph is not None:
                graph.load(batch)
                with trace.span("dtx.train.launch"):
                    loss = graph()
            else:
                with trace.span("dtx.train.stage"):
                    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
                    if mesh is not None:
                        batch = {k: mesh_mod.shard_batch(v, mesh, "dp")
                                 for k, v in batch.items()}
                    for v in batch.values():
                        trace.count_copy(v, device)
                    batch = {k: v.to(device) for k, v in batch.items()}
                with trace.span("dtx.train.launch"):
                    params, loss = step_fn(params, batch)
            if lead and (step % 10 == 0 or step == cfg.n_steps - 1):
                with trace.span("dtx.train.wait"):
                    value = float(loss)
                metrics.log(step, loss=value)
            if (ckpt_path is not None and cfg.checkpoint_every
                    and (step + 1) % cfg.checkpoint_every == 0):
                with trace.span("dtx.train.checkpoint"):
                    whole, opt = params, optimizer.state_dict()
                    if mesh is not None:  # every rank takes part in gathers
                        whole = D.gather_params(params, mesh)
                        opt = _opt_state(opt, lambda x, n, k: D.gather_leaf(
                            x, mesh, n, k), names)
                    if lead:
                        ckpt_path.parent.mkdir(parents=True, exist_ok=True)
                        ckpt.save(str(ckpt_path), ckpt.controller_state(
                            whole, opt, torch.zeros((1,)),
                            generator.get_state(), step + 1))
    return params, optimizer, float(loss)

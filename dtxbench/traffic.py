"""Inputs made from the seed.  The program receives only what is made here.

BC7 blocks are random bytes behind a valid mode prefix: byte 0's lowest
set bit is the mode, and every bitstring behind a valid prefix is a valid
BC7 block, so each block decodes and the modes are uniform.  A share of
them may be made invalid (byte 0 zero: no mode), which a decoder must
output as zeros.
"""

from __future__ import annotations

import numpy as np


def bc7_blocks(rng: np.random.Generator, n: int, modes=None,
               invalid_share: float = 0.0) -> np.ndarray:
    """(n, 16) uint8 BC7 blocks: random bytes, mode `modes[i]` (uniformly
    random where None) written as byte 0's lowest set bit; then
    round(n * invalid_share) blocks at places drawn from `rng` get byte 0
    zero, which makes them invalid."""
    blocks = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    if modes is None:
        modes = rng.integers(0, 8, size=n)
    modes = np.asarray(modes, np.int64)
    blocks[:, 0] = ((1 << modes)
                    | (blocks[:, 0].astype(np.int64) & (0xFF << (modes + 1)))
                    ).astype(np.uint8)
    invalid = round(n * invalid_share)
    if invalid:
        blocks[rng.choice(n, size=invalid, replace=False), 0] = 0
    return blocks


def words(blocks: np.ndarray) -> np.ndarray:
    """(..., 16) uint8 blocks -> (..., 4) int32 little-endian words."""
    return np.ascontiguousarray(blocks).view("<u4").astype(np.int64) \
        .astype(np.int32)


def blocks_of(words_: np.ndarray) -> np.ndarray:
    """(..., 4) int32 words -> (..., 16) uint8 blocks."""
    return np.ascontiguousarray(words_.astype("<i4")).view(np.uint8)


def observation_pool(rng: np.random.Generator, frames: int,
                     side: int) -> np.ndarray:
    """(frames, (side / 4)^2, 4) int32 words: a camera's BC7 frames."""
    n = (side // 4) ** 2
    return words(bc7_blocks(rng, frames * n)).reshape(frames, n, 4)


def replay_batches(rng: np.random.Generator, count: int, batch: int,
                   side: int, pool_size: int, action_dim: int) -> list:
    """`count` training batches of `batch` transitions, each observation
    (and next observation) (side / 4)^2 blocks drawn from a pool of
    `pool_size` random blocks whose modes cycle 0..7, as a replay buffer
    of real frames draws them; actions uniform in [-1, 1]."""
    pool = words(bc7_blocks(rng, pool_size, np.arange(pool_size) % 8))
    n = (side // 4) ** 2
    out = []
    for _ in range(count):
        out.append({
            "obs_words": pool[rng.integers(0, pool_size, (batch, n))],
            "action": rng.uniform(-1, 1, (batch, action_dim))
            .astype(np.float32),
            "next_obs_words": pool[rng.integers(0, pool_size, (batch, n))],
        })
    return out

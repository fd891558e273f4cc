"""Texture container shared by the I/O and decode layers.

The port's own copy of detex_tpu/texture.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

Mirrors the reference detexTexture struct (reference: detex.h:729-736):
format, raw data bytes, pixel dimensions and block-grid dimensions.
Data is host-side numpy; the decode engine turns it into device arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from detex_tpu_torch import formats as F


@dataclasses.dataclass
class Texture:
    """One mip level of a (possibly compressed) texture."""

    format: int
    data: np.ndarray          # flat uint8 bytes
    width: int
    height: int
    width_in_blocks: int
    height_in_blocks: int

    @classmethod
    def new(cls, fmt: int, data: np.ndarray, width: int, height: int):
        if F.is_compressed(fmt):
            wb = (width + 3) // 4
            hb = (height + 3) // 4
        else:
            wb = hb = 0
        return cls(fmt, np.ascontiguousarray(data, dtype=np.uint8).ravel(),
                   width, height, wb, hb)

    @property
    def n_blocks(self) -> int:
        return self.width_in_blocks * self.height_in_blocks

    @property
    def block_size(self) -> int:
        return F.block_size_bytes(self.format)

    def expected_data_size(self) -> int:
        if F.is_compressed(self.format):
            return self.n_blocks * self.block_size
        return self.width * self.height * F.pixel_size(self.format)

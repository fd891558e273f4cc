"""Headerless raw texture I/O (reference: raw.c:30-73).

The port's own copy of detex_tpu/io/raw.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import numpy as np

from detex_tpu_torch.texture import Texture


def load_raw(filename: str, template: Texture) -> Texture:
    """Read raw data sized from the caller-provided texture fields
    (reference detexLoadRawFile, raw.c:30-50)."""
    data = np.fromfile(filename, dtype=np.uint8)
    expected = template.expected_data_size()
    if data.size < expected:
        raise ValueError(
            f"raw file {filename} too small ({data.size} < {expected})")
    return Texture(template.format, data[:expected], template.width,
                   template.height, template.width_in_blocks,
                   template.height_in_blocks)


def save_raw(texture: Texture, filename: str) -> None:
    """Write the raw data bytes (reference detexSaveRawFile,
    raw.c:55-73)."""
    texture.data.tofile(filename)

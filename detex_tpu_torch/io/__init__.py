"""File I/O: KTX / DDS / raw / PNG with extension dispatch
(reference: misc.c:98-121 detexLoadTextureFile*).

The port's own copy of detex_tpu/io/__init__.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py."""

from __future__ import annotations

from typing import List

from detex_tpu_torch.io.dds import load_dds, save_dds
from detex_tpu_torch.io.ktx import TextureFileError, load_ktx, save_ktx
from detex_tpu_torch.io.png import load_png, save_png
from detex_tpu_torch.io.raw import load_raw, save_raw
from detex_tpu_torch.texture import Texture

__all__ = [
    "TextureFileError", "load_texture_file", "save_texture_file",
    "load_ktx", "save_ktx", "load_dds", "save_dds", "load_png", "save_png",
    "load_raw", "save_raw",
]


def load_texture_file(filename: str, max_mipmaps: int = 1) -> List[Texture]:
    """Extension-dispatched load (reference misc.c:98-109)."""
    lower = filename.lower()
    if lower.endswith(".ktx"):
        return load_ktx(filename, max_mipmaps)
    if lower.endswith(".dds"):
        return load_dds(filename, max_mipmaps)
    if lower.endswith(".png"):
        return [load_png(filename)]
    raise TextureFileError("Do not recognize filename extension")


def save_texture_file(textures: List[Texture], filename: str) -> None:
    lower = filename.lower()
    if lower.endswith(".ktx"):
        save_ktx(textures, filename)
    elif lower.endswith(".dds"):
        save_dds(textures, filename)
    elif lower.endswith(".png"):
        save_png(textures[0], filename)
    else:
        raise TextureFileError("Do not recognize filename extension")

"""Texture decode engine of the port: batched block decode, pixel-format
conversion and assembly of the linear or tiled image.

Counterpart of detex_tpu/engine.py (reference texture engine,
texture.c:27-145).  Every block of a texture is decoded by one kernel
launch; the image is assembled with a reshape and a permute, with no
per-block loop.

Layers:
  decode_blocks_device : (N, k) int32 word tensor -> the decoder's packed
      payload and valid flags, on the tensor's device
  decode_blocks_sharded: the same on each rank of a mesh axis, for its
      N / n rows of the words, with no collective
  decode_blocks        : (N, block bytes) u8 blocks -> per-block pixel
      bytes on the host, byte for byte the reference's pixel buffers
  decompress_texture_linear_device / _tiled_device : the whole texture,
      decoded, converted (convert_device), zeroed and assembled on the
      device by _device_pipeline, returned as a device tensor
  decompress_texture_linear / _tiled : the whole texture in a pixel format
      as host bytes, with partial edge blocks cropped and invalid blocks
      zero in the target format (texture.c:90-93, 125-127)

Backends of the texture calls:
  "device": decode, convert, zero and assemble on `device`, then copy the
      image to the host;
  "torch":  decode on `device`, convert with the host converter
      convert.convert_pixels;
  "native": the multithreaded C++ host runtime, native (the port's copy).
The device is explicit: a CUDA device runs the CUDA kernels, the CPU runs
their plain PyTorch versions, and nothing falls back from one to the other.
A format pair with no conversion path raises ConversionError on every
backend.

Host copies on a card: a call's words go up, and a "device" call's image
comes back, through pinned host blocks taken from torch's caching host
allocator (torch.empty(..., pin_memory=True)), never through fresh
pageable memory.  The words are copied once into a pinned block viewed as
int32 words and uploaded without a wait (convert_device.staged, .upload);
the image is copied into a pinned block of its own, the copy alone is
waited for under graphs.run's lock, and the block's numpy view is
returned (convert_device.to_bytes).  The caller owns that array: later
calls do not change it, and when it is freed its block goes back to the
cache, where the next call of the size takes it without a cudaHostAlloc.
So the pinned memory a process holds is the peak of what its callers
hold at once plus one call's staging, each block rounded up to a power
of two by the cache, which keeps freed blocks pinned until
torch._C._host_emptyCache() (where torch has it) releases them.  A
caller that keeps every image holds that many blocks pinned.  On the CPU
the same single copies go through ordinary host memory.

One program per call, as in the JAX engine: on a card every "device"
texture call (and the "device" conversion of an uncompressed texture,
convert_device.convert_pixels_torch) whose key was called before is one
replay of a CUDA graph captured per key (_device_pipeline,
graphs.Program), the counterpart of JAX's jitted pipelines
(detex_tpu/engine.py:278-394); a key's first call runs the same kernels
eagerly, so a caller that never repeats a key (dtx-convert on a mip chain)
pays no capture and keeps no graph.  The calls take one lock
(graphs.run), so threads may share the engine.  decode_blocks_device
stays a direct launch: it is one kernel, so one launch is already one
program (JAX's _jitted_decoder, detex_tpu/engine.py:97-100).
"""

from __future__ import annotations

import numpy as np
import torch

from detex_tpu_torch import convert as C
from detex_tpu_torch import resolve_device as _device
from detex_tpu_torch import formats as F
from detex_tpu_torch import graphs
from detex_tpu_torch.texture import Texture
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch.ops import bc, bptc, bptc_float, eac, etc, rgtc
from detex_tpu_torch.parallel import mesh as mesh_mod
from detex_tpu_torch.utils import trace

_FULL = 0xFFFFFFFF
BACKENDS = ("device", "torch", "native")

# Backend of the last texture call that succeeded ("device", "torch" or
# "native"); set only after the call has produced its result.
LAST_BACKEND: str = ""

# compressed-format index -> (module, wrapper, packer kind).  The wrapper
# is looked up at call time.  Every kind is the little-endian byte stream
# of the reference's pixel buffer (detex.h:879-930):
#   u32  : (N, 16) packed RGBA8 pixels
#   p8   : (N, 4) words of 4 R8 pixels
#   p8x2 : (N, 8) words of 2 RG8 pixels
#   p16  : (N, 8) words of 2 16-bit pixels
#   p16x2: (N, 16) words of one R | G << 16 pixel
#   p16x4: (N, 32) words, R | G << 16 then B | X << 16 per pixel
_DECODERS = {
    F.IDX_BC1: (bc, "decode_bc1", "u32"),
    F.IDX_BC1A: (bc, "decode_bc1a", "u32"),
    F.IDX_BC2: (bc, "decode_bc2", "u32"),
    F.IDX_BC3: (bc, "decode_bc3", "u32"),
    F.IDX_RGTC1: (rgtc, "decode_rgtc1", "p8"),
    F.IDX_SIGNED_RGTC1: (rgtc, "decode_signed_rgtc1", "p16"),
    F.IDX_RGTC2: (rgtc, "decode_rgtc2", "p8x2"),
    F.IDX_SIGNED_RGTC2: (rgtc, "decode_signed_rgtc2", "p16x2"),
    F.IDX_BPTC_FLOAT: (bptc_float, "decode_bptc_float", "p16x4"),
    F.IDX_BPTC_SIGNED_FLOAT: (bptc_float, "decode_bptc_signed_float",
                              "p16x4"),
    F.IDX_BPTC: (bptc, "decode_bptc", "u32"),
    F.IDX_ETC1: (etc, "decode_etc1", "u32"),
    F.IDX_ETC2: (etc, "decode_etc2", "u32"),
    F.IDX_ETC2_PUNCHTHROUGH: (etc, "decode_etc2_punchthrough", "u32"),
    F.IDX_ETC2_EAC: (etc, "decode_etc2_eac", "u32"),
    F.IDX_EAC_R11: (eac, "decode_eac_r11", "p16"),
    F.IDX_EAC_SIGNED_R11: (eac, "decode_eac_signed_r11", "p16"),
    F.IDX_EAC_RG11: (eac, "decode_eac_rg11", "p16x2"),
    F.IDX_EAC_SIGNED_RG11: (eac, "decode_eac_signed_rg11", "p16x2"),
}

def _decoder(tex_fmt: int):
    """The decode wrapper of a compressed format."""
    idx = F.compressed_index(tex_fmt)
    if idx not in _DECODERS:
        raise ValueError(f"not a compressed format: {tex_fmt:#x}")
    module, name, _ = _DECODERS[idx]
    return getattr(module, name)


def _words(blocks_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, block bytes) u8 blocks -> (N, block bytes / 4) int32
    little-endian words on `device`, the bytes copied once into a staged
    block viewed as those words (convert_device.staged, .upload)."""
    with trace.span("dtx.texture.words"):
        words = CD.staged(blocks_u8, (blocks_u8.shape[0],
                                      blocks_u8.shape[1] // 4),
                          torch.int32, device)
    with trace.span("dtx.texture.upload"):
        return CD.upload(words, device)


def decode_blocks_device(tex_fmt: int, words: torch.Tensor,
                         mode_mask=_FULL, flags=0):
    """Decode an (N, k) int32 word tensor on its device.  Returns the
    decoder's packed payload and (N,) bool valid, on that device."""
    return _decoder(tex_fmt)(words, mode_mask, flags)


def decode_blocks_sharded(tex_fmt: int, words: torch.Tensor, mesh,
                          mode_mask=_FULL, flags=0, axis: str = "dp"):
    """Scale-out decode (counterpart of detex_tpu/engine.py:139-163): each
    rank of `mesh` decodes its N / n rows of the (N, k) int32 `words` along
    `axis` with the local kernel (the plain version for a CPU tensor) and
    returns its shard of (pixels, valid).  Blocks are independent
    (texture.c:85-96), so no collective runs.  N not divisible by the
    axis size raises ValueError."""
    decode = _decoder(tex_fmt)
    n_shards = mesh_mod.axis_size(mesh, axis)
    if words.shape[0] % n_shards:
        raise ValueError(f"N={words.shape[0]} not divisible by mesh axis "
                         f"'{axis}' size {n_shards}")
    return decode(mesh_mod.shard_batch(words, mesh, axis), mode_mask, flags)


def decode_blocks(tex_fmt: int, blocks_u8: np.ndarray, mode_mask=_FULL,
                  flags=0, backend: str = "torch", device="cuda"):
    """Decode (N, block_bytes) u8 blocks to per-block pixel bytes
    ((N, 16 * pixel size) u8, on the host) and (N,) bool valid.  Invalid
    blocks are not zeroed here: callers zero them in the target format.

    backend "torch" and "device" decode on `device`; "native" runs
    the native runtime (which zero-fills invalid blocks itself)."""
    if backend == "native":
        from detex_tpu_torch import native
        return native.decode(F.BY_FORMAT[tex_fmt].name, blocks_u8,
                             int(mode_mask), int(flags))
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    pix, valid = decode_blocks_device(
        tex_fmt, _words(blocks_u8, _device(device)), mode_mask, flags)
    out = pix.cpu().numpy().view(np.uint8).reshape(pix.shape[0], -1)
    return out, valid.cpu().numpy()


def _device_tiles(tex_fmt: int, pixel_format: int, words: torch.Tensor,
                  mode_mask, flags) -> torch.Tensor:
    """Decode an (N, k) int32 word tensor, convert the pixels and zero
    invalid blocks on its device: (N, 16, lanes) in convert_device's lane
    representation of pixel_format."""
    src_fmt = F.texture_pixel_format(tex_fmt)
    pix, valid = _decoder(tex_fmt)(words, mode_mask, flags)
    n = pix.shape[0]
    # The payload is the reference's pixel buffer: its bytes viewed as
    # lanes are the decoded format's lane representation.
    typed = pix.view(CD.repr_dtype(src_fmt)).reshape(
        n * 16, CD.repr_lanes(src_fmt))
    conv = CD.convert_pixels_device(typed, src_fmt, pixel_format)
    return torch.where(valid[:, None, None], conv.reshape(n, 16, -1), 0)


def _assemble(tiles: torch.Tensor, wb: int, hb: int, width: int,
              height: int) -> torch.Tensor:
    """(hb * wb, 16, lanes) per-block pixels -> (height, width, lanes)
    row-major image on the same device, partial edge blocks cropped
    (texture.c:115-143)."""
    lanes = tiles.shape[2]
    img = tiles.reshape(hb, wb, 4, 4, lanes).permute(0, 2, 1, 3, 4) \
        .reshape(hb * 4, wb * 4, lanes)[:height, :width]
    return img.contiguous()


def _check_device_path(tex_fmt: int, pixel_format: int) -> None:
    if not F.is_compressed(tex_fmt):
        raise ValueError("device path requires a compressed texture")
    src_fmt = F.texture_pixel_format(tex_fmt)
    if C.match_conversion(src_fmt, pixel_format) is None:
        raise C.ConversionError(
            f"Unable to find conversion path {F.format_name(src_fmt)} -> "
            f"{F.format_name(pixel_format)}")


def _pipeline_body(tex_fmt: int, pixel_format: int, wb: int, hb: int,
                   width: int, height: int, tiled: bool, mode_mask,
                   flags):
    """The eager pipeline: a function of (wb * hb, k) int32 words on a
    device that decodes, converts and zeroes invalid blocks there, then
    assembles the (height, width, lanes) image (tiled=False) or keeps the
    (wb * hb, 16, lanes) tiles (tiled=True), in convert_device's lane
    representation of pixel_format."""
    def body(words: torch.Tensor) -> torch.Tensor:
        tiles = _device_tiles(tex_fmt, pixel_format, words, mode_mask, flags)
        return tiles if tiled else _assemble(tiles, wb, hb, width, height)
    return body


def _device_pipeline(tex_fmt: int, pixel_format: int, wb: int, hb: int,
                     width: int, height: int, tiled: bool = False):
    """The words-on-the-device pipeline (counterpart of
    detex_tpu/engine.py:278-394): a function of ((wb * hb, k) int32 words
    on a device, mode_mask, flags) that decodes, converts, zeroes invalid
    blocks and assembles there (_pipeline_body), returning the (height,
    width, lanes) image, or with tiled=True the (wb * hb, 16, lanes)
    tiles.  Nothing goes to or from the host, so a caller with words
    already on the card (a bench, a renderer) runs the texture path alone.

    On a card each call of a key (format, pixel format, the texture's
    shape, tiled, mode_mask, flags, the HDR parameters, the device) after
    its first is one replay of a CUDA graph (graphs.Program), the
    counterpart of JAX's jitted pipeline, captured at the key's second
    call after GRAPH_WARMUP eager runs; the first call runs the body
    eagerly.  The kernels take mode_mask and flags as launch arguments
    and the conversion reads the HDR parameters while it is captured, so
    a capture bakes them in and the key holds them.  The words are copied
    into the graph's buffer, and the result is the graph's output: the
    next call with the same key overwrites it, unless `read` (applied
    under graphs.run's lock) copies it out.  On the CPU the pipeline runs
    eagerly.  A format pair with no conversion path raises ConversionError
    here, before anything runs."""
    _check_device_path(tex_fmt, pixel_format)
    src_fmt = F.texture_pixel_format(tex_fmt)

    def pipeline(words: torch.Tensor, mode_mask=_FULL, flags=0, read=None):
        body = _pipeline_body(tex_fmt, pixel_format, wb, hb, width, height,
                              tiled, mode_mask, flags)
        if words.device.type != "cuda":
            out = body(words)
            return out if read is None else read(out)
        key = ("pipeline", tex_fmt, pixel_format, wb, hb, width, height,
               tiled, int(mode_mask) & _FULL, int(flags) & _FULL,
               CD.hdr_params_key(), words.device)
        return graphs.run(key, lambda: graphs.Program(
            body, keep=CD.tables(src_fmt, pixel_format, words.device)),
            words, read)
    return pipeline


def _texture_words(tex: Texture, device) -> torch.Tensor:
    return _words(tex.data.reshape(tex.n_blocks, tex.block_size),
                  _device(device))


def _texture_pipeline(tex: Texture, pixel_format: int, tiled: bool):
    return _device_pipeline(tex.format, pixel_format, tex.width_in_blocks,
                            tex.height_in_blocks, tex.width, tex.height,
                            tiled)


def _copy_out(out: torch.Tensor) -> torch.Tensor:
    """A result on the card copied into a tensor of the caller's (it may
    be a graph's output); a CPU result is fresh already."""
    return out.clone() if out.is_cuda else out


def decompress_texture_tiled_device(tex: Texture, pixel_format: int = None,
                                    mode_mask=_FULL, flags=0,
                                    device="cuda") -> torch.Tensor:
    """Per-block tiles decoded, converted and zeroed on `device` and left
    there (texture.c:77-98): (n_blocks, 16, lanes) in convert_device's lane
    representation of pixel_format.  Their bytes equal the host path's.
    The tensor is the caller's: later calls do not change it."""
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    return _texture_pipeline(tex, pixel_format, True)(
        _texture_words(tex, device), mode_mask, flags, _copy_out)


def decompress_texture_linear_device(tex: Texture, pixel_format: int = None,
                                     mode_mask=_FULL, flags=0,
                                     device="cuda") -> torch.Tensor:
    """The whole texture decoded, converted, zeroed and assembled
    row-major on `device` by _device_pipeline: (height, width, lanes).
    The tensor is the caller's: later calls do not change it."""
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    return _texture_pipeline(tex, pixel_format, False)(
        _texture_words(tex, device), mode_mask, flags, _copy_out)


def _tiles_host(tex: Texture, pixel_format: int, mode_mask, flags,
                backend: str, device) -> np.ndarray:
    """Decode on `device` (or natively), convert on the host, zero
    invalid blocks: (n_blocks, 16 * pixel size) uint8."""
    blocks = tex.data.reshape(tex.n_blocks, tex.block_size)
    native, valid = decode_blocks(tex.format, blocks, mode_mask, flags,
                                  backend, device)
    n = native.shape[0]
    converted = C.convert_pixels(native.ravel(), n * 16,
                                 F.texture_pixel_format(tex.format),
                                 pixel_format).reshape(n, -1)
    return np.where(valid[:, None], converted, 0).astype(np.uint8)


def decompress_texture_linear(tex: Texture, pixel_format: int = None,
                              mode_mask=_FULL, flags=0,
                              backend: str = "torch",
                              device="cuda") -> np.ndarray:
    """Decode a whole texture row-major (reference
    detexDecompressTextureLinear, texture.c:105-145).  Returns flat u8
    bytes of width * height pixels in `pixel_format` (default: the
    format's decoded pixel format), the caller's own: with backend
    "device" on a card, the numpy view of a pinned block from torch's
    caching host allocator (module docstring)."""
    global LAST_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    src_fmt = F.texture_pixel_format(tex.format)
    if pixel_format is None:
        pixel_format = src_fmt
    if not F.is_compressed(tex.format):
        n_px = tex.width * tex.height
        if backend == "device":
            out = CD.convert_pixels_torch(tex.data, n_px, src_fmt,
                                          pixel_format, _device(device))
        else:
            out = C.convert_pixels(tex.data, n_px, src_fmt, pixel_format)
    elif backend == "device":
        # The bytes are copied straight from the pipeline's output.
        out = _texture_pipeline(tex, pixel_format, False)(
            _texture_words(tex, device), mode_mask, flags, CD.to_bytes)
    else:
        tiles = _tiles_host(tex, pixel_format, mode_mask, flags, backend,
                            device)
        out = CD.to_bytes(_assemble(
            torch.from_numpy(tiles).reshape(tex.n_blocks, 16, -1),
            tex.width_in_blocks, tex.height_in_blocks, tex.width,
            tex.height))
    LAST_BACKEND = backend
    return out


def decompress_texture_tiled(tex: Texture, pixel_format: int = None,
                             mode_mask=_FULL, flags=0,
                             backend: str = "torch",
                             device="cuda") -> np.ndarray:
    """Decode into per-block tiles (reference detexDecompressTextureTiled,
    texture.c:77-98): blocks of 16 converted pixels, one after another."""
    global LAST_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if not F.is_compressed(tex.format):
        raise ValueError("Cannot handle uncompressed texture format")
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    if backend == "device":
        out = _texture_pipeline(tex, pixel_format, True)(
            _texture_words(tex, device), mode_mask, flags, CD.to_bytes)
    else:
        out = _tiles_host(tex, pixel_format, mode_mask, flags, backend,
                          device).ravel()
    LAST_BACKEND = backend
    return out

"""The texture engine's host copies (engine._words, convert_device.from_bytes,
.to_bytes): on the CPU the bytes are those of the pageable copies the
engine has always made, the staging layout a card uses (a block filled by
convert_device._fill) holds the same words, and nothing is counted as a
pinned copy.  Tests marked `cuda` hold the pinned path to the pageable one
on a card: the bytes, each call's array its own, the cache's reuse of a
freed block; they skip here.
"""

import gc

import numpy as np
import pytest
import torch

from detex_tpu_torch import convert as C
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch import engine
from detex_tpu_torch import formats as F
from detex_tpu_torch.ops.bitops import words_from_bytes
from detex_tpu_torch.texture import Texture
from detex_tpu_torch.utils import trace

# (format, width, height): 15 BC1 blocks are 120 bytes and 63 BPTC blocks
# 1,008, neither a power of two.
_TEXTURES = [(F.BC1, 20, 12), (F.BC1, 64, 64), (F.BPTC, 36, 28),
             (F.BPTC, 64, 32), (F.ETC2_EAC, 8, 4), (F.EAC_R11, 12, 12)]
_NP_DTYPES = {1: np.uint8, 2: np.int16, 4: np.int32}
# (pixel format, pixels): uint8, int16 and int32 lanes, odd counts.
_PIXELS = [(F.RGBA8, 37), (F.RGB8, 5), (F.R16, 1), (F.RG16, 333),
           (F.FLOAT_RGBA16, 64), (F.FLOAT_RGBA32, 7), (F.FLOAT_R32, 1000)]


@pytest.fixture(autouse=True)
def fresh():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _blocks(fmt, width, height, seed):
    n = ((width + 3) // 4) * ((height + 3) // 4)
    return np.random.default_rng(seed).integers(
        0, 256, (n, F.block_size_bytes(fmt)), np.uint8)


def _pixel_bytes(pixel_format, n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n * F.pixel_size(pixel_format), np.uint8)


def _todays_from_bytes(buf, n, fmt):
    return torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8).view(
        _NP_DTYPES[F.component_size(fmt)]).reshape(
            n, CD.repr_lanes(fmt)).copy())


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("fmt,width,height", _TEXTURES)
def test_cpu_words_are_words_from_bytes(fmt, width, height):
    blocks = _blocks(fmt, width, height, width * height)
    want = words_from_bytes(blocks)
    got = engine._words(blocks, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # A strided view of the blocks (every other block) as well.
    np.testing.assert_array_equal(
        engine._words(blocks[::2], torch.device("cpu")).numpy(),
        words_from_bytes(blocks[::2]))


@pytest.mark.parametrize("fmt,width,height", _TEXTURES)
def test_the_staging_layout_holds_words_from_bytes(fmt, width, height):
    """The card's staging block, filled as pinned() fills it, holds the
    words words_from_bytes makes, from contiguous and strided blocks."""
    blocks = _blocks(fmt, width, height, 3 * width + height)
    for src in (blocks, blocks[::-1], blocks[1::3]):
        host = torch.empty((src.shape[0], src.shape[1] // 4),
                           dtype=torch.int32)
        assert CD._fill(host, src) is host
        np.testing.assert_array_equal(host.numpy(), words_from_bytes(src))


@pytest.mark.parametrize("pixel_format,n", _PIXELS)
def test_cpu_from_bytes_is_todays_copy(pixel_format, n):
    buf = _pixel_bytes(pixel_format, n, n)
    got = CD.from_bytes(buf, n, pixel_format, device="cpu")
    want = _todays_from_bytes(buf, n, pixel_format)
    assert got.dtype == want.dtype == CD.repr_dtype(pixel_format)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not np.shares_memory(got.numpy(), buf)
    host = torch.empty(want.shape, dtype=want.dtype)
    torch.testing.assert_close(CD._fill(host, buf), want, rtol=0, atol=0)


@pytest.mark.parametrize("pixel_format,n", _PIXELS)
def test_cpu_to_bytes_is_the_tensors_bytes(pixel_format, n):
    t = _todays_from_bytes(_pixel_bytes(pixel_format, n, n + 1), n,
                           pixel_format)
    for src in (t, t.flip(0)):              # a strided tensor too
        got = CD.to_bytes(src)
        assert got.dtype == np.uint8 and got.ndim == 1
        np.testing.assert_array_equal(
            got, src.contiguous().numpy().view(np.uint8).ravel())
    np.testing.assert_array_equal(
        CD.to_bytes(CD.from_bytes(_pixel_bytes(pixel_format, n, 2), n,
                                  pixel_format, device="cpu")),
        _pixel_bytes(pixel_format, n, 2))


@pytest.mark.parametrize("fmt,width,height", _TEXTURES)
def test_cpu_copies_stage_nothing_pinned(fmt, width, height):
    blocks = _blocks(fmt, width, height, 11)
    tex = Texture.new(fmt, blocks.ravel(), width, height)
    trace.enable(True)
    want = engine.decompress_texture_linear(tex, backend="torch",
                                            device="cpu")
    got = engine.decompress_texture_linear(tex, backend="device",
                                           device="cpu")
    np.testing.assert_array_equal(got, want)
    px = CD.convert_pixels_torch(_pixel_bytes(F.RGBA8, 50, 1), 50, F.RGBA8,
                                 F.RGBA16, device="cpu")
    np.testing.assert_array_equal(px, C.convert_pixels(
        _pixel_bytes(F.RGBA8, 50, 1), 50, F.RGBA8, F.RGBA16))
    counts = trace.snapshot()["counts"]
    assert "dtx.pinned_copies" not in counts
    assert "dtx.pinned_bytes" not in counts
    # The torch and device calls upload words, the conversion its pixels.
    assert trace.snapshot()["spans"]["dtx.texture.upload"]["count"] == 3


def test_count_pinned_counts_only_while_recording():
    block = torch.empty((3, 5), dtype=torch.int16)
    trace.count_pinned(block)
    assert trace.snapshot()["counts"] == {}
    trace.enable(True)
    trace.count_pinned(block)
    trace.count_pinned(block)
    assert trace.snapshot()["counts"] == {"dtx.pinned_copies": 2,
                                          "dtx.pinned_bytes": 60}


def test_host_allocs_only_where_a_card_was_used():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only snapshot")
    assert "host_allocs" not in trace.snapshot()


# -- on a card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (pinned host memory and the CUDA "
                    "kernels have no CPU mode)")
    return torch.device("cuda")


def _bc7_rect(width, height, seed):
    blocks = _blocks(F.BPTC, width, height, seed)
    blocks[:, 0] |= 0x40                      # byte 0 set: a valid block
    blocks[::97, 0] = 0                       # and some invalid ones
    return Texture.new(F.BPTC, blocks.ravel(), width, height)


def _bc7(side, seed):
    return _bc7_rect(side, side, seed)


def _pageable(tex, pixel_format, device):
    """The image through the eager pipeline, words and image copied through
    pageable memory."""
    body = engine._pipeline_body(tex.format, pixel_format,
                                 tex.width_in_blocks, tex.height_in_blocks,
                                 tex.width, tex.height, False, 0xFFFFFFFF, 0)
    words = torch.from_numpy(words_from_bytes(
        tex.data.reshape(tex.n_blocks, tex.block_size))).to(device)
    return body(words).cpu().numpy().view(np.uint8).ravel()


def _call(tex, device, pixel_format=F.RGBA8):
    return engine.decompress_texture_linear(tex, pixel_format,
                                            backend="device", device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [1024, 4096])
def test_cuda_bc7_calls_match_the_pageable_path(cuda, side):
    tex = _bc7(side, side)
    want = _pageable(tex, F.RGBA8, cuda)
    for _ in range(3):                        # eager, captured, replayed
        np.testing.assert_array_equal(_call(tex, cuda), want)


@pytest.mark.cuda
def test_cuda_a_converted_pair_matches_the_pageable_path(cuda):
    tex = _bc7(256, 5)
    want = _pageable(tex, F.RGBA16, cuda)
    for _ in range(3):
        np.testing.assert_array_equal(_call(tex, cuda, F.RGBA16), want)
    n = 333 * 77
    src = _pixel_bytes(F.RGBA8, n, 6)
    host = C.convert_pixels(src, n, F.RGBA8, F.RGBA16)
    for _ in range(3):
        np.testing.assert_array_equal(
            CD.convert_pixels_torch(src, n, F.RGBA8, F.RGBA16, cuda), host)


@pytest.mark.cuda
def test_cuda_a_call_leaves_the_last_calls_array_alone(cuda):
    pool = [_bc7(1024, 20 + i) for i in range(2)]
    wants = [_pageable(tex, F.RGBA8, cuda) for tex in pool]
    outs = []
    for k in range(6):
        outs.append(_call(pool[k % 2], cuda))
        if k:
            assert not np.shares_memory(outs[k], outs[k - 1])
    for k, out in enumerate(outs):
        np.testing.assert_array_equal(out, wants[k % 2])


@pytest.mark.cuda
def test_cuda_a_call_after_an_output_was_freed_is_right(cuda):
    pool = [_bc7(1024, 30 + i) for i in range(2)]
    wants = [_pageable(tex, F.RGBA8, cuda) for tex in pool]
    for k in range(6):
        out = _call(pool[k % 2], cuda)
        np.testing.assert_array_equal(out, wants[k % 2])
        del out
        gc.collect()


@pytest.mark.cuda
def test_cuda_freed_outputs_reuse_cached_pinned_blocks(cuda):
    tex = _bc7(1024, 40)
    for _ in range(4):
        _call(tex, cuda)
    trace.enable(True)
    before = trace.snapshot()["host_allocs"]
    for _ in range(100):
        out = _call(tex, cuda)
        del out
    snap = trace.snapshot()
    assert snap["counts"]["dtx.pinned_copies"] == 200     # up and down
    assert snap["counts"]["dtx.pinned_bytes"] == 100 * (
        tex.n_blocks * 16 + 1024 * 1024 * 4)
    assert snap["host_allocs"] == before                  # hit share 1.0


@pytest.mark.cuda
def test_cuda_sizes_under_one_power_of_two_share_the_cached_blocks(cuda):
    """The cache rounds a block up to a power of two, so 4096 x (4096 - 4k)
    textures, each called once (an eager call of a new key, no capture),
    take the blocks a freed 4096^2 call left: no fresh allocation."""
    for _ in range(3):
        out = _call(_bc7(4096, 60), cuda)
        del out
    before = trace.snapshot()["host_allocs"]
    for k in (1, 2, 3):
        tex = _bc7_rect(4096, 4096 - 4 * k, 60 + k)
        np.testing.assert_array_equal(_call(tex, cuda),
                                      _pageable(tex, F.RGBA8, cuda))
    assert trace.snapshot()["host_allocs"] == before

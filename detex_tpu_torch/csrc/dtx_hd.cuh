// Qualifiers for per-block decode functions that both nvcc (the kernels)
// and g++ (the host builds the CPU tests load) compile from one source,
// the read-only tables those functions share, a byte lookup in an 8-byte
// palette (with_palette_byte3), the kernels' launch
// geometry (128 threads a CUDA block) and their stores: per thread, or
// staged through shared memory as a tile (TileOut, decode_tile).

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define DTX_HD __host__ __device__ __forceinline__
#define DTX_UNROLL _Pragma("unroll")
#else
#define DTX_HD inline
#define DTX_UNROLL
#endif

// A uint32 table, visible to the device pass as read-only global memory
// (a dynamic index into a local array would land in local memory, and
// __constant__ would serialise a warp's differing indices) and to the host
// pass as a plain array.
#if defined(__CUDACC__)
#define DTX_TABLE(name, ...)                                \
  __device__ const uint32_t name##_dev[] = {__VA_ARGS__};   \
  static const uint32_t name##_host[] = {__VA_ARGS__};
#else
#define DTX_TABLE(name, ...) \
  static const uint32_t name##_host[] = {__VA_ARGS__};
#endif

#if defined(__CUDA_ARCH__)
#define DTX_LOOKUP(name, i) __ldg(&name##_dev[i])
#else
#define DTX_LOOKUP(name, i) (name##_host[i])
#endif

namespace dtx {

// `word` with its byte 3 replaced by byte `code & 7` of the 8-byte palette
// lo | hi << 32: on the device two PRMTs (an 8-entry byte lookup, then the
// merge), on the host the same selection by shifts.
DTX_HD uint32_t with_palette_byte3(uint32_t word, uint32_t lo, uint32_t hi,
                                   uint32_t code) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(word, __byte_perm(lo, hi, code & 7u), 0x4210u);
#else
  const uint32_t half = (code & 4u) ? hi : lo;
  return (word & 0xFFFFFFu) | (((half >> (8 * (code & 3u))) & 0xFFu) << 24);
#endif
}

}  // namespace dtx

#if defined(__CUDACC__)
namespace dtx {

constexpr int kThreads = 128;

// CUDA blocks for n 4x4 blocks, `tile` of them per CUDA block.
inline unsigned int grid(long long n, int tile = kThreads) {
  return (unsigned int)((n + tile - 1) / tile);
}

// One thread's kWords output words as kWords / 4 16 B vector stores.
// Across a warp these lie kWords * 4 B apart, so a warp store instruction
// touches 32 separate 16 B pieces.  Used by the kernels that still write
// per thread: rgtc1_kernel, rgtc2_kernel (bc.cu) and eac_r11_kernel
// (etc_eac.cu).  Written this way, the 64 B-row kernels ran at 43-49% of
// their byte bound (bc1 52.8 us, eac_rg11 58.4, etc2_eac 52.4 at N =
// 1,048,576; CUDA events, NVIDIA H100 80GB HBM3, 700.00 W); through
// TileOut (decode_tile) bc1 takes 28.7 us and eac_rg11 34.2.  Of those
// still here, only signed rgtc2 writes 64 B rows (59% of its bound).
template <int kWords>
__device__ __forceinline__ void store_words(uint4* dst, const uint32_t* out) {
#pragma unroll
  for (int q = 0; q < kWords / 4; ++q) {
    dst[q] = make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                        out[4 * q + 3]);
  }
}

// The output of a tile of kRows consecutive 4x4 blocks, kWords words each,
// staged in shared memory so that it leaves in order: put() writes a
// block's words and valid flag to its row (any thread, any row), and after
// a __syncthreads() store() copies rows [0, rows) out with consecutive
// threads on consecutive 16 B chunks, so each warp store instruction
// writes 512 contiguous bytes, and the valid flags one byte per thread.
//
// Layout: rows of kChunks = kWords / 4 16 B chunks, unpadded; chunk c of
// row r sits at r * kChunks + (c ^ s(r)), s(r) = (r / (8 / kChunks)) %
// kChunks.  Shared memory serves a 16 B access in phases of 8 threads
// (128 B, every bank once); in put() 8 consecutive rows' chunk c, and in
// store() 8 consecutive chunks, then land in 8 distinct 16 B bank groups.
// (A 16 B pad per row does that for the writes but leaves the copy-out of
// 64 B rows 2-way conflicted.)
template <int kWords, int kRows>
struct TileOut {
  static constexpr int kChunks = kWords / 4;
  static_assert(kWords % 4 == 0 && kChunks <= 8 &&
                    (kChunks & (kChunks - 1)) == 0,
                "rows of 1, 2, 4 or 8 16 B chunks");
  uint4 chunk[kRows * kChunks];
  bool ok[kRows];

  static __device__ __forceinline__ int slot(int r, int c) {
    return r * kChunks + (c ^ ((r / (8 / kChunks)) & (kChunks - 1)));
  }

  __device__ __forceinline__ void put(int r, const uint32_t* out,
                                      bool valid) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      chunk[slot(r, c)] = make_uint4(out[4 * c], out[4 * c + 1],
                                     out[4 * c + 2], out[4 * c + 3]);
    }
    ok[r] = valid;
  }

  // dst: the tile's first row (kChunks uint4 per row); dst_valid: its
  // first flag.
  __device__ __forceinline__ void store(uint4* __restrict__ dst,
                                        bool* __restrict__ dst_valid,
                                        int rows) const {
    for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
      dst[i] = chunk[slot(i / kChunks, i % kChunks)];
    }
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      dst_valid[i] = ok[i];
    }
  }
};

// Orders a tile's rows by a small key, so that warps walking the order
// mostly see one key (a decoder's mode).  bin[r] is the key (< kBins) of
// row r * kThreads + threadIdx.x, or kBins for a slot past the tile's last
// row.  On return, after a __syncthreads(), order[j] for j below the row
// count is the j-th row in key order.  Each row's rank among the rows of
// its key comes from __match_any_sync and one shared-memory count per key
// and warp step; count (kBins + 1 words) then holds each key's start.
template <int kRounds, uint32_t kBins>
__device__ __forceinline__ void order_rows(const uint32_t (&bin)[kRounds],
                                           uint32_t* count,
                                           uint16_t* order) {
  const int t = threadIdx.x;
  const uint32_t lane = t & 31;
  if (t <= (int)kBins) count[t] = 0;
  __syncthreads();
  uint32_t rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, bin[r]);
    const int leader = __ffs((int)peers) - 1;
    uint32_t first = 0;
    if ((int)lane == leader) {
      first = atomicAdd(&count[bin[r]], (uint32_t)__popc(peers));
    }
    first = __shfl_sync(0xFFFFFFFFu, first, leader);
    rank[r] = first + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  if (t == 0) {  // counts -> starts
    uint32_t sum = 0;
    for (uint32_t b = 0; b <= kBins; ++b) {
      const uint32_t c = count[b];
      count[b] = sum;
      sum += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (bin[r] != kBins) {
      order[count[bin[r]] + rank[r]] = (uint16_t)(r * kThreads + t);
    }
  }
  __syncthreads();
}

// A CUDA block's share of a kernel whose 4x4 blocks decode on their own,
// kWords words each: the tile of kThreads * kRounds consecutive blocks
// from words[blockIdx.x * kTile], thread t taking tile rows t, t +
// kThreads, ...  decode(w, out) decodes the block whose words are w into
// out[kWords] and returns its valid flag.  The rows go through a TileOut
// and leave in order; a ragged last tile stores only its rows.  Launch
// with grid(n, kThreads * kRounds).
template <int kWords, int kRounds, class Word, class Decode>
__device__ __forceinline__ void decode_tile(const Word* __restrict__ words,
                                            long long n,
                                            uint4* __restrict__ pixels,
                                            bool* __restrict__ valid,
                                            Decode decode) {
  constexpr int kTile = kThreads * kRounds;
  __shared__ TileOut<kWords, kTile> s_out;
  const long long base = (long long)blockIdx.x * kTile;
  const int rows = n - base < kTile ? (int)(n - base) : kTile;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = r * kThreads + threadIdx.x;
    if (e < rows) {
      const Word w = words[base + e];  // one vector load
      uint32_t out[kWords];
      const bool ok = decode(w, out);
      s_out.put(e, out, ok);
    }
  }
  __syncthreads();
  s_out.store(pixels + base * (kWords / 4), valid + base, rows);
}

// decode_tile with the tile's blocks decoded in the order of key(w) <
// kBins (order_rows), so that a warp mostly decodes blocks of one key, a
// decoder's mode: the words are staged in shared memory first.
template <int kWords, int kRounds, uint32_t kBins, class Word, class Decode,
          class Key>
__device__ __forceinline__ void decode_tile(const Word* __restrict__ words,
                                            long long n,
                                            uint4* __restrict__ pixels,
                                            bool* __restrict__ valid,
                                            Decode decode, Key key) {
  constexpr int kTile = kThreads * kRounds;
  __shared__ Word s_words[kTile];
  __shared__ TileOut<kWords, kTile> s_out;
  __shared__ uint16_t s_order[kTile];
  __shared__ uint32_t s_count[kBins + 1];
  const long long base = (long long)blockIdx.x * kTile;
  const int rows = n - base < kTile ? (int)(n - base) : kTile;
  uint32_t bin[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = r * kThreads + threadIdx.x;
    bin[r] = kBins;
    if (e < rows) {
      const Word w = words[base + e];
      s_words[e] = w;
      bin[r] = key(w);
    }
  }
  order_rows<kRounds, kBins>(bin, s_count, s_order);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int j = r * kThreads + threadIdx.x;
    if (j >= rows) break;
    const int e = s_order[j];
    const Word w = s_words[e];
    uint32_t out[kWords];
    const bool ok = decode(w, out);
    s_out.put(e, out, ok);
  }
  __syncthreads();
  s_out.store(pixels + base * (kWords / 4), valid + base, rows);
}

}  // namespace dtx
#endif

// Tile-routed segment pack and unpack, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernels `pack_tiles` and `unpack_tiles` of
// src/repro/kernels/pack/pack.py. Both are gathers of whole 4 KiB tiles
// (32 x 128 bytes, the TPU's uint8 tile, kept as the unit of the packed
// layout):
//
//   pack:   out[t]    = src[seg_ids[t], tile_ids[t]]      src (n_seg, max_tiles, 4096)
//   unpack: out[s, k] = packed[gather_ids[s * max_tiles + k]]
//
// For unpack, padding entries point at a zero tile appended after the
// payload, so every output tile is written exactly once.
//
// Bound: bytes. Each output tile is read once and written once, 8 KiB per
// tile plus its 4- or 8-byte routing entry, against 3.35 TB/s of HBM on the
// H100 SXM. The design moves the bytes in the widest unit a thread has: one
// block of 256 threads per output tile, each thread one 16-byte load and one
// 16-byte store, so a warp moves 512 contiguous bytes per instruction and no
// byte is staged in shared memory. The block reads its own routing entry (a
// broadcast load; the TPU's scalar prefetch has no counterpart). A routing
// entry out of range traps, as PyTorch's own index kernels do, instead of
// reading past the source.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileBytes = 4096;
constexpr int kThreads = kTileBytes / 16;  // one uint4 per thread

__device__ __forceinline__ void copy_tile(const uint8_t* __restrict__ from,
                                          uint8_t* __restrict__ to) {
  reinterpret_cast<uint4*>(to)[threadIdx.x] =
      reinterpret_cast<const uint4*>(from)[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
pack_tiles_kernel(const uint8_t* __restrict__ src,
                  const int32_t* __restrict__ seg_ids,
                  const int32_t* __restrict__ tile_ids,
                  uint8_t* __restrict__ out, int32_t n_seg, int32_t max_tiles) {
  const int64_t t = blockIdx.x;
  const int32_t s = seg_ids[t];
  const int32_t k = tile_ids[t];
  if (s < 0 || s >= n_seg || k < 0 || k >= max_tiles) __trap();
  copy_tile(src + (static_cast<int64_t>(s) * max_tiles + k) * kTileBytes,
            out + t * kTileBytes);
}

__global__ void __launch_bounds__(kThreads)
unpack_tiles_kernel(const uint8_t* __restrict__ packed,
                    const int32_t* __restrict__ gather_ids,
                    uint8_t* __restrict__ out, int64_t n_packed) {
  const int64_t t = blockIdx.x;
  const int32_t g = gather_ids[t];
  if (g < 0 || g >= n_packed) __trap();
  copy_tile(packed + static_cast<int64_t>(g) * kTileBytes, out + t * kTileBytes);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after the launch.
extern "C" int pack_tiles(const void* src, const void* seg_ids,
                          const void* tile_ids, void* out, int64_t n_out,
                          int32_t n_seg, int32_t max_tiles, void* stream) {
  pack_tiles_kernel<<<static_cast<unsigned>(n_out), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int32_t*>(seg_ids),
      static_cast<const int32_t*>(tile_ids), static_cast<uint8_t*>(out), n_seg,
      max_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_tiles(const void* packed, const void* gather_ids,
                            void* out, int64_t n_total, int64_t n_packed,
                            void* stream) {
  unpack_tiles_kernel<<<static_cast<unsigned>(n_total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(gather_ids), static_cast<uint8_t*>(out),
      n_packed);
  return static_cast<int>(cudaGetLastError());
}

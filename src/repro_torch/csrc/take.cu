// Selection-vector row gather over a table of columns, and Arrow validity-
// bitmap expand, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernels `take_rows` and `bitmap_expand` of
// src/repro/kernels/take/take.py.
//
// take_columns: for each column c of a table of up to kMaxCols columns,
// out_c[i, :] = src_c[idx_c(indices[i]), :] on rows of row_bytes_c bytes of
// any dtype, under one selection vector. The index rule is the JAX
// reference's (`values[indices]` in jnp): a negative index wraps once
// (i + n_c), then the index is clamped to [0, n_c - 1]. It is applied in
// registers, with no pass over the indices and no host sync. One column is a
// table of one entry; the wrapper launches once per kMaxCols columns.
// Bound: bytes. The call must read the selected rows and the indices once and
// write the output rows: n_out * (sum_c 2 * row_bytes_c + 4) bytes against
// 3.35 TB/s. At the main path's sizes (17511 rows of 8-byte values) that is
// under a microsecond, so the time is the launch and the latency of a
// dependent chain: index, row, store. The design:
// - one launch per batch, not per column: the table of column pointers,
//   row counts and widths is a by-value __grid_constant__ parameter;
// - each output row's index is read from device memory once for all
//   columns: into a register when every row is one vector (thread i takes
//   row i), else into shared memory, where the threads that copy the
//   vectors of a wide row find it (a table of one column of wide rows reads
//   it straight into each such thread, one load per warp and row, with no
//   barrier);
// - a thread issues the loads of up to kGroup columns into registers before
//   it stores any of them: the 8 float64 columns of the main path are 8
//   independent loads in flight after one index load;
// - a row is copied in the widest vector (16, 8, 4, 2 or 1 bytes) that
//   divides it and both base addresses, chosen per column. A wide row's tile
//   in a 128-thread block holds 128 / (the widest row's vectors) rows, at
//   least one, so neighbouring threads copy neighbouring vectors of a row;
//   a narrow table puts 128 rows in a block: 17511 rows make 137 blocks for
//   132 SMs (256-row blocks left half of them idle);
// - the code a launch runs is kept short, since at this size a cold
//   instruction fetch costs as much as a row: a narrow table whose columns
//   share one width runs a kernel compiled for that width, and a table of
//   one column one compiled for one column (a first design, 16 columns
//   unrolled with a width switch each, made the one-column launch slower
//   than the per-column kernel it replaced; PERF.md, section 6).
// The TPU's padding of every row to 128 lanes is not carried over: on the
// card it would multiply a 1-D column's traffic by 128.
//
// bitmap_expand: LSB-first bits to bool bytes (0 or 1), out[8 * i + k] =
// (bitmap[i] >> k) & 1.
// Bound: bytes. n_bytes read, 8 * n_bytes written. The design gives each
// thread one input byte and builds its 8 output bytes in a 64-bit register
// with one multiply and masks, written as one 8-byte store, so the stores of
// a warp are 256 contiguous bytes. It needs none of the TPU kernel's
// padding to 1024-byte blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGatherThreads = 128;
constexpr int kMaxCols = 16;  // a TPC-H lineitem projection fits one launch
constexpr int kGroup = 8;     // columns whose loads a thread has in flight at once
constexpr int64_t kMaxBlocks = int64_t{1} << 20;
constexpr int kTableFields = 5;  // src, out, n_rows, row_bytes, vec_bytes

inline unsigned blocks_for(int64_t work, int threads) {
  const int64_t b = (work + threads - 1) / threads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

struct GatherColumn {
  const char* src;
  char* out;
  int64_t n_rows;
  int32_t units;  // vectors per row
  int32_t vec;    // bytes per vector: 16, 8, 4, 2 or 1
};

struct GatherTable {
  GatherColumn col[kMaxCols];
  const int32_t* indices;
  int64_t n_out;
  int64_t n_tiles;    // ceil(n_out / tile_rows)
  int32_t n_cols;
  int32_t tile_rows;  // output rows per tile
  int32_t max_units;  // the widest row's vectors
};

// The row an index selects from n >= 1 rows: wrap a negative once, clamp.
__device__ __forceinline__ int64_t source_row(int64_t r, int64_t n) {
  if (r < 0) r += n;
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__device__ __forceinline__ uint4 load_vec(const char* p, int vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  switch (vec) {
    case 16: v = *reinterpret_cast<const uint4*>(p); break;
    case 8: {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      v.x = t.x;
      v.y = t.y;
      break;
    }
    case 4: v.x = *reinterpret_cast<const uint32_t*>(p); break;
    case 2: v.x = *reinterpret_cast<const uint16_t*>(p); break;
    default: v.x = *reinterpret_cast<const uint8_t*>(p); break;
  }
  return v;
}

__device__ __forceinline__ void store_vec(char* p, int vec, uint4 v) {
  switch (vec) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.x); break;
    default: *reinterpret_cast<uint8_t*>(p) = static_cast<uint8_t>(v.x); break;
  }
}

// A table whose rows are all one vector: thread i takes output row i, holds
// its index in a register and copies that row of every column. kVec is the
// table's one vector width, or 0 for a width per column; kOne: one column.
template <int kVec, bool kOne>
__global__ void __launch_bounds__(kGatherThreads)
take_narrow_kernel(const __grid_constant__ GatherTable t) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // Loops are not unrolled: a launch covers its rows in one pass up to 2^27
  // rows, and an unrolled loop first divides to count its trips.
#pragma unroll 1
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < t.n_out; i += stride) {
    const int64_t idx = t.indices[i];
    if constexpr (kOne) {
      const GatherColumn& col = t.col[0];
      const int vec = kVec ? kVec : col.vec;
      store_vec(col.out + i * vec, vec,
                load_vec(col.src + source_row(idx, col.n_rows) * vec, vec));
    } else {
#pragma unroll 1
      for (int c0 = 0; c0 < t.n_cols; c0 += kGroup) {
        uint4 v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (c0 + g < t.n_cols) {
            const GatherColumn& col = t.col[c0 + g];
            const int vec = kVec ? kVec : col.vec;
            v[g] = load_vec(col.src + source_row(idx, col.n_rows) * vec, vec);
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (c0 + g < t.n_cols) {
            const GatherColumn& col = t.col[c0 + g];
            const int vec = kVec ? kVec : col.vec;
            store_vec(col.out + i * vec, vec, v[g]);
          }
        }
      }
    }
  }
}

// Any table: a tile of tile_rows output rows; vector e of a column's tile
// is row e / units, vector e % units. The tile's indices go to shared
// memory, but for one column (kOne), whose threads read each index once.
template <bool kOne>
__global__ void __launch_bounds__(kGatherThreads)
take_wide_kernel(const __grid_constant__ GatherTable t) {
  __shared__ int32_t s_idx[kOne ? 1 : kGatherThreads];
#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < t.n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * t.tile_rows;
    const int64_t left = t.n_out - row0;
    const int rows = static_cast<int>(left < t.tile_rows ? left : t.tile_rows);
    if constexpr (!kOne) {
      __syncthreads();  // the previous tile's readers of s_idx are done
      for (int k = threadIdx.x; k < rows; k += blockDim.x) s_idx[k] = t.indices[row0 + k];
      __syncthreads();
    }
    const int64_t tile_units = static_cast<int64_t>(rows) * t.max_units;
#pragma unroll 1
    for (int64_t base = 0; base < tile_units; base += blockDim.x) {
      const int64_t e = base + threadIdx.x;
      if constexpr (kOne) {
        const GatherColumn& col = t.col[0];
        if (e >= tile_units) break;
        const uint32_t ue = static_cast<uint32_t>(e);
        const uint32_t i = ue / static_cast<uint32_t>(col.units);
        const uint32_t j = ue - i * static_cast<uint32_t>(col.units);
        const int64_t r = source_row(t.indices[row0 + i], col.n_rows);
        store_vec(col.out + (row0 * col.units + e) * col.vec, col.vec,
                  load_vec(col.src + (r * col.units + j) * col.vec, col.vec));
      } else {
#pragma unroll 1
        for (int c0 = 0; c0 < t.n_cols; c0 += kGroup) {
          uint4 v[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (c0 + g >= t.n_cols) continue;
            const GatherColumn& col = t.col[c0 + g];
            if (e >= static_cast<int64_t>(rows) * col.units) continue;
            const uint32_t ue = static_cast<uint32_t>(e);
            const uint32_t i = col.units == 1 ? ue : ue / static_cast<uint32_t>(col.units);
            const uint32_t j = ue - i * static_cast<uint32_t>(col.units);
            const int64_t r = source_row(s_idx[i], col.n_rows);
            v[g] = load_vec(col.src + (r * col.units + j) * col.vec, col.vec);
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (c0 + g >= t.n_cols) continue;
            const GatherColumn& col = t.col[c0 + g];
            if (e < static_cast<int64_t>(rows) * col.units)
              store_vec(col.out + (row0 * col.units + e) * col.vec, col.vec, v[g]);
          }
        }
      }
    }
  }
}

template <int kVec>
void launch_narrow(const GatherTable& t, unsigned blocks, cudaStream_t s) {
  if (t.n_cols == 1)
    take_narrow_kernel<kVec, true><<<blocks, kGatherThreads, 0, s>>>(t);
  else
    take_narrow_kernel<kVec, false><<<blocks, kGatherThreads, 0, s>>>(t);
}

__global__ void __launch_bounds__(kThreads)
bitmap_expand_kernel(const uint8_t* __restrict__ bitmap,
                     uint64_t* __restrict__ out, int64_t n_bytes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_bytes; i += stride) {
    // Byte k of x holds the whole input byte, then only its bit k (in place).
    uint64_t x = static_cast<uint64_t>(bitmap[i]) * 0x0101010101010101ULL;
    x &= 0x8040201008040201ULL;
    // Each byte is 0 or 2^k <= 0x80: adding 0x7F sets its bit 7 iff it is
    // non-zero and never carries into the next byte.
    out[i] = ((x + 0x7F7F7F7F7F7F7F7FULL) >> 7) & 0x0101010101010101ULL;
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers, but for
// `table`; `stream` is a cudaStream_t. Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments it does not take.

// One launch over n_cols (1..kMaxCols) columns under `indices` (n_out int32).
// `table` is a host array of n_cols x 5 int64: for each column its source and
// output device pointers, its rows, its row bytes (below 2^31) and the vector
// bytes (16, 8, 4, 2 or 1) that divide the row and both pointers. A column
// of 0 rows is taken only with n_out == 0, and then nothing is launched.
extern "C" int take_columns(const int64_t* table, int32_t n_cols,
                            const void* indices, int64_t n_out, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherTable t = {};
  t.indices = static_cast<const int32_t*>(indices);
  t.n_out = n_out;
  t.n_cols = n_cols;
  t.max_units = 1;
  for (int c = 0; c < n_cols; ++c) {
    const int64_t* f = table + kTableFields * c;
    const int64_t row_bytes = f[3], vec = f[4];
    if ((vec != 16 && vec != 8 && vec != 4 && vec != 2 && vec != 1) ||
        row_bytes <= 0 || row_bytes >= (int64_t{1} << 31) || row_bytes % vec ||
        f[0] % vec || f[1] % vec || (f[2] < 1 && n_out))
      return static_cast<int>(cudaErrorInvalidValue);
    GatherColumn& col = t.col[c];
    col.src = reinterpret_cast<const char*>(f[0]);
    col.out = reinterpret_cast<char*>(f[1]);
    col.n_rows = f[2];
    col.units = static_cast<int32_t>(row_bytes / vec);
    col.vec = static_cast<int32_t>(vec);
    if (col.units > t.max_units) t.max_units = col.units;
  }
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  t.tile_rows = t.max_units < kGatherThreads ? kGatherThreads / t.max_units : 1;
  t.n_tiles = (n_out + t.tile_rows - 1) / t.tile_rows;
  const unsigned blocks = blocks_for(n_out, t.tile_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t.max_units > 1) {
    if (n_cols == 1)
      take_wide_kernel<true><<<blocks, kGatherThreads, 0, s>>>(t);
    else
      take_wide_kernel<false><<<blocks, kGatherThreads, 0, s>>>(t);
    return static_cast<int>(cudaGetLastError());
  }
  int vec = t.col[0].vec;  // the table's one vector width, or 0
  for (int c = 1; c < n_cols; ++c)
    if (t.col[c].vec != vec) vec = 0;
  switch (vec) {
    case 16: launch_narrow<16>(t, blocks, s); break;
    case 8: launch_narrow<8>(t, blocks, s); break;
    case 4: launch_narrow<4>(t, blocks, s); break;
    case 2: launch_narrow<2>(t, blocks, s); break;
    case 1: launch_narrow<1>(t, blocks, s); break;
    default: launch_narrow<0>(t, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitmap_expand(const void* bitmap, void* out, int64_t n_bytes,
                             void* stream) {
  bitmap_expand_kernel<<<blocks_for(n_bytes, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bitmap), static_cast<uint64_t*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Selection-vector row gather and Arrow validity-bitmap expand, CUDA C++ for
// sm_90a.
//
// Replaces the Pallas TPU kernels `take_rows` and `bitmap_expand` of
// src/repro/kernels/take/take.py.
//
// take_rows: out[i, :] = values[idx(indices[i]), :] on rows of `row_bytes`
// bytes of any dtype. The index rule is the JAX reference's (`values[indices]`
// in jnp): a negative index wraps once (i + n), then the index is clamped to
// [0, n - 1]. It is applied in registers, with no pass over the indices and
// no host sync.
// Bound: bytes. The call must read the selected rows and the indices and
// write the output rows: n_out * (2 * row_bytes + 4) bytes against 3.35 TB/s.
// The design copies each row in the widest vector (16, 8, 4, 2 or 1 bytes)
// that divides the row and the base addresses, one vector per thread over a
// flat index, so neighbouring threads touch neighbouring bytes of a row and
// a 1-D column of 8-byte values is one 8-byte load and store per row. The
// TPU's padding of every row to 128 lanes is not carried over: on the card it
// would multiply a 1-D column's traffic by 128.
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
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

inline unsigned blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const V* __restrict__ values, const int32_t* __restrict__ indices,
                 V* __restrict__ out, int64_t n_rows, int64_t n_out,
                 int64_t units) {
  const int64_t total = n_out * units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t i = e / units;
    const int64_t j = e - i * units;
    int64_t r = indices[i];
    if (r < 0) r += n_rows;
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    out[e] = values[r * units + j];
  }
}

template <typename V>
int launch_take(const void* values, const void* indices, void* out,
                int64_t n_rows, int64_t n_out, int64_t units,
                cudaStream_t stream) {
  take_rows_kernel<V><<<blocks_for(n_out * units), kThreads, 0, stream>>>(
      static_cast<const V*>(values), static_cast<const int32_t*>(indices),
      static_cast<V*>(out), n_rows, n_out, units);
  return static_cast<int>(cudaGetLastError());
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

// Plain C interface for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a vector width it does not take.
extern "C" int take_rows(const void* values, const void* indices, void* out,
                         int64_t n_rows, int64_t n_out, int64_t row_bytes,
                         int32_t vec_bytes, void* stream) {
  const int64_t units = row_bytes / vec_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_take<uint4>(values, indices, out, n_rows, n_out, units, s);
    case 8: return launch_take<uint2>(values, indices, out, n_rows, n_out, units, s);
    case 4: return launch_take<uint32_t>(values, indices, out, n_rows, n_out, units, s);
    case 2: return launch_take<uint16_t>(values, indices, out, n_rows, n_out, units, s);
    case 1: return launch_take<uint8_t>(values, indices, out, n_rows, n_out, units, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bitmap_expand(const void* bitmap, void* out, int64_t n_bytes,
                             void* stream) {
  bitmap_expand_kernel<<<blocks_for(n_bytes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bitmap), static_cast<uint64_t*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}

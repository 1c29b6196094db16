// Flash attention, forward, float32: CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/attention/attention.py (body `_flash_kernel`). It
// computes what that kernel and `attention_ref` compute,
//
//   o[bh] = softmax(q[bh] k[bh / group]^T / sqrt(hd), masked) v[bh / group]
//
// with q (BH, Sq, hd), k and v (BH / group, Sk, hd), all contiguous, and the
// TPU kernel's arithmetic: q scaled by 1/sqrt(hd) first, an online softmax
// over key tiles with float32 running max `m`, sum `l` and accumulator
// `acc`, masked scores NEG_INF = -1e30, output acc / max(l, 1e-37). The
// causal mask is top-left aligned: query i sees key j iff i >= j, both
// counted from 0, also when Sq != Sk. `group` query rows share one K/V row
// (GQA), so the K/V heads are never repeated in device memory.
//
// Unlike the TPU kernel, any Sq and Sk are taken: keys past Sk get a score
// of -inf and so a weight of exactly 0, and query rows past Sq are computed
// on zeros and not stored.
//
// Bound: operations. At granite-3-2b's prefill (BH = 4 x 32, S = 1024,
// hd = 64, causal, 8 KV heads) the function needs 2 x 2 x BH x hd x S(S+1)/2
// = 17.2 GFLOP, 0.26 ms at the H100 SXM's 67 TFLOP/s of float32 outside the
// tensor cores, against 84 MB of q, k, v and o, 0.025 ms at 3.35 TB/s. The
// model runs in float32, so the tensor cores (TF32 at best) are not used.
// The design keeps the scores out of device memory and feeds the float32
// FMA units from registers and shared memory:
//
// - one block of 128 threads per (bh, tile of query rows); a query row is
//   held by HD/32 neighbouring threads (one for hd <= 32), each owning 32 of
//   its dimensions of q and of acc in registers, interleaved in float4s so
//   that the threads of a row read neighbouring banks;
// - the loop over key tiles is inside the block: each tile of K and V is
//   staged in shared memory once, with 16-byte loads, and every row reads it
//   back as broadcast float4s; a row's partial dot products are summed with
//   warp shuffles;
// - a causal block stops at the key tile that holds its last query row, and
//   the blocks of the last query tiles, which have the most tiles, are
//   scheduled first.
//
// A simple kernel: no wgmma, TMA or double buffering; the plain PyTorch
// version beside it is src/repro_torch/kernels/attention/ref.py.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Tiling {
  static constexpr int kDims = HD < 32 ? HD : 32;       // dims of a row per thread
  static constexpr int kThreadsPerRow = HD / kDims;
  static constexpr int kChunks = kDims / 4;              // float4s per thread
  static constexpr int kBlockQ = kThreads / kThreadsPerRow;
  static constexpr int kBlockK = HD > 128 ? 16 : 32;     // K + V tile <= 32 KiB
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float4 axpy4(float p, float4 x, float4 y) {
  return make_float4(fmaf(p, x.x, y.x), fmaf(p, x.y, y.y), fmaf(p, x.z, y.z),
                     fmaf(p, x.w, y.w));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int64_t bh_count, int64_t sq, int64_t sk, int64_t group,
                     int64_t n_qtiles, int causal, float scale) {
  using T = Tiling<HD>;
  constexpr int TPR = T::kThreadsPerRow, CH = T::kChunks;
  constexpr int BQ = T::kBlockQ, BK = T::kBlockK;
  constexpr int kTileVec = BK * HD / 4;
  __shared__ __align__(16) float4 ks[kTileVec];
  __shared__ __align__(16) float4 vs[kTileVec];

  const int64_t bh = blockIdx.x % bh_count;
  const int64_t qt = n_qtiles - 1 - blockIdx.x / bh_count;  // longest first
  const int sub = threadIdx.x % TPR;
  const int64_t row = qt * BQ + threadIdx.x / TPR;          // query position
  const bool live = row < sq;

  const float4* qrow = reinterpret_cast<const float4*>(q + (bh * sq + (live ? row : 0)) * HD);
  const float4* kb = reinterpret_cast<const float4*>(k + (bh / group) * sk * HD);
  const float4* vb = reinterpret_cast<const float4*>(v + (bh / group) * sk * HD);

  float4 qr[CH], acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float4 x = live ? qrow[sub + TPR * c] : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  const int64_t k_end = causal ? min64(sk, (qt + 1) * BQ) : sk;
  for (int64_t k0 = 0; k0 < k_end; k0 += BK) {
    const int64_t valid = min64(BK, sk - k0) * (HD / 4);
    for (int i = threadIdx.x; i < kTileVec; i += kThreads) {
      const bool in = i < valid;
      ks[i] = in ? kb[k0 * (HD / 4) + i] : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[i] = in ? vb[k0 * (HD / 4) + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) part = dot4(qr[c], ks[j * (HD / 4) + sub + TPR * c], part);
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int64_t kpos = k0 + j;
      s[j] = kpos >= sk ? -INFINITY : (causal && kpos > row) ? kNegInf : part;
    }
    float m_blk = s[0];
#pragma unroll
    for (int j = 1; j < BK; ++j) m_blk = fmaxf(m_blk, s[j]);
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      acc[c] = make_float4(acc[c].x * corr, acc[c].y * corr, acc[c].z * corr,
                           acc[c].w * corr);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = axpy4(p, vs[j * (HD / 4) + sub + TPR * c], acc[c]);
    }
    l = l * corr + psum;
    m = m_new;
    __syncthreads();
  }

  if (live) {
    const float den = fmaxf(l, 1e-37f);
    float4* orow = reinterpret_cast<float4*>(o + (bh * sq + row) * HD);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      orow[sub + TPR * c] = make_float4(acc[c].x / den, acc[c].y / den,
                                        acc[c].z / den, acc[c].w / den);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int64_t bh,
           int64_t sq, int64_t sk, int64_t group, int causal, float scale,
           cudaStream_t stream) {
  constexpr int BQ = Tiling<HD>::kBlockQ;
  const int64_t n_qtiles = (sq + BQ - 1) / BQ;
  if (n_qtiles * bh > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd_f32_kernel<HD><<<static_cast<unsigned>(n_qtiles * bh), kThreads, 0, stream>>>(
      q, k, v, o, bh, sq, sk, group, n_qtiles, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (bh, sq, hd), k and v (bh / group, sk, hd), o (bh, sq, hd): contiguous
// float32 on the device, sq, sk >= 1. Returns cudaGetLastError() after the
// launch, or an error without launching for a head dim other than 16, 32,
// 64, 128 or 256 or a grid of more than 2^31 - 1 blocks.
int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                        int64_t bh, int64_t sq, int64_t sk, int64_t group,
                        int32_t hd, int32_t causal, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, bh, sq, sk, group, causal, scale, stream);
    case 32: return launch<32>(q, k, v, o, bh, sq, sk, group, causal, scale, stream);
    case 64: return launch<64>(q, k, v, o, bh, sq, sk, group, causal, scale, stream);
    case 128: return launch<128>(q, k, v, o, bh, sq, sk, group, causal, scale, stream);
    case 256: return launch<256>(q, k, v, o, bh, sq, sk, group, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

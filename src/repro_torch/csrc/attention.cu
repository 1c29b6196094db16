// Flash attention, forward, float32: CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/attention/attention.py (body `_flash_kernel`). It
// computes what that kernel and `attention_ref` compute,
//
//   o[bh] = softmax(q[bh] k[bh / group]^T / sqrt(hd), masked) v[bh / group]
//
// with q (BH, Sq, hd), k and v (BH / group, Sk, hd), all contiguous, and the
// TPU kernel's arithmetic: q scaled first (by 1/sqrt(hd), times log2(e) here,
// see below), an online softmax over key tiles with float32 running max `m`,
// sum `l` and accumulator `acc`, masked scores NEG_INF = -1e30, output
// acc / max(l, 1e-37). The causal mask is top-left aligned: query i sees
// key j iff i >= j, both counted from 0, also when Sq != Sk. `group` query
// rows share one K/V row (GQA), so the K/V heads are never repeated in
// device memory.
//
// Unlike the TPU kernel, any Sq and Sk are taken: keys past Sk get a score
// of -inf and so a weight of exactly 0, and query rows past Sq are computed
// on zeros and not stored.
//
// Bound: operations. At granite-3-2b's prefill (BH = 4 x 32, S = 1024,
// hd = 64, causal, 8 KV heads) the function needs 2 x 2 x BH x hd x S(S+1)/2
// = 17.2 GFLOP, 0.26 ms at the H100 SXM's 67 TFLOP/s of float32 outside the
// tensor cores, against 84 MB of q, k, v and o, 0.025 ms at 3.35 TB/s. The
// model runs in float32 and TF32 tensor cores keep about 3 decimal digits,
// so the float32 FMA units do the work; the design keeps them fed from
// registers, with as few shared-memory loads per FMA as the registers allow:
//
// - one block per (bh, 64 query rows), a (64 / R) x 16 grid of threads:
//   thread (ty, tx) owns the R query rows ty + (64 / R) i, the keys
//   tx + 16 j of each key tile and hd / 16 dims of the output. A warp holds
//   two row groups of 16 lanes; the 16 threads of a row are in one warp.
// - QK^T is a register-tiled micro-GEMM: per 4 dims of depth a thread reads
//   R q rows and BK / 16 k rows as float4s from shared memory and does
//   4 R BK / 16 FMAs (R = 8, BK = 64: 12 LDS.128 per 128 FMA). Q is staged
//   once per block, already scaled. Rows of the q, k and v tiles are padded
//   to hd + 4 floats, so that the 8 lanes of a quarter warp that read
//   different rows hit different banks.
// - one exponential per score: q is scaled by log2(e) / sqrt(hd), so the
//   scores are in log2 units and each weight is one exp2f (the function is
//   the same; the rounding differs by ~1e-7). Each thread exponentiates only
//   its own scores; the row max is reduced with 4 xor shuffles among the
//   row's 16 lanes, and the row sum is kept per thread and reduced once at
//   the end (the rescale factor is the same on all 16 lanes).
// - PV is a second micro-GEMM: p goes to shared memory transposed (a padded
//   (BK, 64 + 4) tile, a thread's R rows in R contiguous slots), and per key
//   a thread reads R p values and hd / 16 v values as float4s into an
//   R x hd / 16 accumulator held in registers (R = 8, hd 64: 3 LDS.128 per
//   32 FMA).
// - K and V tiles arrive through a 2-stage ring in dynamic shared memory by
//   16-byte cp.async.cg copies (rows past Sk zero-filled); the copy of tile
//   t + 1 is issued right after the barrier that opens tile t, so it flies
//   while tile t is computed. Two barriers per tile.
// - causal: a block stops at the key tile that holds its last query row,
//   masks only the tiles that cross its first row or Sk, and the blocks of
//   the last query tiles, which have the most tiles, are scheduled first.
//
// Tiles and occupancy. BQ = 64 query rows; BK = 64 keys for hd <= 64, 32
// for hd 128 and 256. R = 8 rows (128 threads) for hd <= 128, R = 4 (256
// threads) for hd 256, where 8 rows x 16 dims of accumulator do not fit the
// registers. Dynamic shared memory (q, 2 x (k, v), p^T): 43008 B at hd 16,
// 63488 B at hd 32, 104448 B at hd 64, 110080 B at hd 128, 208384 B at
// hd 256. This departs from a 4 x 4 tile in 256-thread blocks capped at 128
// registers: that design, this kernel's first version, ran slower at
// granite's shape (PERF.md, section 6), because it issues one LDS.128 per 8 FMA
// where this one issues one per 10.7. At hd 64 two 128-thread blocks share
// an SM (shared memory bounds it), 8 warps with 216 registers each.
//
// ptxas (-Xptxas -v, sm_90a), registers per thread and spills, as
// chip_smoke.py prints them: hd 16: 162, hd 32: 168, hd 64: 216, hd 128: 212,
// hd 256: 202; no spill stores or loads and no stack frame at any head dim.
// No tensor cores, TMA or wgmma.
//
// The plain PyTorch version beside it is src/repro_torch/kernels/attention/ref.py.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiling {
  static constexpr int kBlockQ = 64;
  static constexpr int kBlockK = HD >= 128 ? 32 : 64;
  static constexpr int kRows = HD >= 256 ? 4 : 8;  // query rows per thread
  static constexpr int kThreads = 16 * kBlockQ / kRows;
  static constexpr int kKeys = kBlockK / 16;       // keys per thread
  static constexpr int kDims = HD / 16;            // output dims per thread
  static constexpr int kLd = HD + 4;               // padded row of the q, k, v tiles
  static constexpr int kLdP = kBlockQ + 4;         // padded row of p^T
  static constexpr int kMinBlocks = HD <= 128 ? 2 : 1;
  static constexpr int kSmemBytes =
      (kBlockQ * kLd + 4 * kBlockK * kLd + kBlockK * kLdP) * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int HD>
__device__ __forceinline__ void load_dims(const float* row, int tx, float (&x)[Tiling<HD>::kDims]) {
  constexpr int D = Tiling<HD>::kDims;
  if constexpr (D >= 4) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 f = *reinterpret_cast<const float4*>(row + c * 64 + tx * 4);
      x[4 * c] = f.x;
      x[4 * c + 1] = f.y;
      x[4 * c + 2] = f.z;
      x[4 * c + 3] = f.w;
    }
  } else if constexpr (D == 2) {
    const float2 f = *reinterpret_cast<const float2*>(row + tx * 2);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = row[tx];
  }
}

template <int HD>
__device__ __forceinline__ void store_dims(float* row, int tx, const float (&x)[Tiling<HD>::kDims]) {
  constexpr int D = Tiling<HD>::kDims;
  if constexpr (D >= 4) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      *reinterpret_cast<float4*>(row + c * 64 + tx * 4) =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  } else if constexpr (D == 2) {
    *reinterpret_cast<float2*>(row + tx * 2) = make_float2(x[0], x[1]);
  } else {
    row[tx] = x[0];
  }
}

template <int HD>
__global__ void __launch_bounds__(Tiling<HD>::kThreads, Tiling<HD>::kMinBlocks)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int64_t bh_count, int64_t sq, int64_t sk, int64_t group,
                     int64_t n_qtiles, int causal, float scale) {
  using T = Tiling<HD>;
  constexpr int BQ = T::kBlockQ, BK = T::kBlockK, R = T::kRows, KPT = T::kKeys;
  constexpr int D = T::kDims, LD = T::kLd, LDP = T::kLdP, V4 = HD / 4;
  constexpr int kThreads = T::kThreads, RS = BQ / R;  // a thread's rows: ty + RS i
  static_assert(R % 4 == 0, "p is written and read as float4s over 4 rows");
  static_assert(BQ % R == 0 && BK % 16 == 0 && HD % 16 == 0, "a (BQ / R) x 16 thread grid");
  static_assert((BQ * V4) % kThreads == 0 && (BK * V4) % kThreads == 0, "whole copy rounds");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [BQ][LD], q scaled
  float* kv = qs + BQ * LD;          // stage s: k at kv + 2 s BK LD, v after it
  float* ps = kv + 4 * BK * LD;      // [BK][LDP], p transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t qt = n_qtiles - 1 - blockIdx.x / bh_count;  // longest first
  const int64_t q0 = qt * BQ;
  const float* kb = k + (bh / group) * sk * HD;
  const float* vb = v + (bh / group) * sk * HD;

  auto load_kv = [&](int64_t k0, int stage) {
    float* ks = kv + stage * 2 * BK * LD;
    float* vs = ks + BK * LD;
#pragma unroll
    for (int it = 0; it < BK * V4 / kThreads; ++it) {
      const int c = tid + it * kThreads, r = c / V4, col = (c % V4) * 4;
      const bool in = k0 + r < sk;
      const int64_t off = (in ? k0 + r : 0) * HD + col;
      cp_async16(ks + r * LD + col, kb + off, in);
      cp_async16(vs + r * LD + col, vb + off, in);
    }
    cp_async_commit();
  };

  const int64_t k_end = causal ? min64(sk, q0 + BQ) : sk;
  const int n_tiles = static_cast<int>((k_end + BK - 1) / BK);
  load_kv(0, 0);

  const float* qb = q + bh * sq * HD;
  const float qscale = scale * kLog2e;  // scores in log2 units: exp2 below
#pragma unroll
  for (int it = 0; it < BQ * V4 / kThreads; ++it) {
    const int c = tid + it * kThreads, r = c / V4, col = (c % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qb + (q0 + r) * HD + col);
    *reinterpret_cast<float4*>(qs + r * LD + col) =
        make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
  }

  float acc[R][D], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = static_cast<int64_t>(t) * BK;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every thread is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(k0 + BK, (t + 1) & 1);
    const float* ks = kv + (t & 1) * 2 * BK * LD;
    const float* vs = ks + BK * LD;

    float s[R][KPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[R], kr[KPT];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty + RS * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) kr[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = dot4(qv[i], kr[j], s[i][j]);
    }

    if (k0 + BK > sk || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int64_t kpos = k0 + tx + 16 * j, row = q0 + ty + RS * i;
          s[i][j] = kpos >= sk ? -INFINITY : (causal && kpos > row) ? kNegInf : s[i][j];
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int e = 0; e < D; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
#pragma unroll
      for (int i = 0; i < R; i += 4)
        *reinterpret_cast<float4*>(ps + (tx + 16 * j) * LDP + ty * R + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    __syncthreads();  // p of tile t is in shared memory

#pragma unroll 16
    for (int j = 0; j < BK; ++j) {
      float vr[D];
      load_dims<HD>(vs + j * LD, tx, vr);
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 p = *reinterpret_cast<const float4*>(ps + j * LDP + ty * R + i);
#pragma unroll
        for (int e = 0; e < D; ++e) {
          acc[i][e] = fmaf(p.x, vr[e], acc[i][e]);
          acc[i + 1][e] = fmaf(p.y, vr[e], acc[i + 1][e]);
          acc[i + 2][e] = fmaf(p.z, vr[e], acc[i + 2][e]);
          acc[i + 3][e] = fmaf(p.w, vr[e], acc[i + 3][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off /= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int64_t row = q0 + ty + RS * i;
    if (row < sq) {
      const float den = fmaxf(l[i], 1e-37f);
      float out[D];
#pragma unroll
      for (int e = 0; e < D; ++e) out[e] = acc[i][e] / den;
      store_dims<HD>(o + (bh * sq + row) * HD, tx, out);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int64_t bh,
           int64_t sq, int64_t sk, int64_t group, int causal, float scale,
           cudaStream_t stream) {
  using T = Tiling<HD>;
  const int64_t n_qtiles = (sq + T::kBlockQ - 1) / T::kBlockQ;
  if (n_qtiles * bh > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32_kernel<HD><<<static_cast<unsigned>(n_qtiles * bh), T::kThreads, T::kSmemBytes, stream>>>(
      q, k, v, o, bh, sq, sk, group, n_qtiles, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (bh, sq, hd), k and v (bh / group, sk, hd), o (bh, sq, hd): contiguous
// float32 on the device, 16-byte aligned, sq, sk >= 1. Returns
// cudaGetLastError() after the launch, or an error without launching for a
// head dim other than 16, 32, 64, 128 or 256 or a grid of more than
// 2^31 - 1 blocks.
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

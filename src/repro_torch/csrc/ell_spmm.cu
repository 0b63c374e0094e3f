// Degree-bucketed ELL SpMM for Hopper (sm_90a):
//   out[i, :] = sum_k w[i, k] * h[idx[i, k], :]        (one ELL bucket)
//
// Replaces the TPU kernel `_spmm_stream_kernel` of
// src/repro/kernels/ell_spmm.py (`ell_spmm`, stream=True): the HBM->VMEM
// double-buffered row gather of the reference package.
//
// What bounds it on an H100: memory. Each real nonzero moves one gathered row
// of h (D elements) plus one (idx, w) pair and does 2*D flops, under 0.5 flop
// per byte in f32, far below the card's ~20 flop/byte f32 ridge (67 TFLOP/s
// over 3.35 TB/s). The least time is the bytes of the h rows the real
// nonzeros reference, plus their idx and w, plus one output row per distinct
// real destination row (padding rows, whose output the caller drops, need
// none), over 3.35 TB/s.
//
// Design: one warp per (output row, column tile). The warp reads up to 32
// (idx, w) pairs of its row with one coalesced load each and broadcasts them
// with __shfl_sync, so idx and w are read once per (row, k). Each lane owns
// kVec contiguous columns per 32*kVec-wide chunk and reads them with one
// 16-byte load (4 x f32 or 8 x bf16): a warp moves 512 contiguous bytes of a
// gathered row per load instruction, and many warps per SM keep enough
// gathers in flight to cover the latency. Accumulation is in f32, in k order
// (k = 0..K-1), as on the TPU. The D tail is masked here (D is not padded to
// a tile multiple). Padding slots (w == 0, idx == 0) are not skipped:
// 0 * NaN must stay NaN, so a poisoned source row poisons the output exactly
// as the TPU body's multiply-add does. Indices are clamped to [0, M-1] so a
// bad index can never read outside h.
//
// Left for later work: skipping all-padding rows and the padding slots of
// wide buckets, and prefetching the next gathered rows (cp.async or TMA).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // output rows per block
constexpr int kChunks = 2;   // 16-byte vectors per lane per column tile

struct F32 {
  using raw = float;
  static constexpr int kVec = 4;
  __device__ static float load(raw x) { return x; }
  __device__ static raw store(float x) { return x; }
};

struct BF16 {
  using raw = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float load(raw x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static raw store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <typename T>
union Pack {
  uint4 u;
  typename T::raw e[T::kVec];
};

template <typename TW, typename TH, bool kVector>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(const int32_t* __restrict__ idx,
                const typename TW::raw* __restrict__ w,
                const typename TH::raw* __restrict__ h,
                typename TH::raw* __restrict__ out,
                int rows, int K, int M, int D) {
  constexpr int kVec = kVector ? TH::kVec : 1;
  constexpr int kTile = 32 * kVec * kChunks;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // uniform per warp: shuffles below stay full
  const int col0 = blockIdx.y * kTile;

  float acc[kChunks][kVec];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[c][v] = 0.f;

  const int32_t* idx_r = idx + static_cast<size_t>(row) * K;
  const typename TW::raw* w_r = w + static_cast<size_t>(row) * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    int my_j = 0;
    float my_w = 0.f;
    if (k0 + lane < K) {
      my_j = idx_r[k0 + lane];
      my_w = TW::load(w_r[k0 + lane]);
    }
    my_j = min(max(my_j, 0), M - 1);
    const int kn = min(32, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const int j = __shfl_sync(0xffffffffu, my_j, kk);
      const float wk = __shfl_sync(0xffffffffu, my_w, kk);
      const typename TH::raw* src = h + static_cast<size_t>(j) * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = col0 + (c * 32 + lane) * kVec;
        if (col < D) {   // kVector needs D % kVec == 0: a vector is all in
          if constexpr (kVector) {
            Pack<TH> p;
            p.u = *reinterpret_cast<const uint4*>(src + col);
#pragma unroll
            for (int v = 0; v < kVec; ++v)
              acc[c][v] = fmaf(wk, TH::load(p.e[v]), acc[c][v]);
          } else {
            acc[c][0] = fmaf(wk, TH::load(src[col]), acc[c][0]);
          }
        }
      }
    }
  }

  typename TH::raw* dst = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = col0 + (c * 32 + lane) * kVec;
    if (col < D) {
      if constexpr (kVector) {
        Pack<TH> p;
#pragma unroll
        for (int v = 0; v < kVec; ++v) p.e[v] = TH::store(acc[c][v]);
        *reinterpret_cast<uint4*>(dst + col) = p.u;
      } else {
        dst[col] = TH::store(acc[c][0]);
      }
    }
  }
}

template <typename TW, typename TH, bool kVector>
void launch(const void* idx, const void* w, const void* h, void* out,
            int rows, int K, int M, int D, cudaStream_t stream) {
  constexpr int kTile = 32 * (kVector ? TH::kVec : 1) * kChunks;
  const dim3 grid((rows + kWarps - 1) / kWarps, (D + kTile - 1) / kTile);
  ell_spmm_kernel<TW, TH, kVector><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const typename TW::raw*>(w),
      static_cast<const typename TH::raw*>(h),
      static_cast<typename TH::raw*>(out), rows, K, M, D);
}

template <typename TW, typename TH>
void dispatch_vector(int vector, const void* idx, const void* w,
                     const void* h, void* out, int rows, int K, int M, int D,
                     cudaStream_t stream) {
  if (vector)
    launch<TW, TH, true>(idx, w, h, out, rows, K, M, D, stream);
  else
    launch<TW, TH, false>(idx, w, h, out, rows, K, M, D, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). idx: (rows, K) int32; w: (rows, K)
// f32 or bf16; h: (M, D) f32 or bf16; out: (rows, D) in h's dtype. All
// row-major and contiguous. `vector` selects 16-byte loads and needs
// D % (16 / sizeof(h)) == 0 and 16-byte-aligned h and out. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_ell_spmm(const void* idx, const void* w, const void* h,
                              void* out, int rows, int K, int M, int D,
                              int w_bf16, int h_bf16, int vector,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16 && h_bf16)
    dispatch_vector<BF16, BF16>(vector, idx, w, h, out, rows, K, M, D, s);
  else if (w_bf16)
    dispatch_vector<BF16, F32>(vector, idx, w, h, out, rows, K, M, D, s);
  else if (h_bf16)
    dispatch_vector<F32, BF16>(vector, idx, w, h, out, rows, K, M, D, s);
  else
    dispatch_vector<F32, F32>(vector, idx, w, h, out, rows, K, M, D, s);
  return static_cast<int>(cudaGetLastError());
}

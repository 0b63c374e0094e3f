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
//
// Resident-source variant (`repro_ell_spmm_resident`) replaces the TPU kernel
// `_spmm_resident_kernel` of the same file (`ell_spmm`, stream=False), where
// the whole (M, block_d) source slab rides into VMEM as one block. Here one
// block per (256-row tile, bd-column tile) first stages the column slab
// h[:, c0:c0+bd] of all M source rows in dynamic shared memory (16-byte loads
// where D allows), then its warps gather rows out of shared memory, one
// output row per warp at a time, lanes across the tile's columns. The wrapper
// picks bd, the widest multiple of the 16-byte vector with M*bd elements in
// the card's opt-in shared memory per block, so only small sources fit
// (about 14.5k rows at one vector per row). The arithmetic is the streaming
// kernel's: f32 fmaf in k order from 0, padding slots multiplied through,
// indices clamped, so the two kernels agree bit for bit. Every row tile
// reloads the slab: this design sits far above its memory bound by
// construction, and it is kept for small sources and for comparison.
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

constexpr int kResWarps = 8;       // warps per resident block
constexpr int kResTileRows = 256;  // output rows per resident block

template <typename TW, typename TH, bool kVector>
__global__ void __launch_bounds__(kResWarps * 32)
ell_spmm_resident_kernel(const int32_t* __restrict__ idx,
                         const typename TW::raw* __restrict__ w,
                         const typename TH::raw* __restrict__ h,
                         typename TH::raw* __restrict__ out,
                         int rows, int K, int M, int D, int bd) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* slab = reinterpret_cast<typename TH::raw*>(smem);   // (M, bd)
  const int col0 = blockIdx.y * bd;
  const int width = min(bd, D - col0);

  // stage h[:, col0:col0+width] of every source row
  if constexpr (kVector) {   // D % kVec == 0 and bd % kVec == 0: whole vectors
    constexpr int kVec = TH::kVec;
    const int nvec = width / kVec;
    for (int t = threadIdx.x; t < M * nvec; t += blockDim.x) {
      const int r = t / nvec, c = (t - r * nvec) * kVec;
      *reinterpret_cast<uint4*>(slab + static_cast<size_t>(r) * bd + c) =
          *reinterpret_cast<const uint4*>(h + static_cast<size_t>(r) * D +
                                          col0 + c);
    }
  } else {
    for (int t = threadIdx.x; t < M * width; t += blockDim.x) {
      const int r = t / width, c = t - r * width;
      slab[static_cast<size_t>(r) * bd + c] =
          h[static_cast<size_t>(r) * D + col0 + c];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row_end = min(rows, (blockIdx.x + 1) * kResTileRows);
  for (int row = blockIdx.x * kResTileRows + (threadIdx.x >> 5);
       row < row_end; row += kResWarps) {   // uniform per warp
    const int32_t* idx_r = idx + static_cast<size_t>(row) * K;
    const typename TW::raw* w_r = w + static_cast<size_t>(row) * K;
    typename TH::raw* dst = out + static_cast<size_t>(row) * D + col0;
    for (int c0 = 0; c0 < width; c0 += 32) {
      const int col = c0 + lane;
      float acc = 0.f;
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
          if (col < width)
            acc = fmaf(wk, TH::load(slab[static_cast<size_t>(j) * bd + col]),
                       acc);
        }
      }
      if (col < width) dst[col] = TH::store(acc);
    }
  }
}

template <typename TW, typename TH, bool kVector>
cudaError_t launch_resident(const void* idx, const void* w, const void* h,
                            void* out, int rows, int K, int M, int D, int bd,
                            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * bd * sizeof(typename TH::raw);
  auto kernel = ell_spmm_resident_kernel<TW, TH, kVector>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + kResTileRows - 1) / kResTileRows,
                  (D + bd - 1) / bd);
  kernel<<<grid, kResWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const typename TW::raw*>(w),
      static_cast<const typename TH::raw*>(h),
      static_cast<typename TH::raw*>(out), rows, K, M, D, bd);
  return cudaGetLastError();
}

template <typename TW, typename TH>
cudaError_t dispatch_resident(int vector, const void* idx, const void* w,
                              const void* h, void* out, int rows, int K,
                              int M, int D, int bd, cudaStream_t stream) {
  if (vector)
    return launch_resident<TW, TH, true>(idx, w, h, out, rows, K, M, D, bd,
                                         stream);
  return launch_resident<TW, TH, false>(idx, w, h, out, rows, K, M, D, bd,
                                        stream);
}

}  // namespace

// The card's opt-in shared memory per block, in bytes, for `device`
// (232,448 on an H100). Returns the CUDA error code (0 on success).
extern "C" int repro_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Resident-source entry point: the arguments of `repro_ell_spmm`, plus `bd`,
// the column-tile width, a multiple of the 16-byte vector with
// M * bd * sizeof(h) within the opt-in shared memory per block. `vector`
// selects 16-byte staging loads (D % (16 / sizeof(h)) == 0, h 16-byte
// aligned). Returns the first CUDA error (0 on success).
extern "C" int repro_ell_spmm_resident(const void* idx, const void* w,
                                       const void* h, void* out, int rows,
                                       int K, int M, int D, int bd,
                                       int w_bf16, int h_bf16, int vector,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w_bf16 && h_bf16)
    e = dispatch_resident<BF16, BF16>(vector, idx, w, h, out, rows, K, M, D,
                                      bd, s);
  else if (w_bf16)
    e = dispatch_resident<BF16, F32>(vector, idx, w, h, out, rows, K, M, D,
                                     bd, s);
  else if (h_bf16)
    e = dispatch_resident<F32, BF16>(vector, idx, w, h, out, rows, K, M, D,
                                     bd, s);
  else
    e = dispatch_resident<F32, F32>(vector, idx, w, h, out, rows, K, M, D,
                                    bd, s);
  return static_cast<int>(e);
}

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

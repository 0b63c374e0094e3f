// Fused LMC halo compensation for Hopper (sm_90a), paper Eq. 9/12:
//   out[i, :] = mask[i] * ((1 - beta[i]) * TF(store[clamp(gid[i]), :])
//                          + beta[i] * fresh[i, :])
//
// Replaces the TPU kernel `_comp_stream_kernel` of
// src/repro/kernels/compensate.py (`lmc_compensate_kernel`, stream=True): the
// HBM->VMEM double-buffered store-row gather fused with the lerp and mask.
//
// What bounds it on an H100: memory. Per output row it reads one gathered
// store row, one fresh row and three scalars, writes one row, and does 5
// flops per element: about 0.4 flop per byte in f32, far below the card's
// ~20 flop/byte f32 ridge. The least time is the bytes of the distinct store
// rows gathered, plus fresh, gids, beta and mask, plus the output, over
// 3.35 TB/s.
//
// Design: one warp per output row, lanes across D, four contiguous elements
// per lane per load (16 bytes of f32, 8 of bf16), so the gathered store row
// and the fresh row stream in fully coalesced; the historical row never
// makes a second trip through device memory. The store row is cast to
// fresh's dtype before the arithmetic, and the expression keeps the TPU
// body's order, mask * ((1 - b) * hist + b * fresh), with explicitly rounded
// f32 operations (no fused multiply-add), so on f32 inputs the result is
// bit-identical to the plain PyTorch version. Rows with mask == 0 are
// computed like any other (0 * NaN stays NaN, as on the TPU), and gid is
// clamped to [0, M-1], the clip semantics of gather_rows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // output rows per block
constexpr int kVec = 4;     // elements per lane per load

struct F32 {
  using raw = float;
  __device__ static float load(raw x) { return x; }
  __device__ static raw store(float x) { return x; }
  // round through this dtype (identity for f32)
  __device__ static float round(float x) { return x; }
};

struct BF16 {
  using raw = unsigned short;
  __device__ static float load(raw x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static raw store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static float round(float x) { return load(store(x)); }
};

template <typename T>
__device__ __forceinline__ void load4(const typename T::raw* p, float* x) {
  if constexpr (sizeof(typename T::raw) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    union { uint2 u; typename T::raw e[4]; } v;
    v.u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = T::load(v.e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store4(typename T::raw* p, const float* x) {
  if constexpr (sizeof(typename T::raw) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    union { uint2 u; typename T::raw e[4]; } v;
#pragma unroll
    for (int i = 0; i < 4; ++i) v.e[i] = T::store(x[i]);
    *reinterpret_cast<uint2*>(p) = v.u;
  }
}

// mask * ((1 - b) * hist + b * fresh), each step rounded to f32
__device__ __forceinline__ float lerp_mask(float m, float b, float hist,
                                           float fresh) {
  const float a = __fmul_rn(__fsub_rn(1.f, b), hist);
  return __fmul_rn(m, __fadd_rn(a, __fmul_rn(b, fresh)));
}

template <typename TS, typename TF, bool kVector>
__global__ void __launch_bounds__(kWarps * 32)
compensate_kernel(const typename TS::raw* __restrict__ store,
                  const int32_t* __restrict__ gids,
                  const float* __restrict__ beta,
                  const typename TF::raw* __restrict__ fresh,
                  const float* __restrict__ mask,
                  typename TF::raw* __restrict__ out, int N, int M, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const int g = min(max(gids[row], 0), M - 1);
  // beta and mask are cast to fresh's dtype, as the TPU wrapper does
  const float b = TF::round(beta[row]);
  const float m = TF::round(mask[row]);
  const typename TS::raw* s = store + static_cast<size_t>(g) * D;
  const typename TF::raw* f = fresh + static_cast<size_t>(row) * D;
  typename TF::raw* o = out + static_cast<size_t>(row) * D;
  if constexpr (kVector) {   // D % 4 == 0, rows aligned for the vector width
    for (int col = lane * kVec; col < D; col += 32 * kVec) {
      float hs[kVec], fs[kVec], os[kVec];
      load4<TS>(s + col, hs);
      load4<TF>(f + col, fs);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        os[v] = lerp_mask(m, b, TF::round(hs[v]), fs[v]);
      store4<TF>(o + col, os);
    }
  } else {
    for (int col = lane; col < D; col += 32)
      o[col] = TF::store(lerp_mask(m, b, TF::round(TS::load(s[col])),
                                   TF::load(f[col])));
  }
}

template <typename TS, typename TF>
void launch(int vector, const void* store, const void* gids, const void* beta,
            const void* fresh, const void* mask, void* out, int N, int M,
            int D, cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  const auto* s = static_cast<const typename TS::raw*>(store);
  const auto* g = static_cast<const int32_t*>(gids);
  const auto* b = static_cast<const float*>(beta);
  const auto* f = static_cast<const typename TF::raw*>(fresh);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<typename TF::raw*>(out);
  if (vector)
    compensate_kernel<TS, TF, true><<<grid, kWarps * 32, 0, stream>>>(
        s, g, b, f, m, o, N, M, D);
  else
    compensate_kernel<TS, TF, false><<<grid, kWarps * 32, 0, stream>>>(
        s, g, b, f, m, o, N, M, D);
}

}  // namespace

// Plain C entry point (loaded with ctypes). store: (M, D) f32 or bf16;
// gids: (N,) int32; beta, mask: (N,) f32; fresh: (N, D) f32 or bf16;
// out: (N, D) in fresh's dtype. All row-major and contiguous. `vector`
// selects 4-element loads and needs D % 4 == 0 and store/fresh/out aligned
// to 4 elements. Launches on `stream`; returns cudaGetLastError().
extern "C" int repro_lmc_compensate(const void* store, const void* gids,
                                    const void* beta, const void* fresh,
                                    const void* mask, void* out, int N, int M,
                                    int D, int store_bf16, int fresh_bf16,
                                    int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_bf16 && fresh_bf16)
    launch<BF16, BF16>(vector, store, gids, beta, fresh, mask, out, N, M, D, s);
  else if (store_bf16)
    launch<BF16, F32>(vector, store, gids, beta, fresh, mask, out, N, M, D, s);
  else if (fresh_bf16)
    launch<F32, BF16>(vector, store, gids, beta, fresh, mask, out, N, M, D, s);
  else
    launch<F32, F32>(vector, store, gids, beta, fresh, mask, out, N, M, D, s);
  return static_cast<int>(cudaGetLastError());
}

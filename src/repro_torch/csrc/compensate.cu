// Fused LMC halo compensation for Hopper (sm_90a), paper Eq. 9/12:
//   out[i, :] = mask[i] * ((1 - beta[i]) * TF(store[clamp(gid[i]), :])
//                          + beta[i] * fresh[i, :])
//
// Arithmetic of both kernels: the store row is cast to fresh's dtype before
// the arithmetic, and the expression keeps the TPU body's order,
// mask * ((1 - b) * hist + b * fresh), with explicitly rounded f32
// operations (no fused multiply-add), so on f32 inputs the result is
// bit-identical to the plain PyTorch version, and the two kernels are
// bit-identical to each other for every dtype. Rows with mask == 0 are
// computed like any other (0 * NaN stays NaN, as on the TPU), and gid is
// clamped to [0, M-1], the clip semantics of gather_rows.
//
// What bounds both on an H100: memory. Per output row they read one gathered
// store row, one fresh row and three scalars, write one row, and do 5 flops
// per element: about 0.4 flop per byte in f32, far below the card's ~20
// flop/byte f32 ridge. The least time is the bytes of the distinct store
// rows gathered, plus fresh, gids, beta and mask, plus the output, over
// 3.35 TB/s. At the small shapes of the main paths (a few thousand rows)
// that is 2-3 us, so latency decides: the launch, and how many dependent
// round trips to memory a warp makes before its last store.
//
// Streaming kernel (`repro_lmc_compensate`) replaces the TPU kernel
// `_comp_stream_kernel` of src/repro/kernels/compensate.py
// (`lmc_compensate_kernel`, stream=True): the HBM->VMEM double-buffered
// store-row gather fused with the lerp and mask. One warp per row, lanes
// across D, 4 contiguous elements each per vector (16 bytes of f32, 8 of
// bf16), kNV vectors per row (kNV = ceil(D/128) in {1, 2, 4}, fixed at
// compile time, the tail masked; past 512 columns the warp loops over
// 512-column passes). Every load of a pass is issued before its first
// arithmetic: the row's gid, beta and mask, the fresh vectors (they need no
// gid), then the gathered store vectors, so a warp pays one gid round trip
// and one gather round trip, not one per vector. Store rows are gathered
// through the read-only path (__ldg); fresh and the output take plain loads
// and stores. Tried on an H100 and dropped (PERF.md): evict-first and
// no-allocate cache hints, slower at the full-width training shapes (their
// padding rows all gather row 0, which L1 then serves), and 2 or 4 rows per
// warp with their scalars loaded once and shuffled, no faster at either
// shape. What is left at the serving shapes is the launch and the two round
// trips (chip_smoke.py times an 8-row launch beside the 3648-row one).
//
// Resident-store kernel (`repro_lmc_compensate_resident`) replaces the TPU
// kernel `_comp_resident_kernel` of the same file (stream=False), where the
// whole (M, block_d) store block rides into VMEM and every gathered row is
// read from there. Here, too, every store value comes from an (M, bd) slab
// of the store in shared memory; what the design does about the cost of
// that slab:
// - persistent layout: blocks of 32 warps (the whole SM) in a grid of
//   C = ceil(D/bd) column tiles by P contiguous row shares, so each block
//   stages its slab exactly once. P is at most SMs / C (about one block
//   per SM) and at most what leaves each block two passes of its lane
//   groups: every share stages the column tile again from L2, and at
//   arxiv-cpu (C = 22) P = 6 (132 blocks, 26 MB staged) is slower than
//   P = 3 (66 blocks, 2.4 passes each; chip_smoke.py times every P);
// - staging with every copy in flight: cp.async.cg of 16 bytes, one wait.
//   cp.async, not a TMA load: a slab row is bd/4 vectors (48 bytes at
//   bd = 12) on a 1 KB stride, which a 2D TMA box would cover in many
//   boxes of a tensor map built on the host through the driver API; cp.async
//   needs neither and keeps this a plain-C library. Before the wait each
//   lane issues the loads of its first row (gid, beta, mask, fresh), and
//   every row after that is loaded one row ahead of its arithmetic;
// - every lane computes: a warp splits into lane groups of bd/kU lanes (kU =
//   one 16-byte slab vector: 4 f32 or 8 bf16 elements), one row per group
//   (3 lanes at bd = 12: 10 rows per warp pass), 16-byte slab reads and
//   fresh/output vectors; the ragged last column tile (4 columns at
//   arxiv-cpu) takes 1-lane groups, 32 rows per warp.
// Where D is not a multiple of the vector (or the store is unaligned), both
// kernels fall back to element-wise loads within the same layouts.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // warps per streaming block
constexpr int kVec = 4;        // elements per lane per streaming vector
constexpr int kResWarps = 32;  // warps per resident block (one per SM)

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

// Everything one launch needs.
struct Args {
  const void* store;
  const int32_t* gids;
  const float* beta;
  const void* fresh;
  const float* mask;
  void* out;
  int N, M, D;
  int bd;    // resident: column-tile width
  int rows;  // resident: rows per block (one contiguous share)
};

// ------------------------------------------------------------ memory ops
template <int kBytes> struct Bits;   // an integer (vector) of kBytes bytes
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<4> { using type = unsigned; };
template <> struct Bits<2> { using type = unsigned short; };

enum Hint { kGather, kPlain };

// the gathered store rows through the read-only path, the rest plain (see
// the note above)
template <Hint H, typename B>
__device__ __forceinline__ B ld(const B* p) {
  if constexpr (H == kGather) return __ldg(p);
  else return *p;
}

// kE contiguous elements of T, moved as pieces of at most 16 bytes and kept
// raw until the arithmetic, so that every load of a pass is in flight first
template <typename T, int kE>
struct Elems {
  using R = typename T::raw;
  static constexpr int kBytes = kE * static_cast<int>(sizeof(R));
  static constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  static constexpr int kN = kBytes / kPiece;
  using B = typename Bits<kPiece>::type;
  union {
    B b[kN];
    R e[kE];
  };

  template <Hint H>
  __device__ __forceinline__ void load(const R* p) {
#pragma unroll
    for (int i = 0; i < kN; ++i) b[i] = ld<H>(reinterpret_cast<const B*>(p) + i);
  }
  __device__ __forceinline__ void store(R* p) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) reinterpret_cast<B*>(p)[i] = b[i];
  }
  __device__ __forceinline__ float get(int v) const { return T::load(e[v]); }
  __device__ __forceinline__ void set(int v, float x) { e[v] = T::store(x); }
};

// mask * ((1 - b) * hist + b * fresh), each step rounded to f32
__device__ __forceinline__ float lerp_mask(float m, float b, float hist,
                                           float fresh) {
  const float a = __fmul_rn(__fsub_rn(1.f, b), hist);
  return __fmul_rn(m, __fadd_rn(a, __fmul_rn(b, fresh)));
}

// out = lerp_mask over kE elements, the store value cast to fresh's dtype
template <typename TS, typename TF, int kE>
__device__ __forceinline__ void combine(const Elems<TS, kE>& s,
                                        const Elems<TF, kE>& f, float m,
                                        float b, typename TF::raw* dst) {
  Elems<TF, kE> o;
#pragma unroll
  for (int v = 0; v < kE; ++v)
    o.set(v, lerp_mask(m, b, TF::round(s.get(v)), f.get(v)));
  o.store(dst);
}

// ------------------------------------------------------------- streaming
template <typename TS, typename TF, bool kVector, int kNV>
__global__ void __launch_bounds__(kWarps * 32)
compensate_kernel(Args a) {
  using RS = typename TS::raw;
  using RF = typename TF::raw;
  constexpr int kE = kVector ? kVec : 1;   // elements per lane per vector
  constexpr int kPass = 32 * kE * kNV;     // columns per pass of the warp
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.N) return;
  const int M = a.M, D = a.D;
  const int gid = a.gids[row];
  // beta and mask are cast to fresh's dtype, as the TPU wrapper does
  const float b = TF::round(a.beta[row]);
  const float m = TF::round(a.mask[row]);
  const RF* f_row = static_cast<const RF*>(a.fresh) + static_cast<size_t>(row) * D;
  RF* o_row = static_cast<RF*>(a.out) + static_cast<size_t>(row) * D;
  for (int c0 = 0; c0 < D; c0 += kPass) {  // one pass where D <= kPass
    Elems<TF, kE> f[kNV];
    Elems<TS, kE> s[kNV];
#pragma unroll
    for (int v = 0; v < kNV; ++v) {        // fresh first: it needs no gid
      const int col = c0 + (v * 32 + lane) * kE;
      if (col < D) f[v].template load<kPlain>(f_row + col);
    }
    const RS* s_row = static_cast<const RS*>(a.store) +
                      static_cast<size_t>(min(max(gid, 0), M - 1)) * D;
#pragma unroll
    for (int v = 0; v < kNV; ++v) {        // then every gathered vector
      const int col = c0 + (v * 32 + lane) * kE;
      if (col < D) s[v].template load<kGather>(s_row + col);
    }
#pragma unroll
    for (int v = 0; v < kNV; ++v) {
      const int col = c0 + (v * 32 + lane) * kE;
      if (col < D) combine<TS, TF, kE>(s[v], f[v], m, b, o_row + col);
    }
  }
}

// -------------------------------------------------------------- resident
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <typename TS, typename TF, bool kVector>
__global__ void __launch_bounds__(kResWarps * 32, 1)
compensate_resident_kernel(Args a) {
  using RS = typename TS::raw;
  using RF = typename TF::raw;
  // a unit is one 16-byte vector of the slab (element-wise without vectors)
  constexpr int kU = kVector ? 16 / static_cast<int>(sizeof(RS)) : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  RS* slab = reinterpret_cast<RS*>(smem);   // (M, bd)
  const int M = a.M, D = a.D, bd = a.bd;
  const RS* store = static_cast<const RS*>(a.store);
  const RF* fresh = static_cast<const RF*>(a.fresh);
  RF* out = static_cast<RF*>(a.out);
  const int col0 = blockIdx.y * bd;
  const int width = min(bd, D - col0);
  const int r0 = blockIdx.x * a.rows;
  const int nrows = min(a.N - r0, a.rows);

  // A row's slab segment is `units` units. A warp is R groups of G lanes,
  // one row per group and one unit per lane (rows of more than 32 units
  // take several items). Item k of the block is row r0 + k / nuc, units
  // from (k % nuc) * G; lane group j of warp w takes items j + R * w,
  // then every kResWarps * R-th.
  const int units = width / kU;
  const int G = min(units, 32), R = 32 / G;
  const int nuc = (units + G - 1) / G;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, p = lane - grp * G;
  const int items = nrows * nuc;
  const int stride = kResWarps * R;

  struct Item {
    bool on = false;
    int row = 0, col = 0, g = 0;
    float b = 0.f, m = 0.f;
    Elems<TF, kU> f;
  };
  auto fetch = [&](int k) {
    Item it;
    if (grp >= R || k >= items) return it;
    const int q = k / nuc;
    const int unit = (k - q * nuc) * G + p;
    if (unit >= units) return it;
    it.on = true;
    it.row = r0 + q;
    it.col = col0 + unit * kU;
    it.g = a.gids[it.row];
    it.b = a.beta[it.row];
    it.m = a.mask[it.row];
    it.f.template load<kPlain>(fresh + static_cast<size_t>(it.row) * D + it.col);
    return it;
  };

  // the first row's loads fly while the slab is staged
  int k = grp < R ? (threadIdx.x >> 5) * R + grp : items;
  Item cur = fetch(k);
  // stage store[:, col0:col0+width] of every store row, all copies in flight
  if constexpr (kVector) {   // D % kU == 0 and bd % kU == 0: whole vectors
    for (int t = threadIdx.x; t < M * units; t += blockDim.x) {
      const int r = t / units, c = (t - r * units) * kU;
      cp_async16(slab + static_cast<size_t>(r) * bd + c,
                 store + static_cast<size_t>(r) * D + col0 + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int t = threadIdx.x; t < M * width; t += blockDim.x) {
      const int r = t / width, c = t - r * width;
      slab[static_cast<size_t>(r) * bd + c] =
          store[static_cast<size_t>(r) * D + col0 + c];
    }
  }
  __syncthreads();

  // An item is off for the lanes past a row's last unit; the lane's later
  // items may be on (the stride need not be a multiple of nuc).
  for (; k < items; k += stride) {   // no warp-wide operation inside
    const Item next = fetch(k + stride);   // one row ahead
    if (cur.on) {
      const int g = min(max(cur.g, 0), M - 1);
      Elems<TS, kU> s;
      s.template load<kPlain>(slab + static_cast<size_t>(g) * bd +
                               (cur.col - col0));
      combine<TS, TF, kU>(s, cur.f, TF::round(cur.m), TF::round(cur.b),
                          out + static_cast<size_t>(cur.row) * D + cur.col);
    }
    cur = next;
  }
}

// --------------------------------------------------------------- launches
template <typename TS, typename TF, bool kVector, int kNV>
cudaError_t launch_stream(const Args& a, cudaStream_t stream) {
  compensate_kernel<TS, TF, kVector, kNV>
      <<<(a.N + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TS, typename TF>
cudaError_t launch_streaming(const Args& a, int vector, cudaStream_t s) {
  if (!vector) return launch_stream<TS, TF, false, 4>(a, s);  // 128 columns
  if (a.D <= 32 * kVec) return launch_stream<TS, TF, true, 1>(a, s);
  if (a.D <= 64 * kVec) return launch_stream<TS, TF, true, 2>(a, s);
  return launch_stream<TS, TF, true, 4>(a, s);                // 512 columns
}

template <typename TS, typename TF>
cudaError_t launch_resident(const Args& a, int vector, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.M) * a.bd * sizeof(typename TS::raw);
  decltype(&compensate_resident_kernel<TS, TF, true>) kernel =
      vector ? &compensate_resident_kernel<TS, TF, true>
             : &compensate_resident_kernel<TS, TF, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + a.rows - 1) / a.rows, (a.D + a.bd - 1) / a.bd);
  kernel<<<grid, kResWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kResident>
int dispatch(const Args& a, int store_bf16, int fresh_bf16, int vector,
             void* stream) {
  if (a.N <= 0 || a.D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (kResident) {
    if (a.rows <= 0 || a.bd <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (store_bf16 && fresh_bf16) e = launch_resident<BF16, BF16>(a, vector, s);
    else if (store_bf16) e = launch_resident<BF16, F32>(a, vector, s);
    else if (fresh_bf16) e = launch_resident<F32, BF16>(a, vector, s);
    else e = launch_resident<F32, F32>(a, vector, s);
  } else {
    if (store_bf16 && fresh_bf16) e = launch_streaming<BF16, BF16>(a, vector, s);
    else if (store_bf16) e = launch_streaming<BF16, F32>(a, vector, s);
    else if (fresh_bf16) e = launch_streaming<F32, BF16>(a, vector, s);
    else e = launch_streaming<F32, F32>(a, vector, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// Plain C entry point (loaded with ctypes). store: (M, D) f32 or bf16;
// gids: (N,) int32; beta, mask: (N,) f32; fresh: (N, D) f32 or bf16;
// out: (N, D) in fresh's dtype. All row-major and contiguous. `vector`
// selects 4-element loads and needs D % 4 == 0 and store/fresh/out aligned
// to 4 elements. Launches on `stream`; returns the CUDA error (0 on
// success).
extern "C" int repro_lmc_compensate(const void* store, const void* gids,
                                    const void* beta, const void* fresh,
                                    const void* mask, void* out, int N, int M,
                                    int D, int store_bf16, int fresh_bf16,
                                    int vector, void* stream) {
  const Args a{store, static_cast<const int32_t*>(gids),
               static_cast<const float*>(beta), fresh,
               static_cast<const float*>(mask), out, N, M, D, 0, 0};
  return dispatch<false>(a, store_bf16, fresh_bf16, vector, stream);
}

// Resident-store entry point: the arguments of `repro_lmc_compensate`,
// plus `bd`, the column-tile width, a multiple of
// the store's 16-byte vector with M * bd * sizeof(store) within the opt-in
// shared memory per block, and `block_rows`, the rows of each block's
// contiguous share (grid: ceil(N / block_rows) x ceil(D / bd) blocks).
// `vector` selects 16-byte staging and slab reads (D a multiple of
// 16 / sizeof(store), store 16-byte aligned, fresh and out aligned to that
// many of their elements or to 16 bytes). Returns the first CUDA error.
extern "C" int repro_lmc_compensate_resident(
    const void* store, const void* gids, const void* beta, const void* fresh,
    const void* mask, void* out, int N, int M, int D, int bd, int block_rows,
    int store_bf16, int fresh_bf16, int vector, void* stream) {
  const Args a{store, static_cast<const int32_t*>(gids),
               static_cast<const float*>(beta), fresh,
               static_cast<const float*>(mask), out, N, M, D, bd, block_rows};
  return dispatch<true>(a, store_bf16, fresh_bf16, vector, stream);
}

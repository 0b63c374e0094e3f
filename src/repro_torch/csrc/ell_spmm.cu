// Degree-bucketed ELL SpMM for Hopper (sm_90a), one bucket per launch:
//   out[i, :]        = sum_k w[i, k] * h[idx[i, k], :]   (per-bucket form)
//   out[rid[i], :]  += sum_k w[i, k] * h[idx[i, k], :]   (scatter form,
//                                                         rid[i] < n only)
//
// The scatter form is what `bucketed_spmm` runs: every bucket adds straight
// into one zeroed (n, D) output, so no per-bucket output and no index_add_
// exist. The per-bucket form is the same body with the scatter switched off
// (template flag kScatter).
//
// Streaming variant (`repro_ell_spmm`) replaces the TPU kernel
// `_spmm_stream_kernel` of src/repro/kernels/ell_spmm.py (`ell_spmm`,
// stream=True): the HBM->VMEM double-buffered row gather of the reference.
//
// What bounds it on an H100: memory. Each real nonzero moves one gathered row
// of h (D elements) plus one (idx, w) pair and does 2*D flops, under 0.5 flop
// per byte in f32, far below the card's ~20 flop/byte f32 ridge (67 TFLOP/s
// over 3.35 TB/s). The least time is the bytes of the h rows the real
// nonzeros reference, plus their idx and w, plus one output row per distinct
// real destination row, over 3.35 TB/s.
//
// Design of the streaming kernel: one warp per (run of bucket rows, column
// tile). The warp loads the (idx, w) slots of up to four 32-slot chunks of
// a row with one coalesced load each, the next row's (or chunk block's)
// before it multiplies the current one, and broadcasts them with
// __shfl_sync. Each lane owns kVec contiguous columns per 32*kVec-wide chunk
// and reads them with one 16-byte load (4 x f32 or 8 x bf16); kUnroll
// gathered rows are loaded before any of them is multiplied, so each lane
// keeps kUnroll * kChunks 16-byte loads in flight. Accumulation is in f32,
// in k order from +0, as on the TPU. The D tail is masked (D is not padded
// to a tile multiple). Indices are clamped to [0, M-1] so a bad index can
// never read outside h.
//
// What the kernels do about the padding of fixed-capacity buckets:
// - padding rows (rid >= n, at the tail of every bucket) are skipped by the
//   scatter form, and the wrapper sizes the grid by the bucket's real row
//   count where the host knows it;
// - the trailing run of a chunk's slots that share one zero weight (same
//   bits) and one index j (the padding slots that end a short row; whole
//   chunks of the all-zero pieces that padded edges make of row 0) is one
//   fmaf(w, h[j], acc), and a run equal to the one just done is none. That
//   changes no bit: x -> fmaf(+-0, h[j], x) is idempotent for every x, so
//   a run of them equals one, and 0 * NaN or 0 * inf still poisons the row;
// - in the widest bucket (K >= 128), where the pieces of a heavy row (and
//   row 0's) sit next to each other in (node, chunk) order, a warp walks a
//   run of kRun = 2 rows, keeps accumulating while rid stays the same and
//   flushes once per destination row; narrower buckets hold one piece per
//   row, so their runs are single rows. A flush is a 16-byte atomicAdd
//   (red) per lane into the zeroed output, so a row with a single piece
//   gets 0 + x = x exactly, and a lane whose sum is +0 in every element
//   (row 0's all-zero pieces) adds nothing, which changes no bit either.
//   Runs are aligned at multiples of the run length in both variants, so
//   the two give the same partial sums per bucket; a row of up to three
//   pieces then takes at most two flushes, which commute. Runs are short
//   because the resident kernel walks a run's rows one after another, each
//   after its own dependent index loads, and few long runs leave most of
//   the card idle.
//
// Resident-source variant (`repro_ell_spmm_resident`) replaces the TPU kernel
// `_spmm_resident_kernel` of the same file (`ell_spmm`, stream=False), where
// the whole (M, block_d) source slab rides into VMEM as one block. Here
// blocks are persistent: about one per SM, each owns one column tile of bd
// columns, stages the slab h[:, c0:c0+bd] of all M rows into dynamic shared
// memory once (cp.async of 16 bytes, all in flight, then one wait), and then
// walks its share of the bucket's runs. The wrapper picks bd, the widest
// multiple of the 16-byte vector with M*bd elements in the card's opt-in
// shared memory per block (one block of 32 warps owns the SM). A row's slab
// segment is bd/kVec vectors; a warp splits into lane groups of that many
// lanes (5 at bd = 20 floats: six rows per warp), so narrow slabs keep the
// lanes busy, and each lane loads kSub (idx, w) slots of its group's row at
// once. Its arithmetic is the streaming kernel's (fmaf in k order from +0,
// trailing zero runs collapsed, the same runs, indices clamped), so the two
// agree bit for bit per bucket.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;     // warps per streaming block
constexpr int kChunks = 2;    // 16-byte vectors per lane per column tile
constexpr int kUnroll = 8;    // gathered rows in flight per lane
constexpr int kBlk = 4;       // 32-slot (idx, w) chunks loaded together
constexpr int kRun = 2;       // bucket rows per run (scatter form, K >= 128)
constexpr int kResWarps = 32; // warps per resident block
constexpr int kSub = 8;       // (idx, w) slots per lane per resident chunk

struct F32 {
  using raw = float;
  static constexpr int kVec = 4;
  __device__ static float load(raw x) { return x; }
  __device__ static raw store(float x) { return x; }
  __device__ static void add_vec(raw* p, const float* a) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  }
  __device__ static void add1(raw* p, float a) { atomicAdd(p, a); }
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
  __device__ static void add_vec(raw* p, const float* a) {
    auto* q = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      atomicAdd(q + v, __floats2bfloat162_rn(a[2 * v], a[2 * v + 1]));
  }
  __device__ static void add1(raw* p, float a) {
    atomicAdd(reinterpret_cast<__nv_bfloat16*>(p), __float2bfloat16_rn(a));
  }
};

template <typename T>
union Pack {
  uint4 u;
  typename T::raw e[T::kVec];
};

// Everything one launch needs; rid == nullptr selects the per-bucket form.
struct Args {
  const int32_t* idx;
  const void* w;
  const int32_t* rid;
  const void* h;
  void* out;
  int rows;   // bucket rows to process (the real count where known)
  int K, M, D;
  int n;      // output rows of the scatter form
  int bd;     // resident column-tile width
  int run;    // bucket rows per run, aligned at multiples of it
};

// acc (+)= w * row, kVec (vector) or 1 element(s)
template <typename TH, bool kVector>
__device__ __forceinline__ void fma_unit(float* acc, float w, const uint4& u,
                                         typename TH::raw s) {
  if constexpr (kVector) {
    Pack<TH> p;
    p.u = u;
#pragma unroll
    for (int v = 0; v < TH::kVec; ++v) acc[v] = fmaf(w, TH::load(p.e[v]), acc[v]);
  } else {
    acc[0] = fmaf(w, TH::load(s), acc[0]);
  }
}

// Write (per-bucket form) or add (scatter form) one unit of the output.
template <typename TH, bool kVector, bool kScatter>
__device__ __forceinline__ void put_unit(typename TH::raw* dst, const float* acc) {
  constexpr int n = kVector ? TH::kVec : 1;
  if constexpr (kScatter) {
    // adding +0 changes no element: the output starts at +0 and a sum in
    // round-to-nearest is -0 only when both terms are
    bool zero = true;
#pragma unroll
    for (int v = 0; v < n; ++v) zero = zero && __float_as_uint(acc[v]) == 0u;
    if (zero) return;
    if constexpr (kVector) TH::add_vec(dst, acc);
    else TH::add1(dst, acc[0]);
  } else if constexpr (kVector) {
    Pack<TH> p;
#pragma unroll
    for (int v = 0; v < n; ++v) p.e[v] = TH::store(acc[v]);
    *reinterpret_cast<uint4*>(dst) = p.u;
  } else {
    dst[0] = TH::store(acc[0]);
  }
}

// ------------------------------------------------------------- streaming
// One 32-slot chunk of a row: the slots before its trailing run of
// identical zero-weight slots as gathers (kUnroll rows in flight per lane),
// the trailing run as one fmaf, skipped when it repeats the run just done.
struct Collapse {
  bool have = false;   // the last operation was a collapsed run ...
  int j = 0;           // ... on this index
  unsigned wb = 0;     // ... with these weight bits
};

template <typename TH, bool kVector>
__device__ __forceinline__ void stream_chunk(
    float (&acc)[kChunks][kVector ? TH::kVec : 1], Collapse& last, int jl,
    float wl, int kn, const typename TH::raw* __restrict__ h, int M, int D,
    int col0, int lane) {
  using RH = typename TH::raw;
  constexpr int kVec = kVector ? TH::kVec : 1;
  jl = min(max(jl, 0), M - 1);
  const unsigned wbl = __float_as_uint(wl);
  const int jt = __shfl_sync(kFull, jl, kn - 1);
  const unsigned wbt = __shfl_sync(kFull, wbl, kn - 1);
  const unsigned live = kn == 32 ? kFull : (1u << kn) - 1u;
  const unsigned diff = ~__ballot_sync(kFull, jl == jt && wbl == wbt) & live;
  // slots [s, kn) are one run of zero weights on row jt
  const int s = __uint_as_float(wbt) == 0.f ? (diff ? 32 - __clz(diff) : 0)
                                            : kn;
  if (s > 0) last.have = false;
  for (int kk = 0; kk < s; kk += kUnroll) {
    uint4 u[kUnroll][kChunks];
    RH e[kUnroll][kChunks];
    float wk[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {   // start every load first
      const int j = __shfl_sync(kFull, jl, (kk + q) & 31);
      wk[q] = __shfl_sync(kFull, wl, (kk + q) & 31);
      const RH* src = h + static_cast<size_t>(j) * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = col0 + (c * 32 + lane) * kVec;
        u[q][c] = uint4{};
        e[q][c] = RH{};
        if (kk + q < s && col < D) {
          if constexpr (kVector) u[q][c] = *reinterpret_cast<const uint4*>(src + col);
          else e[q][c] = src[col];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)     // then multiply in k order
      if (kk + q < s) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          fma_unit<TH, kVector>(acc[c], wk[q], u[q][c], e[q][c]);
      }
  }
  if (s < kn && !(last.have && last.j == jt && last.wb == wbt)) {
    const RH* src = h + static_cast<size_t>(jt) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = col0 + (c * 32 + lane) * kVec;
      if (col < D) {
        uint4 u{};
        RH e{};
        if constexpr (kVector) u = *reinterpret_cast<const uint4*>(src + col);
        else e = src[col];
        fma_unit<TH, kVector>(acc[c], __uint_as_float(wbt), u, e);
      }
    }
    last = Collapse{true, jt, wbt};
  }
}

template <typename TW, typename TH, bool kVector, bool kScatter>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(Args a) {
  using RH = typename TH::raw;
  using RW = typename TW::raw;
  constexpr int kVec = kVector ? TH::kVec : 1;
  constexpr int kTile = 32 * kVec * kChunks;
  const int lane = threadIdx.x & 31;
  const int r_begin = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * a.run;
  if (r_begin >= a.rows) return;   // uniform per warp: shuffles stay full
  const int nrun = min(a.rows - r_begin, a.run);
  const int col0 = blockIdx.y * kTile;
  const int K = a.K, D = a.D;
  const RH* h = static_cast<const RH*>(a.h);
  const RW* w = static_cast<const RW*>(a.w);
  RH* out = static_cast<RH*>(a.out);

  // the run's destination rows, one per lane; its real rows as a bit mask
  int my_rid = r_begin + lane;
  if (kScatter && lane < nrun) my_rid = a.rid[r_begin + lane];
  unsigned live = __ballot_sync(
      kFull, lane < nrun && (!kScatter || static_cast<unsigned>(my_rid) <
                                              static_cast<unsigned>(a.n)));
  if (!live) return;               // a run of padding rows

  float acc[kChunks][kVec];
  int cur = -1;                    // destination row being accumulated
  Collapse last;
  auto put = [&](int dst_row) {
    RH* dst = out + static_cast<size_t>(dst_row) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = col0 + (c * 32 + lane) * kVec;
      if (col < D) put_unit<TH, kVector, kScatter>(dst + col, acc[c]);
    }
  };
  // (idx, w) of kBlk chunks of a row, one slot per lane per chunk; the next
  // block is loaded before the current one is multiplied
  const int nblk = (K + 32 * kBlk - 1) / (32 * kBlk);
  auto load = [&](int i, int b, int (&j)[kBlk], float (&wv)[kBlk]) {
    const size_t base = static_cast<size_t>(r_begin + i) * K;
#pragma unroll
    for (int c = 0; c < kBlk; ++c) {
      const int k = (b * kBlk + c) * 32 + lane;
      j[c] = 0;
      wv[c] = 0.f;
      if (k < K) {
        j[c] = a.idx[base + k];
        wv[c] = TW::load(w[base + k]);
      }
    }
  };
  int i = __ffs(live) - 1, b = 0;
  live &= live - 1;
  int cj[kBlk];
  float cw[kBlk];
  load(i, 0, cj, cw);
  while (true) {
    int ni = i, nb = b + 1;
    if (nb == nblk) {
      nb = 0;
      ni = live ? __ffs(live) - 1 : -1;
      live &= live - 1;
    }
    int nj[kBlk];
    float nw[kBlk];
    if (ni >= 0) load(ni, nb, nj, nw);
    if (b == 0) {
      const int dst_row = __shfl_sync(kFull, my_rid, i);
      if (dst_row != cur) {
        if (kScatter && cur >= 0) put(cur);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[c][v] = 0.f;
        cur = dst_row;
        last.have = false;
      }
    }
#pragma unroll
    for (int c = 0; c < kBlk; ++c) {
      const int k0 = (b * kBlk + c) * 32;
      if (k0 < K)
        stream_chunk<TH, kVector>(acc, last, cj[c], cw[c], min(32, K - k0), h,
                                  a.M, D, col0, lane);
    }
    if (!kScatter && nb == 0) put(cur);   // per-bucket form: row done
    if (ni < 0) break;
    i = ni;
    b = nb;
#pragma unroll
    for (int c = 0; c < kBlk; ++c) {
      cj[c] = nj[c];
      cw[c] = nw[c];
    }
  }
  if (kScatter) put(cur);
}

// -------------------------------------------------------------- resident
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <typename TW, typename TH, bool kVector, bool kScatter>
__global__ void __launch_bounds__(kResWarps * 32, 1)
ell_spmm_resident_kernel(Args a) {
  using RH = typename TH::raw;
  using RW = typename TW::raw;
  constexpr int kVec = kVector ? TH::kVec : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  RH* slab = reinterpret_cast<RH*>(smem);   // (M, bd)
  const int K = a.K, M = a.M, D = a.D, bd = a.bd;
  const RH* h = static_cast<const RH*>(a.h);
  const RW* w = static_cast<const RW*>(a.w);
  RH* out = static_cast<RH*>(a.out);
  const int col0 = blockIdx.y * bd;
  const int width = min(bd, D - col0);

  // stage h[:, col0:col0+width] of every source row, all copies in flight
  if constexpr (kVector) {   // D % kVec == 0 and bd % kVec == 0: whole vectors
    const int nvec = width / kVec;
    for (int t = threadIdx.x; t < M * nvec; t += blockDim.x) {
      const int r = t / nvec, c = (t - r * nvec) * kVec;
      cp_async16(slab + static_cast<size_t>(r) * bd + c,
                 h + static_cast<size_t>(r) * D + col0 + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int t = threadIdx.x; t < M * width; t += blockDim.x) {
      const int r = t / width, c = t - r * width;
      slab[static_cast<size_t>(r) * bd + c] = h[static_cast<size_t>(r) * D + col0 + c];
    }
  }
  __syncthreads();

  // A row's slab segment is `units` units of kVec elements. A warp is R
  // groups of G lanes, one row (of its own run) per group, one unit per
  // lane per pass. Each lane loads kSub consecutive (idx, w) slots of its
  // group's row, so a chunk of G * kSub slots is one load round.
  const int units = width / kVec;
  const int G = min(units, 32), R = 32 / G;
  const int lane = threadIdx.x & 31;
  const int g = lane / G, p = lane - g * G, gbase = g * G;
  const unsigned gmask = G == 32 ? kFull : (((1u << G) - 1u) << gbase);
  const int span = G * kSub;
  const int nruns = (a.rows + a.run - 1) / a.run;
  // warps numbered across blocks first, so that few runs still spread
  // over every block
  const int warp0 = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int nwarps = gridDim.x * kResWarps;

  for (int u0 = 0; u0 < units; u0 += G) {         // passes (units > 32 only)
    const int unit = u0 + p;
    const bool lane_on = g < R && unit < units;
    const int col = unit * kVec;                   // within the tile
    for (int base = warp0 * R; base < nruns; base += nwarps * R) {  // uniform
      const int run = base + g;
      const bool run_on = g < R && run < nruns;
      float acc[kVec];
      int cur = -1;
      Collapse last;
      for (int rr = 0; rr < a.run; ++rr) {         // uniform trip count
        const int row = run * a.run + rr;
        int dst_row = -1;
        if (run_on && row < a.rows) {
          dst_row = kScatter ? a.rid[row] : row;
          if (kScatter && static_cast<unsigned>(dst_row) >=
                              static_cast<unsigned>(a.n))
            dst_row = -1;                          // padding row: skipped
        }
        const bool row_on = dst_row >= 0;
        if (row_on && dst_row != cur) {
          if (kScatter && cur >= 0 && lane_on)
            put_unit<TH, kVector, true>(
                out + static_cast<size_t>(cur) * D + col0 + col, acc);
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
          cur = dst_row;
          last.have = false;
        }
        const size_t rbase = static_cast<size_t>(row) * K;
        for (int k0 = 0; k0 < K; k0 += span) {     // uniform trip count
          const int kn = min(span, K - k0);
          int jv[kSub];
          float wv[kSub];
#pragma unroll
          for (int c = 0; c < kSub; ++c) {
            const int k = p * kSub + c;
            jv[c] = 0;
            wv[c] = 0.f;
            if (row_on && g < R && k < kn) {
              jv[c] = a.idx[rbase + k0 + k];
              wv[c] = TW::load(w[rbase + k0 + k]);
            }
            jv[c] = min(max(jv[c], 0), M - 1);
          }
          // the chunk's last slot, and the trailing run of slots equal to it
          const int tq = (kn - 1) / kSub, tc = (kn - 1) - tq * kSub;
          int jsel = jv[0];
          float wsel = wv[0];
#pragma unroll
          for (int c = 1; c < kSub; ++c)
            if (c == tc) {
              jsel = jv[c];
              wsel = wv[c];
            }
          const int jt = __shfl_sync(kFull, jsel, gbase + tq);
          const unsigned wbt =
              __shfl_sync(kFull, __float_as_uint(wsel), gbase + tq);
          int s_end = 0;   // one past the group's last slot unequal to it
#pragma unroll
          for (int c = 0; c < kSub; ++c) {
            const bool d = p * kSub + c < kn &&
                           (jv[c] != jt || __float_as_uint(wv[c]) != wbt);
            const unsigned bits = (__ballot_sync(kFull, d) & gmask) >> gbase;
            if (bits) s_end = max(s_end, (31 - __clz(bits)) * kSub + c + 1);
          }
          const int s = __uint_as_float(wbt) == 0.f ? s_end : kn;
          if (row_on && s > 0) last.have = false;
          for (int kq = 0; kq * kSub < kn; ++kq) {  // uniform: source lane
#pragma unroll
            for (int c = 0; c < kSub; ++c) {
              const int kk = kq * kSub + c;
              if (kk < kn) {                         // uniform
                const int j = __shfl_sync(kFull, jv[c], gbase + kq);
                const float wk = __shfl_sync(kFull, wv[c], gbase + kq);
                if (row_on && lane_on && kk < s) {
                  uint4 u{};
                  RH e{};
                  const RH* src = slab + static_cast<size_t>(j) * bd + col;
                  if constexpr (kVector) u = *reinterpret_cast<const uint4*>(src);
                  else e = *src;
                  fma_unit<TH, kVector>(acc, wk, u, e);
                }
              }
            }
          }
          if (row_on && s < kn && !(last.have && last.j == jt && last.wb == wbt)) {
            if (lane_on) {
              uint4 u{};
              RH e{};
              const RH* src = slab + static_cast<size_t>(jt) * bd + col;
              if constexpr (kVector) u = *reinterpret_cast<const uint4*>(src);
              else e = *src;
              fma_unit<TH, kVector>(acc, __uint_as_float(wbt), u, e);
            }
            last = Collapse{true, jt, wbt};
          }
        }
        if (!kScatter && row_on && lane_on)
          put_unit<TH, kVector, false>(
              out + static_cast<size_t>(row) * D + col0 + col, acc);
      }
      if (kScatter && cur >= 0 && lane_on)
        put_unit<TH, kVector, true>(
            out + static_cast<size_t>(cur) * D + col0 + col, acc);
    }
  }
}

// --------------------------------------------------------------- launches
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

template <bool kResident, typename TW, typename TH, bool kVector,
          bool kScatter>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nruns = (a.rows + a.run - 1) / a.run;
  if constexpr (kResident) {
    const size_t smem =
        static_cast<size_t>(a.M) * a.bd * sizeof(typename TH::raw);
    auto kernel = ell_spmm_resident_kernel<TW, TH, kVector, kScatter>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // persistent: about one block per SM, each stages its slab once
    const int tiles = (a.D + a.bd - 1) / a.bd;
    const int fit = std::max(1, sm_count() / tiles);
    const dim3 grid(std::max(1, std::min(nruns, fit)), tiles);
    kernel<<<grid, kResWarps * 32, smem, stream>>>(a);
  } else {
    constexpr int kTile = 32 * (kVector ? TH::kVec : 1) * kChunks;
    const dim3 grid((nruns + kWarps - 1) / kWarps, (a.D + kTile - 1) / kTile);
    ell_spmm_kernel<TW, TH, kVector, kScatter>
        <<<grid, kWarps * 32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool kResident, typename TW, typename TH>
cudaError_t by_form(const Args& a, int vector, cudaStream_t s) {
  if (vector)
    return a.rid ? launch<kResident, TW, TH, true, true>(a, s)
                 : launch<kResident, TW, TH, true, false>(a, s);
  return a.rid ? launch<kResident, TW, TH, false, true>(a, s)
               : launch<kResident, TW, TH, false, false>(a, s);
}

template <bool kResident>
int dispatch(Args a, int w_bf16, int h_bf16, int vector,
             void* stream) {
  if (a.rows <= 0 || a.D <= 0) return 0;
  // Pieces of one row share a bucket only as full chunks of the widest
  // bucket (K = 128 in every configuration the package builds): narrower
  // buckets hold at most one piece per row, so their runs are single rows
  // and every warp works on its own.
  a.run = a.rid && a.K >= 128 ? kRun : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w_bf16 && h_bf16) e = by_form<kResident, BF16, BF16>(a, vector, s);
  else if (w_bf16) e = by_form<kResident, BF16, F32>(a, vector, s);
  else if (h_bf16) e = by_form<kResident, F32, BF16>(a, vector, s);
  else e = by_form<kResident, F32, F32>(a, vector, s);
  return static_cast<int>(e);
}

}  // namespace

// The card's opt-in shared memory per block, in bytes, for `device`
// (232,448 on an H100). Returns the CUDA error code (0 on success).
extern "C" int repro_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Plain C entry point (loaded with ctypes). idx: (rows, K) int32; w: (rows,
// K) f32 or bf16; h: (M, D) f32 or bf16; all row-major and contiguous.
// Per-bucket form (rid == NULL): out (rows, D) in h's dtype, every row
// written. Scatter form: rid (>= rows) int32 destination rows, out (n, D) in
// h's dtype, zeroed by the caller; rows i < `rows` with rid[i] < n add into
// out[rid[i]] (atomics), the others are skipped. `vector` selects 16-byte
// loads and needs D % (16 / sizeof(h)) == 0 and 16-byte-aligned h and out.
// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int repro_ell_spmm(const void* idx, const void* w, const void* rid,
                              const void* h, void* out, int rows, int K,
                              int M, int D, int n, int w_bf16, int h_bf16,
                              int vector, void* stream) {
  const Args a{static_cast<const int32_t*>(idx), w,
               static_cast<const int32_t*>(rid), h, out, rows, K, M, D, n, 0, 1};
  return dispatch<false>(a, w_bf16, h_bf16, vector, stream);
}

// Resident-source entry point: the arguments of `repro_ell_spmm`, plus `bd`,
// the column-tile width, a multiple of the 16-byte vector with
// M * bd * sizeof(h) within the opt-in shared memory per block. `vector`
// selects 16-byte staging and slab loads (D % (16 / sizeof(h)) == 0, h and
// out 16-byte aligned).
extern "C" int repro_ell_spmm_resident(const void* idx, const void* w,
                                       const void* rid, const void* h,
                                       void* out, int rows, int K, int M,
                                       int D, int n, int bd, int w_bf16,
                                       int h_bf16, int vector, void* stream) {
  const Args a{static_cast<const int32_t*>(idx), w,
               static_cast<const int32_t*>(rid), h, out, rows, K, M, D, n, bd, 1};
  return dispatch<true>(a, w_bf16, h_bf16, vector, stream);
}

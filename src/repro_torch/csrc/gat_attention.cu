// GAT's attention aggregation over the degree-bucketed ELL (sm_90a), f32.
// For z (n, H, F), scores u, v (n, H), over the real edges j->i of A (slots
// with w != 0) and one self loop a row:
//   e_ij = LeakyReLU_0.2(u_j + v_i),  a_ij = softmax_j(e_ij),
//   o_i  = sum_j a_ij z_j                                    (each head)
// Three kernels, one warp a (row, head):
//   gat_attn_fwd  over A:   o and lse_i = log sum_j exp(e_ij);
//   gat_attn_dst  over A:   D_i = go_i . o_i and dv_i = sum_j c_ij a_ij
//                           (go_i . z_j - D_i), c the LeakyReLU's slope;
//   gat_attn_src  over A^T: dz_j = sum_i a_ij go_i and du_j = sum_i c_ij
//                           a_ij (go_i . z_j - D_i).
//
// They replace no TPU kernel: the JAX package has no attention GNN. GAT
// (the inductive PPI model) computes its aggregation weights from the data,
// which no fixed-weight SpMM does, and at PPI's widths the aggregation and
// its backward are a large share of an LMC step.
//
// What bounds them on an H100: memory. Each real edge gathers one row of z
// (forward, dst pass) or of go (src pass): F floats a head, against 2F + 5
// flops (forward) or about 4F (backward), under 1 flop per byte, far below
// the card's ~20 flop/byte f32 ridge. The least time is z, u, v and the
// outputs once, plus the gathered index per edge, over 3.35 TB/s
// (perfbench/yardstick.py attention_work, attention_vjp_work); the gathers
// of z[src] read more than that, once per edge, from L2 where rows repeat.
//
// Design. The ELL splits a row of more than K_max edges into pieces, which
// may lie in two buckets; a softmax needs the row whole, so the wrapper
// lists each row's pieces (ptr, code = slot row << 2 | bucket; pieces with
// no real slot, such as the padded COO's edges into row 0, left out) and a
// warp walks its row's pieces in that order. It reads 32 slots at a time,
// one a lane (idx, w, and the gathered score), takes the chunk's max and
// sum with butterfly shuffles (every lane ends with the same bits), and then
// walks the chunk's real slots in slot order, kUnroll gathered rows in
// flight, each lane owning columns lane + 32c of the head (c < C, C a
// template parameter: F <= 32 C, the tail masked, so F = 121 needs no
// padding). The forward is an online softmax: a running max m and sum s,
// the accumulator rescaled when the max grows, starting from the self loop.
// The backward recomputes a_ij = exp(e_ij - lse_i) and needs no E x H x F
// array. The dst pass sums dv as -0.8 (go_i . sum_{pre<=0} a z_j - D_i
// sum_{pre<=0} a), since the sum with c = 1 is zero; the src pass sums du
// as z_j . sum_i c a go_i - sum_i c a D_i. Nothing is added with atomics:
// each output is written once by its warp, so results repeat bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 4;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSlope = 0.2f;

struct Graph {
  const int32_t* ptr;    // (n + 1,) each row's first piece
  const int32_t* code;   // pieces: slot row << 2 | bucket
  int nb;
  const int32_t* idx[kMaxBuckets];   // (cap_b, K_b) gather ids
  const float* w[kMaxBuckets];       // (cap_b, K_b) weights, 0 = padding
  int k[kMaxBuckets];
};

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : kSlope * x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One 32-slot chunk of a piece: this lane's slot (gather id, whether it is
// real) and the ballot of the real slots.
struct Chunk {
  int j;
  bool real;
  unsigned mask;
};

__device__ __forceinline__ Chunk load_chunk(const Graph& g, int code,
                                            int base, int lane) {
  const int b = code & 3;
  const long long r = code >> 2;
  const int K = g.k[b];
  const int slot = base + lane;
  Chunk c{0, false, 0u};
  if (slot < K) {
    const float wt = g.w[b][r * K + slot];
    c.j = g.idx[b][r * K + slot];
    c.real = wt != 0.f;
  }
  c.mask = __ballot_sync(kFull, c.real);
  return c;
}

// acc[c] += p_t * src[j_t * HF + col + 32 c] (and acc2 with q_t where kTwo)
// for the set bits t of mask, in slot order, kUnroll rows loaded before
// they are added; p, q and j are each lane's own slot's.
template <int C, bool kTwo>
__device__ __forceinline__ void gather_add(float (&acc)[C], float (&acc2)[C],
                                           unsigned mask, int j, float p,
                                           float q, const float* __restrict__ src,
                                           long long HF, int col, int F,
                                           int lane) {
  while (mask) {
    int jq[kUnroll];
    float pq[kUnroll], qq[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const bool any = mask != 0u;
      const int t = any ? __ffs(mask) - 1 : 0;
      mask &= mask - 1u;
      const int jt = __shfl_sync(kFull, j, t);
      const float pt = __shfl_sync(kFull, p, t);
      const float qt = kTwo ? __shfl_sync(kFull, q, t) : 0.f;
      jq[k] = any ? jt : -1;
      pq[k] = pt;
      qq[k] = qt;
    }
    float x[kUnroll][C];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const float* row = src + (jq[k] < 0 ? 0 : jq[k]) * HF + col;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        x[k][c] = (jq[k] >= 0 && f < F) ? row[f] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (jq[k] < 0) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] = fmaf(pq[k], x[k][c], acc[c]);
        if (kTwo) acc2[c] = fmaf(qq[k], x[k][c], acc2[c]);
      }
    }
  }
}

struct Fwd {
  const float* z;
  const float* u;
  const float* v;
  float* out;
  float* lse;
  Graph g;
  int n, H, F;
};

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
gat_attn_fwd_kernel(Fwd a) {
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
  if (gw >= static_cast<long long>(a.n) * a.H) return;   // whole warps
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(gw / a.H), h = static_cast<int>(gw % a.H);
  const long long HF = static_cast<long long>(a.H) * a.F;
  const int col = h * a.F;
  const float vi = a.v[gw];
  float m = leaky(a.u[gw] + vi);   // the self loop
  float s = 1.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    acc[c] = f < a.F ? a.z[i * HF + col + f] : 0.f;
  }
  for (int p = a.g.ptr[i]; p < a.g.ptr[i + 1]; ++p) {
    const int code = a.g.code[p];
    const int K = a.g.k[code & 3];
    for (int base = 0; base < K; base += 32) {
      const Chunk ch = load_chunk(a.g, code, base, lane);
      if (!ch.mask) continue;
      const float e = ch.real ? leaky(a.u[static_cast<long long>(ch.j) * a.H
                                          + h] + vi)
                              : -INFINITY;
      const float mn = fmaxf(m, warp_max(e));
      const float scale = expf(m - mn);
      const float pj = ch.real ? expf(e - mn) : 0.f;
      s = fmaf(s, scale, warp_sum(pj));
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= scale;
      m = mn;
      gather_add<C, false>(acc, acc, ch.mask, ch.j, pj, 0.f, a.z, HF, col,
                           a.F, lane);
    }
  }
  const float inv = 1.f / s;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    if (f < a.F) a.out[i * HF + col + f] = acc[c] * inv;
  }
  if (lane == 0) a.lse[gw] = m + logf(s);
}

struct Bwd {
  const float* z;
  const float* u;
  const float* v;
  const float* lse;
  const float* go;
  float* d;    // (n, H): written by the dst pass, read by the src pass
  float* dv;
  float* dz;
  float* du;
  Graph g;
  int n, H, F;
};

// Over A (row i): D_i = go_i . sum_j a_ij z_j and dv_i.
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
gat_attn_dst_kernel(Bwd a) {
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
  if (gw >= static_cast<long long>(a.n) * a.H) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(gw / a.H), h = static_cast<int>(gw % a.H);
  const long long HF = static_cast<long long>(a.H) * a.F;
  const int col = h * a.F;
  const float vi = a.v[gw], li = a.lse[gw];
  float o[C], on[C];
  float an;
  {
    const float pre = a.u[gw] + vi;   // the self loop
    const float al = expf(leaky(pre) - li);
    const float aln = pre > 0.f ? 0.f : al;
    an = aln;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      const float zf = f < a.F ? a.z[i * HF + col + f] : 0.f;
      o[c] = al * zf;
      on[c] = aln * zf;
    }
  }
  for (int p = a.g.ptr[i]; p < a.g.ptr[i + 1]; ++p) {
    const int code = a.g.code[p];
    const int K = a.g.k[code & 3];
    for (int base = 0; base < K; base += 32) {
      const Chunk ch = load_chunk(a.g, code, base, lane);
      if (!ch.mask) continue;
      float al = 0.f, aln = 0.f;
      if (ch.real) {
        const float pre = a.u[static_cast<long long>(ch.j) * a.H + h] + vi;
        al = expf(leaky(pre) - li);
        aln = pre > 0.f ? 0.f : al;
      }
      an += warp_sum(aln);
      gather_add<C, true>(o, on, ch.mask, ch.j, al, aln, a.z, HF, col, a.F,
                          lane);
    }
  }
  float dd = 0.f, dn = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    const float g = f < a.F ? a.go[i * HF + col + f] : 0.f;
    dd = fmaf(g, o[c], dd);
    dn = fmaf(g, on[c], dn);
  }
  dd = warp_sum(dd);
  dn = warp_sum(dn);
  if (lane == 0) {
    a.d[gw] = dd;
    a.dv[gw] = -(1.f - kSlope) * (dn - dd * an);
  }
}

// Over A^T (row j, its slots the destinations i): dz_j and du_j.
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
gat_attn_src_kernel(Bwd a) {
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
  if (gw >= static_cast<long long>(a.n) * a.H) return;
  const int lane = threadIdx.x & 31;
  const int j = static_cast<int>(gw / a.H), h = static_cast<int>(gw % a.H);
  const long long HF = static_cast<long long>(a.H) * a.F;
  const int col = h * a.F;
  const float uj = a.u[gw];
  float dz[C], gs[C];
  float sd;
  {
    const float pre = uj + a.v[gw];   // the self loop
    const float al = expf(leaky(pre) - a.lse[gw]);
    const float ca = pre > 0.f ? al : kSlope * al;
    sd = ca * a.d[gw];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      const float g = f < a.F ? a.go[j * HF + col + f] : 0.f;
      dz[c] = al * g;
      gs[c] = ca * g;
    }
  }
  for (int p = a.g.ptr[j]; p < a.g.ptr[j + 1]; ++p) {
    const int code = a.g.code[p];
    const int K = a.g.k[code & 3];
    for (int base = 0; base < K; base += 32) {
      const Chunk ch = load_chunk(a.g, code, base, lane);
      if (!ch.mask) continue;
      float al = 0.f, ca = 0.f, cd = 0.f;
      if (ch.real) {
        const long long ih = static_cast<long long>(ch.j) * a.H + h;
        const float pre = uj + a.v[ih];
        al = expf(leaky(pre) - a.lse[ih]);
        ca = pre > 0.f ? al : kSlope * al;
        cd = ca * a.d[ih];
      }
      sd += warp_sum(cd);
      gather_add<C, true>(dz, gs, ch.mask, ch.j, al, ca, a.go, HF, col, a.F,
                          lane);
    }
  }
  float zg = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    if (f < a.F) {
      zg = fmaf(a.z[j * HF + col + f], gs[c], zg);
      a.dz[j * HF + col + f] = dz[c];
    }
  }
  zg = warp_sum(zg);
  if (lane == 0) a.du[gw] = zg - sd;
}

bool read_graph(const long long* host, Graph* g) {
  // ptr, code, nb, idx[4], w[4], k[4]
  g->ptr = reinterpret_cast<const int32_t*>(host[0]);
  g->code = reinterpret_cast<const int32_t*>(host[1]);
  g->nb = static_cast<int>(host[2]);
  if (g->nb < 1 || g->nb > kMaxBuckets) return false;
  for (int b = 0; b < kMaxBuckets; ++b) {
    g->idx[b] = reinterpret_cast<const int32_t*>(host[3 + b]);
    g->w[b] = reinterpret_cast<const float*>(host[3 + kMaxBuckets + b]);
    g->k[b] = static_cast<int>(host[3 + 2 * kMaxBuckets + b]);
    if (b < g->nb && g->k[b] < 1) return false;
  }
  return true;
}

unsigned blocks_for(int n, int H) {
  const long long warps = static_cast<long long>(n) * H;
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

// The smallest C with 32 C >= F; 0 where F is out of range.
int chunks_for(int F) {
  for (int c = 1; c <= 16; c *= 2)
    if (32 * c >= F) return c;
  return 0;
}

template <typename A>
int launch(void (*const table[5])(A), A a, cudaStream_t stream) {
  const int c = chunks_for(a.F);
  if (a.n < 0 || a.H < 1 || !c) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const int slot = c == 1 ? 0 : c == 2 ? 1 : c == 4 ? 2 : c == 8 ? 3 : 4;
  table[slot]<<<blocks_for(a.n, a.H), kWarps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

void (*const kFwd[5])(Fwd) = {
    gat_attn_fwd_kernel<1>, gat_attn_fwd_kernel<2>, gat_attn_fwd_kernel<4>,
    gat_attn_fwd_kernel<8>, gat_attn_fwd_kernel<16>};
void (*const kDst[5])(Bwd) = {
    gat_attn_dst_kernel<1>, gat_attn_dst_kernel<2>, gat_attn_dst_kernel<4>,
    gat_attn_dst_kernel<8>, gat_attn_dst_kernel<16>};
void (*const kSrc[5])(Bwd) = {
    gat_attn_src_kernel<1>, gat_attn_src_kernel<2>, gat_attn_src_kernel<4>,
    gat_attn_src_kernel<8>, gat_attn_src_kernel<16>};

}  // namespace

// The forward over A: out (n, H, F) and lse (n, H).
extern "C" int repro_gat_attn_fwd(const void* z, const void* u, const void* v,
                                  void* out, void* lse, const long long* graph,
                                  int n, int H, int F, void* stream) {
  Fwd a{static_cast<const float*>(z), static_cast<const float*>(u),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), {}, n, H, F};
  if (!read_graph(graph, &a.g)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kFwd, a, static_cast<cudaStream_t>(stream));
}

// The backward's pass over A: d (n, H) and dv (n, H).
extern "C" int repro_gat_attn_dst(const void* z, const void* u, const void* v,
                                  const void* lse, const void* go, void* d,
                                  void* dv, const long long* graph, int n,
                                  int H, int F, void* stream) {
  Bwd a{static_cast<const float*>(z), static_cast<const float*>(u),
        static_cast<const float*>(v), static_cast<const float*>(lse),
        static_cast<const float*>(go), static_cast<float*>(d),
        static_cast<float*>(dv), nullptr, nullptr, {}, n, H, F};
  if (!read_graph(graph, &a.g)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kDst, a, static_cast<cudaStream_t>(stream));
}

// The backward's pass over A^T, after the dst pass: dz (n, H, F), du (n, H).
extern "C" int repro_gat_attn_src(const void* z, const void* u, const void* v,
                                  const void* lse, const void* go,
                                  const void* d, void* dz, void* du,
                                  const long long* graph, int n, int H, int F,
                                  void* stream) {
  Bwd a{static_cast<const float*>(z), static_cast<const float*>(u),
        static_cast<const float*>(v), static_cast<const float*>(lse),
        static_cast<const float*>(go), const_cast<float*>(
            static_cast<const float*>(d)), nullptr,
        static_cast<float*>(dz), static_cast<float*>(du), {}, n, H, F};
  if (!read_graph(graph, &a.g)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kSrc, a, static_cast<cudaStream_t>(stream));
}

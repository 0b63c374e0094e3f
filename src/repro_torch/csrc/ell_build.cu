// Degree-bucketed ELL of one direction of a batch's adjacency, built on the
// card from the batch's COO sorted by row (stable), in two launches:
//   `repro_ell_rows`:  each row's first sorted edge (rowptr) and each node's
//                      row count in each bucket (counts), from the keys;
//   `repro_ell_build`: for each sorted edge e,
//     idx[b][row, slot] = col[e],  w[b][row, slot] = w[e],  rid[b][row] = v
// where v is e's row, slot = (rank of e in v's row) mod K_max, and (b, row)
// is the bucket and the slot row of v's piece that holds e; a degree-0 row
// writes rid of its one empty bucket-0 row. Between the two, the wrapper
// scans the counts (one inclusive scan over all buckets, bucket after
// bucket).
//
// They replace no TPU kernel. The reference buckets each batch on the host
// (`kernels/ops.py::ell_from_coo`, numpy), and on the card that bucketing set
// the pace of LMC training on arxiv-like: the builder threads spent most of
// each slot on it, and the buckets were most of the bytes pinned and copied.
// The batch's COO is copied to the card anyway, so the card builds the
// buckets from it. The layout is the host builder's exactly: rows in (node,
// piece) order within each bucket, pieces of at most K_max edges, each piece
// in the smallest bucket that holds it, padding rows idx 0, w 0, rid n.
//
// What bounds them on an H100: memory. The buckets' fixed capacity is
// written once (zeroed by the wrapper: 0.57 GB for A and A^T of an
// arxiv-like batch) and the sorted COO of each direction is read once
// (0.08 GB): about 0.19 ms at 3.35 TB/s for that batch. These kernels' own
// share, the COO read and each edge's (idx, w) written in both directions,
// is about 0.13 GB, 0.04 ms; the zeroing is the rest. What the host sees is
// the build's launches, not its bytes: the rows kernel stands for what
// would otherwise be some twenty small PyTorch operations a direction.
//
// Design. Rows: one thread per row r (and one for the end) finds the row's
// first sorted edge and the next row's by binary search over the keys (12.7
// MB at arxiv-like, held in L2), so rows of degree 0 cost what others cost
// and no thread waits on another. (One thread per key boundary, writing
// every row that starts there, would leave one thread the tens of thousands
// of empty padding rows at a batch's end: 25 ms on an H100.) Scatter: one
// thread per sorted edge, and the first n threads also look at one row
// each. With the inclusive scan `incl`, incl - counts at (b, v) less
// first[b], the rows of the buckets before b, is node v's first slot row in
// bucket b. Nothing is counted with atomics. Consecutive edges of one row
// land in consecutive slots of one slot row, so the writes of a warp are
// mostly contiguous. A row id outside [0, n), or a slot row outside its
// bucket's capacity (a plan that does not match the COO), is skipped:
// nothing is written out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 4;
constexpr int kThreads = 256;

struct Layout {
  int nb;
  int k[kMaxBuckets];         // widths K_b, ascending
  int cap[kMaxBuckets];       // padded rows of each bucket
  int first[kMaxBuckets];     // rows of the buckets before b
  int row_off[kMaxBuckets];   // bucket b's first element of rid
  long long idx_off[kMaxBuckets];   // ... of idx and wout
};

struct RowsArgs {
  const int32_t* key;   // (E,) row of each edge, sorted ascending
  int32_t* rowptr;      // (n + 1,) out: first sorted edge of each row
  int32_t* counts;      // (nb * n,) out: node v's rows in bucket b at b*n+v
  int E, n;
  Layout l;
};

struct Args {
  const int32_t* key;     // (E,) row of each edge, sorted ascending
  const int32_t* col;     // (E,) gather id of each edge, in key's order
  const float* w;         // (E,) weight of each edge, in key's order
  const int32_t* rowptr;  // (n + 1,) first sorted edge of each row
  const int32_t* counts;  // (nb * n,) each node's rows per bucket
  const int32_t* incl;    // (nb * n,) inclusive scan of counts
  int32_t* idx;           // every bucket's (cap_b, K_b), flat
  float* wout;            // the same layout as idx
  int32_t* rid;           // every bucket's (cap_b,), flat
  int E, n;
  Layout l;
};

// The first sorted edge whose key is at least r (E if none).
__device__ __forceinline__ int lower_bound(const int32_t* key, int E, int r) {
  int l = 0, h = E;
  while (l < h) {
    const int m = l + (h - l) / 2;
    if (key[m] < r) l = m + 1; else h = m;
  }
  return l;
}

// The bucket of a node's last piece of `len` edges: the smallest that fits.
__device__ __forceinline__ int bucket_of(const Layout& l, int len) {
  int b = 0;
  while (b < l.nb - 1 && len > l.k[b]) ++b;
  return b;
}

__global__ void __launch_bounds__(kThreads) ell_rows_kernel(
    const RowsArgs a) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (r > a.n) return;
  const int row = static_cast<int>(r);
  const int lo = lower_bound(a.key, a.E, row);
  a.rowptr[row] = lo;
  if (row == a.n) return;
  const int kmax = a.l.k[a.l.nb - 1];
  const int deg = lower_bound(a.key, a.E, row + 1) - lo;
  const int pieces = deg > 0 ? (deg + kmax - 1) / kmax : 1;
  const int last = bucket_of(a.l, deg - (pieces - 1) * kmax);
  for (int b = 0; b < a.l.nb; ++b)
    a.counts[static_cast<long long>(b) * a.n + row] =
        (b == last) + (b == a.l.nb - 1 ? pieces - 1 : 0);
}

// Node v's first slot row in bucket b.
__device__ __forceinline__ int first_row(const Args& a, int b, int v) {
  const long long at = static_cast<long long>(b) * a.n + v;
  return a.incl[at] - a.counts[at] - a.l.first[b];
}

__global__ void __launch_bounds__(kThreads) ell_build_kernel(const Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int nb = a.l.nb, kmax = a.l.k[nb - 1];
  if (i < a.E) {
    const int v = a.key[i];
    if (v >= 0 && v < a.n) {
      const int lo = a.rowptr[v];
      const int deg = a.rowptr[v + 1] - lo;
      const int rank = static_cast<int>(i) - lo;
      const int piece = rank / kmax;
      const int slot = rank - piece * kmax;
      const int pieces = (deg + kmax - 1) / kmax;
      // full pieces and a full last piece sit in the widest bucket, one
      // slot row each in piece order; a shorter last piece is the node's
      // only row in its bucket
      const int b = piece == pieces - 1
                    ? bucket_of(a.l, deg - piece * kmax) : nb - 1;
      const int row = first_row(a, b, v) + (b == nb - 1 ? piece : 0);
      if (row >= 0 && row < a.l.cap[b]) {
        const long long at = a.l.idx_off[b]
                             + static_cast<long long>(row) * a.l.k[b] + slot;
        a.idx[at] = a.col[i];
        a.wout[at] = a.w[i];
        if (slot == 0) a.rid[a.l.row_off[b] + row] = v;
      }
    }
  }
  if (i < a.n && a.rowptr[i + 1] == a.rowptr[i]) {   // degree 0: bucket 0
    const int row = first_row(a, 0, static_cast<int>(i));
    if (row >= 0 && row < a.l.cap[0])
      a.rid[a.l.row_off[0] + row] = static_cast<int>(i);
  }
}

bool read_layout(int nb, const long long* host, Layout* l) {
  if (nb < 1 || nb > kMaxBuckets) return false;
  l->nb = nb;
  for (int b = 0; b < kMaxBuckets; ++b) {
    l->k[b] = static_cast<int>(host[b]);
    l->cap[b] = static_cast<int>(host[kMaxBuckets + b]);
    l->first[b] = static_cast<int>(host[2 * kMaxBuckets + b]);
    l->row_off[b] = static_cast<int>(host[3 * kMaxBuckets + b]);
    l->idx_off[b] = host[4 * kMaxBuckets + b];
  }
  return l->k[nb - 1] > 0;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Device pointers, contiguous:
// key, col: (E,) int32 sorted by key; w: (E,) f32; rowptr: (n + 1,) int32;
// counts, incl: (nb * n,) int32; idx: int32 and wout: f32, bucket b's
// (cap_b, k_b) at element idx_off_b, zeroed; rid: int32, bucket b's (cap_b,)
// at element row_off_b, filled with n. `layout` is a host array of 5 * 4
// values: the widths k_b (ascending), cap_b, first_b, row_off_b and
// idx_off_b, each padded to four (slots past nb are not read); nb is 1 to
// 4. Each launches on `stream` and returns the CUDA error (0 on success).

// rowptr and counts of the sorted keys.
extern "C" int repro_ell_rows(const void* key, void* rowptr, void* counts,
                              int E, int n, int nb, const long long* layout,
                              void* stream) {
  RowsArgs a{static_cast<const int32_t*>(key), static_cast<int32_t*>(rowptr),
             static_cast<int32_t*>(counts), E, n, {}};
  if (E < 0 || n < 0 || !read_layout(nb, layout, &a.l))
    return static_cast<int>(cudaErrorInvalidValue);
  ell_rows_kernel<<<blocks_for(static_cast<long long>(n) + 1), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Every sorted edge into its bucket; incl is counts' inclusive scan.
extern "C" int repro_ell_build(const void* key, const void* col,
                               const void* w, const void* rowptr,
                               const void* counts, const void* incl,
                               void* idx, void* wout, void* rid, int E, int n,
                               int nb, const long long* layout,
                               void* stream) {
  Args a{static_cast<const int32_t*>(key), static_cast<const int32_t*>(col),
         static_cast<const float*>(w), static_cast<const int32_t*>(rowptr),
         static_cast<const int32_t*>(counts),
         static_cast<const int32_t*>(incl), static_cast<int32_t*>(idx),
         static_cast<float*>(wout), static_cast<int32_t*>(rid), E, n, {}};
  if (E < 0 || n < 0 || !read_layout(nb, layout, &a.l))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = E > n ? E : n;
  if (threads == 0) return 0;
  ell_build_kernel<<<blocks_for(threads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// LT encode out[j] = sum_d coeffs[j,d] * A[indices[j,d]] (fp32), in table order.
//
// Replaces the Pallas TPU kernel repro/kernels/lt_encode.py ::
// lt_encode_pallas (def :61, pallas_call :74).  On the task form's path it
// encodes the reserve rows of an LT plan, plan rows [static_rows, capacity),
// on the device (repro_torch.kernels.ops.encode_rows, called by
// ClusterEmulator.run_task).  A [r, M] is the source, out [q, M] the coded
// rows.  The wrapper (kernels/lt_encode.py::_lt_csr) hands over the degree
// table compacted into CSR: row_ptr [q + 1] int64, and cols [nnz] int32 /
// vals [nnz] fp32 holding only the nonzero entries of each row, in table
// order; and order [q] int32, the rows by degree, largest first.
//
// What bounds it on an H100: memory.  Each nonzero entry reads one row of A
// (M floats) and spends one multiply and one add per float.  The least
// bytes are each input read once and each output written once: the rows of
// A the table references (u of them) plus out, (u + q)*M*4 + the table, over
// 3.35 TB/s.  At the task's reserve slice (u = 4,842, nnz = 16,811, q =
// 2,672, M = 500,000) that is 4.5 ms; a kernel that reads A anew for every
// entry moves 11.6 ms of bytes.  Reading each used row once needs the L2
// (50 MB; A is 10 GB): every coded row that uses a source row must read it
// while the row is still there.  Even then 16,811 x 2 MB = 33.6 GB pass
// from the L2 to the SMs.
//
// Design, for that bound:
//  * Never stream padding: a row reads A only for its nonzero entries (the
//    Pallas grid moves a panel of A for every table entry, padding
//    included).  Skipping the 0*A[0] terms gives the same sum for finite A.
//  * Narrow column spans (W = 128 kSpanQuads = 128 columns), walked in
//    order: a span's slab of the used rows of A is u x 4W
//    bytes (2.5 MB).  The work of a span is cut into units, and the warps
//    of a persistent grid take units in order from an atomic counter
//    (zeroed by the wrapper), so all in-flight units lie within a few spans
//    and their slabs stay in the L2.  A static grid-stride walk would not:
//    the table's degrees run from 1 to 595, so warps drift apart by hundreds
//    of spans.  Of 128, 256, 512 and 1,024 columns and 8, 16 or 32 light
//    rows a unit, 128 and 16 were fastest at the task's shape
//    (chip_smoke.py --sweep-lt, which builds those variants of this file).
//  * Two kinds of unit.  A heavy unit is one 32-column slice of a heavy row
//    (degree above the wrapper's threshold, 64; 45 rows hold 58 % of the
//    task's entries): one float per lane and 32 entries' loads in flight,
//    so such a row keeps pace with the light ones instead of holding a slab
//    for tens of microseconds.  Heavy units come first in each span.  A
//    light unit is a chunk of up to kRowsPerChunk of the other rows (ranks
//    first, first + C, ... of them, C chunks a span) over the whole span:
//    each lane owns a column quad (float4 loads where M % 4 == 0 and the
//    pointers are 16-byte aligned; 4 scalar columns 32 apart otherwise).
//    The chunk's entries are walked as one list, so 8 float4 loads are in
//    flight across row ends: most light rows have 1-3 entries, and a warp
//    that waited a round trip per row was latency-bound.
//  * Lanes load 32 (col, val) pairs at once, coalesced, the next 32 while
//    the current ones run, and pass them on with __shfl_sync.
//  * out is stored with an evict-first hint (__stcs), so the coded rows do
//    not push A's slab out of the L2.
//  * The sum is taken as acc = acc + (v * a), each step rounded
//    (__fmul_rn, __fadd_rn, so no FMA contraction), per element in table
//    order: the plain PyTorch version (kernels/ref.py::ref_lt_encode)
//    computes the same sequence, so the two agree bit for bit on the card.
//    Which warp computes which element changes nothing of that.
//  * 64-bit offsets for index*M and j*M (5,000 x 500,000 > 2^31).  A
//    degree-0 row writes zeros.
//  * The launch geometry (spans, chunks a span, the persistent grid from
//    the occupancy) is computed by lt_encode() below from these constants.
// On an H100 80GB HBM3 (700 W) at the task's reserve slice the wrapper's
// call (compaction and kernel) takes 8.70 ms, where the first port's call
// (one block per row and 1,024-column span) took 12.26 ms; the kernel
// alone takes 8.22 ms, 55 % of the read-once bound, against 10.41 ms for
// torch.sparse.mm on the same CSR (chip_smoke.py).  What is left is reuse
// inside an SM (a span's slab staged once per SM): every entry still reads
// its row of A from the L2, 33.6 GB, and wider spans or more rows per unit
// did not help.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps, each taking units on its own
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSpanQuads = 1;          // column quads a lane owns in a span
constexpr int kSpan = 128 * kSpanQuads;  // columns of a span
constexpr int kSlices = kSpan / 32;    // 32-column units of a heavy row in a span
constexpr int kRowsPerChunk = 16;      // light rows a unit takes
static_assert(kRowsPerChunk >= 1 && kRowsPerChunk <= 32, "a chunk's rows are a warp's lanes");

// columns lane owns in a span starting at c0: VEC4, quad p at
// c0 + 128 p + 4 lane; scalar, column s at c0 + 32 s + lane (s < 4 kSpanQuads)
template <bool VEC4>
__device__ __forceinline__ void load_span(float4 (&x)[kSpanQuads], const float* __restrict__ row,
                                          int64_t c0, int lane, int64_t m) {
#pragma unroll
  for (int p = 0; p < kSpanQuads; ++p) {
    if (VEC4) {
      const int64_t c = c0 + 128 * p + 4 * lane;
      x[p] = c < m ? __ldg(reinterpret_cast<const float4*>(row + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const int64_t c = c0 + 128 * p + lane;
      x[p].x = c < m ? __ldg(row + c) : 0.f;
      x[p].y = c + 32 < m ? __ldg(row + c + 32) : 0.f;
      x[p].z = c + 64 < m ? __ldg(row + c + 64) : 0.f;
      x[p].w = c + 96 < m ? __ldg(row + c + 96) : 0.f;
    }
  }
}

template <bool VEC4>
__device__ __forceinline__ void store_span(float* __restrict__ row, int64_t c0, int lane,
                                           int64_t m, const float (&acc)[4 * kSpanQuads]) {
#pragma unroll
  for (int p = 0; p < kSpanQuads; ++p) {
    if (VEC4) {
      const int64_t c = c0 + 128 * p + 4 * lane;
      if (c < m)
        __stcs(reinterpret_cast<float4*>(row + c),
               make_float4(acc[4 * p], acc[4 * p + 1], acc[4 * p + 2], acc[4 * p + 3]));
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int64_t c = c0 + 128 * p + 32 * s + lane;
        if (c < m) __stcs(row + c, acc[4 * p + s]);
      }
    }
  }
}

__device__ __forceinline__ void add_scaled(float& acc, float v, float x) {
  acc = __fadd_rn(acc, __fmul_rn(v, x));
}

// The entries [e0, e0 + 32) of a row that ends at end, lane l holding entry
// e0 + l (zero past the end).
__device__ __forceinline__ void fetch_entries(const int* __restrict__ cols,
                                              const float* __restrict__ vals, int64_t e0,
                                              int64_t end, int lane, int& col, float& val) {
  col = 0;
  val = 0.f;
  if (e0 + lane < end) {
    col = cols[e0 + lane];
    val = vals[e0 + lane];
  }
}

// One 32-column slice of a heavy row: lane owns column col.
__device__ void heavy_unit(const float* __restrict__ a, const int64_t* __restrict__ row_ptr,
                           const int* __restrict__ cols, const float* __restrict__ vals,
                           float* __restrict__ out, int j, int64_t col, int64_t m, int lane) {
  const int64_t beg = row_ptr[j], end = row_ptr[j + 1];
  int cc;
  float cv;
  fetch_entries(cols, vals, beg, end, lane, cc, cv);
  float acc = 0.f;
  for (int64_t e0 = beg; e0 < end; e0 += 32) {
    const int n = static_cast<int>(end - e0 < 32 ? end - e0 : 32);
    int nc;
    float nv;
    fetch_entries(cols, vals, e0 + 32, end, lane, nc, nv);  // in flight during this batch
    float x[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int src = __shfl_sync(kAll, cc, u);
      x[u] = (u < n && col < m) ? __ldg(a + static_cast<int64_t>(src) * m + col) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float v = __shfl_sync(kAll, cv, u);
      if (u < n) add_scaled(acc, v, x[u]);
    }
    cc = nc;
    cv = nv;
  }
  if (col < m) __stcs(out + static_cast<int64_t>(j) * m + col, acc);
}

// A chunk of light rows over the span at c0: ranks first, first + chunks,
// ... of light_order (n_light rows).  The chunk's entries are walked as one
// list (row 0's in table order, then row 1's, ...), so the loads of E
// entries are in flight together whatever the rows' degrees; a row's sum
// is stored when its last entry is in.
template <bool VEC4>
__device__ void light_unit(const float* __restrict__ a, const int64_t* __restrict__ row_ptr,
                           const int* __restrict__ cols, const float* __restrict__ vals,
                           const int* __restrict__ light_order, float* __restrict__ out,
                           int n_light, int chunks, int first, int64_t c0, int64_t m,
                           int lane) {
  constexpr int E = kSpanQuads >= 8 ? 1 : 8 / kSpanQuads;  // entries loaded together
  const int n_rows = (n_light - first + chunks - 1) / chunks;  // <= kRowsPerChunk
  // lane i < n_rows: row i of the chunk, its entries [my_beg, my_beg + my_deg)
  // of the CSR and [my_off, my_off + my_deg) of the chunk's list
  int my_j = 0, my_deg = 0;
  int64_t my_beg = 0;
  if (lane < n_rows) {
    my_j = light_order[first + lane * chunks];
    my_beg = row_ptr[my_j];
    my_deg = static_cast<int>(row_ptr[my_j + 1] - my_beg);
  }
  int my_off = my_deg;  // inclusive scan, then exclusive
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kAll, my_off, d);
    if (lane >= d) my_off += up;
  }
  const int total = __shfl_sync(kAll, my_off, 31);
  my_off -= my_deg;

  float acc[4 * kSpanQuads];
#pragma unroll
  for (int s = 0; s < 4 * kSpanQuads; ++s) acc[s] = 0.f;
  for (unsigned empty = __ballot_sync(kAll, lane < n_rows && my_deg == 0); empty;
       empty &= empty - 1)  // degree-0 rows write zeros
    store_span<VEC4>(out + static_cast<int64_t>(__shfl_sync(kAll, my_j, __ffs(empty) - 1)) * m,
                        c0, lane, m, acc);
  if (total == 0) return;

  // the row that holds list entry t: the last row i with my_off(i) <= t
  auto row_of = [&](int t) {
    int i = 0;
#pragma unroll
    for (int step = 16; step >= 1; step /= 2) {
      const int off = __shfl_sync(kAll, my_off, i + step);
      if (i + step < n_rows && off <= t) i += step;
    }
    return i;
  };
  // lane l holds list entry t0 + l (zero past the end)
  auto fetch = [&](int t0, int& col, float& val) {
    const int t = t0 + lane, i = row_of(t);
    const int64_t e = __shfl_sync(kAll, my_beg, i) + (t - __shfl_sync(kAll, my_off, i));
    col = 0;
    val = 0.f;
    if (t < total) {
      col = cols[e];
      val = vals[e];
    }
  };
  int cc, nc = 0;
  float cv, nv = 0.f;
  fetch(0, cc, cv);
  int cur = row_of(0);  // the row being summed, its list end and output row
  int cur_end = __shfl_sync(kAll, my_off + my_deg, cur);
  int cur_j = __shfl_sync(kAll, my_j, cur);
  for (int t0 = 0; t0 < total; t0 += E) {
    if (t0 % 32 == 0) {
      if (t0 > 0) {
        cc = nc;
        cv = nv;
      }
      if (t0 + 32 < total) fetch(t0 + 32, nc, nv);  // in flight during these 32
    }
    float4 x[E][kSpanQuads];
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const int src = __shfl_sync(kAll, cc, (t0 + u) & 31);
      if (t0 + u < total) load_span<VEC4>(x[u], a + static_cast<int64_t>(src) * m, c0, lane, m);
    }
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const float v = __shfl_sync(kAll, cv, (t0 + u) & 31);
      if (t0 + u < total) {
#pragma unroll
        for (int p = 0; p < kSpanQuads; ++p) {
          add_scaled(acc[4 * p + 0], v, x[u][p].x);
          add_scaled(acc[4 * p + 1], v, x[u][p].y);
          add_scaled(acc[4 * p + 2], v, x[u][p].z);
          add_scaled(acc[4 * p + 3], v, x[u][p].w);
        }
        if (t0 + u + 1 == cur_end) {  // the row is complete
          store_span<VEC4>(out + static_cast<int64_t>(cur_j) * m, c0, lane, m, acc);
#pragma unroll
          for (int s = 0; s < 4 * kSpanQuads; ++s) acc[s] = 0.f;
          do {
            ++cur;
          } while (cur < n_rows && __shfl_sync(kAll, my_deg, cur) == 0);
          cur_end = __shfl_sync(kAll, my_off + my_deg, cur);
          cur_j = __shfl_sync(kAll, my_j, cur);
        }
      }
    }
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
lt_encode_kernel(const float* __restrict__ a, const int64_t* __restrict__ row_ptr,
                 const int* __restrict__ cols, const float* __restrict__ vals,
                 const int* __restrict__ order, float* __restrict__ out, int q, int64_t m,
                 int64_t n_spans, int n_heavy, int chunks,
                 unsigned long long* __restrict__ next_unit) {
  const int lane = threadIdx.x & 31;
  const int64_t heavy_units = static_cast<int64_t>(n_heavy) * kSlices;
  const unsigned long long per_span = static_cast<unsigned long long>(heavy_units + chunks);
  const unsigned long long n_units = static_cast<unsigned long long>(n_spans) * per_span;

  unsigned long long unit = 0;
  if (lane == 0) unit = atomicAdd(next_unit, 1ull);
  unit = __shfl_sync(kAll, unit, 0);
  while (unit < n_units) {
    unsigned long long next = 0;
    if (lane == 0) next = atomicAdd(next_unit, 1ull);  // in flight while this unit runs
    const int64_t c0 = static_cast<int64_t>(unit / per_span) * kSpan;
    const int64_t k = static_cast<int64_t>(unit % per_span);
    if (k < heavy_units)
      heavy_unit(a, row_ptr, cols, vals, out, order[k / kSlices],
                 c0 + (k % kSlices) * 32 + lane, m, lane);
    else
      light_unit<VEC4>(a, row_ptr, cols, vals, order + n_heavy, out, q - n_heavy, chunks,
                       static_cast<int>(k - heavy_units), c0, m, lane);
    unit = __shfl_sync(kAll, next, 0);
  }
}

}  // namespace

// a [r, m] fp32; row_ptr [q + 1] int64; cols [nnz] int32 (each in [0, r));
// vals [nnz] fp32; order [q] int32, a permutation of the rows whose first
// n_heavy are the heavy ones; out [q, m] fp32 — contiguous, on the current
// device; next_unit one zeroed counter.  The float4 variant runs where
// m % 4 == 0 and a and out are 16-byte aligned.  Spans, chunks and the
// persistent grid (as many blocks as fit on every SM, or fewer where there
// are fewer units than warps) are computed here.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int lt_encode(const float* a, const long long* row_ptr, const int* cols,
                         const float* vals, const int* order, float* out, int q, long long m,
                         int n_heavy, unsigned long long* next_unit, void* stream) {
  if (q < 1 || m < 1 || n_heavy < 0 || n_heavy > q || next_unit == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = m % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const void* fn = vec4 ? reinterpret_cast<const void*>(&lt_encode_kernel<true>)
                        : reinterpret_cast<const void*>(&lt_encode_kernel<false>);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int chunks = (q - n_heavy + kRowsPerChunk - 1) / kRowsPerChunk;
  const long long n_spans = (m + kSpan - 1) / kSpan;
  const long long units = n_spans * (static_cast<long long>(n_heavy) * kSlices + chunks);
  const long long warps = (units + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(warps < static_cast<long long>(sms) * per_sm
                                        ? warps : static_cast<long long>(sms) * per_sm);
  const int64_t* rp = reinterpret_cast<const int64_t*>(row_ptr);
  void* args[] = {&a, &rp, &cols, &vals, &order, &out, &q, &m,
                  const_cast<long long*>(&n_spans), &n_heavy, const_cast<int*>(&chunks),
                  &next_unit};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// LT encode out[j] = sum_d coeffs[j,d] * A[indices[j,d]] (fp32), in table order.
//
// Replaces the Pallas TPU kernel repro/kernels/lt_encode.py ::
// lt_encode_pallas.  On the task form's path it encodes the reserve rows of
// an LT plan, plan rows [static_rows, capacity), on the device
// (repro_torch.kernels.ops.encode_rows, called by ClusterEmulator.run_task).
// A [r, M] is the source, out [q, M] the coded rows.  The wrapper
// (kernels/lt_encode.py) hands over the degree table compacted into CSR:
// row_ptr [q + 1] int64, and cols [nnz] int32 / vals [nnz] fp32 holding
// only the nonzero entries of each row, in table order.
//
// What bounds it on an H100: memory.  Each nonzero entry streams one row of
// A (M floats) and spends one multiply and one add per float.  The least
// bytes are each input read once and each output written once: the rows
// of A the table references (u of them) plus out, (u + q)*M*4 + the table,
// over 3.35 TB/s.  A kernel that gets no reuse from the L2 moves
// nnz*M*4 + q*M*4 instead: A (10 GB at the paper's r = 5,000, M = 500,000)
// is far larger than the 50 MB L2.  At the task's reserve slice u = 4,842
// rows, nnz = 16,811 and q = 2,672: 4.5 ms read once, 11.6 ms with no
// reuse.
//
// Design, for that bound:
//  * Never stream padding.  The TPU grid is (q, M/BM, d_max) and moves a
//    panel of A for every table entry, padding (coefficient 0, row 0)
//    included; an LT plan's d_max is its largest degree, over 100x its mean.
//    Here a row reads A only for its nonzero entries.  Skipping the 0*A[0]
//    terms gives the same sum for finite A.  Zeros may sit anywhere in a
//    row; the CSR compaction keeps the nonzeros' table order.
//  * One block per (row j, span of 1024 columns).  The block stages the
//    row's entries in shared memory, 256 at a time, once, and each thread
//    keeps 4 columns of the sum in registers while it walks the entries:
//    one 16-byte load per entry (float4 where M % 4 == 0 and the pointers
//    are 16-byte aligned, scalar loads otherwise), coalesced across the
//    warp, four entries unrolled so their loads are in flight together.
//    Each output element is written once.
//  * Rows are the grid's fastest axis, so the resident blocks work on the
//    same column span: its slab of A (r x 4 KB, 20 MB at r = 5,000) can
//    stay in the 50 MB L2 while the several coded rows that use one source
//    row read it.  On an H100 (700 W) at the task's reserve slice (q =
//    2,672, 16,811 nonzeros, M = 500,000) the wrapper's call took 13.1 ms
//    this way and 14.2 ms with spans fastest and 4096 columns a block
//    (chip_smoke.py; the wrapper's CSR compaction included).
//  * The sum is taken as acc = acc + (v * a), each step rounded
//    (__fmul_rn, __fadd_rn, so no FMA contraction): the plain PyTorch
//    version (kernels/ref.py::ref_lt_encode) computes the same sequence,
//    so the two agree bit for bit on the card.
//  * 64-bit offsets for index*M and j*M (5,000 x 500,000 > 2^31).  Spans
//    beyond 65,535 loop over gridDim.y.  A degree-0 row writes zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                    // columns per thread
constexpr int kSpan = kThreads * kPerThread;     // 1024 columns per block
constexpr int kStage = 256;                      // table entries staged at a time

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
lt_encode_kernel(const float* __restrict__ a, const int64_t* __restrict__ row_ptr,
                 const int* __restrict__ cols, const float* __restrict__ vals,
                 float* __restrict__ out, int64_t m, int64_t n_spans) {
  __shared__ int s_col[kStage];
  __shared__ float s_val[kStage];
  const int j = blockIdx.x;
  const int64_t beg = row_ptr[j], end = row_ptr[j + 1];
  float* dst = out + static_cast<int64_t>(j) * m;

  for (int64_t span = blockIdx.y; span < n_spans; span += gridDim.y) {
    const int64_t c0 = span * kSpan;
    float acc[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) acc[u] = 0.f;

    for (int64_t e0 = beg; e0 < end; e0 += kStage) {
      const int n = static_cast<int>(end - e0 < kStage ? end - e0 : kStage);
      __syncthreads();  // the previous stage has been read by every thread
      for (int t = threadIdx.x; t < n; t += kThreads) {
        s_col[t] = cols[e0 + t];
        s_val[t] = vals[e0 + t];
      }
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < n; ++e) {
        const float v = s_val[e];
        const float* src = a + static_cast<int64_t>(s_col[e]) * m;
        if (VEC4) {
          // thread owns columns c0 + 4*tid .. c0 + 4*tid + 3
          const int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * 4;
          if (c < m) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(src + c));
            acc[0] = __fadd_rn(acc[0], __fmul_rn(v, x.x));
            acc[1] = __fadd_rn(acc[1], __fmul_rn(v, x.y));
            acc[2] = __fadd_rn(acc[2], __fmul_rn(v, x.z));
            acc[3] = __fadd_rn(acc[3], __fmul_rn(v, x.w));
          }
        } else {
          // thread owns columns c0 + u*kThreads + tid, u = 0..3
#pragma unroll
          for (int u = 0; u < kPerThread; ++u) {
            const int64_t c = c0 + static_cast<int64_t>(u) * kThreads + threadIdx.x;
            if (c < m) acc[u] = __fadd_rn(acc[u], __fmul_rn(v, __ldg(src + c)));
          }
        }
      }
    }

    if (VEC4) {
      const int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * 4;
      if (c < m)
        *reinterpret_cast<float4*>(dst + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int64_t c = c0 + static_cast<int64_t>(u) * kThreads + threadIdx.x;
        if (c < m) dst[c] = acc[u];
      }
    }
  }
}

}  // namespace

// a [r, m] fp32; row_ptr [q + 1] int64; cols [nnz] int32 (each in [0, r));
// vals [nnz] fp32; out [q, m] fp32 — contiguous, on the current device.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes the kernel does not take).
extern "C" int lt_encode(const float* a, const long long* row_ptr, const int* cols,
                         const float* vals, float* out, int q, long long m, void* stream) {
  if (q < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_spans = (m + kSpan - 1) / kSpan;
  const dim3 grid(static_cast<unsigned>(q),
                  static_cast<unsigned>(n_spans < 65535 ? n_spans : 65535));
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t* rp = reinterpret_cast<const int64_t*>(row_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    lt_encode_kernel<true><<<grid, kThreads, 0, s>>>(a, rp, cols, vals, out, m, n_spans);
  else
    lt_encode_kernel<false><<<grid, kThreads, 0, s>>>(a, rp, cols, vals, out, m, n_spans);
  return static_cast<int>(cudaGetLastError());
}

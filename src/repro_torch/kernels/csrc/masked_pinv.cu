// Masked pseudo-inverse of the coded head's generator, on the device:
//   rec = pinv(diag(m) B, rtol 1e-6) diag(m)   (fp32 out, float64 inside)
//
// Replaces no TPU kernel: the reference computes this in jnp
// (repro/core/coded_ops.py :: decode_blocks_svd, jnp.linalg.pinv).  It is
// the recovery matrix of every coded-head decode that the DecoderCache does
// not serve (the 'svd' head mode, geometries with more patterns than the
// cache holds), which the fused decode kernel (coded_decode.cu) then takes.
// A library factorization (torch.linalg.pinv / svd) synchronizes the device
// with the host on every call, so it can sit neither in a CUDA graph nor on
// a decode step that should not stall the host; this kernel can.
//
// B [nb, n] float64 row-major (n = n_data <= nb code blocks), mask [M, nb]
// fp32 (M masks, one thread block each), rec [M, n, nb] fp32.
//
// What bounds it on an H100: neither bytes nor operations.  A serving head
// is tiny (16 x 10 at (10, 6): 1.3 KB of B, a few hundred thousand float64
// operations at most), so the time is the latency of one block walking its
// sweeps in order: barriers, warp reductions and the float64 pipe's
// latency.  It is launched once a decode step, beside a head matmul of
// hundreds of microseconds.
//
// Design (simple and exact first):
//  * One-sided (Hestenes) Jacobi SVD of A = diag(m) B in float64, in shared
//    memory: A's columns are rotated in pairs until every pair is
//    orthogonal; V (n x n, from the identity) takes the same rotations, so
//    A_orig V = A and the columns a_j of A are sigma_j u_j.
//  * Pairs in round-robin order (the circle method over n rounded up to
//    even; a pair with the padding column is skipped), one warp a pair, the
//    pairs of a round disjoint, a barrier between rounds.  Each lane sums
//    its rows and a butterfly of shuffles adds the lanes: a fixed order, so
//    every lane holds the same bits and two calls on one mask give the same
//    result bit for bit.
//  * A pair is left alone where |a_p . a_q| <= nb * eps * |a_p| |a_q|, or
//    where a column's squared norm is at most 1e-30 of A's squared
//    Frobenius norm (a column that far under the cutoff below is dropped
//    anyway).  Sweeps run until one rotates nothing, at most kMaxSweeps:
//    the loop stays inside the kernel, with no host read.
//  * sigma_j = |a_j|; columns with sigma_j > 1e-6 max sigma are kept (the
//    rtol rule of torch.linalg.pinv and of the reference's jnp.linalg.pinv),
//    and rec = sum_j v_j a_j^T / sigma_j^2, times m, cast to fp32.  It is
//    good to about cond(A) eps of |rec| (1.1e-12 at the worst (10, 6)
//    pattern, cond 4.6e4), far under the fp32 cast's 6e-8.  An erased row of
//    A is zero and stays zero through every rotation, so rec's erased
//    columns are exactly zero; a mask with fewer than n survivors gets the
//    least-norm pseudo-inverse, as in the reference.
//  * A, V and |a_j|^2 live in dynamic shared memory, (n nb + n n + n) * 8
//    bytes: 2.2 KB at (10, 6).  The wrapper (kernels/masked_pinv.py)
//    refuses what the opt-in 227 KB cannot hold.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxSweeps = 30;    // kernels/masked_pinv.py::MAX_SWEEPS
constexpr double kRtol = 1e-6;    // torch.linalg.pinv's rtol, as the reference passes it
constexpr double kTiny = 1e-30;   // a column's |a|^2 under this share of |A|_F^2 is not rotated

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pair k of round r among np (even) columns, the circle method: column
// np - 1 stays, the others turn.  Every round pairs each column once.
__device__ __forceinline__ void round_robin(int r, int k, int np, int& p, int& q) {
  const int turn = np - 1;
  const int a = k == 0 ? turn : (r + k) % turn;
  const int b = k == 0 ? r : (r - k + turn) % turn;
  p = min(a, b);
  q = max(a, b);
}

__global__ void masked_pinv_kernel(const float* __restrict__ mask,
                                   const double* __restrict__ gen, float* __restrict__ rec,
                                   int* __restrict__ sweeps_out, int nb, int n) {
  extern __shared__ double smem[];
  double* a = smem;             // [n][nb]: column j of diag(m) B at a + j * nb
  double* v = a + n * nb;       // [n][n]: column j of V at v + j * n
  double* norm2 = v + n * n;    // [n]: |a_j|^2 after the sweeps
  __shared__ int rotated;
  __shared__ double frob2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* m = mask + static_cast<int64_t>(blockIdx.x) * nb;
  float* out = rec + static_cast<int64_t>(blockIdx.x) * n * nb;

  for (int idx = tid; idx < n * nb; idx += blockDim.x) {
    const int j = idx / nb, r = idx - j * nb;
    a[idx] = static_cast<double>(m[r]) * gen[r * n + j];
  }
  for (int idx = tid; idx < n * n; idx += blockDim.x) v[idx] = (idx / n == idx % n) ? 1.0 : 0.0;
  __syncthreads();
  if (warp == 0) {
    double s = 0.0;
    for (int idx = lane; idx < n * nb; idx += 32) s += a[idx] * a[idx];
    s = warp_sum(s);
    if (lane == 0) frob2 = s;
  }
  __syncthreads();
  const double tiny = kTiny * frob2;
  const double tol = nb * DBL_EPSILON;
  const int np = n + (n & 1);
  const int pairs = np / 2;

  int sweeps = 0;
  while (sweeps < kMaxSweeps) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (int r = 0; r < np - 1; ++r) {
      for (int k = warp; k < pairs; k += n_warps) {
        int p, q;
        round_robin(r, k, np, p, q);
        if (q >= n) continue;  // the padding column of an odd n
        double* ap = a + p * nb;
        double* aq = a + q * nb;
        double al = 0.0, be = 0.0, ga = 0.0;
        for (int i = lane; i < nb; i += 32) {
          const double x = ap[i], y = aq[i];
          al += x * x;
          be += y * y;
          ga += x * y;
        }
        al = warp_sum(al);
        be = warp_sum(be);
        ga = warp_sum(ga);
        if (al <= tiny || be <= tiny || fabs(ga) <= tol * sqrt(al) * sqrt(be)) continue;
        // the rotation that makes the pair orthogonal, the smaller angle
        const double zeta = (be - al) / (2.0 * ga);
        const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
        for (int i = lane; i < nb; i += 32) {
          const double x = ap[i], y = aq[i];
          ap[i] = c * x - s * y;
          aq[i] = s * x + c * y;
        }
        double* vp = v + p * n;
        double* vq = v + q * n;
        for (int i = lane; i < n; i += 32) {
          const double x = vp[i], y = vq[i];
          vp[i] = c * x - s * y;
          vq[i] = s * x + c * y;
        }
        if (lane == 0) rotated = 1;
      }
      __syncthreads();
    }
    ++sweeps;
    const int any = rotated;
    __syncthreads();  // every thread has read the flag before thread 0 clears it
    if (!any) break;
  }

  for (int j = warp; j < n; j += n_warps) {
    double s = 0.0;
    for (int i = lane; i < nb; i += 32) s += a[j * nb + i] * a[j * nb + i];
    s = warp_sum(s);
    if (lane == 0) norm2[j] = s;
  }
  __syncthreads();
  double max2 = 0.0;
  for (int j = 0; j < n; ++j) max2 = fmax(max2, norm2[j]);
  const double cut = kRtol * sqrt(max2);
  for (int idx = tid; idx < n * nb; idx += blockDim.x) {
    const int i = idx / nb, r = idx - i * nb;
    double s = 0.0;
    for (int j = 0; j < n; ++j) {
      if (sqrt(norm2[j]) > cut) s += v[j * n + i] * a[j * nb + r] / norm2[j];
    }
    out[idx] = static_cast<float>(s * static_cast<double>(m[r]));
  }
  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweeps;
}

}  // namespace

extern "C" {

// One launch: n_masks blocks of `threads` threads (a multiple of 32), `smem`
// bytes of dynamic shared memory each ((n nb + n n + n) * 8, checked by the
// wrapper).  sweeps_out may be null; else [n_masks] int32 gets each block's
// sweep count.  Returns the launch's cudaError_t.
int masked_pinv(const float* mask, const double* gen, float* rec, int* sweeps_out,
                int n_masks, int nb, int n, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_pinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_pinv_kernel<<<n_masks, threads, smem, stream>>>(mask, gen, rec, sweeps_out, nb, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Mamba-2 SSD intra-chunk kernels (fp32 arithmetic, no TF32).
//
// Replaces the Pallas TPU kernels repro/kernels/ssd_scan.py ::
// ssd_chunk_pallas and ssd_combine_pallas.  A cell g is one (batch, head,
// chunk) slice of Q <= 256 positions; x [G, Q, P] (pre-multiplied by dt),
// da [G, Q] fp32, b and c [G, Q, N] (head-expanded); x, b and c are fp32 or
// bf16 (read as bf16, computed in fp32).
//
//   ssd_chunk:   cum = cumsum(da); L_ls = exp(cum_l - cum_s) for l >= s, else 0
//                y_diag = (C Bᵀ ∘ L) X            [G, Q, P]
//                states = Xᵀ (exp(cum_Q - cum) ∘ B) [G, P, N]
//                decay  = exp(cum_Q) [G], cum [G, Q]
//   ssd_combine: y_off = exp(cum) ∘ (C S_inᵀ)     [G, Q, P], S_in [G, P, N] fp32
//
// What bounds them on an H100: fp32 operations, or close to balanced.  At
// mamba2-130m's widths (P 48, N 128, Q 256) a cell of ssd_chunk needs 14.7
// MFLOP (the causal half of the two Q x Q products, then the state),
// against ~230 KB moved; at 67 TFLOP/s a 4096-token prompt (512 cells)
// needs ≈ 0.11 ms.
//
// Design.  The Pallas cell holds [Q, Q] L and C·Bᵀ plus B, C and X in VMEM
// (≈ 0.85 MB at Q 256); a Hopper block has 227 KB at most, so the cell is
// tiled.  One grid row of blocks per cell (blockIdx.x = g):
//   * blockIdx.y < ceil(Q/64): a 64-row tile of y_diag.  The block walks
//     the 64-wide s-tiles up to its diagonal only (causality skips the
//     upper half), forms the C·Bᵀ tile over N in stages of 32 through
//     shared memory, selects and scales it by L (the select comes first:
//     above the diagonal exp would overflow, and inf·0 is NaN), stores it
//     transposed in shared memory and multiplies it by the staged X tile,
//     y kept in registers;
//   * the other blocks: a 64-column tile of states over n, reduced over all
//     Q in stages of 32 positions; tile 0 also writes decay.
// Every block first scans da of its cell (one warp, Q <= 256), so no
// block waits on another.  All products share one micro-kernel: 256
// threads, each a 4 x 4 register tile of a 64 x 64 output, operands read
// as float4 from [depth][64 + 4] shared stages.  Ragged Q, P and N are
// zero-filled in shared memory and masked at the store.  ssd_combine is the
// same micro-kernel over [64 rows of C] x [S_in]ᵀ with the exp(cum) row scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // output tile edge (rows l or p, columns p or n)
constexpr int kK = 32;           // reduction depth of one shared-memory stage
constexpr int kLd = kT + 4;      // padded stage row (keeps float4 alignment)
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kStage = kK * kLd;  // floats in one [kK][kLd] stage

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc[i][j] += sum_k a[k][ty*4 + i] * b[k][tx*4 + j]
template <int DEPTH>
__device__ __forceinline__ void mma_stage(const float* __restrict__ a,
                                          const float* __restrict__ b, float acc[4][4],
                                          int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < DEPTH; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// stage[k][r] = src[(row0 + r) * ld + col0 + k] for r < 64, k < 32 — a
// transposing load, coalesced along the source row; zero outside
// rows < n_rows, cols < n_cols.
template <typename T>
__device__ __forceinline__ void stage_rows_t(float* __restrict__ stage,
                                             const T* __restrict__ src, int64_t ld,
                                             int row0, int n_rows, int col0, int n_cols) {
  for (int idx = threadIdx.x; idx < kT * kK; idx += kThreads) {
    const int r = idx / kK, k = idx % kK;
    const int row = row0 + r, col = col0 + k;
    stage[k * kLd + r] = (row < n_rows && col < n_cols) ? to_f(src[row * ld + col]) : 0.f;
  }
}

// cum_s[i] = da[0] + ... + da[i] for i < q (entries up to kMaxQ are filled).
// The first warp scans: each lane sums its 8 positions in order, every lane
// adds the 32 lane totals in lane order (the same adds in each lane), and
// lane k adds the sum of the totals before it.  So a lane's base is the
// previous lane's last value, bit for bit, and zeros at the end of a padded
// chunk leave cum unchanged: exp(cum_Q - cum_s) is exactly 1 at the last
// real position, as in a sequential scan.
__device__ __forceinline__ void cell_cumsum(float* __restrict__ cum_s,
                                            const float* __restrict__ da, int q) {
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) cum_s[i] = i < q ? da[i] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    constexpr int kPer = kMaxQ / 32;
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      run += cum_s[lane * kPer + j];
      v[j] = run;
    }
    float base = 0.f, acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float t = __shfl_sync(0xffffffffu, run, k);
      if (lane == k) base = acc;
      acc += t;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) cum_s[lane * kPer + j] = base + v[j];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ da,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ decay, float* __restrict__ cum_out,
                 int q, int p, int n) {
  __shared__ __align__(16) float cum_s[kMaxQ];
  __shared__ __align__(16) float dec_s[kMaxQ];
  __shared__ __align__(16) float buf[2 * kStage];  // two stages, or the X tile
  __shared__ __align__(16) float st[kT * kLd];     // masked C·Bᵀ ∘ L, transposed

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t g = blockIdx.x;
  const T* xg = x + g * q * p;
  const T* bg = bm + g * q * n;
  const T* cg = cm + g * q * n;
  const int n_lt = (q + kT - 1) / kT;

  cell_cumsum(cum_s, da + g * q, q);
  float acc[4][4];
  zero(acc);

  if (static_cast<int>(blockIdx.y) < n_lt) {
    // ---- a 64-row tile of y_diag; heaviest (last) tiles first
    const int l0 = (n_lt - 1 - static_cast<int>(blockIdx.y)) * kT;
    for (int i = tid; i < kT && l0 + i < q; i += kThreads) cum_out[g * q + l0 + i] = cum_s[l0 + i];
    float* sa = buf;           // C stage [k][l]
    float* sb = buf + kStage;  // B stage [k][s]
    float* xs = buf;           // X tile [s][p] (after the C·Bᵀ stages)
    for (int s0 = 0; s0 <= l0; s0 += kT) {
      float cb[4][4];
      zero(cb);
      for (int n0 = 0; n0 < n; n0 += kK) {
        stage_rows_t(sa, cg, n, l0, q, n0, n);
        stage_rows_t(sb, bg, n, s0, q, n0, n);
        __syncthreads();
        mma_stage<kK>(sa, sb, cb, ty, tx);
        __syncthreads();
      }
      // select, then scale by L; store transposed: st[s][l]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty * 4 + i;
          v[i] = (l >= s && l < q) ? cb[i][j] * expf(cum_s[l] - cum_s[s]) : 0.f;
        }
        *reinterpret_cast<float4*>(st + (tx * 4 + j) * kLd + ty * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int r = idx / kT, col = idx % kT;
        const int s = s0 + r;
        xs[r * kLd + col] = (s < q && col < p) ? to_f(xg[s * p + col]) : 0.f;
      }
      __syncthreads();
      mma_stage<kT>(st, xs, acc, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty * 4 + i;
      if (l >= q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        if (col < p) y[(g * q + l) * p + col] = acc[i][j];
      }
    }
  } else {
    // ---- a 64-column tile of the chunk state over n, reduced over all Q
    const int nt = static_cast<int>(blockIdx.y) - n_lt;
    const int n0 = nt * kT;
    const float last = cum_s[q - 1];
    for (int i = tid; i < q; i += kThreads) dec_s[i] = expf(last - cum_s[i]);
    if (nt == 0 && tid == 0) decay[g] = expf(last);
    __syncthreads();
    float* sa = buf;           // X stage [s][p]
    float* sb = buf + kStage;  // decayed B stage [s][n]
    for (int s0 = 0; s0 < q; s0 += kK) {
      for (int idx = tid; idx < kK * kT; idx += kThreads) {
        const int r = idx / kT, col = idx % kT;
        const int s = s0 + r;
        const bool in = s < q;
        sa[r * kLd + col] = (in && col < p) ? to_f(xg[s * p + col]) : 0.f;
        sb[r * kLd + col] = (in && n0 + col < n) ? dec_s[s] * to_f(bg[s * n + n0 + col]) : 0.f;
      }
      __syncthreads();
      mma_stage<kK>(sa, sb, acc, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= p) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < n) states[(g * p + row) * n + col] = acc[i][j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_combine_kernel(const T* __restrict__ cm, const float* __restrict__ cum,
                   const float* __restrict__ s_in, float* __restrict__ y,
                   int q, int p, int n) {
  __shared__ __align__(16) float sa[kStage];  // C stage [k][l]
  __shared__ __align__(16) float sb[kStage];  // S_in stage [k][p]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t g = blockIdx.x;
  const int l0 = blockIdx.y * kT;
  const T* cg = cm + g * q * n;
  const float* sg = s_in + g * p * n;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < n; n0 += kK) {
    stage_rows_t(sa, cg, n, l0, q, n0, n);
    stage_rows_t(sb, sg, n, 0, p, n0, n);
    __syncthreads();
    mma_stage<kK>(sa, sb, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= q) continue;
    const float scale = expf(cum[g * q + l]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx * 4 + j;
      if (col < p) y[(g * q + l) * p + col] = scale * acc[i][j];
    }
  }
}

bool bad_shape(long long g, int q, int p, int n) {
  return g < 1 || g > 0x7fffffffLL || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || n < 1;
}

}  // namespace

// x, b, c [g, q, *] fp32 (bf16 = 0) or bf16 (bf16 = 1); da [g, q] fp32;
// outputs y [g, q, p], states [g, p, n], decay [g], cum [g, q] fp32; all
// contiguous on the current device.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int ssd_chunk(const void* x, const float* da, const void* b, const void* c,
                         float* y, float* states, float* decay, float* cum,
                         long long g, int q, int p, int n, int bf16, void* stream) {
  if (bad_shape(g, q, p, n)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(g), (q + kT - 1) / kT + (n + kT - 1) / kT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    ssd_chunk_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), da, static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c), y, states, decay, cum, q, p, n);
  else
    ssd_chunk_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), da, static_cast<const float*>(b),
        static_cast<const float*>(c), y, states, decay, cum, q, p, n);
  return static_cast<int>(cudaGetLastError());
}

// c [g, q, n] fp32 or bf16; cum [g, q], states_in [g, p, n], y [g, q, p] fp32.
extern "C" int ssd_combine(const void* c, const float* cum, const float* states_in, float* y,
                           long long g, int q, int p, int n, int bf16, void* stream) {
  if (bad_shape(g, q, p, n)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(g), (q + kT - 1) / kT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    ssd_combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(c), cum, states_in, y, q, p, n);
  else
    ssd_combine_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(c), cum, states_in, y, q, p, n);
  return static_cast<int>(cudaGetLastError());
}

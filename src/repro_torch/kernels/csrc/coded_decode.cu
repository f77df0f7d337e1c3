// Fused coded block matmul + erasure decode for the BPCC coded LM head.
//
// Replaces the Pallas TPU kernel repro/kernels/coded_decode.py ::
// coded_matvec_decode_pallas:  y = R . blocked(W_c x), where W_c
// [nb*br, M] holds nb coded row blocks of br rows each, x is [M, B] and R
// [n_data, nb] is the mask-keyed recovery matrix.  Output [n_data*br, B].
//
// What bounds it on an H100: reading W_c once.  The head is a thin product
// (B = 1 at prefill, B = n_slots at decode), about 2*B flops per 4-byte
// weight, far below the card's ~20 flop/byte fp32 balance, so the least
// time is bytes(W_c) / 3.35 TB/s (glm4-9b: [173216, 4096] fp32, 2.84 GB,
// about 0.85 ms).  Everything else (x, R, the decoded output) is noise.
//
// Design.  The TPU kernel walks a sequential grid of column panels with a
// VMEM-resident accumulator; here each thread block owns a row tile of BT
// rows in EVERY one of the nb code blocks (nb*BT <= 32 coded rows) and loops
// over M itself, so no sum crosses blocks:
//   * 8 warps; each warp streams 4 coded rows at once with coalesced
//     16-byte loads (32 lanes x float4 = 512 contiguous bytes per row), so
//     every weight byte is read exactly once;
//   * x is staged in shared memory in panels of 512 columns, transposed to
//     [B][panel] so a lane reads 4 consecutive x values per column with one
//     conflict-free float4; each x value read serves 4 rows, and the B
//     partial sums per row live in registers (B <= 16);
//   * after the M loop the [nb, BT, B] coded partials are warp-reduced into
//     shared memory and contracted with R there: only the decoded
//     [n_data, BT, B] tile is written to device memory.  R's columns for
//     erased blocks are exactly zero, so a straggler's block cannot leak.
// fp32 FMA throughout (no TF32).  Ragged br (last row tile) and M (last
// panel) are masked; M % 4 != 0 takes the scalar-load variant.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerTile = kWarps * kRowsPerWarp;  // coded rows per thread block
constexpr int kPanel = 512;                          // x columns staged per pass
constexpr int kMaxB = 16;
constexpr int kMaxBlocks = kRowsPerTile;             // nb * BT <= 32 with BT >= 1

template <int BMAX, bool VEC4>
__global__ void __launch_bounds__(kThreads)
coded_matvec_decode_kernel(const float* __restrict__ w, const float* __restrict__ x,
                           const float* __restrict__ rec, float* __restrict__ out,
                           int64_t br, int64_t m, int b, int nb, int n_data, int bt) {
  __shared__ __align__(16) float xs[BMAX * kPanel];
  __shared__ float ys[kRowsPerTile * BMAX];
  __shared__ float rs[kMaxBlocks * kMaxBlocks];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * bt;
  const int ncoded = nb * bt;

  for (int i = threadIdx.x; i < n_data * nb; i += kThreads) rs[i] = rec[i];

  // coded row c of this tile: block j = c / bt, row r0 + c % bt of that block
  const float* wrow[kRowsPerWarp];
  bool valid[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int c = warp * kRowsPerWarp + i;
    const int j = c / bt;
    const int64_t r = r0 + c % bt;
    valid[i] = c < ncoded && r < br;
    wrow[i] = valid[i] ? w + (static_cast<int64_t>(j) * br + r) * m : w;
  }

  float acc[kRowsPerWarp][BMAX];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int q = 0; q < BMAX; ++q) acc[i][q] = 0.f;

  for (int64_t p0 = 0; p0 < m; p0 += kPanel) {
    const int pm = static_cast<int>(m - p0 < kPanel ? m - p0 : kPanel);
    __syncthreads();  // the previous panel is consumed
    for (int idx = threadIdx.x; idx < pm * b; idx += kThreads) {
      const int mm = idx / b, q = idx - mm * b;
      xs[q * kPanel + mm] = x[(p0 + mm) * b + q];
    }
    __syncthreads();
    if (VEC4) {
      for (int mm = lane * 4; mm < pm; mm += 128) {
        float4 wv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          wv[i] = valid[i] ? __ldg(reinterpret_cast<const float4*>(wrow[i] + p0 + mm))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < BMAX; ++q) {
          if (q < b) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[q * kPanel + mm]);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              float s = acc[i][q];
              s = fmaf(wv[i].x, xv.x, s);
              s = fmaf(wv[i].y, xv.y, s);
              s = fmaf(wv[i].z, xv.z, s);
              s = fmaf(wv[i].w, xv.w, s);
              acc[i][q] = s;
            }
          }
        }
      }
    } else {
      for (int mm = lane; mm < pm; mm += 32) {
        float wv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) wv[i] = valid[i] ? __ldg(wrow[i] + p0 + mm) : 0.f;
#pragma unroll
        for (int q = 0; q < BMAX; ++q) {
          if (q < b) {
            const float xv = xs[q * kPanel + mm];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) acc[i][q] = fmaf(wv[i], xv, acc[i][q]);
          }
        }
      }
    }
  }

  // warp-reduce the coded partials into shared memory: ys[c][q]
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int q = 0; q < BMAX; ++q) {
      if (q < b) {
        float v = acc[i][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) ys[(warp * kRowsPerWarp + i) * BMAX + q] = v;
      }
    }
  }
  __syncthreads();

  // decode in shared memory: y[d, r0 + t, q] = sum_j R[d, j] * ys[j*bt + t][q]
  const int per_d = bt * b;
  for (int idx = threadIdx.x; idx < n_data * per_d; idx += kThreads) {
    const int d = idx / per_d;
    const int rem = idx - d * per_d;
    const int t = rem / b, q = rem - t * b;
    const int64_t r = r0 + t;
    if (r >= br) continue;
    float s = 0.f;
    for (int j = 0; j < nb; ++j) s = fmaf(rs[d * nb + j], ys[(j * bt + t) * BMAX + q], s);
    out[(static_cast<int64_t>(d) * br + r) * b + q] = s;
  }
}

template <int BMAX>
void launch(bool vec4, dim3 grid, cudaStream_t stream, const float* w, const float* x,
            const float* rec, float* out, int64_t br, int64_t m, int b, int nb, int n_data,
            int bt) {
  if (vec4)
    coded_matvec_decode_kernel<BMAX, true>
        <<<grid, kThreads, 0, stream>>>(w, x, rec, out, br, m, b, nb, n_data, bt);
  else
    coded_matvec_decode_kernel<BMAX, false>
        <<<grid, kThreads, 0, stream>>>(w, x, rec, out, br, m, b, nb, n_data, bt);
}

}  // namespace

// w [nb*br, m], x [m, b], rec [n_data, nb], out [n_data*br, b]; all fp32,
// contiguous, on the current device.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int coded_matvec_decode(const float* w, const float* x, const float* rec, float* out,
                                   long long br, long long m, int b, int nb, int n_data,
                                   void* stream) {
  if (b < 1 || b > kMaxB || nb < 1 || nb > kMaxBlocks || n_data < 1 || n_data > nb ||
      br < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bt = kRowsPerTile / nb;
  const dim3 grid(static_cast<unsigned>((br + bt - 1) / bt));
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 1)
    launch<1>(vec4, grid, s, w, x, rec, out, br, m, b, nb, n_data, bt);
  else if (b <= 2)
    launch<2>(vec4, grid, s, w, x, rec, out, br, m, b, nb, n_data, bt);
  else if (b <= 4)
    launch<4>(vec4, grid, s, w, x, rec, out, br, m, b, nb, n_data, bt);
  else if (b <= 8)
    launch<8>(vec4, grid, s, w, x, rec, out, br, m, b, nb, n_data, bt);
  else
    launch<16>(vec4, grid, s, w, x, rec, out, br, m, b, nb, n_data, bt);
  return static_cast<int>(cudaGetLastError());
}

// Dense encode out = G A (fp32) for coded parity and reserve rows.
//
// Replaces the Pallas TPU kernel repro/kernels/lt_encode.py ::
// gaussian_encode_pallas.  G [q, r] is a dense generator slice, A [r, M] the
// source; out [q, M].  On the serving path it re-encodes the coded LM head
// with one more parity block (encode_blocks_device): G = B [nb, n_data],
// A = the head's data blocks flattened to [n_data, br*in] (glm4-9b after a
// (13, 3) re-split: [16, 13] x [13, 47,751,168]).
//
// What bounds it on an H100: memory.  With r = 13 the product does ~2*q
// flops per 4 bytes of A read and 4 bytes of out per r flops, so the least
// time is (bytes(A) + bytes(out)) / 3.35 TB/s: 2.48 GB + 3.06 GB, about
// 1.65 ms.  The fp32 FMA rate (67 TFLOP/s) is far off.
//
// Design: a plain tiled fp32 SGEMM (no TF32, no tensor cores: fp32 means
// fp32).  A 256-thread block owns a [32 x 128] output tile; the reduction
// over r runs in k-tiles of 16 through shared memory (G tile stored
// transposed so a warp reads one broadcast row, A tile read as float4), and
// each thread keeps a 4 x 4 register tile, stored with one float4 per row.
// For the skinny-K encode every A element is read once (one q-tile when
// q <= 32) and every output written once.  Ragged q, r and M are masked;
// M % 4 != 0 takes the scalar-load variant, so the kernel is right for any
// [q, r] x [r, M].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;   // output rows per block
constexpr int kBM = 128;  // output columns per block
constexpr int kBK = 16;   // reduction depth per shared-memory stage
constexpr int kTQ = 4;    // rows per thread
constexpr int kTM = 4;    // columns per thread
constexpr int kThreads = (kBQ / kTQ) * (kBM / kTM);  // 256

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
gaussian_encode_kernel(const float* __restrict__ g, const float* __restrict__ a,
                       float* __restrict__ out, int q, int r, int64_t m) {
  __shared__ float gs[kBK][kBQ];
  __shared__ __align__(16) float as[kBK][kBM];

  const int tx = threadIdx.x & 31;  // column group: columns tx*4 .. tx*4+3
  const int ty = threadIdx.x >> 5;  // row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.y * kBQ;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;

  float acc[kTQ][kTM];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTM; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < r; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kBQ * kBK; idx += kThreads) {
      const int qq = idx / kBK, kk = idx % kBK;
      gs[kk][qq] = (q0 + qq < q && k0 + kk < r)
                       ? g[static_cast<int64_t>(q0 + qq) * r + k0 + kk] : 0.f;
    }
    if (VEC4) {
      for (int idx = threadIdx.x; idx < kBK * kBM / 4; idx += kThreads) {
        const int kk = idx / (kBM / 4), mm = (idx % (kBM / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < r && m0 + mm < m)
          v = __ldg(reinterpret_cast<const float4*>(a + static_cast<int64_t>(k0 + kk) * m + m0 + mm));
        *reinterpret_cast<float4*>(&as[kk][mm]) = v;
      }
    } else {
      for (int idx = threadIdx.x; idx < kBK * kBM; idx += kThreads) {
        const int kk = idx / kBM, mm = idx % kBM;
        as[kk][mm] = (k0 + kk < r && m0 + mm < m)
                         ? __ldg(a + static_cast<int64_t>(k0 + kk) * m + m0 + mm) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float gv[kTQ];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) gv[i] = gs[kk][ty * kTQ + i];
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][tx * kTM]);
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        acc[i][0] = fmaf(gv[i], av.x, acc[i][0]);
        acc[i][1] = fmaf(gv[i], av.y, acc[i][1]);
        acc[i][2] = fmaf(gv[i], av.z, acc[i][2]);
        acc[i][3] = fmaf(gv[i], av.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  const int64_t col = m0 + tx * kTM;
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int row = q0 + ty * kTQ + i;
    if (row >= q || col >= m) continue;
    float* o = out + static_cast<int64_t>(row) * m + col;
    if (VEC4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTM; ++j)
        if (col + j < m) o[j] = acc[i][j];
    }
  }
}

}  // namespace

// g [q, r], a [r, m], out [q, m]; all fp32, contiguous, on the current
// device.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int gaussian_encode(const float* g, const float* a, float* out, int q, int r,
                               long long m, void* stream) {
  if (q < 1 || r < 1 || m < 1 || (q + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (q + kBQ - 1) / kBQ);
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    gaussian_encode_kernel<true><<<grid, kThreads, 0, s>>>(g, a, out, q, r, m);
  else
    gaussian_encode_kernel<false><<<grid, kThreads, 0, s>>>(g, a, out, q, r, m);
  return static_cast<int>(cudaGetLastError());
}

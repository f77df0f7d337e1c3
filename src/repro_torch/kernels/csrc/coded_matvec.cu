// Coded matvec / thin matmul y = A x: one worker's (or one code block's) product.
//
// Replaces the Pallas TPU kernel repro/kernels/coded_matvec.py ::
// coded_matvec_pallas: A [R, M] (fp32 or fp16), x [M, B] of the same type,
// y [R, B] fp32, summed in fp32.  On the serving path it is the local
// product of each code block of the mesh-sharded coded head (glm4-9b:
// [10826, 4096] fp32 per block, B = 1 at prefill and B = n_slots at decode).
//
// What bounds it on an H100: reading A once.  About 2*B flops per element of
// A, far below the card's fp32 balance (~20 flop/byte), so the least time is
// bytes(A) / 3.35 TB/s (a [10826, 4096] fp32 block: 177 MB, about 0.053 ms).
//
// Design.  The TPU kernel walks a sequential grid of column panels with the
// output block resident in VMEM.  Here each thread block owns 32 rows and
// loops over M itself, so no sum crosses thread blocks:
//   * 8 warps, each streaming 4 rows at once with coalesced 16-byte loads
//     (32 lanes x 16 B = 512 contiguous bytes per row per load), so every
//     byte of A is read exactly once;
//   * x is staged in shared memory, converted to fp32, in panels of 512
//     columns transposed to [B][panel], so a lane reads 4 consecutive x
//     values with one conflict-free float4; each x value serves 4 rows and
//     the B partial sums of each row live in registers (B <= 16);
//   * after the M loop a warp shuffle reduces each row's sums and lane 0
//     writes the row's B outputs: one write per output.
// fp32 FMA throughout (no TF32).  Ragged R (last tile) and M (last panel)
// are masked.  A row that is not 16-byte aligned (M not a multiple of the
// vector width, or a view starting mid-row-group) takes the scalar-load
// variant.  Offsets are 64-bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kPanel = 512;  // x columns staged per pass
constexpr int kMaxB = 16;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __half* p) {
  return __half2float(__ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float lo_half(unsigned int u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u & 0xffffu)));
}
__device__ __forceinline__ float hi_half(unsigned int u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}

// one 16-byte load of A as fp32 values: 4 floats or 8 halves
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <>
struct Vec<__half> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __half* p, float (&f)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    f[0] = lo_half(v.x); f[1] = hi_half(v.x); f[2] = lo_half(v.y); f[3] = hi_half(v.y);
    f[4] = lo_half(v.z); f[5] = hi_half(v.z); f[6] = lo_half(v.w); f[7] = hi_half(v.w);
  }
};

template <typename T, int BMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
coded_matvec_kernel(const T* __restrict__ a, const T* __restrict__ x, float* __restrict__ out,
                    int64_t r, int64_t m, int b) {
  constexpr int kVec = Vec<T>::n;
  __shared__ __align__(16) float xs[BMAX * kPanel];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp * kRowsPerWarp;

  const T* arow[kRowsPerWarp];
  bool valid[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    valid[i] = row0 + i < r;
    arow[i] = valid[i] ? a + (row0 + i) * m : a;
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
      xs[q * kPanel + mm] = load_f(x + (p0 + mm) * b + q);
    }
    __syncthreads();
    if (VEC) {
      // m % kVec == 0, so pm is a multiple of kVec too
      for (int mm = lane * kVec; mm < pm; mm += 32 * kVec) {
        float wv[kRowsPerWarp][kVec];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (valid[i]) {
            Vec<T>::load(arow[i] + p0 + mm, wv[i]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) wv[i][e] = 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < BMAX; ++q) {
          if (q < b) {
#pragma unroll
            for (int e4 = 0; e4 < kVec; e4 += 4) {
              const float4 xv = *reinterpret_cast<const float4*>(&xs[q * kPanel + mm + e4]);
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i) {
                float s = acc[i][q];
                s = fmaf(wv[i][e4 + 0], xv.x, s);
                s = fmaf(wv[i][e4 + 1], xv.y, s);
                s = fmaf(wv[i][e4 + 2], xv.z, s);
                s = fmaf(wv[i][e4 + 3], xv.w, s);
                acc[i][q] = s;
              }
            }
          }
        }
      }
    } else {
      for (int mm = lane; mm < pm; mm += 32) {
        float wv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) wv[i] = valid[i] ? load_f(arow[i] + p0 + mm) : 0.f;
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

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int q = 0; q < BMAX; ++q) {
      if (q < b) {
        float v = acc[i][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && valid[i]) out[(row0 + i) * b + q] = v;
      }
    }
  }
}

template <typename T, int BMAX>
void launch(bool vec, dim3 grid, cudaStream_t stream, const T* a, const T* x, float* out,
            int64_t r, int64_t m, int b) {
  if (vec)
    coded_matvec_kernel<T, BMAX, true><<<grid, kThreads, 0, stream>>>(a, x, out, r, m, b);
  else
    coded_matvec_kernel<T, BMAX, false><<<grid, kThreads, 0, stream>>>(a, x, out, r, m, b);
}

template <typename T>
int run(const T* a, const T* x, float* out, long long r, long long m, int b, void* stream) {
  if (b < 1 || b > kMaxB || r < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((r + kRowsPerBlock - 1) / kRowsPerBlock));
  // every row starts 16-byte aligned iff the first does and a row is a whole
  // number of 16-byte vectors
  const bool vec = (m % Vec<T>::n == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 1)
    launch<T, 1>(vec, grid, s, a, x, out, r, m, b);
  else if (b <= 2)
    launch<T, 2>(vec, grid, s, a, x, out, r, m, b);
  else if (b <= 4)
    launch<T, 4>(vec, grid, s, a, x, out, r, m, b);
  else if (b <= 8)
    launch<T, 8>(vec, grid, s, a, x, out, r, m, b);
  else
    launch<T, 16>(vec, grid, s, a, x, out, r, m, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [r, m], x [m, b] (both fp32, or both fp16 when half != 0), out [r, b]
// fp32; all contiguous, on the current device.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int coded_matvec(const void* a, const void* x, float* out, long long r,
                            long long m, int b, int half, void* stream) {
  if (half)
    return run(static_cast<const __half*>(a), static_cast<const __half*>(x), out, r, m, b,
               stream);
  return run(static_cast<const float*>(a), static_cast<const float*>(x), out, r, m, b, stream);
}

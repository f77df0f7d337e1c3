// Dense encode out = G A (fp32) for coded parity and reserve rows.
//
// Replaces the Pallas TPU kernel repro/kernels/lt_encode.py ::
// gaussian_encode_pallas (def :107, pallas_call :125).  G [q, r] is a dense
// generator slice, A [r, M] the source; out [q, M].  On the serving path it
// re-encodes the coded LM head with one more parity block
// (encode_blocks_device): G = B [nb, n_data], A = the head's data blocks
// flattened to [n_data, br*in] (glm4-9b after a (13, 3) re-split: [16, 13] x
// [13, 47,751,168]).  On the task path it encodes a Gaussian plan's reserve
// rows (encode_rows: [26, 500] x [500, 200,000] in chip_smoke.py).
//
// What bounds it on an H100: memory.  Each element of A feeds q
// multiply-adds and each output element r of them, so the least time is
// (bytes(A) + bytes(out)) / 3.35 TB/s: at the glm4-9b raise 2.48 GB + 3.06
// GB, 1.65 ms.  At the task shape the fp32 FMA rate (67 TFLOP/s) comes close
// (0.078 ms of operations against 0.126 ms of bytes), so FMAs spent on rows
// past q show.
//
// Design, for that bound (no TF32, no tensor cores: fp32 means fp32):
//  * A goes straight from device memory into registers, once.  Each thread
//    owns a column quad (float4 loads where M % 4 == 0 and the pointers are
//    16-byte aligned; otherwise 4 scalar columns 128 apart, still coalesced)
//    and every row of the block's q-tile: QT x 4 sums in registers.  No two
//    threads use the same element of A, so nothing of A is staged in shared
//    memory and no barrier separates loads from FMAs.
//  * G's q-tile is staged transposed ([k][QT]) in dynamic shared memory once
//    per block and read back as float4 broadcasts.  Where r x QT x 4 bytes
//    exceeds a 64 KB cap, r is walked in panels of G (restaged per column
//    span), so shared memory alone never keeps a third block off an SM.
//  * QT is a template parameter: q rounded up to a multiple of 4 (4 to 32),
//    so q = 16 (every parity raise) wastes no FMA and q = 26 two rows of 28.
//    Where q > 32 the rows are cut into ceil(q / 32) equal q-tiles and A is
//    read once per q-tile.
//  * The k loop loads U rows of A (16, or 8 at QT > 16) before the first
//    FMA that needs them: at r = 13 all 13 are in flight together.
//  * A persistent grid (a few blocks per SM, from the occupancy the wrapper
//    asks for) walks 512-column spans grid-stride, so G is staged once per
//    block and not once per span.
//  * out is stored with an evict-first hint (__stcs): nothing reads it again.
//  * Ragged shapes: rows past q, k past r (zero-padded to U in shared
//    memory and in registers), M % 4 != 0, M = 1, misaligned views (the
//    scalar variant) and 64-bit offsets (r x M past 2^31).
// The wrapper (kernels/lt_encode.py::gaussian_plan) computes the launch
// geometry; gaussian_encode() checks it and refuses what it does not take.
// On an H100 (700 W) the glm4-9b raise takes 1.955 ms (85 % of its bound;
// torch.matmul 3.178 ms) and the task's reserve slice 0.194 ms (65 %;
// torch.matmul 0.247 ms), where the first port took 3.33 and 0.331 ms
// (chip_smoke.py).  ptxas reports up to 255 registers (the widest q-tiles)
// and no spills.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // one column quad each
constexpr int kSpan = 4 * kThreads;      // columns a block covers per work item
constexpr int kSmemCap = 64 * 1024;      // bytes of G a block stages at most

__host__ __device__ constexpr int unroll_for(int qt) { return qt > 16 ? 8 : 16; }

__device__ __forceinline__ void fma4(float (&c)[4], float g, const float4& x) {
  c[0] = fmaf(g, x.x, c[0]);
  c[1] = fmaf(g, x.y, c[1]);
  c[2] = fmaf(g, x.z, c[2]);
  c[3] = fmaf(g, x.w, c[3]);
}

template <int QT, bool VEC4>
__global__ void __launch_bounds__(kThreads)
gaussian_encode_kernel(const float* __restrict__ g, const float* __restrict__ a,
                       float* __restrict__ out, int q, int r, int64_t m, int panel,
                       int n_qtiles, int64_t n_spans) {
  constexpr int U = unroll_for(QT);
  extern __shared__ __align__(16) float gs[];  // [round_up(panel rows, U)][QT]
  const int n_panels = (r + panel - 1) / panel;
  const int64_t n_work = static_cast<int64_t>(n_qtiles) * n_spans;
  int staged = -1;  // the q-tile whose only panel gs holds

  for (int64_t w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int tile = static_cast<int>(w / n_spans);
    const int q0 = tile * QT;
    // VEC4: columns col .. col + 3; scalar: col + j * kThreads, j = 0..3
    const int64_t col = (w % n_spans) * kSpan + (VEC4 ? 4 * threadIdx.x : threadIdx.x);

    float acc[QT][4];
#pragma unroll
    for (int i = 0; i < QT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int p = 0; p < n_panels; ++p) {
      const int k0 = p * panel;
      const int kp = min(panel, r - k0);
      if (n_panels > 1 || tile != staged) {
        const int kpad = (kp + U - 1) / U * U;
        __syncthreads();  // every thread is done with the previous panel
        for (int idx = threadIdx.x; idx < QT * kpad; idx += kThreads) {
          const int i = idx / kpad, k = idx % kpad;
          gs[k * QT + i] = (q0 + i < q && k < kp)
                               ? g[static_cast<int64_t>(q0 + i) * r + k0 + k] : 0.f;
        }
        __syncthreads();
        staged = tile;
      }
      const float* ap = a + static_cast<int64_t>(k0) * m + col;
      for (int kk = 0; kk < kp; kk += U) {
        float4 av[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          av[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kk + u < kp) {
            const float* src = ap + static_cast<int64_t>(kk + u) * m;
            if (VEC4) {
              if (col < m) av[u] = __ldg(reinterpret_cast<const float4*>(src));
            } else {
              if (col < m) av[u].x = __ldg(src);
              if (col + kThreads < m) av[u].y = __ldg(src + kThreads);
              if (col + 2 * kThreads < m) av[u].z = __ldg(src + 2 * kThreads);
              if (col + 3 * kThreads < m) av[u].w = __ldg(src + 3 * kThreads);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4* gk = reinterpret_cast<const float4*>(gs + (kk + u) * QT);
#pragma unroll
          for (int i4 = 0; i4 < QT / 4; ++i4) {
            const float4 gv = gk[i4];
            fma4(acc[4 * i4 + 0], gv.x, av[u]);
            fma4(acc[4 * i4 + 1], gv.y, av[u]);
            fma4(acc[4 * i4 + 2], gv.z, av[u]);
            fma4(acc[4 * i4 + 3], gv.w, av[u]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (q0 + i >= q) break;
      float* o = out + static_cast<int64_t>(q0 + i) * m + col;
      if (VEC4) {
        if (col < m)
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j * kThreads < m) __stcs(o + j * kThreads, acc[i][j]);
      }
    }
  }
}

template <int QT, bool VEC4>
void* kernel_ptr() {
  return reinterpret_cast<void*>(&gaussian_encode_kernel<QT, VEC4>);
}

// the instantiation for (qt, vec4), or nullptr for a qt the kernel does not take
void* select(int qt, bool vec4) {
#define GE_CASE(QT) \
  case QT: return vec4 ? kernel_ptr<QT, true>() : kernel_ptr<QT, false>();
  switch (qt) {
    GE_CASE(4) GE_CASE(8) GE_CASE(12) GE_CASE(16)
    GE_CASE(20) GE_CASE(24) GE_CASE(28) GE_CASE(32)
    default: return nullptr;
  }
#undef GE_CASE
}

int smem_for(int qt, int r, int panel) {
  const int u = unroll_for(qt);
  const int rows = panel < r ? panel : r;
  return (rows + u - 1) / u * u * qt * 4;
}

}  // namespace

// Blocks of the (qt, vec4) variant that fit on one SM with smem_bytes of
// dynamic shared memory, into *blocks.  Returns a cudaError_t.
extern "C" int gaussian_encode_occupancy(int qt, int vec4, int smem_bytes, int* blocks) {
  void* fn = select(qt, vec4 != 0);
  if (fn == nullptr || smem_bytes < 0 || smem_bytes > kSmemCap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem_bytes));
}

// g [q, r], a [r, m], out [q, m]; all fp32, contiguous, on the current
// device.  The geometry comes from the wrapper: the q-tile qt (a multiple
// of 4, at most 32) and n_qtiles = ceil(q / qt); G's panel (rows of r a
// block stages at once) and smem_bytes = round_up(min(panel, r), U) x qt x 4
// (at most 64 KB); the persistent grid; vec4 (m % 4 == 0, a and out 16-byte
// aligned).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or geometry the kernel does not take).
extern "C" int gaussian_encode(const float* g, const float* a, float* out, int q, int r,
                               long long m, int qt, int n_qtiles, int panel, int smem_bytes,
                               int grid, int vec4, void* stream) {
  void* fn = select(qt, vec4 != 0);
  if (fn == nullptr || q < 1 || r < 1 || m < 1 || panel < 1 || grid < 1 ||
      n_qtiles != (q + qt - 1) / qt || smem_bytes != smem_for(qt, r, panel) ||
      smem_bytes > kSmemCap)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec4 && (m % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_spans = (m + kSpan - 1) / kSpan;
  void* args[] = {&g, &a, &out, &q, &r, &m, &panel, &n_qtiles,
                  const_cast<long long*>(&n_spans)};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args,
                         static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
